// Row LayerNorm, fast-variance form, bf16 in / bf16 out, f32 statistics.
//
// Replaces us_video_medsam2_tpu/kernels/fused_ln.py (layer_norm_pallas,
// _ln_kernel): mean and E[x^2] in f32 from one read, var = max(E[x^2] -
// mean^2, 0), y = (x - mean) * rsqrt(var + eps) * w + b with f32 scale and
// bias, rounded once.
//
// Bound by bytes on the H100 (one read and one write of x). Each row takes a
// group of LANES = D / 24 lanes (4, 8, 16, 32 at D 96, 192, 384, 768; a warp
// holds 32 / LANES rows, so no lane idles), and each lane three 16-byte chunks
// of 8 columns, at chunk index j * LANES + lane for j = 0, 1, 2: neighbouring
// lanes read and write neighbouring addresses. Sum and sum of squares reduce
// with shuffles inside the group. A thread loads its 24 columns of w and b
// once, as float4, and keeps them in registers across the rows it takes
// (the grid walks the rows in strides of the whole grid).
#include "common.cuh"

namespace {

constexpr int VEC = 8;  // bf16 columns per 16-byte chunk
constexpr int PER = 3;  // chunks per lane
constexpr int THREADS = 128;

template <int D>
__global__ void __launch_bounds__(THREADS) layer_norm_kernel(
    const usm::bf16* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, usm::bf16* __restrict__ out, int rows, float eps) {
  constexpr int LANES = D / (VEC * PER);
  constexpr int ROWS_PER_WARP = 32 / LANES;
  static_assert(LANES * VEC * PER == D && 32 % LANES == 0, "D = 24 * a power of two up to 32");
  const int lane = threadIdx.x & 31;
  const int sub = lane % LANES, grp = lane / LANES;
  const int warp = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int warps = gridDim.x * (THREADS / 32);

  float wr[PER][VEC], br[PER][VEC];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = (j * LANES + sub) * VEC;
#pragma unroll
    for (int h = 0; h < VEC; h += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(w + c + h);
      const float4 b4 = *reinterpret_cast<const float4*>(b + c + h);
      wr[j][h] = w4.x, wr[j][h + 1] = w4.y, wr[j][h + 2] = w4.z, wr[j][h + 3] = w4.w;
      br[j][h] = b4.x, br[j][h + 1] = b4.y, br[j][h + 2] = b4.z, br[j][h + 3] = b4.w;
    }
  }

  // the loop bound is the warp's, so every lane takes part in the shuffles
  for (int base = warp * ROWS_PER_WARP; base < rows; base += warps * ROWS_PER_WARP) {
    const int row = base + grp;
    const bool ok = row < rows;
    const usm::bf16* xr = x + (size_t)(ok ? row : 0) * D;
    float v[PER][VEC];
    float s = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (ok) raw = *reinterpret_cast<const uint4*>(xr + (j * LANES + sub) * VEC);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int h = 0; h < VEC / 2; ++h) {
        const float2 f = __bfloat1622float2(p2[h]);
        v[j][2 * h] = f.x;
        v[j][2 * h + 1] = f.y;
        s += f.x + f.y;
        sq += f.x * f.x + f.y * f.y;
      }
    }
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    const float mean = s / D;
    const float var = fmaxf(sq / D - mean * mean, 0.f);
    const float r = rsqrtf(var + eps);
    if (!ok) continue;
    usm::bf16* orow = out + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      uint4 packed;
      __nv_bfloat162* q2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int h = 0; h < VEC / 2; ++h)
        q2[h] = __floats2bfloat162_rn((v[j][2 * h] - mean) * r * wr[j][2 * h] + br[j][2 * h],
                                      (v[j][2 * h + 1] - mean) * r * wr[j][2 * h + 1] + br[j][2 * h + 1]);
      *reinterpret_cast<uint4*>(orow + (j * LANES + sub) * VEC) = packed;
    }
  }
}

template <int D>
cudaError_t launch(const void* x, const void* w, const void* b, void* out, int rows,
                   float eps, cudaStream_t stream) {
  constexpr int rows_per_block = (THREADS / 32) * (32 / (D / (VEC * PER)));
  const int want = (rows + rows_per_block - 1) / rows_per_block;
  const int blocks = want < 132 * 8 ? want : 132 * 8;
  layer_norm_kernel<D><<<blocks, THREADS, 0, stream>>>(
      static_cast<const usm::bf16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<usm::bf16*>(out), rows, eps);
  return cudaGetLastError();
}

}  // namespace

// x and out [rows, d] bf16 and w, b [d] f32, all 16-byte aligned
extern "C" int usm_layer_norm_bf16(const void* x, const void* w, const void* b, void* out,
                                   int rows, int d, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return cudaSuccess;
  switch (d) {
    case 96: return launch<96>(x, w, b, out, rows, eps, s);
    case 192: return launch<192>(x, w, b, out, rows, eps, s);
    case 384: return launch<384>(x, w, b, out, rows, eps, s);
    case 768: return launch<768>(x, w, b, out, rows, eps, s);
    default: return cudaErrorInvalidValue;
  }
}
