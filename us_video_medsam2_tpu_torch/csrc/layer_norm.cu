// Row LayerNorm, fast-variance form, bf16 in / bf16 out, f32 statistics.
//
// Replaces us_video_medsam2_tpu/kernels/fused_ln.py (layer_norm_pallas,
// _ln_kernel). Bound by bytes on the H100: one warp per row reads the row once
// (lane i takes columns i, i+32, ...: neighbouring lanes on neighbouring
// addresses), reduces sum and sum of squares with shuffles, and writes once.
#include "common.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(256) layer_norm_kernel(
    const usm::bf16* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, usm::bf16* __restrict__ out, int rows, float eps) {
  constexpr int PER = D / 32;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const usm::bf16* xr = x + (size_t)row * D;
  float v[PER];
  float s = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    v[i] = __bfloat162float(xr[lane + 32 * i]);
    s += v[i];
    sq += v[i] * v[i];
  }
  s = usm::warp_sum(s);
  sq = usm::warp_sum(sq);
  const float mean = s / D;
  const float var = fmaxf(sq / D - mean * mean, 0.f);
  const float r = rsqrtf(var + eps);
  usm::bf16* orow = out + (size_t)row * D;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    orow[c] = __float2bfloat16((v[i] - mean) * r * w[c] + b[c]);
  }
}

template <int D>
cudaError_t launch(const void* x, const void* w, const void* b, void* out, int rows,
                   float eps, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (rows + threads / 32 - 1) / (threads / 32);
  layer_norm_kernel<D><<<blocks, threads, 0, stream>>>(
      static_cast<const usm::bf16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<usm::bf16*>(out), rows, eps);
  return cudaGetLastError();
}

}  // namespace

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
