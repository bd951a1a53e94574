// out = x + bf16(W2 . bf16(GELU(bf16(W1 . LN(x) + b1))) + b2) over [N, D] tokens.
//
// Replaces us_video_medsam2_tpu/kernels/fused_mlp.py (ln_mlp_residual, _kernel).
// Bound by operations at the Hiera shapes. One block (8 warps) per 32-token
// tile:
//   1. two-pass LayerNorm (f32 statistics) of the tile into shared memory, bf16;
//   2. for each 128-wide chunk of the hidden axis F: the chunk's hidden units
//      on bf16 tensor cores (WMMA 16x16x16, f32 accumulation; W1 read from
//      device memory, where every tile shares it through L2), then bias, bf16
//      rounding, exact erf GELU and bf16 rounding in shared memory, then the
//      chunk's contribution to the [32, D] output accumulated in f32
//      fragments that stay in registers across all chunks;
//   3. epilogue: bias, bf16 rounding, residual add.
// The [N, F] hidden activation never reaches device memory.
#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 32;       // tokens per block
constexpr int FC = 128;      // hidden chunk
constexpr int WARPS = 8;
constexpr int LDH = FC + 4;  // f32 hidden chunk row stride
constexpr int LDHB = FC + 8; // bf16 hidden chunk row stride

template <int D>
struct Layout {
  static constexpr int LDY = D + 8;
  static constexpr int LDO = D + 4;
  static constexpr size_t ys = 0;
  static constexpr size_t hf = usm::align128(ys + sizeof(usm::bf16) * BM * LDY);
  static constexpr size_t hb = usm::align128(hf + sizeof(float) * BM * LDH);
  static constexpr size_t of = usm::align128(hb + sizeof(usm::bf16) * BM * LDHB);
  static constexpr size_t bytes = usm::align128(of + sizeof(float) * BM * LDO);
};

template <int D>
__global__ void __launch_bounds__(WARPS * 32) ln_mlp_residual_kernel(
    const usm::bf16* __restrict__ x, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, const usm::bf16* __restrict__ w1,
    const float* __restrict__ b1, const usm::bf16* __restrict__ w2,
    const float* __restrict__ b2, usm::bf16* __restrict__ out, int n, int f, float eps) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  usm::bf16* ys = reinterpret_cast<usm::bf16*>(smem + L::ys);
  float* hf = reinterpret_cast<float*>(smem + L::hf);
  usm::bf16* hb = reinterpret_cast<usm::bf16*>(smem + L::hb);
  float* of = reinterpret_cast<float*>(smem + L::of);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BM;

  // 1. LayerNorm, two-pass variance, one warp per row.
  constexpr int PER = D / 32;
  for (int r = warp; r < BM; r += WARPS) {
    const int g = row0 + r;
    usm::bf16* yrow = ys + r * L::LDY;
    if (g < n) {
      const usm::bf16* xr = x + (size_t)g * D;
      float v[PER];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        v[i] = __bfloat162float(xr[lane + 32 * i]);
        s += v[i];
      }
      const float mean = usm::warp_sum(s) / D;
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) sq += (v[i] - mean) * (v[i] - mean);
      const float rstd = rsqrtf(usm::warp_sum(sq) / D + eps);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int c = lane + 32 * i;
        yrow[c] = __float2bfloat16((v[i] - mean) * rstd * ln_w[c] + ln_b[c]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) yrow[lane + 32 * i] = __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  constexpr int NT = D / 16;              // output column tiles
  constexpr int TILES = (BM / 16) * NT;   // output tiles per block
  constexpr int TPW = (TILES + WARPS - 1) / WARPS;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TPW];
#pragma unroll
  for (int i = 0; i < TPW; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int c0 = 0; c0 < f; c0 += FC) {
    // 2a. hidden chunk h[32, FC] = y . W1[c0:c0+FC, :]^T ; 16 tiles, 2 per warp
    for (int t = warp; t < (BM / 16) * (FC / 16); t += WARPS) {
      const int mt = t / (FC / 16), nt = t % (FC / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc;
      wmma::fill_fragment(hacc, 0.f);
#pragma unroll 4
      for (int k = 0; k < D / 16; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, usm::bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, usm::bf16, wmma::col_major> bm;
        wmma::load_matrix_sync(a, ys + mt * 16 * L::LDY + k * 16, L::LDY);
        wmma::load_matrix_sync(bm, w1 + (size_t)(c0 + nt * 16) * D + k * 16, D);
        wmma::mma_sync(hacc, a, bm, hacc);
      }
      wmma::store_matrix_sync(hf + mt * 16 * LDH + nt * 16, hacc, LDH, wmma::mem_row_major);
    }
    __syncthreads();
    // 2b. bias, bf16 rounding, exact GELU, bf16 rounding
    for (int i = threadIdx.x; i < BM * FC; i += WARPS * 32) {
      const int r = i / FC, c = i % FC;
      const float h = usm::bf16_round(hf[r * LDH + c] + b1[c0 + c]);
      hb[r * LDHB + c] = __float2bfloat16(0.5f * h * (1.f + erff(h * 0.70710678118654752f)));
    }
    __syncthreads();
    // 2c. out[32, D] += h . W2[:, c0:c0+FC]^T
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int t = warp + WARPS * i;
      if (t < TILES) {
        const int mt = t / NT, nt = t % NT;
#pragma unroll
        for (int k = 0; k < FC / 16; ++k) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, usm::bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, usm::bf16, wmma::col_major> bm;
          wmma::load_matrix_sync(a, hb + mt * 16 * LDHB + k * 16, LDHB);
          wmma::load_matrix_sync(bm, w2 + (size_t)(nt * 16) * f + c0 + k * 16, f);
          wmma::mma_sync(acc[i], a, bm, acc[i]);
        }
      }
    }
    __syncthreads();
  }

  // 3. epilogue: out = x + bf16(o + b2)
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int t = warp + WARPS * i;
    if (t < TILES) {
      const int mt = t / NT, nt = t % NT;
      wmma::store_matrix_sync(of + mt * 16 * L::LDO + nt * 16, acc[i], L::LDO, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * D; i += WARPS * 32) {
    const int r = i / D, c = i % D;
    const int g = row0 + r;
    if (g < n) {
      const float o = usm::bf16_round(of[r * L::LDO + c] + b2[c]);
      const size_t idx = (size_t)g * D + c;
      out[idx] = __float2bfloat16(__bfloat162float(x[idx]) + o);
    }
  }
}

template <int D>
cudaError_t launch(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                   const void* b1, const void* w2, const void* b2, void* out, int n, int f,
                   float eps, cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes;
  cudaError_t e = usm::allow_smem(ln_mlp_residual_kernel<D>, bytes);
  if (e != cudaSuccess) return e;
  const int blocks = (n + BM - 1) / BM;
  ln_mlp_residual_kernel<D><<<blocks, WARPS * 32, bytes, stream>>>(
      static_cast<const usm::bf16*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const usm::bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const usm::bf16*>(w2),
      static_cast<const float*>(b2), static_cast<usm::bf16*>(out), n, f, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int usm_ln_mlp_residual_bf16(const void* x, const void* ln_w, const void* ln_b,
                                        const void* w1, const void* b1, const void* w2,
                                        const void* b2, void* out, int n, int d, int f,
                                        float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return cudaSuccess;
  if (f <= 0 || f % FC) return cudaErrorInvalidValue;
  switch (d) {
    case 96: return launch<96>(x, ln_w, ln_b, w1, b1, w2, b2, out, n, f, eps, s);
    case 192: return launch<192>(x, ln_w, ln_b, w1, b1, w2, b2, out, n, f, eps, s);
    case 384: return launch<384>(x, ln_w, ln_b, w1, b1, w2, b2, out, n, f, eps, s);
    case 768: return launch<768>(x, ln_w, ln_b, w1, b1, w2, b2, out, n, f, eps, s);
    default: return cudaErrorInvalidValue;
  }
}
