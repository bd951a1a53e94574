// The memory encoder's ConvNeXt block in one pass over [B, H, W, C] bf16:
//   out = x + g . bf16(bf16(W2 . h) + b2),  h = bf16(GELU(bf16(bf16(W1 . y) + b1))),
//   y = bf16(LN(bf16(dwconv7x7(x) + dw_b))), rounding where the JAX _xla_ref rounds.
//
// Replaces us_video_medsam2_tpu/kernels/fused_cxblock.py (fused_cxblock, _kernel).
// The TPU kernel holds the whole [32, 32, 256] image in VMEM; one image is 512 KB
// of bf16 against the 227 KB of shared memory a block may use, so here one block
// (8 warps) takes an 8x8 token tile:
//   1. the tile's 14x14 halo (3 pixels each side, zeros outside the image) ->
//      shared memory with 16-byte loads (100 KB at C = 256);
//   2. depthwise 7x7, one channel per thread, the channel's 49 f32 taps in
//      registers, a row of 8 outputs accumulated in f32 per pass;
//   3. LayerNorm (fast variance, f32 statistics), one warp per token, in place;
//   4. the hidden axis (4C) in 128-wide chunks: the chunk's hidden units on
//      bf16 tensor cores (WMMA 16x16x16, f32 accumulation; each warp one
//      16-column tile of W1 against the tile's 64 tokens), bias and exact erf
//      GELU in shared memory, then the chunk's share of the [64, C] output,
//      whose f32 fragments stay in registers across all chunks;
//   5. epilogue: bias, layer scale and residual, each rounded as _xla_ref does.
// Bound by operations (the two products); W1 and W2 (1 MB at C = 256) are read
// by every block from L2. At B = 1 and 32x32 there are only 16 blocks.
#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int TH = 8, TW = 8;       // output tile
constexpr int BM = TH * TW;         // tokens per block
constexpr int KS = 7, PAD = KS / 2;
constexpr int HH = TH + KS - 1, HW = TW + KS - 1;  // halo
constexpr int WARPS = 8;
constexpr int FC = 128;             // hidden chunk
constexpr int LDH = FC + 4;         // f32 hidden chunk row stride
constexpr int LDHB = FC + 8;        // bf16 hidden chunk row stride

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

template <int C>
struct Layout {
  static constexpr int LDY = C + 8;
  static constexpr int LDO = C + 4;
  // region A: the halo, then the hidden chunk (f32 and bf16), then the output staging
  static constexpr size_t hf = 0;
  static constexpr size_t hb = usm::align128(sizeof(float) * BM * LDH);
  static constexpr size_t of = 0;
  static constexpr size_t a_bytes =
      cmax(cmax(sizeof(usm::bf16) * HH * HW * C, hb + sizeof(usm::bf16) * BM * LDHB),
           sizeof(float) * BM * LDO);
  static constexpr size_t ys = usm::align128(a_bytes);
  static constexpr size_t bytes = usm::align128(ys + sizeof(usm::bf16) * BM * LDY);
};

template <int C>
__global__ void __launch_bounds__(WARPS * 32) cxblock_kernel(
    const usm::bf16* __restrict__ x, const float* __restrict__ dw_w,
    const float* __restrict__ dw_b, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, const usm::bf16* __restrict__ w1,
    const float* __restrict__ b1, const usm::bf16* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ gamma,
    usm::bf16* __restrict__ out, int h, int w, int f, float eps) {
  using L = Layout<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  usm::bf16* halo = reinterpret_cast<usm::bf16*>(smem);
  float* hf = reinterpret_cast<float*>(smem + L::hf);
  usm::bf16* hb = reinterpret_cast<usm::bf16*>(smem + L::hb);
  float* of = reinterpret_cast<float*>(smem + L::of);
  usm::bf16* ys = reinterpret_cast<usm::bf16*>(smem + L::ys);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles_w = (w + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_w) * TH, tx0 = (blockIdx.x % tiles_w) * TW;
  const size_t img = (size_t)blockIdx.y * h * w * C;
  const usm::bf16* xb = x + img;

  // 1. halo -> shared memory; zeros outside the image
  constexpr int CH = C / 8;
  for (int i = threadIdx.x; i < HH * HW * CH; i += WARPS * 32) {
    const int p = i / CH, ch = i % CH;
    const int yy = ty0 - PAD + p / HW, xx = tx0 - PAD + p % HW;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (yy >= 0 && yy < h && xx >= 0 && xx < w)
      v = *reinterpret_cast<const uint4*>(xb + ((size_t)yy * w + xx) * C + ch * 8);
    *reinterpret_cast<uint4*>(halo + p * C + ch * 8) = v;
  }
  __syncthreads();

  // 2. depthwise 7x7 + bias, rounded to bf16 into ys
  for (int c = threadIdx.x; c < C; c += WARPS * 32) {
    float tap[KS * KS];
#pragma unroll
    for (int k = 0; k < KS * KS; ++k) tap[k] = dw_w[c * KS * KS + k];
    const float bias = dw_b[c];
    for (int r = 0; r < TH; ++r) {
      float acc[TW];
#pragma unroll
      for (int j = 0; j < TW; ++j) acc[j] = 0.f;
#pragma unroll
      for (int ki = 0; ki < KS; ++ki) {
        float in[HW];
#pragma unroll
        for (int j = 0; j < HW; ++j) in[j] = __bfloat162float(halo[((r + ki) * HW + j) * C + c]);
#pragma unroll
        for (int kj = 0; kj < KS; ++kj)
#pragma unroll
          for (int j = 0; j < TW; ++j) acc[j] = fmaf(in[j + kj], tap[ki * KS + kj], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < TW; ++j) ys[(r * TW + j) * L::LDY + c] = __float2bfloat16(acc[j] + bias);
    }
  }
  __syncthreads();

  // 3. LayerNorm in place, fast variance, one warp per token
  constexpr int PER = C / 32;
  for (int r = warp; r < BM; r += WARPS) {
    usm::bf16* yrow = ys + r * L::LDY;
    float v[PER];
    float s = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] = __bfloat162float(yrow[lane + 32 * i]);
      s += v[i];
      sq += v[i] * v[i];
    }
    const float mean = usm::warp_sum(s) / C;
    const float var = fmaxf(usm::warp_sum(sq) / C - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      yrow[c] = __float2bfloat16((v[i] - mean) * rstd * ln_w[c] + ln_b[c]);
    }
  }
  __syncthreads();

  // 4. the two pointwise products, hidden axis in FC-wide chunks
  constexpr int MT = BM / 16;        // token tiles
  constexpr int NT = C / 16;         // output column tiles
  constexpr int NPW = NT / WARPS;    // output column tiles per warp
  static_assert(NT % WARPS == 0 && FC / 16 == WARPS, "tile split");
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT][NPW];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NPW; ++n) wmma::fill_fragment(acc[m][n], 0.f);

  for (int c0 = 0; c0 < f; c0 += FC) {
    // 4a. hidden chunk [64, FC] = y . W1[c0:c0+FC, :]^T; warp = its 16-column tile
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) wmma::fill_fragment(hacc[m], 0.f);
#pragma unroll 2
      for (int k = 0; k < C / 16; ++k) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, usm::bf16, wmma::col_major> bm;
        wmma::load_matrix_sync(bm, w1 + (size_t)(c0 + warp * 16) * C + k * 16, C);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, usm::bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, ys + m * 16 * L::LDY + k * 16, L::LDY);
          wmma::mma_sync(hacc[m], a, bm, hacc[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
        wmma::store_matrix_sync(hf + m * 16 * LDH + warp * 16, hacc[m], LDH, wmma::mem_row_major);
    }
    __syncthreads();
    // 4b. product rounded, bias added in bf16, exact GELU in f32, rounded
    for (int i = threadIdx.x; i < BM * FC; i += WARPS * 32) {
      const int r = i / FC, c = i % FC;
      const float hv = usm::bf16_round(usm::bf16_round(hf[r * LDH + c]) + usm::bf16_round(b1[c0 + c]));
      hb[r * LDHB + c] = __float2bfloat16(0.5f * hv * (1.f + erff(hv * 0.70710678118654752f)));
    }
    __syncthreads();
    // 4c. out[64, C] += h . W2[:, c0:c0+FC]^T
#pragma unroll
    for (int k = 0; k < FC / 16; ++k) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, usm::bf16, wmma::row_major> a[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) wmma::load_matrix_sync(a[m], hb + m * 16 * LDHB + k * 16, LDHB);
#pragma unroll
      for (int n = 0; n < NPW; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, usm::bf16, wmma::col_major> bm;
        wmma::load_matrix_sync(bm, w2 + (size_t)((warp * NPW + n) * 16) * f + c0 + k * 16, f);
#pragma unroll
        for (int m = 0; m < MT; ++m) wmma::mma_sync(acc[m][n], a[m], bm, acc[m][n]);
      }
    }
    __syncthreads();
  }

  // 5. epilogue: o = bf16(bf16(acc) + b2); out = bf16(x + bf16(g . o))
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NPW; ++n)
      wmma::store_matrix_sync(of + m * 16 * L::LDO + (warp * NPW + n) * 16, acc[m][n], L::LDO,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * C; i += WARPS * 32) {
    const int r = i / C, c = i % C;
    const int yy = ty0 + r / TW, xx = tx0 + r % TW;
    if (yy < h && xx < w) {
      const size_t idx = img + ((size_t)yy * w + xx) * C + c;
      const float o = usm::bf16_round(usm::bf16_round(of[r * L::LDO + c]) + usm::bf16_round(b2[c]));
      const float go = usm::bf16_round(usm::bf16_round(gamma[c]) * o);
      out[idx] = __float2bfloat16(__bfloat162float(x[idx]) + go);
    }
  }
}

template <int C>
cudaError_t launch(const void* x, const void* dw_w, const void* dw_b, const void* ln_w,
                   const void* ln_b, const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* gamma, void* out, int b, int h, int w, int f,
                   float eps, cudaStream_t stream) {
  const size_t bytes = Layout<C>::bytes;
  cudaError_t e = usm::allow_smem(cxblock_kernel<C>, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(((h + TH - 1) / TH) * ((w + TW - 1) / TW), b);
  cxblock_kernel<C><<<grid, WARPS * 32, bytes, stream>>>(
      static_cast<const usm::bf16*>(x), static_cast<const float*>(dw_w),
      static_cast<const float*>(dw_b), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const usm::bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const usm::bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(gamma),
      static_cast<usm::bf16*>(out), h, w, f, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int usm_cxblock_bf16(const void* x, const void* dw_w, const void* dw_b,
                                const void* ln_w, const void* ln_b, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                const void* gamma, void* out, int b, int h, int w, int c, int f,
                                float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || h <= 0 || w <= 0) return cudaSuccess;
  if (f <= 0 || f % FC) return cudaErrorInvalidValue;
  if (c != 256) return cudaErrorInvalidValue;  // the memory encoder's width in every SAM2.1 config
  return launch<256>(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, out, b, h, w, f, eps, s);
}
