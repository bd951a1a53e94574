// out = x + bf16(W2 . bf16(GELU(bf16(W1 . LN(x) + b1))) + b2) over [N, D] tokens.
//
// Replaces us_video_medsam2_tpu/kernels/fused_mlp.py:129 (ln_mlp_residual, body
// _kernel). x, W1 [F, D], W2 [D, F] and out are bf16; the LN parameters and the
// biases f32. LN takes the two-pass variance with f32 statistics; GELU is the
// exact erf form; the bf16 rounding points are those of the JAX _xla_ref.
//
// What bounds it on the H100: 4*N*D*F flop (F = 4D, so 2.42 GFLOP at every
// sam2.1_hiera_t512 stage, 2.4 us at 989 TFLOP/s) against 4*N*D + 4*D*F bytes.
// Stages 1-3 (D 96-384) are bound by operations; stage 4 (256 tokens of 768)
// by bytes, its 9.4 MB of weights (3.0 us at 3.35 TB/s). At batch 1 a grid of
// token tiles alone would leave most of the 132 SMs idle (16 tiles of 64
// tokens at (1024, 384), 8 tiles of 32 at (256, 768)), so the hidden axis F is
// split across blocks too, as the JAX kernel's f_chunks split its W2
// contraction into f32 partial sums:
//  * ln_mlp_residual_kernel<D, SPLIT>, grid (token tiles, splits). Block
//    (tile, s) copies its BM tokens into shared memory by cp.async, ahead of
//    the first weights, normalises them there in place as bf16, then walks
//    the FC-wide hidden chunks of split s (a contiguous run of F / FC chunks,
//    split evenly). Each chunk's W1 rows [FC, D] and W2 columns [D, FC] arrive
//    by cp.async into a ring of NS shared-memory slots, the next ones in flight
//    while the current one is computed. Both products run on
//    mma.sync.m16n8k16 (bf16 operands from ldmatrix, f32 accumulators in
//    registers). A warp is one 16-token row group times one of CG column
//    groups: in h = LN(x) . W1c^T it computes FC / CG hidden units of its rows
//    and applies b1, the bf16 round, GELU and the bf16 round in registers. With
//    CG = 1 (D <= 192) those accumulators are, packed, the A fragments of the
//    second product; with CG > 1 the warps of a row group pass them to each
//    other through a bf16 [BM, FC] slab, since one warp holding all D output
//    columns of 16 rows would need D / 2 accumulator registers a thread (384 at
//    D 768). Each warp's [16, D / CG] output partial stays in f32 registers
//    across the split's chunks.
//  * with one split the block writes x + bf16(o + b2). With several, each
//    block writes its f32 partial into ws [S, N, D], and
//    ln_mlp_residual_combine_kernel sums the partials in the fixed order
//    0..S-1 in f32, adds b2, rounds to bf16 and adds x. No partial is rounded
//    to bf16, and two calls on the same inputs give the same bits.
// The [N, F] hidden activation never reaches device memory. mlp_splits() in
// kernels/ln_mlp_residual.py picks S from the shape with the BM and FC of Cfg:
// as many splits as let the grid run in one wave (132 SMs times the blocks an
// SM holds, usm_ln_mlp_residual_blocks_per_sm), since a block past the wave
// starts a second one that costs as much as the first.
#include "warp_mma.cuh"

namespace {

using namespace usm;

// BM tokens a block, CG warps across the output columns, FC hidden units a
// chunk, NS ring slots (as many as fit in 227 KB beside the token tile)
template <int D>
struct Cfg;
template <>
struct Cfg<96> {
  static constexpr int BM = 64, CG = 1, FC = 64, NS = 3;
};
template <>
struct Cfg<192> {
  static constexpr int BM = 64, CG = 1, FC = 64, NS = 3;
};
template <>
struct Cfg<384> {
  static constexpr int BM = 64, CG = 2, FC = 64, NS = 3;
};
template <>
struct Cfg<768> {
  static constexpr int BM = 32, CG = 4, FC = 32, NS = 2;
};

template <int D>
struct Layout {
  using C = Cfg<D>;
  static constexpr int WARPS = C::BM / 16 * C::CG;
  static constexpr int THREADS = WARPS * 32;
  // bf16 row strides: a multiple of 8 elements (16-byte rows) whose 8 ldmatrix
  // rows fall in distinct banks
  static constexpr int LDY = D + 8;      // LN tile and W1 chunk rows
  static constexpr int LDF = C::FC + 8;  // W2 chunk rows and the h slab
  static constexpr int SLOT_ELEMS = C::FC * LDY > D * LDF ? C::FC * LDY : D * LDF;
  static constexpr size_t slot = align128(sizeof(bf16) * SLOT_ELEMS);
  static constexpr size_t ys = 0;
  static constexpr size_t hs = align128(ys + sizeof(bf16) * C::BM * LDY);
  static constexpr size_t ring = align128(hs + (C::CG > 1 ? sizeof(bf16) * C::BM * LDF : 0));
  static constexpr size_t bytes = ring + C::NS * slot;
};

__device__ __forceinline__ float gelu(float h) { return 0.5f * h * (1.f + erff(h * 0.70710678118654752f)); }

template <int D, bool SPLIT>
__global__ void __launch_bounds__(Layout<D>::THREADS, 1) ln_mlp_residual_kernel(
    const bf16* __restrict__ x, const float* __restrict__ ln_w, const float* __restrict__ ln_b,
    const bf16* __restrict__ w1, const float* __restrict__ b1, const bf16* __restrict__ w2,
    const float* __restrict__ b2, bf16* __restrict__ out, float* __restrict__ part, int n, int f,
    float eps) {
  using C = Cfg<D>;
  using L = Layout<D>;
  constexpr int FC = C::FC, CG = C::CG, NS = C::NS;
  constexpr int HW = FC / CG;  // hidden units of a warp in the first product
  constexpr int HN = HW / 8;   // its n8 tiles
  constexpr int DW = D / CG;   // output columns of a warp
  constexpr int ON = DW / 8;   // its n8 tiles
  constexpr int KF = FC / 16;  // k-steps of the second product
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem + L::ys);
  bf16* hs = reinterpret_cast<bf16*>(smem + L::hs);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp / CG, cq = warp % CG;
  const int row0 = blockIdx.x * C::BM;
  const int chunks = f / FC;
  const int c_lo = blockIdx.y * chunks / gridDim.y;
  const int entries = 2 * ((blockIdx.y + 1) * chunks / gridDim.y - c_lo);

  // ring entry 2j: W1 rows of chunk c_lo + j, [FC, D]; entry 2j + 1: its W2 columns, [D, FC]
  auto slot = [&](int e) { return reinterpret_cast<bf16*>(smem + L::ring + (e % NS) * L::slot); };
  auto load_entry = [&](int e) {
    bf16* dst = slot(e);
    const int c0 = (c_lo + e / 2) * FC;
    if ((e & 1) == 0) {
      constexpr int CH = D / 8;
      for (int i = threadIdx.x; i < FC * CH; i += L::THREADS) {
        const int r = i / CH, c = i % CH;
        cp_async16(smem_u32(dst + r * L::LDY + c * 8), w1 + (size_t)(c0 + r) * D + c * 8, true);
      }
    } else {
      constexpr int CH = FC / 8;
      for (int i = threadIdx.x; i < D * CH; i += L::THREADS) {
        const int r = i / CH, c = i % CH;
        cp_async16(smem_u32(dst + r * L::LDF + c * 8), w2 + (size_t)r * f + c0 + c * 8, true);
      }
    }
  };
  // the token tile into shared memory (rows past n zero-filled), then the first weights
  {
    constexpr int CH = D / 8;
    for (int i = threadIdx.x; i < C::BM * CH; i += L::THREADS) {
      const int r = i / CH, c = i % CH;
      const bool ok = row0 + r < n;
      cp_async16(smem_u32(ys + r * L::LDY + c * 8), x + (size_t)(ok ? row0 + r : 0) * D + c * 8, ok);
    }
    cp_commit();
  }
  for (int e = 0; e < NS - 1; ++e) {
    if (e < entries) load_entry(e);
    cp_commit();
  }
  cp_wait<NS - 1>();  // the token tile has landed
  __syncthreads();

  // LayerNorm of the tile in place (two-pass variance, f32), one warp a row, while the weights land
  constexpr int PER = D / 32;
  for (int r = warp; r < C::BM && row0 + r < n; r += L::WARPS) {
    bf16* yrow = ys + r * L::LDY;
    float v[PER];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] = __bfloat162float(yrow[lane + 32 * i]);
      s += v[i];
    }
    const float mean = warp_sum(s) / D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) sq += (v[i] - mean) * (v[i] - mean);
    const float rstd = rsqrtf(warp_sum(sq) / D + eps);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      yrow[c] = __float2bfloat16((v[i] - mean) * rstd * ln_w[c] + ln_b[c]);
    }
  }

  float o[ON][4];
#pragma unroll
  for (int j = 0; j < ON; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  uint32_t ha[CG == 1 ? KF : 1][4];  // CG == 1: the chunk's h as A fragments
  const uint32_t y_addr = smem_u32(ys + rg * 16 * L::LDY + a_off(lane, L::LDY));
  const uint32_t h_addr = smem_u32(hs + rg * 16 * L::LDF + a_off(lane, L::LDF));
  const int h0 = cq * HW;  // the warp's first hidden unit within a chunk

  for (int e = 0; e < entries; ++e) {
    cp_wait<NS - 2>();  // entry e has landed (and every group before it)
    __syncthreads();    // for every warp; and every warp is done with entry e - 1's slot
    if (e + NS - 1 < entries) load_entry(e + NS - 1);
    cp_commit();
    const uint32_t w_addr = smem_u32(slot(e));
    if ((e & 1) == 0) {
      // h[16, HW] = y . W1c^T over the warp's hidden units
      float h[HN][4];
#pragma unroll
      for (int j = 0; j < HN; ++j) h[j][0] = h[j][1] = h[j][2] = h[j][3] = 0.f;
      float bias[HN][2];  // b1 of the warp's columns, loaded ahead of the products
      const float* b1c = b1 + (c_lo + e / 2) * FC + h0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < HN; ++j) bias[j][0] = b1c[j * 8], bias[j][1] = b1c[j * 8 + 1];
      const uint32_t b_addr = w_addr + (h0 * L::LDY + b_off(lane, L::LDY)) * 2;
      if constexpr (HN == 1) {
        // one n8 tile: four accumulators over interleaved k-steps, so that four
        // mma chains are in flight instead of one
        float hp[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) hp[q][0] = hp[q][1] = hp[q][2] = hp[q][3] = 0.f;
        static_assert(D % 64 == 0, "four chains of D / 64 k-steps");
#pragma unroll 4
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4], b[2];
          ldsm_x4(y_addr + kk * 32, a);
          ldsm_x2(b_addr + kk * 32, b);
          mma(hp[kk & 3], a, b[0], b[1]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) h[0][c] = (hp[0][c] + hp[1][c]) + (hp[2][c] + hp[3][c]);
      } else {
#pragma unroll 4
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4];
          ldsm_x4(y_addr + kk * 32, a);
#pragma unroll
          for (int nj = 0; nj < HN / 2; ++nj) {
            uint32_t b[4];
            ldsm_x4(b_addr + (nj * 16 * L::LDY + kk * 16) * 2, b);
            mma(h[2 * nj], a, b[0], b[1]);
            mma(h[2 * nj + 1], a, b[2], b[3]);
          }
        }
      }
      // b1, bf16 round, GELU; the bf16 round of GELU is the pack
#pragma unroll
      for (int j = 0; j < HN; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          h[j][c] = gelu(bf16_round(h[j][c] + bias[j][c]));
          h[j][2 + c] = gelu(bf16_round(h[j][2 + c] + bias[j][c]));
        }
      }
      if constexpr (CG == 1) {
#pragma unroll
        for (int kk = 0; kk < KF; ++kk) {
          ha[kk][0] = pack_bf16(h[2 * kk][0], h[2 * kk][1]);
          ha[kk][1] = pack_bf16(h[2 * kk][2], h[2 * kk][3]);
          ha[kk][2] = pack_bf16(h[2 * kk + 1][0], h[2 * kk + 1][1]);
          ha[kk][3] = pack_bf16(h[2 * kk + 1][2], h[2 * kk + 1][3]);
        }
      } else {
        bf16* hrow = hs + (rg * 16 + g) * L::LDF + h0 + 2 * t4;
#pragma unroll
        for (int j = 0; j < HN; ++j) {
          *reinterpret_cast<uint32_t*>(hrow + j * 8) = pack_bf16(h[j][0], h[j][1]);
          *reinterpret_cast<uint32_t*>(hrow + 8 * L::LDF + j * 8) = pack_bf16(h[j][2], h[j][3]);
        }
      }
    } else {
      // o[16, DW] += h . W2c^T over the warp's output columns
      const uint32_t b_addr = w_addr + (cq * DW * L::LDF + b_off(lane, L::LDF)) * 2;
#pragma unroll
      for (int kk = 0; kk < KF; ++kk) {
        uint32_t a[4];
        if constexpr (CG == 1) {
          a[0] = ha[kk][0];
          a[1] = ha[kk][1];
          a[2] = ha[kk][2];
          a[3] = ha[kk][3];
        } else {
          ldsm_x4(h_addr + kk * 32, a);
        }
#pragma unroll
        for (int nn = 0; nn < DW / 16; ++nn) {
          uint32_t b[4];
          ldsm_x4(b_addr + (nn * 16 * L::LDF + kk * 16) * 2, b);
          mma(o[2 * nn], a, b[0], b[1]);
          mma(o[2 * nn + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_wait<0>();

  // epilogue: x + bf16(o + b2), or the f32 partial of this split
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + rg * 16 + g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < ON; ++j) {
      const int col = cq * DW + j * 8 + 2 * t4;
      if constexpr (SPLIT) {
        *reinterpret_cast<float2*>(part + ((size_t)blockIdx.y * n + row) * D + col) =
            make_float2(o[j][2 * r], o[j][2 * r + 1]);
      } else {
        const size_t idx = (size_t)row * D + col;
        const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + idx);
        *reinterpret_cast<__nv_bfloat162*>(out + idx) = __floats2bfloat162_rn(
            __bfloat162float(xv.x) + bf16_round(o[j][2 * r] + b2[col]),
            __bfloat162float(xv.y) + bf16_round(o[j][2 * r + 1] + b2[col + 1]));
      }
    }
  }
}

// out = x + bf16(sum_{s = 0..S-1} part[s] + b2), the sum in that order; 4 columns a thread
template <int D>
__global__ void __launch_bounds__(256) ln_mlp_residual_combine_kernel(
    const float* __restrict__ part, const bf16* __restrict__ x, const float* __restrict__ b2,
    bf16* __restrict__ out, int n, int splits) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= (size_t)n * (D / 4)) return;
  const size_t idx = i * 4;  // row-major [n, D] element of this thread's first column
  const int col = (int)(idx % D);
  float4 acc = *reinterpret_cast<const float4*>(part + idx);
  for (int s = 1; s < splits; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(part + (size_t)s * n * D + idx);
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(x + idx);
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out + idx);
  dst[0] = __floats2bfloat162_rn(__bfloat162float(xv[0].x) + bf16_round(acc.x + b2[col]),
                                 __bfloat162float(xv[0].y) + bf16_round(acc.y + b2[col + 1]));
  dst[1] = __floats2bfloat162_rn(__bfloat162float(xv[1].x) + bf16_round(acc.z + b2[col + 2]),
                                 __bfloat162float(xv[1].y) + bf16_round(acc.w + b2[col + 3]));
}

template <int D, bool SPLIT>
cudaError_t launch_main(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                        const void* b1, const void* w2, const void* b2, void* out, void* part, int n,
                        int f, int splits, float eps, cudaStream_t stream) {
  using L = Layout<D>;
  cudaError_t e = allow_smem(ln_mlp_residual_kernel<D, SPLIT>, L::bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + Cfg<D>::BM - 1) / Cfg<D>::BM, splits);
  ln_mlp_residual_kernel<D, SPLIT><<<grid, L::THREADS, L::bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), static_cast<float*>(part), n, f, eps);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* x, const void* ln_w, const void* ln_b, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, void* part, int n, int f, int splits,
                   float eps, cudaStream_t stream) {
  if (f % Cfg<D>::FC || splits > f / Cfg<D>::FC) return cudaErrorInvalidValue;
  if (splits == 1)
    return launch_main<D, false>(x, ln_w, ln_b, w1, b1, w2, b2, out, nullptr, n, f, 1, eps, stream);
  if (!part) return cudaErrorInvalidValue;
  cudaError_t e = launch_main<D, true>(x, ln_w, ln_b, w1, b1, w2, b2, out, part, n, f, splits, eps, stream);
  if (e != cudaSuccess) return e;
  const size_t threads = (size_t)n * (D / 4);
  ln_mlp_residual_combine_kernel<D><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const bf16*>(x), static_cast<const float*>(b2),
      static_cast<bf16*>(out), n, splits);
  return cudaGetLastError();
}

template <int D, bool SPLIT>
cudaError_t occupancy(int* blocks) {
  using L = Layout<D>;
  cudaError_t e = allow_smem(ln_mlp_residual_kernel<D, SPLIT>, L::bytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ln_mlp_residual_kernel<D, SPLIT>,
                                                       L::THREADS, L::bytes);
}

template <int D>
cudaError_t occupancy(int split, int* blocks) {
  return split ? occupancy<D, true>(blocks) : occupancy<D, false>(blocks);
}

}  // namespace

// Blocks of the kernel at this D (split or not) that one SM holds at once.
extern "C" int usm_ln_mlp_residual_blocks_per_sm(int d, int split, int* blocks) {
  switch (d) {
    case 96: return occupancy<96>(split, blocks);
    case 192: return occupancy<192>(split, blocks);
    case 384: return occupancy<384>(split, blocks);
    case 768: return occupancy<768>(split, blocks);
    default: return cudaErrorInvalidValue;
  }
}

// part [splits, n, d] f32 is scratch, unused (may be null) when splits == 1.
extern "C" int usm_ln_mlp_residual_bf16(const void* x, const void* ln_w, const void* ln_b,
                                        const void* w1, const void* b1, const void* w2,
                                        const void* b2, void* out, void* part, int n, int d, int f,
                                        int splits, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return cudaSuccess;
  if (f <= 0 || splits <= 0) return cudaErrorInvalidValue;
  switch (d) {
    case 96: return launch<96>(x, ln_w, ln_b, w1, b1, w2, b2, out, part, n, f, splits, eps, s);
    case 192: return launch<192>(x, ln_w, ln_b, w1, b1, w2, b2, out, part, n, f, splits, eps, s);
    case 384: return launch<384>(x, ln_w, ln_b, w1, b1, w2, b2, out, part, n, f, splits, eps, s);
    case 768: return launch<768>(x, ln_w, ln_b, w1, b1, w2, b2, out, part, n, f, splits, eps, s);
    default: return cudaErrorInvalidValue;
  }
}
