// Flash attention with attention-weight dropout after the softmax (training
// memory attention): forward with the row logsumexp, and its backward.
//
// Replaces us_video_medsam2_tpu/kernels/flash_dropout.py (flash_attention_train:
// _fwd_kernel at _fwd_call, _bwd_kernel at _bwd_call). q [BH, Lq, D], k/v
// [BH, Lk, D] bf16, mask [B, Lk] uint8 (1 = attend, may be null), D = 256.
//
// Keep decision: the murmur3 finalizer over the element's global index
// (bh * Lq + q) * Lk + k, mixed with seed * 0x9e3779b9, all in wrapping 32-bit
// unsigned arithmetic (bit-identical to the JAX int32 form with its logical
// shifts); keep when the hash >= thr = round(rate * 2^32). Masked keys score
// -1e30 and keys past Lk score -inf, as in the JAX kernel.
//
// Bound on this card: operations at the training shapes (forward 4·Lq·Lk·D
// flop, backward 10·Lq·Lk·D over the unmasked keys, against ~4·(Lq + Lk)·D
// bytes: hundreds of flop per byte at Lq = 1024, D = 256). The designs keep
// every [Lq, Lk] tile (scores, probabilities, keep mask, dP, dS) in shared
// memory, run the five products on bf16 tensor cores (WMMA, f32 accumulation),
// and skip key tiles whose keys are all masked when the batch has a valid key
// (those tiles contribute exact zeros: memory banks early in a video hold
// mostly invalid slots). No wgmma or TMA yet.
//
// Forward (one block of 4 warps per 64-query tile): the Q tile stays in shared
// memory, 64-key K/V tiles stream through it, online softmax in f32 whose
// normaliser sums the UNDROPPED probabilities; only P·V sees the keep mask and
// the 1/(1 - rate) scale. Writes out = O / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)).
//
// Backward: the TPU kernel walks its grid in order and carries dq across the
// k-blocks in VMEM. Blocks on Hopper run in parallel and in no order, so the
// backward is split as in FlashAttention-2: one kernel over key blocks writes
// dk and dv (its keys resident, query tiles streamed), a second over query
// blocks writes dq (its queries resident, key tiles streamed). Each recomputes
// P = exp(min(s - lse, 0)) from the saved lse (the min guards rows at the
// -1e30 floor) and dS = P * (dP * keep / (1 - rate) - delta), rounded to bf16
// as the JAX kernel rounds it. Chosen over f32 atomics into a zeroed dq: no
// zeroing pass, no atomic traffic, and the same result on every run; the
// price is S and dP computed twice. dS is zero on masked keys (the gradient
// of a constant score), and a batch whose keys are all masked takes its
// exact uniform probability 1/Lk (its lse sits at the -1e30 floor, where
// f32 has lost log Lk).
#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int D = 256;
constexpr int LDQ = D + 8;  // bf16 row stride of q/k/v/dO tiles
constexpr int LDO = D + 4;  // f32 row stride of an accumulator slab
constexpr float MASKED = -1e30f;

__device__ __forceinline__ unsigned keep_hash(unsigned idx, unsigned seed_mix) {
  unsigned h = idx ^ seed_mix;
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// dropout factor of element (bh, qi, key): 0 or 1 / (1 - rate)
__device__ __forceinline__ float keep_factor(int bh, int qi, int key, int lq, int lk,
                                             unsigned seed_mix, unsigned thr, float inv_keep) {
  if (thr == 0u) return 1.f;
  const unsigned idx = ((unsigned)bh * (unsigned)lq + (unsigned)qi) * (unsigned)lk + (unsigned)key;
  return keep_hash(idx, seed_mix) >= thr ? inv_keep : 0.f;
}

// rows [row0, row0 + rows) of a [*, D] bf16 matrix into a tile, zeros past `valid`
template <int THREADS>
__device__ __forceinline__ void load_rows(usm::bf16* dst, const usm::bf16* src, int row0, int rows,
                                          int valid) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH, ch = i % CH;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < valid) v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + ch * 8);
    *reinterpret_cast<uint4*>(dst + r * LDQ + ch * 8) = v;
  }
}

// whether the batch row of the mask has any key to attend (the whole block agrees)
__device__ __forceinline__ bool batch_has_valid(const unsigned char* mrow, int lk) {
  if (!mrow) return true;
  int any = 0;
  for (int i = threadIdx.x; i < lk && !any; i += blockDim.x) any = mrow[i];
  return __syncthreads_or(any) != 0;
}

// whether keys [k0, k0 + n) hold a valid one (the whole block agrees)
__device__ __forceinline__ bool tile_has_valid(const unsigned char* mrow, int k0, int n, int lk) {
  if (!mrow) return true;
  int any = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) any |= (k0 + i < lk) && mrow[k0 + i];
  return __syncthreads_or(any) != 0;
}

// acc[16, D] (f32 slab, ld LDO) += A[16, K] (bf16, ld lda) . B[K, D] (bf16 rows, ld LDQ)
template <int K>
__device__ __forceinline__ void slab_mma_rows(float* acc, const usm::bf16* a, int lda,
                                              const usm::bf16* b) {
#pragma unroll 2
  for (int j = 0; j < D / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::load_matrix_sync(c, acc + j * 16, LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, usm::bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, usm::bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, lda);
      wmma::load_matrix_sync(fb, b + kk * 16 * LDQ + j * 16, LDQ);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(acc + j * 16, c, LDO, wmma::mem_row_major);
  }
}

// out[16, N] (f32, ld ldo) = A[16, D] (bf16 rows, ld LDQ) . B[N, D]^T (bf16 rows, ld LDQ)
template <int N>
__device__ __forceinline__ void slab_mma_nt(float* out, int ldo, const usm::bf16* a,
                                            const usm::bf16* b) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, usm::bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, usm::bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LDQ);
      wmma::load_matrix_sync(fb, b + j * 16 * LDQ + kk * 16, LDQ);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(out + j * 16, c, ldo, wmma::mem_row_major);
  }
}

// ------------------------------------------------------------------ forward
namespace fwd {
constexpr int WARPS = 4;
constexpr int BQ = 16 * WARPS;
constexpr int BK = 64;
constexpr int LDS = BK + 4;
constexpr int LDP = BK + 8;
constexpr size_t qs = 0;
constexpr size_t ks = usm::align128(qs + sizeof(usm::bf16) * BQ * LDQ);
constexpr size_t vs = usm::align128(ks + sizeof(usm::bf16) * BK * LDQ);
constexpr size_t warp0 = usm::align128(vs + sizeof(usm::bf16) * BK * LDQ);
constexpr size_t w_ss = 0;
constexpr size_t w_ps = usm::align128(w_ss + sizeof(float) * 16 * LDS);
constexpr size_t w_os = usm::align128(w_ps + sizeof(usm::bf16) * 16 * LDP);
constexpr size_t w_stats = usm::align128(w_os + sizeof(float) * 16 * LDO);
constexpr size_t warp_bytes = usm::align128(w_stats + sizeof(float) * 3 * 16);
constexpr size_t bytes = warp0 + WARPS * warp_bytes;

__global__ void __launch_bounds__(WARPS * 32) kernel(
    const usm::bf16* __restrict__ q, const usm::bf16* __restrict__ k,
    const usm::bf16* __restrict__ v, const unsigned char* __restrict__ mask,
    usm::bf16* __restrict__ out, float* __restrict__ lse, int h, int lq, int lk, float scale,
    unsigned seed_mix, unsigned thr, float inv_keep) {
  extern __shared__ __align__(128) unsigned char smem[];
  usm::bf16* qsm = reinterpret_cast<usm::bf16*>(smem + qs);
  usm::bf16* ksm = reinterpret_cast<usm::bf16*>(smem + ks);
  usm::bf16* vsm = reinterpret_cast<usm::bf16*>(smem + vs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* wb = smem + warp0 + warp * warp_bytes;
  float* ss = reinterpret_cast<float*>(wb + w_ss);
  usm::bf16* ps = reinterpret_cast<usm::bf16*>(wb + w_ps);
  float* os = reinterpret_cast<float*>(wb + w_os);
  float* m_run = reinterpret_cast<float*>(wb + w_stats);
  float* l_run = m_run + 16;
  float* alpha = m_run + 32;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t off_q = (size_t)bh * lq * D;
  const size_t off_k = (size_t)bh * lk * D;
  const unsigned char* mrow = mask ? mask + (size_t)(bh / h) * lk : nullptr;
  const bool has_valid = batch_has_valid(mrow, lk);

  load_rows<WARPS * 32>(qsm, q + off_q, q0, BQ, lq);
  for (int i = lane; i < 16 * LDO; i += 32) os[i] = 0.f;
  if (lane < 16) {
    m_run[lane] = -INFINITY;
    l_run[lane] = 0.f;
  }
  const usm::bf16* qw = qsm + warp * 16 * LDQ;
  const int row = lane >> 1, half = lane & 1;  // lanes 2r, 2r+1: row r, 32 keys each
  const int qi = q0 + warp * 16 + row;

  for (int k0 = 0; k0 < lk; k0 += BK) {
    // a tile of masked keys adds exact zeros once the row has a valid key
    if (has_valid && !tile_has_valid(mrow, k0, BK, lk)) continue;
    __syncthreads();  // previous tile consumed, Q loaded on the first pass
    load_rows<WARPS * 32>(ksm, k + off_k, k0, BK, lk);
    load_rows<WARPS * 32>(vsm, v + off_k, k0, BK, lk);
    __syncthreads();

    slab_mma_nt<BK>(ss, LDS, qw, ksm);  // S = Q_w . K^T  [16, 64]
    __syncwarp();
    {
      float* srow = ss + row * LDS + half * 32;
      float tmax = -INFINITY;
      for (int c = 0; c < 32; ++c) {
        const int key = k0 + half * 32 + c;
        float s;
        if (key >= lk) s = -INFINITY;
        else if (mrow && !mrow[key]) s = MASKED;
        else s = srow[c] * scale;
        srow[c] = s;
        tmax = fmaxf(tmax, s);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      const float m_old = m_run[row];
      const float m_new = fmaxf(m_old, tmax);
      float psum = 0.f;
      usm::bf16* prow = ps + row * LDP + half * 32;
      for (int c = 0; c < 32; ++c) {
        const float p = expf(srow[c] - m_new);
        psum += p;  // the normaliser sums undropped probabilities
        const int key = k0 + half * 32 + c;
        prow[c] = __float2bfloat16(p * keep_factor(bh, qi, key, lq, lk, seed_mix, thr, inv_keep));
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      const float a = expf(m_old - m_new);
      __syncwarp();
      if (half == 0) {
        alpha[row] = a;
        m_run[row] = m_new;
        l_run[row] = l_run[row] * a + psum;
      }
    }
    __syncwarp();
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = i / D, c = i % D;
      os[r * LDO + c] *= alpha[r];
    }
    __syncwarp();
    slab_mma_rows<BK>(os, ps, LDP, vsm);  // O += P_dropped . V
    __syncwarp();
  }

  for (int i = lane; i < 16 * (D / 2); i += 32) {
    const int r = i / (D / 2), c2 = (i % (D / 2)) * 2;
    const int qr = q0 + warp * 16 + r;
    if (qr < lq) {
      const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
      *reinterpret_cast<__nv_bfloat162*>(out + off_q + (size_t)qr * D + c2) =
          __floats2bfloat162_rn(os[r * LDO + c2] * inv, os[r * LDO + c2 + 1] * inv);
    }
  }
  if (lane < 16 && q0 + warp * 16 + lane < lq)
    lse[(size_t)bh * lq + q0 + warp * 16 + lane] = m_run[lane] + logf(fmaxf(l_run[lane], 1e-30f));
}
}  // namespace fwd

// P, dropped P and dS of one [16, N] slab from S and dP (f32 slabs, ld lds):
// rows are `rows_are_keys ? keys : queries`. Writes bf16 P·keep (if pd) and dS.
struct SlabArgs {
  const unsigned char* mrow;
  const float* lse;    // indexed by query offset in the q tile
  const float* delta;  // idem
  int bh, lq, lk, q0, k0;
  bool has_valid;
  float scale, inv_lk, inv_keep;
  unsigned seed_mix, thr;
};

template <int N, bool ROWS_ARE_KEYS>
__device__ __forceinline__ void slab_grads(const SlabArgs& a, int row_base, float* ss, float* dps,
                                           int lds, usm::bf16* pd, usm::bf16* ds, int ldp) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < 16 * N; i += 32) {
    const int r = i / N, c = i % N;
    const int key = ROWS_ARE_KEYS ? a.k0 + row_base + r : a.k0 + c;
    const int qoff = ROWS_ARE_KEYS ? c : row_base + r;
    const int qi = a.q0 + qoff;
    float p = 0.f, dsv = 0.f;
    if (key < a.lk) {
      const bool attend = !a.mrow || a.mrow[key];
      if (!a.has_valid) p = a.inv_lk;  // every key masked: uniform
      else if (attend) p = expf(fminf(ss[r * lds + c] * a.scale - a.lse[qoff], 0.f));
      const float kf = keep_factor(a.bh, qi, key, a.lq, a.lk, a.seed_mix, a.thr, a.inv_keep);
      if (pd) pd[r * ldp + c] = __float2bfloat16(p * kf);
      if (attend) dsv = p * (dps[r * lds + c] * kf - a.delta[qoff]);
    } else if (pd) {
      pd[r * ldp + c] = __float2bfloat16(0.f);
    }
    ds[r * ldp + c] = __float2bfloat16(dsv);
  }
}

// ------------------------------------------------------- backward: dk, dv
namespace bwd_kv {
constexpr int WARPS = 2;
constexpr int BK = 16 * WARPS;  // keys per block
constexpr int BQ = 64;          // queries per streamed tile
constexpr int LDS = BQ + 4;
constexpr int LDP = BQ + 8;
constexpr size_t ks = 0;
constexpr size_t vs = usm::align128(ks + sizeof(usm::bf16) * BK * LDQ);
constexpr size_t qs = usm::align128(vs + sizeof(usm::bf16) * BK * LDQ);
constexpr size_t gs = usm::align128(qs + sizeof(usm::bf16) * BQ * LDQ);
constexpr size_t lses = usm::align128(gs + sizeof(usm::bf16) * BQ * LDQ);
constexpr size_t deltas = lses + sizeof(float) * BQ;
constexpr size_t warp0 = usm::align128(deltas + sizeof(float) * BQ);
constexpr size_t w_st = 0;  // S^T [16 keys, BQ] f32
constexpr size_t w_dpt = usm::align128(w_st + sizeof(float) * 16 * LDS);
constexpr size_t w_pd = usm::align128(w_dpt + sizeof(float) * 16 * LDS);
constexpr size_t w_ds = usm::align128(w_pd + sizeof(usm::bf16) * 16 * LDP);
constexpr size_t w_dk = usm::align128(w_ds + sizeof(usm::bf16) * 16 * LDP);
constexpr size_t w_dv = usm::align128(w_dk + sizeof(float) * 16 * LDO);
constexpr size_t warp_bytes = usm::align128(w_dv + sizeof(float) * 16 * LDO);
constexpr size_t bytes = warp0 + WARPS * warp_bytes;

__global__ void __launch_bounds__(WARPS * 32) kernel(
    const usm::bf16* __restrict__ q, const usm::bf16* __restrict__ k,
    const usm::bf16* __restrict__ v, const usm::bf16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const unsigned char* __restrict__ mask, usm::bf16* __restrict__ dk,
    usm::bf16* __restrict__ dv, int h, int lq, int lk, float scale, unsigned seed_mix,
    unsigned thr, float inv_keep) {
  extern __shared__ __align__(128) unsigned char smem[];
  usm::bf16* ksm = reinterpret_cast<usm::bf16*>(smem + ks);
  usm::bf16* vsm = reinterpret_cast<usm::bf16*>(smem + vs);
  usm::bf16* qsm = reinterpret_cast<usm::bf16*>(smem + qs);
  usm::bf16* gsm = reinterpret_cast<usm::bf16*>(smem + gs);
  float* lse_s = reinterpret_cast<float*>(smem + lses);
  float* delta_s = reinterpret_cast<float*>(smem + deltas);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* wb = smem + warp0 + warp * warp_bytes;
  float* st = reinterpret_cast<float*>(wb + w_st);
  float* dpt = reinterpret_cast<float*>(wb + w_dpt);
  usm::bf16* pdt = reinterpret_cast<usm::bf16*>(wb + w_pd);
  usm::bf16* dst = reinterpret_cast<usm::bf16*>(wb + w_ds);
  float* dk_acc = reinterpret_cast<float*>(wb + w_dk);
  float* dv_acc = reinterpret_cast<float*>(wb + w_dv);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const size_t off_q = (size_t)bh * lq * D;
  const size_t off_k = (size_t)bh * lk * D;
  const unsigned char* mrow = mask ? mask + (size_t)(bh / h) * lk : nullptr;
  SlabArgs a{mrow, lse_s, delta_s, bh, lq, lk, 0, k0, batch_has_valid(mrow, lk),
             scale, 1.f / (float)lk, inv_keep, seed_mix, thr};
  const bool skip = a.has_valid && !tile_has_valid(mrow, k0, BK, lk);

  for (int i = lane; i < 16 * LDO; i += 32) dk_acc[i] = dv_acc[i] = 0.f;
  if (!skip) {
    load_rows<WARPS * 32>(ksm, k + off_k, k0, BK, lk);
    load_rows<WARPS * 32>(vsm, v + off_k, k0, BK, lk);
    const usm::bf16* kw = ksm + warp * 16 * LDQ;
    const usm::bf16* vw = vsm + warp * 16 * LDQ;
    for (int q0 = 0; q0 < lq; q0 += BQ) {
      __syncthreads();  // previous q tile consumed (and K/V loaded on the first pass)
      load_rows<WARPS * 32>(qsm, q + off_q, q0, BQ, lq);
      load_rows<WARPS * 32>(gsm, g + off_q, q0, BQ, lq);
      for (int i = threadIdx.x; i < BQ; i += WARPS * 32) {
        const bool in = q0 + i < lq;  // padded rows: P = exp(-inf) = 0, dO = 0
        lse_s[i] = in ? lse[(size_t)bh * lq + q0 + i] : INFINITY;
        delta_s[i] = in ? delta[(size_t)bh * lq + q0 + i] : 0.f;
      }
      __syncthreads();
      a.q0 = q0;
      slab_mma_nt<BQ>(st, LDS, kw, qsm);   // S^T = K_w . Q^T   [16 keys, BQ]
      slab_mma_nt<BQ>(dpt, LDS, vw, gsm);  // dP^T = V_w . dO^T [16 keys, BQ]
      __syncwarp();
      slab_grads<BQ, true>(a, warp * 16, st, dpt, LDS, pdt, dst, LDP);
      __syncwarp();
      slab_mma_rows<BQ>(dv_acc, pdt, LDP, gsm);  // dV_w += (P·keep)^T . dO
      slab_mma_rows<BQ>(dk_acc, dst, LDP, qsm);  // dK_w += dS^T . Q
      __syncwarp();
    }
  }
  for (int i = lane; i < 16 * (D / 2); i += 32) {
    const int r = i / (D / 2), c2 = (i % (D / 2)) * 2;
    const int key = k0 + warp * 16 + r;
    if (key < lk) {
      const size_t o = off_k + (size_t)key * D + c2;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) =
          __floats2bfloat162_rn(dk_acc[r * LDO + c2] * scale, dk_acc[r * LDO + c2 + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + o) =
          __floats2bfloat162_rn(dv_acc[r * LDO + c2], dv_acc[r * LDO + c2 + 1]);
    }
  }
}
}  // namespace bwd_kv

// ------------------------------------------------------------- backward: dq
namespace bwd_q {
constexpr int WARPS = 4;
constexpr int BQ = 16 * WARPS;  // queries per block
constexpr int BK = 32;          // keys per streamed tile
constexpr int LDS = BK + 4;
constexpr int LDP = BK + 8;
constexpr size_t qs = 0;
constexpr size_t gs = usm::align128(qs + sizeof(usm::bf16) * BQ * LDQ);
constexpr size_t ks = usm::align128(gs + sizeof(usm::bf16) * BQ * LDQ);
constexpr size_t vs = usm::align128(ks + sizeof(usm::bf16) * BK * LDQ);
constexpr size_t lses = usm::align128(vs + sizeof(usm::bf16) * BK * LDQ);
constexpr size_t deltas = lses + sizeof(float) * BQ;
constexpr size_t warp0 = usm::align128(deltas + sizeof(float) * BQ);
constexpr size_t w_s = 0;
constexpr size_t w_dp = usm::align128(w_s + sizeof(float) * 16 * LDS);
constexpr size_t w_ds = usm::align128(w_dp + sizeof(float) * 16 * LDS);
constexpr size_t w_dq = usm::align128(w_ds + sizeof(usm::bf16) * 16 * LDP);
constexpr size_t warp_bytes = usm::align128(w_dq + sizeof(float) * 16 * LDO);
constexpr size_t bytes = warp0 + WARPS * warp_bytes;

__global__ void __launch_bounds__(WARPS * 32) kernel(
    const usm::bf16* __restrict__ q, const usm::bf16* __restrict__ k,
    const usm::bf16* __restrict__ v, const usm::bf16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const unsigned char* __restrict__ mask, usm::bf16* __restrict__ dq, int h, int lq, int lk,
    float scale, unsigned seed_mix, unsigned thr, float inv_keep) {
  extern __shared__ __align__(128) unsigned char smem[];
  usm::bf16* qsm = reinterpret_cast<usm::bf16*>(smem + qs);
  usm::bf16* gsm = reinterpret_cast<usm::bf16*>(smem + gs);
  usm::bf16* ksm = reinterpret_cast<usm::bf16*>(smem + ks);
  usm::bf16* vsm = reinterpret_cast<usm::bf16*>(smem + vs);
  float* lse_s = reinterpret_cast<float*>(smem + lses);
  float* delta_s = reinterpret_cast<float*>(smem + deltas);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* wb = smem + warp0 + warp * warp_bytes;
  float* ss = reinterpret_cast<float*>(wb + w_s);
  float* dps = reinterpret_cast<float*>(wb + w_dp);
  usm::bf16* dsb = reinterpret_cast<usm::bf16*>(wb + w_ds);
  float* dq_acc = reinterpret_cast<float*>(wb + w_dq);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t off_q = (size_t)bh * lq * D;
  const size_t off_k = (size_t)bh * lk * D;
  const unsigned char* mrow = mask ? mask + (size_t)(bh / h) * lk : nullptr;
  SlabArgs a{mrow, lse_s, delta_s, bh, lq, lk, q0, 0, batch_has_valid(mrow, lk),
             scale, 1.f / (float)lk, inv_keep, seed_mix, thr};

  load_rows<WARPS * 32>(qsm, q + off_q, q0, BQ, lq);
  load_rows<WARPS * 32>(gsm, g + off_q, q0, BQ, lq);
  for (int i = threadIdx.x; i < BQ; i += WARPS * 32) {
    const bool in = q0 + i < lq;
    lse_s[i] = in ? lse[(size_t)bh * lq + q0 + i] : INFINITY;
    delta_s[i] = in ? delta[(size_t)bh * lq + q0 + i] : 0.f;
  }
  for (int i = lane; i < 16 * LDO; i += 32) dq_acc[i] = 0.f;
  const usm::bf16* qw = qsm + warp * 16 * LDQ;
  const usm::bf16* gw = gsm + warp * 16 * LDQ;

  for (int k0 = 0; k0 < lk; k0 += BK) {
    if (a.has_valid && !tile_has_valid(mrow, k0, BK, lk)) continue;
    __syncthreads();  // previous tile consumed (and Q, dO loaded on the first pass)
    load_rows<WARPS * 32>(ksm, k + off_k, k0, BK, lk);
    load_rows<WARPS * 32>(vsm, v + off_k, k0, BK, lk);
    __syncthreads();
    a.k0 = k0;
    slab_mma_nt<BK>(ss, LDS, qw, ksm);   // S = Q_w . K^T   [16, BK]
    slab_mma_nt<BK>(dps, LDS, gw, vsm);  // dP = dO_w . V^T [16, BK]
    __syncwarp();
    slab_grads<BK, false>(a, warp * 16, ss, dps, LDS, nullptr, dsb, LDP);
    __syncwarp();
    slab_mma_rows<BK>(dq_acc, dsb, LDP, ksm);  // dQ_w += dS . K
    __syncwarp();
  }
  for (int i = lane; i < 16 * (D / 2); i += 32) {
    const int r = i / (D / 2), c2 = (i % (D / 2)) * 2;
    const int qi = q0 + warp * 16 + r;
    if (qi < lq)
      *reinterpret_cast<__nv_bfloat162*>(dq + off_q + (size_t)qi * D + c2) =
          __floats2bfloat162_rn(dq_acc[r * LDO + c2] * scale, dq_acc[r * LDO + c2 + 1] * scale);
  }
}
}  // namespace bwd_q

}  // namespace

extern "C" int usm_flash_dropout_fwd_bf16(const void* q, const void* k, const void* v,
                                          const void* mask, void* out, void* lse, int bh, int h,
                                          int lq, int lk, int d, float scale, unsigned seed_mix,
                                          unsigned thr, float inv_keep, void* stream) {
  if (bh <= 0 || lq <= 0) return cudaSuccess;
  if (lk <= 0 || h <= 0 || d != D) return cudaErrorInvalidValue;
  cudaError_t e = usm::allow_smem(fwd::kernel, fwd::bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((lq + fwd::BQ - 1) / fwd::BQ, bh);
  fwd::kernel<<<grid, fwd::WARPS * 32, fwd::bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const usm::bf16*>(q), static_cast<const usm::bf16*>(k),
      static_cast<const usm::bf16*>(v), static_cast<const unsigned char*>(mask),
      static_cast<usm::bf16*>(out), static_cast<float*>(lse), h, lq, lk, scale, seed_mix, thr,
      inv_keep);
  return cudaGetLastError();
}

extern "C" int usm_flash_dropout_bwd_bf16(const void* q, const void* k, const void* v,
                                          const void* g, const void* lse, const void* delta,
                                          const void* mask, void* dq, void* dk, void* dv, int bh,
                                          int h, int lq, int lk, int d, float scale,
                                          unsigned seed_mix, unsigned thr, float inv_keep,
                                          void* stream) {
  if (bh <= 0 || lq <= 0) return cudaSuccess;
  if (lk <= 0 || h <= 0 || d != D) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = usm::allow_smem(bwd_kv::kernel, bwd_kv::bytes);
  if (e != cudaSuccess) return e;
  e = usm::allow_smem(bwd_q::kernel, bwd_q::bytes);
  if (e != cudaSuccess) return e;
  const auto* qp = static_cast<const usm::bf16*>(q);
  const auto* kp = static_cast<const usm::bf16*>(k);
  const auto* vp = static_cast<const usm::bf16*>(v);
  const auto* gp = static_cast<const usm::bf16*>(g);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  const auto* mp = static_cast<const unsigned char*>(mask);
  dim3 grid_kv((lk + bwd_kv::BK - 1) / bwd_kv::BK, bh);
  bwd_kv::kernel<<<grid_kv, bwd_kv::WARPS * 32, bwd_kv::bytes, s>>>(
      qp, kp, vp, gp, lp, dp, mp, static_cast<usm::bf16*>(dk), static_cast<usm::bf16*>(dv), h, lq,
      lk, scale, seed_mix, thr, inv_keep);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 grid_q((lq + bwd_q::BQ - 1) / bwd_q::BQ, bh);
  bwd_q::kernel<<<grid_q, bwd_q::WARPS * 32, bwd_q::bytes, s>>>(
      qp, kp, vp, gp, lp, dp, mp, static_cast<usm::bf16*>(dq), h, lq, lk, scale, seed_mix, thr,
      inv_keep);
  return cudaGetLastError();
}
