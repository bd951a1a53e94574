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
// bytes: hundreds of flop per byte at Lq = 1024). Both passes skip key tiles
// whose keys are all masked when the batch has a valid key (those tiles
// contribute exact zeros: memory banks early in a video hold mostly invalid
// slots), deciding on the device.
//
// Forward (one block of 4 warps per 64-query tile, WMMA, f32 slabs in shared
// memory): the Q tile stays in shared memory, 64-key K/V tiles stream through
// it, online softmax in f32 whose normaliser sums the UNDROPPED
// probabilities; only P·V sees the keep mask and the 1/(1 - rate) scale.
// Writes out = O / max(l, 1e-30) and lse = m + log(max(l, 1e-30)).
//
// Backward: the TPU kernel walks its grid in order and carries dq across the
// k-blocks in VMEM. Blocks on Hopper run in parallel and in no order, so the
// backward is split as in FlashAttention-2 into two kinds of block of one
// launch (bwd_kernel): a dk/dv block (kv_block) keeps 64 keys of K and V
// resident and streams 64-query tiles of Q and dO (with lse and delta)
// through two cp.async stages; a dq block (q_block) keeps 64 queries of Q and
// dO resident and streams 64-key tiles of K and V. Each recomputes P =
// exp(min(s - lse, 0)) from the saved lse (the min guards rows at the -1e30
// floor) and dS = P * (dP * keep / (1 - rate) - delta), rounded to bf16 as
// the JAX kernel rounds it. dS is zero on masked keys (the gradient of a
// constant score), and a batch whose keys are all masked takes its exact
// uniform probability 1/Lk (its lse sits at the -1e30 floor, where f32 has
// lost log Lk). delta = sum_d dO * O comes from a small kernel before.
//
// Both kinds run 8 warps on mma.sync.m16n8k16 with f32 accumulators in
// registers. A [64, 256] f32 accumulator is 64 registers a thread over 8
// warps, and a dk/dv block holds two, so each warp owns 16 rows x 128 columns
// of them; the score tile is cut differently (16 rows x 32 columns a warp),
// so the bf16 P·keep and dS tiles pass between the warps through shared
// memory. The dk/dv block computes S^T = K·Q^T and dP^T = V·dO^T with keys as
// rows: their bf16 transposes are then the A operands of dV += (P·keep)^T·dO
// and dK += dS^T·Q as they lie, and ldmatrix.trans feeds dO and Q as B
// operands. The keep factor of each element comes from its own (query, key).
// At B·H = 3 and Lq = Lk = 1024 either kind alone gives 48 blocks for 132
// SMs, so the dk/dv blocks also split the queries and the dq blocks the keys
// into ranges of whole tiles (counts from the shape alone: the wrapper's
// bwd_splits). Each block of a split writes f32 partials and
// sum_splits_kernel adds them in split order and rounds once, so the result
// is the same on every run (no float atomics); with one split the blocks
// round and write the gradients themselves. The dk/dv blocks come first in
// the grid and the dq blocks fill the SMs they leave, so a memory bank whose
// masked key tiles end their dk/dv blocks at once still keeps the card busy.
// S and dP are computed in both kinds (14·Lq·Lk·D flop in all).
#include "warp_mma.cuh"

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

// ------------------------------------------------------------------ backward
namespace bwd {
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BT = 64;         // rows of a resident or a streamed tile (keys or queries)
constexpr int LDX = BT + 8;    // bf16 row stride of the score tiles exchanged between warps
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t TILE = sizeof(usm::bf16) * BT * LDQ;
constexpr size_t XCH = sizeof(usm::bf16) * BT * LDX;
constexpr size_t STATS = sizeof(float) * 4 * BT;  // lse and delta of two stages
// dk/dv block: K, V resident; Q, dO in two stages; lse, delta; P·keep^T and dS^T
constexpr size_t KV_BYTES = 6 * TILE + STATS + 2 * XCH;
// dq block: Q, dO resident; K, V in two stages; dS
constexpr size_t Q_BYTES = 6 * TILE + XCH;
static_assert(KV_BYTES <= 232448 && Q_BYTES <= 232448, "a block's shared memory");

// rows [row0, row0 + BT) of a [*, D] head into a tile by cp.async, rows at or
// past `valid` zero-filled
__device__ __forceinline__ void load_tile(usm::bf16* dst, const usm::bf16* src, int row0, int valid) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < BT * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < valid;
    usm::cp_async16(usm::smem_u32(dst + r * LDQ + c * 8), src + (size_t)(ok ? row0 + r : 0) * D + c * 8,
                    ok);
  }
}

// acc[16 x 32] (4 n-tiles) = A[16 rows, D] . B[32 rows, D]^T, both row-major
// tiles of stride LDQ: a_addr / b_addr are this lane's ldmatrix addresses
// (usm::a_off, usm::b_off) of the first 16 x 16 block
__device__ __forceinline__ void nt_slab(float acc[4][4], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 4
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t a[4];
    usm::ldsm_x4(a_addr + kd * 32, a);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t b[4];
      usm::ldsm_x4(b_addr + (nj * 16 * LDQ + kd * 16) * 2, b);
      usm::mma(acc[2 * nj], a, b[0], b[1]);
      usm::mma(acc[2 * nj + 1], a, b[2], b[3]);
    }
  }
}

// acc[16 x 128] (16 n-tiles) += X[16 rows, BT] (stride LDX) . Y[BT, 128] (rows of
// stride LDQ, read with .trans): x_addr / y_addr this lane's first-block addresses
__device__ __forceinline__ void nn_acc(float acc[16][4], uint32_t x_addr, uint32_t y_addr) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    uint32_t a[4];
    usm::ldsm_x4(x_addr + kk * 32, a);
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
      uint32_t b[4];
      usm::ldsm_x4_t(y_addr + (kk * 16 * LDQ + dn * 16) * 2, b);
      usm::mma(acc[2 * dn], a, b[0], b[1]);
      usm::mma(acc[2 * dn + 1], a, b[2], b[3]);
    }
  }
}

// this thread's 16 x 128 accumulator slab, rows row0 + g and row0 + g + 8 (if
// < valid) of a [*, D] head, columns col0 + ...: bf16(acc * scale) into out,
// or the unscaled f32 partial into part when part is not null
__device__ __forceinline__ void store_slab(const float acc[16][4], int row0, int col0, int valid,
                                           usm::bf16* out, float* part, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= valid) continue;
    const size_t o = (size_t)row * D + col0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (part)
        *reinterpret_cast<float2*>(part + o + j * 8) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      else
        *reinterpret_cast<__nv_bfloat162*>(out + o + j * 8) =
            __floats2bfloat162_rn(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
    }
  }
}

struct Args {
  const usm::bf16 *q, *k, *v, *g;
  const float *lse, *delta;
  const unsigned char* mask;
  usm::bf16 *dq, *dk, *dv;
  float *dq_part, *dk_part, *dv_part;  // f32 partials, or null where that split count is 1
  int bh, h, lq, lk;
  int q_splits, k_splits;  // of the dk/dv blocks' query tiles, of the dq blocks' key tiles
  float scale, scale_log2, inv_keep;
  unsigned seed_mix, thr;
};

// dk, dv of block (kt, split, bh): keys [64 kt, 64 kt + 64) resident, walking
// the query tiles of its split.
__device__ __forceinline__ void kv_block(const Args& a, int kt, int split, int bh, unsigned char* smem) {
  usm::bf16* ks = reinterpret_cast<usm::bf16*>(smem);
  usm::bf16* vs = reinterpret_cast<usm::bf16*>(smem + TILE);
  // stage st: Q at smem + (2 + 2 st) TILE, dO right after it
  auto qs = [&](int st) { return reinterpret_cast<usm::bf16*>(smem + (2 + 2 * st) * TILE); };
  auto gs = [&](int st) { return reinterpret_cast<usm::bf16*>(smem + (3 + 2 * st) * TILE); };
  float* lse_s = reinterpret_cast<float*>(smem + 6 * TILE);  // [2][BT]
  float* del_s = lse_s + 2 * BT;                              // [2][BT]
  usm::bf16* pdx = reinterpret_cast<usm::bf16*>(smem + 6 * TILE + STATS);  // (P·keep)^T [key][query]
  usm::bf16* dsx = pdx + BT * LDX;                                         // dS^T [key][query]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = (warp & 3) * 16;  // the warp's 16 key rows of the tile
  const int wc = warp >> 2;        // its half of the columns: queries 32 wc.. (scores), D 128 wc.. (dk, dv)

  const int k0 = kt * BT;
  const size_t off_q = (size_t)bh * a.lq * D;
  const size_t off_k = (size_t)bh * a.lk * D;
  const unsigned char* mrow = a.mask ? a.mask + (size_t)(bh / a.h) * a.lk : nullptr;
  const bool has_valid = batch_has_valid(mrow, a.lk);
  const bool skip = has_valid && !tile_has_valid(mrow, k0, BT, a.lk);
  const int q_tiles = (a.lq + BT - 1) / BT;
  const int per = (q_tiles + a.q_splits - 1) / a.q_splits;
  const int t_begin = split * per;
  const int t_end = min(q_tiles, t_begin + per);

  float dk_acc[16][4], dv_acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[j][c] = dv_acc[j][c] = 0.f;

  if (!skip && t_begin < t_end) {  // else: exact zeros (masked keys, or no query in the split)
    auto prefetch = [&](int st, int t) {
      const int q0 = t * BT;
      load_tile(qs(st), a.q + off_q, q0, a.lq);
      load_tile(gs(st), a.g + off_q, q0, a.lq);
      if (threadIdx.x < BT) {
        const int i = threadIdx.x;
        const bool ok = q0 + i < a.lq;
        const size_t o = (size_t)bh * a.lq + (ok ? q0 + i : 0);
        usm::cp_async4(usm::smem_u32(lse_s + st * BT + i), a.lse + o, ok);
        usm::cp_async4(usm::smem_u32(del_s + st * BT + i), a.delta + o, ok);
      }
    };
    load_tile(ks, a.k + off_k, k0, a.lk);
    load_tile(vs, a.v + off_k, k0, a.lk);
    prefetch(0, t_begin);
    usm::cp_commit();

    // this thread's two keys (accumulator rows g, g + 8 of the warp)
    bool in[2], att[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + wr + g + 8 * r;
      in[r] = key < a.lk;
      att[r] = in[r] && (!mrow || mrow[key]);
    }
    const float inv_lk = 1.f / (float)a.lk;
    const uint32_t k_addr = usm::smem_u32(ks + wr * LDQ + usm::a_off(lane, LDQ));
    const uint32_t v_addr = usm::smem_u32(vs + wr * LDQ + usm::a_off(lane, LDQ));
    const uint32_t pd_addr = usm::smem_u32(pdx + wr * LDX + usm::a_off(lane, LDX));
    const uint32_t ds_addr = usm::smem_u32(dsx + wr * LDX + usm::a_off(lane, LDX));

    int stage = 0;
    for (int t = t_begin; t < t_end; ++t) {
      if (t + 1 < t_end) prefetch(stage ^ 1, t + 1);
      usm::cp_commit();
      usm::cp_wait<1>();  // this tile (and K, V) have landed; the next may be in flight
      __syncthreads();

      // S^T = K_w . Q^T and dP^T = V_w . dO^T: [16 keys, 32 queries]
      float st[4][4], dpt[4][4];
      nt_slab(st, k_addr, usm::smem_u32(qs(stage) + wc * 32 * LDQ + usm::b_off(lane, LDQ)));
      nt_slab(dpt, v_addr, usm::smem_u32(gs(stage) + wc * 32 * LDQ + usm::b_off(lane, LDQ)));

      const float* lse_t = lse_s + stage * BT;
      const float* del_t = del_s + stage * BT;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = wc * 32 + j * 8 + 2 * t4;  // query column in the tile
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float pd[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = t * BT + qc + e;
            float p = 0.f;
            pd[e] = ds[e] = 0.f;
            if (in[r] && qi < a.lq) {
              if (!has_valid) p = inv_lk;  // every key masked: uniform
              else if (att[r]) p = exp2f(fminf(st[j][2 * r + e] * a.scale_log2 - lse_t[qc + e] * LOG2E, 0.f));
              const float kf = keep_factor(bh, qi, k0 + wr + g + 8 * r, a.lq, a.lk, a.seed_mix, a.thr,
                                           a.inv_keep);
              pd[e] = p * kf;
              if (att[r]) ds[e] = p * (dpt[j][2 * r + e] * kf - del_t[qc + e]);
            }
          }
          const int o = (wr + g + 8 * r) * LDX + qc;
          *reinterpret_cast<uint32_t*>(pdx + o) = usm::pack_bf16(pd[0], pd[1]);
          *reinterpret_cast<uint32_t*>(dsx + o) = usm::pack_bf16(ds[0], ds[1]);
        }
      }
      __syncthreads();  // the whole [64 keys, 64 queries] P·keep and dS tiles are in

      // dV_w += (P·keep)^T . dO and dK_w += dS^T . Q over the warp's 128 columns
      nn_acc(dv_acc, pd_addr, usm::smem_u32(gs(stage) + wc * 128 + usm::bt_off(lane, LDQ)));
      nn_acc(dk_acc, ds_addr, usm::smem_u32(qs(stage) + wc * 128 + usm::bt_off(lane, LDQ)));
      __syncthreads();  // every warp is done with this stage and the exchange tiles
      stage ^= 1;
    }
    usm::cp_wait<0>();
  }
  const size_t part = ((size_t)split * a.bh + bh) * a.lk * D;
  store_slab(dk_acc, k0 + wr, wc * 128, a.lk, a.dk + off_k, a.dk_part ? a.dk_part + part : nullptr, a.scale);
  store_slab(dv_acc, k0 + wr, wc * 128, a.lk, a.dv + off_k, a.dv_part ? a.dv_part + part : nullptr, 1.f);
}

// dq of block (qt, split, bh): queries [64 qt, 64 qt + 64) resident, walking
// the key tiles of its split and skipping wholly masked ones when the batch
// has a valid key.
__device__ __forceinline__ void q_block(const Args& a, int qt, int split, int bh, unsigned char* smem) {
  usm::bf16* qs = reinterpret_cast<usm::bf16*>(smem);
  usm::bf16* gs = reinterpret_cast<usm::bf16*>(smem + TILE);
  // stage st: K at smem + (2 + 2 st) TILE, V right after it
  auto ks = [&](int st) { return reinterpret_cast<usm::bf16*>(smem + (2 + 2 * st) * TILE); };
  auto vs = [&](int st) { return reinterpret_cast<usm::bf16*>(smem + (3 + 2 * st) * TILE); };
  usm::bf16* dsx = reinterpret_cast<usm::bf16*>(smem + 6 * TILE);  // dS [query][key]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = (warp & 3) * 16;  // the warp's 16 query rows of the tile
  const int wc = warp >> 2;        // its half of the columns: keys 32 wc.. (scores), D 128 wc.. (dq)

  const int q0 = qt * BT;
  const size_t off_q = (size_t)bh * a.lq * D;
  const size_t off_k = (size_t)bh * a.lk * D;
  const unsigned char* mrow = a.mask ? a.mask + (size_t)(bh / a.h) * a.lk : nullptr;
  const bool skip_masked = mrow && batch_has_valid(mrow, a.lk);
  const int k_tiles = (a.lk + BT - 1) / BT;
  const int per = (k_tiles + a.k_splits - 1) / a.k_splits;
  const int t_end = min(k_tiles, (split + 1) * per);
  // every warp takes the same decisions from the same bytes, so the block stays uniform
  auto next_tile = [&](int t) {
    for (; t < t_end && skip_masked; ++t) {
      const int x = t * BT + lane, y = x + 32;
      if (__any_sync(0xffffffffu, (x < a.lk && mrow[x]) || (y < a.lk && mrow[y]))) break;
    }
    return t;
  };

  // this thread's two queries (accumulator rows g, g + 8 of the warp)
  bool qin[2];
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wr + g + 8 * r;
    qin[r] = qi < a.lq;
    lse2[r] = qin[r] ? a.lse[(size_t)bh * a.lq + qi] * LOG2E : 0.f;
    del[r] = qin[r] ? a.delta[(size_t)bh * a.lq + qi] : 0.f;
  }

  float dq_acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.f;

  int cur = next_tile(split * per);
  if (cur < t_end) {  // else: exact zeros (no key, or only masked keys, in the split)
    load_tile(qs, a.q + off_q, q0, a.lq);
    load_tile(gs, a.g + off_q, q0, a.lq);
    load_tile(ks(0), a.k + off_k, cur * BT, a.lk);
    load_tile(vs(0), a.v + off_k, cur * BT, a.lk);
    usm::cp_commit();
    const uint32_t q_addr = usm::smem_u32(qs + wr * LDQ + usm::a_off(lane, LDQ));
    const uint32_t g_addr = usm::smem_u32(gs + wr * LDQ + usm::a_off(lane, LDQ));
    const uint32_t ds_addr = usm::smem_u32(dsx + wr * LDX + usm::a_off(lane, LDX));

    int stage = 0;
    while (cur < t_end) {
      const int nxt = next_tile(cur + 1);
      if (nxt < t_end) {
        load_tile(ks(stage ^ 1), a.k + off_k, nxt * BT, a.lk);
        load_tile(vs(stage ^ 1), a.v + off_k, nxt * BT, a.lk);
      }
      usm::cp_commit();
      usm::cp_wait<1>();
      __syncthreads();

      // S = Q_w . K^T and dP = dO_w . V^T: [16 queries, 32 keys]
      float s[4][4], dp[4][4];
      nt_slab(s, q_addr, usm::smem_u32(ks(stage) + wc * 32 * LDQ + usm::b_off(lane, LDQ)));
      nt_slab(dp, g_addr, usm::smem_u32(vs(stage) + wc * 32 * LDQ + usm::b_off(lane, LDQ)));

#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = wc * 32 + j * 8 + 2 * t4;  // key column in the tile
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = cur * BT + kc + e;
            ds[e] = 0.f;
            // an attended key implies the batch has a valid key: P from lse
            if (qin[r] && key < a.lk && (!mrow || mrow[key])) {
              const float p = exp2f(fminf(s[j][2 * r + e] * a.scale_log2 - lse2[r], 0.f));
              const float kf = keep_factor(bh, q0 + wr + g + 8 * r, key, a.lq, a.lk, a.seed_mix, a.thr,
                                           a.inv_keep);
              ds[e] = p * (dp[j][2 * r + e] * kf - del[r]);
            }
          }
          *reinterpret_cast<uint32_t*>(dsx + (wr + g + 8 * r) * LDX + kc) = usm::pack_bf16(ds[0], ds[1]);
        }
      }
      __syncthreads();  // the whole [64 queries, 64 keys] dS tile is in

      // dQ_w += dS . K over the warp's 128 columns
      nn_acc(dq_acc, ds_addr, usm::smem_u32(ks(stage) + wc * 128 + usm::bt_off(lane, LDQ)));
      __syncthreads();
      stage ^= 1;
      cur = nxt;
    }
    usm::cp_wait<0>();
  }
  const size_t part = ((size_t)split * a.bh + bh) * a.lq * D;
  store_slab(dq_acc, q0 + wr, wc * 128, a.lq, a.dq + off_q, a.dq_part ? a.dq_part + part : nullptr, a.scale);
}

// One launch for both: blocks [0, k_tiles * q_splits * BH) are dk/dv blocks
// (the heavier, so they are dispatched first), the rest dq blocks, so the dq
// blocks fill the SMs that the dk/dv blocks leave idle (a memory bank's
// wholly masked key tiles end their dk/dv blocks at once).
__global__ void __launch_bounds__(THREADS, 1) bwd_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int k_tiles = (a.lk + BT - 1) / BT, q_tiles = (a.lq + BT - 1) / BT;
  const int n_kv = k_tiles * a.q_splits * a.bh;
  int i = blockIdx.x;
  if (i < n_kv) {
    kv_block(a, i % k_tiles, (i / k_tiles) % a.q_splits, i / (k_tiles * a.q_splits), smem);
  } else {
    i -= n_kv;
    q_block(a, i % q_tiles, (i / q_tiles) % a.k_splits, i / (q_tiles * a.k_splits), smem);
  }
}

// delta[row] = sum_d g[row, d] * out[row, d] in f32 (= sum_k dP P over the
// keys, which holds under dropout); one warp a row, 8 columns a lane
__global__ void __launch_bounds__(256) delta_kernel(const usm::bf16* __restrict__ g,
                                                    const usm::bf16* __restrict__ out,
                                                    float* __restrict__ delta, int rows) {
  const int row = (blockIdx.x * 256 + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= rows) return;
  const uint4 x = *reinterpret_cast<const uint4*>(g + (size_t)row * D + lane * 8);
  const uint4 y = *reinterpret_cast<const uint4*>(out + (size_t)row * D + lane * 8);
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(x2[i]), b = __bfloat1622float2(y2[i]);
    s += a.x * b.x + a.y * b.y;
  }
  s = usm::warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// out[i] = bf16(scale * sum_s part[s][i]), s = 0, 1, ... in order; 4 elements a thread
__global__ void __launch_bounds__(256) sum_splits_kernel(const float4* __restrict__ part,
                                                         usm::bf16* __restrict__ out, int splits,
                                                         size_t n4, float scale) {
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < n4; i += (size_t)gridDim.x * 256) {
    float4 acc = part[i];
    for (int s = 1; s < splits; ++s) {
      const float4 x = part[(size_t)s * n4 + i];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out + 4 * i);
    dst[0] = __floats2bfloat162_rn(acc.x * scale, acc.y * scale);
    dst[1] = __floats2bfloat162_rn(acc.z * scale, acc.w * scale);
  }
}

cudaError_t sum_splits(const void* part, void* out, int splits, size_t n, float scale, cudaStream_t s) {
  const size_t n4 = n / 4;
  const size_t want = (n4 + 255) / 256;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  sum_splits_kernel<<<blocks, 256, 0, s>>>(static_cast<const float4*>(part), static_cast<usm::bf16*>(out),
                                           splits, n4, scale);
  return cudaGetLastError();
}
}  // namespace bwd

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

// scratch: f32 sections, each starting on a 64-float boundary: delta [bh, lq];
// then dq_part [k_splits, bh, lq, 256] if k_splits > 1; then dk_part and
// dv_part [q_splits, bh, lk, 256] each if q_splits > 1 (the wrapper's
// _bwd_scratch_floats gives the total).
extern "C" int usm_flash_dropout_bwd_bf16(const void* q, const void* k, const void* v,
                                          const void* out, const void* g, const void* lse,
                                          const void* mask, void* dq, void* dk, void* dv, void* scratch,
                                          int bh, int h, int lq, int lk, int d, int q_splits,
                                          int k_splits, float scale, unsigned seed_mix, unsigned thr,
                                          float inv_keep, void* stream) {
  using namespace bwd;
  if (bh <= 0 || lq <= 0) return cudaSuccess;
  if (lk <= 0 || h <= 0 || d != D || !scratch) return cudaErrorInvalidValue;
  if (q_splits <= 0 || k_splits <= 0 || q_splits > 65535 || k_splits > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = usm::allow_smem(bwd_kernel, KV_BYTES > Q_BYTES ? KV_BYTES : Q_BYTES);
  if (e != cudaSuccess) return e;
  auto up64 = [](size_t n) { return (n + 63) / 64 * 64; };
  float* delta = static_cast<float*>(scratch);
  float* dq_part = delta + up64((size_t)bh * lq);
  const size_t nq = (size_t)bh * lq * D, nk = (size_t)bh * lk * D;
  float* dk_part = dq_part + (k_splits > 1 ? k_splits * nq : 0);
  float* dv_part = dk_part + q_splits * nk;

  const int rows = bh * lq;
  delta_kernel<<<(rows + 7) / 8, 256, 0, s>>>(static_cast<const usm::bf16*>(g),
                                               static_cast<const usm::bf16*>(out), delta, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int q_tiles = (lq + BT - 1) / BT, k_tiles = (lk + BT - 1) / BT;
  Args a{static_cast<const usm::bf16*>(q), static_cast<const usm::bf16*>(k),
         static_cast<const usm::bf16*>(v), static_cast<const usm::bf16*>(g),
         static_cast<const float*>(lse), delta, static_cast<const unsigned char*>(mask),
         static_cast<usm::bf16*>(dq), static_cast<usm::bf16*>(dk), static_cast<usm::bf16*>(dv),
         k_splits > 1 ? dq_part : nullptr, q_splits > 1 ? dk_part : nullptr, q_splits > 1 ? dv_part : nullptr,
         bh, h, lq, lk, q_splits, k_splits, scale, scale * LOG2E, inv_keep, seed_mix, thr};
  const long long blocks = (long long)k_tiles * q_splits * bh + (long long)q_tiles * k_splits * bh;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  bwd_kernel<<<(unsigned)blocks, THREADS, KV_BYTES > Q_BYTES ? KV_BYTES : Q_BYTES, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (q_splits > 1) {
    e = sum_splits(dk_part, dk, q_splits, nk, scale, s);
    if (e != cudaSuccess) return e;
    e = sum_splits(dv_part, dv, q_splits, nk, 1.f, s);
    if (e != cudaSuccess) return e;
  }
  if (k_splits > 1) return sum_splits(dq_part, dq, k_splits, nq, scale, s);
  return cudaSuccess;
}
