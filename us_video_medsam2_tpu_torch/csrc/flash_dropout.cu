// Flash attention with attention-weight dropout after the softmax (training
// memory attention): forward with the row logsumexp, and its backward.
//
// Replaces us_video_medsam2_tpu/kernels/flash_dropout.py (flash_attention_train:
// _fwd_kernel at _fwd_call, _bwd_kernel at _bwd_call). q [BH, Lq, D], k/v
// [BH, Lk, D] bf16, mask [B, Lk] uint8 (1 = attend, may be null), D = 256,
// seed: one int32 in device memory, read by the kernels (so a captured launch
// draws anew each replay).
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
// Forward (fwd::kernel, grid (Lq/128, splits, BH), 8 warps of 16 query rows):
// the Q tile stays in shared memory and 64-key K/V tiles arrive by cp.async
// in two stages, the next in flight while the current one is computed.
// S = Q.K^T and O += (P·keep).V run on mma.sync.m16n8k16 (bf16 operands,
// f32 accumulators in registers, operands from ldmatrix). Each thread holds
// rows g and g + 8 of its warp's 16 x 256 O, so the online softmax (running
// max m and sum l in f32, natural-log units) stays in registers and P goes
// from the S accumulators into the A operand of P.V without touching shared
// memory. The normaliser sums the UNDROPPED probabilities; only P.V sees
// keep / (1 - rate), the keep bit of each accumulator element hashed from
// its own (query, key), and P·keep is rounded to bf16 as the JAX kernel
// rounds it. At B·H = 3 one block per 128 queries gives 24 blocks for 132
// SMs, so the key tiles are split across blocks too: tile t goes to split
// t mod splits (the wrapper's fwd_split_tiles; fwd_splits picks the count
// from the shape alone, one wave of the blocks an SM holds). Dealt out in
// turn, the valid tiles of a memory bank (runs of whole 16-tile slots) fall
// evenly on the splits wherever select_memories puts them. A block reads its
// split's key mask once: one thread a tile packs the tile's 64 mask bytes
// into a bit word in shared memory (a window of 256 tiles at a time), from
// which it masks scores and skips tiles with no valid key. With one split
// the block writes out = bf16(O / max(l, 1e-30)) and lse = m +
// log(max(l, 1e-30)); otherwise each writes its O (f32) and (m, l), a split
// that attended no tile m = -inf, and fwd::combine_kernel sums them in split
// order (no atomics: two calls give the same bits).
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

constexpr int D = 256;
constexpr int LDQ = D + 8;  // bf16 row stride of q/k/v/dO tiles
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

// the seed's mix into the hash: seed * 0x9e3779b9 in wrapping 32-bit arithmetic,
// the seed read from device memory (the JAX kernel's seed_ref operand)
__device__ __forceinline__ unsigned seed_mix_of(const int* seed) {
  return (unsigned)__ldg(seed) * 0x9e3779b9u;
}

// dropout factor of element (bh, qi, key): 0 or 1 / (1 - rate)
__device__ __forceinline__ float keep_factor(int bh, int qi, int key, int lq, int lk,
                                             unsigned seed_mix, unsigned thr, float inv_keep) {
  if (thr == 0u) return 1.f;
  const unsigned idx = ((unsigned)bh * (unsigned)lq + (unsigned)qi) * (unsigned)lk + (unsigned)key;
  return keep_hash(idx, seed_mix) >= thr ? inv_keep : 0.f;
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

// ------------------------------------------------------------------ forward
namespace fwd {
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = 16 * WARPS;   // query rows of a block, 16 a warp
constexpr int BK = 64;           // keys of a tile
constexpr int WINDOW = THREADS;  // local tiles whose key masks one scan brings in, one a thread
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t Q_BYTES = sizeof(usm::bf16) * BQ * LDQ;
constexpr size_t TILE = sizeof(usm::bf16) * BK * LDQ;
constexpr size_t BITS = Q_BYTES + 4 * TILE;  // after Q and K, V in two stages
constexpr size_t BYTES = BITS + sizeof(unsigned long long) * WINDOW + sizeof(uint32_t) * WARPS;
static_assert(BYTES <= 232448, "a block's shared memory");

struct Args {
  const usm::bf16 *q, *k, *v;
  const unsigned char* mask;
  usm::bf16* out;
  float* lse;
  float *o_part, *ml_part;  // each split's O [splits, bh, lq, D] and (m, l) [splits, bh, lq, 2]; null with one split
  int bh, h, lq, lk, splits;
  float scale, inv_keep;
  const int* seed;  // the int32 dropout seed, on the device
  unsigned thr;
};

// rows [row0, row0 + ROWS) of a [*, D] head into a tile by cp.async, rows at or past `valid` zero-filled
template <int ROWS>
__device__ __forceinline__ void load_rows(usm::bf16* dst, const usm::bf16* src, int row0, int valid) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < valid;
    usm::cp_async16(usm::smem_u32(dst + r * LDQ + c * 8), src + (size_t)(ok ? row0 + r : 0) * D + c * 8, ok);
  }
}

// Block (query tile, split, bh): queries [BQ·x, BQ·x + BQ) against the key
// tiles t = i·splits + split, i = 0, 1, ... (its local tiles).
__global__ void __launch_bounds__(THREADS, 1) kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  usm::bf16* qs = reinterpret_cast<usm::bf16*>(smem);
  auto ks = [&](int st) { return reinterpret_cast<usm::bf16*>(smem + Q_BYTES + 2 * st * TILE); };
  auto vs = [&](int st) { return reinterpret_cast<usm::bf16*>(smem + Q_BYTES + (2 * st + 1) * TILE); };
  // the window's local tiles: bit c of keybits[i] = key c of the tile is attended (and < Lk);
  // bit i of tilebits = keybits[i] != 0
  unsigned long long* keybits = reinterpret_cast<unsigned long long*>(smem + BITS);
  uint32_t* tilebits = reinterpret_cast<uint32_t*>(keybits + WINDOW);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const int q0 = blockIdx.x * BQ, split = blockIdx.y, bh = blockIdx.z;
  const unsigned seed_mix = seed_mix_of(a.seed);
  const usm::bf16* qh = a.q + (size_t)bh * a.lq * D;
  const usm::bf16* kh = a.k + (size_t)bh * a.lk * D;
  const usm::bf16* vh = a.v + (size_t)bh * a.lk * D;
  const unsigned char* mrow = a.mask ? a.mask + (size_t)(bh / a.h) * a.lk : nullptr;
  const int k_tiles = (a.lk + BK - 1) / BK;
  const int n_local = split < k_tiles ? (k_tiles - 1 - split) / a.splits + 1 : 0;

  load_rows<BQ>(qs, qh, q0, a.lq);  // in flight while the mask is scanned

  // the key masks of local tiles [WINDOW w, WINDOW w + WINDOW): one thread a tile
  int win = 0;
  auto scan = [&](int w) {
    __syncthreads();  // every thread is done with the previous window
    const int i = w * WINDOW + threadIdx.x;
    unsigned long long bits = 0;
    if (i < n_local) {
      const int k0 = (i * a.splits + split) * BK;
      const int n = min(BK, a.lk - k0);
      if (!mrow) {
        bits = n == BK ? ~0ull : (1ull << n) - 1;
      } else {
#pragma unroll
        for (int c = 0; c < BK; ++c)
          if (c < n) bits |= (unsigned long long)(mrow[k0 + c] != 0) << c;
      }
    }
    keybits[threadIdx.x] = bits;
    const uint32_t word = __ballot_sync(0xffffffffu, bits != 0);
    if (lane == 0) tilebits[warp] = word;
    __syncthreads();
    win = w;
  };
  scan(0);
  // Tiles with no attended key are skipped when the batch has a valid key
  // (they add exact zeros); a batch with none attends every tile. A valid key
  // among the split's first window settles it; else the whole row is read.
  bool skip = false;
  if (mrow) {
    uint32_t any = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) any |= tilebits[w];
    skip = any != 0 || batch_has_valid(mrow, a.lk);
  }
  // the first local tile >= i to attend, or n_local; every thread takes the
  // same steps on the same bits, so the block stays uniform
  auto next = [&](int i) {
    while (i < n_local) {
      if (i / WINDOW != win) scan(i / WINDOW);
      if (!skip) return i;
      const int b = i % WINDOW;
      const uint32_t word = tilebits[b >> 5] >> (b & 31);
      if (word) return i + __ffs(word) - 1;
      i += 32 - (b & 31);
    }
    return n_local;
  };

  int cur = next(0);
  unsigned long long kb_cur = 0;
  if (cur < n_local) {
    kb_cur = keybits[cur % WINDOW];
    const int k0 = (cur * a.splits + split) * BK;
    load_rows<BK>(ks(0), kh, k0, a.lk);
    load_rows<BK>(vs(0), vh, k0, a.lk);
  }
  usm::cp_commit();

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // the keep hash's element index (bh·Lq + q)·Lk + k (wrapping) of this
  // thread's rows g, g + 8 at key 2·t4: key c of tile k0 adds k0 + c
  unsigned row_idx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    row_idx[r] = ((unsigned)bh * (unsigned)a.lq + (unsigned)(q0 + warp * 16 + g + 8 * r)) * (unsigned)a.lk +
                 2u * t4;

  const uint32_t q_addr = usm::smem_u32(qs + warp * 16 * LDQ + usm::a_off(lane, LDQ));
  const int k_off = usm::b_off(lane, LDQ), v_off = usm::bt_off(lane, LDQ);

  int stage = 0;
  while (cur < n_local) {
    const int nxt = next(cur + 1);
    unsigned long long kb_nxt = 0;
    if (nxt < n_local) {
      kb_nxt = keybits[nxt % WINDOW];
      const int k0 = (nxt * a.splits + split) * BK;
      load_rows<BK>(ks(stage ^ 1), kh, k0, a.lk);
      load_rows<BK>(vs(stage ^ 1), vh, k0, a.lk);
    }
    usm::cp_commit();
    usm::cp_wait<1>();  // this tile (and Q) have landed; the next may be in flight
    __syncthreads();

    // S = Q_w . K^T  [16, 64], and between its products the keep bits of
    // this thread's elements (bit x = 16 r + 2 j + e: row g + 8 r, key
    // j·8 + 2·t4 + e of the tile), so the hash's integer work overlaps them
    // (at rate 0, thr = 0 keeps every element and inv_keep is 1)
    const int k0 = (cur * a.splits + split) * BK;
    constexpr int ELEMS = BK / 2, PER_KD = ELEMS / (D / 16);
    uint32_t keep = 0;
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const uint32_t k_addr = usm::smem_u32(ks(stage) + k_off);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t qa[4];
      usm::ldsm_x4(q_addr + kd * 32, qa);
#pragma unroll
      for (int nj = 0; nj < BK / 16; ++nj) {
        uint32_t b[4];
        usm::ldsm_x4(k_addr + (nj * 16 * LDQ + kd * 16) * 2, b);
        usm::mma(s[2 * nj], qa, b[0], b[1]);
        usm::mma(s[2 * nj + 1], qa, b[2], b[3]);
      }
#pragma unroll
      for (int x = kd * PER_KD; x < (kd + 1) * PER_KD; ++x) {
        const unsigned idx = row_idx[x / (BK / 4)] + (unsigned)(k0 + (x % (BK / 4)) / 2 * 8 + x % 2);
        keep |= (uint32_t)(keep_hash(idx, seed_mix) >= a.thr) << x;
      }
    }

    // scale and mask (natural-log units): rows g (s[.][0..1]) and g + 8 (s[.][2..3])
    const unsigned long long kb = kb_cur >> (2 * t4);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool on = (kb >> (j * 8 + e)) & 1ull;
        const bool in = k0 + j * 8 + 2 * t4 + e < a.lk;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = s[j][2 * r + e];
          x = on ? x * a.scale : (in ? MASKED : -INFINITY);
          mx[r] = fmaxf(mx[r], x);
        }
      }
    }
    // online softmax: a processed tile holds a key < Lk, so m_new is finite
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f((m[r] - m_new) * LOG2E);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f((s[j][c] - m[c >> 1]) * LOG2E);
        rs[c >> 1] += p;  // the normaliser sums the undropped probabilities
        s[j][c] = p;
      }
    }
    // only P·V sees keep / (1 - rate)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          s[j][2 * r + e] *= (keep >> (r * (BK / 4) + 2 * j + e)) & 1u ? a.inv_keep : 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];  // per-thread partial sums
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += (P·keep) . V, the bf16 A operand straight from the S accumulators
    const uint32_t v_addr = usm::smem_u32(vs(stage) + v_off);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = usm::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = usm::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = usm::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = usm::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        usm::ldsm_x4_t(v_addr + (kk * 16 * LDQ + dn * 16) * 2, b);
        usm::mma(o[2 * dn], pa, b[0], b[1]);
        usm::mma(o[2 * dn + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
    stage ^= 1;
    cur = nxt;
    kb_cur = kb_nxt;
  }
  usm::cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= a.lq) continue;
    const size_t orow = (size_t)bh * a.lq + row;
    if (a.o_part) {  // a split with no tile attended writes O 0, m -inf, l 0
      const size_t prow = (size_t)split * a.bh * a.lq + orow;
      float* dst = a.o_part + prow * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + j * 8) = make_float2(o[j][2 * r], o[j][2 * r + 1]);
      if (t4 == 0) *reinterpret_cast<float2*>(a.ml_part + prow * 2) = make_float2(m[r], l[r]);
    } else {
      const float ls = fmaxf(l[r], 1e-30f), inv = 1.f / ls;
      usm::bf16* dst = a.out + orow * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
      if (t4 == 0) a.lse[orow] = m[r] + logf(ls);
    }
  }
}

// out and lse from the splits' partials, summed in split order: m = max_i m_i,
// w_i = exp(m_i - m) (0 for a split that attended no tile, m_i = -inf),
// out = bf16(sum_i w_i O_i / max(L, 1e-30)), lse = m + log(max(L, 1e-30)),
// L = sum_i w_i l_i. 64 threads a row (4 columns each), 4 rows a block.
__global__ void __launch_bounds__(256) combine_kernel(const float* __restrict__ o_part,
                                                      const float* __restrict__ ml_part,
                                                      usm::bf16* __restrict__ out, float* __restrict__ lse,
                                                      int splits, int rows) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 6);
  if (row >= rows) return;
  const int c = (threadIdx.x & 63) * 4;
  float top = -INFINITY;
  for (int i = 0; i < splits; ++i) top = fmaxf(top, ml_part[((size_t)i * rows + row) * 2]);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float sum = 0.f;
  for (int i = 0; i < splits; ++i) {
    const float2 ml = *reinterpret_cast<const float2*>(ml_part + ((size_t)i * rows + row) * 2);
    if (ml.x == -INFINITY) continue;
    const float w = expf(ml.x - top);
    const float4 oi = *reinterpret_cast<const float4*>(o_part + ((size_t)i * rows + row) * D + c);
    acc.x += w * oi.x;
    acc.y += w * oi.y;
    acc.z += w * oi.z;
    acc.w += w * oi.w;
    sum += w * ml.y;
  }
  const float ls = fmaxf(sum, 1e-30f), inv = 1.f / ls;
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * D + c);
  dst[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
  dst[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  if (c == 0) lse[row] = top + logf(ls);
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
  const int* seed;  // the int32 dropout seed, on the device
  unsigned thr;
};

// dk, dv of block (kt, split, bh): keys [64 kt, 64 kt + 64) resident, walking
// the query tiles of its split.
__device__ __forceinline__ void kv_block(const Args& a, int kt, int split, int bh, unsigned char* smem) {
  const unsigned seed_mix = seed_mix_of(a.seed);
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
              const float kf = keep_factor(bh, qi, k0 + wr + g + 8 * r, a.lq, a.lk, seed_mix, a.thr,
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
  const unsigned seed_mix = seed_mix_of(a.seed);
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
              const float kf = keep_factor(bh, q0 + wr + g + 8 * r, key, a.lq, a.lk, seed_mix, a.thr,
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

// Blocks of the forward kernel that one SM holds at once (fwd_splits sizes
// its grid to one wave of them).
extern "C" int usm_flash_dropout_fwd_blocks_per_sm(int* blocks) {
  cudaError_t e = usm::allow_smem(fwd::kernel, fwd::BYTES);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fwd::kernel, fwd::THREADS, fwd::BYTES);
}

// scratch: o_part [splits, bh, lq, 256] then ml_part [splits, bh, lq, 2], f32
// (the wrapper's _fwd_scratch_floats); unused, and may be null, with one split.
extern "C" int usm_flash_dropout_fwd_bf16(const void* q, const void* k, const void* v,
                                          const void* mask, void* out, void* lse, void* scratch, int bh,
                                          int h, int lq, int lk, int d, int splits, float scale,
                                          const void* seed, unsigned thr, float inv_keep, void* stream) {
  using namespace fwd;
  if (bh <= 0 || lq <= 0) return cudaSuccess;
  if (lk <= 0 || h <= 0 || d != D || splits <= 0 || splits > 65535 || bh > 65535) return cudaErrorInvalidValue;
  if ((splits > 1 && !scratch) || !seed) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = usm::allow_smem(kernel, BYTES);
  if (e != cudaSuccess) return e;
  float* o_part = splits > 1 ? static_cast<float*>(scratch) : nullptr;
  float* ml_part = splits > 1 ? o_part + (size_t)splits * bh * lq * D : nullptr;
  Args a{static_cast<const usm::bf16*>(q), static_cast<const usm::bf16*>(k), static_cast<const usm::bf16*>(v),
         static_cast<const unsigned char*>(mask), static_cast<usm::bf16*>(out), static_cast<float*>(lse),
         o_part, ml_part, bh, h, lq, lk, splits, scale, inv_keep, static_cast<const int*>(seed), thr};
  kernel<<<dim3((lq + BQ - 1) / BQ, splits, bh), THREADS, BYTES, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int rows = bh * lq;
  combine_kernel<<<(rows + 3) / 4, 256, 0, s>>>(o_part, ml_part, static_cast<usm::bf16*>(out),
                                                 static_cast<float*>(lse), splits, rows);
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
                                          int k_splits, float scale, const void* seed, unsigned thr,
                                          float inv_keep, void* stream) {
  using namespace bwd;
  if (bh <= 0 || lq <= 0) return cudaSuccess;
  if (lk <= 0 || h <= 0 || d != D || !scratch || !seed) return cudaErrorInvalidValue;
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
         bh, h, lq, lk, q_splits, k_splits, scale, scale * LOG2E, inv_keep,
         static_cast<const int*>(seed), thr};
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
