// The attention half of a Hiera block: LayerNorm, per-head q/k/v projection,
// windowed attention (optional 2x2 q max-pool) and the output projection
// summed over heads.
//
// Replaces us_video_medsam2_tpu/kernels/rejected/window_attention_v1.py
// (window_attention, _run, _kernel), unwired as there. x [B, Hp, Wp, C] bf16
// (already padded to whole windows), gamma/beta [C] f32, wq/wk/wv [H, C, 96]
// bf16, bq/bk/bv [H, 96] f32, wo [H*96, Co] bf16, bo [Co] f32 ->
// out [B, Hp/ws*wso, Wp/ws*wso, Co] bf16, wso = ws/2 with pooling.
//
// What bounds it on the H100: operations (the projections, the attention
// products and the output projection: 20 us of tensor-core time at the peak
// rate over the nine t512 blocks). At B 1 the work is small, and a call costs
// the chain of one block. The TPU kernel walks a row strip of windows a grid
// step and sums the heads into an f32 accumulator; one window's f32
// [wso^2, Co] accumulator is 301 KB at ws 14 and Co 384, above a block's
// 227 KB of shared memory, so the work is two kernels here, each spread over
// the card:
//  1. window_attention_v1_kernel: a block of 8 warps is (a group of G
//     windows, one head, one rank of a cluster of C blocks), the plan that
//     kernels/rejected/window_attention_v1.py's plan_for() picks from the
//     shape alone. Small windows (ws 4, 8) take G > 1: the G windows' tokens
//     are the M dimension of the products, so the head's weight rows are read
//     once per G windows. Large windows (ws 14, 7, 16) at B 1 give 36-72
//     window-heads for 132 SMs, so C > 1 blocks of a thread-block cluster share
//     one (unpooled only: there a rank's query slabs are its key tiles): each
//     projects K, V and q of its 1/C share of the window's 16-row token tiles
//     and stores its K and V share into its peers' shared memory (16-byte
//     distributed shared-memory stores between two cluster barriers).
//     LayerNorm once a token: the f32 mean and 1/std of each token of the
//     rank's tiles are computed once from its values held in registers (two
//     passes over C, pad tokens included: a zero pad token becomes beta), and
//     each element is normalised and rounded to bf16 once, into a resident y
//     tile of the rank's tokens (all C) where it fits; the q, k and v passes
//     then read their A fragments from y. Where y does not fit (the pooled
//     ws-14 window of a block without a cluster), the tokens stream through
//     the ring and each element is normalised on the stage its cp.async landed
//     in, by the thread that copied it, before the stage's block barrier. The
//     products are mma.sync.m16n8k16 (bf16, f32 accumulators in registers) fed
//     by a 3-stage cp.async ring of 32-wide C chunks: the head's [C, 96]
//     weight rows loaded as they lie and read through ldmatrix.trans (and,
//     without y, the token rows gathered from the map by address). The first
//     pass's chunks are issued before the tables and the statistics. K and V
//     of a pass share its stage; q takes a second pass (under pooling its rows
//     are the four tokens of each pooled query, gathered into neighbouring
//     rows, so the 2x2 max is two shuffles of the accumulators). A warp's two
//     tiles of a pass lie 4 (K/V) or 8 (q) tiles apart, so a pass of few tiles
//     spreads over every warp. The epilogues add the f32 bias in registers and
//     round once. Attention is csrc/window_attn_core.cuh's slab core on every
//     warp (at ws 16 with 16 key tiles, 255 registers and no spill); o is
//     rounded once and stored into o [B, Hpo, Wpo, H*96];
//  2. out_proj_kernel: out = o . wo + bo, a block a BM x BN tile (BM 64 or
//     32 rows, BN 96 or 32 columns, from plan_for), 2 BM / 16 warps of
//     16 x BN/2, mma.sync with o and wo through a 3-stage cp.async ring of
//     96-deep chunks (one head's channels) and ldmatrix(.trans); the sum runs
//     over every head and channel (K = H*96) in f32 in one fixed order, plus
//     bo, rounded once, as _xla_ref's einsum("bhqd,hdc->bqc"). o's round trip
//     (at most 3 MB at t512) stays in L2.
// No split over C or K, no atomics: two calls give the same bits.
#include "window_attn_core.cuh"

namespace {

using namespace usm;

constexpr int HD = 96;
constexpr int MAX_WS = 16;
constexpr int WARPS = 8;  // warps an attention block
constexpr int NTHR = WARPS * 32;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int MAX_GROUP = 8;    // windows a group
constexpr int KC = 32;          // C (or K) rows of one ring stage
constexpr int LDR = KC + 8;     // bf16 row stride of a stage's token rows: 80 bytes
constexpr int LD = HD + 8;      // bf16 row stride of weight rows and of K, V, q: 208 bytes
constexpr int STAGES = 3;
constexpr long long SMEM_PER_BLOCK = 232448;
constexpr int U = 2;  // 16-row tiles a warp projects in one pass, against the same weight fragments
constexpr int PSTAGES = 3;  // stages of the output projection's ring

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

struct Geo {
  int hp, wp, c, ws, nh, q_pool, ln;
  int wso, lk, lq, nww, nwin, n_win;  // nwin: windows of an image; n_win: of the batch
  int gsz, csz;                        // the plan: windows a group, blocks a cluster
  int slabs, qtiles;                   // 16-row query slabs of a window; 16-row q token tiles of a window
  int hpo, wpo;
  float eps;
  int res;  // with ln: the rank's token rows resident in shared memory (y), normalised once, where they fit
};

// Dynamic shared memory of an attention block: the head's q, k and v bias,
// gamma and beta, the token address tables (each window's first token, each
// token's offset in its window, the first token of each pooled query), the
// LN statistics of the block's token tiles, the group's K and V (KT * 16 rows
// a window), the block's q slabs, with res the rank's token rows y (all C),
// then the ring's STAGES stages, each with room for the most token rows a
// pass of this plan copies (none with res) and its weight rows.
template <int KT>
struct Smem {
  size_t bs, gb, wb, toff, ptok, st, ks, vs, qs, ys, ring, slot, bytes;  // slot: elements of one ring stage
  int ldy, a_rows_kv, a_rows_q;  // y's row stride; token rows of a K/V pass and of a q pass
  __host__ __device__ explicit Smem(const Geo& G) {
    const size_t kv = sizeof(bf16) * (size_t)G.gsz * KT * 16 * LD;
    const int slabs = cdiv(G.gsz * G.slabs, G.csz);  // the most slabs a rank takes
    const int tiles = cdiv(G.gsz * KT, G.csz);      // the most token tiles a rank takes
    bs = 0;
    gb = bs + sizeof(float) * 3 * HD;
    wb = gb + sizeof(float) * 2 * G.c;
    toff = wb + sizeof(long long) * MAX_GROUP;
    ptok = toff + sizeof(int) * KT * 16;
    st = ptok + sizeof(int) * KT * 16;
    ks = align128(st + sizeof(float2) * tiles * 16);
    vs = ks + kv;
    qs = vs + kv;
    ys = align128(qs + sizeof(bf16) * (size_t)slabs * 16 * LD);
    ldy = G.c + 8;
    ring = align128(ys + (G.res ? sizeof(bf16) * (size_t)tiles * 16 * ldy : 0));
    a_rows_kv = G.res ? 0 : imin(WARPS * U / 2, tiles) * 16;
    a_rows_q = G.res ? 0 : imin(WARPS * U, slabs * (G.q_pool ? 4 : 1)) * 16;
    const int kv_el = a_rows_kv * LDR + 2 * KC * LD, q_el = a_rows_q * LDR + KC * LD;
    slot = (size_t)(kv_el > q_el ? kv_el : q_el);
    bytes = ring + sizeof(bf16) * STAGES * slot;
  }
};

// 8 bf16 of a token, normalised: ((x - mean) * rstd) * gamma + beta, rounded (st: mean, rstd)
__device__ __forceinline__ uint4 norm8(uint4 v, float2 st, const float* g, const float* b) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    const float y0 = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f.x, st.x), st.y), g[2 * e]), b[2 * e]);
    const float y1 = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f.y, st.x), st.y), g[2 * e + 1]), b[2 * e + 1]);
    h[e] = __floats2bfloat162_rn(y0, y1);
  }
  return v;
}

// Copy chunk c of a pass into stage sa: the pass's token rows, each thread
// copying NA of them (row (tid + k * nthr) / 4, 16-byte chunk
// (tid + k * nthr) % 4 of a stage) from a_src[k] (zero-filled where
// !a_ok[k], not copied where !a_on[k]), and KC rows of each of NB [C, HD]
// weight matrices, w0's then w1's.
template <int NB, int NA>
__device__ __forceinline__ void issue_chunk(int c, bf16* sa, const bf16* const (&a_src)[NA], const bool (&a_on)[NA],
                                            const bool (&a_ok)[NA], const bf16* __restrict__ w0,
                                            const bf16* __restrict__ w1, int a_rows) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  bf16* sb = sa + a_rows * LDR;
  const int k0 = c * KC;
#pragma unroll
  for (int k = 0; k < NA; ++k) {
    const int i = tid + k * nthr;
    if (a_on[k]) cp_async16(smem_u32(sa + (i >> 2) * LDR + (i & 3) * 8), a_src[k] + k0 + (i & 3) * 8, a_ok[k]);
  }
  for (int i = tid; i < NB * KC * (HD / 8); i += nthr) {
    const int r = i / (HD / 8), ch = i % (HD / 8);
    const bf16* src = NB == 2 && r >= KC ? w1 + (size_t)(k0 + r - KC) * HD : w0 + (size_t)(k0 + r) * HD;
    cp_async16(smem_u32(sb + r * LD + ch * 8), src + ch * 8, true);
  }
}

// The first STAGES - 1 chunks of a pass, each its own cp.async group.
template <int NB, int NA>
__device__ __forceinline__ void prime(const bf16* const (&a_src)[NA], const bool (&a_on)[NA], const bool (&a_ok)[NA],
                                      const bf16* __restrict__ w0, const bf16* __restrict__ w1, int cin, bf16* ring,
                                      size_t slot, int a_rows) {
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < cin / KC) issue_chunk<NB, NA>(c, ring + c * slot, a_src, a_on, a_ok, w0, w1, a_rows);
    cp_commit();
  }
}

// One pass of a projection: acc[u] = A[mt0 + u * us] . W over C, f32, for
// this warp against matrix nb, for the tiles below nmt (a warp's tiles lie
// us apart, so a pass of few tiles spreads over every warp and a warp with
// one tile computes one). The rows and weights as issue_chunk copies them;
// with ln, each thread normalises its own copies with the row's statistics
// a_st[k] once they land. RES: A is the resident y instead, lane rows ya[u] (shared
// addresses of each lane's ldmatrix row of tile u), and the ring holds
// weights only. primed: prime() has issued this pass's first chunks.
template <int NB, int NA, bool RES>
__device__ __forceinline__ void project(float (&acc)[U][HD / 8][4], const bf16* const (&a_src)[NA],
                                        const bool (&a_on)[NA], const bool (&a_ok)[NA], const float2 (&a_st)[NA],
                                        const uint32_t (&ya)[U], const float* gb, bool ln,
                                        const bf16* __restrict__ w0, const bf16* __restrict__ w1, int cin,
                                        bf16* ring, size_t slot, int a_rows, int mt0, int us, int nb, int nmt,
                                        bool primed) {
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31;  // nthr is NTHR (see the kernel)
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) acc[u][j][0] = acc[u][j][1] = acc[u][j][2] = acc[u][j][3] = 0.f;
  const int nch = cin / KC;
  // chunk c lands in stage c % STAGES: the stage pointers step along with c
  bf16* const last = ring + (STAGES - 1) * slot;
  auto step = [&](bf16* p) { return p == last ? ring : p + slot; };
  if (!primed) {
    __syncthreads();  // the ring's readers of a previous pass are done
    prime<NB, NA>(a_src, a_on, a_ok, w0, w1, cin, ring, slot, a_rows);
  }
  bf16* in = last;  // the stage of the next chunk to issue
  const int a_l = a_off(lane, LDR), b_l = bt_off(lane, LD);
  bf16* sa = ring;  // the stage of chunk c
  for (int c = 0; c < nch; ++c, sa = step(sa)) {
    cp_wait<STAGES - 2>();  // this thread's copies of chunk c have landed
    if (!RES && ln) {
      // each element normalised once, by the thread that copied it
      const float* g = gb + c * KC;
#pragma unroll
      for (int k = 0; k < NA; ++k) {
        const int i = tid + k * nthr;
        if (a_ok[k]) {
          uint4* p = reinterpret_cast<uint4*>(sa + (i >> 2) * LDR + (i & 3) * 8);
          *p = norm8(*p, a_st[k], g + (i & 3) * 8, g + cin + (i & 3) * 8);
        }
      }
    }
    __syncthreads();  // chunk c is in place for every thread, and chunk c - 1's stage is free
    if (c + STAGES - 1 < nch) issue_chunk<NB, NA>(c + STAGES - 1, in, a_src, a_on, a_ok, w0, w1, a_rows);
    cp_commit();
    in = step(in);
    if (mt0 >= nmt) continue;
    const bool two = mt0 + us < nmt;  // the warp's second tile (warp-uniform)
    const bf16* sb = sa + a_rows * LDR + nb * KC * LD;
    // every fragment of the chunk first, then its products
    uint32_t a[KC / 16][U][4], b[KC / 16][HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u > 0 && !two) continue;
        if (RES)
          ldsm_x4(ya[u] + (c * KC + kk * 16) * 2, a[kk][u]);
        else
          ldsm_x4(smem_u32(sa + (mt0 + u * us) * 16 * LDR + a_l + kk * 16), a[kk][u]);
      }
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) ldsm_x4_t(smem_u32(sb + kk * 16 * LD + b_l + n * 16), b[kk][n]);
    }
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
#pragma unroll
      for (int n = 0; n < HD / 16; ++n)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u > 0 && !two) continue;
          mma(acc[u][2 * n], a[kk][u], b[kk][n][0], b[kk][n][1]);
          mma(acc[u][2 * n + 1], a[kk][u], b[kk][n][2], b[kk][n][3]);
        }
  }
  cp_wait<0>();
}

// sum of 8 bf16, and of their squared deviations from mean
__device__ __forceinline__ float sum8(uint4 v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    s += f.x + f.y;
  }
  return s;
}
__device__ __forceinline__ float sq8(uint4 v, float mean) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    s += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
  }
  return s;
}

template <int KT>
__global__ void __launch_bounds__(NTHR) window_attention_v1_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
    const bf16* __restrict__ wq, const bf16* __restrict__ wk, const bf16* __restrict__ wv,
    const float* __restrict__ bq, const float* __restrict__ bk, const float* __restrict__ bv,
    bf16* __restrict__ o, const Geo geo, float scale) {
  constexpr int CH = HD / 8;  // 16-byte chunks of a head row
  constexpr int LKP = KT * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  // strides from blockDim, which is NTHR at every launch
  const int tid = threadIdx.x, nthr = blockDim.x, warps = nthr >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const Smem<KT> L(geo);
  float* bs = reinterpret_cast<float*>(smem + L.bs);
  float* gb = reinterpret_cast<float*>(smem + L.gb);  // gamma, then beta
  long long* wb = reinterpret_cast<long long*>(smem + L.wb);
  int* toff = reinterpret_cast<int*>(smem + L.toff);
  int* ptok = reinterpret_cast<int*>(smem + L.ptok);
  float2* st = reinterpret_cast<float2*>(smem + L.st);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.ks);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.vs);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.qs);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);

  // the block's task (a group of windows and a head) and its rank's shares:
  // group tiles [t_lo, t_hi) (tile t is rows 16 t of ks and vs), slabs
  // [s_lo, s_hi) (group slab g * slabs + s), q token tiles [qt_lo, qt_hi).
  // With C > 1 (unpooled, slabs == KT) the slab and tile ranges are the same.
  const int csz = geo.csz;
  const int rank = csz > 1 ? (int)cluster_ctarank() : 0;
  const int task = blockIdx.x / csz;
  const int head = task % geo.nh, w0 = task / geo.nh * geo.gsz;
  const int gw = imin(geo.gsz, geo.n_win - w0);
  const int tiles = gw * KT, slabs = gw * geo.slabs;
  const int t_lo = rank * tiles / csz, t_hi = (rank + 1) * tiles / csz;
  const int s_lo = rank * slabs / csz, s_hi = (rank + 1) * slabs / csz;
  const int P = geo.q_pool ? 4 : 1;  // q token tiles a slab
  auto qt_start = [&](int gs) {      // the group's first q token tile of slab gs
    return gs / geo.slabs * geo.qtiles + imin(P * (gs % geo.slabs), geo.qtiles);
  };
  const int qt_lo = qt_start(s_lo), qt_hi = qt_start(s_hi);
  if (csz > 1) cluster_arrive();  // barrier 1: this block has started
  // token j of the group's window g
  auto token_at = [&](int g, int j) {
    const int wg = w0 + g, bi = wg / geo.nwin, wi = wg - bi * geo.nwin;
    const int wy = wi / geo.nww, wx = wi - wy * geo.nww;
    return x + ((((long long)bi * geo.hp + wy * geo.ws + j / geo.ws) * geo.wp + wx * geo.ws + j % geo.ws) * geo.c);
  };
  // token i of the rank's rows: its address, or null past lk (not a token)
  auto token = [&](int i) -> const bf16* {
    const int t = t_lo + i / 16, j = t % KT * 16 + i % 16;
    return j < geo.lk ? token_at(t / KT, j) : nullptr;
  };
  // 1. K and V of the rank's tiles: warps [0, warps/2) project K, the others V.
  // The first pass's stages are issued before anything else: they land while
  // the tables and the LN statistics are made.
  const bool res = geo.res;
  bf16* y = reinterpret_cast<bf16*>(smem + L.ys);  // row i: group tile row 16 t_lo + i
  const int pm_kv = warps * U / 2, rows = (t_hi - t_lo) * 16;
  const int nb = warp / (warps / 2), mt0_kv = warp % (warps / 2), us_kv = warps / 2;
  const bf16* wk_h = wk + (size_t)head * geo.c * HD;
  const bf16* wv_h = wv + (size_t)head * geo.c * HD;
  const bf16* kv_src[2];
  bool kv_on[2], kv_ok[2];
  auto kv_rows = [&](int base) {  // the token rows of the pass of tiles [base, base + pm_kv); none with res
    const int nmt = imin(pm_kv, t_hi - base);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int row = (tid + k * nthr) >> 2;
      const bf16* src = !res && row < nmt * 16 ? token((base - t_lo) * 16 + row) : nullptr;
      kv_on[k] = !res && row < nmt * 16;
      kv_ok[k] = src != nullptr;
      kv_src[k] = kv_ok[k] ? src : x;
    }
  };
  // the head's bias (q, k, v) and gamma and beta: one cp.async group ahead of the pass's
  for (int i = tid; i < 3 * HD / 4; i += nthr) {
    const float* b3 = i < HD / 4 ? bq : i < HD / 2 ? bk : bv;
    cp_async16(smem_u32(bs + 4 * i), b3 + head * HD + 4 * (i % (HD / 4)), true);
  }
  if (geo.ln)
    for (int i = tid; i < geo.c / 2; i += nthr)
      cp_async16(smem_u32(gb + 4 * i), i < geo.c / 4 ? gamma + 4 * i : beta + 4 * i - geo.c, true);
  cp_commit();
  kv_rows(t_lo);
  if (t_lo < t_hi)
    prime<2, 2>(kv_src, kv_on, kv_ok, wk_h, wv_h, geo.c, ring, L.slot, L.a_rows_kv);
  else
    for (int c = 0; c < STAGES - 1; ++c) cp_commit();  // the same count of groups
  // token j of the group's window g is x + wb[g] + toff[j] (the q pass's
  // gather); pooled query qi's four tokens are ptok[qi] + (0, 1, ws, ws + 1)
  if (tid < gw) {
    const int wg = w0 + tid, bi = wg / geo.nwin, wi = wg - bi * geo.nwin;
    const int wy = wi / geo.nww, wx = wi - wy * geo.nww;
    wb[tid] = (((long long)bi * geo.hp + wy * geo.ws) * geo.wp + wx * geo.ws) * geo.c;
  }
  for (int j = tid; j < geo.lk; j += nthr) toff[j] = (j / geo.ws * geo.wp + j % geo.ws) * geo.c;
  if (geo.q_pool)
    for (int qi = tid; qi < geo.lq; qi += nthr) ptok[qi] = 2 * (qi / geo.wso) * geo.ws + 2 * (qi % geo.wso);
  cp_wait<STAGES - 1>();  // the bias, gamma and beta have landed (the pass's chunks may not have)
  __syncthreads();
  // pooled q slab rows past lq that no tile covers are zeros (finite; never stored)
  if (geo.q_pool)
    for (int i = tid; i < (s_hi - s_lo) * 16 * CH; i += nthr)
      *reinterpret_cast<uint4*>(qs + (i / CH) * LD + (i % CH) * 8) = make_uint4(0, 0, 0, 0);
  const int nc = geo.c / 8;  // 16-byte chunks of a token
  // LN statistics of each token of the rank's tiles, two passes over C as
  // the reference takes them: the mean, then the mean of squared deviations,
  // from the token's values held in registers (lpr lanes a token, at most NV
  // 16-byte chunks a lane for C <= 768; the chunks past them, for a wider C,
  // read again). With res the token is normalised from the same registers
  // into y (rows past lk zero); else the statistics go to st (row i: group
  // tile row 16 t_lo + i; rows past lk get (0, 0): they are zero-filled on
  // the stages and never normalised).
  if (geo.ln) {
    constexpr int NV = 12;
    const int lpr = nc > 4 * NV ? 8 : nc > 2 * NV ? 4 : 2;
    const int sub = lane & (lpr - 1), rpw = 32 / lpr;
    const float* gm = gb;
    const float* bt = gb + geo.c;
    for (int r0 = warp * rpw; r0 < rows; r0 += warps * rpw) {
      const int i = r0 + lane / lpr;
      const bf16* src = i < rows ? token(i) : nullptr;
      const bool ok = src != nullptr;
      uint4 v[NV];
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        const int ch = sub + e * lpr;
        v[e] = ok && ch < nc ? *reinterpret_cast<const uint4*>(src + ch * 8) : make_uint4(0, 0, 0, 0);
      }
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < NV; ++e) s += sum8(v[e]);
      for (int ch = sub + NV * lpr; ok && ch < nc; ch += lpr) s += sum8(*reinterpret_cast<const uint4*>(src + ch * 8));
      for (int m = 1; m < lpr; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
      const float mean = s / geo.c;
      float q = 0.f;
#pragma unroll
      for (int e = 0; e < NV; ++e)
        if (sub + e * lpr < nc) q += sq8(v[e], mean);
      for (int ch = sub + NV * lpr; ok && ch < nc; ch += lpr)
        q += sq8(*reinterpret_cast<const uint4*>(src + ch * 8), mean);
      for (int m = 1; m < lpr; m <<= 1) q += __shfl_xor_sync(0xffffffffu, q, m);
      const float2 ms = ok ? make_float2(mean, 1.f / sqrtf(q / geo.c + geo.eps)) : make_float2(0.f, 0.f);
      if (i >= rows) continue;
      if (!res) {
        if (sub == 0) st[i] = ms;
        continue;
      }
      bf16* yr = y + (size_t)i * L.ldy;
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        const int ch = sub + e * lpr;
        if (ch < nc) *reinterpret_cast<uint4*>(yr + ch * 8) = ok ? norm8(v[e], ms, gm + ch * 8, bt + ch * 8) : v[e];
      }
      for (int ch = sub + NV * lpr; ch < nc; ch += lpr)
        *reinterpret_cast<uint4*>(yr + ch * 8) =
            ok ? norm8(*reinterpret_cast<const uint4*>(src + ch * 8), ms, gm + ch * 8, bt + ch * 8)
               : make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
  }
  const int ya_col = (lane >> 4) * 8;  // each lane's ldmatrix column of a 16 x 16 A block
  {
    const float* bb = bs + (1 + nb) * HD;
    bf16* dst0 = nb ? vs : ks;
    for (int base = t_lo; base < t_hi; base += pm_kv) {
      const int nmt = imin(pm_kv, t_hi - base);
      if (base != t_lo) kv_rows(base);
      float2 kv_st[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int row = (tid + k * nthr) >> 2, t = base + row / 16;
        kv_st[k] = kv_ok[k] && geo.ln ? st[(t - t_lo) * 16 + row % 16] : make_float2(0.f, 0.f);
      }
      uint32_t ya[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = base + mt0_kv + (mt0_kv + u * us_kv < nmt ? u * us_kv : 0);
        ya[u] = smem_u32(y + (size_t)((t - t_lo) * 16 + (lane & 15)) * L.ldy + ya_col);
      }
      float acc[U][HD / 8][4];
      if (res)
        project<2, 2, true>(acc, kv_src, kv_on, kv_ok, kv_st, ya, gb, geo.ln, wk_h, wv_h, geo.c, ring, L.slot,
                            L.a_rows_kv, mt0_kv, us_kv, nb, nmt, base == t_lo);
      else
        project<2, 2, false>(acc, kv_src, kv_on, kv_ok, kv_st, ya, gb, geo.ln, wk_h, wv_h, geo.c, ring, L.slot,
                             L.a_rows_kv, mt0_kv, us_kv, nb, nmt, base == t_lo);
      const int r = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (mt0_kv + u * us_kv >= nmt) continue;
        const int t = base + mt0_kv + u * us_kv, j0 = t % KT * 16;
        bf16* dst = dst0 + (size_t)t * 16 * LD;
        const bool ok0 = j0 + r < geo.lk, ok1 = j0 + r + 8 < geo.lk;  // rows past lk are not tokens: zero
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const int col = n * 8 + c2;
          const float b0 = bb[col], b1 = bb[col + 1];
          *reinterpret_cast<uint32_t*>(dst + r * LD + col) = ok0 ? pack_bf16(acc[u][n][0] + b0, acc[u][n][1] + b1) : 0u;
          *reinterpret_cast<uint32_t*>(dst + (r + 8) * LD + col) =
              ok1 ? pack_bf16(acc[u][n][2] + b0, acc[u][n][3] + b1) : 0u;
        }
      }
    }
  }
  if (csz > 1) {
    // this rank's K and V share into every peer's shared memory (16-byte
    // stores; the peers started: cluster barrier 1, arrived at the start)
    __syncthreads();
    cluster_wait();
    const int n = (t_hi - t_lo) * 16 * CH;
    for (int p = 1; p < csz; ++p) {
      const uint32_t peer = (rank + p) % csz;
      for (int which = 0; which < 2; ++which) {
        const bf16* share = (which ? vs : ks) + (size_t)t_lo * 16 * LD;
        for (int i = tid; i < n; i += nthr) {
          const bf16* row = share + (i / CH) * LD + (i % CH) * 8;
          st_cluster16(map_rank(smem_u32(row), peer), *reinterpret_cast<const uint4*>(row));
        }
      }
    }
    cluster_arrive();  // barrier 2: this rank's share has reached its peers
  }

  // 2. q of the rank's slabs (under pooling, tile row 4 r + d is token d of
  // pooled row r). Each q token lies in the rank's tiles (all of the group's
  // without a cluster): with res its row of y, else its statistics in st.
  {
    const int pm = warps * U, mt0 = warp, us = warps;
    const bf16* wq_h = wq + (size_t)head * geo.c * HD;
    const float* bb = bs;
    // the group tile row of q token tile qt's row rho, or -1 past lq
    auto q_token = [&](int qt, int rho) {
      const int g = qt / geo.qtiles, ti = qt % geo.qtiles;
      const int qi = geo.q_pool ? 4 * ti + rho / 4 : 16 * ti + rho;
      if (qi >= geo.lq) return -1;
      return g * LKP + (geo.q_pool ? ptok[qi] + (rho & 2) / 2 * geo.ws + (rho & 1) : qi);
    };
    for (int base = qt_lo; base < qt_hi; base += pm) {
      const int nmt = imin(pm, qt_hi - base);
      const bf16* a_src[4];
      bool a_on[4], a_ok[4];
      float2 a_st[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int row = (tid + k * nthr) >> 2, qt = base + row / 16;
        const int gr = row < nmt * 16 ? q_token(qt, row % 16) : -1;
        a_on[k] = !res && row < nmt * 16;
        a_ok[k] = a_on[k] && gr >= 0;
        a_src[k] = a_ok[k] ? x + wb[gr / LKP] + toff[gr % LKP] : x;
        a_st[k] = a_ok[k] && geo.ln ? st[gr - t_lo * 16] : make_float2(0.f, 0.f);
      }
      uint32_t ya[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int gr = q_token(base + mt0 + (mt0 + u * us < nmt ? u * us : 0), lane & 15);
        ya[u] = smem_u32(y + (size_t)(gr >= 0 ? gr - t_lo * 16 : 0) * L.ldy + ya_col);
      }
      float acc[U][HD / 8][4];
      if (res)
        project<1, 4, true>(acc, a_src, a_on, a_ok, a_st, ya, gb, geo.ln, wq_h, wq_h, geo.c, ring, L.slot,
                            L.a_rows_q, mt0, us, 0, nmt, false);
      else
        project<1, 4, false>(acc, a_src, a_on, a_ok, a_st, ya, gb, geo.ln, wq_h, wq_h, geo.c, ring, L.slot,
                             L.a_rows_q, mt0, us, 0, nmt, false);
      const int r = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (mt0 + u * us >= nmt) continue;
        const int qt = base + mt0 + u * us, g = qt / geo.qtiles, ti = qt % geo.qtiles;
        bf16* dst = qs + (size_t)(g * geo.slabs + ti / P - s_lo) * 16 * LD;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const int col = n * 8 + c2;
          const float b0 = bb[col], b1 = bb[col + 1];
          if (!geo.q_pool) {
            *reinterpret_cast<uint32_t*>(dst + r * LD + col) = pack_bf16(acc[u][n][0] + b0, acc[u][n][1] + b1);
            *reinterpret_cast<uint32_t*>(dst + (r + 8) * LD + col) =
                pack_bf16(acc[u][n][2] + b0, acc[u][n][3] + b1);
          } else {
            // rounded q, then the max over the four tokens of a pooled row: tile rows 4 r' + d
            // are the lanes whose r differs in its low two bits (lanes xor 4 and xor 8)
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              v[e] = bf16_round(acc[u][n][e] + (e & 1 ? b1 : b0));
              v[e] = fmaxf(v[e], __shfl_xor_sync(0xffffffffu, v[e], 4));
              v[e] = fmaxf(v[e], __shfl_xor_sync(0xffffffffu, v[e], 8));
            }
            if ((r & 3) == 0) {
              const int row = 4 * (ti % 4) + r / 4;  // pooled rows of tile rows r and r + 8
              *reinterpret_cast<uint32_t*>(dst + row * LD + col) = pack_bf16(v[0], v[1]);
              *reinterpret_cast<uint32_t*>(dst + (row + 2) * LD + col) = pack_bf16(v[2], v[3]);
            }
          }
        }
      }
    }
  }

  if (csz > 1) cluster_wait();  // barrier 2: the peers' shares have arrived
  __syncthreads();

  // 3. attention, one 16-row query slab a warp
  const int c_out = geo.nh * HD;
  for (int sl = warp; sl < s_hi - s_lo; sl += warps) {
    const int gs = s_lo + sl, g = gs / geo.slabs, s0 = gs % geo.slabs * 16;
    bf16* qsl = qs + (size_t)sl * 16 * LD;
    const bf16* kw = ks + (size_t)g * LKP * LD;
    float s[2 * KT][4], l[2];
    slab_probs<HD, KT, LD>(qsl, kw, geo.lk, scale, s, l);
    float ov[HD / 8][4];
    slab_pv<HD, KT, LD>(s, l, vs + (size_t)g * LKP * LD, ov);
    __syncwarp();
    // o rounded once into the warp's q slab, then stored as 16-byte rows
    const int r = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(qsl + r * LD + j * 8 + c2) = pack_bf16(ov[j][0], ov[j][1]);
      *reinterpret_cast<uint32_t*>(qsl + (r + 8) * LD + j * 8 + c2) = pack_bf16(ov[j][2], ov[j][3]);
    }
    __syncwarp();
    const int wg = w0 + g, bi = wg / geo.nwin, wi = wg - bi * geo.nwin;
    const int wy = wi / geo.nww, wx = wi - wy * geo.nww;
    for (int i = lane; i < 16 * CH; i += 32) {
      const int rr = i / CH, ch = i % CH, qi = s0 + rr;
      if (qi >= geo.lq) continue;
      const int oy = wy * geo.wso + qi / geo.wso, ox = wx * geo.wso + qi % geo.wso;
      *reinterpret_cast<uint4*>(o + (((size_t)bi * geo.hpo + oy) * geo.wpo + ox) * c_out + head * HD + ch * 8) =
          *reinterpret_cast<const uint4*>(qsl + rr * LD + ch * 8);
    }
    __syncwarp();
  }
}

// out[m, n] = o[m, k] . wo[k, n] + bo, a BM x BN tile a block of 2 WM warps,
// BM = 16 WM, BN = 16 NT: warp w takes rows 16 (w % WM) and the NT 8-column
// tiles at NT * 8 * (w / WM). k is a multiple of HD: the ring's stages hold
// HD-deep chunks (one head's channels), PSTAGES of them.
template <int WM, int NT>
struct ProjSmem {
  static constexpr int BM = 16 * WM, BN = 16 * NT, LDB = BN + 8, SLOT = BM * LD + HD * LDB, THREADS = 64 * WM;
  static constexpr size_t BYTES = sizeof(bf16) * PSTAGES * SLOT;
};

template <int WM, int NT>
__global__ void __launch_bounds__(64 * WM) out_proj_kernel(const bf16* __restrict__ o, const bf16* __restrict__ wo,
                                                           const float* __restrict__ bo, bf16* __restrict__ out,
                                                           int m, int k, int n) {
  using S = ProjSmem<WM, NT>;
  constexpr int BM = S::BM, BN = S::BN, LDB = S::LDB, SLOT = S::SLOT, THREADS = S::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int wm = warp % WM, wn = warp / WM;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int nch = k / HD;
  auto issue = [&](int c, bf16* sa) {
    for (int i = tid; i < BM * (HD / 8); i += THREADS) {
      const int r = i / (HD / 8), ch = i % (HD / 8);
      const bool ok = row0 + r < m;
      cp_async16(smem_u32(sa + r * LD + ch * 8), o + (size_t)(ok ? row0 + r : 0) * k + c * HD + ch * 8, ok);
    }
    bf16* sb = sa + BM * LD;
    for (int i = tid; i < HD * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), ch = i % (BN / 8);
      cp_async16(smem_u32(sb + r * LDB + ch * 8), wo + (size_t)(c * HD + r) * n + col0 + ch * 8, true);
    }
  };
#pragma unroll
  for (int c = 0; c < PSTAGES - 1; ++c) {
    if (c < nch) issue(c, ring + c * SLOT);
    cp_commit();
  }
  const int a_l = a_off(lane, LD), b_l = bt_off(lane, LDB);
  for (int c = 0; c < nch; ++c) {
    cp_wait<PSTAGES - 2>();
    __syncthreads();  // chunk c has landed for every thread, and chunk c - 1's stage is free
    if (c + PSTAGES - 1 < nch) issue(c + PSTAGES - 1, ring + (c + PSTAGES - 1) % PSTAGES * SLOT);
    cp_commit();
    const bf16* sa = ring + c % PSTAGES * SLOT;
    const bf16* sb = sa + BM * LD + wn * NT * 8;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4], b[NT / 2][4];
      ldsm_x4(smem_u32(sa + wm * 16 * LD + a_l + kk * 16), a);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) ldsm_x4_t(smem_u32(sb + kk * 16 * LDB + b_l + p * 16), b[p]);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        mma(acc[2 * p], a, b[p][0], b[p][1]);
        mma(acc[2 * p + 1], a, b[p][2], b[p][3]);
      }
    }
  }
  cp_wait<0>();
  const int r = row0 + wm * 16 + (lane >> 2), c2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = col0 + wn * NT * 8 + j * 8 + c2;
    const float b0 = bo[col], b1 = bo[col + 1];
    if (r < m) *reinterpret_cast<uint32_t*>(out + (size_t)r * n + col) = pack_bf16(acc[j][0] + b0, acc[j][1] + b1);
    if (r + 8 < m)
      *reinterpret_cast<uint32_t*>(out + (size_t)(r + 8) * n + col) = pack_bf16(acc[j][2] + b0, acc[j][3] + b1);
  }
}

template <int WM, int NT>
cudaError_t launch_proj(const void* o, const void* wo, const void* bo, void* out, int m, int k, int n,
                        cudaStream_t s) {
  using S = ProjSmem<WM, NT>;
  cudaError_t e = allow_smem(out_proj_kernel<WM, NT>, S::BYTES);
  if (e != cudaSuccess) return e;
  out_proj_kernel<WM, NT><<<dim3(cdiv(m, S::BM), n / S::BN), S::THREADS, S::BYTES, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(wo), static_cast<const float*>(bo),
      static_cast<bf16*>(out), m, k, n);
  return cudaGetLastError();
}

template <int WM, int NT>
cudaError_t proj_occupancy(int* blocks) {
  using S = ProjSmem<WM, NT>;
  cudaError_t e = allow_smem(out_proj_kernel<WM, NT>, S::BYTES);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, out_proj_kernel<WM, NT>, S::THREADS, S::BYTES);
}

// the output projection's tiles: rows 64 or 32, 8-column tiles a warp 6 or 2 (BN 96 or 32)
bool valid_proj(int rows, int nt) { return (rows == 64 || rows == 32) && (nt == 6 || nt == 2); }

cudaError_t dispatch_proj(int rows, int nt, const void* o, const void* wo, const void* bo, void* out, int m, int k,
                          int n, cudaStream_t s) {
  if (rows == 64) return nt == 6 ? launch_proj<4, 6>(o, wo, bo, out, m, k, n, s) : launch_proj<4, 2>(o, wo, bo, out, m, k, n, s);
  return nt == 6 ? launch_proj<2, 6>(o, wo, bo, out, m, k, n, s) : launch_proj<2, 2>(o, wo, bo, out, m, k, n, s);
}

cudaError_t dispatch_proj_occupancy(int rows, int nt, int* blocks) {
  if (rows == 64) return nt == 6 ? proj_occupancy<4, 6>(blocks) : proj_occupancy<4, 2>(blocks);
  return nt == 6 ? proj_occupancy<2, 6>(blocks) : proj_occupancy<2, 2>(blocks);
}

// the key tiles of the instantiation that holds ws x ws keys
inline int key_tiles(int ws) { return ws <= 4 ? 1 : ws <= 8 ? 4 : ws <= 14 ? 13 : 16; }

size_t smem_bytes(const Geo& G);

Geo make_geo(int b, int hp, int wp, int c, int ws, int nh, int q_pool, int ln, int gsz, int csz, float eps) {
  Geo g;
  g.hp = hp, g.wp = wp, g.c = c, g.ws = ws, g.nh = nh, g.q_pool = q_pool, g.ln = ln;
  g.wso = q_pool ? ws / 2 : ws;
  g.lk = ws * ws;
  g.lq = g.wso * g.wso;
  g.nww = wp / ws;
  g.nwin = (hp / ws) * g.nww;
  g.n_win = b * g.nwin;
  g.gsz = gsz, g.csz = csz;
  g.slabs = cdiv(g.lq, 16);
  g.qtiles = cdiv((q_pool ? 4 : 1) * g.lq, 16);
  g.hpo = hp / ws * g.wso;
  g.wpo = g.nww * g.wso;
  g.eps = eps;
  g.res = ln;
  g.res = ln && smem_bytes(g) <= (size_t)SMEM_PER_BLOCK;
  return g;
}

cudaLaunchConfig_t config(int blocks, size_t bytes, cudaStream_t stream, cudaLaunchAttribute* attr, int csz) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(NTHR, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csz;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

struct Args {
  const void *x, *gamma, *beta, *wq, *wk, *wv, *bq, *bk, *bv;
  void* o;
};

template <int KT>
cudaError_t launch(const Args& a, const Geo& G, float scale, cudaStream_t stream) {
  const Smem<KT> L(G);
  cudaError_t e = allow_smem(window_attention_v1_kernel<KT>, L.bytes);
  if (e != cudaSuccess) return e;
  const int tasks = cdiv(G.n_win, G.gsz) * G.nh;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(tasks * G.csz, L.bytes, stream, attr, G.csz);
  e = cudaLaunchKernelEx(&cfg, window_attention_v1_kernel<KT>, static_cast<const bf16*>(a.x),
                         static_cast<const float*>(a.gamma), static_cast<const float*>(a.beta),
                         static_cast<const bf16*>(a.wq), static_cast<const bf16*>(a.wk),
                         static_cast<const bf16*>(a.wv), static_cast<const float*>(a.bq),
                         static_cast<const float*>(a.bk), static_cast<const float*>(a.bv), static_cast<bf16*>(a.o),
                         G, scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int KT>
cudaError_t occupancy(const Geo& G, int* smem, int* blocks, int* clusters) {
  const Smem<KT> L(G);
  *smem = (int)L.bytes;
  cudaError_t e = allow_smem(window_attention_v1_kernel<KT>, L.bytes);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, window_attention_v1_kernel<KT>, NTHR, L.bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(G.csz, L.bytes, 0, attr, G.csz);
  return cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<const void*>(window_attention_v1_kernel<KT>), &cfg);
}

cudaError_t dispatch(const Args& a, const Geo& G, float scale, cudaStream_t s) {
  switch (key_tiles(G.ws)) {
    case 1: return launch<1>(a, G, scale, s);
    case 4: return launch<4>(a, G, scale, s);
    case 13: return launch<13>(a, G, scale, s);
    default: return launch<16>(a, G, scale, s);
  }
}

cudaError_t dispatch_occupancy(const Geo& G, int* smem, int* blocks, int* clusters) {
  switch (key_tiles(G.ws)) {
    case 1: return occupancy<1>(G, smem, blocks, clusters);
    case 4: return occupancy<4>(G, smem, blocks, clusters);
    case 13: return occupancy<13>(G, smem, blocks, clusters);
    default: return occupancy<16>(G, smem, blocks, clusters);
  }
}

size_t smem_bytes(const Geo& G) {
  switch (key_tiles(G.ws)) {
    case 1: return Smem<1>(G).bytes;
    case 4: return Smem<4>(G).bytes;
    case 13: return Smem<13>(G).bytes;
    default: return Smem<16>(G).bytes;
  }
}

// a cluster splits a window's token tiles and query slabs alike: unpooled, with as many slabs as key tiles
bool valid_plan(const Geo& G) {
  return G.gsz >= 1 && G.gsz <= MAX_GROUP && G.csz >= 1 && G.csz <= MAX_CLUSTER &&
         (G.csz == 1 || (!G.q_pool && G.slabs == key_tiles(G.ws))) && smem_bytes(G) <= (size_t)SMEM_PER_BLOCK;
}

bool valid_shape(int hp, int wp, int c, int ws, int q_pool) {
  return ws > 0 && ws <= MAX_WS && hp % ws == 0 && wp % ws == 0 && !(q_pool && ws % 2) && c > 0 && c % KC == 0;
}

}  // namespace

// Shared memory an attention block of the plan (gsz, csz) takes at (ws,
// q_pool, c, ln), the blocks of it an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the clusters of csz
// blocks the card runs at once (cudaOccupancyMaxActiveClusters).
extern "C" int usm_window_attention_v1_occupancy(int ws, int q_pool, int c, int ln, int gsz, int csz, int* smem,
                                                 int* blocks, int* clusters) {
  if (!valid_shape(ws, ws, c, ws, q_pool)) return cudaErrorInvalidValue;
  const Geo G = make_geo(1, ws, ws, c, ws, 1, q_pool, ln, gsz, csz, 0.f);
  if (!valid_plan(G)) return cudaErrorInvalidValue;
  return dispatch_occupancy(G, smem, blocks, clusters);
}

// Blocks of the output projection's tile (rows x 16 nt columns) an SM holds.
extern "C" int usm_window_attention_v1_proj_occupancy(int rows, int nt, int* blocks) {
  if (!valid_proj(rows, nt)) return cudaErrorInvalidValue;
  return dispatch_proj_occupancy(rows, nt, blocks);
}

// o is scratch [B, Hpo, Wpo, nh*96] bf16 (the heads' outputs before the
// projection). gsz, csz, rows, nt: the plan (kernels/rejected/window_attention_v1.py
// plan_for()): windows a group, blocks a cluster, the output projection's
// tile rows (64 or 32) and 8-column tiles a warp (6 or 2).
extern "C" int usm_window_attention_v1_bf16(const void* x, const void* gamma, const void* beta, const void* wq,
                                            const void* wk, const void* wv, const void* bq, const void* bk,
                                            const void* bv, const void* wo, const void* bo, void* o, void* out, int b,
                                            int hp, int wp, int c, int nh, int hd, int co, int ws, int q_pool,
                                            int ln_inside, int gsz, int csz, int rows, int nt, float eps,
                                            float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_shape(hp, wp, c, ws, q_pool) || nh <= 0 || !valid_proj(rows, nt) || co <= 0 || co % (16 * nt))
    return cudaErrorInvalidValue;
  if (hd != HD) return cudaErrorInvalidValue;  // Hiera-tiny's head width at every stage
  const Geo G = make_geo(b, hp, wp, c, ws, nh, q_pool, ln_inside, gsz, csz, eps);
  if (!valid_plan(G)) return cudaErrorInvalidValue;
  if (b <= 0 || hp <= 0 || wp <= 0) return cudaSuccess;
  const Args a = {x, gamma, beta, wq, wk, wv, bq, bk, bv, o};
  cudaError_t e = dispatch(a, G, scale, s);
  if (e != cudaSuccess) return e;
  const int m = b * G.hpo * G.wpo;
  return dispatch_proj(rows, nt, o, wo, bo, out, m, nh * HD, co, s);
}

