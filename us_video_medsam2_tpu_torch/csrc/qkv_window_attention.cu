// qkv projection + windowed multi-head attention (optional 2x2 q max-pool) in one pass.
//
// Replaces us_video_medsam2_tpu/kernels/fused_window_attention.py
// (fused_qkv_window_attention, _kernel_qkv). y [B, Hp, Wp, Cin] bf16 (post-norm1
// tokens, zero-padded to whole windows), W [3*nh*HD, Cin] bf16 (the Linear's
// layout), b [3*nh*HD] f32 -> out [B, Hp/ws*wso, Wp/ws*wso, nh*HD] bf16.
//
// What bounds it on the H100: operations, the projection's 2*Hp*Wp*Cin*3*nh*HD
// flop (0.5-2 us at 989 TFLOP/s at the presets' shapes). At B 1 the work is
// small, so what a call costs is the chain of one block: stream the weights
// and tokens in, run the products, attend. The design spreads that chain
// over the card and keeps every intermediate on chip (the qkv map never
// reaches device memory):
//  * a block of 8 warps is (a group of G windows, one head, one rank of a
//    cluster of C blocks); kernels/qkv_window_attention.py's plan_for()
//    picks (G, C) from the shape alone. Small windows (ws 4, 8) take G > 1:
//    the G windows' tokens are the M dimension of the products (64-128
//    rows), so the head's weight rows are read once per G windows. Large
//    windows (ws 14, 7) at B 1 give 36-72 window-heads for 132 SMs, so C > 1
//    blocks of a thread-block cluster share one: each projects K and V for
//    its 1/C share of the group's 16-row token tiles and q for its share of
//    the query slabs. Each block stores its K and V share into its peers' shared memory
//    (distributed shared memory, 16-byte stores) between two cluster
//    barriers: the first (arrived at the start) says every peer is running,
//    the second (waited on after the q projection) that every share has
//    landed. After it a block reads only its own shared memory, so it may
//    exit without waiting on its peers;
//  * the projections are mma.sync.m16n8k16 products (bf16, f32 accumulators
//    in registers, fragments from ldmatrix) fed by a 3-stage cp.async ring of
//    32-wide Cin chunks, one block barrier a chunk: the token rows are
//    gathered straight from the padded map by address (a window partition
//    costs nothing), the head's weight rows come through the same ring. A
//    warp holds two 16-row tiles against HD weight columns (K or V, or q);
//    the epilogue adds the f32 bias in registers and rounds once into the
//    bf16 tiles the attention reads: key rows past ws*ws (not tokens) are
//    written as zeros, while a zero pad token of the map is a token and gets
//    exactly the bias. Under q pooling the four tokens behind a pooled query
//    are gathered into neighbouring rows (row 4 r + d), so the 2x2 max of
//    the rounded q is two shuffles of the accumulator lanes;
//  * attention is csrc/window_attn_core.cuh's slab core (one warp a 16-row
//    query slab, scores, softmax and P in registers), on every warp of the
//    block; O is rounded once and stored unpartitioned. Every output row is
//    computed (the JAX qkv kernel has no last-strip cut).
// No split over Cin, no atomics: two calls give the same bits.
#include "window_attn_core.cuh"

namespace {

using namespace usm;

constexpr int MAX_WS = 14;
constexpr int WARPS = 8;  // warps a block
constexpr int NTHR = WARPS * 32;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int MAX_GROUP = 8;    // windows a group
constexpr int KC = 32;          // Cin columns of one ring stage
constexpr int LDR = KC + 8;     // bf16 row stride of a ring row: 80 bytes, 8 ldmatrix rows in distinct banks
constexpr int STAGES = 3;
constexpr long long SMEM_PER_BLOCK = 232448;
constexpr int U = 2;            // 16-row tiles a warp projects in one pass, against the same weight fragments

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

struct Geo {
  int hp, wp, cin, ws, nh, q_pool;
  int wso, lk, lq, nww, nwin, n_win;  // nwin: windows of an image; n_win: of the batch
  int gsz, csz;                        // the plan: windows a group, blocks a cluster
  int slabs, qtiles;                   // 16-row query slabs of a window; 16-row q token tiles of a window
  int hpo, wpo;
};

// Dynamic shared memory of a block: the head's q, k and v bias, the token
// address tables (each window's first token, each token's offset in its
// window, the first token of each pooled query), the group's K
// and V (KT * 16 rows a window), the block's q slabs, then the ring's STAGES
// stages, each with room for the most token rows a pass of this plan copies
// and its weight rows.
template <int HD, int KT>
struct Smem {
  size_t bs, wb, toff, ptok, ks, vs, qs, ring, slot, bytes;  // slot: elements of one ring stage
  int a_rows_kv, a_rows_q;               // token rows of a K/V pass and of a q pass
  __host__ __device__ explicit Smem(const Geo& G) {
    constexpr int LD = HD + 8;
    const size_t kv = sizeof(bf16) * (size_t)G.gsz * KT * 16 * LD;
    const int slabs = cdiv(G.gsz * G.slabs, G.csz);  // the most slabs a rank takes
    bs = 0;
    wb = sizeof(float) * 3 * HD;
    toff = wb + sizeof(long long) * MAX_GROUP;
    ptok = toff + sizeof(int) * KT * 16;
    ks = align128(ptok + sizeof(int) * KT * 16);
    vs = ks + kv;
    qs = vs + kv;
    ring = align128(qs + sizeof(bf16) * (size_t)slabs * 16 * LD);
    a_rows_kv = imin(WARPS * U / 2, cdiv(G.gsz * KT, G.csz)) * 16;
    a_rows_q = imin(WARPS * U, slabs * (G.q_pool ? 4 : 1)) * 16;
    const int kv_rows = a_rows_kv + 2 * HD, q_rows = a_rows_q + HD;
    slot = (size_t)(kv_rows > q_rows ? kv_rows : q_rows) * LDR;
    bytes = ring + sizeof(bf16) * STAGES * slot;
  }
};

// One pass of a projection: acc[u] = A[mt0 + u] . Wnb^T over Cin, f32, for
// this warp (tiles at or past nmt are computed on tile mt0 and discarded).
// A: the pass's token rows, each thread copying NA of them
// (row (tid + k * nthr) / 4, 16-byte chunk (tid + k * nthr) % 4 of a
// stage) from a_src[k] (zero-filled where !a_ok[k], not copied where
// !a_on[k]); W: NB * HD weight rows, w0's HD rows then w1's.
template <int HD, int NB, int NA>
__device__ __forceinline__ void project(float (&acc)[U][HD / 8][4], const bf16* const (&a_src)[NA],
                                        const bool (&a_on)[NA], const bool (&a_ok)[NA],
                                        const bf16* __restrict__ w0, const bf16* __restrict__ w1, int cin,
                                        bf16* ring, size_t slot, int a_rows, int mt0, int nb, int nmt) {
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31;  // nthr is NTHR (see the kernel)
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) acc[u][j][0] = acc[u][j][1] = acc[u][j][2] = acc[u][j][3] = 0.f;
  const int nch = cin / KC;
  // chunk c lands in stage c % STAGES: the stage pointers step along with c
  bf16* const last = ring + (STAGES - 1) * slot;
  auto step = [&](bf16* p) { return p == last ? ring : p + slot; };
  auto issue = [&](int c, bf16* sa) {
    bf16* sb = sa + a_rows * LDR;
    const int k0 = c * KC;
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      const int i = tid + k * nthr;
      if (a_on[k]) cp_async16(smem_u32(sa + (i >> 2) * LDR + (i & 3) * 8), a_src[k] + k0 + (i & 3) * 8, a_ok[k]);
    }
    for (int i = tid; i < NB * HD * (KC / 8); i += nthr) {
      const int r = i >> 2, ch = i & 3;
      const bf16* src = NB == 2 && r >= HD ? w1 + (size_t)(r - HD) * cin : w0 + (size_t)r * cin;
      cp_async16(smem_u32(sb + r * LDR + ch * 8), src + k0 + ch * 8, true);
    }
  };
  __syncthreads();  // the ring's readers of a previous pass are done
  bf16* in = ring;  // the stage of the next chunk to issue
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nch) issue(c, in);
    cp_commit();
    in = step(in);
  }
  const int a_l = a_off(lane, LDR), b_l = b_off(lane, LDR);
  bf16* sa = ring;  // the stage of chunk c
  for (int c = 0; c < nch; ++c, sa = step(sa)) {
    cp_wait<STAGES - 2>();  // chunk c has landed
    __syncthreads();        // ... for every thread, and chunk c - 1's stage is free
    if (c + STAGES - 1 < nch) issue(c + STAGES - 1, in);
    cp_commit();
    in = step(in);
    if (mt0 >= nmt) continue;
    const bf16* sb = sa + (a_rows + nb * HD) * LDR;
    // every fragment of the chunk first, then its products: the loads are
    // issued back to back instead of each waiting in front of its products
    uint32_t a[KC / 16][U][4], b[KC / 16][HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        ldsm_x4(smem_u32(sa + (mt0 + (mt0 + u < nmt ? u : 0)) * 16 * LDR + a_l + kk * 16), a[kk][u]);
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) ldsm_x4(smem_u32(sb + n * 16 * LDR + b_l + kk * 16), b[kk][n]);
    }
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
#pragma unroll
      for (int n = 0; n < HD / 16; ++n)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          mma(acc[u][2 * n], a[kk][u], b[kk][n][0], b[kk][n][1]);
          mma(acc[u][2 * n + 1], a[kk][u], b[kk][n][2], b[kk][n][3]);
        }
  }
  cp_wait<0>();
}

template <int HD, int KT>
__global__ void __launch_bounds__(NTHR) qkv_window_attention_kernel(
    const bf16* __restrict__ y, const bf16* __restrict__ wqkv, const float* __restrict__ bqkv,
    bf16* __restrict__ out, const Geo geo, float scale) {
  constexpr int LD = HD + 8;
  constexpr int CH = HD / 8;  // 16-byte chunks of a head row
  constexpr int LKP = KT * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  // strides from blockDim, which is NTHR at every launch: as compile-time
  // constants they measured ~2% slower a ws-14 call
  const int tid = threadIdx.x, nthr = blockDim.x, warps = nthr >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const Smem<HD, KT> L(geo);
  float* bs = reinterpret_cast<float*>(smem + L.bs);
  long long* wb = reinterpret_cast<long long*>(smem + L.wb);
  int* toff = reinterpret_cast<int*>(smem + L.toff);
  int* ptok = reinterpret_cast<int*>(smem + L.ptok);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.ks);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.vs);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.qs);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);

  // the block's task (a group of windows and a head) and its rank's shares:
  // group tiles [t_lo, t_hi) (tile t is rows 16 t of ks and vs), slabs
  // [s_lo, s_hi) (group slab g * slabs + s), q token tiles [qt_lo, qt_hi)
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
  // the head's bias (q, k, v), read by every epilogue
  for (int i = tid; i < 3 * HD; i += nthr) bs[i] = bqkv[(i / HD * geo.nh + head) * HD + i % HD];
  // token j of the group's window g is y + wb[g] + toff[j]; pooled query qi's
  // four tokens are ptok[qi] + (0, 1, ws, ws + 1)
  if (tid < gw) {
    const int wg = w0 + tid, bi = wg / geo.nwin, wi = wg - bi * geo.nwin;
    const int wy = wi / geo.nww, wx = wi - wy * geo.nww;
    wb[tid] = (((long long)bi * geo.hp + wy * geo.ws) * geo.wp + wx * geo.ws) * geo.cin;
  }
  for (int j = tid; j < geo.lk; j += nthr) toff[j] = (j / geo.ws * geo.wp + j % geo.ws) * geo.cin;
  if (geo.q_pool)
    for (int qi = tid; qi < geo.lq; qi += nthr) ptok[qi] = 2 * (qi / geo.wso) * geo.ws + 2 * (qi % geo.wso);
  __syncthreads();
  // pooled q slab rows past lq that no tile covers are zeros (finite; never stored)
  if (geo.q_pool)
    for (int i = tid; i < (s_hi - s_lo) * 16 * CH; i += nthr)
      *reinterpret_cast<uint4*>(qs + (i / CH) * LD + (i % CH) * 8) = make_uint4(0, 0, 0, 0);

  // 1. K and V of the rank's tiles: warps [0, warps/2) project K, the others V
  {
    const int pm = warps * U / 2;
    const int nb = warp / (warps / 2), mt0 = warp % (warps / 2) * U;
    const bf16* wk = wqkv + (size_t)(geo.nh + head) * HD * geo.cin;
    const bf16* wv = wqkv + (size_t)(2 * geo.nh + head) * HD * geo.cin;
    const float* bb = bs + (1 + nb) * HD;
    bf16* dst0 = nb ? vs : ks;
    for (int base = t_lo; base < t_hi; base += pm) {
      const int nmt = imin(pm, t_hi - base);
      const bf16* a_src[2];
      bool a_on[2], a_ok[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int row = (tid + k * nthr) >> 2, t = base + row / 16, j = t % KT * 16 + row % 16;
        a_on[k] = row < nmt * 16;
        a_ok[k] = a_on[k] && j < geo.lk;
        a_src[k] = a_ok[k] ? y + wb[t / KT] + toff[j] : y;
      }
      float acc[U][HD / 8][4];
      project<HD, 2, 2>(acc, a_src, a_on, a_ok, wk, wv, geo.cin, ring, L.slot, L.a_rows_kv, mt0, nb, nmt);
      const int r = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (mt0 + u >= nmt) continue;
        const int t = base + mt0 + u, j0 = t % KT * 16;
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

  // 2. q of the rank's slabs (under pooling, tile row 4 r + d is token d of pooled row r)
  {
    const int pm = warps * U, mt0 = warp * U;
    const bf16* wq = wqkv + (size_t)head * HD * geo.cin;
    const float* bb = bs;
    for (int base = qt_lo; base < qt_hi; base += pm) {
      const int nmt = imin(pm, qt_hi - base);
      const bf16* a_src[4];
      bool a_on[4], a_ok[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int row = (tid + k * nthr) >> 2, qt = base + row / 16, rho = row % 16;
        const int g = qt / geo.qtiles, ti = qt % geo.qtiles;
        const int qi = geo.q_pool ? 4 * ti + rho / 4 : 16 * ti + rho;
        a_on[k] = row < nmt * 16;
        a_ok[k] = a_on[k] && qi < geo.lq;
        a_src[k] = a_ok[k] ? y + wb[g] + toff[geo.q_pool ? ptok[qi] + (rho & 2) / 2 * geo.ws + (rho & 1) : qi] : y;
      }
      float acc[U][HD / 8][4];
      project<HD, 1, 4>(acc, a_src, a_on, a_ok, wq, wq, geo.cin, ring, L.slot, L.a_rows_q, mt0, 0, nmt);
      const int r = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (mt0 + u >= nmt) continue;
        const int qt = base + mt0 + u, g = qt / geo.qtiles, ti = qt % geo.qtiles;
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

  // 4. attention, one 16-row query slab a warp
  const int c_out = geo.nh * HD;
  for (int sl = warp; sl < s_hi - s_lo; sl += warps) {
    const int gs = s_lo + sl, g = gs / geo.slabs, s0 = gs % geo.slabs * 16;
    bf16* qsl = qs + (size_t)sl * 16 * LD;
    const bf16* kw = ks + (size_t)g * LKP * LD;
    float s[2 * KT][4], l[2];
    slab_probs<HD, KT, LD>(qsl, kw, geo.lk, scale, s, l);
    float o[HD / 8][4];
    slab_pv<HD, KT, LD>(s, l, vs + (size_t)g * LKP * LD, o);
    __syncwarp();
    // O rounded once into the warp's q slab, then stored as 16-byte rows
    const int r = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(qsl + r * LD + j * 8 + c2) = pack_bf16(o[j][0], o[j][1]);
      *reinterpret_cast<uint32_t*>(qsl + (r + 8) * LD + j * 8 + c2) = pack_bf16(o[j][2], o[j][3]);
    }
    __syncwarp();
    const int wg = w0 + g, bi = wg / geo.nwin, wi = wg - bi * geo.nwin;
    const int wy = wi / geo.nww, wx = wi - wy * geo.nww;
    for (int i = lane; i < 16 * CH; i += 32) {
      const int rr = i / CH, ch = i % CH, qi = s0 + rr;
      if (qi >= geo.lq) continue;
      const int oy = wy * geo.wso + qi / geo.wso, ox = wx * geo.wso + qi % geo.wso;
      *reinterpret_cast<uint4*>(out + (((size_t)bi * geo.hpo + oy) * geo.wpo + ox) * c_out + head * HD + ch * 8) =
          *reinterpret_cast<const uint4*>(qsl + rr * LD + ch * 8);
    }
    __syncwarp();
  }
}

// the key tiles of the instantiation that holds ws x ws keys
inline int key_tiles(int ws) { return ws <= 4 ? 1 : ws <= 8 ? 4 : 13; }

Geo make_geo(int b, int hp, int wp, int cin, int ws, int nh, int q_pool, int gsz, int csz) {
  Geo g;
  g.hp = hp, g.wp = wp, g.cin = cin, g.ws = ws, g.nh = nh, g.q_pool = q_pool;
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

template <int HD, int KT>
cudaError_t launch(const void* y, const void* w, const void* bias, void* out, const Geo& G, float scale,
                   cudaStream_t stream) {
  const Smem<HD, KT> L(G);
  cudaError_t e = allow_smem(qkv_window_attention_kernel<HD, KT>, L.bytes);
  if (e != cudaSuccess) return e;
  const int tasks = cdiv(G.n_win, G.gsz) * G.nh;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(tasks * G.csz, L.bytes, stream, attr, G.csz);
  e = cudaLaunchKernelEx(&cfg, qkv_window_attention_kernel<HD, KT>, static_cast<const bf16*>(y),
                         static_cast<const bf16*>(w), static_cast<const float*>(bias), static_cast<bf16*>(out), G,
                         scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int HD, int KT>
cudaError_t occupancy(const Geo& G, int* smem, int* blocks, int* clusters) {
  const Smem<HD, KT> L(G);
  *smem = (int)L.bytes;
  cudaError_t e = allow_smem(qkv_window_attention_kernel<HD, KT>, L.bytes);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, qkv_window_attention_kernel<HD, KT>, NTHR, L.bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(G.csz, L.bytes, 0, attr, G.csz);
  return cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<const void*>(qkv_window_attention_kernel<HD, KT>),
                                        &cfg);
}

template <int HD>
cudaError_t dispatch(const void* y, const void* w, const void* bias, void* out, const Geo& G, float scale,
                     cudaStream_t s) {
  switch (key_tiles(G.ws)) {
    case 1: return launch<HD, 1>(y, w, bias, out, G, scale, s);
    case 4: return launch<HD, 4>(y, w, bias, out, G, scale, s);
    default: return launch<HD, 13>(y, w, bias, out, G, scale, s);
  }
}

template <int HD>
cudaError_t dispatch_occupancy(const Geo& G, int* smem, int* blocks, int* clusters) {
  switch (key_tiles(G.ws)) {
    case 1: return occupancy<HD, 1>(G, smem, blocks, clusters);
    case 4: return occupancy<HD, 4>(G, smem, blocks, clusters);
    default: return occupancy<HD, 13>(G, smem, blocks, clusters);
  }
}

size_t smem_bytes(int hd, const Geo& G) {
  const int kt = key_tiles(G.ws);
  if (hd == 96) return kt == 1 ? Smem<96, 1>(G).bytes : kt == 4 ? Smem<96, 4>(G).bytes : Smem<96, 13>(G).bytes;
  return kt == 1 ? Smem<64, 1>(G).bytes : kt == 4 ? Smem<64, 4>(G).bytes : Smem<64, 13>(G).bytes;
}

bool valid_plan(int hd, const Geo& G) {
  return (hd == 96 || hd == 64) && G.gsz >= 1 && G.gsz <= MAX_GROUP && G.csz >= 1 && G.csz <= MAX_CLUSTER &&
         smem_bytes(hd, G) <= (size_t)SMEM_PER_BLOCK;
}

bool valid_shape(int hp, int wp, int cin, int ws, int q_pool) {
  return ws > 0 && ws <= MAX_WS && hp % ws == 0 && wp % ws == 0 && !(q_pool && ws % 2) && cin > 0 && cin % KC == 0;
}

}  // namespace

// Shared memory a block of the plan (gsz, csz) takes at (hd, ws, q_pool),
// the blocks of it an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the clusters of csz
// blocks the card runs at once (cudaOccupancyMaxActiveClusters).
extern "C" int usm_qkv_window_attention_occupancy(int hd, int ws, int q_pool, int gsz, int csz, int* smem,
                                                  int* blocks, int* clusters) {
  if (!valid_shape(ws, ws, KC, ws, q_pool)) return cudaErrorInvalidValue;
  const Geo G = make_geo(1, ws, ws, KC, ws, 1, q_pool, gsz, csz);
  if (!valid_plan(hd, G)) return cudaErrorInvalidValue;
  if (hd == 96) return dispatch_occupancy<96>(G, smem, blocks, clusters);
  return dispatch_occupancy<64>(G, smem, blocks, clusters);
}

// gsz, csz: the plan (kernels/qkv_window_attention.py plan_for()): windows a
// group, blocks a cluster.
extern "C" int usm_qkv_window_attention_bf16(const void* y, const void* w, const void* bias, void* out, int b,
                                             int hp, int wp, int cin, int ws, int nh, int hd, int q_pool, int gsz,
                                             int csz, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_shape(hp, wp, cin, ws, q_pool)) return cudaErrorInvalidValue;
  const Geo G = make_geo(b, hp, wp, cin, ws, nh, q_pool, gsz, csz);
  if (!valid_plan(hd, G)) return cudaErrorInvalidValue;
  if (b <= 0 || hp <= 0 || wp <= 0 || nh <= 0) return cudaSuccess;
  // Hiera-tiny's head width at every stage, and the ViTDet trunks' (384/6, 192/3)
  if (hd == 96) return dispatch<96>(y, w, bias, out, G, scale, s);
  return dispatch<64>(y, w, bias, out, G, scale, s);
}
