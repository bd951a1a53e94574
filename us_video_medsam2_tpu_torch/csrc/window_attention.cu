// Windowed multi-head attention on the dense qkv layout, with optional 2x2 q
// max-pool and the last-strip row cut.
//
// Replaces us_video_medsam2_tpu/kernels/fused_window_attention.py
// (fused_window_attention, _kernel). qkv [B, Hp, Wp, 3*nh*HD] bf16 ->
// out [B, Hp/ws*wso, Wp/ws*wso, nh*HD] bf16, wso = ws/2 with pooling.
//
// What bounds it on the H100: bytes. It reads qkv once and writes out once
// (4.06 + 1.35 MB at t512's ws-14 blocks, 1.6 us at 3.35 TB/s) and does about
// 2*lk*HD operations a byte, far below the card's ~295. At batch 1 the work is
// small (36-72 window-heads at ws 14) and latency-bound: what a call costs is
// the longest chain of one block (copy K and V in, one slab's products and
// softmax, the store), so the design keeps every intermediate on chip and
// spreads the slabs over the 132 SMs:
//  * one warp per 16-row query slab. S = q.k^T stays in mma.sync
//    accumulators (26 n8 tiles at ws 14), pad keys are masked to -inf, the row
//    max and sum go over the quad by shuffles, and P is normalised in f32 and
//    packed to bf16 straight into the A fragments of P.V (window_attn_core.cuh).
//    The whole key row is in registers, so the softmax is exact, with the
//    reference's rounding points. O is rounded to bf16 once, staged through
//    the warp's q slab and stored as 16-byte rows;
//  * the grid is computed on the host (window_tiles() in
//    kernels/window_attention.py, passed in as `warps`): a block holds one
//    window-head's K and V in shared memory (cp.async, 16-byte loads from the
//    dense layout: the window partition costs no device-memory pass; K lands
//    first, so that S starts while V is in flight) and each warp takes one of
//    its slabs. A window-head's slabs are shared evenly over
//    ceil(slabs / warps) blocks, each of which copies K and V again (from
//    L2). window_tiles takes as many warps a block as let the grid run in one
//    wave: all of a block's threads copy its K and V, so fewer, larger blocks
//    copy less and sooner;
//  * the JAX last-strip row cut: with q_lq > 0 the windows of the last
//    strip have only q_lq real query rows (the rest are the map's pad rows,
//    which the caller slices off). Those windows form a second region of the
//    grid with ceil(q_lq / 16) slabs each; the cut rows are written as exact
//    zeros and never computed. The real rows go through the same slab code as
//    without the cut, so they are bit-identical to an uncut call, and the
//    tiling never changes a slab's arithmetic.
// Keys pad to KT * 16 (16, 64 or 208: ws <= 4, <= 8, <= 14) with zero rows.
#include "window_attn_core.cuh"

namespace {

using namespace usm;

constexpr int MAX_WS = 14;
constexpr int MAX_WARPS = 8;

struct Geo {
  int hp, wp, ws, nh, q_pool, wso, lq, lk, nwh, nww, q_lq;
  // region 0: the strips whose every query row is real; region 1: the cut last strip
  int n_wh[2], slabs[2], parts[2], blocks[2];
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int HD>
__host__ __device__ constexpr int ld() { return HD + 8; }

// dynamic shared memory: the window-head's K and V, then one q slab a warp
template <int HD, int KT>
__host__ __device__ inline size_t smem_bytes(int warps) {
  return sizeof(bf16) * ld<HD>() * (size_t)(2 * KT * 16 + warps * 16);
}

__device__ __forceinline__ uint4 hmax4(uint4 a, uint4 b) {
  uint4 r;
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) pr[i] = __hmax2(pa[i], pb[i]);
  return r;
}

template <int HD, int KT>
__global__ void __launch_bounds__(MAX_WARPS * 32) window_attention_kernel(
    const bf16* __restrict__ qkv, bf16* __restrict__ out, const Geo G, float scale) {
  constexpr int LD = ld<HD>();
  constexpr int CH = HD / 8;  // 16-byte chunks of a head row
  constexpr int LKP = KT * 16;
  static_assert(16 * CH % 32 == 0, "a slab's 16-byte chunks share out evenly over a warp");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* kv = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* qs = kv + (size_t)(2 * LKP + warp * 16) * LD;

  // (the regions' fields are picked, not indexed: an index would copy G to local memory)
  const bool region = blockIdx.x >= G.blocks[0];
  const int local = region ? blockIdx.x - G.blocks[0] : blockIdx.x;
  const int parts = region ? G.parts[1] : G.parts[0], slabs = region ? G.slabs[1] : G.slabs[0];
  const int wh = local / parts, part = local % parts;  // the block's window-head, and its part of the slabs
  const int rows = region ? 1 : G.nwh - (G.q_lq ? 1 : 0);  // window rows of the region
  const int wy0 = region ? G.nwh - 1 : 0;
  const int lq_w = region ? G.q_lq : G.lq;  // real query rows of a window here
  const int c_all = 3 * G.nh * HD, c_out = G.nh * HD;
  const int hpo = G.nwh * G.wso, wpo = G.nww * G.wso;

  // window-head i of the region, ordered (batch, window row, window column, head)
  struct WH {
    int b, wy, wx, head;
  };
  auto decode = [&](int i) {
    WH w;
    w.head = i % G.nh;
    i /= G.nh;
    w.wx = i % G.nww;
    i /= G.nww;
    w.wy = wy0 + i % rows;
    w.b = i / rows;
    return w;
  };
  auto token = [&](const WH& w, int r, int c) -> const bf16* {
    return qkv + (((size_t)w.b * G.hp + w.wy * G.ws + r) * G.wp + (w.wx * G.ws + c)) * c_all;
  };
  auto out_row = [&](const WH& w, int qi) -> bf16* {
    const int oy = w.wy * G.wso + qi / G.wso, ox = w.wx * G.wso + qi % G.wso;
    return out + (((size_t)w.b * hpo + oy) * wpo + ox) * c_out + w.head * HD;
  };

  // this warp's slab: slab lo + warp of the block's part
  const int lo = part * slabs / parts, hi = (part + 1) * slabs / parts;
  const int slab = lo + warp < hi ? lo + warp : -1;
  const WH me = decode(wh);

  // cp.async group 0: K and the warp's q rows (unpooled); group 1: V.
  // Rows past lk (and q rows past lq_w) are zero-filled.
  for (int which = 1; which <= 2; ++which) {
    const bf16* src0 = token(me, 0, 0) + (which * G.nh + me.head) * HD;
    bf16* dst0 = kv + (size_t)(which - 1) * LKP * LD;
    for (int i = threadIdx.x; i < LKP * CH; i += blockDim.x) {
      const int t = i / CH, ch = i % CH;
      const int r = t / G.ws;
      const bool ok = t < G.lk;
      const bf16* src = src0 + (ok ? ((size_t)r * G.wp + (t - r * G.ws)) * c_all : 0) + ch * 8;
      cp_async16(smem_u32(dst0 + t * LD + ch * 8), src, ok);
    }
    if (which == 1 && slab >= 0 && !G.q_pool) {
      for (int i = lane; i < 16 * CH; i += 32) {
        const int r = i / CH, ch = i % CH, qi = slab * 16 + r;
        const bool ok = qi < lq_w;
        const bf16* src = token(me, ok ? qi / G.wso : 0, ok ? qi % G.wso : 0) + me.head * HD + ch * 8;
        cp_async16(smem_u32(qs + r * LD + ch * 8), src, ok);
      }
    }
    cp_commit();
  }
  if (slab >= 0 && G.q_pool) {  // the 2x2 max of four tokens, through registers, all loads issued first
    constexpr int PER = 16 * CH / 32;
    uint4 tk[PER][4];
    const size_t dy = (size_t)G.wp * c_all;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = lane + 32 * k, r = i / CH, ch = i % CH, qi = slab * 16 + r;
      const bool ok = qi < lq_w;
      const int pr = ok ? 2 * (qi / G.wso) : 0, pc = ok ? 2 * (qi % G.wso) : 0;
      const bf16* p = token(me, pr, pc) + me.head * HD + ch * 8;
      tk[k][0] = ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
      tk[k][1] = ok ? *reinterpret_cast<const uint4*>(p + c_all) : make_uint4(0, 0, 0, 0);
      tk[k][2] = ok ? *reinterpret_cast<const uint4*>(p + dy) : make_uint4(0, 0, 0, 0);
      tk[k][3] = ok ? *reinterpret_cast<const uint4*>(p + dy + c_all) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = lane + 32 * k;
      *reinterpret_cast<uint4*>(qs + (i / CH) * LD + (i % CH) * 8) =
          hmax4(hmax4(tk[k][0], tk[k][1]), hmax4(tk[k][2], tk[k][3]));
    }
  }
  // the cut rows no slab covers are exact zeros: the window-head's first block writes them
  if (region == 1 && part == 0) {
    for (int i = slabs * 16 * CH + threadIdx.x; i < G.lq * CH; i += blockDim.x)
      *reinterpret_cast<uint4*>(out_row(me, i / CH) + (i % CH) * 8) = make_uint4(0, 0, 0, 0);
  }

  float s[2 * KT][4], l[2];
  cp_wait<1>();  // K and q have landed
  __syncthreads();
  if (slab >= 0) slab_probs<HD, KT, LD>(qs, kv, G.lk, scale, s, l);
  cp_wait<0>();  // V has landed
  __syncthreads();
  if (slab < 0) return;
  float o[HD / 8][4];
  slab_pv<HD, KT, LD>(s, l, kv + (size_t)LKP * LD, o);

  // O rounded once into the warp's q slab, then stored as 16-byte rows:
  // real rows with O, cut rows of the slab (past lq_w) with zeros
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<uint32_t*>(qs + g * LD + j * 8 + 2 * t4) = pack_bf16(o[j][0], o[j][1]);
    *reinterpret_cast<uint32_t*>(qs + (g + 8) * LD + j * 8 + 2 * t4) = pack_bf16(o[j][2], o[j][3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, ch = i % CH, qi = slab * 16 + r;
    if (qi >= G.lq) continue;
    const uint4 v = qi < lq_w ? *reinterpret_cast<const uint4*>(qs + r * LD + ch * 8) : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(out_row(me, qi) + ch * 8) = v;
  }
}

template <int HD, int KT>
cudaError_t launch(const void* qkv, void* out, const Geo& G, int warps, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<HD, KT>(warps);
  cudaError_t e = allow_smem(window_attention_kernel<HD, KT>, bytes);
  if (e != cudaSuccess) return e;
  const int blocks = G.blocks[0] + G.blocks[1];
  if (blocks == 0) return cudaSuccess;
  window_attention_kernel<HD, KT><<<blocks, warps * 32, bytes, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), G, scale);
  return cudaGetLastError();
}

template <int HD, int KT>
cudaError_t occupancy(int warps, int* blocks) {
  const size_t bytes = smem_bytes<HD, KT>(warps);
  cudaError_t e = allow_smem(window_attention_kernel<HD, KT>, bytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, window_attention_kernel<HD, KT>, warps * 32,
                                                       bytes);
}

// the key tiles of the instantiation that holds ws x ws keys
inline int key_tiles(int ws) { return ws <= 4 ? 1 : ws <= 8 ? 4 : 13; }

template <int HD>
cudaError_t dispatch(const void* qkv, void* out, const Geo& G, int warps, float scale, cudaStream_t s) {
  switch (key_tiles(G.ws)) {
    case 1: return launch<HD, 1>(qkv, out, G, warps, scale, s);
    case 4: return launch<HD, 4>(qkv, out, G, warps, scale, s);
    default: return launch<HD, 13>(qkv, out, G, warps, scale, s);
  }
}

template <int HD>
cudaError_t dispatch_occupancy(int ws, int warps, int* blocks) {
  switch (key_tiles(ws)) {
    case 1: return occupancy<HD, 1>(warps, blocks);
    case 4: return occupancy<HD, 4>(warps, blocks);
    default: return occupancy<HD, 13>(warps, blocks);
  }
}

bool valid_warps(int warps) { return warps >= 1 && warps <= MAX_WARPS; }

}  // namespace

// Blocks of the kernel at (hd, ws) with `warps` warps a block that one SM holds.
extern "C" int usm_window_attention_blocks_per_sm(int hd, int ws, int warps, int* blocks) {
  if (ws <= 0 || ws > MAX_WS || !valid_warps(warps)) return cudaErrorInvalidValue;
  if (hd == 96) return dispatch_occupancy<96>(ws, warps, blocks);
  if (hd == 64) return dispatch_occupancy<64>(ws, warps, blocks);
  return cudaErrorInvalidValue;
}

// q_lq: real query rows of each last-strip window (0: no cut); warps:
// window_tiles()'s warps a block.
extern "C" int usm_window_attention_bf16(const void* qkv, void* out, int b, int hp, int wp, int ws, int nh,
                                         int hd, int q_pool, int q_lq, int warps, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ws <= 0 || ws > MAX_WS || hp % ws || wp % ws || (q_pool && ws % 2)) return cudaErrorInvalidValue;
  if (!valid_warps(warps)) return cudaErrorInvalidValue;
  if (b <= 0 || hp <= 0 || wp <= 0 || nh <= 0) return cudaSuccess;
  Geo G;
  G.hp = hp, G.wp = wp, G.ws = ws, G.nh = nh, G.q_pool = q_pool;
  G.wso = q_pool ? ws / 2 : ws;
  G.lq = G.wso * G.wso;
  G.lk = ws * ws;
  G.nwh = hp / ws, G.nww = wp / ws;
  if (q_lq < 0 || q_lq >= G.lq) return cudaErrorInvalidValue;
  G.q_lq = q_lq;
  G.n_wh[0] = b * (G.nwh - (q_lq ? 1 : 0)) * G.nww * nh;
  G.n_wh[1] = q_lq ? b * G.nww * nh : 0;
  G.slabs[0] = cdiv(G.lq, 16);
  G.slabs[1] = cdiv(q_lq, 16);
  for (int r = 0; r < 2; ++r) {
    // a block holds one window-head and `warps` of its slabs
    G.parts[r] = G.slabs[r] ? cdiv(G.slabs[r], warps) : 1;
    G.blocks[r] = G.n_wh[r] * G.parts[r];
  }
  // Hiera-tiny's head width at every stage, and the ViTDet trunks' (384/6, 192/3)
  if (hd == 96) return dispatch<96>(qkv, out, G, warps, scale, s);
  if (hd == 64) return dispatch<64>(qkv, out, G, warps, scale, s);
  return cudaErrorInvalidValue;
}
