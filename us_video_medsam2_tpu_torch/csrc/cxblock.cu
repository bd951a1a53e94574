// The memory encoder's ConvNeXt block in one pass over [B, H, W, C] bf16:
//   out = x + g . bf16(bf16(W2 . h) + b2),  h = bf16(GELU(bf16(bf16(W1 . y) + b1))),
//   y = bf16(LN(bf16(dwconv7x7(x) + dw_b))), rounding where the JAX _xla_ref rounds.
//
// Replaces us_video_medsam2_tpu/kernels/fused_cxblock.py (fused_cxblock, _kernel).
// The TPU kernel holds the whole [32, 32, 256] image in VMEM; one image is 512 KB
// of bf16 against the 227 KB of shared memory a block may use, so here an 8x8
// token tile is the unit, and since a memory encoding has only 16 of them at
// B 1, the hidden axis (4C) and the channels are split too, across the S
// blocks (ranks) of a thread-block cluster (kernels/cxblock.py plan_for(): the
// most splits whose clusters all run at once, one wave; 6 at B 1, where 8
// would be 16 clusters of 8 and the card runs 15). Rank r takes the run
// [share_lo(r), share_lo(r + 1)) of the 32 8-channel groups and the hidden
// chunks [r K / S, (r + 1) K / S) of K = 4C / 64:
//   1. its share's 14x14 halo (zeros outside the image) and taps arrive by
//      cp.async ahead of the first weight chunks; the depthwise 7x7 runs two
//      channels a thread (bf16x2 halo reads, a tap pair one float2), a row of
//      8 outputs accumulated in f32 registers across the 49 taps, + bias,
//      rounded into the tile's [64, C] bf16 slab ys; the rank then stores its
//      share into every peer's ys (16-byte distributed shared-memory stores
//      between two cluster barriers);
//   2. LayerNorm of the whole tile in place (fast variance, f32 statistics),
//      one warp a token;
//   3. the rank's hidden chunks: each chunk's W1 rows [64, C] and W2 columns
//      [C, 64] arrive by cp.async into a ring of NS slots, the next ones in
//      flight while the current one is computed; both products on
//      mma.sync.m16n8k16 (bf16 operands, f32 accumulators in registers). In
//      h = y . W1c^T a warp takes one 16-token row group (its y rows held in
//      registers as A fragments for the whole kernel) and 32 hidden units, and
//      applies the bf16 round, b1, the round, GELU and the round in registers;
//      h goes to a bf16 [64, 64] slab, since in o += h . W2c^T a warp takes all
//      64 rows and 32 output columns (one warp with all C columns of its rows
//      would need 128 accumulator registers a thread), so the f32 partial o
//      [64, C] stays in registers across the rank's chunks;
//   4. the fixed-order combine: rank r owns the output columns of its share.
//      Every rank stores the f32 partial of each owner's columns into slot r
//      of that owner's receive buffer (16-byte distributed shared-memory
//      stores into the halo's region, dead on every rank after barrier 2);
//      after a cluster barrier each owner sums its S slots in the order
//      0..S-1, in f32 (no partial is rounded), then adds b2, applies g and adds
//      x, each rounded as _xla_ref rounds. Two calls give the same bits.
// What bounds it: 4*HW*C*4C flop of the two products (1.07 GFLOP at [1, 32,
// 32, 256], 1.1 us at 989 TFLOP/s) against ~2.6 MB of x, out and weights. At
// B 1 what a call takes is one block's chain: the halo and first weights from
// L2, the conv, two cluster exchanges, LN, its 2-3 chunks, the combine
// (tools/torch_cxblock_phases.py clocks each phase).
#include "warp_mma.cuh"

namespace {

using namespace usm;

constexpr int C = 256;              // the memory encoder's width in every SAM2.1 config
constexpr int TH = 8, TW = 8;       // token tile
constexpr int BM = TH * TW;         // tokens a block
constexpr int KS = 7, PAD = KS / 2;
constexpr int HH = TH + KS - 1, HW = TW + KS - 1;  // halo
constexpr int WARPS = 8, THREADS = WARPS * 32;
constexpr int CG = 2;               // warps across a row group's hidden units in the first product
constexpr int FC = 64;              // hidden units a chunk
constexpr int NS = 3;               // ring slots
constexpr int PW = 64;              // channels of one depthwise pass
constexpr int MAX_SPLITS = 8;       // the portable cluster size
constexpr int C8 = C / 8;           // 8-channel groups: a rank's channels and output columns are a run of them
constexpr int LDY = C + 8;          // bf16 row strides: 16-byte rows, ldmatrix rows in distinct banks
constexpr int LDF = FC + 8;
constexpr int LDH = PW + 8;
static_assert(BM / 16 * CG == WARPS, "warp layout");

// rank r of s: channels and output columns [share_lo(r, s), share_lo(r + 1, s)),
// the 8-channel groups shared out evenly in order; the rank that owns group q
__host__ __device__ constexpr int share_lo(int r, int s) { return r * C8 / s * 8; }
__device__ __forceinline__ int owner_of(int q, int s) { return (q * s + s - 1) / C8; }
__host__ __device__ constexpr int max_share(int s) { return (C8 + s - 1) / s * 8; }

// ys [BM, LDY] | hs [BM, LDF] | ring NS x slot | front: the halo and taps of a
// depthwise pass, then (once every rank of the cluster is past its conv) the
// partials received, S slots of [BM, max_share] f32
struct Layout {
  static constexpr size_t ys = 0;
  static constexpr size_t hs = align128(sizeof(bf16) * BM * LDY);
  static constexpr size_t ring = align128(hs + sizeof(bf16) * BM * LDF);
  static constexpr size_t slot = align128(sizeof(bf16) * (FC * LDY > C * LDF ? FC * LDY : C * LDF));
  static constexpr size_t front = ring + NS * slot;
  static constexpr size_t taps = align128(sizeof(bf16) * HH * HW * LDH);  // from front
  static constexpr size_t front_bytes = taps + sizeof(float) * KS * KS * PW;
  static constexpr size_t recv_bytes(int s) { return sizeof(float) * s * BM * max_share(s); }
  static constexpr size_t bytes(int s) {
    return front + (front_bytes > recv_bytes(s) ? front_bytes : recv_bytes(s));
  }
};
constexpr bool fits(int s) { return s > MAX_SPLITS || (Layout::bytes(s) <= 232448 && fits(s + 1)); }
static_assert(fits(1), "shared memory");

__device__ __forceinline__ float gelu(float h) { return 0.5f * h * (1.f + erff(h * 0.70710678118654752f)); }

__global__ void __launch_bounds__(THREADS, 1) cxblock_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dw_w, const float* __restrict__ dw_b,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ gamma, bf16* __restrict__ out, int h, int w, int f, int splits, float eps) {
  constexpr int HWARP = FC / CG;  // hidden units of a warp in the first product
  constexpr int HN = HWARP / 8;   // its n8 tiles
  constexpr int MG = BM / 16;     // row groups
  constexpr int OW = C / WARPS;   // output columns of a warp in the second product
  constexpr int ON = OW / 8;      // its n8 tiles
  constexpr int KF = FC / 16;     // k-steps of the second product
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem + Layout::ys);
  bf16* hs = reinterpret_cast<bf16*>(smem + Layout::hs);
  bf16* halo = reinterpret_cast<bf16*>(smem + Layout::front);
  float* taps = reinterpret_cast<float*>(smem + Layout::front + Layout::taps);
  float* recv = reinterpret_cast<float*>(smem + Layout::front);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp / CG, cq = warp % CG;
  const int rank = splits > 1 ? (int)cluster_ctarank() : 0;
  const int tile = blockIdx.x / splits;
  const int tiles_w = (w + TW - 1) / TW, tiles_img = (h + TH - 1) / TH * tiles_w;
  const int bi = tile / tiles_img, ti = tile - bi * tiles_img;
  const int ty0 = ti / tiles_w * TH, tx0 = ti % tiles_w * TW;
  const bf16* xb = x + (size_t)bi * h * w * C;
  if (splits > 1) cluster_arrive();  // barrier 1: this block has started

  // the rank's share of the channels (and of the output columns, step 4); its
  // depthwise conv runs over them in passes of PW, each pass's halo (zeros
  // outside the image) and taps ([49][pw]: a channel pair is one float2)
  // arriving by cp.async
  const int s_lo = share_lo(rank, splits), s_hi = share_lo(rank + 1, splits);
  auto load_pass = [&](int c0) {
    const int pw = min(PW, s_hi - c0), ch8 = pw / 8;
    for (int i = tid; i < HH * HW * ch8; i += THREADS) {
      const int p = i / ch8, q = i - p * ch8;
      const int yy = ty0 - PAD + p / HW, xx = tx0 - PAD + p % HW;
      const bool in = yy >= 0 && yy < h && xx >= 0 && xx < w;
      cp_async16(smem_u32(halo + p * LDH + q * 8), in ? xb + ((size_t)yy * w + xx) * C + c0 + q * 8 : xb, in);
    }
    for (int i = tid; i < KS * KS * pw; i += THREADS) {
      const int k = i / pw, c = i - k * pw;
      cp_async4(smem_u32(taps + i), dw_w + (c0 + c) * KS * KS + k, true);
    }
    cp_commit();
  };
  load_pass(s_lo);

  // the rank's hidden chunks [k_lo, k_hi) of f / FC, shared out evenly in order.
  // Ring entry 2j: W1 rows of chunk k_lo + j, [FC, C]; entry 2j + 1: its W2 columns, [C, FC]
  const int chunks = f / FC;
  const int k_lo = rank * chunks / splits;
  const int entries = 2 * ((rank + 1) * chunks / splits - k_lo);
  auto slot = [&](int e) { return reinterpret_cast<bf16*>(smem + Layout::ring + (e % NS) * Layout::slot); };
  auto load_entry = [&](int e) {
    bf16* dst = slot(e);
    const int c0 = (k_lo + e / 2) * FC;
    if ((e & 1) == 0) {
      constexpr int CH = C / 8;
      for (int i = tid; i < FC * CH; i += THREADS) {
        const int r = i / CH, c = i % CH;
        cp_async16(smem_u32(dst + r * LDY + c * 8), w1 + (size_t)(c0 + r) * C + c * 8, true);
      }
    } else {
      constexpr int CH = FC / 8;
      for (int i = tid; i < C * CH; i += THREADS) {
        const int r = i / CH, c = i % CH;
        cp_async16(smem_u32(dst + r * LDF + c * 8), w2 + (size_t)r * f + c0 + c * 8, true);
      }
    }
  };
  for (int e = 0; e < NS - 1; ++e) {
    if (e < entries) load_entry(e);
    cp_commit();
  }
  cp_wait<NS - 1>();  // the first pass has landed
  __syncthreads();

  // 1. depthwise 7x7 + bias, rounded into ys: two channels and a row of 8 outputs a thread
  for (int c0 = s_lo; c0 < s_hi; c0 += PW) {
    const int pw = min(PW, s_hi - c0), pairs = pw / 2;
    for (int it = tid; it < pairs * TH; it += THREADS) {
      const int p = it % pairs, r = it / pairs;  // channels c0 + 2p, +1; output row r
      float2 acc[TW];
#pragma unroll
      for (int j = 0; j < TW; ++j) acc[j] = make_float2(0.f, 0.f);
#pragma unroll
      for (int ki = 0; ki < KS; ++ki) {
        float2 tp[KS], in[HW];
#pragma unroll
        for (int kj = 0; kj < KS; ++kj) tp[kj] = *reinterpret_cast<const float2*>(taps + (ki * KS + kj) * pw + 2 * p);
        const bf16* hrow = halo + (r + ki) * HW * LDH + 2 * p;
#pragma unroll
        for (int j = 0; j < HW; ++j) in[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hrow + j * LDH));
#pragma unroll
        for (int kj = 0; kj < KS; ++kj)
#pragma unroll
          for (int j = 0; j < TW; ++j) {
            acc[j].x = fmaf(in[j + kj].x, tp[kj].x, acc[j].x);
            acc[j].y = fmaf(in[j + kj].y, tp[kj].y, acc[j].y);
          }
      }
      const int c = c0 + 2 * p;
      const float bx = dw_b[c], by = dw_b[c + 1];
#pragma unroll
      for (int j = 0; j < TW; ++j)
        *reinterpret_cast<uint32_t*>(ys + (r * TW + j) * LDY + c) = pack_bf16(acc[j].x + bx, acc[j].y + by);
    }
    __syncthreads();  // ys holds the pass; the halo and taps are free
    if (c0 + PW < s_hi) {
      load_pass(c0 + PW);
      cp_wait<0>();
      __syncthreads();
    }
  }
  if (splits > 1) {
    cluster_wait();  // barrier 1: every peer has started
    const int ch8 = (s_hi - s_lo) / 8;  // this rank's share into every peer's ys
    for (int pp = 1; pp < splits; ++pp) {
      const uint32_t peer = (rank + pp) % splits;
      for (int i = tid; i < BM * ch8; i += THREADS) {
        const bf16* src = ys + (i / ch8) * LDY + s_lo + (i % ch8) * 8;
        st_cluster16(map_rank(smem_u32(src), peer), *reinterpret_cast<const uint4*>(src));
      }
    }
    cluster_arrive();  // barrier 2: the share has reached the peers; this rank's halo is dead
    cluster_wait();
  }

  // 2. LayerNorm in place, fast variance, one warp a token, 8 channels a lane, two tokens at a time
  {
    const int c = lane * 8;
    float lw[8], lb[8];
#pragma unroll
    for (int i = 0; i < 8; i += 4) {
      *reinterpret_cast<float4*>(lw + i) = *reinterpret_cast<const float4*>(ln_w + c + i);
      *reinterpret_cast<float4*>(lb + i) = *reinterpret_cast<const float4*>(ln_b + c + i);
    }
    for (int r0 = warp; r0 < BM; r0 += 2 * WARPS) {
      uint4* yrow[2];
      float v[2][8], s[2], sq[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        yrow[u] = reinterpret_cast<uint4*>(ys + (r0 + u * WARPS) * LDY) + lane;
        const uint4 raw = *yrow[u];
        const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&raw);
        s[u] = sq[u] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 t = __bfloat1622float2(pr[i]);
          v[u][2 * i] = t.x, v[u][2 * i + 1] = t.y;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) s[u] += v[u][i], sq[u] += v[u][i] * v[u][i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
          sq[u] += __shfl_xor_sync(0xffffffffu, sq[u], o);
        }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float mean = s[u] / C;
        const float rstd = rsqrtf(fmaxf(sq[u] / C - mean * mean, 0.f) + eps);
        uint32_t packed[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          packed[i] = pack_bf16((v[u][2 * i] - mean) * rstd * lw[2 * i] + lb[2 * i],
                                (v[u][2 * i + 1] - mean) * rstd * lw[2 * i + 1] + lb[2 * i + 1]);
        *yrow[u] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
    }
  }
  __syncthreads();

  // 3. the rank's chunks: h = GELU(y . W1c^T + b1) into hs (warp: row group rg,
  // hidden units [cq HWARP, +HWARP) of the chunk; its y rows stay in registers as
  // A fragments), then o += h . W2c^T (warp: all BM rows, output columns [warp OW, +OW))
  uint32_t ya[C / 16][4];
  {
    const uint32_t y_addr = smem_u32(ys + rg * 16 * LDY + a_off(lane, LDY));
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) ldsm_x4(y_addr + kk * 32, ya[kk]);
  }
  float o[MG][ON][4];
#pragma unroll
  for (int m = 0; m < MG; ++m)
#pragma unroll
    for (int j = 0; j < ON; ++j) o[m][j][0] = o[m][j][1] = o[m][j][2] = o[m][j][3] = 0.f;
  const uint32_t h_addr = smem_u32(hs + a_off(lane, LDF));
  const int h0 = cq * HWARP;  // the warp's first hidden unit within a chunk
  for (int e = 0; e < entries; ++e) {
    cp_wait<NS - 2>();  // entry e has landed (and every group before it)
    __syncthreads();    // for every warp; every warp is done with entry e - 1's slot (and hs)
    if (e + NS - 1 < entries) load_entry(e + NS - 1);
    cp_commit();
    const uint32_t w_addr = smem_u32(slot(e));
    if ((e & 1) == 0) {
      float hacc[HN][4];
#pragma unroll
      for (int j = 0; j < HN; ++j) hacc[j][0] = hacc[j][1] = hacc[j][2] = hacc[j][3] = 0.f;
      float bias[HN][2];  // bf16(b1) of the warp's columns, loaded ahead of the products
      const float* b1c = b1 + (k_lo + e / 2) * FC + h0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < HN; ++j) bias[j][0] = bf16_round(b1c[j * 8]), bias[j][1] = bf16_round(b1c[j * 8 + 1]);
      const uint32_t b_addr = w_addr + (h0 * LDY + b_off(lane, LDY)) * 2;
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
#pragma unroll
        for (int nj = 0; nj < HN / 2; ++nj) {
          uint32_t b[4];
          ldsm_x4(b_addr + (nj * 16 * LDY + kk * 16) * 2, b);
          mma(hacc[2 * nj], ya[kk], b[0], b[1]);
          mma(hacc[2 * nj + 1], ya[kk], b[2], b[3]);
        }
      }
      // product rounded, + bf16(b1) rounded, exact GELU; the bf16 round of GELU is the pack
      bf16* hrow = hs + (rg * 16 + g) * LDF + h0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < HN; ++j) {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = gelu(bf16_round(bf16_round(hacc[j][q]) + bias[j][q & 1]));
        *reinterpret_cast<uint32_t*>(hrow + j * 8) = pack_bf16(v[0], v[1]);
        *reinterpret_cast<uint32_t*>(hrow + 8 * LDF + j * 8) = pack_bf16(v[2], v[3]);
      }
    } else {
      const uint32_t b_addr = w_addr + (warp * OW * LDF + b_off(lane, LDF)) * 2;
#pragma unroll
      for (int kk = 0; kk < KF; ++kk) {
        uint32_t a[MG][4];
#pragma unroll
        for (int m = 0; m < MG; ++m) ldsm_x4(h_addr + (m * 16 * LDF + kk * 16) * 2, a[m]);
#pragma unroll
        for (int nn = 0; nn < ON / 2; ++nn) {
          uint32_t b[4];
          ldsm_x4(b_addr + (nn * 16 * LDF + kk * 16) * 2, b);
#pragma unroll
          for (int m = 0; m < MG; ++m) {
            mma(o[m][2 * nn], a[m], b[0], b[1]);
            mma(o[m][2 * nn + 1], a[m], b[2], b[3]);
          }
        }
      }
    }
  }
  cp_wait<0>();

  // 4. each f32 partial into slot `rank` of its columns' owner (the front region:
  // every rank of the cluster is past its conv, barrier 2), 16 bytes a store: the
  // lanes of a column pair swap rows so that each holds four columns of one row
  const int ldr = max_share(splits);
  const bool odd = t4 & 1;
#pragma unroll
  for (int m = 0; m < MG; ++m)
#pragma unroll
    for (int j = 0; j < ON; ++j) {
      const float* a = o[m][j];
      const float s0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
      const float s1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
      const float4 v = odd ? make_float4(s0, s1, a[2], a[3]) : make_float4(a[0], a[1], s0, s1);
      const int col = warp * OW + j * 8 + 2 * (t4 & 2);
      const int owner = owner_of(col / 8, splits);
      float* dst = recv + ((size_t)rank * BM + m * 16 + g + (odd ? 8 : 0)) * ldr + col - share_lo(owner, splits);
      if (splits > 1)
        st_cluster16(map_rank(smem_u32(dst), owner), make_uint4(__float_as_uint(v.x), __float_as_uint(v.y),
                                                                 __float_as_uint(v.z), __float_as_uint(v.w)));
      else
        *reinterpret_cast<float4*>(dst) = v;
    }
  if (splits > 1) {
    cluster_arrive();  // barrier 3: every partial has reached its owner
    cluster_wait();
  } else {
    __syncthreads();
  }

  // 5. the owner's columns [s_lo, s_hi): sum of the S slots in order, + b2, g, + x;
  // four columns a thread, the loads of four such items issued together
  const int q4 = (s_hi - s_lo) / 4, items = BM * q4;
  for (int i0 = tid; i0 < items; i0 += 4 * THREADS) {
    uint2 xr[4];
    float4 bb[4], gg[4];
    size_t idx[4];
    bool ok[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * THREADS, row = i / q4, col = s_lo + (i - row * q4) * 4;
      const int yy = ty0 + row / TW, xx = tx0 + row % TW;
      ok[u] = i < items && yy < h && xx < w;
      idx[u] = (((size_t)bi * h + yy) * w + xx) * C + col;
      if (ok[u]) {
        xr[u] = *reinterpret_cast<const uint2*>(x + idx[u]);
        bb[u] = *reinterpret_cast<const float4*>(b2 + col);
        gg[u] = *reinterpret_cast<const float4*>(gamma + col);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (!ok[u]) continue;
      const int i = i0 + u * THREADS, row = i / q4, lc = (i - row * q4) * 4;
      float4 acc = *reinterpret_cast<const float4*>(recv + (size_t)row * ldr + lc);
      for (int s = 1; s < splits; ++s) {
        const float4 p = *reinterpret_cast<const float4*>(recv + ((size_t)s * BM + row) * ldr + lc);
        acc.x += p.x;
        acc.y += p.y;
        acc.z += p.z;
        acc.w += p.w;
      }
      const float a4[4] = {acc.x, acc.y, acc.z, acc.w};
      const float b4[4] = {bb[u].x, bb[u].y, bb[u].z, bb[u].w};
      const float g4[4] = {gg[u].x, gg[u].y, gg[u].z, gg[u].w};
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&xr[u]);
      float r4[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float ov = bf16_round(bf16_round(a4[q]) + bf16_round(b4[q]));
        const float go = bf16_round(bf16_round(g4[q]) * ov);
        r4[q] = (q & 1 ? __high2float(xv[q / 2]) : __low2float(xv[q / 2])) + go;
      }
      *reinterpret_cast<uint2*>(out + idx[u]) = make_uint2(pack_bf16(r4[0], r4[1]), pack_bf16(r4[2], r4[3]));
    }
  }
}

cudaLaunchConfig_t config(int blocks, size_t bytes, cudaStream_t stream, cudaLaunchAttribute* attr, int splits) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool valid_plan(int f, int splits) {
  return splits >= 1 && splits <= MAX_SPLITS && f > 0 && f % FC == 0 && f / FC >= splits;
}

}  // namespace

// The plan's shared memory a block, blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// and clusters of `splits` blocks the card runs at once (cudaOccupancyMaxActiveClusters).
extern "C" int usm_cxblock_occupancy(int splits, int* smem, int* blocks, int* clusters) {
  if (!valid_plan(4 * C, splits)) return cudaErrorInvalidValue;
  const size_t bytes = Layout::bytes(splits);
  *smem = (int)bytes;
  cudaError_t e = allow_smem(cxblock_kernel, bytes);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, cxblock_kernel, THREADS, bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(splits, bytes, 0, attr, splits);
  return cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<const void*>(cxblock_kernel), &cfg);
}

// splits: the plan (kernels/cxblock.py plan_for()): the blocks of a cluster,
// each with its share of the channels, hidden units and output columns.
extern "C" int usm_cxblock_bf16(const void* x, const void* dw_w, const void* dw_b, const void* ln_w,
                                const void* ln_b, const void* w1, const void* b1, const void* w2, const void* b2,
                                const void* gamma, void* out, int b, int h, int w, int c, int f, int splits,
                                float eps, void* stream) {
  if (c != C || !valid_plan(f, splits)) return cudaErrorInvalidValue;
  if (b <= 0 || h <= 0 || w <= 0) return cudaSuccess;
  const size_t bytes = Layout::bytes(splits);
  cudaError_t e = allow_smem(cxblock_kernel, bytes);
  if (e != cudaSuccess) return e;
  const int tiles = b * ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(tiles * splits, bytes, static_cast<cudaStream_t>(stream), attr, splits);
  e = cudaLaunchKernelEx(&cfg, cxblock_kernel, static_cast<const bf16*>(x), static_cast<const float*>(dw_w),
                         static_cast<const float*>(dw_b), static_cast<const float*>(ln_w),
                         static_cast<const float*>(ln_b), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
                         static_cast<const bf16*>(w2), static_cast<const float*>(b2),
                         static_cast<const float*>(gamma), static_cast<bf16*>(out), h, w, f, splits, eps);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
