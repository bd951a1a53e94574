// The attention half of a Hiera block in two kernels: LayerNorm, per-head q/k/v
// projection, windowed attention (optional 2x2 q max-pool) and the output
// projection summed over heads.
//
// Replaces us_video_medsam2_tpu/kernels/rejected/window_attention_v1.py
// (window_attention, _run, _kernel), unwired as there. x [B, Hp, Wp, C] bf16
// (already padded to whole windows), gamma/beta [C] f32, wq/wk/wv [H, C, 96]
// bf16, bq/bk/bv [H, 96] f32, wo [H*96, Co] bf16, bo [Co] f32 ->
// out [B, Hp/ws*wso, Wp/ws*wso, Co] bf16, wso = ws/2 with pooling.
//
// The TPU kernel walks one row strip of windows per grid step and sums the
// heads into an f32 VMEM accumulator. A window's f32 [wso^2, Co] accumulator
// alone is 301 KB at ws 14 and Co 384, above a block's 227 KB of shared
// memory, so the work is cut in two:
//  1. window_attention_v1_kernel, one block (8 warps) per (window, head,
//     batch): with ln_inside, the f32 mean and 1/std of each of the window's
//     tokens (pad tokens included: a zero token becomes beta, as in the
//     reference); then k, v and q of the head, each [ws^2, 96] = y . W + b,
//     with the tokens (normalised and rounded to bf16 on the way in) and the
//     head's weight rows streaming through shared memory in 48-wide chunks of
//     C, products on bf16 tensor cores (WMMA, f32 accumulation), the f32 bias
//     added before the one rounding; q 2x2 max-pooled inside the window; then
//     per 16-row query slab S = q.k^T in f32, the row softmax in f32 with P
//     normalised before its bf16 rounding, and o = P.v rounded to bf16, stored
//     unpartitioned into o [B, Hpo, Wpo, H*96]. As many warps attend as there
//     are slabs in the shared memory left beside q, k and v (2 at ws 16, 4 at
//     ws 14, 8 at ws <= 8);
//  2. out_proj_kernel, one block per (64 rows, 96 output channels):
//     out = o . wo + bo, summed over every head and its 96 channels in f32 and
//     rounded once, as _xla_ref's einsum("bhqd,hdc->bqc").
// Bound by operations (the projections and the attention products); o makes
// one round trip through device memory, mostly in L2.
#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int WARPS = 8;
constexpr int MAX_WS = 16;
constexpr int HD = 96;
constexpr int NTC = HD / 16;   // 16-wide column tiles of a head
constexpr int KC = 48;         // C chunk of the projection
constexpr int LDX = KC + 8;    // bf16 row stride of the token chunk
constexpr int LDW = HD + 8;    // bf16 row stride of the weight chunk [KC, HD]
constexpr int LDK = HD + 8;    // bf16 q/k/v row stride
constexpr int LDST = 20;       // f32 row stride of a warp's 16x16 staging tile
constexpr size_t SMEM_LIMIT = 232448;

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }
__host__ __device__ inline size_t smax(size_t a, size_t b) { return a > b ? a : b; }

struct Layout {
  int lk, lkp, lq, wso, lds, ldp, att_warps;
  size_t ks, vs, qs, stats, scratch;  // scratch: phase 1, then the pooled q, then the slabs
  size_t xs, wsm, stage;              // phase 1, inside scratch
  size_t ss, ps, slab;                // one attention warp's slab, inside scratch
  size_t bytes;
  __host__ __device__ Layout(int ws, int q_pool) {
    lk = ws * ws;
    lkp = round16(lk);
    wso = q_pool ? ws / 2 : ws;
    lq = wso * wso;
    lds = (lkp > HD ? lkp : HD) + 4;  // f32 S slab stride; reused for the O slab
    ldp = lkp + 8;                     // bf16 P slab stride
    ks = 0;
    vs = usm::align128(ks + sizeof(usm::bf16) * lkp * LDK);
    qs = usm::align128(vs + sizeof(usm::bf16) * lkp * LDK);
    stats = usm::align128(qs + sizeof(usm::bf16) * lkp * LDK);  // mean, then 1/std
    scratch = usm::align128(stats + sizeof(float) * 2 * lkp);
    xs = 0;
    wsm = usm::align128(xs + sizeof(usm::bf16) * lkp * LDX);
    stage = usm::align128(wsm + sizeof(usm::bf16) * KC * LDW);
    const size_t phase1 = usm::align128(stage + sizeof(float) * WARPS * 16 * LDST);
    const size_t pooled = usm::align128(sizeof(usm::bf16) * lq * LDK);
    ss = 0;
    ps = usm::align128(sizeof(float) * 16 * lds);
    slab = usm::align128(ps + sizeof(usm::bf16) * 16 * ldp);
    const size_t room = SMEM_LIMIT > scratch ? SMEM_LIMIT - scratch : 0;
    att_warps = (int)(room / slab) < WARPS ? (int)(room / slab) : WARPS;
    bytes = scratch + smax(smax(phase1, pooled), att_warps * slab);
  }
};

__device__ __forceinline__ uint4 hmax4(uint4 a, uint4 b) {
  uint4 r;
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) pr[i] = __hmax2(pa[i], pb[i]);
  return r;
}

// the window of one block: its batch's map and its place in the window grid
struct Window {
  const usm::bf16* base;
  int wp, c, ws, wy, wx;
  // token t (row-major inside the window) of the window
  __device__ __forceinline__ const usm::bf16* token(int t) const {
    return base + ((size_t)(wy * ws + t / ws) * wp + (wx * ws + t % ws)) * c;
  }
};

// dst [lkp, HD] (row stride LDK) = bf16(y_win . w + bias), y_win the window's
// tokens, layer-normalised when `ln`. w [C, HD] and bias [HD] are the head's.
// Ends without a block barrier after the last product; the caller
// synchronises before reading dst.
__device__ __forceinline__ void project(const Layout& L, unsigned char* smem, const Window& win,
                                        bool ln, const float* __restrict__ gamma,
                                        const float* __restrict__ beta,
                                        const usm::bf16* __restrict__ w,
                                        const float* __restrict__ bias, usm::bf16* dst) {
  constexpr int MAXF = (round16(MAX_WS * MAX_WS) / 16 * NTC + WARPS - 1) / WARPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = L.lkp / 16 * NTC;
  usm::bf16* xs = reinterpret_cast<usm::bf16*>(smem + L.scratch + L.xs);
  usm::bf16* wsm = reinterpret_cast<usm::bf16*>(smem + L.scratch + L.wsm);
  float* st = reinterpret_cast<float*>(smem + L.scratch + L.stage) + warp * 16 * LDST;
  const float* mean = reinterpret_cast<const float*>(smem + L.stats);
  const float* rstd = mean + L.lkp;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXF];
#pragma unroll
  for (int i = 0; i < MAXF; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int k0 = 0; k0 < win.c; k0 += KC) {
    __syncthreads();  // the previous chunk (or the caller's last reads) are done
    for (int i = threadIdx.x; i < L.lkp * (KC / 8); i += WARPS * 32) {
      const int t = i / (KC / 8), ch = i % (KC / 8);
      uint4 val = make_uint4(0, 0, 0, 0);
      if (t < L.lk) {
        val = *reinterpret_cast<const uint4*>(win.token(t) + k0 + ch * 8);
        if (ln) {
          __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&val);
          const int c0 = k0 + ch * 8;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(p[e]);
            const float a = (f.x - mean[t]) * rstd[t] * gamma[c0 + 2 * e] + beta[c0 + 2 * e];
            const float b = (f.y - mean[t]) * rstd[t] * gamma[c0 + 2 * e + 1] + beta[c0 + 2 * e + 1];
            p[e] = __floats2bfloat162_rn(a, b);
          }
        }
      }
      *reinterpret_cast<uint4*>(xs + t * LDX + ch * 8) = val;
    }
    for (int i = threadIdx.x; i < KC * (HD / 8); i += WARPS * 32) {
      const int r = i / (HD / 8), ch = i % (HD / 8);
      *reinterpret_cast<uint4*>(wsm + r * LDW + ch * 8) =
          *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * HD + ch * 8);
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < MAXF; ++f) {
      const int t = warp + WARPS * f;
      if (t < tiles) {
        const int mt = t / NTC, nt = t % NTC;
#pragma unroll
        for (int k = 0; k < KC / 16; ++k) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, usm::bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, usm::bf16, wmma::row_major> bm;
          wmma::load_matrix_sync(a, xs + mt * 16 * LDX + k * 16, LDX);
          wmma::load_matrix_sync(bm, wsm + k * 16 * LDW + nt * 16, LDW);
          wmma::mma_sync(acc[f], a, bm, acc[f]);
        }
      }
    }
  }

  // epilogue: f32 bias, one rounding
#pragma unroll
  for (int f = 0; f < MAXF; ++f) {
    const int t = warp + WARPS * f;
    if (t < tiles) {
      const int mt = t / NTC, nt = t % NTC;
      wmma::store_matrix_sync(st, acc[f], LDST, wmma::mem_row_major);
      __syncwarp();
      for (int i = lane; i < 256; i += 32) {
        const int r = i / 16, cc = i % 16;
        dst[(mt * 16 + r) * LDK + nt * 16 + cc] = __float2bfloat16(st[r * LDST + cc] + bias[nt * 16 + cc]);
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32) window_attention_v1_kernel(
    const usm::bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const usm::bf16* __restrict__ wq,
    const usm::bf16* __restrict__ wk, const usm::bf16* __restrict__ wv,
    const float* __restrict__ bq, const float* __restrict__ bk, const float* __restrict__ bv,
    usm::bf16* __restrict__ o, int hp, int wp, int c, int ws, int nh, int q_pool, int ln_inside,
    float eps, float scale) {
  constexpr int CH = HD / 8;  // 16-byte chunks per head row
  const Layout L(ws, q_pool);
  extern __shared__ __align__(128) unsigned char smem[];
  usm::bf16* ks = reinterpret_cast<usm::bf16*>(smem + L.ks);
  usm::bf16* vs = reinterpret_cast<usm::bf16*>(smem + L.vs);
  usm::bf16* qs = reinterpret_cast<usm::bf16*>(smem + L.qs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int nww = wp / ws;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const Window win{x + (size_t)b * hp * wp * c, wp, c, ws, (int)blockIdx.x / nww, (int)blockIdx.x % nww};

  // 0. LayerNorm statistics of the window's tokens (two passes, f32)
  if (ln_inside) {
    float* mean = reinterpret_cast<float*>(smem + L.stats);
    float* rstd = mean + L.lkp;
    for (int t = warp; t < L.lk; t += WARPS) {
      const __nv_bfloat162* tok = reinterpret_cast<const __nv_bfloat162*>(win.token(t));
      float s = 0.f;
      for (int i = lane; i < c / 2; i += 32) {
        const float2 f = __bfloat1622float2(tok[i]);
        s += f.x + f.y;
      }
      const float mu = usm::warp_sum(s) / c;
      float var = 0.f;
      for (int i = lane; i < c / 2; i += 32) {
        const float2 f = __bfloat1622float2(tok[i]);
        var += (f.x - mu) * (f.x - mu) + (f.y - mu) * (f.y - mu);
      }
      var = usm::warp_sum(var) / c;
      if (lane == 0) {
        mean[t] = mu;
        rstd[t] = rsqrtf(var + eps);
      }
    }
  }

  // 1. k, v and q of this head (project() opens with a block barrier)
  const size_t wofs = (size_t)head * c * HD;
  project(L, smem, win, ln_inside, gamma, beta, wk + wofs, bk + head * HD, ks);
  project(L, smem, win, ln_inside, gamma, beta, wv + wofs, bv + head * HD, vs);
  project(L, smem, win, ln_inside, gamma, beta, wq + wofs, bq + head * HD, qs);
  __syncthreads();

  // 2. 2x2 max-pool of q inside the window, staged in scratch, back into qs
  if (q_pool) {
    usm::bf16* qp = reinterpret_cast<usm::bf16*>(smem + L.scratch);
    for (int i = threadIdx.x; i < L.lq * CH; i += WARPS * 32) {
      const int qi = i / CH, ch = i % CH;
      const int t = (2 * (qi / L.wso)) * ws + 2 * (qi % L.wso);
      auto row = [&](int r) { return *reinterpret_cast<const uint4*>(qs + r * LDK + ch * 8); };
      const uint4 a = row(t), bb = row(t + 1), cc = row(t + ws), d = row(t + ws + 1);
      *reinterpret_cast<uint4*>(qp + qi * LDK + ch * 8) = hmax4(hmax4(a, bb), hmax4(cc, d));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < L.lq * CH; i += WARPS * 32) {
      const int qi = i / CH, ch = i % CH;
      *reinterpret_cast<uint4*>(qs + qi * LDK + ch * 8) =
          *reinterpret_cast<const uint4*>(qp + qi * LDK + ch * 8);
    }
    __syncthreads();
  }

  // 3. attention, one 16-row query slab at a time per attention warp
  if (warp >= L.att_warps) return;
  unsigned char* wbase = smem + L.scratch + warp * L.slab;
  float* ss = reinterpret_cast<float*>(wbase + L.ss);
  usm::bf16* ps = reinterpret_cast<usm::bf16*>(wbase + L.ps);
  const int hpo = hp / ws * L.wso, wpo = wp / ws * L.wso;
  const int c_out = nh * HD;

  for (int slab = warp; slab * 16 < L.lq; slab += L.att_warps) {
    const int q0 = slab * 16;
    // S = q . k^T  (f32)
    for (int j = 0; j < L.lkp / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, usm::bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, usm::bf16, wmma::col_major> bm;
        wmma::load_matrix_sync(a, qs + q0 * LDK + k * 16, LDK);
        wmma::load_matrix_sync(bm, ks + j * 16 * LDK + k * 16, LDK);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(ss + j * 16, acc, L.lds, wmma::mem_row_major);
    }
    __syncwarp();

    // row softmax in f32; P normalised, then rounded to bf16; zero on the pad keys
    for (int r = 0; r < 16; ++r) {
      float* srow = ss + r * L.lds;
      float m = -INFINITY;
      for (int cc = lane; cc < L.lk; cc += 32) m = fmaxf(m, srow[cc] * scale);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float sum = 0.f;
      for (int cc = lane; cc < L.lk; cc += 32) {
        const float e = expf(srow[cc] * scale - m);
        srow[cc] = e;
        sum += e;
      }
      sum = usm::warp_sum(sum);
      usm::bf16* prow = ps + r * L.ldp;
      for (int cc = lane; cc < L.lkp; cc += 32)
        prow[cc] = __float2bfloat16(cc < L.lk ? srow[cc] / sum : 0.f);
    }
    __syncwarp();

    // o = P . v  (f32), staged in the S slab
    for (int j = 0; j < HD / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < L.lkp / 16; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, usm::bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, usm::bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, ps + k * 16, L.ldp);
        wmma::load_matrix_sync(bm, vs + k * 16 * LDK + j * 16, LDK);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(ss + j * 16, acc, L.lds, wmma::mem_row_major);
    }
    __syncwarp();

    // unpartitioned store, one bf16 rounding
    for (int i = lane; i < 16 * (HD / 2); i += 32) {
      const int r = i / (HD / 2), c2 = (i % (HD / 2)) * 2;
      const int qi = q0 + r;
      if (qi < L.lq) {
        const int oy = win.wy * L.wso + qi / L.wso, ox = win.wx * L.wso + qi % L.wso;
        usm::bf16* dst = o + (((size_t)b * hpo + oy) * wpo + ox) * c_out + head * HD + c2;
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(ss[r * L.lds + c2], ss[r * L.lds + c2 + 1]);
      }
    }
    __syncwarp();
  }
}

constexpr int PM = 64, PN = 96, PK = 96;  // out-projection tile; 8 warps hold 4 x 6 WMMA tiles
constexpr int LDA = PK + 8, LDB = PN + 8;

// out [m, co] = bf16(o [m, kd] . wo [kd, co] + bo), f32 accumulation
__global__ void __launch_bounds__(WARPS * 32) out_proj_kernel(
    const usm::bf16* __restrict__ o, const usm::bf16* __restrict__ wo,
    const float* __restrict__ bo, usm::bf16* __restrict__ out, int m, int kd, int co) {
  __shared__ __align__(128) unsigned char sm[sizeof(usm::bf16) * (PM * LDA + PK * LDB) +
                                             sizeof(float) * WARPS * 16 * LDST];
  usm::bf16* as = reinterpret_cast<usm::bf16*>(sm);
  usm::bf16* bs = as + PM * LDA;
  float* st = reinterpret_cast<float*>(bs + PK * LDB);
  constexpr int F = PM / 16 * (PN / 16) / WARPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * PM, n0 = blockIdx.y * PN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[F];
#pragma unroll
  for (int i = 0; i < F; ++i) wmma::fill_fragment(acc[i], 0.f);
  for (int k0 = 0; k0 < kd; k0 += PK) {
    __syncthreads();
    for (int i = threadIdx.x; i < PM * (PK / 8); i += WARPS * 32) {
      const int r = i / (PK / 8), ch = i % (PK / 8);
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m0 + r < m) val = *reinterpret_cast<const uint4*>(o + (size_t)(m0 + r) * kd + k0 + ch * 8);
      *reinterpret_cast<uint4*>(as + r * LDA + ch * 8) = val;
    }
    for (int i = threadIdx.x; i < PK * (PN / 8); i += WARPS * 32) {
      const int r = i / (PN / 8), ch = i % (PN / 8);
      *reinterpret_cast<uint4*>(bs + r * LDB + ch * 8) =
          *reinterpret_cast<const uint4*>(wo + (size_t)(k0 + r) * co + n0 + ch * 8);
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int t = warp + WARPS * f;
      const int mt = t / (PN / 16), nt = t % (PN / 16);
#pragma unroll
      for (int k = 0; k < PK / 16; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, usm::bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, usm::bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, as + mt * 16 * LDA + k * 16, LDA);
        wmma::load_matrix_sync(bm, bs + k * 16 * LDB + nt * 16, LDB);
        wmma::mma_sync(acc[f], a, bm, acc[f]);
      }
    }
  }
  float* stw = st + warp * 16 * LDST;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int t = warp + WARPS * f;
    const int mt = t / (PN / 16), nt = t % (PN / 16);
    wmma::store_matrix_sync(stw, acc[f], LDST, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 128; i += 32) {
      const int r = i / 8, c2 = (i % 8) * 2;
      const int row = m0 + mt * 16 + r, col = n0 + nt * 16 + c2;
      if (row < m)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * co + col) =
            __floats2bfloat162_rn(stw[r * LDST + c2] + bo[col], stw[r * LDST + c2 + 1] + bo[col + 1]);
    }
    __syncwarp();
  }
}

}  // namespace

// o is scratch [B, Hpo, Wpo, nh*96] bf16 (the heads' outputs before the projection).
extern "C" int usm_window_attention_v1_bf16(
    const void* x, const void* gamma, const void* beta, const void* wq, const void* wk,
    const void* wv, const void* bq, const void* bk, const void* bv, const void* wo,
    const void* bo, void* o, void* out, int b, int hp, int wp, int c, int nh, int hd, int co,
    int ws, int q_pool, int ln_inside, float eps, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ws <= 0 || ws > MAX_WS || hp % ws || wp % ws || (q_pool && ws % 2) || c <= 0 || c % KC ||
      nh <= 0 || co <= 0 || co % PN)
    return cudaErrorInvalidValue;
  if (hd != HD) return cudaErrorInvalidValue;  // Hiera-tiny's head width at every stage
  if (b <= 0 || hp <= 0 || wp <= 0) return cudaSuccess;
  const Layout L(ws, q_pool);
  if (L.att_warps < 1 || L.bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t e = usm::allow_smem(window_attention_v1_kernel, L.bytes);
  if (e != cudaSuccess) return e;
  window_attention_v1_kernel<<<dim3((hp / ws) * (wp / ws), nh, b), WARPS * 32, L.bytes, s>>>(
      static_cast<const usm::bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const usm::bf16*>(wq),
      static_cast<const usm::bf16*>(wk), static_cast<const usm::bf16*>(wv),
      static_cast<const float*>(bq), static_cast<const float*>(bk), static_cast<const float*>(bv),
      static_cast<usm::bf16*>(o), hp, wp, c, ws, nh, q_pool, ln_inside, eps, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int wso = q_pool ? ws / 2 : ws;
  const int m = b * (hp / ws * wso) * (wp / ws * wso);
  out_proj_kernel<<<dim3((m + PM - 1) / PM, co / PN), WARPS * 32, 0, s>>>(
      static_cast<const usm::bf16*>(o), static_cast<const usm::bf16*>(wo),
      static_cast<const float*>(bo), static_cast<usm::bf16*>(out), m, nh * HD, co);
  return cudaGetLastError();
}
