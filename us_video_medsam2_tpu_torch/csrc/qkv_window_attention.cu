// qkv projection + windowed multi-head attention (optional 2x2 q max-pool) in one pass.
//
// Replaces us_video_medsam2_tpu/kernels/fused_window_attention.py
// (fused_qkv_window_attention, _kernel_qkv). y [B, Hp, Wp, Cin] bf16 (post-norm1
// tokens, zero-padded to whole windows), W [3*nh*HD, Cin] bf16 (the Linear's
// layout), b [3*nh*HD] f32 -> out [B, Hp/ws*wso, Wp/ws*wso, nh*HD] bf16.
//
// One block (8 warps) per (window, head, batch); the qkv map never reaches
// device memory:
//   1. q, k and v of the head, each [ws*ws, HD] = y_win . W[rows]^T: the
//      window's tokens and the head's weight rows stream through shared
//      memory in 96-wide chunks of Cin (16-byte loads; pad rows zero), the
//      products run on bf16 tensor cores (WMMA, f32 accumulation in
//      registers), and the epilogue adds the f32 bias and rounds once, so a
//      zero pad token gets exactly the bias;
//   2. q 2x2 max-pooled inside the window, in shared memory;
//   3. the attention of csrc/window_attention.cu on 4 warps: per 16-row query
//      slab, S = q.k^T in f32, row softmax in f32, P rounded to bf16,
//      O = P.v in f32 rounded once, stored unpartitioned.
// Bound by operations: the projection's 2*ws^2*Cin*3*HD flop per block
// dominate. The window's tokens are read once per head and per q/k/v
// (3*nh times, from L2); the TPU kernel's strip-wide dense is not carried
// over, since a block holds one window.
#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int WARPS = 8;       // projection
constexpr int ATT_WARPS = 4;   // attention slabs (shared memory allows 4 slabs at ws 14)
constexpr int MAX_WS = 14;
constexpr int KC = 96;         // Cin chunk
constexpr int LDX = KC + 8;    // bf16 row stride of the token and weight chunks
constexpr int LDST = 20;       // f32 row stride of a warp's 16x16 staging tile

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }
__host__ __device__ inline size_t smax(size_t a, size_t b) { return a > b ? a : b; }

template <int HD>
struct Layout {
  static constexpr int LDK = HD + 8;  // bf16 q/k/v row stride
  int lk, lkp, lq, wso, lds, ldp;
  size_t ks, vs, qs, scratch;  // scratch: phase 1, then the pooled q, then the slabs
  size_t xs, wsm, stage;       // phase 1, inside scratch
  size_t ss, ps, slab;         // one attention warp's slab, inside scratch
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
    scratch = usm::align128(qs + sizeof(usm::bf16) * lkp * LDK);
    xs = 0;
    wsm = usm::align128(xs + sizeof(usm::bf16) * lkp * LDX);
    stage = usm::align128(wsm + sizeof(usm::bf16) * HD * LDX);
    const size_t phase1 = usm::align128(stage + sizeof(float) * WARPS * 16 * LDST);
    const size_t pooled = usm::align128(sizeof(usm::bf16) * lq * LDK);
    ss = 0;
    ps = usm::align128(sizeof(float) * 16 * lds);
    slab = usm::align128(ps + sizeof(usm::bf16) * 16 * ldp);
    bytes = scratch + smax(smax(phase1, pooled), ATT_WARPS * slab);
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

// dst [lkp, HD] (row stride LDK) = bf16(y_win . W[row0:row0+HD, :]^T + b[row0:row0+HD]).
// Starts and ends without a block barrier of its own after the last product;
// the caller synchronises before reading dst.
template <int HD>
__device__ __forceinline__ void project(const Layout<HD>& L, unsigned char* smem,
                                        const usm::bf16* base, int wp, int ws, int wy, int wx,
                                        int cin, const usm::bf16* __restrict__ wqkv,
                                        const float* __restrict__ bias, int row0,
                                        usm::bf16* dst) {
  constexpr int LDK = Layout<HD>::LDK;
  constexpr int NTC = HD / 16;
  constexpr int MAXF = (round16(MAX_WS * MAX_WS) / 16 * NTC + WARPS - 1) / WARPS;
  constexpr int CH = KC / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = L.lkp / 16 * NTC;
  usm::bf16* xs = reinterpret_cast<usm::bf16*>(smem + L.scratch + L.xs);
  usm::bf16* wsm = reinterpret_cast<usm::bf16*>(smem + L.scratch + L.wsm);
  float* st = reinterpret_cast<float*>(smem + L.scratch + L.stage) + warp * 16 * LDST;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXF];
#pragma unroll
  for (int i = 0; i < MAXF; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int k0 = 0; k0 < cin; k0 += KC) {
    __syncthreads();  // the previous chunk (or the caller's last reads) are done
    for (int i = threadIdx.x; i < L.lkp * CH; i += WARPS * 32) {
      const int t = i / CH, ch = i % CH;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (t < L.lk) {
        const usm::bf16* tok = base + ((size_t)(wy * ws + t / ws) * wp + (wx * ws + t % ws)) * cin;
        v = *reinterpret_cast<const uint4*>(tok + k0 + ch * 8);
      }
      *reinterpret_cast<uint4*>(xs + t * LDX + ch * 8) = v;
    }
    for (int i = threadIdx.x; i < HD * CH; i += WARPS * 32) {
      const int r = i / CH, ch = i % CH;
      *reinterpret_cast<uint4*>(wsm + r * LDX + ch * 8) =
          *reinterpret_cast<const uint4*>(wqkv + (size_t)(row0 + r) * cin + k0 + ch * 8);
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
          wmma::fragment<wmma::matrix_b, 16, 16, 16, usm::bf16, wmma::col_major> bm;
          wmma::load_matrix_sync(a, xs + mt * 16 * LDX + k * 16, LDX);
          wmma::load_matrix_sync(bm, wsm + nt * 16 * LDX + k * 16, LDX);
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
        const int r = i / 16, c = i % 16;
        dst[(mt * 16 + r) * LDK + nt * 16 + c] =
            __float2bfloat16(st[r * LDST + c] + bias[row0 + nt * 16 + c]);
      }
      __syncwarp();
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(WARPS * 32) qkv_window_attention_kernel(
    const usm::bf16* __restrict__ y, const usm::bf16* __restrict__ wqkv,
    const float* __restrict__ bqkv, usm::bf16* __restrict__ out, int hp, int wp, int cin,
    int ws, int nh, int q_pool, float scale) {
  constexpr int LDK = Layout<HD>::LDK;
  constexpr int CH = HD / 8;  // 16-byte chunks per head row
  const Layout<HD> L(ws, q_pool);
  extern __shared__ __align__(128) unsigned char smem[];
  usm::bf16* ks = reinterpret_cast<usm::bf16*>(smem + L.ks);
  usm::bf16* vs = reinterpret_cast<usm::bf16*>(smem + L.vs);
  usm::bf16* qs = reinterpret_cast<usm::bf16*>(smem + L.qs);

  const int nww = wp / ws;
  const int wy = blockIdx.x / nww, wx = blockIdx.x % nww;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const usm::bf16* base = y + (size_t)b * hp * wp * cin;

  // 1. k, v and q of this head
  project<HD>(L, smem, base, wp, ws, wy, wx, cin, wqkv, bqkv, (nh + head) * HD, ks);
  project<HD>(L, smem, base, wp, ws, wy, wx, cin, wqkv, bqkv, (2 * nh + head) * HD, vs);
  project<HD>(L, smem, base, wp, ws, wy, wx, cin, wqkv, bqkv, head * HD, qs);
  __syncthreads();

  // 2. 2x2 max-pool of q inside the window, staged in scratch, back into qs
  if (q_pool) {
    usm::bf16* qp = reinterpret_cast<usm::bf16*>(smem + L.scratch);
    for (int i = threadIdx.x; i < L.lq * CH; i += WARPS * 32) {
      const int qi = i / CH, ch = i % CH;
      const int t = (2 * (qi / L.wso)) * ws + 2 * (qi % L.wso);
      auto row = [&](int r) { return *reinterpret_cast<const uint4*>(qs + r * LDK + ch * 8); };
      const uint4 a = row(t), bq = row(t + 1), c = row(t + ws), d = row(t + ws + 1);
      *reinterpret_cast<uint4*>(qp + qi * LDK + ch * 8) = hmax4(hmax4(a, bq), hmax4(c, d));
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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= ATT_WARPS) return;
  unsigned char* wbase = smem + L.scratch + warp * L.slab;
  float* ss = reinterpret_cast<float*>(wbase + L.ss);
  usm::bf16* ps = reinterpret_cast<usm::bf16*>(wbase + L.ps);
  const int hpo = hp / ws * L.wso, wpo = wp / ws * L.wso;
  const int c_out = nh * HD;

  for (int slab = warp; slab * 16 < L.lq; slab += ATT_WARPS) {
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

    // row softmax in f32; P rounded to bf16, zero on the pad keys
    for (int r = 0; r < 16; ++r) {
      float* srow = ss + r * L.lds;
      float m = -INFINITY;
      for (int c = lane; c < L.lk; c += 32) m = fmaxf(m, srow[c] * scale);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = 0.f;
      for (int c = lane; c < L.lk; c += 32) {
        const float e = expf(srow[c] * scale - m);
        srow[c] = e;
        sum += e;
      }
      sum = usm::warp_sum(sum);
      usm::bf16* prow = ps + r * L.ldp;
      for (int c = lane; c < L.lkp; c += 32)
        prow[c] = __float2bfloat16(c < L.lk ? srow[c] / sum : 0.f);
    }
    __syncwarp();

    // O = P . v  (f32), staged in the S slab
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
        const int oy = wy * L.wso + qi / L.wso, ox = wx * L.wso + qi % L.wso;
        usm::bf16* dst = out + (((size_t)b * hpo + oy) * wpo + ox) * c_out + head * HD + c2;
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(ss[r * L.lds + c2], ss[r * L.lds + c2 + 1]);
      }
    }
    __syncwarp();
  }
}

template <int HD>
cudaError_t launch(const void* y, const void* w, const void* bias, void* out, int b, int hp,
                   int wp, int cin, int ws, int nh, int q_pool, float scale,
                   cudaStream_t stream) {
  const Layout<HD> L(ws, q_pool);
  cudaError_t e = usm::allow_smem(qkv_window_attention_kernel<HD>, L.bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((hp / ws) * (wp / ws), nh, b);
  qkv_window_attention_kernel<HD><<<grid, WARPS * 32, L.bytes, stream>>>(
      static_cast<const usm::bf16*>(y), static_cast<const usm::bf16*>(w),
      static_cast<const float*>(bias), static_cast<usm::bf16*>(out), hp, wp, cin, ws, nh,
      q_pool, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int usm_qkv_window_attention_bf16(const void* y, const void* w, const void* bias,
                                             void* out, int b, int hp, int wp, int cin, int ws,
                                             int nh, int hd, int q_pool, float scale,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ws <= 0 || ws > MAX_WS || hp % ws || wp % ws || (q_pool && ws % 2) || cin <= 0 || cin % KC)
    return cudaErrorInvalidValue;
  if (b <= 0 || hp <= 0 || wp <= 0) return cudaSuccess;
  // Hiera-tiny's head width at every stage, and the ViTDet trunks' (384/6, 192/3)
  if (hd == 96) return launch<96>(y, w, bias, out, b, hp, wp, cin, ws, nh, q_pool, scale, s);
  if (hd == 64) return launch<64>(y, w, bias, out, b, hp, wp, cin, ws, nh, q_pool, scale, s);
  return cudaErrorInvalidValue;
}
