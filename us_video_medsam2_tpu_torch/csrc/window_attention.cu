// Windowed multi-head attention on the dense qkv layout, with optional 2x2 q max-pool.
//
// Replaces us_video_medsam2_tpu/kernels/fused_window_attention.py
// (fused_window_attention, _kernel). qkv [B, Hp, Wp, 3*nh*HD] bf16 ->
// out [B, Hp/ws*wso, Wp/ws*wso, nh*HD] bf16, wso = ws/2 with pooling.
//
// One block (4 warps) per (window, head, batch). The block gathers the
// window's k and v rows from the dense layout into shared memory with 16-byte
// loads (the window partition costs no device-memory pass). Each warp then
// takes 16-row query slabs: it loads (and max-pools) its q rows, computes
// S = q.k^T on bf16 tensor cores (WMMA, f32 accumulation) into shared memory,
// a row softmax in f32 with P rounded to bf16, and O = P.v, written straight
// to the unpartitioned output. At ws = 14 the 196 keys pad to 208 and the f32
// S slab of one warp is 16 x 208; the full 196-row S would not fit beside
// q, k and v, which is why rows go in slabs.
#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int WARPS = 4;
constexpr int MAX_WS = 14;

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

template <int HD>
struct Layout {
  static constexpr int LDK = HD + 8;  // bf16 k/v/q row stride
  int lk, lkp, lq, wso, lds, ldp;
  size_t ks, vs, warp0, warp_bytes, qs, ss, ps, bytes;
  __host__ __device__ Layout(int ws, int q_pool) {
    lk = ws * ws;
    lkp = round16(lk);
    wso = q_pool ? ws / 2 : ws;
    lq = wso * wso;
    lds = (lkp > HD ? lkp : HD) + 4;  // f32 S slab stride; reused for the O slab
    ldp = lkp + 8;                     // bf16 P slab stride
    ks = 0;
    vs = usm::align128(ks + sizeof(usm::bf16) * lkp * LDK);
    warp0 = usm::align128(vs + sizeof(usm::bf16) * lkp * LDK);
    qs = 0;
    ss = usm::align128(qs + sizeof(usm::bf16) * 16 * LDK);
    ps = usm::align128(ss + sizeof(float) * 16 * lds);
    warp_bytes = usm::align128(ps + sizeof(usm::bf16) * 16 * ldp);
    bytes = warp0 + WARPS * warp_bytes;
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

template <int HD>
__global__ void __launch_bounds__(WARPS * 32) window_attention_kernel(
    const usm::bf16* __restrict__ qkv, usm::bf16* __restrict__ out, int hp, int wp, int ws,
    int nh, int q_pool, float scale) {
  using namespace nvcuda;
  constexpr int LDK = Layout<HD>::LDK;
  constexpr int CH = HD / 8;  // 16-byte chunks per head row
  const Layout<HD> L(ws, q_pool);
  extern __shared__ __align__(128) unsigned char smem[];
  usm::bf16* ks = reinterpret_cast<usm::bf16*>(smem + L.ks);
  usm::bf16* vs = reinterpret_cast<usm::bf16*>(smem + L.vs);

  const int nww = wp / ws;
  const int wy = blockIdx.x / nww, wx = blockIdx.x % nww;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int c_all = 3 * nh * HD;
  const usm::bf16* base = qkv + (size_t)b * hp * wp * c_all;

  auto token = [&](int r, int c) -> const usm::bf16* {
    return base + ((size_t)(wy * ws + r) * wp + (wx * ws + c)) * c_all;
  };

  // k and v of the window -> shared memory; pad rows are zero
  for (int i = threadIdx.x; i < L.lkp * CH; i += WARPS * 32) {
    const int t = i / CH, ch = i % CH;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (t < L.lk) {
      const usm::bf16* tok = token(t / ws, t % ws);
      kv = *reinterpret_cast<const uint4*>(tok + (nh + head) * HD + ch * 8);
      vv = *reinterpret_cast<const uint4*>(tok + (2 * nh + head) * HD + ch * 8);
    }
    *reinterpret_cast<uint4*>(ks + t * LDK + ch * 8) = kv;
    *reinterpret_cast<uint4*>(vs + t * LDK + ch * 8) = vv;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* wbase = smem + L.warp0 + warp * L.warp_bytes;
  usm::bf16* qs = reinterpret_cast<usm::bf16*>(wbase + L.qs);
  float* ss = reinterpret_cast<float*>(wbase + L.ss);
  usm::bf16* ps = reinterpret_cast<usm::bf16*>(wbase + L.ps);
  const int hpo = hp / ws * L.wso, wpo = wp / ws * L.wso;
  const int c_out = nh * HD;

  for (int slab = warp; slab * 16 < L.lq; slab += WARPS) {
    const int q0 = slab * 16;
    // q rows of this slab (2x2 max-pooled inside the window when pooling)
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, ch = i % CH;
      const int qi = q0 + r;
      uint4 qv = make_uint4(0, 0, 0, 0);
      if (qi < L.lq) {
        const int pr = qi / L.wso, pc = qi % L.wso;
        const int off = head * HD + ch * 8;
        if (q_pool) {
          const uint4 a = *reinterpret_cast<const uint4*>(token(2 * pr, 2 * pc) + off);
          const uint4 bq = *reinterpret_cast<const uint4*>(token(2 * pr, 2 * pc + 1) + off);
          const uint4 c = *reinterpret_cast<const uint4*>(token(2 * pr + 1, 2 * pc) + off);
          const uint4 d = *reinterpret_cast<const uint4*>(token(2 * pr + 1, 2 * pc + 1) + off);
          qv = hmax4(hmax4(a, bq), hmax4(c, d));
        } else {
          qv = *reinterpret_cast<const uint4*>(token(pr, pc) + off);
        }
      }
      *reinterpret_cast<uint4*>(qs + r * LDK + ch * 8) = qv;
    }
    __syncwarp();

    // S = q . k^T  (f32)
    for (int j = 0; j < L.lkp / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, usm::bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, usm::bf16, wmma::col_major> bm;
        wmma::load_matrix_sync(a, qs + k * 16, LDK);
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
cudaError_t launch(const void* qkv, void* out, int b, int hp, int wp, int ws, int nh,
                   int q_pool, float scale, cudaStream_t stream) {
  const Layout<HD> L(ws, q_pool);
  cudaError_t e = usm::allow_smem(window_attention_kernel<HD>, L.bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((hp / ws) * (wp / ws), nh, b);
  window_attention_kernel<HD><<<grid, WARPS * 32, L.bytes, stream>>>(
      static_cast<const usm::bf16*>(qkv), static_cast<usm::bf16*>(out), hp, wp, ws, nh,
      q_pool, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int usm_window_attention_bf16(const void* qkv, void* out, int b, int hp, int wp,
                                         int ws, int nh, int hd, int q_pool, float scale,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ws <= 0 || ws > MAX_WS || hp % ws || wp % ws || (q_pool && ws % 2))
    return cudaErrorInvalidValue;
  if (b <= 0 || hp <= 0 || wp <= 0) return cudaSuccess;
  // Hiera-tiny's head width at every stage, and the ViTDet trunks' (384/6, 192/3)
  if (hd == 96) return launch<96>(qkv, out, b, hp, wp, ws, nh, q_pool, scale, s);
  if (hd == 64) return launch<64>(qkv, out, b, hp, wp, ws, nh, q_pool, scale, s);
  return cudaErrorInvalidValue;
}
