// Flash attention with a per-key boolean mask: out = softmax(q.k^T * scale, masked) . v.
//
// Replaces us_video_medsam2_tpu/kernels/flash_attention.py (flash_attention,
// flash_attention_masked, _flash_kernel). q [BH, Lq, D], k/v [BH, Lk, D] bf16,
// mask [B, Lk] uint8 (1 = attend, may be null), out [BH, Lq, D] bf16.
//
// Bound by operations at the memory-attention shapes. One block (4 warps) per
// 64-row query tile: the Q tile stays in shared memory, 64-key K and V tiles
// stream through shared memory, each warp owns 16 query rows. Per key tile:
// S = Q.K^T on bf16 tensor cores (WMMA, f32 accumulation), then the online
// softmax in f32 (running max m and sum l per row; masked keys score -1e30 as
// in the JAX kernel, keys past Lk score -inf and never count), P rounded to
// bf16, O scaled by exp(m_old - m_new) and O += P.V, with O kept in f32 in
// shared memory (a WMMA fragment's rows cannot be rescaled in registers).
// Finally out = O / max(l, 1e-30). The score matrix never reaches device
// memory. At batch 1 the grid is Lq/64 blocks: 16 for 1024 queries.
#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int WARPS = 4;
constexpr int BQ = 16 * WARPS;  // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr float MASKED = -1e30f;

template <int D>
struct Layout {
  static constexpr int LDQ = D + 8;   // bf16 q/k/v row stride
  static constexpr int LDS = BK + 4;  // f32 score slab stride
  static constexpr int LDP = BK + 8;  // bf16 P slab stride
  static constexpr int LDO = D + 4;   // f32 O slab stride
  static constexpr size_t qs = 0;
  static constexpr size_t ks = usm::align128(qs + sizeof(usm::bf16) * BQ * LDQ);
  static constexpr size_t vs = usm::align128(ks + sizeof(usm::bf16) * BK * LDQ);
  static constexpr size_t warp0 = usm::align128(vs + sizeof(usm::bf16) * BK * LDQ);
  static constexpr size_t ss = 0;
  static constexpr size_t ps = usm::align128(ss + sizeof(float) * 16 * LDS);
  static constexpr size_t os = usm::align128(ps + sizeof(usm::bf16) * 16 * LDP);
  static constexpr size_t stats = usm::align128(os + sizeof(float) * 16 * LDO);
  static constexpr size_t warp_bytes = usm::align128(stats + sizeof(float) * 3 * 16);
  static constexpr size_t bytes = warp0 + WARPS * warp_bytes;
};

template <int D>
__device__ __forceinline__ void load_tile(usm::bf16* dst, const usm::bf16* src, int row0,
                                          int rows, int valid) {
  constexpr int CH = D / 8;
  constexpr int LDQ = Layout<D>::LDQ;
  for (int i = threadIdx.x; i < rows * CH; i += WARPS * 32) {
    const int r = i / CH, ch = i % CH;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < valid) v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + ch * 8);
    *reinterpret_cast<uint4*>(dst + r * LDQ + ch * 8) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32) flash_attention_kernel(
    const usm::bf16* __restrict__ q, const usm::bf16* __restrict__ k,
    const usm::bf16* __restrict__ v, const unsigned char* __restrict__ mask,
    usm::bf16* __restrict__ out, int h, int lq, int lk, float scale) {
  using L = Layout<D>;
  constexpr int LDQ = L::LDQ;
  extern __shared__ __align__(128) unsigned char smem[];
  usm::bf16* qs = reinterpret_cast<usm::bf16*>(smem + L::qs);
  usm::bf16* ks = reinterpret_cast<usm::bf16*>(smem + L::ks);
  usm::bf16* vs = reinterpret_cast<usm::bf16*>(smem + L::vs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* wbase = smem + L::warp0 + warp * L::warp_bytes;
  float* ss = reinterpret_cast<float*>(wbase + L::ss);
  usm::bf16* ps = reinterpret_cast<usm::bf16*>(wbase + L::ps);
  float* os = reinterpret_cast<float*>(wbase + L::os);
  float* m_run = reinterpret_cast<float*>(wbase + L::stats);
  float* l_run = m_run + 16;
  float* alpha = m_run + 32;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t head_off_q = (size_t)bh * lq * D;
  const size_t head_off_k = (size_t)bh * lk * D;
  const unsigned char* mrow = mask ? mask + (size_t)(bh / h) * lk : nullptr;

  load_tile<D>(qs, q + head_off_q, q0, BQ, lq);
  for (int i = lane; i < 16 * L::LDO; i += 32) os[i] = 0.f;
  if (lane < 16) {
    m_run[lane] = -INFINITY;
    l_run[lane] = 0.f;
  }

  const usm::bf16* qw = qs + warp * 16 * LDQ;
  // lanes 2r and 2r+1 share query row r of this warp, 32 keys each
  const int row = lane >> 1, half = lane & 1;

  for (int k0 = 0; k0 < lk; k0 += BK) {
    __syncthreads();  // previous tile fully consumed (and Q loaded on the first pass)
    load_tile<D>(ks, k + head_off_k, k0, BK, lk);
    load_tile<D>(vs, v + head_off_k, k0, BK, lk);
    __syncthreads();

    // S = Q_w . K^T  [16, 64]
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll 4
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, usm::bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, usm::bf16, wmma::col_major> bm;
        wmma::load_matrix_sync(a, qw + kk * 16, LDQ);
        wmma::load_matrix_sync(bm, ks + j * 16 * LDQ + kk * 16, LDQ);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(ss + j * 16, acc, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax for row `row`, keys [half*32, half*32+32) of the tile
    {
      float* srow = ss + row * L::LDS + half * 32;
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
      usm::bf16* prow = ps + row * L::LDP + half * 32;
      for (int c = 0; c < 32; ++c) {
        const float p = expf(srow[c] - m_new);
        psum += p;
        prow[c] = __float2bfloat16(p);
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

    // O = alpha * O + P . V
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = i / D, c = i % D;
      os[r * L::LDO + c] *= alpha[r];
    }
    __syncwarp();
#pragma unroll 2
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, os + j * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, usm::bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, usm::bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, ps + kk * 16, L::LDP);
        wmma::load_matrix_sync(bm, vs + kk * 16 * LDQ + j * 16, LDQ);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(os + j * 16, acc, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // out = O / max(l, 1e-30), one rounding
  for (int i = lane; i < 16 * (D / 2); i += 32) {
    const int r = i / (D / 2), c2 = (i % (D / 2)) * 2;
    const int qi = q0 + warp * 16 + r;
    if (qi < lq) {
      const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
      *reinterpret_cast<__nv_bfloat162*>(out + head_off_q + (size_t)qi * D + c2) =
          __floats2bfloat162_rn(os[r * L::LDO + c2] * inv, os[r * L::LDO + c2 + 1] * inv);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int bh, int h, int lq, int lk, float scale, cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes;
  cudaError_t e = usm::allow_smem(flash_attention_kernel<D>, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((lq + BQ - 1) / BQ, bh);
  flash_attention_kernel<D><<<grid, WARPS * 32, bytes, stream>>>(
      static_cast<const usm::bf16*>(q), static_cast<const usm::bf16*>(k),
      static_cast<const usm::bf16*>(v), static_cast<const unsigned char*>(mask),
      static_cast<usm::bf16*>(out), h, lq, lk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int usm_flash_attention_bf16(const void* q, const void* k, const void* v,
                                        const void* mask, void* out, int bh, int h, int lq,
                                        int lk, int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || lq <= 0) return cudaSuccess;
  if (lk <= 0 || h <= 0) return cudaErrorInvalidValue;
  if (d != 256) return cudaErrorInvalidValue;  // the memory attention's d_model, one head
  return launch<256>(q, k, v, mask, out, bh, h, lq, lk, scale, s);
}
