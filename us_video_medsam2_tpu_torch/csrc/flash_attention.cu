// Flash attention with a per-key boolean mask: out = softmax(q.k^T * scale, masked) . v.
//
// Replaces us_video_medsam2_tpu/kernels/flash_attention.py (flash_attention,
// flash_attention_masked, _flash_kernel). q [BH, Lq, D], k/v [BH, Lk, D] bf16,
// mask [B, Lk] uint8 (1 = attend, may be null), out [BH, Lq, D] bf16, D = 256.
//
// Bound by operations at the memory-attention shapes (4*Lq*Lk*D flop against
// ~2*(Lq + 2*Lk)*D bytes: ~500 flop/byte at Lq 1024). At batch 1 one block per
// 64-query tile would give 16 blocks for 132 SMs, so the keys are split across
// blocks as well (flash-decoding):
//  * flash_fwd_kernel, grid (Lq/64, splits, BH), 4 warps of 16 query rows.
//    Block `split` walks the key tiles [split*tps, (split+1)*tps) of 64 keys
//    (tps = ceil(tiles / splits); trailing splits may hold no key at all).
//    K and V tiles arrive by cp.async into two shared-memory stages, the next
//    tile in flight while the current one is computed. S = Q.K^T and O += P.V
//    run on mma.sync.m16n8k16 (bf16 in, f32 accumulation) with operands from
//    ldmatrix; each thread owns rows g and g+8 of its warp's slab, so the
//    online softmax (running max m and sum l in f32, the exp(m_old - m_new)
//    rescale of O) stays in registers and P goes from the S accumulators into
//    the A operand of P.V without touching shared memory. Masked keys score
//    -1e30 and keys past Lk -inf, as in the JAX kernel. When the batch has at
//    least one valid key, tiles whose 64 keys are all masked are skipped (their
//    exp(-1e30 - m) would be exactly 0 once m is a real score); a batch with no
//    valid key attends every tile, which averages v uniformly. The decision is
//    taken on the device, so the call never synchronises with the host.
//    With one split the block writes bf16(O / max(l, 1e-30)); otherwise it
//    writes its unnormalised O (f32) and (m, l) into scratch;
//  * flash_combine_kernel: m = max_i m_i, w_i = exp(m_i - m) (0 for a split
//    with no key, m_i = -inf), out = bf16(sum_i w_i O_i / max(sum_i w_i l_i, 1e-30)).
// Scores are kept in log2 units (scale * log2 e folded in) so every
// exponential is one exp2f. The score matrix never reaches device memory.
#include "warp_mma.cuh"

namespace {

using namespace usm;

constexpr int D = 256;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = 16 * WARPS;  // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int LD = D + 8;       // bf16 row stride: the 8 rows of an ldmatrix hit distinct banks
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

constexpr size_t Q_BYTES = sizeof(usm::bf16) * BQ * LD;
constexpr size_t TILE_BYTES = sizeof(usm::bf16) * BK * LD;
constexpr size_t SMEM_BYTES = Q_BYTES + 4 * TILE_BYTES;  // Q, then K and V in two stages

// rows [row0, row0 + rows) of a [*, D] head into shared memory (row stride LD),
// rows at or past `valid` zero-filled
__device__ __forceinline__ void load_rows(usm::bf16* dst, const usm::bf16* src, int row0, int rows,
                                          int valid) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < valid;
    cp_async16(smem_u32(dst + r * LD + c * 8), src + (size_t)(ok ? row0 + r : 0) * D + c * 8, ok);
  }
}

template <bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_kernel(
    const usm::bf16* __restrict__ q, const usm::bf16* __restrict__ k,
    const usm::bf16* __restrict__ v, const unsigned char* __restrict__ mask,
    usm::bf16* __restrict__ out, float* __restrict__ o_part, float* __restrict__ ml_part, int h,
    int lq, int lk, int tiles_per_split, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  usm::bf16* qs = reinterpret_cast<usm::bf16*>(smem);
  usm::bf16* ks[2] = {reinterpret_cast<usm::bf16*>(smem + Q_BYTES),
                      reinterpret_cast<usm::bf16*>(smem + Q_BYTES + TILE_BYTES)};
  usm::bf16* vs[2] = {reinterpret_cast<usm::bf16*>(smem + Q_BYTES + 2 * TILE_BYTES),
                      reinterpret_cast<usm::bf16*>(smem + Q_BYTES + 3 * TILE_BYTES)};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int bh = blockIdx.z;
  const usm::bf16* qh = q + (size_t)bh * lq * D;
  const usm::bf16* kh = k + (size_t)bh * lk * D;
  const usm::bf16* vh = v + (size_t)bh * lk * D;
  const unsigned char* mrow = mask ? mask + (size_t)(bh / h) * lk : nullptr;

  const int tiles = (lk + BK - 1) / BK;
  const int t_end = min(tiles, (split + 1) * tiles_per_split);

  // Wholly masked tiles may be skipped only when the batch has a valid key.
  bool skip_masked = false;
  if (mrow) {
    int any = 0;
    for (int i = threadIdx.x; i < lk; i += THREADS) any |= mrow[i];
    skip_masked = __syncthreads_or(any);
  }
  // every warp takes the same decisions from the same bytes, so the block stays uniform
  auto next_tile = [&](int t) {
    for (; t < t_end && skip_masked; ++t) {
      const int a = t * BK + lane, b = a + 32;
      if (__any_sync(0xffffffffu, (a < lk && mrow[a]) || (b < lk && mrow[b]))) break;
    }
    return t;
  };

  int cur = next_tile(split * tiles_per_split);
  load_rows(qs, qh, q0, BQ, lq);
  if (cur < t_end) {
    load_rows(ks[0], kh, cur * BK, BK, lk);
    load_rows(vs[0], vh, cur * BK, BK, lk);
  }
  cp_commit();

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const uint32_t q_addr = smem_u32(qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  // K as the B operand of Q.K^T (keys are its columns): matrices (keys 0-7 | 8-15) x (d 0-7 | 8-15)
  const int k_off = (((lane >> 4) << 3) + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
  // V as the B operand of P.V, transposed on load: (keys 0-7 | 8-15) x (d 0-7 | 8-15)
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  int stage = 0;
  while (cur < t_end) {
    const int nxt = next_tile(cur + 1);
    if (nxt < t_end) {
      load_rows(ks[stage ^ 1], kh, nxt * BK, BK, lk);
      load_rows(vs[stage ^ 1], vh, nxt * BK, BK, lk);
    }
    cp_commit();
    cp_wait<1>();  // the current tile (and Q) have landed; the next may be in flight
    __syncthreads();

    // S = Q_w . K^T  [16, 64]
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const uint32_t k_addr = smem_u32(ks[stage] + k_off);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t a[4];
      ldsm_x4(q_addr + kd * 32, a);
#pragma unroll
      for (int nj = 0; nj < BK / 16; ++nj) {
        uint32_t b[4];
        ldsm_x4(k_addr + (nj * 16 * LD + kd * 16) * 2, b);
        mma(s[2 * nj], a, b[0], b[1]);
        mma(s[2 * nj + 1], a, b[2], b[3]);
      }
    }

    // scale, mask, online softmax; thread holds rows g (s[.][0..1]) and g+8 (s[.][2..3])
    const int k0 = cur * BK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + j * 8 + 2 * t4 + e;
        const bool in = key < lk;
        const bool on = in && (!mrow || mrow[key]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = s[j][2 * r + e];
          x = on ? x * scale_log2 : (in ? MASKED : -INFINITY);
          mx[r] = fmaxf(mx[r], x);
        }
      }
    }
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      base[r] = m_new == -INFINITY ? 0.f : m_new;  // guards -inf - -inf
      alpha[r] = exp2f(m[r] - base[r]);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = exp2f(s[j][c] - base[c >> 1]);
        rs[c >> 1] += s[j][c];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];  // per-thread partial sums
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P . V, P (bf16) straight from the S accumulators
    const uint32_t v_addr = smem_u32(vs[stage] + v_off);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        ldsm_x4_t(v_addr + (kk * 16 * LD + dn * 16) * 2, b);
        mma(o[2 * dn], a, b[0], b[1]);
        mma(o[2 * dn + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
    stage ^= 1;
    cur = nxt;
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= lq) continue;
    if constexpr (SPLIT) {
      const size_t prow = ((size_t)split * gridDim.z + bh) * lq + row;
      float* dst = o_part + prow * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + j * 8) = make_float2(o[j][2 * r], o[j][2 * r + 1]);
      if (t4 == 0) *reinterpret_cast<float2*>(ml_part + prow * 2) = make_float2(m[r], l[r]);
    } else {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      usm::bf16* dst = out + ((size_t)bh * lq + row) * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    }
  }
}

// out rows = BH * Lq; 64 threads a row (4 columns each), 4 rows a block
__global__ void __launch_bounds__(256) flash_combine_kernel(const float* __restrict__ o_part,
                                                            const float* __restrict__ ml_part,
                                                            usm::bf16* __restrict__ out, int splits,
                                                            int rows) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 6);
  if (row >= rows) return;
  const int c = (threadIdx.x & 63) * 4;
  float top = -INFINITY;
  for (int i = 0; i < splits; ++i) top = fmaxf(top, ml_part[((size_t)i * rows + row) * 2]);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;
  for (int i = 0; i < splits; ++i) {
    const float2 ml = *reinterpret_cast<const float2*>(ml_part + ((size_t)i * rows + row) * 2);
    if (ml.x == -INFINITY) continue;  // no key in this split
    const float w = exp2f(ml.x - top);
    const float4 oi = *reinterpret_cast<const float4*>(o_part + ((size_t)i * rows + row) * D + c);
    acc.x += w * oi.x;
    acc.y += w * oi.y;
    acc.z += w * oi.z;
    acc.w += w * oi.w;
    l += w * ml.y;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * D + c);
  dst[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
  dst[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
}

template <bool SPLIT>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* mask, void* out,
                       void* o_part, void* ml_part, int bh, int h, int lq, int lk, int splits,
                       float scale, cudaStream_t stream) {
  cudaError_t e = usm::allow_smem(flash_fwd_kernel<SPLIT>, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const int tiles = (lk + BK - 1) / BK;
  dim3 grid((lq + BQ - 1) / BQ, splits, bh);
  flash_fwd_kernel<SPLIT><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const usm::bf16*>(q), static_cast<const usm::bf16*>(k),
      static_cast<const usm::bf16*>(v), static_cast<const unsigned char*>(mask),
      static_cast<usm::bf16*>(out), static_cast<float*>(o_part), static_cast<float*>(ml_part), h,
      lq, lk, (tiles + splits - 1) / splits, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// o_part [splits, bh, lq, 256] and ml_part [splits, bh, lq, 2] f32 are scratch,
// unused (may be null) when splits == 1.
extern "C" int usm_flash_attention_bf16(const void* q, const void* k, const void* v,
                                        const void* mask, void* out, void* o_part, void* ml_part,
                                        int bh, int h, int lq, int lk, int d, int splits,
                                        float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || lq <= 0) return cudaSuccess;
  if (lk <= 0 || h <= 0 || splits <= 0 || splits > 65535) return cudaErrorInvalidValue;
  if (d != D) return cudaErrorInvalidValue;  // the memory attention's d_model, one head
  if (splits == 1) return launch_fwd<false>(q, k, v, mask, out, nullptr, nullptr, bh, h, lq, lk, 1, scale, s);
  if (!o_part || !ml_part) return cudaErrorInvalidValue;
  cudaError_t e = launch_fwd<true>(q, k, v, mask, out, o_part, ml_part, bh, h, lq, lk, splits, scale, s);
  if (e != cudaSuccess) return e;
  const int rows = bh * lq;
  flash_combine_kernel<<<(rows + 3) / 4, 256, 0, s>>>(static_cast<const float*>(o_part),
                                                       static_cast<const float*>(ml_part),
                                                       static_cast<usm::bf16*>(out), splits, rows);
  return cudaGetLastError();
}
