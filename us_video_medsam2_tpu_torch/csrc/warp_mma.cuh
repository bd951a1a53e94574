// Warp-level building blocks of the flash and window kernels (sm_90a):
// cp.async copies into shared memory, ldmatrix fragment loads,
// mma.sync.m16n8k16 with bf16 operands and f32 accumulators in registers, and
// the thread-block cluster barrier and distributed shared-memory stores.
//
// Fragment layout of one m16n8 accumulator c[4] (lane = 4 * g + t4): c[0],
// c[1] hold row g, columns 2 * t4 and 2 * t4 + 1; c[2], c[3] the same
// columns of row g + 8.
#pragma once

#include "common.cuh"

namespace usm {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// two 8x8 matrices: lanes 0-15 give the row addresses (those of 16-31 are not read)
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t r[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c[16x8] += a[16x16] . b[16x8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Thread-block clusters (sm_90): the block's rank in its cluster, the
// cluster barrier split into its arrive (release) and wait (acquire) halves,
// and 16-byte stores into a peer block's shared memory (distributed shared
// memory), valid between two cluster barriers that every block of the
// cluster passes. Every thread of the block calls the barrier halves.
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the shared::cluster address of the shared::cta address `addr` in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster16(uint32_t addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z),
               "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Lane offsets (in elements, for a row stride `ld`) of the ldmatrix.x4 that
// loads one 16 x 16 bf16 block of a row-major tile:
//  * a_off: the A operand (rows = m, columns = k): a[0..3] as mma takes them;
//  * b_off: the B operand of X . Y^T with Y stored [n][k]: b[0], b[1] for
//    columns n 0-7 and b[2], b[3] for n 8-15 (k 0-7, then 8-15);
//  * bt_off: the B operand of X . Y with Y stored [k][n], loaded with .trans:
//    the same register order.
__device__ __forceinline__ int a_off(int lane, int ld) { return (lane & 15) * ld + (lane >> 4) * 8; }
__device__ __forceinline__ int b_off(int lane, int ld) {
  return (((lane >> 4) << 3) + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int bt_off(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}

}  // namespace usm
