// Thin wrappers over the Hopper (sm_90a) instructions the hand-written
// kernels share: asynchronous 16-byte copies into shared memory (cp.async,
// with zero fill), ldmatrix (plain and transposed), the tensor-core
// products mma.sync.m16n8k16 (bf16) and m16n8k8 (tf32) with f32
// accumulators, and the cluster barrier and distributed shared-memory loads
// of thread block clusters.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (PTX ISA, "Matrix Fragments
// for mma.m16n8k16"), with lane = 4 * g + t (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), four 32-bit registers of two bf16 each, the
//     lower half holding the smaller column:
//       a0 = A[g][2t, 2t+1]      a1 = A[g+8][2t, 2t+1]
//       a2 = A[g][2t+8, 2t+9]    a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8, "col": stored by columns), two registers:
//       b0 = B[2t, 2t+1][g]      b1 = B[2t+8, 2t+9][g]
//   C, D (16 x 8, f32), four registers:
//       c0, c1 = C[g][2t, 2t+1]  c2, c3 = C[g+8][2t, 2t+1]
// ldmatrix.x4 loads four 8 x 8 b16 matrices; lanes 8i .. 8i+7 give the row
// addresses of matrix i, and register i of lane (4 g + t) receives row g,
// elements 2t and 2t+1 of matrix i (of its transpose with .trans).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ptx {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; with valid false
// nothing is read and the 16 bytes are zero-filled (src must still be a
// valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// two matrices: lanes 0 .. 15 give the row addresses, r[0] and r[1] come
// back (r[2], r[3] untouched)
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += A * B: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32 rounded to tf32 (nearest, ties away from zero), as a b32 operand of
// a tf32 mma: the 13 low mantissa bits zero
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as tf32 hi + lo (hi = tf32(x), lo = tf32(x - hi)): |x - hi - lo| <=
// 2^-22 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += A * B: mma.sync.m16n8k8 with tf32 operands and f32 accumulators.
// Fragments (lane = 4 g + t): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
// a3 = A[g+8][t+4]; b0 = B[t][g], b1 = B[t+4][g]; C as for m16n8k16.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Thread block clusters: every thread of every block of the cluster
// arrives and waits (release / acquire: shared-memory writes before the
// barrier are visible to the cluster's blocks after it).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The same barrier without release semantics: for a barrier that orders no
// memory access (peers only have to have finished reading this block's
// shared memory, which their loads have, once their values are used), so
// the arrive does not wait for this block's outstanding global stores.
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile(
      "barrier.cluster.arrive.relaxed.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// two f32 at the same shared-memory offset as p (8-byte aligned) in block
// `rank` of the cluster, in one load
__device__ __forceinline__ float2 ld_cluster_f32x2(const float* p,
                                                   unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(remote));
  return v;
}

// four f32 at the same shared-memory offset as p (16-byte aligned) in block
// `rank` of the cluster (distributed shared memory), in one load; ordered
// by cluster_sync's barrier, not by a memory clobber
__device__ __forceinline__ float4 ld_cluster_f32x4(const float* p,
                                                   unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(remote));
  return v;
}

// two f32 values rounded to nearest-even bf16, lo in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace ptx
