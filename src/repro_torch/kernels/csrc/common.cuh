// Shared helpers for the Libra Hopper kernels: the 8-row window, the
// TF32 Tensor Core instruction of the two Tensor Core streams (K1, K3) and
// the cp.async copies that stage their gathers and K5's tiles.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace libra {

constexpr int kWindow = 8;          // rows per window (8x1 column vectors)
constexpr unsigned kFullMask = 0xffffffffu;

// Batch elements one launch of K1-K4 covers. A launch over a batch (a
// panel stack, a partition's shards) takes each element's operand bases
// as a kernel parameter, a table indexed by the block's batch coordinate,
// which the kernel reads from the constant bank as it reads a plain
// pointer parameter; the launcher covers a larger batch with one launch
// of kMaxBatch elements after another. Offsetting the pointers inside the
// kernel by batch strides instead kept them in registers and cost a
// single launch of K2 9-11% and of K4 16-17% at the main path's shapes
// (the scheduler issued fewer gathers ahead of their use), against 2-3%
// and nothing this way (tools/ab_batched_kernels.py).
constexpr int kMaxBatch = 64;

// Elements of a batch of ``batch`` from element z0 that one launch covers.
inline int batch_chunk(long long batch, long long z0) {
  return static_cast<int>(batch - z0 < kMaxBatch ? batch - z0 : kMaxBatch);
}

// Round an fp32 value to TF32 (round to nearest, ties away), as the
// Tensor Core operand registers expect.
__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

// D (16x8, fp32) += A (16x8, row-major, tf32) * B (8x8, col-major, tf32).
// Fragment layout, with g = lane / 4 and t = lane % 4:
//   a[0] = A[g][t]    a[1] = A[g+8][t]    a[2] = A[g][t+4]  a[3] = A[g+8][t+4]
//   b[0] = B[t][g]    b[1] = B[t+4][g]
//   d[0] = D[g][2t]   d[1] = D[g][2t+1]   d[2] = D[g+8][2t] d[3] = D[g+8][2t+1]
__device__ __forceinline__ void mma_m16n8k8_tf32(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy through L2 only; valid = false reads nothing and
// zero-fills the destination.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

// 4-byte async copy (for operands that are not 16-byte aligned); valid =
// false reads nothing and zero-fills the destination.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace libra
