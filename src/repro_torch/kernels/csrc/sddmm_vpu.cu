// K4 - SDDMM CUDA-core stream.
//
// Replaces the TPU kernel sddmm_vpu in src/repro/kernels/sddmm_vpu.py
// (function sddmm_vpu, body _kernel): per element e of an (ntiles, ts)
// tile table, s[e] = <X[rows[e]], Y[cols[e]]>. With a position table and
// the tile mask, s[e] is stored at out[pos[e]], its canonical CSR
// position, where mask[e] holds (each position has one owner; masked
// padding stores nothing); without them the output is s itself, laid
// out as the table, and the caller applies the mask.
//
// Bound on H100: bytes. Each element gathers one random Y row (4 kf
// bytes) for 2 kf flops; the compulsory traffic is the (row, column)
// pairs, X and Y once and the scores. On a graph Y is larger than the
// 50 MB L2, so gathers over all of kf go to HBM.
//
// Design:
// - Feature slices. The kf axis is cut into slices of slice_feats,
//   chosen by the caller so that k * slice_feats * 4 bytes of Y fit
//   most of the L2, and each slice is one launch: its Y
//   gathers hit L2. Launches run in order on the stream; the first
//   stores its partial dot products and each later one adds its own, so
//   the sum is taken in a fixed slice order and is deterministic. With
//   canonical stores the slices before the last store into a scratch
//   table laid out as the tile table, and the last adds it.
// - Runs of elements. A warp scores 32 consecutive elements: each lane
//   loads one element's (row, column) pair, coalesced; a group of
//   slice_feats / 4 lanes (a power of two, float4 features; one feature
//   a lane when kf % 4 != 0 or an operand is unaligned) scores the
//   group's elements one after another, so that every lane ends up
//   holding its own element's score and the store is coalesced.
//   Elements follow the mask's window order, so a run touches a few X
//   rows again and again: X is read through L1, Y around it (L2 only).
// - Many gathers in flight: each lane issues the X and Y loads of
//   kUnroll elements before it reduces any; the group sums with
//   log2(group) butterfly shuffles.
// - A batch axis (a panel stack, a partition's shards): blockIdx.y picks
//   the batch element, whose operand bases the launcher computes from the
//   batch strides (0 shares an operand) into the kernel's parameter
//   table (libra::kMaxBatch); the single launch is the batch of one.
// FP32 FMA.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;   // warps a block
constexpr int kUnroll = 2;  // elements a lane has in flight

// The operands of the batch elements of one launch.
struct Operands {
  const int* rows[libra::kMaxBatch];
  const int* cols[libra::kMaxBatch];
  const int* pos[libra::kMaxBatch];  // null: output laid out as the table
  const unsigned char* mask[libra::kMaxBatch];  // torch.bool bytes
  const float* x[libra::kMaxBatch];
  const float* y[libra::kMaxBatch];
  float* out[libra::kMaxBatch];
};

template <int kV>
__global__ void __launch_bounds__(kWarps * 32)
sddmm_vpu_kernel(const __grid_constant__ Operands ops, long long nel, int kf,
                 int f0, int group, int accumulate, const float* staged,
                 long long staged_bs) {
  const int z = blockIdx.y;  // the batch element
  const int* __restrict__ rows = ops.rows[z];
  const int* __restrict__ cols = ops.cols[z];
  const int* __restrict__ pos = ops.pos[z];
  const float* __restrict__ x = ops.x[z];
  const float* __restrict__ y = ops.y[z];
  float* __restrict__ out = ops.out[z];
  const int lane = threadIdx.x & 31;
  const long long base =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (base >= nel) return;  // uniform per warp
  const long long e = base + lane;
  const bool valid = e < nel;
  int row = 0, col = 0, at = -1;  // at: the canonical position, -1 none
  if (valid) {
    row = __ldcs(rows + e);
    col = __ldcs(cols + e);
    if (pos != nullptr && __ldcs(ops.mask[z] + e)) at = __ldcs(pos + e);
  }
  const int gl = lane & (group - 1);  // lane within the group
  const int first = lane - gl;        // the group's first lane
  const int f = f0 + gl * kV;
  const bool feat = f < kf;  // kV == 4: kf % 4 == 0
  float mine = 0.f;
  for (int u0 = 0; u0 < group; u0 += kUnroll) {
    float p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int src = first + min(u0 + u, group - 1);
      const int64_t r = __shfl_sync(libra::kFullMask, row, src);
      const int64_t cc = __shfl_sync(libra::kFullMask, col, src);
      p[u] = 0.f;
      if (feat && u0 + u < group) {
        if constexpr (kV == 4) {
          const float4 a =
              __ldg(reinterpret_cast<const float4*>(x + r * kf + f));
          const float4 bb =
              __ldcg(reinterpret_cast<const float4*>(y + cc * kf + f));
          p[u] = fmaf(a.x, bb.x, p[u]);
          p[u] = fmaf(a.y, bb.y, p[u]);
          p[u] = fmaf(a.z, bb.z, p[u]);
          p[u] = fmaf(a.w, bb.w, p[u]);
        } else {
          p[u] = __ldg(x + r * kf + f) * __ldcg(y + cc * kf + f);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float s = p[u];
      for (int off = group >> 1; off > 0; off >>= 1) {
        s += __shfl_xor_sync(libra::kFullMask, s, off, group);
      }
      if (gl == u0 + u) mine = s;
    }
  }
  if (!valid) return;
  if (pos != nullptr) {  // canonical: the kept score's one owner
    if (at < 0) return;
    if (accumulate) mine += __ldcs(staged + z * staged_bs + e);
    out[at] = mine;
    return;
  }
  if (accumulate) mine += __ldcs(out + e);
  __stcs(out + e, mine);  // streaming: keep the slice in L2
}

}  // namespace

// Strides (*_bs, in elements) step from one batch element's operand to
// the next; 0 shares the operand. pos null: the output laid out as the
// table (mask unread). pos given: canonical stores into out where mask
// holds, over several slices through staged, nel scratch floats a batch
// element.
extern "C" int sddmm_vpu_launch(const int* rows, const int* cols,
                                const int* pos, const unsigned char* mask,
                                const float* x, const float* y, float* out,
                                float* staged, long long batch, long long nel,
                                int kf, long long rows_bs, long long cols_bs,
                                long long pos_bs, long long mask_bs,
                                long long x_bs, long long y_bs,
                                long long out_bs, long long staged_bs,
                                int slice_feats, int vec4,
                                cudaStream_t stream) {
  const int v = vec4 ? 4 : 1;
  const int group = slice_feats / v;
  if (slice_feats <= 0 || slice_feats % v != 0 || group > 32 ||
      (group & (group - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || nel <= 0) return static_cast<int>(cudaSuccess);
  if (pos == nullptr) {
    staged = nullptr;
  } else if (staged == nullptr && kf > slice_feats) {
    return static_cast<int>(cudaErrorInvalidValue);  // nowhere to stage
  }
  const long long warps = (nel + 31) / 32;
  auto kernel = vec4 ? sddmm_vpu_kernel<4> : sddmm_vpu_kernel<1>;
  for (long long z0 = 0; z0 < batch; z0 += libra::kMaxBatch) {
    const int nz = libra::batch_chunk(batch, z0);
    Operands ops{}, early{};
    for (int i = 0; i < nz; ++i) {
      const long long z = z0 + i;
      ops.rows[i] = rows + z * rows_bs, ops.cols[i] = cols + z * cols_bs;
      ops.pos[i] = pos == nullptr ? nullptr : pos + z * pos_bs;
      ops.mask[i] = pos == nullptr ? nullptr : mask + z * mask_bs;
      ops.x[i] = x + z * x_bs, ops.y[i] = y + z * y_bs;
      ops.out[i] = out + z * out_bs;
    }
    if (staged != nullptr) {
      early = ops;
      for (int i = 0; i < nz; ++i) {
        early.pos[i] = nullptr;
        early.out[i] = staged + (z0 + i) * staged_bs;
      }
    }
    const float* const staged_z0 =
        staged == nullptr ? nullptr : staged + z0 * staged_bs;
    const dim3 grid(static_cast<unsigned>((warps + kWarps - 1) / kWarps), nz);
    for (int f0 = 0; f0 < kf; f0 += slice_feats) {
      if (staged != nullptr && f0 + slice_feats < kf) {
        kernel<<<grid, kWarps * 32, 0, stream>>>(early, nel, kf, f0, group,
                                                 f0 > 0, nullptr, 0);
      } else {
        kernel<<<grid, kWarps * 32, 0, stream>>>(
            ops, nel, kf, f0, group, f0 > 0, f0 > 0 ? staged_z0 : nullptr,
            staged_bs);
      }
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaSuccess);
}
