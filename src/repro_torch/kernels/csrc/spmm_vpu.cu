// K2 - SpMM CUDA-core stream.
//
// Replaces the TPU kernel spmm_vpu in src/repro/kernels/spmm_vpu.py
// (function spmm_vpu, body _kernel): per residual tile or §4.3 Cs
// segment t (one row's residual non-zeros, zero padded to the table's
// width), p[t] = sum_j vals[t,j] * B[cols[t,j], :], written to a
// (ntiles, n) partial.
//
// Bound on H100: bytes. Each non-zero gathers one random row of B (4n
// bytes) for 2n flops; the compulsory traffic is the real (value,
// column) pairs, B once and the partials. On a graph B is several times
// the 50 MB L2, so gathers over all of n go to HBM.
//
// Design:
// - Real slots only. The real non-zeros of a row are a prefix of it;
//   the caller passes each row's length (one past its last real slot),
//   and only [0, len) is read and multiplied. The padding (value 0,
//   column 0) adds 0 * B[0, c]: that term is added once to every row
//   shorter than the table, so a non-finite B row 0 gives the inf/NaN
//   pattern of the TPU kernel and the plain twin, which multiply every
//   slot.
// - L2-resident column slices. The columns of B are cut into slices of
//   slice_cols, chosen by the caller so that k * slice_cols * 4 bytes
//   fit most of the L2, and the grid runs slice-major (the slice is the
//   outer part of the linear block id, which the scheduler walks in
//   order): while one slice runs, its random gathers hit L2.
// - Several rows a warp, gathers in flight. slice_cols / 4 lanes
//   (float4 columns; one column a lane when n % 4 != 0) share one row,
//   so a warp holds several rows and few lanes idle at narrow n. A group
//   reads its row's (value, column) pairs with one coalesced streaming
//   load, broadcasts them by shuffle, and each lane issues kUnroll
//   independent B loads (L2 only) before it consumes any. Small blocks
//   and few loads a lane measured fastest: the L2, not the number of
//   loads in flight, sets the pace once a slice is resident.
// - A batch axis (a panel stack, a partition's shards): blockIdx.y picks
//   the batch element, whose operand bases the launcher computes from the
//   batch strides (0 shares an operand) into the kernel's parameter
//   table (libra::kMaxBatch). Each element runs the single launch's grid,
//   slice-major, so a slice of its B stays in L2 while it runs; the
//   single launch is the batch of one.
// FP32 FMA, summed in slot order; the partials are written once, with
// streaming stores.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;   // warps a block
constexpr int kUnroll = 4;  // B rows a lane has in flight

template <int kV>
struct Row {
  float v[kV];
};

template <int kV>
__device__ __forceinline__ Row<kV> gather(const float* p) {
  Row<kV> r;
  if constexpr (kV == 4) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
    r.v[0] = t.x, r.v[1] = t.y, r.v[2] = t.z, r.v[3] = t.w;
  } else {
    r.v[0] = __ldcg(p);
  }
  return r;
}

// The operands of the batch elements of one launch.
struct Operands {
  const float* vals[libra::kMaxBatch];
  const int* cols[libra::kMaxBatch];
  const int* row_len[libra::kMaxBatch];
  const float* b[libra::kMaxBatch];
  float* out[libra::kMaxBatch];
};

template <int kV>
__global__ void __launch_bounds__(kWarps * 32)
spmm_vpu_kernel(const __grid_constant__ Operands ops, long long ntiles,
                int width, int n, int slice_cols, long long blocks_per_slice) {
  const int z = blockIdx.y;  // the batch element
  const float* __restrict__ vals = ops.vals[z];
  const int* __restrict__ cols = ops.cols[z];
  const int* __restrict__ row_len = ops.row_len[z];
  const float* __restrict__ b = ops.b[z];
  float* __restrict__ out = ops.out[z];
  const int group = slice_cols / kV;  // lanes per row, <= 32
  const int per_warp = 32 / group;    // rows per warp
  const int lane = threadIdx.x & 31;
  const int grp = lane / group;
  const int gl = lane - grp * group;
  const long long slice = blockIdx.x / blocks_per_slice;
  const long long sblk = blockIdx.x - slice * blocks_per_slice;
  const long long tile =
      (sblk * kWarps + (threadIdx.x >> 5)) * per_warp + grp;
  const bool live = grp < per_warp && tile < ntiles;
  const int c = static_cast<int>(slice) * slice_cols + gl * kV;
  const bool active = live && c < n;  // kV == 4: n % 4 == 0
  const int len = live ? min(__ldcs(row_len + tile), width) : 0;
  const int max_len = __reduce_max_sync(libra::kFullMask, len);
  const float* tv = vals + tile * width;
  const int* tc = cols + tile * width;
  const int first = grp * group;  // the group's first lane

  float acc[kV] = {};
  for (int j0 = 0; j0 < max_len; j0 += group) {
    // Lane gl holds slot j0 + gl of its row.
    float v = 0.f;
    int col = 0;
    if (j0 + gl < len) {
      v = __ldcs(tv + j0 + gl);
      col = __ldcs(tc + j0 + gl);
    }
    const int chunk = min(group, max_len - j0);  // uniform per warp
    for (int u0 = 0; u0 < chunk; u0 += kUnroll) {
      float vu[kUnroll];
      Row<kV> bu[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = u0 + u;
        const int src = first + min(jj, group - 1);
        vu[u] = __shfl_sync(libra::kFullMask, v, src);
        const int cu = __shfl_sync(libra::kFullMask, col, src);
        ok[u] = active && jj < group && j0 + jj < len;
        if (ok[u]) bu[u] = gather<kV>(b + static_cast<int64_t>(cu) * n + c);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (ok[u]) {
#pragma unroll
          for (int q = 0; q < kV; ++q) {
            acc[q] = fmaf(vu[u], bu[u].v[q], acc[q]);
          }
        }
      }
    }
  }
  if (!active) return;
  if (len < width) {  // the padding's term, once
    const Row<kV> b0 = gather<kV>(b + c);
#pragma unroll
    for (int q = 0; q < kV; ++q) acc[q] = fmaf(0.f, b0.v[q], acc[q]);
  }
  float* o = out + tile * n + c;  // streaming: keep the slice in L2
  if constexpr (kV == 4) {
    __stcs(reinterpret_cast<float4*>(o),
           make_float4(acc[0], acc[1], acc[2], acc[3]));
  } else {
    __stcs(o, acc[0]);
  }
}

}  // namespace

// Strides (*_bs, in elements) step from one batch element's operand to
// the next; 0 shares the operand.
extern "C" int spmm_vpu_launch(const float* vals, const int* cols,
                               const int* row_len, const float* b, float* out,
                               long long batch, long long ntiles, int width,
                               int n, long long vals_bs, long long cols_bs,
                               long long len_bs, long long b_bs,
                               long long out_bs, int slice_cols, int vec4,
                               cudaStream_t stream) {
  const int v = vec4 ? 4 : 1;
  if (slice_cols <= 0 || slice_cols % v != 0 || slice_cols / v > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || ntiles <= 0) return static_cast<int>(cudaSuccess);
  const int per_warp = 32 / (slice_cols / v);
  const long long rows_per_block = static_cast<long long>(kWarps) * per_warp;
  const long long blocks_per_slice =
      (ntiles + rows_per_block - 1) / rows_per_block;
  const long long slices = (n + slice_cols - 1) / slice_cols;
  auto kernel = vec4 ? spmm_vpu_kernel<4> : spmm_vpu_kernel<1>;
  for (long long z0 = 0; z0 < batch; z0 += libra::kMaxBatch) {
    const int nz = libra::batch_chunk(batch, z0);
    Operands ops;
    for (int i = 0; i < nz; ++i) {
      const long long z = z0 + i;
      ops.vals[i] = vals + z * vals_bs, ops.cols[i] = cols + z * cols_bs;
      ops.row_len[i] = row_len + z * len_bs, ops.b[i] = b + z * b_bs;
      ops.out[i] = out + z * out_bs;
    }
    const dim3 grid(static_cast<unsigned>(blocks_per_slice * slices), nz);
    kernel<<<grid, kWarps * 32, 0, stream>>>(ops, ntiles, width, n,
                                             slice_cols, blocks_per_slice);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
