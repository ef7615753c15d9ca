// K1 - SpMM Tensor Core stream.
//
// Replaces the TPU kernel spmm_mxu in src/repro/kernels/spmm_mxu.py
// (function spmm_mxu, body _kernel): per condensed block or §4.3 segment
// s, out[rank[s]] (8 x n) = vals[s] (8 x bk) . B[cols[s]] (bk x n), fp32
// accumulation, into the compacted (n_active * 8, n) output.
//
// Bound on H100: bytes. Every condensed vector brings one gathered B row
// (4n bytes) for 16n flops, about 4 flop/byte against a TF32 ridge near
// 150, so the kernel is limited by how fast it can gather B rows; the
// compulsory traffic is the real vectors' values and columns, B once and
// the output.
//
// Design: the paper's swap-and-transpose on mma.sync m16n8k8 TF32,
//   out^T (n x 8) = B[cols]^T (n x bk) . vals^T (bk x 8):
// the 8-row window is the n=8 side, output columns are the m=16 side and
// the condensed vectors are walked in k=8 steps.
// - Real vectors only. The real vectors of a segment are a prefix of it;
//   the caller passes each segment's length (one past its last real
//   vector), and only [0, len) is gathered and multiplied. A real vector
//   multiplies all 8 rows, zeros included, as the twin's product does.
//   The padding (values 0, column 0) adds 0 * B[0, c]: that term is added
//   once to every output of a segment shorter than the table, so a
//   non-finite B row 0 gives the twin's inf/NaN pattern. A segment with
//   no real vector (the dummy segment of an empty path) reads only B[0].
// - One block per (segment, 128 output columns), 32 columns a warp:
//   every gathered B row is staged once for the tile. At n = 256 two
//   blocks gather each row's two halves and read the values twice; the
//   A/B found that 1% faster than one block over all 256 columns (six
//   blocks an SM instead of three).
// - A cp.async ring of two chunks of 32 gathered B rows (16 bytes a
//   thread through L2 only, neighbouring threads on one row; 4 bytes when
//   n % 4 != 0 or an operand is unaligned) with the chunk's values beside
//   them: the mmas on chunk i run while chunk i+1 is in flight. One
//   barrier a chunk. The columns a chunk's copies need are loaded into
//   registers one chunk ahead, the first ones beside the segment's length,
//   and what the epilogue reads (rank, B[0]) at the start, so no load
//   waits on the critical path. The A/B (tools/ab_mxu_kernels.py) set the
//   shape: more stages were slower (fewer blocks an SM; a segment has at
//   most 4 chunks on the main path). Folding every gather into L2 gains
//   nothing: latency, not the L2's rate, sets the pace.
// - Permuted fragments: lane (g, t) reads columns 4g..4g+3 of slots 2t
//   and 2t+1 as two 16-byte shared-memory reads (two m16 tiles' A
//   fragments) and the values of slots 2t, 2t+1 as one 8-byte read, at
//   pitches that keep each read on distinct banks; the accumulators then
//   hold four consecutive columns of two rows, stored as two float4.
// Segments own their output rows (unique ranks) and store with streaming
// stores; with shared ranks (the per-block layout) the wrapper zeroes the
// output and the kernel adds atomically.
// - A batch axis (the TPU's vmapped form over a panel stack or a
//   partition's shards): blockIdx.z picks the batch element, whose
//   operand bases the launcher computes from the batch strides (a stride
//   of 0 shares the operand across the batch: one plan for a stack of
//   panels) into the kernel's parameter table (libra::kMaxBatch). A
//   block does the same arithmetic at any batch size, so each element's
//   output is the single launch's; the single launch is the batch of one.
#include "common.cuh"

namespace {

constexpr int kStages = 2;      // chunks staged or in flight
constexpr int kTileCols = 128;  // output columns a block covers at most
constexpr int kChunk = 32;      // condensed vectors a chunk
constexpr int kVPitch = kChunk + 8;  // conflict-free 8-byte value reads

// Floats in one stage of a tile nt columns wide: 32 B rows at a pitch of
// nt + 4 (conflict-free 16-byte reads of rows 2t), then 8 value rows.
__host__ __device__ constexpr int stage_floats(int nt) {
  return kChunk * (nt + 4) + libra::kWindow * kVPitch;
}

// The operands of the batch elements of one launch.
struct Operands {
  const float* vals[libra::kMaxBatch];
  const int* cols[libra::kMaxBatch];
  const int* seg_len[libra::kMaxBatch];
  const int* rank[libra::kMaxBatch];
  const float* b[libra::kMaxBatch];
  float* out[libra::kMaxBatch];
};

template <bool kVec4>
__global__ void __launch_bounds__(kTileCols)
spmm_mxu_kernel(const __grid_constant__ Operands ops, int bk, int n,
                int atomic_out, int vals16) {
  extern __shared__ __align__(16) float smem[];
  const int z = blockIdx.z;  // the batch element
  const float* __restrict__ vals = ops.vals[z];
  const int* __restrict__ cols = ops.cols[z];
  const int* __restrict__ seg_len = ops.seg_len[z];
  const int* __restrict__ rank = ops.rank[z];
  const float* __restrict__ b = ops.b[z];
  float* __restrict__ out = ops.out[z];
  const int nt = blockDim.x;  // this tile's columns, 32 a warp
  const int pitch = nt + 4;
  const int stage = stage_floats(nt);
  const int64_t seg = blockIdx.x;
  const int c_base = blockIdx.y * nt;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* seg_vals = vals + seg * libra::kWindow * bk;
  const int* seg_cols = cols + seg * bk;
  const int len_raw = __ldg(seg_len + seg);
  int len, nchunks;  // set once the first chunks' columns are in flight

  // The column of slot 32i + lane (every warp loads the chunk's 32).
  // Before the length has arrived, any slot of the table may be loaded.
  auto fetch = [&](int i, int limit) {
    const int s = i * kChunk + lane;
    return s < limit ? __ldcs(seg_cols + s) : 0;
  };
  // Stage chunk i (an empty group past the last one); col is fetch(i).
  // Slots past the real prefix gather nothing and stage zeros.
  auto issue = [&](int i, int col) {
    if (i < nchunks) {
      float* sb = smem + (i % kStages) * stage;
      float* sv = sb + kChunk * pitch;
      const int k0 = i * kChunk;
      if constexpr (kVec4) {
        const int pieces = nt / 4;  // float4 a row; nt threads: 4 rows a pass
        const int q = tid % pieces;
        const int c = c_base + q * 4;
        for (int r = tid / pieces; r < kChunk; r += 4) {
          const int cr = __shfl_sync(libra::kFullMask, col, r);
          const bool ok = k0 + r < len && c < n;
          libra::cp_async16(libra::smem_u32(sb + r * pitch + q * 4),
                            ok ? b + static_cast<int64_t>(cr) * n + c : b, ok);
        }
      } else {
        const int c = c_base + tid;
        for (int r = 0; r < kChunk; ++r) {
          const int cr = __shfl_sync(libra::kFullMask, col, r);
          const bool ok = k0 + r < len && c < n;
          libra::cp_async4(libra::smem_u32(sb + r * pitch + tid),
                           ok ? b + static_cast<int64_t>(cr) * n + c : b, ok);
        }
      }
      if (vals16) {  // 8 rows x 8 float4
        for (int p = tid; p < libra::kWindow * kChunk / 4; p += nt) {
          const int r = p / (kChunk / 4), s = k0 + (p % (kChunk / 4)) * 4;
          const bool ok = s < len;
          libra::cp_async16(
              libra::smem_u32(sv + r * kVPitch + s - k0),
              ok ? seg_vals + static_cast<int64_t>(r) * bk + s : vals, ok);
        }
      } else {
        for (int p = tid; p < libra::kWindow * kChunk; p += nt) {
          const int r = p / kChunk, s = k0 + p % kChunk;
          const bool ok = s < len;
          libra::cp_async4(
              libra::smem_u32(sv + r * kVPitch + s - k0),
              ok ? seg_vals + static_cast<int64_t>(r) * bk + s : vals, ok);
        }
      }
    }
    libra::cp_async_commit();
  };

  const int c0 = warp * 32;  // the warp's columns within the tile
  const bool active = c_base + c0 < n;
  const int c = c_base + c0 + 4 * g;  // this lane's four output columns
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  // The first chunks' columns are loaded beside the length, and what the
  // epilogue reads (the output rank, B[0] for the padding's term) too.
  const int64_t orow = static_cast<int64_t>(__ldg(rank + seg)) *
                       libra::kWindow + 2 * t;
  float b0[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) b0[e] = c + e < n ? __ldg(b + c + e) : 0.f;
  int col[kStages];
#pragma unroll
  for (int i = 0; i < kStages; ++i) col[i] = fetch(i, bk);
  len = min(len_raw, bk);
  nchunks = (len + kChunk - 1) / kChunk;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i, col[i]);
  int col_next = col[kStages - 1];
  for (int i = 0; i < nchunks; ++i) {
    libra::cp_async_wait<kStages - 2>();  // chunk i has landed (this thread)
    __syncthreads();  // ... for every thread; chunk i - 1 is consumed
    issue(i + kStages - 1, col_next);
    col_next = fetch(i + kStages, len);
    if (!active) continue;
    const float* sb = smem + (i % kStages) * stage;
    const float* sv = sb + kChunk * pitch;
#pragma unroll
    for (int ks = 0; ks < kChunk; ks += 8) {
      // k index t <-> slot ks + 2t, t + 4 <-> slot ks + 2t + 1.
      const float2 v =
          *reinterpret_cast<const float2*>(sv + g * kVPitch + ks + 2 * t);
      const uint32_t bf[2] = {libra::to_tf32(v.x), libra::to_tf32(v.y)};
      const float4 p = *reinterpret_cast<const float4*>(
          sb + (ks + 2 * t) * pitch + c0 + 4 * g);
      const float4 q = *reinterpret_cast<const float4*>(
          sb + (ks + 2 * t + 1) * pitch + c0 + 4 * g);
      // Tile 0: m = g <-> column 4g, m = g + 8 <-> 4g + 1; tile 1: 4g + 2,
      // 4g + 3.
      const uint32_t a0[4] = {libra::to_tf32(p.x), libra::to_tf32(p.y),
                              libra::to_tf32(q.x), libra::to_tf32(q.y)};
      libra::mma_m16n8k8_tf32(acc[0], a0, bf);
      const uint32_t a1[4] = {libra::to_tf32(p.z), libra::to_tf32(p.w),
                              libra::to_tf32(q.z), libra::to_tf32(q.w)};
      libra::mma_m16n8k8_tf32(acc[1], a1, bf);
    }
  }
  libra::cp_async_wait<0>();
  if (!active) return;

  // Row 2t of columns 4g..4g+3 and row 2t + 1 of the same columns.
  float o[2][4] = {{acc[0][0], acc[0][2], acc[1][0], acc[1][2]},
                   {acc[0][1], acc[0][3], acc[1][1], acc[1][3]}};
  if (len < bk) {  // the padding's term, once
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[0][e] = fmaf(0.f, b0[e], o[0][e]);
      o[1][e] = fmaf(0.f, b0[e], o[1][e]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* dst = out + (orow + h) * n + c;
    if (kVec4 && !atomic_out) {
      if (c < n) {  // n % 4 == 0: all four columns or none
        __stcs(reinterpret_cast<float4*>(dst),
               make_float4(o[h][0], o[h][1], o[h][2], o[h][3]));
      }
      continue;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c + e >= n) continue;
      if (atomic_out) {
        atomicAdd(dst + e, o[h][e]);
      } else {
        __stcs(dst + e, o[h][e]);
      }
    }
  }
}

}  // namespace

// Strides (*_bs, in elements) step from one batch element's operand to
// the next; 0 shares the operand.
extern "C" int spmm_mxu_launch(const float* vals, const int* cols,
                               const int* seg_len, const int* rank,
                               const float* b, float* out, long long batch,
                               long long nb, int bk, int n,
                               long long vals_bs, long long cols_bs,
                               long long len_bs, long long rank_bs,
                               long long b_bs, long long out_bs,
                               int atomic_out, int vec4,
                               cudaStream_t stream) {
  if (batch <= 0 || nb <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  // The tile: all of n up to kTileCols, in whole warps.
  const int nt = min(kTileCols, (n + 31) / 32 * 32);
  const size_t smem = sizeof(float) * kStages * stage_floats(nt);
  const int vals16 = bk % 4 == 0 && vals_bs % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  auto kernel = vec4 ? spmm_mxu_kernel<true> : spmm_mxu_kernel<false>;
  if (smem > 48 * 1024) {  // two stages of 128 columns take 36 KB
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (long long z0 = 0; z0 < batch; z0 += libra::kMaxBatch) {
    const int nz = libra::batch_chunk(batch, z0);
    Operands ops;
    for (int i = 0; i < nz; ++i) {
      const long long z = z0 + i;
      ops.vals[i] = vals + z * vals_bs, ops.cols[i] = cols + z * cols_bs;
      ops.seg_len[i] = seg_len + z * len_bs;
      ops.rank[i] = rank + z * rank_bs;
      ops.b[i] = b + z * b_bs, ops.out[i] = out + z * out_bs;
    }
    const dim3 grid(static_cast<unsigned>(nb), (n + nt - 1) / nt, nz);
    kernel<<<grid, nt, smem, stream>>>(ops, bk, n, atomic_out, vals16);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
