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
// compulsory traffic is vals + cols + B once + the output.
//
// Design: the paper's swap-and-transpose on mma.sync m16n8k8 TF32,
//   out^T (n x 8) = B[cols]^T (n x bk) . vals^T (bk x 8):
// the 8-row window is the n=8 side, 16 output columns are the m=16 side
// and bk is walked in k=8 steps. One thread block owns one (segment,
// 128-column tile); it stages 32 gathered B rows at a time in shared
// memory with coalesced (float4 where n % 4 == 0) loads, so each gathered
// row is read from memory once per column tile, and four warps each
// accumulate 32 columns x 8 rows in fp32 registers. The ragged n edge is
// masked in the kernel. Segments own their output rows (unique ranks) and
// store; with shared ranks (the per-block layout) the wrapper zeroes the
// output and the kernel adds atomically.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;        // 4 warps
constexpr int kNTile = 128;          // output columns per block (32 per warp)
constexpr int kKChunk = 32;          // condensed vectors staged per step
constexpr int kBPitch = kNTile + 8;  // conflict-free A-fragment reads
constexpr int kVPitch = kKChunk + 4; // conflict-free B-fragment reads

__global__ void __launch_bounds__(kThreads)
spmm_mxu_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                const int* __restrict__ rank, const float* __restrict__ b,
                float* __restrict__ out, int bk, int n, int atomic_out,
                int vec4) {
  __shared__ __align__(16) float sb[kKChunk][kBPitch];
  __shared__ float sv[libra::kWindow][kVPitch];

  const int64_t seg = blockIdx.x;
  const int n0 = blockIdx.y * kNTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* seg_vals = vals + seg * libra::kWindow * bk;
  const int* seg_cols = cols + seg * bk;

  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int k0 = 0; k0 < bk; k0 += kKChunk) {
    for (int i = tid; i < libra::kWindow * kKChunk; i += kThreads) {
      const int r = i / kKChunk, kk = i % kKChunk;
      sv[r][kk] = (k0 + kk < bk) ? seg_vals[(int64_t)r * bk + k0 + kk] : 0.f;
    }
    if (vec4) {
      for (int i = tid; i < kKChunk * (kNTile / 4); i += kThreads) {
        const int kk = i / (kNTile / 4), c = (i % (kNTile / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + kk < bk && n0 + c < n) {
          const int64_t row = seg_cols[k0 + kk];
          v = __ldg(reinterpret_cast<const float4*>(b + row * n + n0 + c));
        }
        *reinterpret_cast<float4*>(&sb[kk][c]) = v;
      }
    } else {
      for (int i = tid; i < kKChunk * kNTile; i += kThreads) {
        const int kk = i / kNTile, c = i % kNTile;
        float v = 0.f;
        if (k0 + kk < bk && n0 + c < n) {
          const int64_t row = seg_cols[k0 + kk];
          v = __ldg(b + row * n + n0 + c);
        }
        sb[kk][c] = v;
      }
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kKChunk; ks += 8) {
      const uint32_t bf[2] = {libra::to_tf32(sv[g][ks + t]),
                              libra::to_tf32(sv[g][ks + t + 4])};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = warp * 32 + h * 16 + g;
        const uint32_t af[4] = {libra::to_tf32(sb[ks + t][c]),
                                libra::to_tf32(sb[ks + t][c + 8]),
                                libra::to_tf32(sb[ks + t + 4][c]),
                                libra::to_tf32(sb[ks + t + 4][c + 8])};
        libra::mma_m16n8k8_tf32(acc[h], af, bf);
      }
    }
    __syncthreads();
  }

  // d[0] = out^T[c][2t], d[1] = out^T[c][2t+1], d[2]/d[3]: column c + 8.
  const int64_t orow = (int64_t)rank[seg] * libra::kWindow + 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = n0 + warp * 32 + h * 16 + g;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = c + (q >> 1) * 8;
      if (col >= n) continue;
      float* dst = out + (orow + (q & 1)) * n + col;
      if (atomic_out) {
        atomicAdd(dst, acc[h][q]);
      } else {
        *dst = acc[h][q];
      }
    }
  }
}

}  // namespace

extern "C" int spmm_mxu_launch(const float* vals, const int* cols,
                               const int* rank, const float* b, float* out,
                               long long nb, int bk, int n, int atomic_out,
                               int vec4, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(nb), (n + kNTile - 1) / kNTile);
  spmm_mxu_kernel<<<grid, kThreads, 0, stream>>>(vals, cols, rank, b, out, bk,
                                                 n, atomic_out, vec4);
  return static_cast<int>(cudaGetLastError());
}
