// K2 - SpMM CUDA-core stream.
//
// Replaces the TPU kernel spmm_vpu in src/repro/kernels/spmm_vpu.py
// (function spmm_vpu, body _kernel): per residual tile or §4.3 Cs
// segment t (ts non-zeros of one row), p[t] = sum_j vals[t,j] * B[cols[t,j], :],
// written to a (ntiles, n) partial.
//
// Bound on H100: bytes. Each non-zero costs one gathered B row (4n bytes)
// for 2n flops; the compulsory traffic is vals + cols + B once + the
// partials, far below the FP32 ridge.
//
// Design: one warp per (tile, column chunk). The warp reads 32 (value,
// column) pairs at a time with one coalesced load and broadcasts them by
// shuffle; each lane then accumulates 4 consecutive columns with one
// float4 load of the gathered B row (n % 4 == 0, 128 columns per warp),
// or one column with scalar loads otherwise (32 per warp). Every slot is
// multiplied, padding (value 0, column 0) included, as the TPU kernel and
// the plain twin do, so a non-finite B row or an exact-zero weight gives
// the same result in all three; padding re-reads B row 0, which stays in
// cache. FP32 FMA, summed in tile order.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
spmm_vpu_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                const float* __restrict__ b, float* __restrict__ out,
                long long ntiles, int ts, int n, int vec4) {
  const int lane = threadIdx.x & 31;
  const int cols_per_warp = vec4 ? 128 : 32;
  const int nchunks = (n + cols_per_warp - 1) / cols_per_warp;
  const int64_t wid = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (wid >= ntiles * nchunks) return;  // uniform per warp
  const int64_t tile = wid / nchunks;
  const int chunk = static_cast<int>(wid % nchunks);
  const float* tv = vals + tile * ts;
  const int* tc = cols + tile * ts;

  if (vec4) {
    const int c = chunk * 128 + lane * 4;
    const bool active = c < n;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < ts; j0 += 32) {
      float v = 0.f;
      int col = 0;
      if (j0 + lane < ts) {
        v = __ldg(tv + j0 + lane);
        col = __ldg(tc + j0 + lane);
      }
      const int cnt = min(32, ts - j0);
      for (int jj = 0; jj < cnt; ++jj) {
        const float vj = __shfl_sync(libra::kFullMask, v, jj);
        const int64_t cj = __shfl_sync(libra::kFullMask, col, jj);
        if (active) {
          const float4 bv =
              __ldg(reinterpret_cast<const float4*>(b + cj * n + c));
          acc.x = fmaf(vj, bv.x, acc.x);
          acc.y = fmaf(vj, bv.y, acc.y);
          acc.z = fmaf(vj, bv.z, acc.z);
          acc.w = fmaf(vj, bv.w, acc.w);
        }
      }
    }
    if (active) *reinterpret_cast<float4*>(out + tile * n + c) = acc;
  } else {
    const int c = chunk * 32 + lane;
    const bool active = c < n;
    float acc = 0.f;
    for (int j0 = 0; j0 < ts; j0 += 32) {
      float v = 0.f;
      int col = 0;
      if (j0 + lane < ts) {
        v = __ldg(tv + j0 + lane);
        col = __ldg(tc + j0 + lane);
      }
      const int cnt = min(32, ts - j0);
      for (int jj = 0; jj < cnt; ++jj) {
        const float vj = __shfl_sync(libra::kFullMask, v, jj);
        const int64_t cj = __shfl_sync(libra::kFullMask, col, jj);
        if (active) acc = fmaf(vj, __ldg(b + cj * n + c), acc);
      }
    }
    if (active) out[tile * n + c] = acc;
  }
}

}  // namespace

extern "C" int spmm_vpu_launch(const float* vals, const int* cols,
                               const float* b, float* out, long long ntiles,
                               int ts, int n, int vec4, cudaStream_t stream) {
  const int cols_per_warp = vec4 ? 128 : 32;
  const long long warps = ntiles * ((n + cols_per_warp - 1) / cols_per_warp);
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  spmm_vpu_kernel<<<blocks, kWarps * 32, 0, stream>>>(vals, cols, b, out,
                                                      ntiles, ts, n, vec4);
  return static_cast<int>(cudaGetLastError());
}
