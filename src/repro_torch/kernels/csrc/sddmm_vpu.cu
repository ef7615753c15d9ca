// K4 - SDDMM CUDA-core stream.
//
// Replaces the TPU kernel sddmm_vpu in src/repro/kernels/sddmm_vpu.py
// (function sddmm_vpu, body _kernel): per element e of an (ntiles, ts)
// tile table, s[e] = <X[rows[e]], Y[cols[e]]>. The caller applies the
// tile mask.
//
// Bound on H100: bytes. Each element gathers one X row and one Y row
// (8 kf bytes) for 2 kf flops; the compulsory traffic is rows + cols + X
// and Y once + the scores.
//
// Design: a group of G lanes per element (G = 32 for kf >= 128, fewer
// for narrow features, so a warp scores 32 / G elements at once). Lanes
// stride the feature dimension with float4 loads (kf % 4 == 0) or scalar
// loads, multiply-add in fp32, and reduce across the group with
// butterfly shuffles. Consecutive elements share rows (tiles follow the
// row-major mask), so the X gathers mostly hit L1/L2.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
sddmm_vpu_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                 const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ out, long long nel, int kf, int group,
                 int vec4) {
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / group;
  const int64_t wid = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t e = wid * per_warp + lane / group;
  if (wid * per_warp >= nel) return;  // uniform per warp
  const int gl = lane % group;
  const bool valid = e < nel;
  float acc = 0.f;
  if (valid) {
    const float* xr = x + (int64_t)__ldg(rows + e) * kf;
    const float* yr = y + (int64_t)__ldg(cols + e) * kf;
    if (vec4) {
      for (int f = gl * 4; f < kf; f += group * 4) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(xr + f));
        const float4 b = __ldg(reinterpret_cast<const float4*>(yr + f));
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
        acc = fmaf(a.z, b.z, acc);
        acc = fmaf(a.w, b.w, acc);
      }
    } else {
      for (int f = gl; f < kf; f += group) {
        acc = fmaf(__ldg(xr + f), __ldg(yr + f), acc);
      }
    }
  }
  for (int off = group >> 1; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(libra::kFullMask, acc, off, group);
  }
  if (valid && gl == 0) out[e] = acc;
}

}  // namespace

extern "C" int sddmm_vpu_launch(const int* rows, const int* cols,
                                const float* x, const float* y, float* out,
                                long long nel, int kf, int vec4,
                                cudaStream_t stream) {
  // Lanes per element: enough to cover kf in one pass, a power of two.
  const int need = vec4 ? (kf + 3) / 4 : kf;
  int group = 1;
  while (group < 32 && group < need) group <<= 1;
  const long long per_warp = 32 / group;
  const long long warps = (nel + per_warp - 1) / per_warp;
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  sddmm_vpu_kernel<<<blocks, kWarps * 32, 0, stream>>>(rows, cols, x, y, out,
                                                       nel, kf, group, vec4);
  return static_cast<int>(cudaGetLastError());
}
