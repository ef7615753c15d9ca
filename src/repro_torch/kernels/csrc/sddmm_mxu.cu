// K3 - SDDMM Tensor Core stream.
//
// Replaces the TPU kernel sddmm_mxu in src/repro/kernels/sddmm_mxu.py
// (function sddmm_mxu, body _kernel): per condensed block or §4.3 segment
// s, S = X[8*window[s] : 8*window[s]+8] . Y[cols[s]]^T (8 x bk), then
// Bit-Decoding: row r of column j is kept iff bit r of bitmap[s, j] is set.
// Output (nb, 8, bk).
//
// Bound on H100: bytes. Each condensed column gathers one Y row (4 kf
// bytes) for 16 kf flops, about 4 flop/byte against a TF32 ridge near
// 150; the compulsory traffic is cols + bitmap + window + X + Y once + the
// scores.
//
// Design: mma.sync m16n8k8 TF32 on S^T (bk x 8) = Y[cols] (bk x kf) .
// X_win^T (kf x 8): the window is the n=8 side, 16 condensed columns the
// m=16 side, and kf is walked in k=8 steps. One thread block owns one
// segment: it stages the window's 8 X rows in shared memory once (rows
// past the end of X read as zero, so X needs no padding), and each warp
// walks 16-column slices of the segment, reading its A fragments straight
// from the gathered Y rows (each 32-byte sector is used whole across the
// two fragment halves). The bitmap test runs in registers before the
// store; every output element is written, so the output needs no zeroing.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(128)
sddmm_mxu_kernel(const int* __restrict__ cols, const int* __restrict__ bitmap,
                 const int* __restrict__ window, const float* __restrict__ x,
                 const float* __restrict__ y, float* __restrict__ out, int bk,
                 int kf, long long mrows) {
  extern __shared__ float sx[];  // [kWindow][pitch]
  const int kf8 = (kf + 7) & ~7;
  const int pitch = kf8 + 4;     // conflict-free B-fragment reads
  const int64_t seg = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  const int64_t xrow0 = (int64_t)window[seg] * libra::kWindow;
  for (int i = tid; i < libra::kWindow * kf8; i += blockDim.x) {
    const int r = i / kf8, f = i % kf8;
    sx[r * pitch + f] = (f < kf && xrow0 + r < mrows)
                            ? __ldg(x + (xrow0 + r) * kf + f)
                            : 0.f;
  }
  __syncthreads();

  const int* seg_cols = cols + seg * bk;
  const int* seg_bits = bitmap + seg * bk;
  float* seg_out = out + seg * libra::kWindow * bk;

  for (int j0 = warp * 16; j0 < bk; j0 += nwarps * 16) {
    const int ja = j0 + g, jb = j0 + g + 8;
    const bool va = ja < bk, vb = jb < bk;
    const float* ya = y + (int64_t)(va ? __ldg(seg_cols + ja) : 0) * kf;
    const float* yb = y + (int64_t)(vb ? __ldg(seg_cols + jb) : 0) * kf;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int f0 = 0; f0 < kf8; f0 += 8) {
      const int fa = f0 + t, fb = f0 + t + 4;
      const uint32_t af[4] = {
          libra::to_tf32(va && fa < kf ? __ldg(ya + fa) : 0.f),
          libra::to_tf32(vb && fa < kf ? __ldg(yb + fa) : 0.f),
          libra::to_tf32(va && fb < kf ? __ldg(ya + fb) : 0.f),
          libra::to_tf32(vb && fb < kf ? __ldg(yb + fb) : 0.f)};
      const uint32_t bf[2] = {libra::to_tf32(sx[g * pitch + fa]),
                              libra::to_tf32(sx[g * pitch + fb])};
      libra::mma_m16n8k8_tf32(acc, af, bf);
    }
    // acc[0] = S^T[ja][2t], acc[1] = S^T[ja][2t+1], acc[2..3]: column jb.
    const int r = 2 * t;
    if (va) {
      const int bits = __ldg(seg_bits + ja);
      seg_out[(int64_t)r * bk + ja] = ((bits >> r) & 1) ? acc[0] : 0.f;
      seg_out[(int64_t)(r + 1) * bk + ja] =
          ((bits >> (r + 1)) & 1) ? acc[1] : 0.f;
    }
    if (vb) {
      const int bits = __ldg(seg_bits + jb);
      seg_out[(int64_t)r * bk + jb] = ((bits >> r) & 1) ? acc[2] : 0.f;
      seg_out[(int64_t)(r + 1) * bk + jb] =
          ((bits >> (r + 1)) & 1) ? acc[3] : 0.f;
    }
  }
}

}  // namespace

extern "C" int sddmm_mxu_launch(const int* cols, const int* bitmap,
                                const int* window, const float* x,
                                const float* y, float* out, long long nb,
                                int bk, int kf, long long mrows,
                                cudaStream_t stream) {
  const int warps = min(4, (bk + 15) / 16);
  const size_t smem =
      sizeof(float) * libra::kWindow * (((kf + 7) & ~7) + 4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sddmm_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sddmm_mxu_kernel<<<static_cast<unsigned>(nb), warps * 32, smem, stream>>>(
      cols, bitmap, window, x, y, out, bk, kf, mrows);
  return static_cast<int>(cudaGetLastError());
}
