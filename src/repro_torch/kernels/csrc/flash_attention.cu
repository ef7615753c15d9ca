// K5 - fused attention forward (flash attention) with an online softmax.
//
// Replaces the TPU kernel flash_attention_fused in
// src/repro/kernels/flash_attention.py (function flash_attention_fused,
// body _kernel): O = softmax(mask(softcap(Q K^T / sqrt(D)))) V per query
// head, with GQA (query head h reads KV head h / (H / KV)), causal and
// sliding-window masks and an optional logit softcap c * tanh(s / c).
//
// Bound on H100: operations. Each unmasked (query, key) pair costs
// 4 D flops on the bf16/fp16 Tensor Cores (QK^T and PV); at gemma2's
// 8192-token global layer that is 550 GFLOP against 201 MB of Q, K, V
// and O, far above the card's 295 flops per byte.
//
// Design (a first, simple version): one block of 4 warps per (64-query
// tile, batch * query head). Q stays in shared memory; the block walks
// 64-key tiles of K and V, skipping tiles that the causal or window mask
// leaves empty for every query of the tile. V's load overlaps QK^T and
// the next K's load overlaps PV (cp.async, two commit groups per tile).
// Each warp owns 16 query rows: S = Q K^T and O += P V run on
// mma.sync m16n8k16 with fp32 accumulators; P goes from the S
// accumulators to A fragments in registers, cast to V's type as the
// reference casts it. Rows are padded by 16 bytes in shared memory so
// ldmatrix is free of bank conflicts. Masked scores take the finite
// -1e30 of the reference (never -inf), so a row that meets a fully
// masked tile first gets exp(0) garbage that the next rescale by
// exp(-1e30 - m) = 0 wipes, exactly as in the reference. The final
// division clamps l at 1e-30. Shared memory is 3 * 64 * (D + 8) * 2
// bytes (99 KB at D = 256), above the 48 KB static limit, so it is
// dynamic and opted in with cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block (16 per warp)
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 4 warps
constexpr float kNeg = -1e30f; // the reference's NEG

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, sq, sk, h, kv;
  long long q_sb, q_ss, q_sh;  // element strides of Q over (B, S, H)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale, softcap;
  int causal;
  long long window;    // <= 0: no window
  long long q_offset;  // absolute position of query row 0
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D (16x8, fp32) += A (16x16, row-major) * B (16x8, col-major). With
// g = lane / 4 and t = lane % 4, each register holds two elements:
//   a[0] = A[g][2t:2t+2]   a[1] = A[g+8][2t:2t+2]
//   a[2] = A[g][2t+8:+2]   a[3] = A[g+8][2t+8:+2]
//   b0 = B[2t:2t+2][g]     b1 = B[2t+8:2t+10][g]
//   d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to T, `lo` in the low half (the lower column).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + 64) of one head into shared memory (pitch
// D + 8); rows at or past `nrows` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* s, const T* base,
                                          long long row_stride, int row0,
                                          int nrows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int c = threadIdx.x; c < 64 * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    const bool ok = row0 + r < nrows;
    const T* src = ok ? base + (long long)(row0 + r) * row_stride + cc * 8
                      : base;
    cp_async16(smem_u32(s + r * (D + 8) + cc * 8), src, ok);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const Params p) {
  constexpr int P = D + 8;  // shared-memory row pitch, elements
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kBQ * P;
  T* sV = sK + kBK * P;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // The last query tiles carry the most causal work: start them first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int bi = blockIdx.y / p.h, hi = blockIdx.y % p.h;
  const int kvh = hi / (p.h / p.kv);
  const T* qb = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + bi * p.v_sb + kvh * p.v_sh;

  // Key tiles that hold at least one unmasked key for some query here.
  const long long qfirst = p.q_offset + q0;
  const long long qlast = p.q_offset + min(q0 + kBQ, p.sq) - 1;
  long long kend = p.sk;
  if (p.causal) kend = min(kend, qlast + 1);
  long long kbeg = 0;
  if (p.window > 0) kbeg = max(0LL, qfirst - p.window + 1);
  const int t_begin = static_cast<int>(kbeg / kBK);
  const int t_end = kend > 0 ? static_cast<int>((kend + kBK - 1) / kBK) : 0;

  load_tile<T, D>(sQ, qb, p.q_ss, q0, p.sq);
  if (t_begin < t_end) load_tile<T, D>(sK, kb, p.k_ss, t_begin * kBK, p.sk);
  cp_async_commit();

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int row_base = warp * 16;
  const long long qpos[2] = {p.q_offset + q0 + row_base + g,
                             p.q_offset + q0 + row_base + g + 8};
  const int j8 = lane >> 3, r8 = lane & 7;  // ldmatrix: matrix, row

  for (int it = t_begin; it < t_end; ++it) {
    const int k0 = it * kBK;
    load_tile<T, D>(sV, vb, p.v_ss, k0, p.sk);
    cp_async_commit();
    cp_async_wait<1>();  // Q and this K have landed; V may be in flight
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and 64 keys (8 n-tiles of 8).
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_u32(sQ + (row_base + (lane & 15)) * P + kk * 16 +
                              (lane >> 4) * 8));
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, smem_u32(sK + (nn * 16 + r8 + (j8 >> 1) * 8) * P +
                                  kk * 16 + (j8 & 1) * 8));
        mma16816<T>(s[2 * nn], a, bfr[0], bfr[1]);
        mma16816<T>(s[2 * nn + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // every warp is done with sK
    if (it + 1 < t_end) load_tile<T, D>(sK, kb, p.k_ss, k0 + kBK, p.sk);
    cp_async_commit();  // possibly empty: keeps the group count uniform

    // Scale, softcap, mask; online softmax over this tile.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const long long kpos = k0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * p.scale;
        if (p.softcap != 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = kpos < p.sk;
        if (p.causal) ok = ok && kpos <= qpos[half];
        if (p.window > 0) ok = ok && kpos > qpos[half] - p.window;
        x = ok ? x : kNeg;
        s[j][e] = x;
        mx[half] = fmaxf(mx[half], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half],
                       __shfl_xor_sync(libra::kFullMask, mx[half], 1));
      mx[half] = fmaxf(mx[half],
                       __shfl_xor_sync(libra::kFullMask, mx[half], 2));
      alpha[half] = expf(m[half] - mx[half]);
      m[half] = mx[half];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = expf(s[j][e] - mx[e >> 1]);
        s[j][e] = pv;
        rs[e >> 1] += pv;
      }
    }
    // l is kept per thread (its 16 columns) and summed over the quad at
    // the end; alpha is the same across the quad.
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    cp_async_wait<1>();  // V has landed; the next K may be in flight
    __syncthreads();
    // O += P V: P (16 x 64) from registers, V (64 x D) via ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a[0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nn = 0; nn < D / 16; ++nn) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, smem_u32(sV + (kk * 16 + r8 + (j8 & 1) * 8) * P +
                                        nn * 16 + (j8 >> 1) * 8));
        mma16816<T>(o[2 * nn], a, bfr[0], bfr[1]);
        mma16816<T>(o[2 * nn + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // every warp is done with sV
  }
  cp_async_wait<0>();
  // Every thread's copies (this warp's sQ rows among them) have landed
  // before any warp stages O there, even when no key tile was visited.
  __syncthreads();

  // O / max(l, 1e-30), staged through this warp's own rows of sQ and
  // written as 16-byte stores.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(libra::kFullMask, l[half], 1);
    l[half] += __shfl_xor_sync(libra::kFullMask, l[half], 2);
    l[half] = fmaxf(l[half], 1e-30f);
  }
  T* sO = sQ;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(sO + (row_base + g) * P + col) =
        pack2<T>(o[n][0] / l[0], o[n][1] / l[0]);
    *reinterpret_cast<uint32_t*>(sO + (row_base + g + 8) * P + col) =
        pack2<T>(o[n][2] / l[1], o[n][3] / l[1]);
  }
  __syncwarp();
  T* ob = static_cast<T*>(p.o);
  constexpr int kChunks = D / 8;
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks, cc = c % kChunks;
    const int qrow = q0 + row_base + r;
    if (qrow < p.sq) {
      const long long off =
          ((long long)(bi * (long long)p.sq + qrow) * p.h + hi) * D + cc * 8;
      *reinterpret_cast<uint4*>(ob + off) =
          *reinterpret_cast<const uint4*>(sO + (row_base + r) * P + cc * 8);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem = 3 * 64 * (D + 8) * static_cast<int>(sizeof(T));
  static bool configured = false;  // once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.b * p.h);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(p, stream);
    case 128:
      return launch<T, 128>(p, stream);
    case 256:
      return launch<T, 256>(p, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float16. Output o is (B, Sq, H, D) contiguous.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int b, int sq,
    int sk, int h, int kv, int d, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, float scale,
    float softcap, int causal, long long window, long long q_offset,
    int dtype, cudaStream_t stream) {
  const Params p{q,    k,    v,    o,    b,    sq,    sk,      h,
                 kv,   q_sb, q_ss, q_sh, k_sb, k_ss,  k_sh,    v_sb,
                 v_ss, v_sh, scale, softcap, causal, window, q_offset};
  if (sq == 0 || b * h == 0) return 0;
  return static_cast<int>(dtype == 0 ? dispatch<__nv_bfloat16>(p, d, stream)
                                     : dispatch<__half>(p, d, stream));
}
