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
// L2 traffic: every block re-reads the K and V tiles its queries need
// from L2. With 64-query tiles the causal 8192-token layer reads
// 64 * (1 + ... + 128) = 528,384 key rows a head, x 16 heads x 1 KB (K
// and V at D = 256): 8.66 GB a call, 7.2 TB/s at a 1.2 ms kernel, more
// than L2 delivers. 128-query tiles halve it: 128 * (1 + ... + 64) =
// 266,240 rows a head, 4.36 GB.
//
// Design. One block of two consumer warpgroups (256 threads) per
// (128-query tile, batch * query head); warpgroup w owns query rows
// [64w, 64w + 64). The last query tiles, which carry the most causal
// work, start first. The block walks 64-key tiles (the twin's block_k)
// over the union of the two warpgroups' key ranges; a warpgroup skips a
// tile that the causal or window mask empties for all its rows.
// - Shared memory: Q (128 x Dp) and two stages each of K and V
//   (64 x Dp), all in the 128-byte-swizzled K-major layout a wgmma
//   descriptor reads (atoms of 8 rows x 128 bytes, 16-byte chunk c of
//   row r stored at chunk c ^ (r % 8); each 64-column slab contiguous).
//   Dp is the row pitch, D rounded up to whole 64-column slabs (Dp = D
//   at D = 64, 128 and 256; Dp = 128 at D = 112). 768 Dp bytes: 192 KB
//   at D = 256, so one block an SM.
// - Head dim 112 (zamba2): the tiles keep the 128-column pitch, so the
//   second slab holds 48 real columns and 16 that are never loaded. QK^T
//   runs D / 16 = 7 k-steps over the real columns only. PV runs at
//   n = 128 over V's whole pitch: V's 16 pad columns are zeroed once per
//   block (both stages) before the first tile, the loads never write
//   them, and the 16 extra output columns they give are dropped by the
//   epilogue, which stages and stores only D columns. The cost is 16/112
//   more tensor work in PV alone, and no copy of Q, K or V outside the
//   kernel.
// - Loads: all 256 threads issue 16-byte cp.async copies into the
//   swizzled addresses, zero-filling rows past Sq or Sk. Tile i+1's K
//   and V go into the other stage as soon as the barrier that frees it
//   has passed, so they overlap all of tile i. Each thread's copies are
//   waited for and then fenced (fence.proxy.async) before the block
//   barrier: wgmma reads shared memory through the async proxy.
// - S = Q K^T: wgmma m64n64k16, A = Q and B = K both from shared-memory
//   descriptors (D / 16 k-steps): warpgroup products are the path to the
//   card's tensor-core rate, and the tensor cores read Q from shared
//   memory themselves, with no per-warp fragment loads.
// - Softmax on the accumulator fragment (a thread holds rows
//   16 (warp % 4) + lane / 4 and + 8, columns 8j + 2 (lane % 4) + {0, 1};
//   row max and sum over a quad by shuffles) in the log2 domain:
//   ex2.approx with log2 e folded into one multiply per score, and the
//   softcap as c log2(e) tanh.approx(s scale / c): no libm expf/tanhf
//   and no division per score. NVCC_FLAGS keep IEEE math for K1-K4;
//   only these intrinsics are approximate. Masks are applied only on the
//   tiles that the causal diagonal, the window edge or Sk cut for the
//   warpgroup's rows, as two integer compares per score; interior tiles
//   compare nothing. Masked scores take the reference's finite -1e30
//   (never -inf), so a row that meets a fully masked tile first gets
//   exp(0) garbage that the next rescale by exp(-1e30 - m) = 0 wipes,
//   exactly as in the reference; the final division clamps l at 1e-30.
// - O += P V: wgmma m64n{Dp}k16 with A = P from registers (the S
//   accumulator's pairs rounded to V's type, as the reference rounds
//   them) and B = V from shared memory read MN-major (the transpose bit),
//   so V needs no transposed copy. O stays in Dp / 2 fp32 registers a
//   thread (128 at D = 256); with S (32) and P (16) that fits under
//   __launch_bounds__(256, 1)'s 255 without spilling, and Q never
//   leaves shared memory.
// - Epilogue: O times 1 / max(l, 1e-30), staged through Q's shared
//   memory and written with 16-byte stores. With a non-null lse pointer
//   (the training forward) each row's natural-log logsumexp of its
//   scaled, softcapped, masked scores, (m + log2 l) ln 2 from the log2
//   domain's final m and l, goes to an fp32 (B, H, Sq) tensor; a row
//   that saw no unmasked key (m still -1e30) gets +inf, so that a
//   backward's P = exp(s - lse) is 0 there. The scoring path passes null
//   and writes nothing more.
// Left for later: TMA and mbarrier rings, a producer warp with
// setmaxnreg, overlap of one tile's softmax with the next QK^T,
// ping-pong between warpgroups, persistent blocks, packing the query
// heads of one KV head into one block, fp8.
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kBQ = 128;       // query rows per block (64 per warpgroup)
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // two warpgroups
constexpr float kNeg = -1e30f; // the reference's NEG
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Sq) fp32, or null
  int b, sq, sk, h, kv;
  long long q_sb, q_ss, q_sh;  // element strides of Q over (B, S, H)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale, softcap;
  int causal;
  long long window;    // <= 0: no window
  long long q_offset;  // absolute position of query row 0
};

using libra::cp_async16;
using libra::cp_async_commit;
using libra::cp_async_wait;
using libra::smem_u32;

// Makes this thread's shared-memory writes visible to the async proxy
// (wgmma operand reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait (the registers change asynchronously in between).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of 16-byte chunk `cc` of row `r` in a tile of `rows` rows,
// 128-byte swizzle: 64-column slabs of rows x 128 bytes, one after the
// other, and chunk cc % 8 of a row stored at (cc % 8) ^ (r % 8).
__device__ __forceinline__ uint32_t swizzled(int r, int cc, int rows) {
  return (cc >> 3) * rows * 128 + r * 128 + (((cc & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units. For a K-major
// operand the stride (SBO) is 1024 bytes between 8-row groups and LBO is
// unused; for the MN-major V, LBO is the stride between 64-column slabs
// and SBO between groups of 8 keys.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The wgmma instructions, with their long operand lists.
#define K5_ACC8(i)                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),                \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

#define K5_WGMMA_SS64(TY)                                                    \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY                \
      " {"                                                                   \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                             \
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "                   \
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "                   \
      "%30, %31"                                                             \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                     \
      :                                                                      \
      K5_ACC8(0), K5_ACC8(8), K5_ACC8(16), K5_ACC8(24)                       \
      : "l"(da), "l"(db), "r"(scale_d))

#define K5_WGMMA_RS64(TY)                                                    \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY                \
      " {"                                                                   \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                             \
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "                   \
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "                   \
      "%30, %31"                                                             \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                       \
      :                                                                      \
      K5_ACC8(0), K5_ACC8(8), K5_ACC8(16), K5_ACC8(24)                       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define K5_WGMMA_RS128(TY)                                                   \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY               \
      " {"                                                                   \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                             \
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "                   \
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "                   \
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "                   \
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "                   \
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "                   \
      "%60, %61, %62, %63"                                                   \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                       \
      :                                                                      \
      K5_ACC8(0), K5_ACC8(8), K5_ACC8(16), K5_ACC8(24),                      \
      K5_ACC8(32), K5_ACC8(40), K5_ACC8(48), K5_ACC8(56)                     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define K5_WGMMA_RS256(TY)                                                   \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY               \
      " {"                                                                   \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                             \
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "                   \
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "                   \
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "                   \
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "                   \
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "                   \
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "                   \
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "                   \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "                   \
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "                   \
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "         \
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "         \
      "%120, %121, %122, %123, %124, %125, %126, %127"                       \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                  \
      :                                                                      \
      K5_ACC8(0), K5_ACC8(8), K5_ACC8(16), K5_ACC8(24),                      \
      K5_ACC8(32), K5_ACC8(40), K5_ACC8(48), K5_ACC8(56),                    \
      K5_ACC8(64), K5_ACC8(72), K5_ACC8(80), K5_ACC8(88),                    \
      K5_ACC8(96), K5_ACC8(104), K5_ACC8(112), K5_ACC8(120)                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// S (64 x 64, fp32) = [S +] A B^T over one k16 step, A (64 x 16) and
// B (64 x 16) K-major in shared memory; scale_d = 0 starts S afresh.
template <typename T>
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (std::is_same_v<T, __half>) {
    K5_WGMMA_SS64("f16");
  } else {
    K5_WGMMA_SS64("bf16");
  }
}

// O (64 x N, fp32) += A B over one k16 step, A (64 x 16) in registers
// (each warp's 16 rows in the m16n8k16 A-fragment layout), B (16 x N) in
// shared memory, MN-major.
template <typename T, int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  constexpr bool kHalf = std::is_same_v<T, __half>;
  if constexpr (N == 64) {
    if constexpr (kHalf) K5_WGMMA_RS64("f16"); else K5_WGMMA_RS64("bf16");
  } else if constexpr (N == 128) {
    if constexpr (kHalf) K5_WGMMA_RS128("f16"); else K5_WGMMA_RS128("bf16");
  } else {
    static_assert(N == 256, "tile pitches 64, 128, 256");
    if constexpr (kHalf) K5_WGMMA_RS256("f16"); else K5_WGMMA_RS256("bf16");
  }
}

#undef K5_WGMMA_SS64
#undef K5_WGMMA_RS64
#undef K5_WGMMA_RS128
#undef K5_WGMMA_RS256
#undef K5_ACC8

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

// Copy rows [row0, row0 + ROWS) of one head into the swizzled tile at
// `s`; rows at or past `nrows` are zero-filled.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t s, const T* base,
                                          long long row_stride, int row0,
                                          int nrows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    const bool ok = row0 + r < nrows;
    const T* src = ok ? base + (long long)(row0 + r) * row_stride + cc * 8
                      : base;
    cp_async16(s + swizzled(r, cc, ROWS), src, ok);
  }
}

// Row pitch of the shared-memory tiles: D rounded up to whole 64-column
// slabs of the 128-byte swizzle.
template <int D>
constexpr int kPitch = (D + 63) / 64 * 64;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const Params p) {
  constexpr int kDp = kPitch<D>;
  constexpr int kTileBytes = kBK * kDp * 2;  // one K or V stage
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // Swizzle atoms must sit on 1024-byte boundaries (the launch adds the
  // slack).
  const uint32_t s_base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = s_base;
  const uint32_t sK = sQ + 2 * kTileBytes;  // two stages
  const uint32_t sV = sK + 2 * kTileBytes;  // two stages
  unsigned char* sQ_ptr = smem_raw + (sQ - smem_u32(smem_raw));

  const int wg = threadIdx.x >> 7;          // warpgroup: rows [64 wg, +64)
  const int warp = (threadIdx.x >> 5) & 3;  // warp within the warpgroup
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // Blocks are numbered so that the last query tiles, which carry the
  // most causal work, start first on the whole card.
  const int n_qt = gridDim.x, n_bh = gridDim.y;
  const int id = blockIdx.y * n_qt + blockIdx.x;
  const int q0 = (n_qt - 1 - id / n_bh) * kBQ;
  const int bh = id % n_bh;
  const int bi = bh / p.h, hi = bh % p.h;
  const int kvh = hi / (p.h / p.kv);
  const T* qb = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + bi * p.v_sb + kvh * p.v_sh;

  // Key tiles that hold an unmasked key for some query of the block.
  const long long qfirst = p.q_offset + q0;
  const long long qlast = p.q_offset + min(q0 + kBQ, p.sq) - 1;
  long long kend = p.sk;
  if (p.causal) kend = min(kend, qlast + 1);
  long long kbeg = 0;
  if (p.window > 0) kbeg = max(0LL, qfirst - p.window + 1);
  const int t_begin = static_cast<int>(kbeg / kBK);
  const int t_end = kend > 0 ? static_cast<int>((kend + kBK - 1) / kBK) : 0;

  // The same for this warpgroup's rows [r_lo, r_hi), and the bounds that
  // say whether a tile needs masks at all.
  const int r_lo = q0 + 64 * wg, r_hi = min(r_lo + 64, p.sq);
  const bool wg_rows = r_lo < p.sq;
  const long long wg_pf = p.q_offset + r_lo, wg_pl = p.q_offset + r_hi - 1;
  long long wg_kend = p.sk;
  if (p.causal) wg_kend = min(wg_kend, wg_pl + 1);
  const long long wg_kbeg = p.window > 0 ? wg_pf - p.window + 1 : 0;

  // This thread's two rows: the keys [lo, hi) each may see.
  long long row_lo[2], row_hi[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long qpos =
        p.q_offset + r_lo + warp * 16 + g + 8 * half;
    row_hi[half] = p.causal ? min((long long)p.sk, qpos + 1) : p.sk;
    row_lo[half] = p.window > 0 ? qpos - p.window + 1 : 0;
  }

  if constexpr (kDp != D) {
    // V's pad columns [D, kDp) in both stages: zero for the whole kernel
    // (load_tile writes only the D real columns), so PV's extra output
    // columns, which the epilogue drops, are 0.
    constexpr int kPad = (kDp - D) / 8;  // 16-byte chunks a row
    for (int c = threadIdx.x; c < 2 * kBK * kPad; c += kThreads) {
      const int st = c / (kBK * kPad), r = (c / kPad) % kBK;
      const int cc = D / 8 + c % kPad;
      *reinterpret_cast<uint4*>(smem_raw + (sV - smem_u32(smem_raw)) +
                                st * kTileBytes + swizzled(r, cc, kBK)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  load_tile<T, D, kBQ>(sQ, qb, p.q_ss, q0, p.sq);
  if (t_begin < t_end) {
    load_tile<T, D, kBK>(sK, kb, p.k_ss, t_begin * kBK, p.sk);
    load_tile<T, D, kBK>(sV, vb, p.v_ss, t_begin * kBK, p.sk);
  }
  cp_async_commit();

  // Descriptors: this warpgroup's 64 Q rows; K and V at stage 0.
  const uint64_t dq = make_desc(sQ + wg * 64 * 128, 16, 1024);
  const uint64_t dk = make_desc(sK, 16, 1024);
  const uint64_t dv = make_desc(sV, kBK * 128, 1024);

  float o[kDp / 2];
#pragma unroll
  for (int i = 0; i < kDp / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  // Scores go to the log2 domain: x = s * scale * log2 e, or with a
  // softcap c, x = c log2 e * tanh(s * scale / c).
  const bool capped = p.softcap != 0.f;
  const float mul = capped ? p.scale / p.softcap : p.scale * kLog2e;
  const float cap2 = p.softcap * kLog2e;

  for (int it = t_begin; it < t_end; ++it) {
    const int st = (it - t_begin) & 1;
    if (it + 1 < t_end) {
      load_tile<T, D, kBK>(sK + (st ^ 1) * kTileBytes, kb, p.k_ss,
                           (it + 1) * kBK, p.sk);
      load_tile<T, D, kBK>(sV + (st ^ 1) * kTileBytes, vb, p.v_ss,
                           (it + 1) * kBK, p.sk);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait<1>();  // Q and this tile's K and V have landed
    fence_proxy_async();
    __syncthreads();

    const long long k0 = (long long)it * kBK;
    if (wg_rows && k0 < wg_kend && k0 + kBK > wg_kbeg) {
      const bool masked = k0 + kBK > p.sk ||
                          (p.causal && k0 + kBK - 1 > wg_pf) ||
                          (p.window > 0 && k0 <= wg_pl - p.window);
      const uint64_t st_off = (st * kTileBytes) >> 4;

      // S = Q K^T for this warpgroup's 64 rows and the tile's 64 keys.
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // k-step kk: 64-column slab kk / 4, 32 bytes per step inside it.
        const uint64_t off_q = ((kk >> 2) * kBQ * 128 + (kk & 3) * 32) >> 4;
        const uint64_t off_k = ((kk >> 2) * kBK * 128 + (kk & 3) * 32) >> 4;
        wgmma_qk<T>(s, dq + off_q, dk + st_off + off_k, kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      // Scale and softcap (log2 domain), masks on cut tiles only.
      if (capped) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = cap2 * tanh_approx(s[i] * mul);
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] *= mul;
      }
      if (masked) {
        int c_lo[2], c_hi[2];  // the row's visible columns of this tile
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          c_lo[half] = static_cast<int>(
              min(max(row_lo[half] - k0, 0LL), (long long)kBK));
          c_hi[half] = static_cast<int>(
              min(max(row_hi[half] - k0, 0LL), (long long)kBK));
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int half = (i >> 1) & 1;
          const int c = (i >> 2) * 8 + 2 * t + (i & 1);
          s[i] = (c >= c_lo[half] && c < c_hi[half]) ? s[i] : kNeg;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mx[half] = fmaxf(mx[half],
                         __shfl_xor_sync(libra::kFullMask, mx[half], 1));
        mx[half] = fmaxf(mx[half],
                         __shfl_xor_sync(libra::kFullMask, mx[half], 2));
        alpha[half] = ex2(m[half] - mx[half]);
        m[half] = mx[half];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int half = (i >> 1) & 1;
        s[i] = ex2(s[i] - mx[half]);
        rs[half] += s[i];
      }
      // l is kept per thread (its 16 columns) and summed over the quad at
      // the end; alpha is the same across the quad.
      l[0] = l[0] * alpha[0] + rs[0];
      l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
      for (int j = 0; j < kDp / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }

      // O += P V: P (64 x 64) from registers, 4 k-steps of 16 keys.
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        a[kk][0] = pack2<T>(s[8 * kk], s[8 * kk + 1]);
        a[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
        a[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
        a[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
      }
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_pv<T, kDp>(o, a[kk], dv + st_off + ((kk * 16 * 128) >> 4));
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
    }
    __syncthreads();  // both warpgroups are done with this stage
  }
  cp_async_wait<0>();
  // Every thread's copies (Q's rows among them) have landed before any
  // warp stages O there, even when no key tile was visited.
  __syncthreads();

  // O / max(l, 1e-30), staged through sQ in the swizzled layout (free of
  // bank conflicts) and written as 16-byte stores.
  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(libra::kFullMask, l[half], 1);
    l[half] += __shfl_xor_sync(libra::kFullMask, l[half], 2);
    inv[half] = 1.f / fmaxf(l[half], 1e-30f);
  }
  const int row = 64 * wg + warp * 16 + g;
  if (p.lse != nullptr && t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qrow = q0 + row + 8 * half;
      if (qrow < p.sq) {
        p.lse[(long long)bh * p.sq + qrow] =
            m[half] == kNeg ? __int_as_float(0x7f800000)  // +inf
                            : (m[half] + log2f(l[half])) * kLn2;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(sQ_ptr + swizzled(row, j, kBQ) + 4 * t) =
        pack2<T>(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
    *reinterpret_cast<uint32_t*>(sQ_ptr + swizzled(row + 8, j, kBQ) +
                                 4 * t) =
        pack2<T>(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
  }
  __syncthreads();
  T* ob = static_cast<T*>(p.o);
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kBQ * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    const int qrow = q0 + r;
    if (qrow < p.sq) {
      const long long off =
          ((long long)(bi * (long long)p.sq + qrow) * p.h + hi) * D + cc * 8;
      *reinterpret_cast<uint4*>(ob + off) =
          *reinterpret_cast<const uint4*>(sQ_ptr + swizzled(r, cc, kBQ));
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  // Q, two K stages, two V stages at the row pitch, and slack to align
  // them to 1024 bytes.
  const int smem = (kBQ + 4 * kBK) * kPitch<D> * 2 + 1024;
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
    case 112:
      return launch<T, 112>(p, stream);
    case 128:
      return launch<T, 128>(p, stream);
    case 256:
      return launch<T, 256>(p, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float16. Output o is (B, Sq, H, D) contiguous;
// lse, when not null, (B, H, Sq) fp32 contiguous.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int b, int sq,
    int sk, int h, int kv, int d, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, float scale,
    float softcap, int causal, long long window, long long q_offset,
    int dtype, cudaStream_t stream) {
  const Params p{q,    k,    v,    o,    lse,  b,     sq,      sk,
                 h,    kv,   q_sb, q_ss, q_sh, k_sb,  k_ss,    k_sh,
                 v_sb, v_ss, v_sh, scale, softcap, causal, window,
                 q_offset};
  if (sq == 0 || b * h == 0) return 0;
  return static_cast<int>(dtype == 0 ? dispatch<__nv_bfloat16>(p, d, stream)
                                     : dispatch<__half>(p, d, stream));
}
