// K3 - SDDMM Tensor Core stream.
//
// Replaces the TPU kernel sddmm_mxu in src/repro/kernels/sddmm_mxu.py
// (function sddmm_mxu, body _kernel): per condensed block or §4.3 segment
// s, S = X[8*window[s] : 8*window[s]+8] . Y[cols[s]]^T (8 x bk), then
// Bit-Decoding: row r of column j is kept iff bit r of bitmap[s, j] is set.
// With a position table pos (nb, 8, bk), each kept score whose position
// is not -1 is stored at out[pos[s][r][j]], its canonical CSR position:
// the plan gives every position one owner, so nothing adds and padding
// stores nothing. Without one, the output is staged (nb, 8, bk), 0 where
// nothing is kept: the identity-position case of the same epilogue.
//
// Bound on H100: bytes. Each condensed column gathers one Y row (4 kf
// bytes) for 16 kf flops, about 4 flop/byte against a TF32 ridge near
// 150; the compulsory traffic is the real columns' (column, bitmap)
// pairs, the window ids, X and Y once and the scores once. On a graph Y
// is larger than the 50 MB L2, and a graph's segments hold about one
// kept score per column: the kernel does the CUDA-core stream's gathers.
//
// Design: mma.sync m16n8k8 TF32 on S^T (bk x 8) = Y[cols] (bk x kf) .
// X_win^T (kf x 8): the window is the n=8 side, 16 condensed columns the
// m=16 side, and kf is walked in k=8 steps.
// - Bitmap first. A column whose bitmap is 0 (padding, the dummy segment
//   of an empty path) gathers nothing and stores 0, as the twin's
//   where(mask, s, 0) does whatever its Y row holds; a 16-column tile
//   with no kept score runs no mma.
// - Feature slices. kf is cut into slices of kF features (16 to 128),
//   chosen by the caller so that the slice of every Y row fits most of
//   the L2; each slice is one launch on the stream. The first stores, the
//   later ones add their partial dot products to the kept scores in slice
//   order: deterministic, and exact on integers.
// - Each warp walks a contiguous run of chunks of the table, one run a
//   warp and one wave of warps. A chunk is 32 columns at slices of up to
//   64 features and 16 at 128: 8 KB of Y rows. Two stages a warp in
//   shared memory, filled by cp.async (16 bytes a lane through L2 only, a
//   row's slice loaded by neighbouring lanes; 4 bytes when kf % 4 != 0
//   or an operand is unaligned): the next chunk's Y rows are in flight
//   while the current chunk's mmas run. A stage also receives the
//   window's 8 X rows when the window changes from the chunk before
//   (consecutive chunks mostly share one), and the chunk's 8 x kCols
//   words of a table laid out as the scores: its positions when it
//   stores canonically, else, in a later slice, its earlier partial
//   scores. The next chunk's columns, bitmaps and window are loaded into
//   registers one chunk ahead of their copies.
// - Canonical stores over several slices: the slices before the last
//   run staged into a scratch table, and the last adds their partial of
//   each kept score (loaded ahead of its mmas) and stores the sum. Adding
//   into out[pos] in every slice instead (one owner a position, so no
//   atomics either) was 7% faster at two slices and 13-19% slower at
//   four, on the graph's plan at kf = 128 and 256.
// - The A/B (tools/ab_mxu_kernels.py) set that shape: loads on the
//   critical path, a third stage and 16 KB chunks were each slower.
//   Folding every gather into L2 gains little: latency, not the L2's
//   rate, sets the pace.
// - The k index of the mma is permuted (lane t takes features 4t..4t+3 of
//   each 16), so each A fragment pair and each B fragment is one 16-byte
//   shared-memory read, at a row pitch that keeps a quarter warp on
//   distinct banks.
// - Plain stores for the scores: a later slice reads them back, and the
//   A/B found them 1-2% faster than streaming ones even with one slice.
// - The batch's outputs sit nnz apart (canonical) or nb * 8 * bk apart
//   (staged); the position table is shared by the batch or each
//   element's own, as the other tables.
// - A batch axis (a panel stack, a partition's shards): blockIdx.y picks
//   the batch element, whose operand bases the launcher computes from the
//   batch strides (0 shares an operand) into the kernel's parameter
//   table (libra::kMaxBatch). Each element gets the single launch's wave
//   of warps and chunk runs, so its arithmetic, and its output, are the
//   single launch's; the single launch is the batch of one.
#include <atomic>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;   // warps a block
constexpr int kMaxDevices = 64;
constexpr int kStages = 2;  // chunks a warp has staged or in flight

// Columns a chunk (16-column mma tiles): 8 KB of staged Y rows at the
// main path's slices, 32 rows of 64 features or 16 of 128.
template <int kF>
__host__ __device__ constexpr int chunk_cols() {
  return kF >= 128 ? 16 : 32;
}

// Floats between staged rows: the 16-byte reads of rows g and g + 1 by a
// quarter warp fall on distinct bank groups when the pitch is 16 mod 32.
template <int kF>
__host__ __device__ constexpr int row_pitch() {
  return kF % 32 == 0 ? kF + 16 : kF;
}

// One stage: kCols Y rows and 8 X rows of kF features, 8 rows of kCols
// positions or earlier scores, then the chunk's bitmap words, window,
// first column and segment (8-byte aligned: kCols is even).
template <int kF>
__host__ __device__ constexpr int stage_floats() {
  constexpr int kCols = chunk_cols<kF>();
  return (kCols + libra::kWindow) * row_pitch<kF>() +
         libra::kWindow * kCols + kCols + 4;
}

// What issue() needs of one chunk, loaded a chunk ahead.
struct Idx {
  long long seg;  // segment (table row)
  int j0;         // first column of the chunk
  int col, bits;  // this lane's column and bitmap (lanes < chunk_cols)
  int win;        // the segment's window
};

template <int kF>
constexpr size_t smem_bytes() {
  // Stages start on 16-byte boundaries.
  return sizeof(float) * kWarps * kStages * ((stage_floats<kF>() + 3) & ~3);
}

// Issue one copy of kV floats (16 or 4 bytes); ok = false zero-fills.
template <bool kVec4>
__device__ __forceinline__ void copy(float* dst, const float* src, bool ok,
                                     const float* any) {
  if constexpr (kVec4) {
    libra::cp_async16(libra::smem_u32(dst), ok ? src : any, ok);
  } else {
    libra::cp_async4(libra::smem_u32(dst), ok ? src : any, ok);
  }
}

// The operands of the batch elements of one launch.
struct Operands {
  const int* cols[libra::kMaxBatch];
  const int* bitmap[libra::kMaxBatch];
  const int* window[libra::kMaxBatch];
  const int* pos[libra::kMaxBatch];  // null: staged output
  const float* x[libra::kMaxBatch];
  const float* y[libra::kMaxBatch];
  float* out[libra::kMaxBatch];
};

template <int kF, bool kVec4>
__global__ void __launch_bounds__(kWarps * 32)
sddmm_mxu_kernel(const __grid_constant__ Operands ops, long long nchunks,
                 int chunks_per_seg, int bk, int kf, long long mrows, int f0,
                 int accumulate, int tab16, const float* staged,
                 long long staged_bs, long long per_warp) {
  extern __shared__ __align__(16) float smem[];
  const int z = blockIdx.y;  // the batch element
  const int* __restrict__ cols = ops.cols[z];
  const int* __restrict__ bitmap = ops.bitmap[z];
  const int* __restrict__ window = ops.window[z];
  const int* __restrict__ pos = ops.pos[z];
  const float* __restrict__ x = ops.x[z];
  const float* __restrict__ y = ops.y[z];
  float* __restrict__ out = ops.out[z];
  // Canonical stores after earlier slices: their staged partial scores.
  const float* __restrict__ old =
      staged == nullptr ? nullptr : staged + z * staged_bs;
  // The table a stage copies: positions, or the staged earlier scores.
  const int* tab =
      pos != nullptr ? pos
                     : (accumulate ? reinterpret_cast<const int*>(out)
                                   : nullptr);
  constexpr int kCols = chunk_cols<kF>();
  constexpr int kTiles = kCols / 16;
  constexpr int kPitch = row_pitch<kF>();
  constexpr int kStage = (stage_floats<kF>() + 3) & ~3;
  constexpr int kXRows = kCols * kPitch;          // offset of the X rows
  constexpr int kTab = kXRows + libra::kWindow * kPitch;  // table words
  constexpr int kMeta = kTab + libra::kWindow * kCols;    // bitmaps, window
  constexpr int kV = kVec4 ? 4 : 1;  // floats a copy
  constexpr int kPieces = kF / kV;   // copies a row
  static_assert((kCols * kPieces) % 32 == 0, "whole warp passes");
  static_assert((libra::kWindow * kPieces) % 32 == 0, "whole warp passes");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* ring = smem + warp * kStages * kStage;
  const long long first = ((long long)blockIdx.x * kWarps + warp) * per_warp;
  if (first >= nchunks) return;  // warp-uniform; the block has no barrier
  const int count = static_cast<int>(min(per_warp, nchunks - first));

  // The chunk fetched next: its segment and first column, advanced one
  // chunk a fetch (fetches come in chunk order).
  long long f_seg = first / chunks_per_seg;
  int f_j0 = static_cast<int>(first - f_seg * chunks_per_seg) * kCols;
  // Load chunk i's column and bitmap (lane j < kCols holds column j0 + j)
  // and its window: used by issue(i) one iteration later.
  auto fetch = [&](int i, Idx& d) {
    d.seg = f_seg, d.j0 = f_j0, d.col = 0, d.bits = 0, d.win = -1;
    if (i >= count) return;
    const int j = f_j0 + lane;
    if (lane < kCols && j < bk) {
      d.col = __ldcs(cols + f_seg * bk + j);
      d.bits = __ldcs(bitmap + f_seg * bk + j);
    }
    d.win = __ldg(window + f_seg);
    f_j0 += kCols;
    if (f_j0 >= bk) f_j0 = 0, ++f_seg;
  };
  // Stage chunk i (an empty group past the run's end, so that every
  // iteration waits on the same number of groups). new_win: its window
  // differs from the chunk staged before it.
  auto issue = [&](int i, const Idx& d, bool new_win) {
    if (i < count) {
      float* st = ring + (i % kStages) * kStage;
      int* meta = reinterpret_cast<int*>(st + kMeta);
      if (lane < kCols) meta[lane] = d.bits;
      if (lane == 0) {
        meta[kCols] = d.win;
        meta[kCols + 1] = d.j0;
        reinterpret_cast<long long*>(meta + kCols + 2)[0] = d.seg;
      }
      const unsigned live = __ballot_sync(libra::kFullMask, d.bits != 0);
      if (live) {
#pragma unroll 4
        for (int p = lane; p < kCols * kPieces; p += 32) {
          const int r = p / kPieces, q = p % kPieces;
          const int cr = __shfl_sync(libra::kFullMask, d.col, r);
          if (!((live >> r) & 1)) continue;  // scored 0 whatever it holds
          const int f = f0 + q * kV;
          copy<kVec4>(st + r * kPitch + q * kV,
                      y + static_cast<int64_t>(cr) * kf + f, f < kf, y);
        }
      }
      if (new_win) {  // rows past mrows and features past kf read as zero
#pragma unroll 4
        for (int p = lane; p < libra::kWindow * kPieces; p += 32) {
          const int r = p / kPieces, q = p % kPieces;
          const long long row =
              static_cast<long long>(d.win) * libra::kWindow + r;
          const int f = f0 + q * kV;
          copy<kVec4>(st + kXRows + r * kPitch + q * kV, x + row * kf + f,
                      row < mrows && f < kf, x);
        }
      }
      if (tab != nullptr && live) {  // the chunk's positions or scores
        const int* src = tab + d.seg * libra::kWindow * bk + d.j0;
        if (tab16) {
          for (int p = lane; p < libra::kWindow * kCols / 4; p += 32) {
            const int r = p / (kCols / 4), q = (p % (kCols / 4)) * 4;
            const bool ok = d.j0 + q < bk;
            libra::cp_async16(libra::smem_u32(st + kTab + r * kCols + q),
                              ok ? src + static_cast<int64_t>(r) * bk + q
                                 : tab,
                              ok);
          }
        } else {
          for (int p = lane; p < libra::kWindow * kCols; p += 32) {
            const int r = p / kCols, q = p % kCols;
            const bool ok = d.j0 + q < bk;
            libra::cp_async4(libra::smem_u32(st + kTab + r * kCols + q),
                             ok ? src + static_cast<int64_t>(r) * bk + q
                                : tab,
                             ok);
          }
        }
      }
    }
    libra::cp_async_commit();
  };

  // X_win^T fragments of the current window: b[0] of k-step 2h is
  // X[row g][f0 + 16h + 4t], b[1] the next feature; k-step 2h + 1 takes
  // features 4t + 2 and 4t + 3 (the permuted k index).
  uint32_t xf[kF / 16][4];
  int cur_win = -1;  // the window of the chunk computed last
  int last_win = -1; // the window of the chunk staged last

  Idx pro[kStages - 1];
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fetch(i, pro[i]);
  Idx nxt;  // the next chunk to stage
  fetch(kStages - 1, nxt);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    issue(i, pro[i], pro[i].win != last_win);
    if (i < count) last_win = pro[i].win;
  }
  for (int i = 0; i < count; ++i) {
    issue(i + kStages - 1, nxt, nxt.win != last_win);
    if (i + kStages - 1 < count) last_win = nxt.win;
    fetch(i + kStages, nxt);
    libra::cp_async_wait<kStages - 1>();
    __syncwarp();
    const float* st = ring + (i % kStages) * kStage;
    const int* meta = reinterpret_cast<const int*>(st + kMeta);
    const int w = meta[kCols], j0 = meta[kCols + 1];
    const long long seg =
        reinterpret_cast<const long long*>(meta + kCols + 2)[0];
    if (w != cur_win) {
      cur_win = w;
#pragma unroll
      for (int h = 0; h < kF / 16; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(
            st + kXRows + g * kPitch + h * 16 + 4 * t);
        xf[h][0] = libra::to_tf32(v.x), xf[h][1] = libra::to_tf32(v.y);
        xf[h][2] = libra::to_tf32(v.z), xf[h][3] = libra::to_tf32(v.w);
      }
    }
    float* seg_out = out + seg * libra::kWindow * bk;
    // The last slice of canonical stores: the earlier slices' partials of
    // the kept scores, loaded before the mmas so that their latency
    // overlaps them.
    float prev[kTiles][4];
#pragma unroll
    for (int tile = 0; tile < kTiles; ++tile) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int jc = tile * 16 + g + (q < 2 ? 0 : 8);
        const int r = 2 * t + (q & 1);
        prev[tile][q] =
            old != nullptr && j0 + jc < bk && ((meta[jc] >> r) & 1)
                ? old[seg * libra::kWindow * bk +
                      static_cast<int64_t>(r) * bk + j0 + jc]
                : 0.f;
      }
    }
#pragma unroll
    for (int tile = 0; tile < kTiles; ++tile) {
      const int ja = tile * 16 + g, jb = ja + 8;  // columns of the chunk
      const int bits_a = meta[ja], bits_b = meta[jb];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (__any_sync(libra::kFullMask, (bits_a | bits_b) != 0)) {
        const float* ra = st + ja * kPitch + 4 * t;
        const float* rb = st + jb * kPitch + 4 * t;
#pragma unroll
        for (int h = 0; h < kF / 16; ++h) {
          const float4 ya = *reinterpret_cast<const float4*>(ra + h * 16);
          const float4 yb = *reinterpret_cast<const float4*>(rb + h * 16);
          const uint32_t a0[4] = {libra::to_tf32(ya.x), libra::to_tf32(yb.x),
                                  libra::to_tf32(ya.y), libra::to_tf32(yb.y)};
          const uint32_t b0[2] = {xf[h][0], xf[h][1]};
          libra::mma_m16n8k8_tf32(acc, a0, b0);
          const uint32_t a1[4] = {libra::to_tf32(ya.z), libra::to_tf32(yb.z),
                                  libra::to_tf32(ya.w), libra::to_tf32(yb.w)};
          const uint32_t b1[2] = {xf[h][2], xf[h][3]};
          libra::mma_m16n8k8_tf32(acc, a1, b1);
        }
      }
      // acc[0] = S^T[ja][2t], acc[1] = S^T[ja][2t+1], acc[2..3]: column jb.
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int jc = q < 2 ? ja : jb;
        const int r = 2 * t + (q & 1);
        if (j0 + jc >= bk) continue;
        const bool kept = ((q < 2 ? bits_a : bits_b) >> r) & 1;
        const int64_t at = static_cast<int64_t>(r) * bk + j0 + jc;
        const float* tw = st + kTab + r * kCols + jc;  // the table's word
        if (pos != nullptr) {  // canonical: the kept score's one owner
          if (!kept) continue;
          const int p = __float_as_int(*tw);
          if (p < 0) continue;
          out[p] = old != nullptr ? acc[q] + prev[tile][q] : acc[q];
        } else if (!accumulate) {
          seg_out[at] = kept ? acc[q] : 0.f;
        } else if (kept) {
          seg_out[at] = *tw + acc[q];
        }
      }
    }
    __syncwarp();  // every lane is done with this stage before it refills
  }
  libra::cp_async_wait<0>();
}

// Batch strides of the operands: cols, bitmap, window, pos, x, y, out and
// the staging buffer.
struct Strides {
  long long cols, bitmap, window, pos, x, y, out, staged;
};

// True when a table's 8 x kCols words of a chunk can be copied 16 bytes
// at a time in every batch element.
inline int rows16(const void* base, int bk, long long bs) {
  return bk % 4 == 0 && bs % 4 == 0 &&
         reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

template <int kF, bool kVec4>
int launch(const int* cols, const int* bitmap, const int* window,
           const int* pos, const float* x, const float* y, float* out,
           float* staged, long long batch, long long nb, int bk, int kf,
           long long mrows, const Strides& bs, cudaStream_t stream) {
  auto kernel = sddmm_mxu_kernel<kF, kVec4>;
  constexpr size_t smem = smem_bytes<kF>();
  // Resident warps a device: set up and measured once (each entry is
  // written whole, with the same value by any caller).
  static std::atomic<long long> resident_of[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  long long resident = resident_of[device].load();
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(smem))) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kWarps * 32, smem)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident = static_cast<long long>(sms) * per_sm * kWarps;
    resident_of[device].store(resident);
  }
  // One wave of warps, each walking a contiguous run of chunks.
  constexpr int kCols = chunk_cols<kF>();
  const int chunks_per_seg = (bk + kCols - 1) / kCols;
  const long long nchunks = nb * chunks_per_seg;
  const long long per_warp = (nchunks + resident - 1) / resident;
  const long long warps = (nchunks + per_warp - 1) / per_warp;
  // Canonical stores with a staging buffer: the slices before the last
  // stage their partial scores there, and the last adds them and stores.
  const int tab16 = pos != nullptr ? rows16(pos, bk, bs.pos)
                                   : rows16(out, bk, bs.out);
  const int staged16 = rows16(staged, bk, bs.staged);
  for (long long z0 = 0; z0 < batch; z0 += libra::kMaxBatch) {
    const int nz = libra::batch_chunk(batch, z0);
    Operands ops{}, early{};
    for (int i = 0; i < nz; ++i) {
      const long long z = z0 + i;
      ops.cols[i] = cols + z * bs.cols;
      ops.bitmap[i] = bitmap + z * bs.bitmap;
      ops.window[i] = window + z * bs.window;
      ops.pos[i] = pos == nullptr ? nullptr : pos + z * bs.pos;
      ops.x[i] = x + z * bs.x, ops.y[i] = y + z * bs.y;
      ops.out[i] = out + z * bs.out;
    }
    if (staged != nullptr) {
      early = ops;
      for (int i = 0; i < nz; ++i) {
        early.pos[i] = nullptr;
        early.out[i] = staged + (z0 + i) * bs.staged;
      }
    }
    float* const staged_z0 =
        staged == nullptr ? nullptr : staged + z0 * bs.staged;
    const dim3 grid(static_cast<unsigned>((warps + kWarps - 1) / kWarps), nz);
    for (int f0 = 0; f0 < kf; f0 += kF) {
      const bool last = f0 + kF >= kf;
      if (staged != nullptr && !last) {
        kernel<<<grid, kWarps * 32, smem, stream>>>(
            early, nchunks, chunks_per_seg, bk, kf, mrows, f0, f0 > 0,
            staged16, nullptr, 0, per_warp);
      } else {
        kernel<<<grid, kWarps * 32, smem, stream>>>(
            ops, nchunks, chunks_per_seg, bk, kf, mrows, f0, f0 > 0, tab16,
            f0 > 0 ? staged_z0 : nullptr, bs.staged, per_warp);
      }
      if ((err = cudaGetLastError()) != cudaSuccess) {
        return static_cast<int>(err);
      }
    }
  }
  return static_cast<int>(cudaSuccess);
}

template <bool kVec4>
int launch_width(const int* cols, const int* bitmap, const int* window,
                 const int* pos, const float* x, const float* y, float* out,
                 float* staged, long long batch, long long nb, int bk, int kf,
                 long long mrows, int slice_feats, const Strides& bs,
                 cudaStream_t stream) {
  switch (slice_feats) {
    case 16:
      return launch<16, kVec4>(cols, bitmap, window, pos, x, y, out, staged,
                               batch, nb, bk, kf, mrows, bs, stream);
    case 32:
      return launch<32, kVec4>(cols, bitmap, window, pos, x, y, out, staged,
                               batch, nb, bk, kf, mrows, bs, stream);
    case 64:
      return launch<64, kVec4>(cols, bitmap, window, pos, x, y, out, staged,
                               batch, nb, bk, kf, mrows, bs, stream);
    case 128:
      return launch<128, kVec4>(cols, bitmap, window, pos, x, y, out, staged,
                                batch, nb, bk, kf, mrows, bs, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Strides (*_bs, in elements) step from one batch element's operand to
// the next; 0 shares the operand. pos null: the staged (nb, 8, bk)
// output. pos given: canonical stores into out, over several slices
// through staged, (nb, 8, bk) scratch floats a batch element.
extern "C" int sddmm_mxu_launch(const int* cols, const int* bitmap,
                                const int* window, const int* pos,
                                const float* x, const float* y, float* out,
                                float* staged, long long batch, long long nb,
                                int bk, int kf, long long mrows,
                                long long cols_bs, long long bitmap_bs,
                                long long window_bs, long long pos_bs,
                                long long x_bs, long long y_bs,
                                long long out_bs, long long staged_bs,
                                int slice_feats, int vec4,
                                cudaStream_t stream) {
  if (batch <= 0 || nb <= 0 || bk <= 0 || kf <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (pos == nullptr) {
    staged = nullptr;
  } else if (staged == nullptr && kf > slice_feats) {
    return static_cast<int>(cudaErrorInvalidValue);  // nowhere to stage
  }
  const Strides bs{cols_bs, bitmap_bs, window_bs, pos_bs,
                   x_bs,    y_bs,      out_bs,    staged_bs};
  return vec4 ? launch_width<true>(cols, bitmap, window, pos, x, y, out,
                                   staged, batch, nb, bk, kf, mrows,
                                   slice_feats, bs, stream)
              : launch_width<false>(cols, bitmap, window, pos, x, y, out,
                                    staged, batch, nb, bk, kf, mrows,
                                    slice_feats, bs, stream);
}
