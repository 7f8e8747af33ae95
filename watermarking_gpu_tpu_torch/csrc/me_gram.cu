// ME normal equations: the 9x9 Gram of [8 clamped neighbours; centre], in
// two kernels: the lag sums over row strips, then their assembly.
//
// Replaces: the JAX package's ops/pallas/me_kernel.py::_me_gram_kernel
// and its raw twin _me_gram_kernel_raw (body _gram_core), and the assembly
// that me_gram_padded / me_gram_raw return with them (_assemble_gram).
//
// Every pair sum of the Gram is a window sum of one of 13 lag products
// Q_d[y, x] = P[y, x] * P[y + dr, x + dc] of the clamp-to-edge extension P
// of the image, d = (dr, dc) canonical: dr in [0, 2], dc in [-2, 2],
// dc >= 0 where dr = 0 (ops/me.py::lag_plan(3)). Pair (a, b), first
// offset (ar, ac), sums Q_d over rows [ar, H + ar) and columns
// [ac, W + ac). With I_d the sum over rows [0, H) and the frame's own
// columns [0, W), and C_d(x) column x of Q_d over rows [0, H):
//
//   columns [-1, W - 1) = I_d + (C_d(-1) - C_d(W - 1)),
//   columns [1, W + 1)  = I_d + (C_d(W) - C_d(0)),
//   rows [1, H + 1)     = rows [0, H) + (R_d(H) - R_d(0)),
//   rows [-1, H - 1)    = rows [0, H) + (R_d(-1) - R_d(H - 1)),
//
// R_d(k) row k of Q_d over the pair's columns, windowed the same way. Each
// correction is a difference taken before it is added: a constant frame,
// whose lag sums are all the same bits, then gives 81 entries of the same
// bits, a Gram exactly singular, which the solve flags.
//
// 1. me_gram_lags_kernel sums I_d over the rows of one strip and the
//    columns of one block: one sum per (image, lag, strip, column block).
// 2. me_gram_assemble_kernel, one block per (image, lag): computes C_d and
//    R_d from the image at clamped indices, adds the lag kernel's sums up
//    in a fixed order and writes every pair of its lag into both triangles
//    of the Gram.
//
// What bounds it on an H100: device memory. 13 FMAs a pixel, 0.22 G at
// 1080p x 8 (about 6.4 us at the card's f32 rate), against 66 MB read once
// (about 20 us at 3.35 TB/s). The assembly reads the frame's four boundary
// rows and columns, and its latency is what it costs.
//
// What the design does about it: a block copies its 512 columns (and 4 on
// each side) of each row into a ring of shared memory with cp.async, in
// 16-byte chunks where the chunk lies in the frame and the rows are
// 16-byte aligned (4-byte clamped copies elsewhere), kBuffers - 1 chunks of
// kChunk rows ahead of the rows it multiplies. A thread owns 4 adjacent
// columns, reads them and the 2 on each side as three aligned shared loads
// a row, and keeps the last two rows' values, so each row serves as the
// bottom row of the lags with dr = 2 and 1 and the base of dr = 0: 52 FMAs
// a row into 13 register sums, the thread's 4 columns together (no masking
// inside the frame and the strip). Strips of GRAM_STRIP_ROWS rows
// (ops/me.py) give the grid 1.5 waves at 1080p x 8, and each block reduces
// its 13 sums once, with shuffles and a fixed-order combine of its warps.
// The assembly kernel is launched as a programmatic dependent launch: its
// blocks start while the lag kernel's last wave runs, compute the boundary
// terms, and wait (griddepcontrol.wait) only before they read the sums;
// one warp then finishes. No float atomics: two calls give the same bits.
//
// Halo form (a row shard of a frame; the JAX package's me_gram_padded with
// the exchanged rows spliced into its padding): the image holds top rows
// above the rows owned and bottom rows below them, true neighbour rows at
// a seam and replicated edge rows at the frame's border. Both kernels
// address a frame from its first owned row and clamp row indices to
// [-top, rows + bottom - 1] instead of [0, rows - 1]: that is all. The
// sums then cover the owned rows' centres, the corrections read the rows
// just past them, and the shards' Grams add up to the frame's. top =
// bottom = 0 is the frame itself.
#include <cuda_pipeline.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;           // threads a lag-kernel block
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;                // columns a thread
constexpr int kBlockCols = kThreads * kCols;
constexpr int kTileW = kBlockCols + 8;  // a tile row: columns x0 - 4 ..
constexpr int kLags = 13;
constexpr int kChunk = 2;               // tile rows a copy group
constexpr int kBuffers = 6;             // chunks in shared memory
constexpr int kAssembleThreads = 1024;  // threads an assembly block

// The lag kernel's own order of the lags: dr = 0, dc = 0 .. 2; then
// dr = 1 and dr = 2, dc = -2 .. 2.
__host__ __device__ constexpr int lag_dr(int k) {
  return k < 3 ? 0 : (k < 8 ? 1 : 2);
}
__host__ __device__ constexpr int lag_dc(int k) {
  return k < 3 ? k : (k < 8 ? k - 5 : k - 10);
}

// Copy a tile row (columns x0 - 4 .. x0 + kBlockCols + 3 of an image row,
// clamped) into dst by cp.async: thread t copies the 16-byte chunk of
// columns x0 + 4 t .., threads 0 and 1 the chunks of columns x0 - 4 and
// x0 + kBlockCols. 16-byte copies where the chunk lies in the frame and
// the rows are 16-byte aligned (vec), 4-byte clamped copies elsewhere;
// chunks wholly past column cols + 1, which no live column reads, are
// left to the zeros written at the start.
__device__ __forceinline__ void stage_chunk(float* dst, const float* row,
                                            int x0, int cols, bool vec,
                                            int j) {
  const int x = x0 - 4 + 4 * j;
  if (x > cols + 1) return;
  if (vec && x >= 0 && x + 4 <= cols) {
    __pipeline_memcpy_async(dst + 4 * j, row + x, 16);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      __pipeline_memcpy_async(dst + 4 * j + e,
                              row + wm::clampi(x + e, 0, cols - 1), 4);
  }
}

// A thread's 13 lag sums and the bases of the two rows above the next one.
struct Lags {
  float acc[kLags];
  float b1[kCols];
  float b2[kCols];

  // The products of one tile row: at points to the row's columns xt - 2 ..
  // xt + 5 of the thread's columns xt ..; kMasked: the bases are the row's
  // values times live (zero past the frame's columns), or zero where the
  // row is past the strip; otherwise its values.
  template <bool kMasked>
  __device__ __forceinline__ void add(const float* at,
                                      const float (&live)[kCols],
                                      bool in_strip) {
    const float2 left = *reinterpret_cast<const float2*>(at);
    const float4 mid = *reinterpret_cast<const float4*>(at + 2);
    const float2 right = *reinterpret_cast<const float2*>(at + 6);
    const float q[kCols + 4] = {left.x, left.y, mid.x, mid.y,
                                mid.z,  mid.w,  right.x, right.y};
    float base[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      base[j] = !kMasked ? q[j + 2] : (in_strip ? q[j + 2] * live[j] : 0.0f);
#pragma unroll
    for (int k = 0; k < kLags; ++k) {
      const int dr = lag_dr(k);
      const int dc = lag_dc(k);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float top = dr == 0 ? base[j] : (dr == 1 ? b1[j] : b2[j]);
        acc[k] = fmaf(top, q[j + 2 + dc], acc[k]);
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      b2[j] = b1[j];
      b1[j] = base[j];
    }
  }
};

// Grid (column blocks, strips, batch). sums is (batch, 13, strips, column
// blocks); lag_index maps (dc + 2) * 3 + dr to the lag's index in the
// caller's order. Thread t owns columns x0 + 4 t .. + 3 of the block's
// columns x0 ..; the block walks image rows y0 .. y_end + 1 (clamped to
// rows + bottom - 1), the last two only as the bottom rows of the lags
// with dr > 0, through a ring of kBuffers chunks of kChunk tile rows in
// shared memory, copied kBuffers - 1 chunks ahead of the one it reads.
// A frame holds top + rows + bottom rows, its owned row 0 at row top.
__global__ void __launch_bounds__(kThreads) me_gram_lags_kernel(
    const float* __restrict__ img, const int* __restrict__ lag_index,
    float* __restrict__ sums, int rows, int cols, int strip, bool vec,
    int top, int bottom) {
  __shared__ __align__(16) float tile[kBuffers][kChunk][kTileW];
  __shared__ float per_warp[kWarps][kLags];
  const int b = blockIdx.z;
  const int s = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * kBlockCols;
  const int xt = x0 + threadIdx.x * kCols;
  const int y0 = s * strip;
  const int y_end = min(y0 + strip, rows);   // base rows [y0, y_end)
  const int n_rows = y_end + 2 - y0;
  const int n_chunks = wm::ceil_div(n_rows, kChunk);
  const float* frame =
      img + (static_cast<size_t>(b) * (top + rows + bottom) + top) * cols;
#ifdef __CUDA_ARCH__
  // the assembly kernel may start its reads of the image now; it waits for
  // this grid before it reads the sums
  asm volatile("griddepcontrol.launch_dependents;");
#endif

  // zeros where no copy lands (chunks past column cols + 1)
  for (int i = threadIdx.x; i < kBuffers * kChunk * kTileW; i += kThreads)
    if (x0 - 4 + i % kTileW > cols + 1) (&tile[0][0][0])[i] = 0.0f;
  auto stage = [&](int c) {
    if (c < n_chunks) {
      float(*buf)[kTileW] = tile[c % kBuffers];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float* row =
            frame + static_cast<size_t>(
                        min(y0 + c * kChunk + i, rows + bottom - 1)) * cols;
        stage_chunk(buf[i], row, x0, cols, vec, threadIdx.x + 1);
        if (threadIdx.x < 2)
          stage_chunk(buf[i], row, x0, cols, vec,
                      threadIdx.x == 0 ? 0 : kTileW / 4 - 1);
      }
    }
    __pipeline_commit();   // an empty group past the last chunk
  };

  Lags w;
#pragma unroll
  for (int k = 0; k < kLags; ++k) w.acc[k] = 0.0f;
  float live[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    w.b1[c] = w.b2[c] = 0.0f;
    live[c] = xt + c < cols ? 1.0f : 0.0f;
  }
  const bool full = xt + kCols <= cols;   // no column past the frame

#pragma unroll
  for (int c = 0; c < kBuffers - 1; ++c) stage(c);
  for (int c = 0; c < n_chunks; ++c) {
    __pipeline_wait_prior(kBuffers - 2);   // chunk c landed
    __syncthreads();   // for every thread; chunk c - 1 is read no more
    stage(c + kBuffers - 1);
    // the thread's columns of each tile row, from column xt - 2
    const float* at = &tile[c % kBuffers][0][0] + threadIdx.x * kCols + 2;
    if (full && (c + 1) * kChunk <= y_end - y0) {   // strip rows only
#pragma unroll
      for (int i = 0; i < kChunk; ++i) w.add<false>(at + i * kTileW, live,
                                                    true);
    } else {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int r = y0 + c * kChunk + i;
        if (r - y0 >= n_rows) break;   // the same for the whole block
        w.add<true>(at + i * kTileW, live, r < y_end);
      }
    }
  }
  __pipeline_wait_prior(0);

#pragma unroll
  for (int k = 0; k < kLags; ++k) {
    const float total = wm::warp_sum(w.acc[k]);
    if (lane == 0) per_warp[warp][k] = total;
  }
  __syncthreads();
  if (threadIdx.x < kLags) {
    const int k = threadIdx.x;
    float total = per_warp[0][k];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) total += per_warp[i][k];
    const int l = __ldg(lag_index + (lag_dc(k) + 2) * 3 + lag_dr(k));
    sums[((static_cast<size_t>(b) * kLags + l) * gridDim.y + s) * gridDim.x +
         blockIdx.x] = total;
  }
}

// One block per (lag, image). lags holds (dr, dc) per lag; pairs, grouped by
// lag from pair_start[l] to pair_start[l + 1], hold (row, column, ar, ai),
// ai = ac + 1. sums is the lag kernel's output, n_parts = strips x column
// blocks a lag. A frame holds top + rows + bottom rows, as above.
__global__ void __launch_bounds__(kAssembleThreads) me_gram_assemble_kernel(
    const float* __restrict__ img, const float* __restrict__ sums,
    const int* __restrict__ lags, const int* __restrict__ pair_start,
    const int* __restrict__ pairs, float* __restrict__ gram, int rows,
    int cols, int n_parts, int top, int bottom) {
  __shared__ float s_full[8];
  __shared__ float s_edge[4][4];
  __shared__ float s_window[5][3];
  const int l = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int dr = __ldg(lags + 2 * l);
  const int dc = __ldg(lags + 2 * l + 1);
  const float* frame =
      img + (static_cast<size_t>(b) * (top + rows + bottom) + top) * cols;
  const int last = cols - 1;
  auto at = [&](int y, int x) {
    return __ldg(frame + static_cast<long long>(
                             wm::clampi(y, -top, rows + bottom - 1)) * cols +
                 wm::clampi(x, 0, last));
  };
  // the boundary rows -1, 0, H - 1, H and columns -1, 0, W - 1, W
  const int bank[4] = {-1, 0, rows - 1, rows};
  const int edge[4] = {-1, 0, last, cols};

  // v[e]: C_d(edge[e]); v[4 + j]: row bank[j] of Q_d over columns [0, W)
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = 0.0f;
#pragma unroll 2
  for (int y = tid; y < rows; y += kAssembleThreads) {
    const float left = at(y, 0);
    const float right = at(y, last);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] += (e < 2 ? left : right) * at(y + dr, edge[e] + dc);
  }
#pragma unroll 2
  for (int x = tid; x < cols; x += kAssembleThreads) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[4 + j] += at(bank[j], x) *
                                            at(bank[j] + dr, x + dc);
  }
  if (tid < 16) {   // Q_d at boundary row j, column edge[e]
    const int j = tid / 4;
    const int e = tid % 4;
    s_edge[j][e] = at(bank[j], edge[e]) * at(bank[j] + dr, edge[e] + dc);
  }
  wm::block_reduce_store<8, 8>(v, s_full);
  __syncthreads();
  if (tid >= 32) return;   // one warp finishes, from the lag kernel's sums

#ifdef __CUDA_ARCH__
  asm volatile("griddepcontrol.wait;" ::: "memory");   // the lag kernel
#endif
  const float* part = sums + (static_cast<size_t>(b) * kLags + l) * n_parts;
  float interior = 0.0f;
  for (int i = tid; i < n_parts; i += 32)
    interior += part[i];   // written by the grid just waited for: no __ldg
  interior = wm::warp_sum(interior);
  if (tid < 5) {
    // the column windows ai = 0, 1, 2 of the interior (tid 0) and of
    // boundary row bank[tid - 1]
    const float full = tid == 0 ? interior : s_full[3 + tid];
    float c[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = tid == 0 ? s_full[e]
                                                : s_edge[tid - 1][e];
    s_window[tid][0] = full + (c[0] - c[2]);
    s_window[tid][1] = full;
    s_window[tid][2] = full + (c[3] - c[1]);
  }
  __syncwarp();

  float* out = gram + static_cast<size_t>(b) * 81;
  for (int i = __ldg(pair_start + l) + tid; i < __ldg(pair_start + l + 1);
       i += 32) {
    const int row = __ldg(pairs + 4 * i);
    const int column = __ldg(pairs + 4 * i + 1);
    const int ar = __ldg(pairs + 4 * i + 2);
    const int ai = __ldg(pairs + 4 * i + 3);
    // rows [1, H + 1): + R(H) - R(0); rows [-1, H - 1): + R(-1) - R(H - 1)
    const float shift = ar > 0 ? s_window[4][ai] - s_window[2][ai]
                               : s_window[1][ai] - s_window[3][ai];
    const float value = ar == 0 ? s_window[0][ai] : s_window[0][ai] + shift;
    out[row * 9 + column] = value;
    out[column * 9 + row] = value;
  }
}

}  // namespace

// img (batch, top + rows + bottom, cols) f32 -> sums (batch, 13, strips,
// column blocks) f32 over the owned rows, strips = ceil(rows / strip),
// column blocks = ceil(cols / block_cols); the caller owns that layout and
// passes its column block, which must be kBlockCols.
extern "C" int wm_me_gram_lags(const float* img, const int* lag_index,
                               float* sums, int batch, int rows, int cols,
                               int strip, int block_cols, int top,
                               int bottom, void* stream) {
  if (batch < 1 || rows < 1 || cols < 1 || strip < 1 || top < 0 ||
      bottom < 0 || block_cols != kBlockCols ||
      static_cast<long long>(top + rows + bottom) * cols > 2147483647LL)
    return cudaErrorInvalidValue;
  const int n_strips = wm::ceil_div(rows, strip);
  if (n_strips > 65535 || batch > 65535) return cudaErrorInvalidValue;
  // 16-byte loads need every row to start on a 16-byte boundary
  const bool vec = cols % 4 == 0 &&
                   reinterpret_cast<std::uintptr_t>(img) % 16 == 0;
  const dim3 grid(wm::ceil_div(cols, kBlockCols), n_strips, batch);
  me_gram_lags_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      img, lag_index, sums, rows, cols, strip, vec, top, bottom);
  return static_cast<int>(cudaGetLastError());
}

// The lag kernel's sums with the image (as above) -> gram (batch, 9, 9).
extern "C" int wm_me_gram_assemble(const float* img, const float* sums,
                                   const int* lags, const int* pair_start,
                                   const int* pairs, float* gram, int batch,
                                   int rows, int cols, int n_parts, int top,
                                   int bottom, void* stream) {
  if (batch < 1 || rows < 1 || cols < 1 || n_parts < 1 || batch > 65535 ||
      top < 0 || bottom < 0)
    return cudaErrorInvalidValue;
  const dim3 grid(kLags, batch);
  // programmatic dependent launch: the kernel may start before the lag
  // kernel ends (griddepcontrol above)
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kAssembleThreads);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attribute;
  attribute.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &attribute;
  config.numAttrs = 1;
  const cudaError_t code = cudaLaunchKernelEx(
      &config, me_gram_assemble_kernel, img, sums, lags, pair_start, pairs,
      gram, rows, cols, n_parts, top, bottom);
  if (code != cudaSuccess) return static_cast<int>(code);
  return static_cast<int>(cudaGetLastError());
}
