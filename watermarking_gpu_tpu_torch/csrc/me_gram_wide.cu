// Wide-window ME Gram (p in {5, 7, 9}) in two kernels: the lag sums over
// row strips, then their assembly into the (k+1) x (k+1) Gram of
// [k clamped neighbours; centre], k = p*p - 1, h = p / 2.
//
// Replaces: the JAX package's ops/pallas/me_gram_wide.py::_wide_gram_kernel
// and its raw twin _wide_gram_kernel_raw (body _wide_gram_core), and the
// assembly that me_gram_wide_raw returns with them (_assemble_wide).
//
// Every pair sum of the Gram is a window sum of one lag product
// Q_d[y, x] = P[y, x] * P[y + dr, x + dc] of the clamp-to-edge extension P of
// the image, over the L canonical lags d = (dr, dc), dr in [0, 2h],
// dc in [-2h, 2h], dc >= 0 where dr = 0 (41 / 85 / 145 lags). With lanes
// v in [0, W + 2h) (image columns v - h):
//
// 1. wide_lag_strips_kernel sums Q_d[y, v - h] over the rows y of one strip
//    for the lanes of one block, and writes per (image, lag, strip, lane
//    block) the sum over the block's lanes, and per (image, lag, strip) the
//    2h left and 2h right edge lanes. Summed over strips and lane blocks that
//    is the full lane sum of the JAX package's lane partials
//    V_d[v] = sum_{y in [0, H)} Q_d[y, v - h]; the edge lanes are all that
//    the column windows [ai, ai + W), ai in [0, 2h], need besides it. The
//    output stays a sum over rows, so row shards add up.
// 2. wide_assemble_kernel, one block per (image, lag): adds step 1's output
//    up over strips and lane blocks, takes the 2h + 1 column windows, computes
//    the products of the two boundary banks (the frame's rows [-h, 3h) and
//    [H - h, H + 3h), clamped, which the caller gathers; lanes over columns
//    [-3h, W + 3h) at clamped columns) with their column windows cumulated
//    over the 2h bank rows, and writes every pair of its lag into both
//    triangles of the Gram:
//    base + sign(ar) * (D[h + max(ar, 0)] - D[h + min(ar, 0)]),
//    D = cumHigh - cumLow (the JAX package's _assemble_wide).
//
// Halo form (a row shard of a frame; the JAX package's
// parallel/spatial.py::_gram_wide_sharded with impl="pallas"): the lag
// kernel takes a shard that holds top rows above its owned rows and bottom
// rows below them, counts the owned rows from its row top, lays its strips
// over them and clamps its row reads to the shard's img_rows = top + rows +
// bottom rows. A lag reads rows [0, 2h] below, so a seam needs 2h rows of
// halo below; the shards' outputs then add up to the frame's. The assembly
// needs only the frame's banks, which lie on its edge shards: it takes them
// (and the shards' sums folded), not the image. top = bottom = 0 is the
// frame itself.
//
// What bounds it on an H100: arithmetic. Each canonical lag costs one FMA
// per pixel: at 1080p x 8 that is 0.68 / 1.41 / 2.42 G FMA at p = 5 / 7 / 9,
// about 20 / 42 / 72 us at the card's f32 rate, against 66 MB read once
// (about 20 us at 3.35 TB/s). The assembly does ~1% of that.
//
// What the design does about it: a thread owns one lane and a run of D
// column lags, and walks the rows of one strip. It keeps the 2h + 1 values
// P[y .. y + 2h, v - h + dc] of each column in a register ring indexed at
// compile time (the row loop is unrolled by 2h + 1), so a row costs one
// base load and D ring loads for up to D (2h + 1) FMAs and no register
// moves. The loads come from shared memory: the block copies its rows with
// cp.async in chunks of a multiple of 2h + 1 rows, two chunks ahead of the
// one it reads, so a warp seldom waits on device memory and every load is
// one conflict-free access. Strips put the rows of a frame in many blocks, so
// that the grid fills the card about three times over. Lane sums are
// reduced with shuffles and combined across warps in a fixed order; no
// float atomics, so two calls give the same bits. Every read clamps its
// indices: no padded copy exists.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kLanes = 128;            // lanes (threads) a lag-kernel block
constexpr int kWarps = kLanes / 32;
constexpr int kBuffers = 4;            // chunks of tile rows in shared memory
constexpr int kAssembleThreads = 256;  // threads an assembly block

// The lag kernel's shape per h, each the fastest of an A/B sweep on an H100
// (tools/ab_wide_gram.py): the 4h + 1 column lags split into this many runs
// of near-equal length, one run a thread (longer runs share each base load
// among more FMAs, up to the register cap)...
__host__ __device__ constexpr int column_groups(int h) {
  return h == 4 ? 3 : 2;
}

// ... the blocks an SM holds at once (the register cap follows: 128 at
// h = 2, 3, 168 at h = 4, where 128 spills) ...
__host__ __device__ constexpr int min_blocks(int h) { return h == 4 ? 3 : 4; }

// ... and the rows a chunk of the tile holds, a multiple of 2h + 1 (the
// unrolled row loop; longer chunks synchronise less often, but at h > 2 the
// longer code ran slower).
__host__ __device__ constexpr int chunk_rows(int h) {
  return (2 * h + 1) * (h == 2 ? 3 : 1);
}

// First column lag of run g.
__host__ __device__ constexpr int group_start(int h, int g) {
  return -2 * h + g * (4 * h + 1) / column_groups(h);
}

// The first row lag of column dc that is canonical.
__host__ __device__ constexpr int first_row_lag(int dc) {
  return dc < 0 ? 1 : 0;
}

// Canonical lags of the columns [dc0, dc0 + d).
__host__ __device__ constexpr int canonical_lags(int h, int dc0, int d) {
  int n = 0;
  for (int j = 0; j < d; ++j) n += 2 * h + 1 - first_row_lag(dc0 + j);
  return n;
}

// A block's tile row: image columns [x0 - 3h, x0 + kLanes + h), lane v's
// base column v - h at q = v - x0 + 2h.
__host__ __device__ constexpr int tile_width(int h) { return kLanes + 4 * h; }

// Copy rows [row0, row0 + chunk_rows(h)) of the block's tile (clamped to
// rows) into buf with cp.async, as one commit group: thread i copies tile
// column i (and i + kLanes, for the first 4h threads) from src[0] (and
// src[1]), its clamped image columns of row 0.
template <int H>
__device__ __forceinline__ void stage_chunk(float* buf,
                                            const float* const (&src)[2],
                                            int row0, int rows, int cols) {
  constexpr int C = chunk_rows(H);
  constexpr int TW = tile_width(H);
#pragma unroll
  for (int r = 0; r < C; ++r) {
    const int row = min(row0 + r, rows - 1) * cols;
    __pipeline_memcpy_async(buf + r * TW + threadIdx.x, src[0] + row, 4);
    if (threadIdx.x < TW - kLanes)
      __pipeline_memcpy_async(buf + r * TW + kLanes + threadIdx.x,
                              src[1] + row, 4);
  }
  __pipeline_commit();
}

// The rows one thread walks for the column lags [DC0, DC0 + D) of its lane:
// a ring of the values P[y, v - h + dc] of each column, and the sums of
// each (column, row lag).
template <int H, int DC0, int D>
struct Walk {
  static constexpr int K = 2 * H + 1;  // row lags 0 .. 2h
  static constexpr int C = chunk_rows(H);
  static constexpr int TW = tile_width(H);
  float ring[D][K];  // row y0 + t in slot t mod K
  float acc[D][K];

  // Row t = c C + I of the strip: chunk holds its rows [c C, c C + C),
  // next the C rows after them; q = the lane's base column in the tile.
  template <int I>
  __device__ __forceinline__ void step(const float* chunk, const float* next,
                                       int q) {
    const float* ahead = I + 2 * H < C ? chunk + (I + 2 * H) * TW
                                       : next + (I + 2 * H - C) * TW;
#pragma unroll
    for (int j = 0; j < D; ++j)
      ring[j][(I + 2 * H) % K] = ahead[q + DC0 + j];
    const float base = chunk[I * TW + q];
#pragma unroll
    for (int j = 0; j < D; ++j)
#pragma unroll
      for (int r = first_row_lag(DC0 + j); r < K; ++r)
        acc[j][r] += base * ring[j][(I + r) % K];
  }

  // The first min(count, C) rows of the chunk.
  template <int I = 0>
  __device__ __forceinline__ void steps(const float* chunk, const float* next,
                                        int q, int count) {
    if constexpr (I < C) {
      if (I < count) {
        step<I>(chunk, next, q);
        steps<I + 1>(chunk, next, q, count);
      }
    }
  }
};

// One strip of one lane block for the column lags [DC0, DC0 + D): sum the
// lag products over rows [y0, y0 + len) of frame, whose reads clamp to its
// rows [0, rows), then write the block's lane sum and the edge lanes of
// each canonical lag. The rows come through tile
// (kBuffers chunks of C tile rows): chunks c + 2 .. are copied while chunk
// c is read, chunk c + 1 feeding its ring.
template <int H, int DC0, int D>
__device__ __forceinline__ void strip_lags(
    const float* __restrict__ frame, const int* __restrict__ lag_index,
    float* __restrict__ sums, float* __restrict__ edges, float* tile,
    int rows, int cols, int y0, int len, int plane, int n_blocks) {
  using W = Walk<H, DC0, D>;
  constexpr int K = W::K;
  constexpr int C = W::C;
  constexpr int kChunk = C * W::TW;
  constexpr int kSlots = canonical_lags(H, DC0, D);
  __shared__ float per_warp[kWarps][kSlots];
  const int lanes = cols + 2 * H;
  const int x0 = blockIdx.x * kLanes;
  const int v = x0 + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = threadIdx.x + 2 * H;
  W w;
#pragma unroll
  for (int j = 0; j < D; ++j)
#pragma unroll
    for (int r = 0; r < K; ++r) w.acc[j][r] = 0.0f;

  // chunk c holds strip rows [c C, c C + C); chunks 0 .. n_chunks - 1 are
  // walked, chunk n_chunks only feeds the ring
  const int n_chunks = wm::ceil_div(len, C);
  const float* const src[2] = {
      frame + wm::clampi(x0 - 3 * H + threadIdx.x, 0, cols - 1),
      frame + wm::clampi(x0 - 3 * H + kLanes + threadIdx.x, 0, cols - 1)};
  auto stage = [&](int c) {
    if (c <= n_chunks)
      stage_chunk<H>(tile + c % kBuffers * kChunk, src, y0 + c * C, rows,
                     cols);
    else
      __pipeline_commit();  // an empty group keeps the count
  };
  for (int c = 0; c < kBuffers - 1; ++c) stage(c);
  for (int c = 0; c < n_chunks; ++c) {
    __pipeline_wait_prior(kBuffers - 3);  // chunks .. c + 1 landed
    __syncthreads();  // for every thread, and chunk c - 1 is read no more
    stage(c + kBuffers - 1);
    if (v - lane < lanes) {  // a warp with a live lane
      const float* chunk = tile + c % kBuffers * kChunk;
      const float* next = tile + (c + 1) % kBuffers * kChunk;
      if (c == 0) {
#pragma unroll
        for (int r = 0; r < 2 * H; ++r)
#pragma unroll
          for (int j = 0; j < D; ++j)
            w.ring[j][r] = chunk[r * W::TW + q + DC0 + j];
      }
      if (len - c * C >= C)
        w.steps(chunk, next, q, C);  // a whole chunk: no row test
      else
        w.steps(chunk, next, q, len - c * C);
    }
  }
  __pipeline_wait_prior(0);
  const auto& acc = w.acc;

  const bool live = v < lanes;
  const int edge = v < 2 * H ? v : (live && v >= cols ? 2 * H + v - cols : -1);
  int slot = 0;
#pragma unroll
  for (int j = 0; j < D; ++j) {
#pragma unroll
    for (int r = first_row_lag(DC0 + j); r < K; ++r, ++slot) {
      const float value = live ? acc[j][r] : 0.0f;
      const float total = wm::warp_sum(value);
      if (lane == 0) per_warp[warp][slot] = total;
      if (edge >= 0) {
        const int l = __ldg(lag_index + (DC0 + j + 2 * H) * K + r);
        edges[static_cast<size_t>(l) * plane * 4 * H + edge] = value;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < kSlots) {
    // thread s -> the s-th canonical (column, row lag) of the run
    int j = 0, s = threadIdx.x;
    while (s >= K - first_row_lag(DC0 + j)) {
      s -= K - first_row_lag(DC0 + j);
      ++j;
    }
    const int r = first_row_lag(DC0 + j) + s;
    float total = per_warp[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) total += per_warp[i][threadIdx.x];
    const int l = __ldg(lag_index + (DC0 + j + 2 * H) * K + r);
    sums[static_cast<size_t>(l) * plane * n_blocks + blockIdx.x] = total;
  }
}

// Run g of the column lags, picked at compile time.
template <int H, int G = 0>
__device__ __forceinline__ void dispatch_group(
    int g, const float* __restrict__ frame, const int* __restrict__ lag_index,
    float* __restrict__ sums, float* __restrict__ edges, float* tile,
    int rows, int cols, int y0, int len, int plane, int n_blocks) {
  if constexpr (G < column_groups(H)) {
    if (g == G) {
      constexpr int kStart = group_start(H, G);
      strip_lags<H, kStart, group_start(H, G + 1) - kStart>(
          frame, lag_index, sums, edges, tile, rows, cols, y0, len, plane,
          n_blocks);
    } else {
      dispatch_group<H, G + 1>(g, frame, lag_index, sums, edges, tile, rows,
                               cols, y0, len, plane, n_blocks);
    }
  }
}

// Grid (lane blocks, column groups, batch * strips). A frame of img holds
// img_rows rows, the rows owned from row top (the halo form); the strips
// cover the owned rows. sums is (batch, L, strips, lane blocks), edges
// (batch, L, strips, 4h); lag_index maps (dc + 2h) * (2h + 1) + dr to the
// lag's index in the caller's order.
template <int H>
__global__ void __launch_bounds__(kLanes, min_blocks(H))
    wide_lag_strips_kernel(
    const float* __restrict__ img, const int* __restrict__ lag_index,
    float* __restrict__ sums, float* __restrict__ edges, int rows, int cols,
    int strip, int n_strips, int n_lags, int top, int img_rows) {
  __shared__ float tile[kBuffers * chunk_rows(H) * tile_width(H)];
  const int b = blockIdx.z / n_strips;
  const int s = blockIdx.z % n_strips;
  const int y0 = s * strip;
  const int len = min(strip, rows - y0);
  // this (image, strip)'s lag 0; lag l sits l * n_strips planes further on
  const int plane = n_strips;
  const size_t first = static_cast<size_t>(b) * n_lags * n_strips + s;
  // rows are read from the first owned one down, clamped to the shard's
  dispatch_group<H>(blockIdx.y,
                    img + (static_cast<size_t>(b) * img_rows + top) * cols,
                    lag_index, sums + first * gridDim.x,
                    edges + first * 4 * H, tile, img_rows - top, cols, y0,
                    len, plane, gridDim.x);
}

// The assembly block's boundary-bank products for a lag (dr, dc): per bank
// row j (0 .. 2h-1) the low bank's row j (the frame's row j - h) at lane
// u - h times its row j + dr at u - h + dc, summed over the lanes into
// v[1 + j], and the same of the high bank into v[1 + 2h + j]; the edge
// lanes' products kept in s_qedge. Columns clamp to the frame's.
template <int H>
__device__ __forceinline__ void bank_products(const float* __restrict__ low,
                                              const float* __restrict__ high,
                                              int cols, int dr, int dc,
                                              float (&v)[1 + 4 * H],
                                              float (*s_qedge)[4 * H]) {
  const int lanes = cols + 2 * H;
  const int below = dr * cols;
  for (int u = threadIdx.x; u < lanes; u += kAssembleThreads) {
    const int xt = wm::clampi(u - H, 0, cols - 1);
    const int xb = wm::clampi(u - H + dc, 0, cols - 1) + below;
    const int e = u < 2 * H ? u : (u >= cols ? 2 * H + u - cols : -1);
#pragma unroll
    for (int j = 0; j < 2 * H; ++j) {
      const float lo = __ldg(low + j * cols + xt) * __ldg(low + j * cols + xb);
      const float hi =
          __ldg(high + j * cols + xt) * __ldg(high + j * cols + xb);
      v[1 + j] += lo;
      v[1 + 2 * H + j] += hi;
      if (e >= 0) {
        s_qedge[j][e] = lo;
        s_qedge[2 * H + j][e] = hi;
      }
    }
  }
}

// One block per (lag, image). low and high hold the frame's banks, (batch,
// 4h, cols) each, image b's at b * bank_stride; lags holds (dr, dc) per lag;
// pairs, grouped by lag from pair_start[l] to pair_start[l + 1], hold (row,
// column, ar, ai).
template <int H>
__global__ void __launch_bounds__(kAssembleThreads) wide_assemble_kernel(
    const float* __restrict__ low, const float* __restrict__ high,
    int bank_stride, const float* __restrict__ sums,
    const float* __restrict__ edges, const int* __restrict__ lags,
    const int* __restrict__ pair_start, const int* __restrict__ pairs,
    float* __restrict__ gram, int cols, int n_lags, int n_strips,
    int n_blocks) {
  constexpr int K = 2 * H + 1;
  constexpr int E = 4 * H;            // edge lanes: 2h left, 2h right
  constexpr int kSums = 1 + 2 * 2 * H;  // base, then low and high bank rows
  constexpr int kN = K * K;           // k + 1
  __shared__ float s_edge[E];
  __shared__ float s_qedge[2 * 2 * H][E];
  __shared__ float s_full[kSums];
  __shared__ float s_base[K];
  __shared__ float s_diff[K][K];
  const int l = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int dr = __ldg(lags + 2 * l);
  const int dc = __ldg(lags + 2 * l + 1);
  const size_t bank = static_cast<size_t>(b) * bank_stride;
  const size_t lag = static_cast<size_t>(b) * n_lags + l;

  float v[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) v[i] = 0.0f;
  const float* part = sums + lag * n_strips * n_blocks;
  for (int i = tid; i < n_strips * n_blocks; i += kAssembleThreads)
    v[0] += __ldg(part + i);
  if (tid < E) {
    const float* edge = edges + lag * n_strips * E + tid;
    float total = 0.0f;
    for (int s = 0; s < n_strips; ++s) total += __ldg(edge + s * E);
    s_edge[tid] = total;
  }

  bank_products<H>(low + bank, high + bank, cols, dr, dc, v, s_qedge);
  wm::block_reduce_store<kSums, kSums>(v, s_full);
  __syncthreads();

  if (tid < K) {
    // window ai = tid: lanes [ai, ai + W), the full sum less the ai left and
    // the 2h - ai right edge lanes
    const int ai = tid;
    auto window = [ai](float full, const float* edge) {
      float left = 0.0f, right = 0.0f;
      for (int e = 0; e < ai; ++e) left += edge[e];
      for (int e = E - 1; e >= 2 * H + ai; --e) right += edge[e];
      return full - left - right;
    };
    s_base[ai] = window(s_full[0], s_edge);
    // D[m] = cumHigh[m] - cumLow[m]: bank rows [0, m) summed
    float low = 0.0f, high = 0.0f;
    s_diff[0][ai] = 0.0f;
    for (int m = 1; m < K; ++m) {
      low += window(s_full[m], s_qedge[m - 1]);
      high += window(s_full[2 * H + m], s_qedge[2 * H + m - 1]);
      s_diff[m][ai] = high - low;
    }
  }
  __syncthreads();

  float* out = gram + static_cast<size_t>(b) * kN * kN;
  for (int i = __ldg(pair_start + l) + tid; i < __ldg(pair_start + l + 1);
       i += kAssembleThreads) {
    const int row = __ldg(pairs + 4 * i);
    const int column = __ldg(pairs + 4 * i + 1);
    const int ar = __ldg(pairs + 4 * i + 2);
    const int ai = __ldg(pairs + 4 * i + 3);
    const float sign = ar > 0 ? 1.0f : (ar < 0 ? -1.0f : 0.0f);
    const float value =
        s_base[ai] + sign * (s_diff[H + max(ar, 0)][ai] -
                             s_diff[H + min(ar, 0)][ai]);
    out[row * kN + column] = value;
    out[column * kN + row] = value;
  }
}

int lane_blocks(int cols, int half) {
  return wm::ceil_div(cols + 2 * half, kLanes);
}

template <int H>
int launch_strips(const float* img, const int* lag_index, float* sums,
                  float* edges, int batch, int rows, int cols, int strip,
                  int n_lags, int top, int img_rows, cudaStream_t s) {
  const int n_strips = wm::ceil_div(rows, strip);
  if (static_cast<long long>(batch) * n_strips > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(lane_blocks(cols, H), column_groups(H), batch * n_strips);
  wide_lag_strips_kernel<H><<<grid, kLanes, 0, s>>>(
      img, lag_index, sums, edges, rows, cols, strip, n_strips, n_lags, top,
      img_rows);
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int launch_assemble(const float* low, const float* high, int bank_stride,
                    const float* sums, const float* edges, const int* lags,
                    const int* pair_start, const int* pairs, float* gram,
                    int batch, int cols, int n_lags, int n_strips,
                    int n_blocks, cudaStream_t s) {
  if (batch > 65535) return cudaErrorInvalidValue;
  const dim3 grid(n_lags, batch);
  wide_assemble_kernel<H><<<grid, kAssembleThreads, 0, s>>>(
      low, high, bank_stride, sums, edges, lags, pair_start, pairs, gram,
      cols, n_lags, n_strips, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img (batch, top + rows + bottom, cols) f32, the owned rows from row top
// -> sums (batch, n_lags, strips, lane blocks) and edges (batch, n_lags,
// strips, 4h) f32 over the owned rows, strips = ceil(rows / strip), lane
// blocks = ceil((cols + 2h) / lane_block); the caller owns that layout and
// passes its lane block, which must be kLanes. half = h in {2, 3, 4}; the
// frame's total_rows and cols >= 6h.
extern "C" int wm_wide_lag_strips(const float* img, const int* lag_index,
                                  float* sums, float* edges, int batch,
                                  int rows, int cols, int half, int strip,
                                  int lane_block, int n_lags, int top,
                                  int bottom, int total_rows, void* stream) {
  const long long img_rows = static_cast<long long>(top) + rows + bottom;
  if (batch < 1 || rows < 1 || strip < 1 || lane_block != kLanes ||
      top < 0 || bottom < 0 || total_rows < rows ||
      total_rows < 6 * half || cols < 6 * half ||
      img_rows * cols > 2147483647LL)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WM_STRIPS(h)                                                        \
  launch_strips<h>(img, lag_index, sums, edges, batch, rows, cols, strip,   \
                   n_lags, top, static_cast<int>(img_rows), s)
  switch (half) {
    case 2: return WM_STRIPS(2);
    case 3: return WM_STRIPS(3);
    case 4: return WM_STRIPS(4);
  }
#undef WM_STRIPS
  return cudaErrorInvalidValue;
}

// The lag kernel's sums and edges (any strips and lane blocks, e.g. a row
// shard's folded to one each) with the frame's banks low and high, (batch,
// 4h, cols) each, image b's at b * bank_stride floats: rows [-h, 3h) and
// [total_rows - h, total_rows + 3h) of the frame, clamped to it -> gram
// (batch, k+1, k+1). total_rows, cols >= 6h.
extern "C" int wm_wide_assemble(const float* low, const float* high,
                                int bank_stride, const float* sums,
                                const float* edges, const int* lags,
                                const int* pair_start, const int* pairs,
                                float* gram, int batch, int cols, int half,
                                int n_lags, int n_strips, int n_blocks,
                                int total_rows, void* stream) {
  if (batch < 1 || total_rows < 6 * half || cols < 6 * half ||
      bank_stride < 4 * half * cols || n_strips < 1 || n_blocks < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WM_ASSEMBLE(h)                                                      \
  launch_assemble<h>(low, high, bank_stride, sums, edges, lags, pair_start, \
                     pairs, gram, batch, cols, n_lags, n_strips, n_blocks, s)
  switch (half) {
    case 2: return WM_ASSEMBLE(2);
    case 3: return WM_ASSEMBLE(3);
    case 4: return WM_ASSEMBLE(4);
  }
#undef WM_ASSEMBLE
  return cudaErrorInvalidValue;
}
