// Helpers shared by the port's CUDA kernels (me_gram.cu, me_gram_wide.cu,
// fused.cu, detect_many.cu, predict.cu, nvf.cu).
//
// Every kernel reads its neighbours clamp-to-edge with min/max on the
// indices (the reference's CLK_ADDRESS_CLAMP_TO_EDGE sampler), so one
// kernel covers what the JAX package needed a padded and a raw twin for.
// Per-block sums and maxes go to a (batch, n_blocks, slots) buffer that the
// Python wrapper finishes with torch.sum / torch.amax, that an assembly
// kernel finishes (the Grams), or that the frame's last block finishes
// (frame_total: the fused embed's and detect's chains): deterministic, no
// float atomics.
//
// The arithmetic that has a plain PyTorch twin (prediction errors, the NVF
// variance, u = mask * W) uses the __f*_rn intrinsics, which nvcc never
// contracts into FMAs, so each term rounds exactly as the twin's separate
// elementwise ops do. Only the final sums differ from the twin, in order.
#pragma once

#include <cuda_runtime.h>

namespace wm {

constexpr int kMaskME = 0;
constexpr int kMaskNVF = 1;

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// The tile that the stencil kernels stage in shared memory with its halo:
// kTileH x kTileW pixels of one frame, kTileThreads threads a block.
constexpr int kTileW = 64;
constexpr int kTileH = 32;
constexpr int kTileThreadsX = 32;
constexpr int kTileThreadsY = 8;
constexpr int kTileThreads = kTileThreadsX * kTileThreadsY;
const dim3 kTileBlock(kTileThreadsX, kTileThreadsY);

// Taps of the (2 half + 1)^2 window with the centre left out.
__host__ __device__ constexpr int taps(int half) {
  return (2 * half + 1) * (2 * half + 1) - 1;
}

// The frame halo the detect kernels (fused.cu, detect_many.cu) stage: the u
// ring (PH deep) needs e_z and the mask PH further out, the mask a window of
// NH (NVF) around it.
__host__ __device__ constexpr int detect_halo(int mask, int ph, int nh) {
  return mask == kMaskME ? 2 * ph : ph + (nh > ph ? nh : ph);
}

// Grid of one block per tile of each of `planes` (rows, cols) planes.
inline dim3 tile_grid(int planes, int rows, int cols) {
  return dim3(ceil_div(cols, kTileW), ceil_div(rows, kTileH), planes);
}

// Stage frame(clamp(y0 - halo + r), clamp(x0 - halo + q)) into s[r][q].
template <int kRows, int kCols>
__device__ __forceinline__ void stage_tile(float (*s)[kCols],
                                           const float* __restrict__ frame,
                                           int y0, int x0, int halo, int rows,
                                           int cols, int tid, int n_threads) {
  for (int i = tid; i < kRows * kCols; i += n_threads) {
    const int r = i / kCols;
    const int q = i % kCols;
    const int gy = clampi(y0 - halo + r, 0, rows - 1);
    const int gx = clampi(x0 - halo + q, 0, cols - 1);
    s[r][q] = __ldg(frame + static_cast<size_t>(gy) * cols + gx);
  }
}

// Stage the K predictor coefficients of frame b.
template <int K>
__device__ __forceinline__ void stage_coeffs(float* s_c,
                                             const float* __restrict__ coeffs,
                                             int b, int tid, int n_threads) {
  for (int k = tid; k < K; k += n_threads) s_c[k] = __ldg(coeffs + b * K + k);
}

// A 3x3 clamp-to-edge window: t = row above, m = centre row, b = row below;
// 0/1/2 = column left/centre/right.
struct Window {
  float t0, t1, t2, m0, m1, m2, b0, b1, b2;
};

// Predictor coefficients of one image, read as c[k]. Up to 8 (the 3x3
// window) live in registers; the 24/48/80 of the wide windows stay in the
// shared-memory array they were staged in, since 80 floats a thread in
// registers would spill.
template <int K, bool kInRegisters = (K <= 8)>
struct Coeffs {
  float v[K];
  __device__ __forceinline__ explicit Coeffs(const float* staged) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = staged[k];
  }
  __device__ __forceinline__ float operator[](int k) const { return v[k]; }
};

template <int K>
struct Coeffs<K, false> {
  const float* staged;
  __device__ __forceinline__ explicit Coeffs(const float* s) : staged(s) {}
  __device__ __forceinline__ float operator[](int k) const {
    return staged[k];
  }
};

// The same prediction error over the (2H+1)^2 - 1 taps of a window held in a
// row-major array of row stride `stride`, centred on centre[0]: taps in
// row-major order with the centre left out, subtracted in that order.
template <int H, typename C>
__device__ __forceinline__ float prediction_error_at(const float* centre,
                                                     int stride,
                                                     const C& c) {
  float e = centre[0];
  int k = 0;
#pragma unroll
  for (int dr = -H; dr <= H; ++dr) {
#pragma unroll
    for (int dc = -H; dc <= H; ++dc) {
      if (dr == 0 && dc == 0) continue;
      e = __fsub_rn(e, __fmul_rn(c[k], centre[dr * stride + dc]));
      ++k;
    }
  }
  return e;
}

// Load a window row of kWin floats whose element 0 sits kOff floats past a
// 16-byte boundary of shared memory into w, with the widest aligned loads
// (4, 2 or 1 floats) from element V on.
template <int kOff, int kWin, int V = 0>
__device__ __forceinline__ void load_window(const float* row,
                                            float (&w)[kWin]) {
  if constexpr (V < kWin) {
    constexpr int align = (kOff + V) % 4;
    constexpr int width = align == 0 && V + 4 <= kWin       ? 4
                          : align % 2 == 0 && V + 2 <= kWin ? 2
                                                            : 1;
    if constexpr (width == 4) {
      const float4 f = *reinterpret_cast<const float4*>(row + V);
      w[V] = f.x; w[V + 1] = f.y; w[V + 2] = f.z; w[V + 3] = f.w;
    } else if constexpr (width == 2) {
      const float2 f = *reinterpret_cast<const float2*>(row + V);
      w[V] = f.x; w[V + 1] = f.y;
    } else {
      w[V] = row[V];
    }
    load_window<kOff, kWin, V + width>(row, w);
  }
}

// The NVF mask var / (1 + var) of a p x p window from its sums of x and x^2;
// 1/p^2 rounded from double to float, as torch rounds the Python scalar.
template <int P>
__device__ __forceinline__ float nvf_from_sums(float total, float total_sq) {
  const float inv_p2 = static_cast<float>(1.0 / (P * P));
  const float mean = __fmul_rn(total, inv_p2);
  const float var = __fsub_rn(__fmul_rn(total_sq, inv_p2),
                              __fmul_rn(mean, mean));
  return __fdiv_rn(var, __fadd_rn(1.0f, var));
}

// The NVF mask over the (2H+1)^2 window centred on centre[0], summed as
// ops/nvf.py sums: per row across the columns, then across the rows.
template <int H>
__device__ __forceinline__ float nvf_at(const float* centre, int stride) {
  constexpr int kP = 2 * H + 1;
  float total = 0.0f, total_sq = 0.0f;
#pragma unroll
  for (int dr = -H; dr <= H; ++dr) {
    const float* row = centre + dr * stride;
    float sum = row[-H];
    float sq = __fmul_rn(sum, sum);
#pragma unroll
    for (int dc = -H + 1; dc <= H; ++dc) {
      sum = __fadd_rn(sum, row[dc]);
      sq = __fadd_rn(sq, __fmul_rn(row[dc], row[dc]));
    }
    total = dr == -H ? sum : __fadd_rn(total, sum);
    total_sq = dr == -H ? sq : __fadd_rn(total_sq, sq);
  }
  return nvf_from_sums<kP>(total, total_sq);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

// Reduce v[0..N) over the whole block and write the block's N results to
// out[0..N): slots below N_SUM are summed, the rest take the max. Every
// thread of the block must call it (it synchronises), and the block size
// must be a multiple of 32, at most 1024. Warps combine in a fixed order,
// so the result does not change from run to run.
template <int N, int N_SUM>
__device__ __forceinline__ void block_reduce_store(float (&v)[N],
                                                   float* out) {
  __shared__ float per_warp[32][N];
  const int tid = threadIdx.x + threadIdx.y * blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = (blockDim.x * blockDim.y) >> 5;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const float r = s < N_SUM ? warp_sum(v[s]) : warp_max(v[s]);
    if (lane == 0) per_warp[warp][s] = r;
  }
  __syncthreads();
  if (tid < N) {
    float r = per_warp[0][tid];
    for (int w = 1; w < n_warps; ++w)
      r = tid < N_SUM ? r + per_warp[w][tid] : fmaxf(r, per_warp[w][tid]);
    out[tid] = r;
  }
}

// A float from L2, as __ldcg reads it (no L1 line that another block's
// write would leave stale), but volatile and a memory clobber, so that the
// compiler keeps it after the __threadfence() before it.
__device__ __forceinline__ float load_l2(const float* at) {
  float value;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(value) : "l"(at)
               : "memory");
  return value;
}

// The last-block pattern of a threadfence reduction (me_gram.cu's solving
// assembly), for a kernel whose blocks each store N partials of a frame with
// block_reduce_store: the threads that stored them fence, and the block
// counts itself in *done (which holds 0 when the kernel starts). The block
// that draws blocks - 1, the frame's last, fences again, reduces the frame's
// (blocks, N) partials in their index order, as block_reduce_store does
// (slots below N_SUM summed from 0, the rest the max from 0: the kernels'
// maxes are of masks >= 0), into total in every thread, sets *done back to
// 0 for the next kernel of its chain and returns true; the others return
// false. Which block is last decides only who reduces, not the order: every
// run gives the same bits. Every thread of the block must call it.
template <int N, int N_SUM>
__device__ __forceinline__ bool frame_total(const float* parts, int blocks,
                                            int* done, float (&total)[N]) {
  __shared__ int s_last;
  __shared__ float s_total[N];
  const int tid = threadIdx.x + threadIdx.y * blockDim.x;
  const int n_threads = blockDim.x * blockDim.y;
  if (tid < N) __threadfence();   // this block's partials, before the count
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(done, 1) == blocks - 1;
  __syncthreads();
  if (!s_last) return false;
  __threadfence();   // the frame's other blocks' partials, before the reads
  float v[N];
#pragma unroll
  for (int s = 0; s < N; ++s) v[s] = 0.0f;
#pragma unroll 4
  for (int i = tid; i < blocks; i += n_threads) {
#pragma unroll
    for (int s = 0; s < N; ++s) {
      const float x = load_l2(parts + static_cast<size_t>(i) * N + s);
      v[s] = s < N_SUM ? v[s] + x : fmaxf(v[s], x);
    }
  }
  block_reduce_store<N, N_SUM>(v, s_total);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < N; ++s) total[s] = s_total[s];
  if (tid == 0) *done = 0;
  return true;
}

}  // namespace wm
