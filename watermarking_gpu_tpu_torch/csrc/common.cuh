// Helpers shared by the port's CUDA kernels (me_gram.cu, me_gram_wide.cu,
// fused.cu).
//
// Every kernel reads its neighbours clamp-to-edge with min/max on the
// indices (the reference's CLK_ADDRESS_CLAMP_TO_EDGE sampler), so one
// kernel covers what the JAX package needed a padded and a raw twin for.
// Per-block sums and maxes go to a (batch, n_blocks, slots) buffer that the
// Python wrapper finishes with torch.sum / torch.amax: deterministic, no
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

// A 3x3 clamp-to-edge window: t = row above, m = centre row, b = row below;
// 0/1/2 = column left/centre/right.
struct Window {
  float t0, t1, t2, m0, m1, m2, b0, b1, b2;
};

// e = centre - sum_k c_k * neighbour_k, neighbours in row-major order with
// the centre left out (ops/neighbors.py), one rounding per product and per
// subtraction, as ops/me.py::prediction_error does it.
__device__ __forceinline__ float prediction_error(const Window& w,
                                                  const float (&c)[8]) {
  float e = w.m1;
  e = __fsub_rn(e, __fmul_rn(c[0], w.t0));
  e = __fsub_rn(e, __fmul_rn(c[1], w.t1));
  e = __fsub_rn(e, __fmul_rn(c[2], w.t2));
  e = __fsub_rn(e, __fmul_rn(c[3], w.m0));
  e = __fsub_rn(e, __fmul_rn(c[4], w.m2));
  e = __fsub_rn(e, __fmul_rn(c[5], w.b0));
  e = __fsub_rn(e, __fmul_rn(c[6], w.b1));
  e = __fsub_rn(e, __fmul_rn(c[7], w.b2));
  return e;
}

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

// The NVF mask over the (2H+1)^2 window centred on centre[0], summed as
// ops/nvf.py sums: per row across the columns, then across the rows; 1/p^2
// rounded from double to float, as torch rounds the Python scalar.
template <int H>
__device__ __forceinline__ float nvf_at(const float* centre, int stride) {
  constexpr int kP = 2 * H + 1;
  const float inv_p2 = static_cast<float>(1.0 / (kP * kP));
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
  const float mean = __fmul_rn(total, inv_p2);
  const float var = __fsub_rn(__fmul_rn(total_sq, inv_p2),
                              __fmul_rn(mean, mean));
  return __fdiv_rn(var, __fadd_rn(1.0f, var));
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

}  // namespace wm
