// Helpers shared by the port's CUDA kernels (me_gram.cu, fused.cu).
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

// NVF mask var / (1 + var) over the 3x3 window, var = E[x^2] - E[x]^2,
// summed per row across the columns, then across the rows (ops/nvf.py).
__device__ __forceinline__ float nvf3(const Window& w) {
  const float inv9 = 1.0f / 9.0f;
  const float st = __fadd_rn(__fadd_rn(w.t0, w.t1), w.t2);
  const float sm = __fadd_rn(__fadd_rn(w.m0, w.m1), w.m2);
  const float sb = __fadd_rn(__fadd_rn(w.b0, w.b1), w.b2);
  const float qt = __fadd_rn(__fadd_rn(__fmul_rn(w.t0, w.t0),
                                       __fmul_rn(w.t1, w.t1)),
                             __fmul_rn(w.t2, w.t2));
  const float qm = __fadd_rn(__fadd_rn(__fmul_rn(w.m0, w.m0),
                                       __fmul_rn(w.m1, w.m1)),
                             __fmul_rn(w.m2, w.m2));
  const float qb = __fadd_rn(__fadd_rn(__fmul_rn(w.b0, w.b0),
                                       __fmul_rn(w.b1, w.b1)),
                             __fmul_rn(w.b2, w.b2));
  const float total = __fadd_rn(__fadd_rn(st, sm), sb);
  const float total_sq = __fadd_rn(__fadd_rn(qt, qm), qb);
  const float mean = __fmul_rn(total, inv9);
  const float var = __fsub_rn(__fmul_rn(total_sq, inv9),
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
