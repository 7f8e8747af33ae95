// ME normal equations: the 9x9 Gram of [8 clamped neighbours; centre].
//
// Replaces: the JAX package's ops/pallas/me_kernel.py::_me_gram_kernel
// and its raw twin _me_gram_kernel_raw (body _gram_core, assembled by
// _assemble_gram).
//
// What bounds it on an H100: device memory. The Gram needs 13 lag products
// a pixel (the TPU kernel's form), 0.22 G FMA at 1080p x 8 frames (about
// 6 us at the card's f32 rate), against 66 MB read once (about 20 us at
// 3.35 TB/s).
//
// What the design does about it: each thread owns one column and walks
// kRows rows down it, keeping the 3x3 window in registers and loading only
// the three new values of the next row (coalesced across the warp). It does
// the 45 products of the upper triangle (36 Rx, 8 rx, centre^2) directly
// into 45 register sums, 0.75 G FMA (22 us), more than the lag form needs
// but without its boundary-row corrections; each block writes one row of
// 45 partial sums.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // columns per block
constexpr int kRows = 32;      // rows each thread walks
constexpr int kSlots = 45;     // upper triangle of the 9x9, row-major

__global__ void __launch_bounds__(kThreads)
    me_gram_kernel(const float* __restrict__ img, float* __restrict__ partials,
                   int rows, int cols) {
  const int b = blockIdx.z;
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y0 = blockIdx.y * kRows;
  const int y1 = min(y0 + kRows, rows);
  const float* frame = img + static_cast<size_t>(b) * rows * cols;

  float acc[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) acc[s] = 0.0f;

  if (x < cols) {
    const int xl = max(x - 1, 0);
    const int xr = min(x + 1, cols - 1);
    const float* top = frame + static_cast<size_t>(max(y0 - 1, 0)) * cols;
    const float* mid = frame + static_cast<size_t>(y0) * cols;
    wm::Window w;
    w.t0 = __ldg(top + xl); w.t1 = __ldg(top + x); w.t2 = __ldg(top + xr);
    w.m0 = __ldg(mid + xl); w.m1 = __ldg(mid + x); w.m2 = __ldg(mid + xr);
    for (int y = y0; y < y1; ++y) {
      const float* bot = frame + static_cast<size_t>(min(y + 1, rows - 1)) * cols;
      w.b0 = __ldg(bot + xl); w.b1 = __ldg(bot + x); w.b2 = __ldg(bot + xr);
      // coefficient order (ops/neighbors.py), centre last
      const float v[9] = {w.t0, w.t1, w.t2, w.m0, w.m2, w.b0, w.b1, w.b2, w.m1};
      int s = 0;
#pragma unroll
      for (int i = 0; i < 9; ++i) {
#pragma unroll
        for (int j = i; j < 9; ++j) acc[s++] += v[i] * v[j];
      }
      w.t0 = w.m0; w.t1 = w.m1; w.t2 = w.m2;
      w.m0 = w.b0; w.m1 = w.b1; w.m2 = w.b2;
    }
  }

  const size_t block = (static_cast<size_t>(b) * gridDim.y + blockIdx.y) *
                           gridDim.x + blockIdx.x;
  wm::block_reduce_store<kSlots, kSlots>(acc, partials + block * kSlots);
}

}  // namespace

extern "C" int wm_me_gram_num_blocks(int rows, int cols) {
  return wm::ceil_div(cols, kThreads) * wm::ceil_div(rows, kRows);
}

// img (batch, rows, cols) f32 -> partials (batch, n_blocks, 45) f32.
extern "C" int wm_me_gram(const float* img, float* partials, int batch,
                          int rows, int cols, void* stream) {
  if (batch < 1 || rows < 1 || cols < 1) return cudaErrorInvalidValue;
  const dim3 grid(wm::ceil_div(cols, kThreads), wm::ceil_div(rows, kRows),
                  batch);
  me_gram_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, partials, rows, cols);
  return static_cast<int>(cudaGetLastError());
}
