// Standalone NVF mask: var / (1 + var) of the p x p clamp-to-edge window
// around each pixel (population variance), for p in {3, 5, 7, 9}.
//
// Replaces:
//   nvf_mask_kernel <- the JAX package's ops/pallas/nvf_kernel.py::
//       _nvf_kernel (wrapper nvf_mask_pallas).
//
// A standalone op, as in the JAX package, where no pipeline calls it: the
// NVF mask of the embed and detect paths is computed inside the fused
// kernels' tiles (fused.cu, common.cuh::nvf_at).
//
// What bounds it on an H100: it reads the frame and writes the mask, 8 bytes
// a pixel (133 MB at 8 x 1080 x 1920, 40 us at 3.35 TB/s); the separable box
// sums need 4(p-1) adds, a square and 6 more flops a pixel (39 at p=9, 10
// us of f32): bound by bytes at every p.
//
// What the design does about it: each block stages one tile with a clamped
// halo of p/2 pixels in shared memory (each pixel read from device memory
// about once), takes the sums of x and x^2 across the window's columns for
// every staged row into shared memory, then sums p of those down the rows:
// 2p adds a pixel and plane instead of p^2. The sums run in the order of
// ops/nvf.py (across the columns, then down the rows), one rounding each,
// so the mask is bit-identical to it.
#include "common.cuh"

namespace {

template <int kNH>
__global__ void __launch_bounds__(wm::kTileThreads)
    nvf_mask_kernel(const float* __restrict__ img, float* __restrict__ out,
                    int rows, int cols) {
  constexpr int kP = 2 * kNH + 1;
  constexpr int kIH = wm::kTileH + 2 * kNH;
  constexpr int kIW = wm::kTileW + 2 * kNH;
  // s_img[r][q] = frame(clamp(y0 - kNH + r), clamp(x0 - kNH + q))
  __shared__ float s_img[kIH][kIW];
  // s_sum[r][q] = sum of s_img[r][q .. q + kP), s_sq of the squares
  __shared__ float s_sum[kIH][wm::kTileW];
  __shared__ float s_sq[kIH][wm::kTileW];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * wm::kTileW;
  const int y0 = blockIdx.y * wm::kTileH;
  const size_t plane = static_cast<size_t>(rows) * cols;
  const int tid = threadIdx.x + threadIdx.y * blockDim.x;
  wm::stage_tile<kIH, kIW>(s_img, img + b * plane, y0, x0, kNH, rows, cols,
                           tid, wm::kTileThreads);
  __syncthreads();

  for (int i = tid; i < kIH * wm::kTileW; i += wm::kTileThreads) {
    const int r = i / wm::kTileW;
    const int q = i % wm::kTileW;
    const float* row = &s_img[r][q];
    float sum = row[0];
    float sq = __fmul_rn(sum, sum);
#pragma unroll
    for (int dc = 1; dc < kP; ++dc) {
      sum = __fadd_rn(sum, row[dc]);
      sq = __fadd_rn(sq, __fmul_rn(row[dc], row[dc]));
    }
    s_sum[r][q] = sum;
    s_sq[r][q] = sq;
  }
  __syncthreads();

  // 1/p^2 rounded from double to float, as torch rounds the Python scalar
  const float inv_p2 = static_cast<float>(1.0 / (kP * kP));
  for (int i = tid; i < wm::kTileH * wm::kTileW; i += wm::kTileThreads) {
    const int r = i / wm::kTileW;
    const int q = i % wm::kTileW;
    const int y = y0 + r;
    const int x = x0 + q;
    if (y < rows && x < cols) {
      float total = s_sum[r][q];
      float total_sq = s_sq[r][q];
#pragma unroll
      for (int dr = 1; dr < kP; ++dr) {
        total = __fadd_rn(total, s_sum[r + dr][q]);
        total_sq = __fadd_rn(total_sq, s_sq[r + dr][q]);
      }
      const float mean = __fmul_rn(total, inv_p2);
      const float var = __fsub_rn(__fmul_rn(total_sq, inv_p2),
                                  __fmul_rn(mean, mean));
      out[b * plane + static_cast<size_t>(y) * cols + x] =
          __fdiv_rn(var, __fadd_rn(1.0f, var));
    }
  }
}

template <int kNH>
int launch(const float* img, float* out, int batch, int rows, int cols,
           cudaStream_t s) {
  nvf_mask_kernel<kNH>
      <<<wm::tile_grid(batch, rows, cols), wm::kTileBlock, 0, s>>>(
          img, out, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img (batch, rows, cols) f32 -> out (batch, rows, cols) f32.
extern "C" int wm_nvf_mask(const float* img, float* out, int batch, int rows,
                           int cols, int p, void* stream) {
  if (batch < 1 || rows < 1 || cols < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 3: return launch<1>(img, out, batch, rows, cols, s);
    case 5: return launch<2>(img, out, batch, rows, cols, s);
    case 7: return launch<3>(img, out, batch, rows, cols, s);
    case 9: return launch<4>(img, out, batch, rows, cols, s);
  }
  return cudaErrorInvalidValue;
}
