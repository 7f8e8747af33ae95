// Standalone prediction error: e = x - sum_k c_k x(clamp(y+dr), clamp(x+dc))
// over the p*p-1 taps of the p x p window, for p in {3, 5, 7, 9}.
//
// Replaces:
//   prediction_error_kernel <- the JAX package's
//       ops/pallas/predict_kernel.py::_predict_error_kernel (wrapper
//       prediction_error_pallas).
//
// A standalone op, as in the JAX package, where only the non-fused branch
// of detect_many_pipeline calls it: no engine path of the port does, since
// the fused kernels (fused.cu) compute the error inside their own tiles at
// every geometry and have no envelope to fall out of.
//
// What bounds it on an H100: it reads the frame and writes e, 8 bytes a
// pixel (133 MB at 8 x 1080 x 1920, 40 us at 3.35 TB/s), and does 2(p*p-1)
// flops a pixel (160 at p=9: 40 us of f32): bytes up to p=7, both at p=9.
//
// What the design does about it: each block stages one tile of the frame
// with a clamped halo of p/2 pixels in shared memory, so each pixel is read
// from device memory about once; the taps read shared memory, and the
// coefficients stay in registers at p=3 and in shared memory above it. No
// padded copy of the frame is made. The taps are subtracted in coefficient
// order with one rounding each (common.cuh), as ops/me.py::prediction_error
// does, so the result is bit-identical to it.
#include "common.cuh"

namespace {

template <int kPH>
__global__ void __launch_bounds__(wm::kTileThreads)
    prediction_error_kernel(const float* __restrict__ img,
                            const float* __restrict__ coeffs,
                            float* __restrict__ out, int rows, int cols) {
  constexpr int kTaps = wm::taps(kPH);
  constexpr int kIW = wm::kTileW + 2 * kPH;
  // s_img[r][q] = frame(clamp(y0 - kPH + r), clamp(x0 - kPH + q))
  __shared__ float s_img[wm::kTileH + 2 * kPH][kIW];
  __shared__ float s_c[kTaps];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * wm::kTileW;
  const int y0 = blockIdx.y * wm::kTileH;
  const size_t plane = static_cast<size_t>(rows) * cols;
  const int tid = threadIdx.x + threadIdx.y * blockDim.x;
  wm::stage_coeffs<kTaps>(s_c, coeffs, b, tid, wm::kTileThreads);
  wm::stage_tile<wm::kTileH + 2 * kPH, kIW>(s_img, img + b * plane, y0, x0,
                                            kPH, rows, cols, tid,
                                            wm::kTileThreads);
  __syncthreads();
  const wm::Coeffs<kTaps> c(s_c);

  for (int i = tid; i < wm::kTileH * wm::kTileW; i += wm::kTileThreads) {
    const int r = i / wm::kTileW;
    const int q = i % wm::kTileW;
    const int y = y0 + r;
    const int x = x0 + q;
    if (y < rows && x < cols)
      out[b * plane + static_cast<size_t>(y) * cols + x] =
          wm::prediction_error_at<kPH>(&s_img[r + kPH][q + kPH], kIW, c);
  }
}

template <int kPH>
int launch(const float* img, const float* coeffs, float* out, int batch,
           int rows, int cols, cudaStream_t s) {
  prediction_error_kernel<kPH>
      <<<wm::tile_grid(batch, rows, cols), wm::kTileBlock, 0, s>>>(
          img, coeffs, out, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img (batch, rows, cols), coeffs (batch, p*p-1) f32 -> out (batch, rows,
// cols) f32.
extern "C" int wm_prediction_error(const float* img, const float* coeffs,
                                   float* out, int batch, int rows, int cols,
                                   int p, void* stream) {
  if (batch < 1 || rows < 1 || cols < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 3: return launch<1>(img, coeffs, out, batch, rows, cols, s);
    case 5: return launch<2>(img, coeffs, out, batch, rows, cols, s);
    case 7: return launch<3>(img, coeffs, out, batch, rows, cols, s);
    case 9: return launch<4>(img, coeffs, out, batch, rows, cols, s);
  }
  return cudaErrorInvalidValue;
}
