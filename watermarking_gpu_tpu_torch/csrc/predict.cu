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
// flops a pixel (160 at p=9: 40 us of f32 if they paired into FMAs). They
// do not: each tap is a rounded product and a rounded difference, two
// instructions that issue one at a time, so 2(p*p-1) f32 instructions a
// pixel take about 8 / 24 / 48 / 79 us at p = 3 / 5 / 7 / 9 at the card's
// 67 TFLOP/s of FMAs (33.5 T instructions/s): bound by bytes at p = 3 and 5,
// by those instructions at p = 7 and 9. The rounding is the price of
// results bit-identical to ops/me.py::prediction_error and to the e_z of
// the fused kernels.
//
// What the design does about it: the embed field's tile (stencil.cuh). A
// block of 256 threads takes a 64 x 64 tile, copies it with a clamped halo
// of p/2 pixels into shared memory by cp.async (16-byte chunks where the
// frame allows), and a thread computes 8 consecutive outputs of a row
// (predict_rn): per tap row its 8 + 2 PH pixels are loaded into registers
// once with 16-byte shared loads, the coefficients kept in registers at
// PH <= 2 and read as float4 rows of shared memory above, so shared loads
// no longer set the pace; the outputs go out as two float4 stores where
// the row is 16-byte aligned and all 8 lie in the frame. No padded copy of
// the frame is made: the loads clamp their indices. On an H100 at 700 W it
// takes ~0.055 / 0.057 / 0.080 / 0.117 ms at p = 3 / 5 / 7 / 9
// (tools/ab_standalone.py): at p = 3, 5 1.2x a copy of the frames
// (Tensor.copy_, ~0.047 ms), at p = 9 1.5x the rounded pairs' floor.
#include <cuda_pipeline.h>

#include "stencil.cuh"

using namespace wm::stencil;

namespace {

// The layout of one instantiation (sizes in floats): the staged frame,
// s_img[k * kIS + c] = frame(clamp(y0 - kPH + k), clamp(x0 - kPH - kOff +
// c)); kOff puts the frame's 16-byte chunks on 16-byte boundaries (x0 is a
// multiple of 64).
template <int kPH>
struct Predict {
  static constexpr int kP = 2 * kPH + 1;
  static constexpr int kCW = (kP + 3) / 4 * 4;  // a coefficient row, padded
  static constexpr bool kCoeffRegs = kPH <= 2;  // 8 or 24 coefficients
  static constexpr int kOff = (4 - kPH % 4) % 4;
  static constexpr int kIH = kTileH + 2 * kPH;
  static constexpr int kIW = kOff + kTileW + 2 * kPH;
  static constexpr int kIS = bank_stride(kIW);
  // blocks an SM: eight at PH <= 2 (32 registers, no spill), six above (40
  // registers, no spill; eight spill there). Against four (54-63
  // registers): the same at p=3, 2-7% faster at p = 5, 7, 9
  // (tools/ab_standalone.py)
  static constexpr int kMinBlocks = kPH <= 2 ? 8 : 6;
};

template <int kPH>
__global__ void __launch_bounds__(kThreads, Predict<kPH>::kMinBlocks)
    prediction_error_kernel(const float* __restrict__ img,
                            const float* __restrict__ coeffs,
                            float* __restrict__ out, int rows, int cols) {
  using G = Predict<kPH>;
  constexpr int kItems = kTileH * kTG / kThreads;  // rows of kR a thread
  __shared__ __align__(16) float s_img[G::kIH * G::kIS];
  __shared__ __align__(16) float s_cg[G::kP][G::kCW];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.x;
  const size_t plane = static_cast<size_t>(rows) * cols;
  stage_coeff_rows<kPH, G::kCW>(s_cg, coeffs, b, tid);
  stage_async<G::kIH, (G::kIW + 3) / 4, G::kIS>(
      s_img, img + b * plane, y0 - kPH, x0 - kPH - G::kOff, rows, cols, tid);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  float cg[G::kCoeffRegs ? G::kP : 1][G::kCoeffRegs ? G::kP : 1];
  coeff_regs<G::kP, G::kCW, G::kCoeffRegs>(s_cg, cg);

  const bool vec = cols % 4 == 0 && reinterpret_cast<size_t>(out) % 16 == 0;
#pragma unroll
  for (int item = 0; item < kItems; ++item) {
    int r, q0;
    tile_item(tid + item * kThreads, r, q0);
    const int n_valid = y0 + r < rows ? wm::clampi(cols - x0 - q0, 0, kR) : 0;
    if (n_valid == 0) continue;
    // tile point (r, q0) is staged at (r + kPH, q0 + kPH + kOff)
    float e[kR];
    predict_rn<kPH, G::kOff, G::kCW, G::kCoeffRegs>(
        s_img + r * G::kIS + q0 + G::kOff, G::kIS, cg, s_cg, e);
    store_row(e, out + b * plane + static_cast<size_t>(y0 + r) * cols + x0 + q0,
              n_valid, vec);
  }
}

template <int kPH>
int launch(const float* img, const float* coeffs, float* out, int batch,
           int rows, int cols, cudaStream_t s) {
  const dim3 grid(wm::ceil_div(cols, kTileW), wm::ceil_div(rows, kTileH),
                  batch);
  prediction_error_kernel<kPH><<<grid, kThreads, 0, s>>>(img, coeffs, out,
                                                         rows, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img (batch, rows, cols), coeffs (batch, p*p-1) f32 -> out (batch, rows,
// cols) f32.
extern "C" int wm_prediction_error(const float* img, const float* coeffs,
                                   float* out, int batch, int rows, int cols,
                                   int p, void* stream) {
  if (batch < 1 || rows < 1 || cols < 1) return cudaErrorInvalidValue;
  if (batch > 65535 || wm::ceil_div(rows, kTileH) > 65535)
    return cudaErrorInvalidValue;  // gridDim.z, gridDim.y
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 3: return launch<1>(img, coeffs, out, batch, rows, cols, s);
    case 5: return launch<2>(img, coeffs, out, batch, rows, cols, s);
    case 7: return launch<3>(img, coeffs, out, batch, rows, cols, s);
    case 9: return launch<4>(img, coeffs, out, batch, rows, cols, s);
  }
  return cudaErrorInvalidValue;
}
