// Standalone NVF mask: var / (1 + var) of the p x p clamp-to-edge window
// around each pixel (population variance), for p in {3, 5, 7, 9}.
//
// Replaces:
//   nvf_mask_kernel <- the JAX package's ops/pallas/nvf_kernel.py::
//       _nvf_kernel (wrapper nvf_mask_pallas).
//
// A standalone op, as in the JAX package, where no pipeline calls it: the
// NVF mask of the embed and detect paths is computed inside the fused
// kernels' tiles (fused.cu).
//
// What bounds it on an H100: it reads the frame and writes the mask, 8 bytes
// a pixel (133 MB at 8 x 1080 x 1920, 40 us at 3.35 TB/s); the separable box
// sums need 4(p-1) adds, a square and 6 more flops a pixel (39 at p=9, 10
// us of f32): bound by bytes at every p.
//
// What the design does about it: the embed field's tile (stencil.cuh). A
// block of 256 threads takes a 64 x 64 tile, copies it with a clamped halo
// of p/2 pixels into shared memory by cp.async (16-byte chunks where the
// frame allows), and nvf_region masks it: a thread takes 16 rows of one
// column and adds p row sums down the column for each row, its own row sums
// or, at p=9, sums taken once per staged row into shared memory, so a pixel
// costs a few shared loads instead of 2p, and stores each mask value as it
// is found, a warp's 32 lanes 128 consecutive bytes. The sums run in the
// order of ops/nvf.py (across the columns, then down the rows), one
// rounding each, so the mask is bit-identical to it. A copy of the frames
// (Tensor.copy_, the same 8 bytes a pixel) takes ~0.047 ms on an H100 at
// 700 W; this kernel ~0.056 / 0.061 / 0.069 / 0.074 ms at p = 3 / 5 / 7 / 9
// (tools/ab_standalone.py), 1.2-1.6x that.
#include <cuda_pipeline.h>

#include <atomic>

#include "stencil.cuh"

using namespace wm::stencil;

namespace {

// The layout of one instantiation (sizes in floats): the staged frame,
// s_img[k * kIS + c] = frame(clamp(y0 - kNH + k), clamp(x0 - kNH - kOff +
// c)), kOff putting the frame's 16-byte chunks on 16-byte boundaries, then,
// with shared row sums, the sums of x and of x^2 of each staged row.
template <int kNH>
struct Mask {
  static constexpr int kOff = (4 - kNH % 4) % 4;
  static constexpr int kIH = kTileH + 2 * kNH;
  static constexpr int kIW = kOff + kTileW + 2 * kNH;
  static constexpr int kIS = bank_stride(kIW);
  // row sums shared at p=9 only, as the embed field chooses: a thread's own
  // took 5% longer there, shared ones 4-12% longer at p = 5, 7
  // (tools/ab_standalone.py)
  static constexpr bool kSharedSums = kNH >= 4;
  static constexpr int kCR = 16;  // rows a thread masks
  static constexpr int kSS = bank_stride(kTileW);
  static constexpr int kSumAt = kIH * kIS;
  static constexpr int kFloats = kSumAt + (kSharedSums ? 2 * kIH * kSS : 0);
};

// Four blocks an SM (at most 64 registers, no spill): three were 4-7%
// slower at p = 5, 7; five, or eight rows a thread with five or six
// blocks, 2-13% slower in all but one reading. The threads store the mask
// straight from nvf_region, a warp's lanes consecutive columns of a row,
// 128 bytes a store: through a shared mask plane and float4 stores it took
// 5-8% longer (tools/ab_standalone.py).
template <int kNH>
__global__ void __launch_bounds__(kThreads, 4)
    nvf_mask_kernel(const float* __restrict__ img, float* __restrict__ out,
                    int rows, int cols) {
  using G = Mask<kNH>;
  extern __shared__ __align__(16) float s_nvf[];  // G::kFloats

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.x;
  const size_t plane = static_cast<size_t>(rows) * cols;
  stage_async<G::kIH, (G::kIW + 3) / 4, G::kIS>(
      s_nvf, img + b * plane, y0 - kNH, x0 - kNH - G::kOff, rows, cols, tid);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  nvf_region<kNH, kTileH, kTileW, G::kIH, G::kIS, G::kOff, G::kCR,
             G::kSharedSums, G::kSS>(
      s_nvf, s_nvf + G::kSumAt, tid, [&](int r, int q, float mask) {
        if (y0 + r < rows && x0 + q < cols)
          out[b * plane + static_cast<size_t>(y0 + r) * cols + x0 + q] = mask;
      });
}

template <int kNH>
int launch(const float* img, float* out, int batch, int rows, int cols,
           cudaStream_t s) {
  constexpr int bytes = Mask<kNH>::kFloats * sizeof(float);
  if constexpr (bytes > 48 * 1024) {
    // past 48 KB (p=9: 61 KB) a kernel must be allowed its dynamic shared
    // memory, once on each device
    static std::atomic<unsigned> allowed{0};  // a bit a device
    int device = 0;
    cudaGetDevice(&device);
    if (device >= 32 || !(allowed.load() >> device & 1u)) {
      const cudaError_t code = cudaFuncSetAttribute(
          nvf_mask_kernel<kNH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          bytes);
      if (code != cudaSuccess) return static_cast<int>(code);
      if (device < 32) allowed.fetch_or(1u << device);
    }
  }
  const dim3 grid(wm::ceil_div(cols, kTileW), wm::ceil_div(rows, kTileH),
                  batch);
  nvf_mask_kernel<kNH><<<grid, kThreads, bytes, s>>>(img, out, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img (batch, rows, cols) f32 -> out (batch, rows, cols) f32.
extern "C" int wm_nvf_mask(const float* img, float* out, int batch, int rows,
                           int cols, int p, void* stream) {
  if (batch < 1 || rows < 1 || cols < 1) return cudaErrorInvalidValue;
  if (batch > 65535 || wm::ceil_div(rows, kTileH) > 65535)
    return cudaErrorInvalidValue;  // gridDim.z, gridDim.y
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 3: return launch<1>(img, out, batch, rows, cols, s);
    case 5: return launch<2>(img, out, batch, rows, cols, s);
    case 7: return launch<3>(img, out, batch, rows, cols, s);
    case 9: return launch<4>(img, out, batch, rows, cols, s);
  }
  return cudaErrorInvalidValue;
}
