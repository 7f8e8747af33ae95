// Fused embed field and detect tail: everything after the 8x8 solve, one
// pass over the frame each.
//
// Replaces:
//   embed_field_kernel  <- the JAX package's ops/pallas/fused.py::
//       _embed_field_kernel and its raw twin _embed_field_kernel_raw
//       (body _embed_field_core);
//   detect_tail_kernel  <- fused.py::_detect_tail_kernel and its raw twin
//       _detect_tail_kernel_raw (body _detect_tail_core -> _tail_rows, with
//       _error_region, _nvf_region and _clamp_fix_ring).
//
// What bounds them on an H100: device-memory bytes. The embed field reads
// the frame and the watermark and writes u_raw (12 bytes a pixel, about
// 200 MB at 1080p x 8) for some 20 flops a pixel; the detect tail reads the
// frame and the watermark (8 bytes a pixel, plus a ~10% halo) for some 40.
// Both are far below the card's 20 flops-per-byte ridge for f32.
//
// What the design does about it: each input is read once, coalesced, and
// nothing intermediate goes to device memory: no padded copies (loads clamp
// their indices), no e or mask planes. The ME mask's 1/max|e| is not applied
// (it cancels in the pixels and in the correlation; the wrapper only
// reports max|e| for the strength). Per-block sums and maxes go to a small
// partials buffer that the wrapper finishes.
//
// Detect tail: e_u(y,x) = u(y,x) - sum_k c_k u(clamp(y+dr), clamp(x+dc)) with
// u(q) = mask(q) * W(q), mask(q) = |e_z(q)| (ME) or nvf(q) (NVF). The ring of
// u outside the frame is clamp-to-edge of u itself, not u computed from
// edge-replicated frame rows (reference Watermark.cpp:221-225); evaluating u
// only at clamped coordinates gives exactly that. Each block stages its tile
// of the frame with a 2-pixel clamped halo in shared memory, computes e_z and
// u over the tile plus a 1-pixel ring at clamped coordinates, then e_u.
// NVF detection keeps the 3x3 predictor.
#include "common.cuh"

namespace {

// ---- embed field: one column per thread, kRows rows down it -------------

constexpr int kEmbedThreads = 128;
constexpr int kEmbedRows = 32;
constexpr int kEmbedSlots = 2;  // sum u_raw^2, max |e|

template <int kMask>
__global__ void __launch_bounds__(kEmbedThreads)
    embed_field_kernel(const float* __restrict__ img,
                       const float* __restrict__ wmark,
                       const float* __restrict__ coeffs,
                       float* __restrict__ u_raw,
                       float* __restrict__ partials, int rows, int cols) {
  const int b = blockIdx.z;
  const int x = blockIdx.x * kEmbedThreads + threadIdx.x;
  const int y0 = blockIdx.y * kEmbedRows;
  const int y1 = min(y0 + kEmbedRows, rows);
  const size_t plane = static_cast<size_t>(rows) * cols;
  const float* frame = img + b * plane;
  float* u_out = u_raw + b * plane;

  float c[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (kMask == wm::kMaskME) {
#pragma unroll
    for (int k = 0; k < 8; ++k) c[k] = __ldg(coeffs + b * 8 + k);
  }

  float acc[kEmbedSlots] = {0.0f, 0.0f};
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
      float mask;
      if (kMask == wm::kMaskME) {
        mask = fabsf(wm::prediction_error(w, c));
      } else {
        mask = wm::nvf3(w);  // the max slot then holds max(mask), unused
      }
      const size_t at = static_cast<size_t>(y) * cols + x;
      const float u = __fmul_rn(mask, __ldg(wmark + at));
      u_out[at] = u;
      acc[0] += u * u;
      acc[1] = fmaxf(acc[1], mask);
      w.t0 = w.m0; w.t1 = w.m1; w.t2 = w.m2;
      w.m0 = w.b0; w.m1 = w.b1; w.m2 = w.b2;
    }
  }
  const size_t block = (static_cast<size_t>(b) * gridDim.y + blockIdx.y) *
                           gridDim.x + blockIdx.x;
  wm::block_reduce_store<kEmbedSlots, 1>(acc, partials + block * kEmbedSlots);
}

// ---- detect tail: shared-memory tiles ------------------------------------

constexpr int kTileW = 64;
constexpr int kTileH = 32;
constexpr int kDetectThreadsX = 32;
constexpr int kDetectThreadsY = 8;
constexpr int kDetectSlots = 3;  // sum e_u*e_z, sum e_u^2, sum e_z^2

__device__ __forceinline__ wm::Window window_at(const float (*s)[kTileW + 4],
                                                int r, int q) {
  wm::Window w;
  w.t0 = s[r - 1][q - 1]; w.t1 = s[r - 1][q]; w.t2 = s[r - 1][q + 1];
  w.m0 = s[r][q - 1];     w.m1 = s[r][q];     w.m2 = s[r][q + 1];
  w.b0 = s[r + 1][q - 1]; w.b1 = s[r + 1][q]; w.b2 = s[r + 1][q + 1];
  return w;
}

template <int kMask>
__global__ void __launch_bounds__(kDetectThreadsX * kDetectThreadsY)
    detect_tail_kernel(const float* __restrict__ img,
                       const float* __restrict__ wmark,
                       const float* __restrict__ coeffs,
                       float* __restrict__ partials, int rows, int cols) {
  // s_img[r][q] = frame(clamp(y0 - 2 + r), clamp(x0 - 2 + q))
  __shared__ float s_img[kTileH + 4][kTileW + 4];
  // s_u[r][q] = u(clamp(y0 - 1 + r), clamp(x0 - 1 + q))
  __shared__ float s_u[kTileH + 2][kTileW + 2];
  // s_ez[r][q] = e_z(y0 + r, x0 + q)
  __shared__ float s_ez[kTileH][kTileW];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const float* frame = img + static_cast<size_t>(b) * rows * cols;
  const int tid = threadIdx.x + threadIdx.y * blockDim.x;
  const int n_threads = blockDim.x * blockDim.y;

  float c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) c[k] = __ldg(coeffs + b * 8 + k);

  for (int i = tid; i < (kTileH + 4) * (kTileW + 4); i += n_threads) {
    const int r = i / (kTileW + 4);
    const int q = i % (kTileW + 4);
    const int gy = wm::clampi(y0 - 2 + r, 0, rows - 1);
    const int gx = wm::clampi(x0 - 2 + q, 0, cols - 1);
    s_img[r][q] = __ldg(frame + static_cast<size_t>(gy) * cols + gx);
  }
  __syncthreads();

  for (int i = tid; i < (kTileH + 2) * (kTileW + 2); i += n_threads) {
    const int r = i / (kTileW + 2);
    const int q = i % (kTileW + 2);
    const int cy = wm::clampi(y0 - 1 + r, 0, rows - 1);
    const int cx = wm::clampi(x0 - 1 + q, 0, cols - 1);
    // (cy, cx) sits at s_img[cy - y0 + 2][cx - x0 + 2], in [1, kTile + 2]
    const wm::Window w = window_at(s_img, cy - y0 + 2, cx - x0 + 2);
    const float e_z = wm::prediction_error(w, c);
    const float mask = kMask == wm::kMaskME ? fabsf(e_z) : wm::nvf3(w);
    s_u[r][q] = __fmul_rn(mask, __ldg(wmark + static_cast<size_t>(cy) * cols + cx));
    if (r >= 1 && r <= kTileH && q >= 1 && q <= kTileW) s_ez[r - 1][q - 1] = e_z;
  }
  __syncthreads();

  float acc[kDetectSlots] = {0.0f, 0.0f, 0.0f};
  for (int i = tid; i < kTileH * kTileW; i += n_threads) {
    const int r = i / kTileW;
    const int q = i % kTileW;
    if (y0 + r < rows && x0 + q < cols) {
      wm::Window w;
      w.t0 = s_u[r][q];     w.t1 = s_u[r][q + 1];     w.t2 = s_u[r][q + 2];
      w.m0 = s_u[r + 1][q]; w.m1 = s_u[r + 1][q + 1]; w.m2 = s_u[r + 1][q + 2];
      w.b0 = s_u[r + 2][q]; w.b1 = s_u[r + 2][q + 1]; w.b2 = s_u[r + 2][q + 2];
      const float e_u = wm::prediction_error(w, c);
      const float e_z = s_ez[r][q];
      acc[0] += e_u * e_z;
      acc[1] += e_u * e_u;
      acc[2] += e_z * e_z;
    }
  }
  const size_t block = (static_cast<size_t>(b) * gridDim.y + blockIdx.y) *
                           gridDim.x + blockIdx.x;
  wm::block_reduce_store<kDetectSlots, kDetectSlots>(
      acc, partials + block * kDetectSlots);
}

}  // namespace

extern "C" int wm_embed_field_num_blocks(int rows, int cols) {
  return wm::ceil_div(cols, kEmbedThreads) * wm::ceil_div(rows, kEmbedRows);
}

// img, wmark (batch, rows, cols) / (rows, cols) f32; coeffs (batch, 8) f32
// (ME only, may be null for NVF) -> u_raw (batch, rows, cols) and partials
// (batch, n_blocks, 2) f32.
extern "C" int wm_embed_field(const float* img, const float* wmark,
                              const float* coeffs, float* u_raw,
                              float* partials, int batch, int rows, int cols,
                              int mask_type, void* stream) {
  if (batch < 1 || rows < 1 || cols < 1) return cudaErrorInvalidValue;
  const dim3 grid(wm::ceil_div(cols, kEmbedThreads),
                  wm::ceil_div(rows, kEmbedRows), batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask_type == wm::kMaskME) {
    if (coeffs == nullptr) return cudaErrorInvalidValue;
    embed_field_kernel<wm::kMaskME><<<grid, kEmbedThreads, 0, s>>>(
        img, wmark, coeffs, u_raw, partials, rows, cols);
  } else if (mask_type == wm::kMaskNVF) {
    embed_field_kernel<wm::kMaskNVF><<<grid, kEmbedThreads, 0, s>>>(
        img, wmark, coeffs, u_raw, partials, rows, cols);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wm_detect_partials_num_blocks(int rows, int cols) {
  return wm::ceil_div(cols, kTileW) * wm::ceil_div(rows, kTileH);
}

// img (batch, rows, cols), wmark (rows, cols), coeffs (batch, 8) f32 ->
// partials (batch, n_blocks, 3) f32.
extern "C" int wm_detect_partials(const float* img, const float* wmark,
                                  const float* coeffs, float* partials,
                                  int batch, int rows, int cols,
                                  int mask_type, void* stream) {
  if (batch < 1 || rows < 1 || cols < 1 || coeffs == nullptr)
    return cudaErrorInvalidValue;
  const dim3 grid(wm::ceil_div(cols, kTileW), wm::ceil_div(rows, kTileH),
                  batch);
  const dim3 block(kDetectThreadsX, kDetectThreadsY);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask_type == wm::kMaskME) {
    detect_tail_kernel<wm::kMaskME><<<grid, block, 0, s>>>(
        img, wmark, coeffs, partials, rows, cols);
  } else if (mask_type == wm::kMaskNVF) {
    detect_tail_kernel<wm::kMaskNVF><<<grid, block, 0, s>>>(
        img, wmark, coeffs, partials, rows, cols);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
