// Fused embed field and detect tail: everything after the predictor solve,
// one pass over the frame each, for p in {3, 5, 7, 9}.
//
// Replaces:
//   embed_field_kernel (ME p=3) and embed_field_tile_kernel (the rest)
//       <- the JAX package's ops/pallas/fused.py::_embed_field_kernel and
//       its raw twin _embed_field_kernel_raw (body _embed_field_core);
//   detect_tail_kernel  <- fused.py::_detect_tail_kernel and its raw twin
//       _detect_tail_kernel_raw (body _detect_tail_core -> _tail_rows, with
//       _error_region, _nvf_region and _clamp_fix_ring).
//
// Windows: ME predicts with the (p*p-1)-tap window (half-width PH = p/2);
// NVF keeps the 3x3 predictor (PH = 1) and takes its variance over p x p
// (half-width NH = p/2).
//
// What bounds them on an H100: device memory, except the ME detect tail at
// p >= 5. The embed field reads the frame and the watermark and writes
// u_raw: 12 bytes a pixel, about 200 MB at 1080p x 8 (59 us at 3.35 TB/s);
// ME p=9 does some 165 flops a pixel (41 us of f32), the NVF mask's
// separable box sums about 4p + 3. The detect tail reads 8 bytes a pixel
// (133 MB, 40 us) but at ME p=9 does two 80-tap predictions a pixel, some
// 330 flops (81 us of f32), so it is bound by operations there.
//
// What the design does about it: each input is read once, coalesced, and
// nothing intermediate goes to device memory: no padded copies (loads clamp
// their indices), no e or mask planes. The ME mask's 1/max|e| is not applied
// (it cancels in the pixels and in the correlation; the wrapper only
// reports max|e| for the strength). Per-block sums and maxes go to a small
// partials buffer that the wrapper finishes. The embed field stages a tile
// with its halo in shared memory, since a p x p window in registers would
// take up to 81 a thread, and the 24/48/80 coefficients of the wide windows
// stay in shared memory too. Only ME at p=3 walks one column a thread with
// the 3x3 window in registers instead: there the tile took 3-9% longer
// (8 x 1080 x 1920 on an H100, PERF.md).
//
// Detect tail: e_u(y,x) = u(y,x) - sum_k c_k u(clamp(y+dr), clamp(x+dc)) with
// u(q) = mask(q) * W(q), mask(q) = |e_z(q)| (ME) or nvf(q) (NVF). The ring of
// u outside the frame is clamp-to-edge of u itself, not u computed from
// edge-replicated frame rows (reference Watermark.cpp:221-225); evaluating u
// only at clamped coordinates gives exactly that, at any ring depth. Each
// block stages its tile of the frame with a clamped halo of S pixels in
// shared memory (S = 2 PH for ME, PH + max(PH, NH) for NVF), computes e_z and
// u over the tile plus a PH-pixel ring at clamped coordinates, then e_u.
#include "common.cuh"

namespace {

// ---- ME embed field at p=3: one column per thread, kRows rows down it ---

constexpr int kEmbedThreads = 128;
constexpr int kEmbedRows = 32;
constexpr int kEmbedSlots = 2;  // sum u_raw^2, max |e|

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

  float c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) c[k] = __ldg(coeffs + b * 8 + k);

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
      const float mask = fabsf(wm::prediction_error(w, c));
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

// ---- tiles in shared memory: the embed field and the detect tail --------

constexpr int kTileW = 64;
constexpr int kTileH = 32;
constexpr int kTileThreadsX = 32;
constexpr int kTileThreadsY = 8;
constexpr int kDetectSlots = 3;  // sum e_u*e_z, sum e_u^2, sum e_z^2

__host__ __device__ constexpr int taps(int half) {
  return (2 * half + 1) * (2 * half + 1) - 1;
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
    const int gy = wm::clampi(y0 - halo + r, 0, rows - 1);
    const int gx = wm::clampi(x0 - halo + q, 0, cols - 1);
    s[r][q] = __ldg(frame + static_cast<size_t>(gy) * cols + gx);
  }
}

template <int K>
__device__ __forceinline__ void stage_coeffs(float* s_c,
                                             const float* __restrict__ coeffs,
                                             int b, int tid, int n_threads) {
  for (int k = tid; k < K; k += n_threads) s_c[k] = __ldg(coeffs + b * K + k);
}

// kHalf: the predictor's half-width (ME) or the NVF window's (NVF).
template <int kMask, int kHalf>
__global__ void __launch_bounds__(kTileThreadsX * kTileThreadsY)
    embed_field_tile_kernel(const float* __restrict__ img,
                            const float* __restrict__ wmark,
                            const float* __restrict__ coeffs,
                            float* __restrict__ u_raw,
                            float* __restrict__ partials, int rows,
                            int cols) {
  constexpr int kTaps = kMask == wm::kMaskME ? taps(kHalf) : 1;
  constexpr int kIW = kTileW + 2 * kHalf;
  __shared__ float s_img[kTileH + 2 * kHalf][kIW];
  __shared__ float s_c[kTaps];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = static_cast<size_t>(rows) * cols;
  const int tid = threadIdx.x + threadIdx.y * blockDim.x;
  const int n_threads = blockDim.x * blockDim.y;
  if (kMask == wm::kMaskME) stage_coeffs<kTaps>(s_c, coeffs, b, tid, n_threads);
  stage_tile<kTileH + 2 * kHalf, kIW>(s_img, img + b * plane, y0, x0, kHalf,
                                      rows, cols, tid, n_threads);
  __syncthreads();
  const wm::Coeffs<kTaps> c(s_c);

  float acc[kEmbedSlots] = {0.0f, 0.0f};
  for (int i = tid; i < kTileH * kTileW; i += n_threads) {
    const int r = i / kTileW;
    const int q = i % kTileW;
    const int y = y0 + r;
    const int x = x0 + q;
    if (y < rows && x < cols) {
      const float* centre = &s_img[r + kHalf][q + kHalf];
      float mask;
      if (kMask == wm::kMaskME) {
        mask = fabsf(wm::prediction_error_at<kHalf>(centre, kIW, c));
      } else {
        mask = wm::nvf_at<kHalf>(centre, kIW);  // max slot unused for NVF
      }
      const size_t at = static_cast<size_t>(y) * cols + x;
      const float u = __fmul_rn(mask, __ldg(wmark + at));
      u_raw[b * plane + at] = u;
      acc[0] += u * u;
      acc[1] = fmaxf(acc[1], mask);
    }
  }
  const size_t block = (static_cast<size_t>(b) * gridDim.y + blockIdx.y) *
                           gridDim.x + blockIdx.x;
  wm::block_reduce_store<kEmbedSlots, 1>(acc, partials + block * kEmbedSlots);
}

// kPH: the predictor's half-width; kNH: the NVF window's (NVF only).
template <int kMask, int kPH, int kNH>
__global__ void __launch_bounds__(kTileThreadsX * kTileThreadsY)
    detect_tail_kernel(const float* __restrict__ img,
                       const float* __restrict__ wmark,
                       const float* __restrict__ coeffs,
                       float* __restrict__ partials, int rows, int cols) {
  constexpr int kTaps = taps(kPH);
  constexpr int kS = kMask == wm::kMaskME ? 2 * kPH
                                          : kPH + (kNH > kPH ? kNH : kPH);
  constexpr int kIW = kTileW + 2 * kS;
  constexpr int kUW = kTileW + 2 * kPH;
  constexpr int kUH = kTileH + 2 * kPH;
  // s_img[r][q] = frame(clamp(y0 - kS + r), clamp(x0 - kS + q))
  __shared__ float s_img[kTileH + 2 * kS][kIW];
  // s_u[r][q] = u(clamp(y0 - kPH + r), clamp(x0 - kPH + q))
  __shared__ float s_u[kUH][kUW];
  // s_ez[r][q] = e_z(y0 + r, x0 + q)
  __shared__ float s_ez[kTileH][kTileW];
  __shared__ float s_c[kTaps];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.x + threadIdx.y * blockDim.x;
  const int n_threads = blockDim.x * blockDim.y;
  stage_coeffs<kTaps>(s_c, coeffs, b, tid, n_threads);
  stage_tile<kTileH + 2 * kS, kIW>(
      s_img, img + static_cast<size_t>(b) * rows * cols, y0, x0, kS, rows,
      cols, tid, n_threads);
  __syncthreads();
  const wm::Coeffs<kTaps> c(s_c);

  for (int i = tid; i < kUH * kUW; i += n_threads) {
    const int r = i / kUW;
    const int q = i % kUW;
    const int cy = wm::clampi(y0 - kPH + r, 0, rows - 1);
    const int cx = wm::clampi(x0 - kPH + q, 0, cols - 1);
    // (cy, cx) sits at s_img[cy - y0 + kS][cx - x0 + kS]: clamping only
    // pulls it toward the tile, so its window stays inside the halo
    const float* centre = &s_img[cy - y0 + kS][cx - x0 + kS];
    const float e_z = wm::prediction_error_at<kPH>(centre, kIW, c);
    const float mask = kMask == wm::kMaskME ? fabsf(e_z)
                                            : wm::nvf_at<kNH>(centre, kIW);
    s_u[r][q] = __fmul_rn(
        mask, __ldg(wmark + static_cast<size_t>(cy) * cols + cx));
    if (r >= kPH && r < kPH + kTileH && q >= kPH && q < kPH + kTileW)
      s_ez[r - kPH][q - kPH] = e_z;
  }
  __syncthreads();

  float acc[kDetectSlots] = {0.0f, 0.0f, 0.0f};
  for (int i = tid; i < kTileH * kTileW; i += n_threads) {
    const int r = i / kTileW;
    const int q = i % kTileW;
    if (y0 + r < rows && x0 + q < cols) {
      const float e_u =
          wm::prediction_error_at<kPH>(&s_u[r + kPH][q + kPH], kUW, c);
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

const dim3 kTileBlock(kTileThreadsX, kTileThreadsY);

dim3 tile_grid(int batch, int rows, int cols) {
  return dim3(wm::ceil_div(cols, kTileW), wm::ceil_div(rows, kTileH), batch);
}

template <int kMask, int kHalf>
int launch_embed_tile(const float* img, const float* wmark,
                      const float* coeffs, float* u_raw, float* partials,
                      int batch, int rows, int cols, cudaStream_t s) {
  embed_field_tile_kernel<kMask, kHalf>
      <<<tile_grid(batch, rows, cols), kTileBlock, 0, s>>>(
          img, wmark, coeffs, u_raw, partials, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

template <int kMask, int kPH, int kNH>
int launch_detect(const float* img, const float* wmark, const float* coeffs,
                  float* partials, int batch, int rows, int cols,
                  cudaStream_t s) {
  detect_tail_kernel<kMask, kPH, kNH>
      <<<tile_grid(batch, rows, cols), kTileBlock, 0, s>>>(
          img, wmark, coeffs, partials, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

static bool column_walk(int mask_type, int p) {
  return mask_type == wm::kMaskME && p == 3;
}

extern "C" int wm_embed_field_num_blocks(int rows, int cols, int mask_type,
                                         int p) {
  if (column_walk(mask_type, p))
    return wm::ceil_div(cols, kEmbedThreads) * wm::ceil_div(rows, kEmbedRows);
  return wm::ceil_div(cols, kTileW) * wm::ceil_div(rows, kTileH);
}

// img, wmark (batch, rows, cols) / (rows, cols) f32; coeffs (batch, p*p-1)
// f32 (ME only, may be null for NVF) -> u_raw (batch, rows, cols) and
// partials (batch, wm_embed_field_num_blocks(rows, cols, mask_type, p), 2)
// f32.
extern "C" int wm_embed_field(const float* img, const float* wmark,
                              const float* coeffs, float* u_raw,
                              float* partials, int batch, int rows, int cols,
                              int mask_type, int p, void* stream) {
  if (batch < 1 || rows < 1 || cols < 1) return cudaErrorInvalidValue;
  if (mask_type == wm::kMaskME && coeffs == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (column_walk(mask_type, p)) {
    const dim3 grid(wm::ceil_div(cols, kEmbedThreads),
                    wm::ceil_div(rows, kEmbedRows), batch);
    embed_field_kernel<<<grid, kEmbedThreads, 0, s>>>(
        img, wmark, coeffs, u_raw, partials, rows, cols);
    return static_cast<int>(cudaGetLastError());
  }
#define WM_EMBED(mask, half)                                               \
  launch_embed_tile<mask, half>(img, wmark, coeffs, u_raw, partials, batch, \
                                rows, cols, s)
  if (mask_type == wm::kMaskME) {
    switch (p) {
      case 5: return WM_EMBED(wm::kMaskME, 2);
      case 7: return WM_EMBED(wm::kMaskME, 3);
      case 9: return WM_EMBED(wm::kMaskME, 4);
    }
  } else if (mask_type == wm::kMaskNVF) {
    switch (p) {
      case 3: return WM_EMBED(wm::kMaskNVF, 1);
      case 5: return WM_EMBED(wm::kMaskNVF, 2);
      case 7: return WM_EMBED(wm::kMaskNVF, 3);
      case 9: return WM_EMBED(wm::kMaskNVF, 4);
    }
  }
#undef WM_EMBED
  return cudaErrorInvalidValue;
}

extern "C" int wm_detect_partials_num_blocks(int rows, int cols) {
  return wm::ceil_div(cols, kTileW) * wm::ceil_div(rows, kTileH);
}

// img (batch, rows, cols), wmark (rows, cols) f32; coeffs (batch, k) f32 with
// k = p*p-1 for ME and 8 for NVF -> partials (batch, n_blocks, 3) f32.
extern "C" int wm_detect_partials(const float* img, const float* wmark,
                                  const float* coeffs, float* partials,
                                  int batch, int rows, int cols,
                                  int mask_type, int p, void* stream) {
  if (batch < 1 || rows < 1 || cols < 1 || coeffs == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WM_DETECT(mask, ph, nh)                                            \
  launch_detect<mask, ph, nh>(img, wmark, coeffs, partials, batch, rows,  \
                              cols, s)
  if (mask_type == wm::kMaskME) {
    switch (p) {
      case 3: return WM_DETECT(wm::kMaskME, 1, 0);
      case 5: return WM_DETECT(wm::kMaskME, 2, 0);
      case 7: return WM_DETECT(wm::kMaskME, 3, 0);
      case 9: return WM_DETECT(wm::kMaskME, 4, 0);
    }
  } else if (mask_type == wm::kMaskNVF) {
    switch (p) {
      case 3: return WM_DETECT(wm::kMaskNVF, 1, 1);
      case 5: return WM_DETECT(wm::kMaskNVF, 1, 2);
      case 7: return WM_DETECT(wm::kMaskNVF, 1, 3);
      case 9: return WM_DETECT(wm::kMaskNVF, 1, 4);
    }
  }
#undef WM_DETECT
  return cudaErrorInvalidValue;
}
