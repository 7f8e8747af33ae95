// Wide-window ME Gram (p in {5, 7, 9}): per-lag lane partials
//   V[dc][dr][v] = sum_{y in [0, H)} P[y, v - h] * P[y + dr, v - h + dc]
// for lanes v in [0, W + 2h), dr in [0, 2h], dc in [-2h, 2h], with P the
// clamp-to-edge extension of the image and h = p / 2. The canonical lags
// among them (all but dr = 0, dc < 0) are what the Python side assembles
// into the (k+1) x (k+1) Gram (ops/me.py::assemble_wide).
//
// Replaces: the JAX package's ops/pallas/me_gram_wide.py::_wide_gram_kernel
// and its raw twin _wide_gram_kernel_raw (body _wide_gram_core), whose
// (B, L, W + 2h) lane-partial output is the contract kept here.
//
// What bounds it on an H100: arithmetic. Each lag costs one FMA per pixel:
// at 1080p x 8 that is 0.68 / 1.41 / 2.42 G FMA at p = 5 / 7 / 9, about
// 20 / 42 / 72 us at the card's f32 rate, against 66 MB read once (about
// 20 us at 3.35 TB/s).
//
// What the design does about it: one thread per output lane, one block per
// 128 lanes x one column lag dc x one image, walking all H rows. The thread
// keeps the 2h + 1 values P[y .. y + 2h, v - h + dc] in registers, so each
// row costs two loads (coalesced across the warp) for 2h + 1 FMAs, and its
// 2h + 1 sums stay in registers. Every read clamps its indices, so no padded
// copy of the image exists. Each thread writes its own sums: no atomics, and
// the result does not change from run to run. At 1080p x 8 and p = 9 the
// grid has 16 x 17 x 8 = 2,176 blocks.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // lanes per block

template <int H>
__global__ void __launch_bounds__(kThreads)
    me_gram_wide_kernel(const float* __restrict__ img, float* __restrict__ out,
                        int rows, int cols) {
  constexpr int kRowLags = 2 * H + 1;
  const int lanes = cols + 2 * H;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= lanes) return;
  const int dc = static_cast<int>(blockIdx.y) - 2 * H;
  const int b = blockIdx.z;
  const float* frame = img + static_cast<size_t>(b) * rows * cols;
  const int xb = wm::clampi(v - H, 0, cols - 1);       // base column
  const int xs = wm::clampi(v - H + dc, 0, cols - 1);  // shifted column

  float win[kRowLags];  // win[i] = P[y + i, v - h + dc]
#pragma unroll
  for (int i = 0; i < kRowLags; ++i)
    win[i] = __ldg(frame + static_cast<size_t>(min(i, rows - 1)) * cols + xs);
  float acc[kRowLags];
#pragma unroll
  for (int i = 0; i < kRowLags; ++i) acc[i] = 0.0f;

#pragma unroll 2
  for (int y = 0; y < rows; ++y) {
    const float base = __ldg(frame + static_cast<size_t>(y) * cols + xb);
    const float next = __ldg(
        frame + static_cast<size_t>(min(y + kRowLags, rows - 1)) * cols + xs);
#pragma unroll
    for (int i = 0; i < kRowLags; ++i) acc[i] += base * win[i];
#pragma unroll
    for (int i = 0; i + 1 < kRowLags; ++i) win[i] = win[i + 1];
    win[kRowLags - 1] = next;
  }

  float* dst = out + ((static_cast<size_t>(b) * gridDim.y + blockIdx.y) *
                      kRowLags) * lanes + v;
#pragma unroll
  for (int i = 0; i < kRowLags; ++i)
    dst[static_cast<size_t>(i) * lanes] = acc[i];
}

template <int H>
int launch(const float* img, float* out, int batch, int rows, int cols,
           cudaStream_t s) {
  const dim3 grid(wm::ceil_div(cols + 2 * H, kThreads), 4 * H + 1, batch);
  me_gram_wide_kernel<H><<<grid, kThreads, 0, s>>>(img, out, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img (batch, rows, cols) f32 -> out (batch, 4h+1, 2h+1, cols+2h) f32,
// out[b][dc + 2h][dr][v] = V[dc][dr][v]; half = h in {2, 3, 4}.
extern "C" int wm_me_gram_wide(const float* img, float* out, int batch,
                               int rows, int cols, int half, void* stream) {
  if (batch < 1 || rows < 1 || cols < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (half) {
    case 2: return launch<2>(img, out, batch, rows, cols, s);
    case 3: return launch<3>(img, out, batch, rows, cols, s);
    case 4: return launch<4>(img, out, batch, rows, cols, s);
  }
  return cudaErrorInvalidValue;
}
