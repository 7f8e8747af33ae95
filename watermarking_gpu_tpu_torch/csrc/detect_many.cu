// Multi-candidate detect: the detect tail of B frames against a bank of n
// candidate watermarks, for p in {3, 5, 7, 9}.
//
// Replaces: the JAX package's ops/pallas/fused.py::_detect_many_kernel and
// its raw twin _detect_many_kernel_raw (body _detect_many_core), behind
// fused_detect_many_partials_padded and fused_detect_many_partials. Per
// frame, once: e_z and the mask (|e_z| for ME, the NVF variance over p x p)
// and sum e_z^2. Per frame and candidate c: u = mask * W_c at clamped
// coordinates (so the ring is clamp-to-edge of u itself), e_u = u -
// sum_k c_k u(neighbour k), sum e_u*e_z and sum e_u^2.
//
// What bounds it on an H100: operations. 8 frames of 1080p against 64
// candidates read 597 MB (0.18 ms at 3.35 TB/s) and take 2k + 5 flops a
// frame, candidate and pixel (k taps): 0.34 ms of f32 at k = 8 and 2.65 ms
// at k = 80, counting a multiply-add as two flops at the FMA rate. Beneath
// that, shared-memory loads (an SM serves one warp-wide 4-byte load a clock
// against four warp-wide FP32 instructions) and, where a candidate costs few
// flops a pixel (p = 3, NVF), the L2 traffic of staging each candidate's
// tile once per frame.
//
// The design, in three steps:
// 1. One block per (frame, tile, chunk of 64 candidates), frames fastest in
//    the grid: the B blocks that read a bank tile run together, so the bank
//    comes from device memory about once and from L2 for the other frames.
//    e_z and the mask are built once a block. Each warp keeps its sums in a
//    slot of its own in shared memory, and one combine at the end writes the
//    block's 2 * 64 + 1 partials in a fixed order, with no float atomics.
// 2. The next two candidates' W tiles are copied with cp.async into two of
//    four buffers while the two before them compute (16-byte chunks of the
//    ring's rows, clamped to the rows held, where the tile's columns and
//    their ring lie inside the frame and the rows are 16-byte aligned, else
//    4-byte copies of the clamped ring): one barrier every two
//    candidates. At p >= 5 the copying thread multiplies its chunks by the
//    mask when they land; at p = 3 and for NVF (3 x 3 predictor) each thread
//    keeps the mask of its 3 x 10 window in registers and applies it to W as
//    it reads it.
// 3. Each thread computes 8 consecutive outputs of a row. Per tap row it loads
//    the row's 8 + 2 PH u values and 2 PH + 1 coefficients into registers
//    once and does 8 (2 PH + 1) fused multiply-adds: (8 + 4 PH + 1) / (8 (2 PH
//    + 1)) shared loads a tap instead of 2. FMA is used in e_u and the two
//    sums only; e_z and the mask keep common.cuh's __f*_rn form, bit-identical
//    to the detect tail's. The sums of 8 candidates (4 at p >= 5) are reduced
//    over the warp together, 16 values in 16 shuffles where one candidate at
//    a time would take 40.
//
// Halo form (a row shard of a frame; the JAX package's
// parallel/spatial.py::_detect_many_shard_pallas, with fused.cu's detect
// tail's contract): the frame and every candidate hold top rows above the
// rows owned and bottom rows below them, true neighbour rows at a seam and
// replicated edge rows at the frame's border. Reads clamp to those rows
// (img_rows = top + rows + bottom), the tiles cover the owned rows only,
// and u's ring rows outside the shard are u's edge rows only where the
// shard's edge is the frame's (clamp_top: row_start == 0, clamp_bottom:
// row_start + rows == total_rows); at a seam they are u of the true rows,
// which takes detect_halo rows of halo. top = bottom = 0 with both clamps
// is the frame itself.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

using wm::kTileH;
using wm::kTileThreads;
using wm::kTileW;

constexpr int kWarps = kTileThreads / 32;
constexpr int kManyNC = 64;  // candidates a block scores
// per block: (sum e_u*e_z, sum e_u^2) per candidate of its chunk, then
// sum e_z^2
constexpr int kManySlots = 2 * kManyNC + 1;
constexpr int kR = 8;  // consecutive outputs of a row a thread computes
// candidates staged and scored between two barriers; the u buffers hold two
// such groups, one computing while the next is copied
constexpr int kPair = 2;
constexpr int kBuffers = 2 * kPair;

// A u buffer row holds the frame columns [x0 - 4, x0 + kTileW + 4): 18
// 16-byte chunks, the ring of every p; its stride is 4 mod 8 floats, so that
// the window loads of eight lanes in eight consecutive rows (one phase of a
// warp's 128-bit shared load) fall in distinct banks.
constexpr int kChunksRow = (kTileW + 8) / 4;
constexpr int kUS = kTileW + 12;
static_assert(kUS >= 4 * kChunksRow && kUS % 8 == 4, "u buffer stride");

// Floats of the kernel's dynamic shared memory: the prologue's frame tile,
// e_z and mask, or the u buffers, whichever is larger.
__host__ __device__ constexpr int many_scratch(int mask, int ph, int nh) {
  const int s = wm::detect_halo(mask, ph, nh);
  const int prolog = (kTileH + 2 * s) * (kTileW + 2 * s) + kTileH * kTileW +
                     (kTileH + 2 * ph) * (kTileW + 2 * ph);
  const int buffers = kBuffers * (kTileH + 2 * ph) * kUS;
  return prolog > buffers ? prolog : buffers;
}

// Sum each of v[0..V) over the warp, V a power of two up to 32, in V - 1 +
// 5 - log2(V) shuffles: while a lane holds several values, half the lanes
// keep the upper half of theirs and half the lower, and each adds its
// partner's copy of what it keeps. Afterwards lane l holds the warp sum of
// value l / (32 / V) in v[0].
template <int V>
__device__ __forceinline__ void warp_sums(float (&v)[V], int lane) {
  int n = V;
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    if (n > 1) {
      const bool upper = lane & offset;
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        if (i < n / 2) {
          const float keep = upper ? v[i + n / 2] : v[i];
          const float send = upper ? v[i] : v[i + n / 2];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, offset);
        }
      }
      n /= 2;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], offset);
    }
  }
}

// blockIdx = (frame, tile, chunk): one tile of one frame against candidates
// [chunk * kManyNC, + count). Partials (batch, n_chunks, n_tiles,
// kManySlots); the slots of candidates past the bank's end are written as 0.
// A frame of img and of bank holds img_rows rows, the rows owned from row
// top (the halo form); clamp_top / clamp_bottom: the shard's top / bottom
// edge is the frame's.
template <int kMask, int kPH, int kNH>
__global__ void __launch_bounds__(kTileThreads, 2)
    detect_many_kernel(const float* __restrict__ img,
                       const float* __restrict__ bank,
                       const float* __restrict__ coeffs,
                       float* __restrict__ partials, int n, int rows,
                       int cols, int top, int img_rows, bool clamp_top,
                       bool clamp_bottom) {
  constexpr int kTaps = wm::taps(kPH);
  constexpr int kP = 2 * kPH + 1;
  constexpr int kS = wm::detect_halo(kMask, kPH, kNH);
  constexpr int kIH = kTileH + 2 * kS;
  constexpr int kIW = kTileW + 2 * kS;
  constexpr int kUH = kTileH + 2 * kPH;
  constexpr int kUW = kTileW + 2 * kPH;
  constexpr int kRing = kUH * kUW;
  constexpr int kOff = 4 - kPH;  // ring column q sits in buffer column q + kOff
  constexpr int kUBuf = kUH * kUS;
  constexpr int kChunks = kUH * kChunksRow;
  constexpr int kPer = (kChunks + kTileThreads - 1) / kTileThreads;
  constexpr int kWin = kR + 2 * kPH;  // a window row: kR outputs and ring
  constexpr int kCW = (kP + 3) / 4 * 4;  // a coefficient row, padded
  constexpr bool kCoeffRegs = kPH <= 2;  // 8 or 24 coefficients
  // PH = 1: the thread keeps the mask of its 3 x 10 window and applies it to
  // W as it reads it; wider windows multiply the staged W in place
  constexpr bool kMaskAtRead = kPH == 1;
  constexpr int kG = kPH == 1 ? 8 : 4;  // candidates a reduction
  // the prologue's frame tile s_img[r][q] = frame(clamp(y0 - kS + r),
  // clamp(x0 - kS + q)), e_z over the tile and the mask over the tile and
  // its ring, s_mask[r * kUW + q] = mask(ring(y0 - kPH + r),
  // clamp(x0 - kPH + q)); then kBuffers u buffers,
  // u[r * kUS + q + kOff] = u(ring(y0 - kPH + r), clamp(x0 - kPH + q)).
  // Rows count from the first owned one: clamp() clamps to the shard's
  // rows [-top, rows + bottom), ring() to the frame's rows where the
  // shard's edge is the frame's and to the shard's rows at a seam
  extern __shared__ __align__(16) float s_scratch[];  // many_scratch floats
  __shared__ float s_c[kTaps];
  // s_cg[dr][dc]: the coefficient of tap (dr - kPH, dc - kPH), centre 0
  __shared__ __align__(16) float s_cg[kP][kCW];
  __shared__ float s_warp[kWarps][kManySlots];
  float(*s_img)[kIW] = reinterpret_cast<float(*)[kIW]>(s_scratch);
  float(*s_ez)[kTileW] =
      reinterpret_cast<float(*)[kTileW]>(s_scratch + kIH * kIW);
  float* s_mask = s_scratch + kIH * kIW + kTileH * kTileW;

  const int b = blockIdx.x;
  const int tiles_x = wm::ceil_div(cols, kTileW);
  const int x0 = (blockIdx.y % tiles_x) * kTileW;
  const int y0 = (blockIdx.y / tiles_x) * kTileH;
  const int first = blockIdx.z * kManyNC;
  const int count = min(kManyNC, n - first);
  const size_t plane = static_cast<size_t>(img_rows) * cols;
  // ring(y) + top: a row of the ring in the shard's rows
  const int ring_lo = clamp_top ? top : 0;
  const int ring_hi = clamp_bottom ? top + rows - 1 : img_rows - 1;
  const int tid = threadIdx.x + threadIdx.y * blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // this thread's outputs: (y0 + r, x0 + q0 + j), j < kR; lanes 0-7 of a
  // warp take eight consecutive rows of one column segment
  const int r = (warp & 3) * 8 + (lane & 7);
  const int q0 = ((warp >> 2) * 4 + (lane >> 3)) * kR;
  const int n_valid = y0 + r < rows ? wm::clampi(cols - x0 - q0, 0, kR) : 0;
  // a buffer row (a ring row, clamped to the rows held) is one 16-byte copy
  // a chunk where the 18 chunks lie inside the frame's columns and the rows
  // are 16-byte aligned; else 4-byte copies of the ring's clamped columns
  const bool whole_chunks = cols % 4 == 0 && x0 >= 4 &&
                            x0 + kTileW + 4 <= cols &&
                            reinterpret_cast<size_t>(bank) % 16 == 0;
  wm::stage_coeffs<kTaps>(s_c, coeffs, b, tid, kTileThreads);
  for (int i = tid; i < kP * kCW; i += kTileThreads) {
    const int dr = i / kCW;
    const int dc = i % kCW;
    const int k = dr * kP + dc;  // row-major, the centre left out
    s_cg[dr][dc] =
        dc >= kP || k == kTaps / 2
            ? 0.0f
            : __ldg(coeffs + b * kTaps + (k < kTaps / 2 ? k : k - 1));
  }
  wm::stage_tile<kIH, kIW>(s_img, img + b * plane, y0 + top, x0, kS,
                           img_rows, cols, tid, kTileThreads);
  __syncthreads();
  const wm::Coeffs<kTaps> c(s_c);

  // e_z and the mask over the tile and its ring, once
  for (int i = tid; i < kRing; i += kTileThreads) {
    const int ur = i / kUW;
    const int uq = i % kUW;
    const int cy = wm::clampi(y0 + top - kPH + ur, ring_lo, ring_hi);
    const int cx = wm::clampi(x0 - kPH + uq, 0, cols - 1);
    const float* centre = &s_img[cy - y0 - top + kS][cx - x0 + kS];
    const float e_z = wm::prediction_error_at<kPH>(centre, kIW, c);
    s_mask[i] = kMask == wm::kMaskME ? fabsf(e_z)
                                     : wm::nvf_at<kNH>(centre, kIW);
    if (ur >= kPH && ur < kPH + kTileH && uq >= kPH && uq < kPH + kTileW)
      s_ez[ur - kPH][uq - kPH] = e_z;
  }
  __syncthreads();
  float e_z[kR];
  float norm_z = 0.0f;
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    e_z[j] = j < n_valid ? s_ez[r][q0 + j] : 0.0f;
    norm_z += e_z[j] * e_z[j];
  }
  // Each thread stages chunks tid + m * kTileThreads of every candidate's
  // buffer: it keeps their frame row offset, their column and, for the
  // in-place multiply, their mask (0 outside the ring).
  int row_at[kPer], col[kPer];
  float mask[kMaskAtRead ? 1 : kPer][4];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int i = tid + m * kTileThreads;
    const int ur = i / kChunksRow;
    col[m] = i % kChunksRow * 4;
    row_at[m] = wm::clampi(y0 + top - kPH + ur, ring_lo, ring_hi) * cols;
    if constexpr (!kMaskAtRead) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int q = col[m] + v - kOff;
        mask[m][v] = i < kChunks && q >= 0 && q < kUW ? s_mask[ur * kUW + q]
                                                      : 0.0f;
      }
    }
  }
  float mw[kMaskAtRead ? kP : 1][kMaskAtRead ? kWin : 1];
  if constexpr (kMaskAtRead) {
#pragma unroll
    for (int dr = 0; dr < kP; ++dr)
#pragma unroll
      for (int v = 0; v < kWin; ++v)
        mw[dr][v] = s_mask[(r + dr) * kUW + q0 + v];
  }
  float cg[kCoeffRegs ? kP : 1][kCoeffRegs ? kP : 1];
  if constexpr (kCoeffRegs) {
#pragma unroll
    for (int dr = 0; dr < kP; ++dr)
#pragma unroll
      for (int dc = 0; dc < kP; ++dc) cg[dr][dc] = s_cg[dr][dc];
  }
  norm_z = wm::warp_sum(norm_z);
  if (lane == 0) s_warp[warp][2 * kManyNC] = norm_z;
  __syncthreads();  // the prologue's buffers are dead: the u buffers follow

  // candidates k .. k + kPair - 1 -> u buffers k % kBuffers .., in flight
  // while the group before them computes; one commit group each, empty past
  // the chunk's end, so that a wait counts groups the same way throughout
  auto fetch = [&](int k) {
#pragma unroll
    for (int h = 0; h < kPair; ++h) {
      if (k + h >= count) break;
      float* buf = s_scratch + (k + h) % kBuffers * kUBuf;
      const float* wmark = bank + static_cast<size_t>(first + k + h) * plane;
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int i = tid + m * kTileThreads;
        if (i >= kChunks) continue;
        float* dst = buf + i / kChunksRow * kUS + col[m];
        if (whole_chunks) {
          __pipeline_memcpy_async(dst, wmark + row_at[m] + x0 - 4 + col[m],
                                  16);
        } else {
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int q = col[m] + v - kOff;
            if (q >= 0 && q < kUW)
              __pipeline_memcpy_async(
                  dst + v,
                  wmark + row_at[m] + wm::clampi(x0 - kPH + q, 0, cols - 1),
                  4);
          }
        }
      }
    }
    __pipeline_commit();
  };
  fetch(0);
  for (int k0 = 0; k0 < count; k0 += kG) {  // count is the block's own
    // (sum e_u*e_z, sum e_u^2) of candidates k0 .. k0 + kG - 1
    float sums[2 * kG];
#pragma unroll
    for (int g = 0; g < kG; g += kPair) {
      if (k0 + g < count) {
        // this thread's copies of the group landed
        __pipeline_wait_prior(0);
        if constexpr (!kMaskAtRead) {
#pragma unroll
          for (int h = 0; h < kPair; ++h) {
            if (k0 + g + h >= count) break;
            float* buf = s_scratch + (k0 + g + h) % kBuffers * kUBuf;
#pragma unroll
            for (int m = 0; m < kPer; ++m) {
              const int i = tid + m * kTileThreads;
              if (i >= kChunks) continue;
              float4* at = reinterpret_cast<float4*>(
                  buf + i / kChunksRow * kUS + col[m]);
              float4 u = *at;
              u.x = __fmul_rn(mask[kMaskAtRead ? 0 : m][0], u.x);
              u.y = __fmul_rn(mask[kMaskAtRead ? 0 : m][1], u.y);
              u.z = __fmul_rn(mask[kMaskAtRead ? 0 : m][2], u.z);
              u.w = __fmul_rn(mask[kMaskAtRead ? 0 : m][3], u.w);
              *at = u;
            }
          }
        }
        // the group's u is visible, and every thread is done with the
        // previous group's buffers, which the next group now fills
        __syncthreads();
        fetch(k0 + g + kPair);
      }
#pragma unroll
      for (int h = 0; h < kPair; ++h) {
        const int k = k0 + g + h;
        float dot = 0.0f, norm_u = 0.0f;
        if (k < count) {
          const float* buf = s_scratch + k % kBuffers * kUBuf;
          // e_u of the kR outputs, one tap row at a time (the centre row
          // first, to start each sum at u): the row's kWin u values and kP
          // coefficients are loaded into registers once and serve kR * kP
          // fused multiply-adds
          float e_u[kR];
#pragma unroll
          for (int t = 0; t < kP; ++t) {
            const int dr = t == 0 ? kPH : (t <= kPH ? t - 1 : t);
            const float* row = buf + (r + dr) * kUS + q0 + kOff;
            float w[kWin];
            wm::load_window<kOff, kWin>(row, w);
            if constexpr (kMaskAtRead) {
#pragma unroll
              for (int v = 0; v < kWin; ++v)
                w[v] = __fmul_rn(mw[kMaskAtRead ? dr : 0][kMaskAtRead ? v : 0],
                                 w[v]);
            }
            float cr[kP];
#pragma unroll
            for (int dc = 0; dc < kP; ++dc) {
              if constexpr (kCoeffRegs) {
                cr[dc] = cg[kCoeffRegs ? dr : 0][kCoeffRegs ? dc : 0];
              } else {
                cr[dc] = s_cg[dr][dc];
              }
            }
#pragma unroll
            for (int j = 0; j < kR; ++j) {
              if (t == 0) e_u[j] = w[j + kPH];
#pragma unroll
              for (int dc = 0; dc < kP; ++dc) {
                if (dr == kPH && dc == kPH) continue;
                e_u[j] = fmaf(-cr[dc], w[j + dc], e_u[j]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kR; ++j) {
            if (j < n_valid) {
              dot = fmaf(e_u[j], e_z[j], dot);
              norm_u = fmaf(e_u[j], e_u[j], norm_u);
            }
          }
        }
        sums[2 * (g + h)] = dot;
        sums[2 * (g + h) + 1] = norm_u;
      }
    }
    warp_sums(sums, lane);
    constexpr int kLanes = 32 / (2 * kG);  // lanes that hold each sum
    if (lane % kLanes == 0) s_warp[warp][2 * k0 + lane / kLanes] = sums[0];
  }
  __syncthreads();

  float* out = partials + ((static_cast<size_t>(b) * gridDim.z + blockIdx.z) *
                               gridDim.y + blockIdx.y) * kManySlots;
  for (int s = tid; s < kManySlots; s += kTileThreads) {
    float total = 0.0f;
    if (s == 2 * kManyNC || s < 2 * count) {
      total = s_warp[0][s];
      for (int w = 1; w < kWarps; ++w) total += s_warp[w][s];
    }
    out[s] = total;
  }
}

template <int kMask, int kPH, int kNH>
int launch_detect_many(const float* img, const float* bank,
                       const float* coeffs, float* partials, int batch, int n,
                       int rows, int cols, int top, int img_rows,
                       bool clamp_top, bool clamp_bottom, cudaStream_t s) {
  const dim3 grid(batch,
                  wm::ceil_div(cols, kTileW) * wm::ceil_div(rows, kTileH),
                  wm::ceil_div(n, kManyNC));
  constexpr int bytes = many_scratch(kMask, kPH, kNH) * sizeof(float);
  cudaFuncSetAttribute(detect_many_kernel<kMask, kPH, kNH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  detect_many_kernel<kMask, kPH, kNH>
      <<<grid, wm::kTileBlock, bytes, s>>>(img, bank, coeffs, partials, n,
                                           rows, cols, top, img_rows,
                                           clamp_top, clamp_bottom);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Candidates a block of wm_detect_many scores: its partials' chunk size.
extern "C" int wm_detect_many_chunk() { return kManyNC; }

// Tiles of a frame that wm_detect_many scores: its partials' dim 2.
extern "C" int wm_detect_many_num_blocks(int rows, int cols) {
  return wm::ceil_div(cols, kTileW) * wm::ceil_div(rows, kTileH);
}

// img (batch, top + rows + bottom, cols), bank (n, top + rows + bottom,
// cols) f32; coeffs (batch, k) f32 with k = p*p-1 for ME and 8 for NVF; the
// owned rows are rows [row_start, row_start + rows) of a frame of
// total_rows -> partials (batch, ceil(n / chunk),
// wm_detect_many_num_blocks(rows, cols), 2 * chunk + 1) f32 with chunk =
// wm_detect_many_chunk(): per candidate sum e_u*e_z and sum e_u^2, then
// sum e_z^2, over the owned rows.
extern "C" int wm_detect_many(const float* img, const float* bank,
                              const float* coeffs, float* partials,
                              int batch, int n, int rows, int cols,
                              int mask_type, int p, int top, int bottom,
                              int row_start, int total_rows, void* stream) {
  if (batch < 1 || n < 1 || rows < 1 || cols < 1 || coeffs == nullptr ||
      top < 0 || bottom < 0 || row_start < 0 ||
      total_rows < row_start + rows)
    return cudaErrorInvalidValue;
  const long long img_rows = static_cast<long long>(top) + rows + bottom;
  const long long tiles = static_cast<long long>(wm::ceil_div(cols, kTileW)) *
                          wm::ceil_div(rows, kTileH);
  if (tiles > 65535 || wm::ceil_div(n, kManyNC) > 65535)
    return cudaErrorInvalidValue;  // gridDim.y, gridDim.z
  if (img_rows * cols > 0x7fffffff)
    return cudaErrorInvalidValue;  // the kernel's offsets in a frame are int
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WM_MANY(mask, ph, nh)                                              \
  launch_detect_many<mask, ph, nh>(img, bank, coeffs, partials, batch, n, \
                                   rows, cols, top,                        \
                                   static_cast<int>(img_rows),             \
                                   row_start == 0,                         \
                                   row_start + rows == total_rows, s)
  if (mask_type == wm::kMaskME) {
    switch (p) {
      case 3: return WM_MANY(wm::kMaskME, 1, 0);
      case 5: return WM_MANY(wm::kMaskME, 2, 0);
      case 7: return WM_MANY(wm::kMaskME, 3, 0);
      case 9: return WM_MANY(wm::kMaskME, 4, 0);
    }
  } else if (mask_type == wm::kMaskNVF) {
    switch (p) {
      case 3: return WM_MANY(wm::kMaskNVF, 1, 1);
      case 5: return WM_MANY(wm::kMaskNVF, 1, 2);
      case 7: return WM_MANY(wm::kMaskNVF, 1, 3);
      case 9: return WM_MANY(wm::kMaskNVF, 1, 4);
    }
  }
#undef WM_MANY
  return cudaErrorInvalidValue;
}
