// The register-tiled p x p stencil machinery of the 64 x 64 tile kernels:
// the embed field and the detect tail (fused.cu), the standalone prediction
// error (predict.cu) and the standalone NVF mask (nvf.cu).
//
// A block of kThreads threads takes a kTileH x kTileW tile of one frame. It
// copies the tile and its clamped halo into shared memory by cp.async
// (stage_async: 16-byte chunks where a chunk lies inside the frame and is
// aligned, 4-byte clamped copies elsewhere), at a row stride whose 16-byte
// loads by eight lanes in eight consecutive rows fall in distinct banks
// (bank_stride), and a thread then computes kR consecutive outputs of a row
// (tile_item): per tap row, the row's kR + 2 PH pixels go into registers
// once with the widest aligned shared loads, with the tap row's
// coefficients (registers at PH <= 2, float4 rows of s_cg above), instead of
// two shared loads a tap (predict_rn). The NVF mask (nvf_region) adds p row
// sums down a column for each of a thread's rows instead of p^2 pixels a
// point; the row sums are the thread's own, or taken once per staged row
// into shared memory.
//
// Rounding: predict_rn keeps common.cuh's __f*_rn form, taps in row-major
// order from the centre value; nvf_region sums in ops/nvf.py's order. Both
// are therefore bit-identical to the plain versions, ops/me.py::
// prediction_error and ops/nvf.py::nvf_mask.
//
// The names live in wm::stencil: common.cuh's wm::kTileW / wm::kTileH are
// the 32 x 64 tile of detect_many.cu.
#pragma once

#include <cuda_pipeline.h>

#include "common.cuh"

namespace wm {
namespace stencil {

constexpr int kTileW = 64;
constexpr int kTileH = 64;
constexpr int kThreads = 256;
constexpr int kR = 8;    // consecutive outputs of a row a thread computes
constexpr int kTG = kTileW / kR;  // column groups of the tile

// The least row stride of at least n floats that is 4 mod 8: 16-byte loads
// by eight lanes in eight consecutive rows (one phase of a warp's 128-bit
// shared load) then fall in distinct banks.
__host__ __device__ constexpr int bank_stride(int n) {
  return (n + 3) / 8 * 8 + 4;
}

// Copy rows [y, y + kRows) and columns [x, x + 4 kChunks) of a (rows, cols)
// plane, each index clamped to the plane, into dst (row stride kStride) by
// cp.async: 16-byte chunks where a chunk lies inside the plane and its rows
// are 16-byte aligned (x is a multiple of 4), 4-byte copies elsewhere. The
// caller commits and waits.
template <int kRows, int kChunks, int kStride>
__device__ __forceinline__ void stage_async(float* dst,
                                            const float* __restrict__ plane,
                                            int y, int x, int rows, int cols,
                                            int tid) {
  const bool aligned =
      cols % 4 == 0 && reinterpret_cast<size_t>(plane) % 16 == 0;
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int k = i / kChunks;
    const int c = (i - k * kChunks) * 4;
    const float* row =
        plane + static_cast<size_t>(wm::clampi(y + k, 0, rows - 1)) * cols;
    float* d = dst + k * kStride + c;
    const int gx = x + c;
    if (aligned && gx >= 0 && gx + 4 <= cols) {
      __pipeline_memcpy_async(d, row + gx, 16);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        __pipeline_memcpy_async(d + v, row + wm::clampi(gx + v, 0, cols - 1),
                                4);
    }
  }
}

// The (2 kPH + 1)^2 - 1 coefficients of frame b as rows of the window,
// s_cg[dr][dc] = the coefficient of tap (dr - kPH, dc - kPH), the centre and
// the padding past the window 0.
template <int kPH, int kCW>
__device__ __forceinline__ void stage_coeff_rows(
    float (*s_cg)[kCW], const float* __restrict__ coeffs, int b, int tid) {
  constexpr int kP = 2 * kPH + 1;
  constexpr int kTaps = wm::taps(kPH);
  for (int i = tid; i < kP * kCW; i += kThreads) {
    const int dr = i / kCW;
    const int dc = i % kCW;
    const int k = dr * kP + dc;  // row-major, the centre left out
    s_cg[dr][dc] =
        dc >= kP || k == kTaps / 2
            ? 0.0f
            : __ldg(coeffs + b * kTaps + (k < kTaps / 2 ? k : k - 1));
  }
}

// The coefficient rows in registers (cg) at kInRegisters; a thread reads
// them from s_cg once the block has synchronised after stage_coeff_rows.
template <int kP, int kCW, bool kInRegisters>
__device__ __forceinline__ void coeff_regs(
    const float (*s_cg)[kCW],
    float (&cg)[kInRegisters ? kP : 1][kInRegisters ? kP : 1]) {
  if constexpr (kInRegisters) {
#pragma unroll
    for (int dr = 0; dr < kP; ++dr)
#pragma unroll
      for (int dc = 0; dc < kP; ++dc) cg[dr][dc] = s_cg[dr][dc];
  }
}

// Row t of the predictor's coefficients, cr[dc] = c(t - kPH, dc - kPH): from
// registers (cg) at kPH <= 2, else a padded row of s_cg.
template <int kP, int kCW, bool kInRegisters>
__device__ __forceinline__ void coeff_row(
    const float (&cg)[kInRegisters ? kP : 1][kInRegisters ? kP : 1],
    const float (*s_cg)[kCW], int t, float (&cr)[kP]) {
#pragma unroll
  for (int dc = 0; dc < kP; ++dc) {
    if constexpr (kInRegisters) {
      cr[dc] = cg[kInRegisters ? t : 0][kInRegisters ? dc : 0];
    } else {
      cr[dc] = s_cg[t][dc];
    }
  }
}

// The prediction errors e[j] of kR consecutive points of a row, rounded as
// common.cuh's prediction_error_at: the centre value, then the taps in
// row-major order, a __fmul_rn and a __fsub_rn each. top: the row of tap
// (-kPH, -kPH) of point 0, kAlign floats past a 16-byte boundary; per tap
// row the kR + 2 kPH values are loaded into registers once.
template <int kPH, int kAlign, int kCW, bool kCoeffRegs>
__device__ __forceinline__ void predict_rn(
    const float* top, int stride,
    const float (&cg)[kCoeffRegs ? 2 * kPH + 1 : 1]
                     [kCoeffRegs ? 2 * kPH + 1 : 1],
    const float (*s_cg)[kCW], float (&e)[kR]) {
  constexpr int kP = 2 * kPH + 1;
  constexpr int kWin = kR + 2 * kPH;
  {
    float w[kWin];
    wm::load_window<kAlign, kWin>(top + kPH * stride, w);
#pragma unroll
    for (int j = 0; j < kR; ++j) e[j] = w[j + kPH];
  }
#pragma unroll
  for (int t = 0; t < kP; ++t) {
    float w[kWin];
    wm::load_window<kAlign, kWin>(top + t * stride, w);
    float cr[kP];
    coeff_row<kP, kCW, kCoeffRegs>(cg, s_cg, t, cr);
#pragma unroll
    for (int j = 0; j < kR; ++j)
#pragma unroll
      for (int dc = 0; dc < kP; ++dc) {
        if (t == kPH && dc == kPH) continue;
        e[j] = __fsub_rn(e[j], __fmul_rn(cr[dc], w[j + dc]));
      }
  }
}

// The NVF mask (p = 2 kNH + 1) of every point (r, q) of a kRH x kRW region
// whose p x p window is staged rows [r, r + 2 kNH] and columns [q, q +
// 2 kNH] of s_img (kIH rows of stride kIS, column 0 kOff floats in, kOff
// the distance past a 16-byte boundary), handed to out(r, q, mask). The
// sums keep ops/nvf.py's order: across the columns, then down the rows. A
// thread takes kCR consecutive rows of one column, the lanes of a warp
// consecutive columns, and adds p row sums down the column for each: its
// own or, at kSharedSums, taken once per staged row into s_sums (the sums
// of x in kIH rows of stride kSS, then those of x^2); then every thread of
// the block must call it (it synchronises).
template <int kNH, int kRH, int kRW, int kIH, int kIS, int kOff, int kCR,
          bool kSharedSums, int kSS, typename Out>
__device__ __forceinline__ void nvf_region(const float* s_img, float* s_sums,
                                           int tid, Out out) {
  constexpr int kNP = 2 * kNH + 1;
  constexpr int kRG = (kRW + kR - 1) / kR;
  float* s_rs = s_sums;
  float* s_rq = s_sums + kIH * kSS;
  if constexpr (kSharedSums) {
    // s_rs[k * kSS + q]: staged row k over staged columns [q, q + 2 kNH],
    // kR consecutive columns a thread, lanes 0-7 in eight consecutive rows
    constexpr int kSW = kR + 2 * kNH;
    for (int i = tid; i < (kIH + 7) / 8 * 8 * kRG; i += kThreads) {
      const int kb = i / (8 * kRG);
      const int rem = i - kb * 8 * kRG;
      const int k = kb * 8 + (rem & 7);
      const int q0 = (rem >> 3) * kR;
      if (k >= kIH) continue;
      float w[kSW], sq[kSW];
      wm::load_window<kOff, kSW>(s_img + k * kIS + q0 + kOff, w);
#pragma unroll
      for (int v = 0; v < kSW; ++v) sq[v] = __fmul_rn(w[v], w[v]);
      float sum[kR], sum_sq[kR];
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        sum[j] = w[j];
        sum_sq[j] = sq[j];
#pragma unroll
        for (int dc = 1; dc < kNP; ++dc) {
          sum[j] = __fadd_rn(sum[j], w[j + dc]);
          sum_sq[j] = __fadd_rn(sum_sq[j], sq[j + dc]);
        }
      }
      float4* at = reinterpret_cast<float4*>(s_rs + k * kSS + q0);
      at[0] = make_float4(sum[0], sum[1], sum[2], sum[3]);
      at[1] = make_float4(sum[4], sum[5], sum[6], sum[7]);
      at = reinterpret_cast<float4*>(s_rq + k * kSS + q0);
      at[0] = make_float4(sum_sq[0], sum_sq[1], sum_sq[2], sum_sq[3]);
      at[1] = make_float4(sum_sq[4], sum_sq[5], sum_sq[6], sum_sq[7]);
    }
    __syncthreads();
  }
  for (int i = tid; i < (kRH + kCR - 1) / kCR * kRW; i += kThreads) {
    const int rb = i / kRW;
    const int q = i - rb * kRW;
    const int r0 = rb * kCR;
    // region row r's window is staged rows [r, r + 2 kNH]
    float mask[kCR];
    float vs[kCR + 2 * kNH], vq[kCR + 2 * kNH];
#pragma unroll
    for (int m = 0; m < kCR + 2 * kNH; ++m) {
      const int k = min(r0 + m, kIH - 1);  // rows past kRH: unused
      if constexpr (kSharedSums) {
        vs[m] = s_rs[k * kSS + q];
        vq[m] = s_rq[k * kSS + q];
      } else {
        const float* row = s_img + k * kIS + q + kOff;
        float sum = row[0];
        float sum_sq = __fmul_rn(sum, sum);
#pragma unroll
        for (int dc = 1; dc < kNP; ++dc) {
          sum = __fadd_rn(sum, row[dc]);
          sum_sq = __fadd_rn(sum_sq, __fmul_rn(row[dc], row[dc]));
        }
        vs[m] = sum;
        vq[m] = sum_sq;
      }
    }
#pragma unroll
    for (int m = 0; m < kCR; ++m) {
      float total = vs[m], total_sq = vq[m];
#pragma unroll
      for (int dr = 1; dr < kNP; ++dr) {
        total = __fadd_rn(total, vs[m + dr]);
        total_sq = __fadd_rn(total_sq, vq[m + dr]);
      }
      mask[m] = wm::nvf_from_sums<kNP>(total, total_sq);
    }
#pragma unroll
    for (int m = 0; m < kCR; ++m)
      if (r0 + m < kRH) out(r0 + m, q, mask[m]);
  }
}

// The tile's output (r, q0 .. q0 + kR - 1) of work item i: lanes 0-7 of a
// warp take eight consecutive rows of one column group, so their 16-byte
// shared loads at a bank_stride row stride fall in distinct banks.
__device__ __forceinline__ void tile_item(int i, int& r, int& q0) {
  const int rb = i / (8 * kTG);
  const int rem = i - rb * 8 * kTG;
  r = rb * 8 + (rem & 7);
  q0 = (rem >> 3) * kR;
}

// Store the kR outputs v of a row that start at row, n of them in the
// frame: two float4 stores where all kR lie in the frame and the rows are
// 16-byte aligned (vec), scalar ones elsewhere.
__device__ __forceinline__ void store_row(const float (&v)[kR],
                                          float* __restrict__ row, int n,
                                          bool vec) {
  if (vec && n == kR) {
    float4* at = reinterpret_cast<float4*>(row);
    at[0] = make_float4(v[0], v[1], v[2], v[3]);
    at[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < kR; ++j)
      if (j < n) row[j] = v[j];
  }
}

}  // namespace stencil
}  // namespace wm
