// The 3x3 predictor's 8x8 solve, Rx a = rx, as one device function that
// both of its callers share: spd_solve.cu's spd_solve8_kernel (one thread
// a system, from a (batch, 9, 9) Gram in device memory) and me_gram.cu's
// assembly kernel, whose last block of a frame solves that frame's Gram
// from shared memory right after the Gram is complete.
//
// The plain version is watermarking_gpu_tpu_torch/ops/me.py::
// solve_coefficients_spd, the unrolled Cholesky that the JAX package's
// ops/me.py::solve_coefficients_spd runs as XLA code. Every operation
// rounds on its own (__f*_rn: nvcc would contract a * b + c into an FMA)
// in the plain version's order: each sum starts at 0 and adds its products
// in increasing k, the pivot's reciprocal is taken once and multiplied
// (torch's 1.0 / t is a reciprocal, then a product by 1.0), the
// substitutions divide by the pivot. It thus gives the plain version's
// bits on the card, wherever the entries come from.
//
// What bounds it: one thread's chain of dependent rounded operations, 8
// square roots, 8 reciprocals, 16 divisions and the products and sums
// between them (392 operations), not bytes: 44 floats in, 8 and a flag
// out.
#pragma once

#include <cuda_runtime.h>

namespace wm {

constexpr int kSolve8 = 8;   // unknowns of the 3x3 predictor

// The lower Cholesky factor of an 8x8 SPD block whose entry (i, j), i >= j,
// is entry(i, j), into lower[i][j] (j <= i).
template <class Entry>
__device__ __forceinline__ void chol8_factor(const Entry& entry,
                                             float (&lower)[kSolve8][kSolve8]) {
#pragma unroll
  for (int j = 0; j < kSolve8; ++j) {
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < j; ++k) {
      sum = __fadd_rn(sum, __fmul_rn(lower[j][k], lower[j][k]));
    }
    lower[j][j] = __fsqrt_rn(__fsub_rn(entry(j, j), sum));
    const float inv_diag = __fdiv_rn(1.0f, lower[j][j]);
#pragma unroll
    for (int i = j + 1; i < kSolve8; ++i) {
      float off = 0.0f;
#pragma unroll
      for (int k = 0; k < j; ++k) {
        off = __fadd_rn(off, __fmul_rn(lower[i][k], lower[j][k]));
      }
      lower[i][j] = __fmul_rn(__fsub_rn(entry(i, j), off), inv_diag);
    }
  }
}

// Solve Rx a = rx, entry(i, j) for j <= i < 8 giving Rx's lower triangle
// and entry(i, 8) rx (a row of the 3x3 Gram): coefficients[0..7] = a and
// *valid = true where every coefficient is finite; otherwise (a zero or
// negative pivot, a NaN entry) zeros and false.
template <class Entry>
__device__ __forceinline__ void solve8(const Entry& entry,
                                       float* __restrict__ coefficients,
                                       bool* __restrict__ valid) {
  // lower[i][j], j <= i: the Cholesky factor, Rx = L L^T
  float lower[kSolve8][kSolve8];
  chol8_factor(entry, lower);

  // forward substitution L y = rx
  float y[kSolve8];
#pragma unroll
  for (int i = 0; i < kSolve8; ++i) {
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < i; ++k) {
      sum = __fadd_rn(sum, __fmul_rn(lower[i][k], y[k]));
    }
    y[i] = __fdiv_rn(__fsub_rn(entry(i, kSolve8), sum), lower[i][i]);
  }

  // back substitution L^T x = y
  float x[kSolve8];
#pragma unroll
  for (int i = kSolve8 - 1; i >= 0; --i) {
    float sum = 0.0f;
#pragma unroll
    for (int k = i + 1; k < kSolve8; ++k) {
      sum = __fadd_rn(sum, __fmul_rn(lower[k][i], x[k]));
    }
    x[i] = __fdiv_rn(__fsub_rn(y[i], sum), lower[i][i]);
  }

  bool finite = true;
#pragma unroll
  for (int i = 0; i < kSolve8; ++i) finite = finite && isfinite(x[i]);
#pragma unroll
  for (int i = 0; i < kSolve8; ++i) coefficients[i] = finite ? x[i] : 0.0f;
  *valid = finite;
}

}  // namespace wm
