// The 3x3 predictor's coefficient solve: Rx a = rx for a batch of 8x8 SPD
// systems, read in place from the (batch, 9, 9) Gram that me_gram.cu writes
// (Rx = G[:8, :8], rx = G[:8, 8]), by an unrolled Cholesky factorisation
// and two substitutions.
//
// Replaces:
//   spd_solve8_kernel <- the JAX package's ops/me.py::solve_coefficients_spd
//       (XLA code, not a Pallas kernel: inside the jitted step it fuses into
//       a few elementwise ops). Its plain PyTorch twin,
//       watermarking_gpu_tpu_torch/ops/me.py::solve_coefficients_spd, runs
//       the same recurrence as ~470 (batch,)-vector ops, one launch each.
//
// What bounds it on an H100: a system is 392 operations (248 of the
// factorisation with its 8 square roots and 8 reciprocals, 72 of each
// substitution with its 8 divisions) on 81 x 4 bytes of Gram in and
// 8 x 4 + 1 bytes out: at 8 frames about 2.9 KB and 3.1 k operations, a
// few nanoseconds at the card's rates. Launch latency bounds it.
//
// What the design does about it: one launch a solve in place of ~470. One
// thread a system holds the 36 entries of L and the right-hand side in
// registers (the loops unroll fully for n = 8); 128 threads a block, so a
// batch of hundreds (a service batch, the calibration tool's) runs several
// blocks. The arithmetic keeps the plain version's order: each sum starts
// at 0 and adds the products in increasing k, the pivot's reciprocal is
// taken once and multiplied (torch's 1.0 / t is a reciprocal, then a
// product by 1.0), the substitutions divide by the pivot. The __f*_rn
// intrinsics round each operation on its own and are never contracted into
// FMAs, as eager torch rounds each elementwise op, so the coefficients are
// the plain version's bits on the card. A zero or negative pivot gives Inf
// or NaN through IEEE arithmetic; `valid` is "all 8 coefficients finite",
// and an invalid system's coefficients are written as zeros.
#include <cuda_runtime.h>

namespace {

constexpr int kN = 8;           // unknowns
constexpr int kG = kN + 1;      // the Gram's row length
constexpr int kThreads = 128;   // systems a block

__global__ void __launch_bounds__(kThreads)
    spd_solve8_kernel(const float* __restrict__ gram,
                      float* __restrict__ coefficients,
                      bool* __restrict__ valid, int batch) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  const float* g = gram + static_cast<size_t>(b) * kG * kG;

  // lower[i][j], j <= i: the Cholesky factor, Rx = L L^T
  float lower[kN][kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < j; ++k) {
      sum = __fadd_rn(sum, __fmul_rn(lower[j][k], lower[j][k]));
    }
    lower[j][j] = __fsqrt_rn(__fsub_rn(__ldg(g + j * kG + j), sum));
    const float inv_diag = __fdiv_rn(1.0f, lower[j][j]);
#pragma unroll
    for (int i = j + 1; i < kN; ++i) {
      float off = 0.0f;
#pragma unroll
      for (int k = 0; k < j; ++k) {
        off = __fadd_rn(off, __fmul_rn(lower[i][k], lower[j][k]));
      }
      lower[i][j] = __fmul_rn(__fsub_rn(__ldg(g + i * kG + j), off),
                              inv_diag);
    }
  }

  // forward substitution L y = rx
  float y[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < i; ++k) {
      sum = __fadd_rn(sum, __fmul_rn(lower[i][k], y[k]));
    }
    y[i] = __fdiv_rn(__fsub_rn(__ldg(g + i * kG + kN), sum), lower[i][i]);
  }

  // back substitution L^T x = y
  float x[kN];
#pragma unroll
  for (int i = kN - 1; i >= 0; --i) {
    float sum = 0.0f;
#pragma unroll
    for (int k = i + 1; k < kN; ++k) {
      sum = __fadd_rn(sum, __fmul_rn(lower[k][i], x[k]));
    }
    x[i] = __fdiv_rn(__fsub_rn(y[i], sum), lower[i][i]);
  }

  bool finite = true;
#pragma unroll
  for (int i = 0; i < kN; ++i) finite = finite && isfinite(x[i]);
  float* out = coefficients + static_cast<size_t>(b) * kN;
#pragma unroll
  for (int i = 0; i < kN; ++i) out[i] = finite ? x[i] : 0.0f;
  valid[b] = finite;
}

}  // namespace

// gram (batch, 9, 9) f32 -> coefficients (batch, 8) f32, valid (batch,)
// bool (one byte each, as torch.bool).
extern "C" int wm_spd_solve8(const float* gram, float* coefficients,
                             bool* valid, int batch, void* stream) {
  if (batch < 1) return cudaErrorInvalidValue;
  const int blocks = (batch + kThreads - 1) / kThreads;
  spd_solve8_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      gram, coefficients, valid, batch);
  return static_cast<int>(cudaGetLastError());
}
