// The ME predictor's coefficient solves, Rx a = rx, read in place from the
// Gram that the Gram kernels write (Rx = G[:k, :k], rx = G[:k, k]):
// spd_solve8_kernel for the 3x3 predictor's 8x8 systems, from the
// (batch, 9, 9) Gram of me_gram.cu, and spd_solve_wide_kernel<k> for the
// 24-, 48- and 80-unknown systems of p = 5, 7, 9, from the (batch, k+1,
// k+1) Gram of me_gram_wide.cu.
//
// Replaces:
//   spd_solve8_kernel <- the JAX package's ops/me.py::solve_coefficients_spd
//       (XLA code, not a Pallas kernel: inside the jitted step it fuses into
//       a few elementwise ops). Its plain PyTorch twin,
//       watermarking_gpu_tpu_torch/ops/me.py::solve_coefficients_spd, runs
//       the same recurrence as ~470 (batch,)-vector ops, one launch each.
//   spd_solve_wide_kernel <- the JAX package's
//       ops/me.py::solve_coefficients_spd_blocked (XLA code as well: 8x8
//       diagonal factors, 8-column panel triangular solves and matmul
//       updates, then blockwise substitutions). Its plain twin,
//       ops/me.py::solve_coefficients_spd_blocked, runs it as thousands of
//       small ops; the port's plain route solves by the library pair
//       cholesky_ex + cholesky_solve, a different algorithm.
//
// What bounds them on an H100: an 8x8 system is 392 operations (248 of the
// factorisation with its 8 square roots and 8 reciprocals, 72 of each
// substitution with its 8 divisions) on 81 x 4 bytes of Gram in and
// 8 x 4 + 1 bytes out: at 8 frames about 2.9 KB and 3.1 k operations, a
// few nanoseconds at the card's rates. An 80-unknown system is about
// 80^3 / 3 + 2 * 80^2 ~ 184 k operations on 26 KB: at 8 frames well under
// a microsecond of bytes or operations. Neither has the work to fill the
// card: launch latency bounds the 8x8 solve, and the chain of dependent
// steps the wide one (at k = 80, 10 panels of a factor, a triangular solve
// and an update, each behind a barrier, then 2 x 10 blocks of
// substitution).
//
// What the design does about it: one launch a solve in place of hundreds
// of small ops. spd_solve8: one thread a system holds the 36 entries of L
// and the right-hand side in registers (the loops unroll fully); 128
// threads a block, so a batch of hundreds (a service batch, the
// calibration tool's) runs several blocks. spd_solve_wide<k>: one block a
// system, 8k threads; Rx and rx live in shared memory in the Gram's own
// layout (k rows of k + 1 floats, an odd stride, so threads on
// neighbouring rows hit different banks: 26 KB at k = 80), and L is
// written over Rx's lower triangle panel by panel, left-looking as the
// JAX package's loop: a thread an entry of the panel at and below its
// diagonal subtracts the earlier panels' products, one panel at a time,
// each an 8-term sum in increasing order; one thread factors the 8x8
// diagonal block by the recurrence that spd_solve8 runs (chol8_factor);
// a thread a row below it solves the row against L11^T. Then one warp
// substitutes block by block: 8 lanes subtract the solved prefix's
// products, a block at a time, one lane runs the block's 8 scalar steps.
// No atomics and a fixed order everywhere, so two calls give the same
// bits. The recurrences round each operation on its own (__f*_rn, never
// contracted into FMAs) in the plain version's order: each sum starts at
// 0 and adds the products in increasing k, the pivot's reciprocal is
// taken once and multiplied (torch's 1.0 / t is a reciprocal, then a
// product by 1.0), the triangular solves and substitutions divide by the
// pivot. spd_solve8 thus gives the plain version's bits on the card; the
// wide kernel's 8-term sums stand for the plain version's matmuls, whose
// order is the library's, so it agrees to rounding. A zero or negative
// pivot gives Inf or NaN through IEEE arithmetic; `valid` is "all
// coefficients finite", and an invalid system's coefficients are written
// as zeros.
#include <cuda_runtime.h>

namespace {

constexpr int kN = 8;           // unknowns of the 3x3 predictor; panel width
constexpr int kG = kN + 1;      // the 3x3 Gram's row length
constexpr int kThreads = 128;   // systems a block of spd_solve8

// The lower Cholesky factor of an 8x8 SPD block whose entry (i, j), i >= j,
// is entry(i, j), into lower[i][j] (j <= i).
template <class Entry>
__device__ __forceinline__ void chol8_factor(const Entry& entry,
                                             float (&lower)[kN][kN]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < j; ++k) {
      sum = __fadd_rn(sum, __fmul_rn(lower[j][k], lower[j][k]));
    }
    lower[j][j] = __fsqrt_rn(__fsub_rn(entry(j, j), sum));
    const float inv_diag = __fdiv_rn(1.0f, lower[j][j]);
#pragma unroll
    for (int i = j + 1; i < kN; ++i) {
      float off = 0.0f;
#pragma unroll
      for (int k = 0; k < j; ++k) {
        off = __fadd_rn(off, __fmul_rn(lower[i][k], lower[j][k]));
      }
      lower[i][j] = __fmul_rn(__fsub_rn(entry(i, j), off), inv_diag);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    spd_solve8_kernel(const float* __restrict__ gram,
                      float* __restrict__ coefficients,
                      bool* __restrict__ valid, int batch) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  const float* g = gram + static_cast<size_t>(b) * kG * kG;

  // lower[i][j], j <= i: the Cholesky factor, Rx = L L^T
  float lower[kN][kN];
  chol8_factor([g](int i, int j) { return __ldg(g + i * kG + j); }, lower);

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

// One block a system of kK unknowns, 8 kK threads (a thread an entry of
// the first panel).
template <int kK>
__global__ void __launch_bounds__(kK * kN)
    spd_solve_wide_kernel(const float* __restrict__ gram,
                          float* __restrict__ coefficients,
                          bool* __restrict__ valid) {
  constexpr int kS = kK + 1;          // row stride, the Gram's
  constexpr int kPanels = kK / kN;
  constexpr int kBlockThreads = kK * kN;
  static_assert(kK % kN == 0, "whole panels only");
  // a[i * kS + j]: Rx (j < kK) with rx in column kK; L over Rx's lower
  // triangle, panel by panel
  __shared__ float a[kK * kS];
  __shared__ float y[kK];             // L y = rx
  __shared__ float x[kK];             // L^T x = y
  __shared__ float rhs[kN];           // a block's right-hand side
  __shared__ bool finite;
  const int t = threadIdx.x;
  const float* g = gram + static_cast<size_t>(blockIdx.x) * kS * kS;
  for (int e = t; e < kK * kS; e += kBlockThreads) a[e] = __ldg(g + e);
  __syncthreads();

  for (int b = 0; b < kPanels; ++b) {
    const int j0 = b * kN;
    // the panel's entries (i, j0 + c), i >= j0, less the earlier panels'
    // products L[i, pb] . L[j0 + c, pb], one panel at a time
    const int i = j0 + t / kN;
    const int c = t % kN;
    if (i < kK && b > 0) {
      float s = a[i * kS + j0 + c];
      for (int pb = 0; pb < b; ++pb) {
        const float* li = a + i * kS + pb * kN;
        const float* lj = a + (j0 + c) * kS + pb * kN;
        float dot = 0.0f;
#pragma unroll
        for (int q = 0; q < kN; ++q) dot += li[q] * lj[q];
        s = __fsub_rn(s, dot);
      }
      a[i * kS + j0 + c] = s;
    }
    __syncthreads();
    // the diagonal block: L11
    float* diag = a + j0 * kS + j0;
    if (t == 0) {
      float lower[kN][kN];
      chol8_factor([diag](int r, int q) { return diag[r * kS + q]; }, lower);
#pragma unroll
      for (int r = 0; r < kN; ++r) {
#pragma unroll
        for (int q = 0; q <= r; ++q) diag[r * kS + q] = lower[r][q];
      }
    }
    __syncthreads();
    // the rows below: X L11^T = S, a thread a row, column by column
    if (t < kK - j0 - kN) {
      float* row = a + (j0 + kN + t) * kS + j0;
#pragma unroll
      for (int q = 0; q < kN; ++q) {
        float acc = row[q];
#pragma unroll
        for (int k = 0; k < q; ++k) {
          acc = __fsub_rn(acc, __fmul_rn(row[k], diag[q * kS + k]));
        }
        row[q] = __fdiv_rn(acc, diag[q * kS + q]);
      }
    }
    __syncthreads();
  }

  if (t >= 32) return;   // one warp substitutes
  const int lane = t;
  // forward, block by block: rhs = rx[j0:] less the solved prefix's
  // products a block at a time, then the block's 8 scalar steps
  for (int b = 0; b < kPanels; ++b) {
    const int j0 = b * kN;
    if (lane < kN) {
      float r = a[(j0 + lane) * kS + kK];
      for (int pb = 0; pb < b; ++pb) {
        const float* l = a + (j0 + lane) * kS + pb * kN;
        float dot = 0.0f;
#pragma unroll
        for (int q = 0; q < kN; ++q) dot += l[q] * y[pb * kN + q];
        r = __fsub_rn(r, dot);
      }
      rhs[lane] = r;
    }
    __syncwarp();
    if (lane == 0) {
      const float* diag = a + j0 * kS + j0;
      float yb[kN];
#pragma unroll
      for (int r = 0; r < kN; ++r) {
        float acc = rhs[r];
#pragma unroll
        for (int k = 0; k < r; ++k) {
          acc = __fsub_rn(acc, __fmul_rn(diag[r * kS + k], yb[k]));
        }
        yb[r] = __fdiv_rn(acc, diag[r * kS + r]);
        y[j0 + r] = yb[r];
      }
    }
    __syncwarp();
  }
  // back, block by block from the last: L^T's block row j0 is L's column
  // panel j0 read down its rows
  for (int b = kPanels - 1; b >= 0; --b) {
    const int j0 = b * kN;
    if (lane < kN) {
      float r = y[j0 + lane];
      for (int pb = b + 1; pb < kPanels; ++pb) {
        float dot = 0.0f;
#pragma unroll
        for (int q = 0; q < kN; ++q) {
          dot += a[(pb * kN + q) * kS + j0 + lane] * x[pb * kN + q];
        }
        r = __fsub_rn(r, dot);
      }
      rhs[lane] = r;
    }
    __syncwarp();
    if (lane == 0) {
      const float* diag = a + j0 * kS + j0;
      float xb[kN];
#pragma unroll
      for (int r = kN - 1; r >= 0; --r) {
        float acc = rhs[r];
#pragma unroll
        for (int k = r + 1; k < kN; ++k) {
          acc = __fsub_rn(acc, __fmul_rn(diag[k * kS + r], xb[k]));
        }
        xb[r] = __fdiv_rn(acc, diag[r * kS + r]);
        x[j0 + r] = xb[r];
      }
    }
    __syncwarp();
  }
  if (lane == 0) {
    bool all = true;
    for (int r = 0; r < kK; ++r) all = all && isfinite(x[r]);
    finite = all;
    valid[blockIdx.x] = all;
  }
  __syncwarp();
  float* out = coefficients + static_cast<size_t>(blockIdx.x) * kK;
  for (int r = lane; r < kK; r += 32) out[r] = finite ? x[r] : 0.0f;
}

template <int kK>
int launch_wide(const float* gram, float* coefficients, bool* valid,
                int batch, cudaStream_t stream) {
  spd_solve_wide_kernel<kK><<<batch, kK * kN, 0, stream>>>(
      gram, coefficients, valid);
  return static_cast<int>(cudaGetLastError());
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

// gram (batch, k+1, k+1) f32, k = unknowns in {24, 48, 80} -> coefficients
// (batch, k) f32, valid (batch,) bool.
extern "C" int wm_spd_solve_wide(const float* gram, float* coefficients,
                                 bool* valid, int batch, int unknowns,
                                 void* stream) {
  if (batch < 1) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (unknowns) {
    case 24: return launch_wide<24>(gram, coefficients, valid, batch, s);
    case 48: return launch_wide<48>(gram, coefficients, valid, batch, s);
    case 80: return launch_wide<80>(gram, coefficients, valid, batch, s);
    default: return cudaErrorInvalidValue;
  }
}
