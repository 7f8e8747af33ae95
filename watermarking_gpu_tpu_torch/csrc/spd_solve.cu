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
// steps the wide one, 80 pivots at k = 80, each waiting for the one
// before.
//
// spd_solve8: one launch a solve in place of hundreds of small ops; one
// thread a system holds the 36 entries of L and the right-hand side in
// registers (the loops unroll fully); 128 threads a block, so a batch of
// hundreds (a service batch, the calibration tool's) runs several blocks.
// The solve itself is wm::solve8 (spd_solve8.cuh), which rounds each
// operation on its own in the plain version's order and so gives its
// bits on the card. me_gram.cu's assembly kernel runs the same function
// as its tail on a single device (ops/cuda/me_kernel.py::me_gram_solve8);
// this kernel solves the Gram that parallel/spatial.py folds from the
// shards' halo-form Grams.
//
// spd_solve_wide<k>: one block a system, 8k threads; Rx lives in shared
// memory in the Gram's own layout (k rows of k + 1 floats, an odd stride,
// so threads on neighbouring rows hit different banks), with rx as one
// more row below it (29 KB at k = 80). The earlier design ran the JAX
// package's left-looking loop step for step: a thread an entry of a panel
// subtracted the earlier panels' products, one thread factored the 8x8
// diagonal block (chol8_factor), a thread a row solved the rows below,
// dividing at every column, then one warp substituted forward and back, one
// lane running each block's 8 scalar steps with a division each. Its time
// grew with the panels, not the work: 3.3-3.6 us a panel at k = 24, 48 and
// 80 on an NVIDIA H100 80GB HBM3 at 700 W. This design factors Rx = L D L^T
// (L unit lower triangular) in panels of 8 columns, right-looking:
//   * warp 0 factors each 8x8 diagonal block, a lane a row, the pivot's
//     reciprocal broadcast by shuffle (factor_diag_warp); no square root,
//     so a pivot's chain is a reciprocal, a shuffle, a product and a
//     difference;
//   * a thread a row solves the rows below against the block's unit
//     triangle (no division), then scales them by the pivots' reciprocals;
//   * the panel's products leave the whole trailing triangle at once,
//     spread over the warps that do not share warp 0's scheduler, while
//     warp 0 already factors the next diagonal block;
//   * rx rides along as row k, so that its row of the factor ends as
//     D^-1 L^-1 rx: the forward substitution is folded into the factor;
//   * the back substitution against the unit L^T runs over a warp, every
//     lane solving a block's 8x8 triangle from the broadcast sides, and a
//     warp vote gives `valid`.
// The 80 pivots' chain still bounds it: about 180 cycles a pivot (clock64
// stamps in the kernel, NVIDIA H100 80GB HBM3, 700 W), of which the
// reciprocal and the shuffle take most. The factor rounds each product and
// difference on its own, the solves and updates use fused multiply-adds:
// another order than the plain version's, so it agrees to rounding. A
// pivot that is not positive gets a NaN reciprocal (Cholesky's root there
// is NaN, or 0 with an Inf reciprocal), so every later value is NaN.
//
// Both kernels: `valid` is "all coefficients finite", an invalid system's
// coefficients are written as zeros, and there are no atomics and a fixed
// order everywhere, so two calls give the same bits.
#include <cuda_runtime.h>

#include "spd_solve8.cuh"

namespace {

constexpr int kN = 8;           // unknowns of the 3x3 predictor; panel width
constexpr int kG = kN + 1;      // the 3x3 Gram's row length
constexpr int kThreads = 128;   // systems a block of spd_solve8

__global__ void __launch_bounds__(kThreads)
    spd_solve8_kernel(const float* __restrict__ gram,
                      float* __restrict__ coefficients,
                      bool* __restrict__ valid, int batch) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  const float* g = gram + static_cast<size_t>(b) * kG * kG;
  wm::solve8([g](int i, int j) { return __ldg(g + i * kG + j); },
             coefficients + static_cast<size_t>(b) * kN, valid + b);
}

constexpr unsigned kFullWarp = 0xffffffffu;

// The 8-term product x . y of two rows of a panel, in increasing order, a
// fused multiply-add a term onto the sum from 0. y is a row of `panel`
// (16-byte loads).
__device__ __forceinline__ float panel_dot(float4 x0, float4 x1,
                                           const float* y_row) {
  const float4* y = reinterpret_cast<const float4*>(y_row);
  const float4 y0 = y[0], y1 = y[1];
  float dot = 0.0f;
  dot = __fmaf_rn(x0.x, y0.x, dot);
  dot = __fmaf_rn(x0.y, y0.y, dot);
  dot = __fmaf_rn(x0.z, y0.z, dot);
  dot = __fmaf_rn(x0.w, y0.w, dot);
  dot = __fmaf_rn(x1.x, y1.x, dot);
  dot = __fmaf_rn(x1.y, y1.y, dot);
  dot = __fmaf_rn(x1.z, y1.z, dot);
  dot = __fmaf_rn(x1.w, y1.w, dot);
  return dot;
}

// The 8 floats at `at` as two float4 (a's odd row stride allows no
// vector load).
__device__ __forceinline__ void load8(const float* at, float4& x0,
                                      float4& x1) {
  x0 = make_float4(at[0], at[1], at[2], at[3]);
  x1 = make_float4(at[4], at[5], at[6], at[7]);
}

// One warp factors the 8x8 diagonal block of a (row stride kS) at (jd, jd)
// as l d l^T, l unit lower triangular: lane r holds row r of the block
// (lanes 8-31 repeat lanes 0-7, so that every shuffle has the whole warp),
// read from `src` (the Gram in device memory for the first block, else the
// block in a), first less the previous panel's products L_r . W_c (L from
// a, W = L D from `panel`) when jd > 0. Column j: lane j takes the
// __frcp_rn of its pivot d_j, the Schur complement's diagonal, NaN where
// d_j is not positive (where Cholesky's root would be NaN or 0), and a
// shuffle broadcasts it (the other lanes take the reciprocal of 1: a lane
// that fed it its upper entry, 0 or garbage, would send the warp down the
// slow path for special values at every column); the lanes below scale
// their entry w_rj = l_rj d_j to l_rj and subtract l_rj w_cj from the rest
// of their row, each product and difference rounded on its own. Lane j + 1
// forms the next pivot from its own entry, so the chain from one pivot to
// the next is a reciprocal, one shuffle, a product and a difference; no
// square root. Writes l below the block's diagonal, d on it, and 1 / d
// into inv[jd:jd + 8].
template <int kS, bool kFirst>
__device__ __forceinline__ void factor_diag_warp(const float* src, float* a,
                                                 const float* panel,
                                                 float* inv, int jd,
                                                 int lane) {
  const int r = lane % kN;
  float* row = a + (jd + r) * kS + jd;
  float v[kN];
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    v[c] = c > r ? 0.0f : kFirst ? __ldg(src + r * kS + c) : row[c];
  }
  if (!kFirst) {
    float4 x0, x1;
    load8(row - kN, x0, x1);
#pragma unroll
    for (int c = 0; c < kN; ++c) {   // c > r: the upper part, never stored
      v[c] = __fsub_rn(v[c], panel_dot(x0, x1, panel + (jd + c) * kN));
    }
  }
  float own_inv = 0.0f;
  float pivot_in = v[0];              // lane j's d_j when column j starts
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float pivot = r == j ? pivot_in : 1.0f;
    const float recip =
        __frcp_rn(pivot > 0.0f ? pivot : __int_as_float(0x7fffffff));
    const float inv_pivot = __shfl_sync(kFullWarp, recip, j);
    const float w = v[j];
    const float l = __fmul_rn(w, inv_pivot);
    own_inv = r == j ? inv_pivot : own_inv;
    v[j] = r == j ? pivot_in : l;
    if (j + 1 < kN) pivot_in = __fsub_rn(v[j + 1], __fmul_rn(l, w));
#pragma unroll
    for (int c = j + 1; c < kN; ++c) {
      const float w_c = __shfl_sync(kFullWarp, w, c);
      v[c] = __fsub_rn(v[c], __fmul_rn(l, w_c));
    }
  }
  if (lane < kN) {
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      if (c <= r) row[c] = v[c];
    }
    inv[jd + r] = own_inv;
  }
}

// One block a system of kK unknowns, 8 kK threads; the rows of Rx and,
// below them, rx as row kK.
template <int kK>
__global__ void __launch_bounds__(kK * kN)
    spd_solve_wide_kernel(const float* __restrict__ gram,
                          float* __restrict__ coefficients,
                          bool* __restrict__ valid) {
  constexpr int kS = kK + 1;          // row stride, the Gram's
  constexpr int kR = kK + 1;          // rows: Rx's kK, then rx
  constexpr int kPanels = kK / kN;
  constexpr int kBlockThreads = kK * kN;
  constexpr int kWarps = kBlockThreads / 32;
  // the warps that load and update: all but those of warp 0's scheduler
  // (warps 0, 4, 8, ...), which then runs the factor's chain alone
  constexpr int kUpdaters = (kWarps - (kWarps + 3) / 4) * 32;
  constexpr int kOwned = (kK + 31) / 32;          // unknowns a lane
  static_assert(kK % kN == 0, "whole panels only");
  // a[i * kS + j], j < kK: Rx, rx as row kK; Rx = L D L^T leaves L (unit
  // lower triangular) below the diagonal and D on it, and row kK ends as
  // D^-1 L^-1 rx
  __shared__ float a[kR * kS];
  // the current panel's columns of W = L D, 8 a row (16-byte loads)
  __shared__ __align__(16) float panel[kR * kN];
  __shared__ float inv[kK];           // 1 / D[j]
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const bool updater = warp % 4 != 0;
  const int u = (warp - warp / 4 - 1) * 32 + lane;   // an updater's index
  const float* g = gram + static_cast<size_t>(blockIdx.x) * kS * kS;
  if (warp == 0) {
    // the first diagonal block, straight from the Gram
    factor_diag_warp<kS, true>(g, a, panel, inv, 0, lane);
  } else if (updater) {
    // the rest of Rx and rx, eight loads in flight before their stores
    constexpr int kLoads = (kK * kS + kUpdaters - 1) / kUpdaters;
    constexpr int kBatch = 8;
    const float rx = u < kK ? __ldg(g + u * kS + kK) : 0.0f;   // column kK
#pragma unroll
    for (int n0 = 0; n0 < kLoads; n0 += kBatch) {
      float loaded[kBatch];
#pragma unroll
      for (int n = 0; n < kBatch; ++n) {
        const int e = u + (n0 + n) * kUpdaters;
        loaded[n] = n0 + n < kLoads && e < kK * kS ? __ldg(g + e) : 0.0f;
      }
#pragma unroll
      for (int n = 0; n < kBatch; ++n) {
        const int e = u + (n0 + n) * kUpdaters;
        if (n0 + n < kLoads && e < kK * kS &&
            (e >= kN * kS || e % kS >= kN)) {
          a[e] = loaded[n];
        }
      }
    }
    if (u < kK) a[kK * kS + u] = rx;
  }
  __syncthreads();

  for (int b = 0; b < kPanels; ++b) {
    const int j0 = b * kN;
    // the panel's rows below its diagonal block, rx's last: W l11^T = S
    // (l11 unit lower triangular), a thread a row, column by column, then
    // L = W D^-1 by the pivots' reciprocals; L into a, W into `panel`
    if (t < kR - j0 - kN) {
      const int i = j0 + kN + t;
      float* row = a + i * kS + j0;
      const float* diag = a + j0 * kS + j0;
      float w[kN];
#pragma unroll
      for (int q = 0; q < kN; ++q) {
        float acc = row[q];
#pragma unroll
        for (int s = 0; s < q; ++s) {
          acc = __fmaf_rn(-w[s], diag[q * kS + s], acc);
        }
        w[q] = acc;
      }
#pragma unroll
      for (int q = 0; q < kN; ++q) row[q] = __fmul_rn(w[q], inv[j0 + q]);
      float4* out = reinterpret_cast<float4*>(panel + i * kN);
      out[0] = make_float4(w[0], w[1], w[2], w[3]);
      out[1] = make_float4(w[4], w[5], w[6], w[7]);
    }
    __syncthreads();
    if (b + 1 == kPanels) break;
    // right-looking: the panel's products L_i . W_j leave the trailing
    // lower triangle, rx's row included. Warp 0 takes the next diagonal block
    // and factors it at once; the updaters take the rest, a thread a
    // row's entries in one 8-column tile, the next panel's tile first.
    const int jd = j0 + kN;
    if (warp == 0) {
      factor_diag_warp<kS, false>(a + jd * kS + jd, a, panel, inv, jd,
                                  lane);
    } else if (updater) {
      int s = u;
      for (int tile = b + 1; tile < kPanels; ++tile) {
        const int first = (tile == b + 1 ? tile + 1 : tile) * kN;
        const int rows = kR - first;
        for (; s < rows; s += kUpdaters) {
          const int i = first + s;
          float4 x0, x1;
          load8(a + i * kS + j0, x0, x1);
          float* entry = a + i * kS + tile * kN;
          const int cols = i - tile * kN + 1;   // j <= i
          float updated[kN];
#pragma unroll
          for (int c = 0; c < kN; ++c) {
            updated[c] = __fsub_rn(
                entry[c], panel_dot(x0, x1, panel + (tile * kN + c) * kN));
          }
#pragma unroll
          for (int c = 0; c < kN; ++c) {
            if (c < cols) entry[c] = updated[c];
          }
        }
        s -= rows;
      }
    }
    __syncthreads();
  }

  // back substitution L^T x = y (L unit lower triangular, y = row kK) on
  // warp 0, block by block from the last: lane l owns unknowns l, l + 32,
  // ... and their running right-hand sides; every lane solves the block's
  // unit 8x8 triangle from the broadcast sides, then subtracts the block's
  // products (L's rows j0 .. j0 + 7, read along the lanes) from its sides:
  // those of unknowns at or past j0 are spent, so every lane may, and none
  // branches
  if (warp != 0) return;
  const float* y = a + kK * kS;
  float acc[kOwned], x[kOwned];
#pragma unroll
  for (int m = 0; m < kOwned; ++m) {
    const int r = lane + 32 * m;
    acc[m] = r < kK ? y[r] : 0.0f;
    x[m] = 0.0f;
  }
#pragma unroll
  for (int b = kPanels - 1; b >= 0; --b) {
    const int j0 = b * kN;
    const float* diag = a + j0 * kS + j0;
    float xb[kN];
#pragma unroll
    for (int q = kN - 1; q >= 0; --q) {
      float s = __shfl_sync(kFullWarp, acc[(j0 + q) / 32], (j0 + q) % 32);
#pragma unroll
      for (int p = kN - 1; p > q; --p) {
        s = __fmaf_rn(-diag[p * kS + q], xb[p], s);
      }
      xb[q] = s;
    }
#pragma unroll
    for (int m = 0; m < kOwned; ++m) {
#pragma unroll
      for (int q = 0; q < kN; ++q) {
        if ((j0 + q) / 32 == m && lane == (j0 + q) % 32) x[m] = xb[q];
      }
      if (32 * m < j0) {
#pragma unroll
        for (int q = 0; q < kN; ++q) {
          acc[m] = __fmaf_rn(-a[(j0 + q) * kS + lane + 32 * m], xb[q],
                             acc[m]);
        }
      }
    }
  }
  bool finite = true;
#pragma unroll
  for (int m = 0; m < kOwned; ++m) {
    if (lane + 32 * m < kK) finite = finite && isfinite(x[m]);
  }
  const bool all = __all_sync(kFullWarp, finite);
  float* out = coefficients + static_cast<size_t>(blockIdx.x) * kK;
#pragma unroll
  for (int m = 0; m < kOwned; ++m) {
    const int r = lane + 32 * m;
    if (r < kK) out[r] = all ? x[m] : 0.0f;
  }
  if (lane == 0) valid[blockIdx.x] = all;
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
