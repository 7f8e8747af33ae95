// The fused embed and the fused detect of whole frames, each enqueued by one
// host call: the C entries of the other sources, in the order the Python
// wrappers of ops/cuda/ would call them one by one, on one stream.
//
// Replaces, on the single-device route of ops/pipelines.py (its Python
// wrapper is ops/cuda/chain.py):
//   wm_embed_chain  <- me_gram_solve8 (or me_gram_wide and spd_solve_wide),
//       embed_field, torch's sum / amax of its partials, embed_finish: five
//       or six wrapper calls, each with its checks, allocations and launch;
//   wm_detect_chain <- me_gram_solve8 (or the wide pair), detect_partials,
//       torch's sum of its partials and dot / sqrt(norm_u * norm_z) with its
//       where.
//
// What bounds a 1080p step on an H100: the host. The card is busy ~0.32 ms
// a step (embed then detect of 8 frames), while the per-wrapper route took
// 0.33-0.60 ms to enqueue it: each wrapper's checks, allocations, device
// context and ctypes call, and torch's small ops between the kernels.
//
// What the design does about it: the caller checks each input once and
// makes one allocation of scratch (lag sums, Gram, coefficients, valid, the
// frames' done counters, u_raw, the field's partials and totals), one
// each for the outputs, and makes this one call; the frames' sums are
// finished inside the kernels (wm::frame_total, fused.cu), so no torch op
// runs between them. The kernels are the per-kernel entries' own, launched
// through those entries; only the frames' sums change order (the blocks'
// partials in index order, in place of torch's).
//
// The analysis of the predictor (ME; NVF's detect takes the 3x3 one):
//   3x3: wm_me_gram_lags zeroes done[b], wm_me_gram_assemble counts in it,
//        solves and sets it back to 0;
//   wide (p = 5, 7, 9, frames of rows, cols >= 6h): done zeroed by a memset,
//        wm_wide_lag_strips, wm_wide_assemble (from the frames' banks, which
//        the caller gathers before the call), wm_spd_solve_wide.
// NVF's embed has none: done zeroed and valid set to true by memsets.
// Then the embed field (its frames' totals into the scratch) and the embed
// finish, or the detect tail (each frame's correlation).
#include <cuda_runtime.h>

extern "C" {
int wm_me_gram_lags(const float* img, const int* lag_index, float* sums,
                    int batch, int rows, int cols, int strip, int block_cols,
                    int top, int bottom, int* done, void* stream);
int wm_me_gram_assemble(const float* img, const float* sums, const int* lags,
                        const int* pair_start, const int* pairs, float* gram,
                        int batch, int rows, int cols, int n_parts, int top,
                        int bottom, float* coefficients, bool* valid,
                        int* done, void* stream);
int wm_wide_lag_strips(const float* img, const int* lag_index, float* sums,
                       float* edges, int batch, int rows, int cols, int half,
                       int strip, int lane_block, int n_lags, int top,
                       int bottom, int total_rows, void* stream);
int wm_wide_assemble(const float* low, const float* high, int bank_stride,
                     const float* sums, const float* edges, const int* lags,
                     const int* pair_start, const int* pairs, float* gram,
                     int batch, int cols, int half, int n_lags, int n_strips,
                     int n_blocks, int total_rows, void* stream);
int wm_spd_solve_wide(const float* gram, float* coefficients, bool* valid,
                      int batch, int unknowns, void* stream);
int wm_embed_field_totals(const float* img, const float* wmark,
                          const float* coeffs, float* u_raw, float* partials,
                          float* totals, int* done, int batch, int rows,
                          int cols, int mask_type, int p, void* stream);
int wm_detect_corr(const float* img, const float* wmark, const float* coeffs,
                   const bool* valid, float* partials, float* corr,
                   int* done, int batch, int rows, int cols, int mask_type,
                   int p, void* stream);
int wm_embed_finish(const float* u_raw, const void* output,
                    const float* sum_u2, const float* max_e,
                    const bool* valid, void* marked, float* strength,
                    int batch, int pixels, int channels, float numerator,
                    int me, int u8, void* stream);
}

namespace {

// The card's launches go to the device of the tensors; the caller's
// current device comes back afterwards.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    if (cudaGetDevice(&previous_) == cudaSuccess && previous_ != device)
      cudaSetDevice(device);
    else
      previous_ = -1;
  }
  ~DeviceScope() {
    if (previous_ >= 0) cudaSetDevice(previous_);
  }

 private:
  int previous_ = -1;
};

// The predictor's tables and the lag kernel's layout (ops/cuda/chain.py
// reads them from ops/me.py): block is the 3x3 lag kernel's column block or
// the wide one's lane block.
struct Analysis {
  int p;   // the predictor's window: 3, or 5, 7, 9 (the wide form)
  const int* lag_index;
  const int* lags;
  const int* pair_start;
  const int* pairs;
  const float* banks;   // wide: (batch, 8h, cols), low then high rows
  int strip, block, n_strips, n_blocks, n_lags;
  float* sums;
  float* edges;   // wide only
  float* gram;
  float* coefficients;
  bool* valid;
  int* done;
};

// coefficients, valid and done (0) for whole frames.
int analyse(const Analysis& a, const float* img, int batch, int rows,
            int cols, cudaStream_t s) {
  int code;
  if (a.p == 3) {
    code = wm_me_gram_lags(img, a.lag_index, a.sums, batch, rows, cols,
                           a.strip, a.block, 0, 0, a.done, s);
    if (code != 0) return code;
    return wm_me_gram_assemble(img, a.sums, a.lags, a.pair_start, a.pairs,
                               a.gram, batch, rows, cols,
                               a.n_strips * a.n_blocks, 0, 0, a.coefficients,
                               a.valid, a.done, s);
  }
  const int h = a.p / 2;
  code = cudaMemsetAsync(a.done, 0, sizeof(int) * batch, s);
  if (code != 0) return code;
  code = wm_wide_lag_strips(img, a.lag_index, a.sums, a.edges, batch, rows,
                            cols, h, a.strip, a.block, a.n_lags, 0, 0, rows,
                            s);
  if (code != 0) return code;
  code = wm_wide_assemble(a.banks, a.banks + 4 * h * cols, 8 * h * cols,
                          a.sums, a.edges, a.lags, a.pair_start, a.pairs,
                          a.gram, batch, cols, h, a.n_lags, a.n_strips,
                          a.n_blocks, rows, s);
  if (code != 0) return code;
  return wm_spd_solve_wide(a.gram, a.coefficients, a.valid, batch,
                           a.p * a.p - 1, s);
}

constexpr int kMaskME = 0;   // common.cuh's wm::kMaskME

}  // namespace

// img (batch, rows, cols) f32 frames, wmark (rows, cols) f32, output and
// marked (batch, rows, cols, channels) f32 (u8 = 0) or u8 (u8 = 1) -> marked,
// strength (batch,) f32, as embed_field then embed_finish with numerator =
// sf * sqrt(rows * cols). pred_p: ME's p (0 for NVF, which has no
// analysis); the analysis' tables, layout and scratch as Analysis holds
// them; u_raw (batch, rows, cols), partials (batch, field blocks, 2) and
// totals (2, batch) f32 scratch. device: the CUDA device of every pointer.
extern "C" int wm_embed_chain(
    int device, const float* img, const float* wmark, const void* output,
    void* marked, float* strength, int batch, int rows, int cols,
    int channels, int u8, int mask_type, int p, float numerator, int pred_p,
    const int* lag_index, const int* lags, const int* pair_start,
    const int* pairs, const float* banks, int strip, int block, int n_strips,
    int n_blocks, int n_lags, float* sums, float* edges, float* gram,
    float* coefficients, bool* valid, int* done, float* u_raw,
    float* partials, float* totals, void* stream) {
  if (batch < 1) return cudaErrorInvalidValue;
  const DeviceScope scope(device);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool me = mask_type == kMaskME;
  int code;
  if (me) {
    code = analyse({pred_p, lag_index, lags, pair_start, pairs, banks, strip,
                    block, n_strips, n_blocks, n_lags, sums, edges, gram,
                    coefficients, valid, done},
                   img, batch, rows, cols, s);
  } else {
    code = cudaMemsetAsync(done, 0, sizeof(int) * batch, s);
    if (code == 0) code = cudaMemsetAsync(valid, 1, sizeof(bool) * batch, s);
  }
  if (code != 0) return code;
  code = wm_embed_field_totals(img, wmark, me ? coefficients : nullptr, u_raw,
                               partials, totals, done, batch, rows, cols,
                               mask_type, p, s);
  if (code != 0) return code;
  return wm_embed_finish(u_raw, output, totals, totals + batch, valid, marked,
                         strength, batch, rows * cols, channels, numerator,
                         me ? 1 : 0, u8, s);
}

// img (batch, rows, cols) f32 frames, wmark (rows, cols) f32 -> corr
// (batch,) f32, each frame's correlation, 0 where its solve failed. pred_p:
// the predictor's p (ME's p; 3 for NVF); the rest as in wm_embed_chain,
// partials (batch, tail blocks, 3).
extern "C" int wm_detect_chain(
    int device, const float* img, const float* wmark, float* corr, int batch,
    int rows, int cols, int mask_type, int p, int pred_p,
    const int* lag_index, const int* lags, const int* pair_start,
    const int* pairs, const float* banks, int strip, int block, int n_strips,
    int n_blocks, int n_lags, float* sums, float* edges, float* gram,
    float* coefficients, bool* valid, int* done, float* partials,
    void* stream) {
  if (batch < 1) return cudaErrorInvalidValue;
  const DeviceScope scope(device);
  const auto s = static_cast<cudaStream_t>(stream);
  const int code = analyse({pred_p, lag_index, lags, pair_start, pairs, banks,
                            strip, block, n_strips, n_blocks, n_lags, sums,
                            edges, gram, coefficients, valid, done},
                           img, batch, rows, cols, s);
  if (code != 0) return code;
  return wm_detect_corr(img, wmark, coefficients, valid, partials, corr, done,
                        batch, rows, cols, mask_type, p, s);
}
