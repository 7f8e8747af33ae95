// Fused embed field and detect tail: everything after the predictor solve,
// one pass over the frame each, for p in {3, 5, 7, 9}. The multi-candidate
// detect, which shares the detect tail's arithmetic, is detect_many.cu.
//
// Replaces:
//   embed_field_kernel  <- the JAX package's ops/pallas/fused.py::
//       _embed_field_kernel and its raw twin _embed_field_kernel_raw (body
//       _embed_field_core);
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
// u_raw: 12 bytes a pixel, about 141 MB at 1080p x 8 (42 us at 3.35 TB/s);
// ME p=9 does some 165 flops a pixel (41 us of f32, but 160 of them are
// rounded products and differences that issue one at a time: ~80 us),
// the NVF mask's separable box sums about 4p + 3. The detect tail reads 8
// bytes a pixel (75 MB, 22 us) but at ME p=9 does two 80-tap predictions a
// pixel, some 330 flops (81 us of f32), so it is bound by operations there.
//
// What the design does about it: each input is read once, coalesced, and
// nothing intermediate goes to device memory: no padded copies (loads clamp
// their indices), no e or mask planes. The ME mask's 1/max|e| is not applied
// (it cancels in the pixels and in the correlation; the wrapper only reports
// max|e| for the strength). Per-block sums and maxes go to a small partials
// buffer that the wrapper finishes, or, on whole frames in a chain (chain.cu),
// that the frame's last block finishes (wm::frame_total): the embed field's sum
// u_raw^2 and max mask, the detect tail's correlation dot / sqrt(||e_u||^2
// ||e_z||^2), 0 where the frame's solve failed, with __f*_rn in the order of
// the eager division it replaces. Both kernels take a 64 x 64 tile a block of
// 256 threads (the other kernels' tiles are 32 x 64; the ring recomputed by
// neighbouring tiles is then 27% of the tile at p=9, not 41%), copy the frame
// with its clamped halo into dynamic shared memory by cp.async (16-byte chunks
// where a chunk lies inside the frame and is aligned, 4-byte clamped copies
// elsewhere: a synchronous load a pixel held the first designs back), and
// compute kR = 8 consecutive outputs of a row a thread: per tap row the row's
// 8 + 2 PH pixels go into registers once with the widest aligned shared loads,
// with the tap row's coefficients (registers at PH <= 2, float4 rows of s_cg
// above), instead of two shared loads a tap. The NVF mask adds p row sums down
// a column for each of a thread's rows instead of p^2 pixels a point; the row
// sums are the thread's own, or at p=9 taken once per staged row into shared
// memory. That machinery is stencil.cuh's, shared with predict.cu and nvf.cu.
//
// Embed field: u_raw = mask * W and the per-image sum u_raw^2 and max mask.
// Halo PH (ME) or NH (NVF). W is read only at the outputs, so it is not
// staged: each thread loads the W of its two rows of 8 outputs into
// registers while the frame is copied, with two float4 loads a row where
// the row is 16-byte aligned and all 8 lie in the frame (scalar loads
// elsewhere), and writes u_raw the same way. NVF threads take 16 rows of a
// column each, and the mask goes through a 64 x 64 shared plane to the
// row-wise threads that write u_raw. Four or five blocks an SM.
//
// Detect tail: e_u(y,x) = u(y,x) - sum_k c_k u(clamp(y+dr), clamp(x+dc))
// with u(q) = mask(q) * W(q), mask(q) = |e_z(q)| (ME) or nvf(q) (NVF). The
// ring of u outside the frame is clamp-to-edge of u itself, not u computed
// from edge-replicated frame rows (reference Watermark.cpp:221-225). Each
// block:
// 1. copies the tile of the frame with a clamped halo of S pixels (S = 2 PH
//    for ME, PH + NH for NVF), and at PH <= 3 W over the u region, into
//    dynamic shared memory by cp.async;
// 2. computes u over the tile and its PH ring, register-tiled as above (e_z
//    of the tile is kept at PH >= 2);
// 3. sets the ring outside the frame to u at the clamped coordinates (only
//    tiles at the frame's edges);
// 4. computes e_u of 8 consecutive outputs a thread, register-tiled as in
//    step 2, e_z again from the frame at PH = 1, and the three sums.
// Rounding: e_z and the mask keep common.cuh's __f*_rn form, taps in
// row-major order from the centre value, the NVF sums in ops/nvf.py's order,
// so u_raw, e_z and the mask are bit-identical to the plain version's and
// to detect_many.cu's. e_u and the sums use fused multiply-adds, in
// detect_many.cu's order.
//
// Halo form (a row shard of a frame; the JAX package's *_padded kernels
// with the exchanged rows spliced into their padding, and the detect
// tail's row_start / total_rows): the frame (and the detect tail's W) holds
// top rows above the rows owned and bottom rows below them, true neighbour
// rows at a seam and replicated edge rows at the frame's border. The
// kernels take its rows, img_rows = top + rows + bottom, count the owned
// rows from its row top, clamp row indices to [0, img_rows - 1] of it,
// and write the owned rows only. The detect tail sets the ring rows
// outside the shard to u's edge rows only where the shard's edge is the
// frame's (row_start == 0 at the top, row_start + rows == total_rows at
// the bottom); at a seam they keep u of the true rows, which takes
// detect_halo rows of halo there.
// Columns clamp as before. top = bottom = row_start = 0 and total_rows =
// rows is the frame itself.
#include <cuda_pipeline.h>

#include "common.cuh"
#include "stencil.cuh"

using namespace wm::stencil;

namespace {

// ---- the 64 x 64 tile of the embed field and the detect tail -----------
// (stencil.cuh: the tile, its staging, predict_rn and nvf_region)

constexpr int kEmbedSlots = 2;   // sum u_raw^2, max mask
constexpr int kDetectSlots = 3;  // sum e_u*e_z, sum e_u^2, sum e_z^2

// ---- embed field -------------------------------------------------------

// The shared-memory layout of one instantiation (all sizes in floats).
// kHalf: the predictor's half-width (ME) or the NVF window's (NVF).
template <int kMask, int kHalf>
struct Embed {
  static constexpr bool kNVF = kMask == wm::kMaskNVF;
  static constexpr int kP = 2 * kHalf + 1;
  static constexpr int kCW = (kP + 3) / 4 * 4;  // a coefficient row, padded
  static constexpr bool kCoeffRegs = !kNVF && kHalf <= 2;  // 8 or 24
  // NVF: rows a thread masks (one column of 16 rows a thread covers the
  // tile), and at p=9 the row sums shared (a thread's own took 8% longer)
  static constexpr int kCR = 16;
  static constexpr bool kSharedSums = kNVF && kHalf >= 4;
  // the staged frame: s_img[k * kIS + c] = frame(clamp(y0 - kHalf + k),
  // clamp(x0 - kHalf - kOff + c)); kOff puts the frame's 16-byte chunks on
  // 16-byte boundaries (x0 is a multiple of 64)
  static constexpr int kOff = (4 - kHalf % 4) % 4;
  static constexpr int kIH = kTileH + 2 * kHalf;
  static constexpr int kIW = kOff + kTileW + 2 * kHalf;
  static constexpr int kIS = bank_stride(kIW);
  // NVF: the mask of the tile, s_mask[r * kMS + q], and the row sums; with
  // shared row sums the mask takes the staged frame's place, which is not
  // read after the sums (61 KB a block at p=9: three blocks an SM, not two)
  static constexpr int kMS = bank_stride(kTileW);
  static constexpr int kMaskAt = kSharedSums ? 0 : kIH * kIS;
  static constexpr int kSumAt =
      kIH * kIS + (kNVF && !kSharedSums ? kTileH * kMS : 0);
  static constexpr int kFloats = kSumAt + (kSharedSums ? 2 * kIH * kMS : 0);
  static_assert(!kSharedSums || kTileH * kMS <= kIH * kIS, "mask in frame");
  // blocks an SM: five at ME PH <= 2 (48 registers, 3% faster at p=5), four
  // elsewhere (64 registers: five spill at ME PH >= 3, and NVF with 8 rows a
  // thread to fit them was slower at p >= 5)
  static constexpr int kMinBlocks = !kNVF && kHalf <= 2 ? 5 : 4;
};

// W at the kR outputs of a row that start at w_row, n of them in the frame:
// two float4 loads where all kR lie in the frame and the rows are 16-byte
// aligned (vec), scalar ones elsewhere.
__device__ __forceinline__ void load_w(const float* __restrict__ w_row, int n,
                                       bool vec, float (&w)[kR]) {
  if (vec && n == kR) {
    const float4 w0 = __ldg(reinterpret_cast<const float4*>(w_row));
    const float4 w1 = __ldg(reinterpret_cast<const float4*>(w_row) + 1);
    w[0] = w0.x; w[1] = w0.y; w[2] = w0.z; w[3] = w0.w;
    w[4] = w1.x; w[5] = w1.y; w[6] = w1.z; w[7] = w1.w;
  } else {
#pragma unroll
    for (int j = 0; j < kR; ++j) w[j] = j < n ? __ldg(w_row + j) : 0.0f;
  }
}

// u = mask * W at those outputs, stored the same way, and their sum of u^2
// and max mask into acc.
__device__ __forceinline__ void store_u(const float (&mask)[kR],
                                        const float (&w)[kR],
                                        float* __restrict__ u_row, int n,
                                        bool vec, float (&acc)[2]) {
  float u[kR];
#pragma unroll
  for (int j = 0; j < kR; ++j) u[j] = __fmul_rn(mask[j], w[j]);
  store_row(u, u_row, n, vec);
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    if (j < n) {
      acc[0] = fmaf(u[j], u[j], acc[0]);
      acc[1] = fmaxf(acc[1], mask[j]);
    }
  }
}

// Partials (batch, tiles, kEmbedSlots). A frame of img holds img_rows rows,
// its owned rows from row top (the halo form); wmark and u_raw hold the
// owned rows. With done not null (whole frames), the frame's last block
// also writes totals[b] (sum u_raw^2) and totals[batch + b] (max mask).
template <int kMask, int kHalf>
__global__ void __launch_bounds__(kThreads, Embed<kMask, kHalf>::kMinBlocks)
    embed_field_kernel(const float* __restrict__ img,
                       const float* __restrict__ wmark,
                       const float* __restrict__ coeffs,
                       float* __restrict__ u_raw,
                       float* __restrict__ partials, int rows, int cols,
                       int top, int img_rows, float* __restrict__ totals,
                       int* __restrict__ done) {
  using G = Embed<kMask, kHalf>;
  constexpr int kIS = G::kIS;
  constexpr int kItems = kTileH * kTG / kThreads;  // rows of kR a thread
  extern __shared__ __align__(16) float s_embed[];  // G::kFloats
  __shared__ __align__(16) float s_cg[G::kNVF ? 1 : G::kP][G::kCW];
  const float* s_img = s_embed;

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.x;
  const size_t plane = static_cast<size_t>(rows) * cols;
  if constexpr (!G::kNVF)
    stage_coeff_rows<kHalf, G::kCW>(s_cg, coeffs, b, tid);
  stage_async<G::kIH, (G::kIW + 3) / 4, kIS>(
      s_embed, img + static_cast<size_t>(b) * img_rows * cols,
      y0 + top - kHalf, x0 - kHalf - G::kOff, img_rows, cols, tid);
  __pipeline_commit();
  // W of the thread's outputs, loaded while the frame is copied (at each
  // output instead, the loads waited in turn: 15% slower at ME p=3)
  const bool vec = cols % 4 == 0 &&
                   reinterpret_cast<size_t>(wmark) % 16 == 0 &&
                   reinterpret_cast<size_t>(u_raw) % 16 == 0;
  float w[kItems][kR];
#pragma unroll
  for (int item = 0; item < kItems; ++item) {
    int r, q0;
    tile_item(tid + item * kThreads, r, q0);
    const int n_valid = y0 + r < rows ? wm::clampi(cols - x0 - q0, 0, kR) : 0;
    load_w(wmark + static_cast<size_t>(y0 + r) * cols + x0 + q0, n_valid, vec,
           w[item]);
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  float cg[G::kCoeffRegs ? G::kP : 1][G::kCoeffRegs ? G::kP : 1];
  coeff_regs<G::kP, G::kCW, G::kCoeffRegs>(s_cg, cg);

  float* s_mask = s_embed + G::kMaskAt;
  if constexpr (G::kNVF) {
    nvf_region<kHalf, kTileH, kTileW, G::kIH, kIS, G::kOff, G::kCR,
               G::kSharedSums, G::kMS>(
        s_img, s_embed + G::kSumAt, tid,
        [&](int r, int q, float mask) { s_mask[r * G::kMS + q] = mask; });
    __syncthreads();
  }

  float acc[kEmbedSlots] = {0.0f, 0.0f};
#pragma unroll
  for (int item = 0; item < kItems; ++item) {
    int r, q0;
    tile_item(tid + item * kThreads, r, q0);
    const int n_valid = y0 + r < rows ? wm::clampi(cols - x0 - q0, 0, kR) : 0;
    if (n_valid == 0) continue;
    float mask[kR];
    if constexpr (G::kNVF) {
      wm::load_window<0, kR>(s_mask + r * G::kMS + q0, mask);
    } else {  // tile point (r, q0) is staged at (r + kHalf, q0 + kHalf + kOff)
      float e[kR];
      predict_rn<kHalf, G::kOff, G::kCW, G::kCoeffRegs>(
          s_img + r * kIS + q0 + G::kOff, kIS, cg, s_cg, e);
#pragma unroll
      for (int j = 0; j < kR; ++j) mask[j] = fabsf(e[j]);
    }
    store_u(mask, w[item],
            u_raw + b * plane + static_cast<size_t>(y0 + r) * cols + x0 + q0,
            n_valid, vec, acc);
  }
  const size_t block = (static_cast<size_t>(b) * gridDim.y + blockIdx.y) *
                           gridDim.x + blockIdx.x;
  wm::block_reduce_store<kEmbedSlots, 1>(acc, partials + block * kEmbedSlots);
  if (done != nullptr) {
    const int blocks = gridDim.x * gridDim.y;
    float total[kEmbedSlots];
    if (wm::frame_total<kEmbedSlots, 1>(
            partials + static_cast<size_t>(b) * blocks * kEmbedSlots, blocks,
            done + b, total) &&
        tid == 0) {
      totals[b] = total[0];
      totals[gridDim.z + b] = total[1];
    }
  }
}

// ---- detect tail -------------------------------------------------------

// The shared-memory layout of one instantiation (all sizes in floats).
template <int kMask, int kPH, int kNH>
struct Tail {
  static constexpr bool kNVF = kMask == wm::kMaskNVF;
  static constexpr int kP = 2 * kPH + 1;
  static constexpr int kCW = (kP + 3) / 4 * 4;  // a coefficient row, padded
  static constexpr int kS = wm::detect_halo(kMask, kPH, kNH);
  // NVF at p = 9 keeps the p-wide row sums of the staged rows in shared
  // memory; below that each thread adds the row sums its kCR rows need
  static constexpr bool kSharedSums = kNVF && kNH >= 4;
  static constexpr int kCR = kSharedSums ? 6 : 11;  // NVF: rows a thread masks
  // at PH = 1 the e_u pass computes e_z of the tile again from the frame
  static constexpr bool kEzShared = kPH > 1;
  // W is copied into the u region with the frame, but at PH = 4, where its
  // registers would spill under two blocks an SM
  static constexpr bool kWAsync = kPH <= 3;
  // the u region, the tile and its ring: region (r, q) is frame
  // (y0 - kPH + r, x0 - kPH + q); its rows are cut in groups of kR columns.
  // s_u[r * kUS + q] sits kUOff floats into its row, which puts W's 16-byte
  // chunks on 16-byte boundaries (x0 is a multiple of 64)
  static constexpr int kRH = kTileH + 2 * kPH;
  static constexpr int kRW = kTileW + 2 * kPH;
  static constexpr int kRG = (kRW + kR - 1) / kR;
  static constexpr int kUOff = kWAsync ? (4 - kPH % 4) % 4 : 0;
  static constexpr int kUS = bank_stride(kUOff + kRG * kR);
  // the staged frame: s_img[k * kIS + c] = frame(clamp(y0 - kS + k),
  // clamp(x0 - kS - kOff + c)); kOff puts the frame's 16-byte chunks on
  // 16-byte boundaries
  static constexpr int kOff = (4 - kS % 4) % 4;
  static constexpr int kIH = kTileH + 2 * kS;
  static constexpr int kIW = kOff + kRG * kR - 2 * kPH + 2 * kS;
  static constexpr int kIS = bank_stride(kIW);
  static constexpr int kES = bank_stride(kTileW);
  static constexpr int kUAt = kIH * kIS;            // s_u
  static constexpr int kEzAt = kUAt + kRH * kUS;    // s_ez
  static constexpr int kSumAt = kEzAt + (kEzShared ? kTileH * kES : 0);
  static constexpr int kFloats = kSumAt + (kSharedSums ? 2 * kIH * kUS : 0);
  static_assert(!kNVF || (kPH == 1 && kS == kPH + kNH), "NVF halo");
};

// kPH: the predictor's half-width; kNH: the NVF window's (NVF only).
// Partials (batch, tiles, kDetectSlots). A frame of img and wmark hold
// img_rows rows, the owned ones from row halo_top (the halo form);
// clamp_top / clamp_bottom: the shard's top / bottom edge is the frame's.
// With done not null (whole frames), the frame's last block also writes
// corr[b] = valid[b] ? dot / sqrt(||e_u||^2 ||e_z||^2) : 0.
// Blocks an SM: three at PH = 2, whose registers then fit 72 without a
// spill (11% faster at ME p=5); at PH >= 3 they would spill, and at PH = 1
// the kernel takes at most 64 registers, which lets four blocks in anyway.
template <int kMask, int kPH, int kNH>
__global__ void __launch_bounds__(kThreads, kPH == 2 ? 3 : 2)
    detect_tail_kernel(const float* __restrict__ img,
                       const float* __restrict__ wmark,
                       const float* __restrict__ coeffs,
                       float* __restrict__ partials, int rows, int cols,
                       int halo_top, int img_rows, bool clamp_top,
                       bool clamp_bottom, const bool* __restrict__ valid,
                       float* __restrict__ corr, int* __restrict__ done) {
  using G = Tail<kMask, kPH, kNH>;
  constexpr int kP = G::kP;
  constexpr int kWin = kR + 2 * kPH;  // a window row: kR outputs and ring
  constexpr bool kCoeffRegs = kPH <= 2;  // 8 or 24 coefficients
  constexpr int kRH = G::kRH, kRW = G::kRW, kRG = G::kRG;
  constexpr int kIS = G::kIS, kUS = G::kUS, kES = G::kES;
  extern __shared__ __align__(16) float s_tail[];  // G::kFloats
  // s_cg[dr][dc]: the coefficient of tap (dr - kPH, dc - kPH), centre 0
  __shared__ __align__(16) float s_cg[kP][G::kCW];
  float* s_img = s_tail;
  // s_u[r * kUS + q] = u(clamp(y0 - kPH + r), clamp(x0 - kPH + q)), W there
  // before u when W is staged
  float* s_u = s_tail + G::kUAt + G::kUOff;
  // s_ez[r * kES + q] = e_z(y0 + r, x0 + q)
  float* s_ez = s_tail + G::kEzAt;

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.x;
  stage_coeff_rows<kPH, G::kCW>(s_cg, coeffs, b, tid);
  stage_async<G::kIH, (G::kIW + 3) / 4, kIS>(
      s_img, img + static_cast<size_t>(b) * img_rows * cols,
      y0 + halo_top - G::kS, x0 - G::kS - G::kOff, img_rows, cols, tid);
  if constexpr (G::kWAsync)
    stage_async<kRH, (G::kUOff + kRW + 3) / 4, kUS>(
        s_tail + G::kUAt, wmark, y0 + halo_top - kPH, x0 - kPH - G::kUOff,
        img_rows, cols, tid);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  float cg[kCoeffRegs ? kP : 1][kCoeffRegs ? kP : 1];
  coeff_regs<kP, G::kCW, kCoeffRegs>(s_cg, cg);
  // W at region row r, column q
  const auto w_at = [&](int r, int q) {
    if constexpr (G::kWAsync) return s_u[r * kUS + q];
    return __ldg(wmark +
                 static_cast<size_t>(
                     wm::clampi(y0 + halo_top - kPH + r, 0, img_rows - 1)) *
                     cols +
                 wm::clampi(x0 - kPH + q, 0, cols - 1));
  };

  // ---- e_z and u over the region, at unclamped coordinates; the ring
  // outside the frame is set right after
  if constexpr (!G::kNVF) {
    // a thread takes kR consecutive region columns of one row; lanes 0-7 of
    // a warp take eight consecutive rows of one column group
    for (int i = tid; i < (kRH + 7) / 8 * 8 * kRG; i += kThreads) {
      const int rb = i / (8 * kRG);
      const int rem = i - rb * 8 * kRG;
      const int r = rb * 8 + (rem & 7);
      const int q0 = (rem >> 3) * kR;
      if (r >= kRH) continue;
      float e[kR];
      predict_rn<kPH, G::kOff, G::kCW, kCoeffRegs>(
          s_img + r * kIS + q0 + G::kOff, kIS, cg, s_cg, e);  // kS = 2 kPH
      float u[kR];
      if constexpr (G::kWAsync) {
        wm::load_window<G::kUOff, kR>(s_u + r * kUS + q0, u);
#pragma unroll
        for (int j = 0; j < kR; ++j) u[j] = __fmul_rn(fabsf(e[j]), u[j]);
      } else {
#pragma unroll
        for (int j = 0; j < kR; ++j)
          u[j] = __fmul_rn(fabsf(e[j]), w_at(r, q0 + j));
      }
      if constexpr (G::kUOff == 0) {
        float4* u_at = reinterpret_cast<float4*>(s_u + r * kUS + q0);
        u_at[0] = make_float4(u[0], u[1], u[2], u[3]);
        u_at[1] = make_float4(u[4], u[5], u[6], u[7]);
      } else {
#pragma unroll
        for (int j = 0; j < kR; ++j) s_u[r * kUS + q0 + j] = u[j];
      }
      if (G::kEzShared && r >= kPH && r < kPH + kTileH) {
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int q = q0 + j - kPH;
          if (q >= 0 && q < kTileW) s_ez[(r - kPH) * kES + q] = e[j];
        }
      }
    }
  } else {
    // the region's window is staged from its own corner (kS = kPH + kNH)
    nvf_region<kNH, kRH, kRW, G::kIH, kIS, G::kOff, G::kCR, G::kSharedSums,
               kUS>(s_img, s_tail + G::kSumAt, tid,
                    [&](int r, int q, float mask) {
                      s_u[r * kUS + q] = __fmul_rn(mask, w_at(r, q));
                    });
  }

  // ---- the ring outside the frame: u at the clamped coordinates, rows
  // first (whole region rows), then columns (every row); the sources lie
  // inside the frame and are never written here. Rows only at the frame's
  // own edges: past a seam the ring is u of the true rows, computed above
  const int top = clamp_top ? max(0, kPH - y0) : 0;   // region rows [0, top)
  const int bottom =                                  // and [bottom, kRH)
      clamp_bottom ? min(kRH, rows - y0 + kPH) : kRH;
  const int left = max(0, kPH - x0);                // columns [0, left)
  const int right = min(kRW, cols - x0 + kPH);      // and [right, kRW)
  if (top > 0 || bottom < kRH) {  // the same in every thread of the block
    __syncthreads();
    const int n = (top + kRH - bottom) * kRW;
    for (int i = tid; i < n; i += kThreads) {
      const int f = i / kRW;
      const int q = i - f * kRW;
      const int r = f < top ? f : bottom + f - top;
      s_u[r * kUS + q] = s_u[(f < top ? top : bottom - 1) * kUS + q];
    }
  }
  if (left > 0 || right < kRW) {
    __syncthreads();
    const int n_cols = left + kRW - right;
    for (int i = tid; i < kRH * n_cols; i += kThreads) {
      const int r = i / n_cols;
      const int f = i - r * n_cols;
      const int q = f < left ? f : right + f - left;
      s_u[r * kUS + q] = s_u[r * kUS + (f < left ? left : right - 1)];
    }
  }
  __syncthreads();

  // ---- e_u of kR consecutive outputs a thread and the three sums
  float acc[kDetectSlots] = {0.0f, 0.0f, 0.0f};
  for (int i = tid; i < kTileH * kTG; i += kThreads) {
    int r, q0;
    tile_item(i, r, q0);
    const int n_valid = y0 + r < rows ? wm::clampi(cols - x0 - q0, 0, kR) : 0;
    if (n_valid == 0) continue;
    // one tap row at a time, the centre row first to start each sum at u:
    // the row's kWin u values and kP coefficients serve kR * kP fused
    // multiply-adds
    float e_u[kR];
#pragma unroll
    for (int t = 0; t < kP; ++t) {
      const int dr = t == 0 ? kPH : (t <= kPH ? t - 1 : t);
      float w[kWin];
      wm::load_window<G::kUOff, kWin>(s_u + (r + dr) * kUS + q0, w);
      float cr[kP];
      coeff_row<kP, G::kCW, kCoeffRegs>(cg, s_cg, dr, cr);
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
    float e_z[kR];
    if constexpr (G::kEzShared) {
      wm::load_window<0, kR>(s_ez + r * kES + q0, e_z);
    } else {  // tile point (r, q0) is staged at (r + kS, q0 + kS + kOff)
      predict_rn<kPH, (G::kOff + G::kS - kPH) % 4, G::kCW, kCoeffRegs>(
          s_img + (r + G::kS - kPH) * kIS + q0 + G::kOff + G::kS - kPH, kIS,
          cg, s_cg, e_z);
    }
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      if (j < n_valid) {
        acc[0] = fmaf(e_u[j], e_z[j], acc[0]);
        acc[1] = fmaf(e_u[j], e_u[j], acc[1]);
        acc[2] = fmaf(e_z[j], e_z[j], acc[2]);
      }
    }
  }
  const size_t block = (static_cast<size_t>(b) * gridDim.y + blockIdx.y) *
                           gridDim.x + blockIdx.x;
  wm::block_reduce_store<kDetectSlots, kDetectSlots>(
      acc, partials + block * kDetectSlots);
  if (done != nullptr) {
    const int blocks = gridDim.x * gridDim.y;
    float total[kDetectSlots];
    if (wm::frame_total<kDetectSlots, kDetectSlots>(
            partials + static_cast<size_t>(b) * blocks * kDetectSlots,
            blocks, done + b, total) &&
        tid == 0) {
      corr[b] = valid[b] ? __fdiv_rn(total[0], __fsqrt_rn(__fmul_rn(
                                                   total[1], total[2])))
                         : 0.0f;
    }
  }
}

template <int kMask, int kHalf>
int launch_embed(const float* img, const float* wmark, const float* coeffs,
                 float* u_raw, float* partials, int batch, int rows, int cols,
                 int top, int img_rows, float* totals, int* done,
                 cudaStream_t s) {
  constexpr int bytes = Embed<kMask, kHalf>::kFloats * sizeof(float);
  cudaFuncSetAttribute(embed_field_kernel<kMask, kHalf>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const dim3 grid(wm::ceil_div(cols, kTileW), wm::ceil_div(rows, kTileH),
                  batch);
  embed_field_kernel<kMask, kHalf><<<grid, kThreads, bytes, s>>>(
      img, wmark, coeffs, u_raw, partials, rows, cols, top, img_rows, totals,
      done);
  return static_cast<int>(cudaGetLastError());
}

template <int kMask, int kPH, int kNH>
int launch_detect(const float* img, const float* wmark, const float* coeffs,
                  float* partials, int batch, int rows, int cols, int top,
                  int img_rows, bool clamp_top, bool clamp_bottom,
                  const bool* valid, float* corr, int* done, cudaStream_t s) {
  constexpr int bytes = Tail<kMask, kPH, kNH>::kFloats * sizeof(float);
  cudaFuncSetAttribute(detect_tail_kernel<kMask, kPH, kNH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const dim3 grid(wm::ceil_div(cols, kTileW), wm::ceil_div(rows, kTileH),
                  batch);
  detect_tail_kernel<kMask, kPH, kNH><<<grid, kThreads, bytes, s>>>(
      img, wmark, coeffs, partials, rows, cols, top, img_rows, clamp_top,
      clamp_bottom, valid, corr, done);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int wm_embed_field_num_blocks(int rows, int cols, int mask_type,
                                         int p) {
  return wm::ceil_div(cols, kTileW) * wm::ceil_div(rows, kTileH);
}

namespace {

int embed_field(const float* img, const float* wmark, const float* coeffs,
                float* u_raw, float* partials, int batch, int rows, int cols,
                int mask_type, int p, int top, int bottom, float* totals,
                int* done, void* stream) {
  if (batch < 1 || rows < 1 || cols < 1 || top < 0 || bottom < 0)
    return cudaErrorInvalidValue;
  if (batch > 65535 || wm::ceil_div(rows, kTileH) > 65535)
    return cudaErrorInvalidValue;  // gridDim.z, gridDim.y
  if (mask_type == wm::kMaskME && coeffs == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WM_EMBED(mask, half)                                                 \
  launch_embed<mask, half>(img, wmark, coeffs, u_raw, partials, batch, rows, \
                           cols, top, top + rows + bottom, totals, done, s)
  if (mask_type == wm::kMaskME) {
    switch (p) {
      case 3: return WM_EMBED(wm::kMaskME, 1);
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

}  // namespace

// img, wmark (batch, top + rows + bottom, cols) / (rows, cols) f32; coeffs
// (batch, p*p-1) f32 (ME only, may be null for NVF) -> u_raw (batch, rows,
// cols) and partials (batch, wm_embed_field_num_blocks(rows, cols,
// mask_type, p), 2) f32.
extern "C" int wm_embed_field(const float* img, const float* wmark,
                              const float* coeffs, float* u_raw,
                              float* partials, int batch, int rows, int cols,
                              int mask_type, int p, int top, int bottom,
                              void* stream) {
  return embed_field(img, wmark, coeffs, u_raw, partials, batch, rows, cols,
                     mask_type, p, top, bottom, nullptr, nullptr, stream);
}

// As wm_embed_field on whole frames (top = bottom = 0), and each frame's
// last block reduces the frame's partials into totals (2, batch) f32: sum
// u_raw^2, then max mask. done (batch,) int32 must hold 0; it is left so.
extern "C" int wm_embed_field_totals(const float* img, const float* wmark,
                                     const float* coeffs, float* u_raw,
                                     float* partials, float* totals,
                                     int* done, int batch, int rows, int cols,
                                     int mask_type, int p, void* stream) {
  if (totals == nullptr || done == nullptr) return cudaErrorInvalidValue;
  return embed_field(img, wmark, coeffs, u_raw, partials, batch, rows, cols,
                     mask_type, p, 0, 0, totals, done, stream);
}

extern "C" int wm_detect_partials_num_blocks(int rows, int cols) {
  return wm::ceil_div(cols, kTileW) * wm::ceil_div(rows, kTileH);
}

namespace {

int detect_partials(const float* img, const float* wmark, const float* coeffs,
                    float* partials, int batch, int rows, int cols,
                    int mask_type, int p, int top, int bottom, int row_start,
                    int total_rows, const bool* valid, float* corr, int* done,
                    void* stream) {
  if (batch < 1 || rows < 1 || cols < 1 || coeffs == nullptr || top < 0 ||
      bottom < 0 || row_start < 0 || total_rows < row_start + rows)
    return cudaErrorInvalidValue;
  const bool clamp_top = row_start == 0;
  const bool clamp_bottom = row_start + rows == total_rows;
  if (batch > 65535 || wm::ceil_div(rows, kTileH) > 65535)
    return cudaErrorInvalidValue;  // gridDim.z, gridDim.y
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WM_DETECT(mask, ph, nh)                                            \
  launch_detect<mask, ph, nh>(img, wmark, coeffs, partials, batch, rows,  \
                              cols, top, top + rows + bottom, clamp_top,     \
                              clamp_bottom, valid, corr, done, s)
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

}  // namespace

// img (batch, top + rows + bottom, cols), wmark (top + rows + bottom, cols)
// f32; coeffs (batch, k) f32 with k = p*p-1 for ME and 8 for NVF; the
// owned rows are rows [row_start, row_start + rows) of a frame of
// total_rows -> partials (batch, wm_detect_partials_num_blocks(rows,
// cols), 3) f32.
extern "C" int wm_detect_partials(const float* img, const float* wmark,
                                  const float* coeffs, float* partials,
                                  int batch, int rows, int cols,
                                  int mask_type, int p, int top, int bottom,
                                  int row_start, int total_rows,
                                  void* stream) {
  return detect_partials(img, wmark, coeffs, partials, batch, rows, cols,
                         mask_type, p, top, bottom, row_start, total_rows,
                         nullptr, nullptr, nullptr, stream);
}

// As wm_detect_partials on whole frames, and each frame's last block
// reduces the frame's partials into corr (batch,) f32: valid[b] ? dot /
// sqrt(||e_u||^2 ||e_z||^2) : 0, valid (batch,) bool. done (batch,) int32
// must hold 0; it is left so.
extern "C" int wm_detect_corr(const float* img, const float* wmark,
                              const float* coeffs, const bool* valid,
                              float* partials, float* corr, int* done,
                              int batch, int rows, int cols, int mask_type,
                              int p, void* stream) {
  if (valid == nullptr || corr == nullptr || done == nullptr)
    return cudaErrorInvalidValue;
  return detect_partials(img, wmark, coeffs, partials, batch, rows, cols,
                         mask_type, p, 0, 0, 0, rows, valid, corr, done,
                         stream);
}
