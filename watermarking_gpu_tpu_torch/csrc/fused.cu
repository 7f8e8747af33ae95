// Fused embed field and detect tail: everything after the predictor solve,
// one pass over the frame each, for p in {3, 5, 7, 9}. The multi-candidate
// detect, which shares the detect tail's arithmetic, is detect_many.cu.
//
// Replaces:
//   embed_field_kernel  <- the JAX package's ops/pallas/fused.py::
//       _embed_field_kernel and its raw twin _embed_field_kernel_raw (body
//       _embed_field_core);
//   detect_tail_kernel, detect_tail_pipelined_kernel (ME p = 3)  <-
//       fused.py::_detect_tail_kernel and its raw twin
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
// the NVF mask's separable box sums about 4p + 3. The detect tail reads the
// frame, 4 bytes a pixel, and W (75 MB with W once, 22 us) but at ME p=9
// does two 80-tap predictions a pixel, some 330 flops (81 us of f32), so it
// is bound by operations there. At ME p = 3, the bulk step's, a block a
// tile took 3.3x its bound (0.074 ms at 8 x 1080p on an H100): each block
// copied its tile and waited, then computed, so the copy, the shared-memory
// traffic and the arithmetic added up; it computed e_z twice a pixel and
// read W again for every frame. There the copy alone now takes 0.034 ms
// (the frames at ~2.2 TB/s) and the arithmetic alone 0.042, most of it
// e_z's 16 rounded operations a pixel, which issue one at a time: the
// pipelined schedule below overlaps the two, in part.
//
// What the design does about it: each input is read once, coalesced, and
// nothing intermediate goes to device memory: no padded copies (loads clamp
// their indices), no e or mask planes. The ME mask's 1/max|e| is not applied
// (it cancels in the pixels and in the correlation; the wrapper only reports
// max|e| for the strength). Per-block sums and maxes go to a small partials
// buffer that the wrapper finishes, or, on whole frames in a chain (chain.cu),
// that the frame's last block finishes (wm::frame_total; at ME p = 3 the
// last block of a chunk of frames, each of them): the embed field's sum
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
// from edge-replicated frame rows (reference Watermark.cpp:221-225).
//
// At ME p = 3 (detect_tail_pipelined_kernel) the grid is as many blocks as
// the card holds at once (two an SM, 83 KB of shared memory each), each
// taking tile positions in a fixed stride and walking a tile through the
// batch's frames, kChunk at a time:
// - W over the tile and its ring is staged once a tile position, into its
//   own region (u no longer overwrites it);
// - the next step's tile of the frame is copied into the other of two
//   stages while this one is computed: one 2-D tensor copy (TMA) a tile,
//   completing on the stage's mbarrier, whose zeros past the frames' edges
//   the step then replaces by the edge pixels; cp.async copies where the
//   frames' address or row pitch is not 16-byte aligned;
// - W of the block's next tile is copied once the last frame's u is
//   formed, and waited for only after the next step's e_z;
// - a thread takes a 4 x 4 block of outputs: e_z once a pixel, kept in
//   registers for the sums, each of the 6 window rows loaded once (the
//   side columns from the neighbouring lanes by shuffle), e_u the same way
//   from u; u of the ring is a point a thread;
// - each frame's three sums add up in a fixed order: each warp's into the
//   frame's slot in shared memory, the warps' in order at the chunk's end,
//   the blocks' by the wrapper's sum or, in a chain, by the chunk's last
//   block to count itself (a block counts once a chunk: 255 blocks each
//   finishing 8 frames in turn at the kernel's end held the 1080p bulk
//   step to +0.4% over a block a tile, against +7% so, on the H100).
// Tried and dropped on the H100 (8 x 1080p and 8 x 2160p, each build
// against the one it would have replaced, in one process): a third stage
// (+0.5-0.7%), 32-row tiles at four blocks an SM (+18-20%), 512 threads
// with 2 x 4 outputs a thread (+12-14%), a bulk copy a row in place of
// cp.async (+28-37%), L2 prefetch hints on cp.async (0 to +1%), 8 outputs
// of a row a thread in place of 4 x 4 (+5-6%).
//
// The wider windows (ME p >= 5) and NVF take one block a tile of a frame
// (detect_tail_kernel): bound by operations there, and NVF's mask wants
// the four blocks an SM a smaller block allows (its arithmetic alone took
// longer at two blocks an SM than this schedule's whole run). Each block:
// 1. copies the tile of the frame with a clamped halo of S pixels (S = 2 PH
//    for ME, PH + NH for NVF), and at PH <= 3 W over the u region, into
//    dynamic shared memory by cp.async;
// 2. computes u over the tile and its PH ring, register-tiled as above
//    (ME keeps e_z of the tile);
// 3. sets the ring outside the frame to u at the clamped coordinates (only
//    tiles at the frame's edges);
// 4. computes e_u of 8 consecutive outputs a thread, register-tiled as in
//    step 2, e_z of NVF from the frame, and the three sums.
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
#include <cuda.h>
#include <cuda_pipeline.h>

#include <atomic>

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
  // ME keeps e_z of the tile from the u pass; NVF, whose u pass computes
  // the mask, computes e_z in the e_u pass
  static constexpr bool kEzShared = !kNVF;
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

// e_u of kR consecutive outputs of a row, fused multiply-adds: at points
// to the u of tap (-kPH, -kPH) of output 0, kAlign floats past a 16-byte
// boundary. One tap row at a time, the centre row first to start each sum
// at u: the row's kR + 2 kPH u values and kP coefficients serve kR * kP
// fused multiply-adds.
template <int kPH, int kAlign, int kCW, bool kCoeffRegs>
__device__ __forceinline__ void predict_fma(
    const float* at, int stride,
    const float (&cg)[kCoeffRegs ? 2 * kPH + 1 : 1]
                     [kCoeffRegs ? 2 * kPH + 1 : 1],
    const float (*s_cg)[kCW], float (&e_u)[kR]) {
  constexpr int kP = 2 * kPH + 1;
  constexpr int kWin = kR + 2 * kPH;
#pragma unroll
  for (int t = 0; t < kP; ++t) {
    const int dr = t == 0 ? kPH : (t <= kPH ? t - 1 : t);
    float w[kWin];
    wm::load_window<kAlign, kWin>(at + dr * stride, w);
    float cr[kP];
    coeff_row<kP, kCW, kCoeffRegs>(cg, s_cg, dr, cr);
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
}

// The three sums of the first n of kR outputs into acc.
__device__ __forceinline__ void add_sums(const float (&e_u)[kR],
                                         const float (&e_z)[kR], int n,
                                         float (&acc)[kDetectSlots]) {
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    if (j < n) {
      acc[0] = fmaf(e_u[j], e_z[j], acc[0]);
      acc[1] = fmaf(e_u[j], e_u[j], acc[1]);
      acc[2] = fmaf(e_z[j], e_z[j], acc[2]);
    }
  }
}

// The ring of u outside the frame (region (r, q) is frame (y0 - kPH + r,
// x0 - kPH + q), s_u[r * kUS + q]): u at the clamped coordinates, rows
// first (whole region rows), then columns (every row); the sources lie
// inside the frame and are never written here. Rows only at the frame's
// own edges (clamp_top, clamp_bottom): past a seam the ring is u of the
// true rows. Every thread of the block calls it after a barrier that
// follows u's writes; where it writes, it ends on a barrier.
template <int kPH, int kRH, int kRW, int kUS>
__device__ __forceinline__ void clamp_ring(float* s_u, int y0, int x0,
                                           int rows, int cols, bool clamp_top,
                                           bool clamp_bottom, int tid) {
  const int top = clamp_top ? max(0, kPH - y0) : 0;   // region rows [0, top)
  const int bottom =                                  // and [bottom, kRH)
      clamp_bottom ? min(kRH, rows - y0 + kPH) : kRH;
  const int left = max(0, kPH - x0);                // columns [0, left)
  const int right = min(kRW, cols - x0 + kPH);      // and [right, kRW)
  // the same in every thread of the block
  const bool by_rows = top > 0 || bottom < kRH;
  const bool by_cols = left > 0 || right < kRW;
  if (by_rows) {
    const int n = (top + kRH - bottom) * kRW;
    for (int i = tid; i < n; i += kThreads) {
      const int f = i / kRW;
      const int q = i - f * kRW;
      const int r = f < top ? f : bottom + f - top;
      s_u[r * kUS + q] = s_u[(f < top ? top : bottom - 1) * kUS + q];
    }
  }
  if (by_cols) {
    if (by_rows) __syncthreads();
    const int n_cols = left + kRW - right;
    for (int i = tid; i < kRH * n_cols; i += kThreads) {
      const int r = i / n_cols;
      const int f = i - r * n_cols;
      const int q = f < left ? f : right + f - left;
      s_u[r * kUS + q] = s_u[r * kUS + (f < left ? left : right - 1)];
    }
  }
  if (by_rows || by_cols) __syncthreads();
}

// The one-shot schedule of the wider windows (ME p >= 5, NVF p >= 5): one
// block a tile of a frame. kPH: the predictor's half-width; kNH: the NVF
// window's (NVF only). Partials (batch, tiles, kDetectSlots). A frame of
// img and wmark hold
// img_rows rows, the owned ones from row halo_top (the halo form);
// clamp_top / clamp_bottom: the shard's top / bottom edge is the frame's.
// With done not null (whole frames), the frame's last block also writes
// corr[b] = valid[b] ? dot / sqrt(||e_u||^2 ||e_z||^2) : 0.
// Blocks an SM: three at PH = 2, whose registers then fit 72 without a
// spill (11% faster at ME p=5); at PH >= 3 they would spill, and at PH = 1
// (NVF) the kernel takes at most 64 registers, which lets four blocks in
// anyway.
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

  __syncthreads();
  clamp_ring<kPH, kRH, kRW, kUS>(s_u, y0, x0, rows, cols, clamp_top,
                                 clamp_bottom, tid);

  // ---- e_u of kR consecutive outputs a thread and the three sums
  float acc[kDetectSlots] = {0.0f, 0.0f, 0.0f};
  for (int i = tid; i < kTileH * kTG; i += kThreads) {
    int r, q0;
    tile_item(i, r, q0);
    const int n_valid = y0 + r < rows ? wm::clampi(cols - x0 - q0, 0, kR) : 0;
    if (n_valid == 0) continue;
    float e_u[kR];
    predict_fma<kPH, G::kUOff, G::kCW, kCoeffRegs>(s_u + r * kUS + q0, kUS,
                                                   cg, s_cg, e_u);
    float e_z[kR];
    if constexpr (G::kEzShared) {
      wm::load_window<0, kR>(s_ez + r * kES + q0, e_z);
    } else {  // tile point (r, q0) is staged at (r + kS, q0 + kS + kOff)
      predict_rn<kPH, (G::kOff + G::kS - kPH) % 4, G::kCW, kCoeffRegs>(
          s_img + (r + G::kS - kPH) * kIS + q0 + G::kOff + G::kS - kPH, kIS,
          cg, s_cg, e_z);
    }
    add_sums(e_u, e_z, n_valid, acc);
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

// ---- detect tail at ME p = 3: persistent blocks ------------------------

// The box of `map` at (x, y, b) into dst, completing on bar; the thread's
// generic accesses of shared memory before it are ordered before the copy.
__device__ __forceinline__ void tensor_copy(float* dst, const CUtensorMap* map,
                                            int x, int y, int b,
                                            unsigned long long* bar) {
  wm::fence_proxy_async();
#ifdef __CUDA_ARCH__
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
          wm::smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y), "r"(b),
      "r"(wm::smem_addr(bar))
      : "memory");
#endif
}

constexpr int kChunk = 8;   // frames whose sums a block holds at once
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 4;       // a thread's outputs: kQ x kQ of the tile
constexpr int kQG = kTileW / kQ;   // column groups of kQ, lanes of a half warp
static_assert(kQG == 16 && (kTileH / kQ) * kQG == kThreads, "a quad a thread");

// The shared-memory layout of the pipelined detect tail (floats): two
// stages of the staged frame (Tail's layout at ME p = 3, but rows as long
// as the tensor copy's box, 16-byte chunks with no padding), then W over
// the u region, then u (Tail's). A stage is 153 x 128 bytes, so each
// starts where the tensor copy may write.
struct Piped {
  using G = Tail<wm::kMaskME, 1, 0>;
  static_assert(G::kS == 2 && G::kUOff == 3 && G::kOff == 2, "3x3 layout");
  // 16-byte chunks of a staged row: the tile and its 2 kS columns from kOff
  static constexpr int kIChunks = (G::kOff + kTileW + 2 * G::kS + 3) / 4;
  static constexpr int kIS = 4 * kIChunks;   // a staged row, the box's
  static_assert(G::kIH * kIS * sizeof(float) % 128 == 0, "stage");
  static constexpr int kStage = G::kIH * kIS;
  static constexpr int kRegion = G::kRH * G::kUS;
  static constexpr int kWAt = 2 * kStage;
  static constexpr int kUAt = kWAt + kRegion;
  static constexpr int kFloats = kUAt + kRegion;
  // the ring of u around the tile: two region rows and two columns
  static constexpr int kRing = 2 * G::kRW + 2 * kTileH;
};

// Window row t of a quad: the kQ + 2 values from `at` (3 floats past a
// 16-byte boundary), w[0] and w[kQ + 1] the quad's left and right
// neighbours. g: the quad's column group, the lane's place in its half warp
// (every lane of the warp calls it). The kQ inner values are one 16-byte
// load; the neighbours come from the next lanes' loads, and at the tile's
// edges (g = 0, kQG - 1) from shared memory.
__device__ __forceinline__ void quad_row(const float* at, int g,
                                         float (&w)[kQ + 2]) {
  const float4 v = *reinterpret_cast<const float4*>(at + 1);
  w[1] = v.x; w[2] = v.y; w[3] = v.z; w[4] = v.w;
  w[0] = __shfl_up_sync(0xffffffffu, v.w, 1, kQG);
  w[5] = __shfl_down_sync(0xffffffffu, v.x, 1, kQG);
  if (g == 0) w[0] = at[0];
  if (g == kQG - 1) w[5] = at[kQ + 1];
}

// The prediction errors e[i][j] of a quad, rounded as predict_rn (the
// centre, then the taps in row-major order, a __fmul_rn and a __fsub_rn
// each): top is tap (-1, -1) of output (0, 0), 3 floats past a 16-byte
// boundary; each of the kQ + 2 window rows is loaded once.
__device__ __forceinline__ void predict_rn_quad(const float* top, int stride,
                                                int g, const float (&cg)[3][3],
                                                float (&e)[kQ][kQ]) {
  float w[kQ + 2][kQ + 2];
#pragma unroll
  for (int t = 0; t < kQ + 2; ++t) quad_row(top + t * stride, g, w[t]);
#pragma unroll
  for (int i = 0; i < kQ; ++i)
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      float v = w[i + 1][j + 1];
#pragma unroll
      for (int dr = 0; dr < 3; ++dr)
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          if (dr == 1 && dc == 1) continue;
          v = __fsub_rn(v, __fmul_rn(cg[dr][dc], w[i + dr][j + dc]));
        }
      e[i][j] = v;
    }
}

// e_u of a quad in predict_fma's order (the centre row's taps first, then
// the rows above and below): at is u at tap (-1, -1) of output (0, 0), 3
// floats past a 16-byte boundary.
__device__ __forceinline__ void predict_fma_quad(const float* at, int stride,
                                                 int g, const float (&cg)[3][3],
                                                 float (&e_u)[kQ][kQ]) {
  float w[kQ + 2][kQ + 2];
#pragma unroll
  for (int t = 0; t < kQ + 2; ++t) quad_row(at + t * stride, g, w[t]);
#pragma unroll
  for (int i = 0; i < kQ; ++i)
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      float v = w[i + 1][j + 1];
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const int dr = t == 0 ? 1 : (t == 1 ? 0 : 2);
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          if (dr == 1 && dc == 1) continue;
          v = fmaf(-cg[dr][dc], w[i + dr][j + dc], v);
        }
      }
      e_u[i][j] = v;
    }
}

// The detect tail at ME p = 3: gridDim.x blocks, as many as the card holds
// at once, each taking tiles blockIdx.x, blockIdx.x + gridDim.x, ... For a
// chunk of up to kChunk frames a block stages W over a tile and its ring
// once and walks the tile through the chunk's frames; the next frame's tile
// (or the next tile's first) is copied into the other of two stages while
// this one is computed (a tensor copy with `map` where `mapped`, else
// cp.async), and W of the next tile once the last frame's u is formed, its
// wait put off until after the next step's e_z. Per frame: e_z of the tile
// (a thread's kQ x kQ outputs, kept in registers for the sums: once a
// pixel), u = |e_z| W over the tile and over the ring (a point a thread),
// the ring outside the frame clamped, e_u and the three sums; each warp
// adds its sums into the frame's slot in a fixed order, and at the chunk's
// end the block writes partials[(b * gridDim.x + blockIdx.x) * 3 + s], its
// warps' slots added in order. Arguments as detect_tail_kernel's, with the
// batch; with done not null the chunk's last block also writes corr[b] of
// its frames (done[b0], b0 the chunk's first frame, counts the blocks).
__global__ void __launch_bounds__(kThreads, 2)
    detect_tail_pipelined_kernel(const float* __restrict__ img,
                                 const float* __restrict__ wmark,
                                 const float* __restrict__ coeffs,
                                 float* __restrict__ partials, int batch,
                                 int rows, int cols, int halo_top,
                                 int img_rows, bool clamp_top,
                                 bool clamp_bottom,
                                 const bool* __restrict__ valid,
                                 float* __restrict__ corr,
                                 int* __restrict__ done,
                                 const __grid_constant__ CUtensorMap map,
                                 bool mapped) {
  using G = Piped::G;
  constexpr int kIS = Piped::kIS, kUS = G::kUS, kRH = G::kRH, kRW = G::kRW;
  constexpr int kCW = G::kCW;
  extern __shared__ __align__(128) float s_piped[];  // Piped::kFloats
  // s_cg[f][dr][dc]: frame f of the chunk's coefficient of tap (dr - 1,
  // dc - 1), centre 0; s_acc[f][warp][s]: the warp's sums of frame f
  __shared__ __align__(16) float s_cg[kChunk][3][kCW];
  __shared__ float s_acc[kChunk][kWarps][kDetectSlots];
  // W and u at region (r, q): s_w[r * kUS + q], s_u[r * kUS + q]
  const float* s_w = s_piped + Piped::kWAt + G::kUOff;
  float* s_u = s_piped + Piped::kUAt + G::kUOff;

  const int tid = threadIdx.x;
  // the thread's quad: tile rows kQ qh .., columns kQ qg ..
  const int qg = tid % kQG, qh = tid / kQG;
  const int tiles_x = wm::ceil_div(cols, kTileW);
  const int tiles = tiles_x * wm::ceil_div(rows, kTileH);
  const int blocks = gridDim.x;
  const size_t plane = static_cast<size_t>(img_rows) * cols;
  // a tile: one tensor copy by thread 0, the others arriving at the
  // stage's mbarrier (past the frames' edges it fills zeros, which the step
  // replaces by the edge pixels); with no tensor map, cp.async copies, each
  // thread arriving there once its copies land
  __shared__ __align__(8) unsigned long long s_full[2];
  const auto stage_frame = [&](int t, int b, int stage) {
    const int y = t / tiles_x * kTileH + halo_top - G::kS;
    const int x = t % tiles_x * kTileW - G::kS - G::kOff;
    float* dst = s_piped + stage * Piped::kStage;
    if (mapped) {
      if (tid == 0) {
        wm::mbar_expect_tx(&s_full[stage], Piped::kStage * sizeof(float));
        tensor_copy(dst, &map, x, y, b, &s_full[stage]);
      } else {
        wm::mbar_arrive(&s_full[stage]);
      }
    } else {
      stage_async<G::kIH, Piped::kIChunks, kIS>(dst, img + b * plane, y, x,
                                                img_rows, cols, tid);
      wm::mbar_arrive_copies(&s_full[stage]);
    }
  };
  if (tid == 0) {
    for (int k = 0; k < 2; ++k) wm::mbar_init(&s_full[k], kThreads);
    wm::mbar_init_fence();
  }
  __syncthreads();
  unsigned phases = 0;   // each stage's mbarrier phase, a bit a stage
  const auto stage_w = [&](int t) {
    stage_async<kRH, (G::kUOff + kRW + 3) / 4, kUS>(
        s_piped + Piped::kWAt, wmark, t / tiles_x * kTileH + halo_top - 1,
        t % tiles_x * kTileW - 1 - G::kUOff, img_rows, cols, tid);
    __pipeline_commit();
  };
  const auto start_chunk = [&](int b0, int n) {
    for (int f = 0; f < n; ++f)
      stage_coeff_rows<1, kCW>(s_cg[f], coeffs, b0 + f, tid);
    for (int i = tid; i < kChunk * kWarps * kDetectSlots; i += kThreads)
      (&s_acc[0][0][0])[i] = 0.0f;
  };
  // u at ring point i (region rows 0 and kRH - 1 alternating with columns
  // 0 and kRW - 1, which spreads a warp's loads over the banks), its e_z
  // rounded as predict_rn's; the window of region (r, q) is staged from
  // (r, q + kOff)
  const auto ring_u = [&](const float* s_img, const float (&cg)[3][3],
                          int i) {
    int r, q;
    if (i % 2 == 0 || i >= 4 * kTileH) {
      const int j = i < 4 * kTileH ? i / 2 : i - 2 * kTileH;
      r = j < kRW ? 0 : kRH - 1;
      q = j < kRW ? j : j - kRW;
    } else {
      r = 1 + i / 4;
      q = i / 2 % 2 ? kRW - 1 : 0;
    }
    const float* top = s_img + r * kIS + q + G::kOff;
    float e = top[kIS + 1];
#pragma unroll
    for (int dr = 0; dr < 3; ++dr)
#pragma unroll
      for (int dc = 0; dc < 3; ++dc) {
        if (dr == 1 && dc == 1) continue;
        e = __fsub_rn(e, __fmul_rn(cg[dr][dc], top[dr * kIS + dc]));
      }
    s_u[r * kUS + q] = __fmul_rn(fabsf(e), s_w[r * kUS + q]);
  };
  // the step after (st, sf, sb0): the chunk's next frame, else the block's
  // next tile, else the next chunk's first
  const auto step_after = [&](int& st, int& sf, int& sb0) {
    if (++sf == min(kChunk, batch - sb0)) {
      sf = 0;
      st += blocks;
      if (st >= tiles) {
        st = blockIdx.x;
        sb0 += kChunk;
      }
    }
  };

  int t = blockIdx.x, f = 0, b0 = 0, stage = 0;
  int n = min(kChunk, batch);
  start_chunk(0, n);
  stage_frame(t, 0, 0);
  stage_w(t);
  bool w_copied = true;   // W of this step's tile still in flight
  while (true) {
    int next_t = t, next_f = f, next_b0 = b0;
    step_after(next_t, next_f, next_b0);
    const bool more = next_b0 < batch;
    // this step's frame landed (W, copied after it, may be in flight)
    wm::mbar_wait(&s_full[stage], phases >> stage & 1);
    phases ^= 1u << stage;
    __syncthreads();  // ... and the last step's reads of the other stage
                      // and of u are done
    if (more) stage_frame(next_t, next_b0 + next_f, stage ^ 1);
    float* s_img = s_piped + stage * Piped::kStage;
    const int y0 = t / tiles_x * kTileH;
    const int x0 = t % tiles_x * kTileW;
    // the staged pixels past the frames' edges: the edge pixels (staged
    // (k, c + kOff) is frame (y0 + halo_top - kS + k, x0 - kS + c))
    if (mapped)
      clamp_ring<G::kS, G::kIH, kIS - G::kOff, kIS>(
          s_img + G::kOff, y0 + halo_top, x0, img_rows, cols, true, true,
          tid);
    float cg[3][3];
    coeff_regs<3, kCW, true>(s_cg[f], cg);

    // ---- e_z of the thread's quad, kept for the sums (tile point (r, q)
    // is staged at (r + kS, q + kS + kOff), region (r + 1, q + 1)), then u
    // there and at its ring point(s)
    float e_z[kQ][kQ];
    predict_rn_quad(s_img + (kQ * qh + 1) * kIS + kQ * qg + 3, kIS, qg, cg,
                    e_z);
    if (w_copied) {   // W landed
      __pipeline_wait_prior(0);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const int at = (kQ * qh + i + 1) * kUS + kQ * qg + 1;
      const float4 w = *reinterpret_cast<const float4*>(s_w + at);
      *reinterpret_cast<float4*>(s_u + at) = make_float4(
          __fmul_rn(fabsf(e_z[i][0]), w.x), __fmul_rn(fabsf(e_z[i][1]), w.y),
          __fmul_rn(fabsf(e_z[i][2]), w.z), __fmul_rn(fabsf(e_z[i][3]), w.w));
    }
    ring_u(s_img, cg, tid);
    if (tid < Piped::kRing - kThreads) ring_u(s_img, cg, kThreads + tid);
    __syncthreads();  // u formed, W read
    w_copied = more && next_t != t;
    if (w_copied) stage_w(next_t);
    clamp_ring<1, kRH, kRW, kUS>(s_u, y0, x0, rows, cols, clamp_top,
                                 clamp_bottom, tid);

    // ---- e_u of the thread's quad and the frame's three sums
    float acc[kDetectSlots] = {0.0f, 0.0f, 0.0f};
    {
      float e_u[kQ][kQ];
      predict_fma_quad(s_u + kQ * qh * kUS + kQ * qg, kUS, qg, cg, e_u);
      const int n_cols = wm::clampi(cols - x0 - kQ * qg, 0, kQ);
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        const int n_valid = y0 + kQ * qh + i < rows ? n_cols : 0;
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          if (j < n_valid) {
            acc[0] = fmaf(e_u[i][j], e_z[i][j], acc[0]);
            acc[1] = fmaf(e_u[i][j], e_u[i][j], acc[1]);
            acc[2] = fmaf(e_z[i][j], e_z[i][j], acc[2]);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kDetectSlots; ++s) {
      const float v = wm::warp_sum(acc[s]);
      if (tid % 32 == 0) s_acc[f][tid / 32][s] += v;
    }

    if (next_b0 != b0) {  // the chunk's last step
      __syncthreads();
      if (tid < kDetectSlots) {
        for (int g = 0; g < n; ++g) {
          float v = s_acc[g][0][tid];
          for (int w = 1; w < kWarps; ++w) v += s_acc[g][w][tid];
          partials[(static_cast<size_t>(b0 + g) * blocks + blockIdx.x) *
                       kDetectSlots + tid] = v;
        }
      }
      if (done != nullptr) {
        // wm::frame_total's last-block finish, once a chunk: the block that
        // counts itself last in done[b0] adds each of the chunk's sums over
        // the blocks, a warp a sum (its lanes in a stride, then the lanes in
        // a fixed order), and sets done[b0] back to 0
        __shared__ int s_last;
        __shared__ float s_total[kChunk][kDetectSlots];
        if (tid < kDetectSlots) __threadfence();
        __syncthreads();
        if (tid == 0) s_last = atomicAdd(done + b0, 1) == blocks - 1;
        __syncthreads();
        if (s_last) {
          __threadfence();
          for (int k = tid / 32; k < n * kDetectSlots; k += kWarps) {
            const float* parts =
                partials +
                static_cast<size_t>(b0 + k / kDetectSlots) * blocks *
                    kDetectSlots +
                k % kDetectSlots;
            float v = 0.0f;
            for (int i = tid % 32; i < blocks; i += 32)
              v += wm::load_l2(parts + static_cast<size_t>(i) * kDetectSlots);
            v = wm::warp_sum(v);
            if (tid % 32 == 0) s_total[k / kDetectSlots][k % kDetectSlots] = v;
          }
          __syncthreads();
          if (tid < n) {
            const float* total = s_total[tid];
            corr[b0 + tid] =
                valid[b0 + tid]
                    ? __fdiv_rn(total[0],
                                __fsqrt_rn(__fmul_rn(total[1], total[2])))
                    : 0.0f;
          }
          if (tid == 0) done[b0] = 0;
        }
      }
      if (!more) break;
      __syncthreads();  // the chunk's sums and coefficients read
      n = min(kChunk, batch - next_b0);
      start_chunk(next_b0, n);
    }
    t = next_t;
    f = next_f;
    b0 = next_b0;
    stage ^= 1;
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

// Blocks of the pipelined detect tail's grid for `tiles` tiles a frame on
// the current device, or a negative CUDA error: as many as the card holds
// at once (blocks an SM by the occupancy calculator, times the SMs, read
// once a device, which also allows the kernel its dynamic shared memory
// there), spread so that every block takes the same number of tiles.
int piped_blocks(int tiles) {
  static std::atomic<int> held[32];   // blocks the card holds, a device
  int device = 0;
  cudaError_t code = cudaGetDevice(&device);
  if (code != cudaSuccess) return -static_cast<int>(code);
  int capacity = device < 32 ? held[device].load() : 0;
  if (capacity == 0) {
    constexpr int bytes = Piped::kFloats * sizeof(float);
    int per_sm = 0, sms = 0;
    code = cudaFuncSetAttribute(detect_tail_pipelined_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                bytes);
    if (code == cudaSuccess)
      code = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, detect_tail_pipelined_kernel, kThreads, bytes);
    if (code == cudaSuccess)
      code = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device);
    if (code != cudaSuccess) return -static_cast<int>(code);
    if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
    capacity = per_sm * sms;
    if (device < 32) held[device].store(capacity);
  }
  return wm::ceil_div(tiles, wm::ceil_div(tiles, capacity));
}

// The frames as a tensor map (cols, img_rows, batch) whose box is a staged
// tile: 1 when made, 0 where the frames' address or row pitch is not
// 16-byte aligned (the kernel then copies by cp.async), or a negative CUDA
// error.
int frame_map(CUtensorMap* map, const float* img, int batch, int img_rows,
              int cols) {
  if (cols % 4 != 0 || reinterpret_cast<size_t>(img) % 16 != 0) return 0;
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    cudaGetLastError();
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr) return -static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(img_rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t pitches[2] = {sizeof(float) * cols,
                                 sizeof(float) * cols * img_rows};
  const cuuint32_t box[3] = {Piped::kIS, Piped::G::kIH, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<float*>(img), dims, pitches, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 1
             : -static_cast<int>(cudaErrorInvalidValue);
}

int launch_piped(const float* img, const float* wmark, const float* coeffs,
                 float* partials, int batch, int rows, int cols, int top,
                 int img_rows, bool clamp_top, bool clamp_bottom,
                 const bool* valid, float* corr, int* done, cudaStream_t s) {
  const int blocks = piped_blocks(wm::ceil_div(cols, kTileW) *
                                  wm::ceil_div(rows, kTileH));
  if (blocks < 0) return -blocks;
  CUtensorMap map = {};
  const int mapped = frame_map(&map, img, batch, img_rows, cols);
  if (mapped < 0) return -mapped;
  constexpr int bytes = Piped::kFloats * sizeof(float);
  detect_tail_pipelined_kernel<<<blocks, kThreads, bytes, s>>>(
      img, wmark, coeffs, partials, batch, rows, cols, top, img_rows,
      clamp_top, clamp_bottom, valid, corr, done, map, mapped == 1);
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

// Blocks a frame's partials hold: at ME p = 3 the pipelined kernel's grid
// on the current device (a negative CUDA error if it cannot be read), else
// a block a tile.
extern "C" int wm_detect_partials_num_blocks(int rows, int cols,
                                             int mask_type, int p) {
  const int tiles = wm::ceil_div(cols, kTileW) * wm::ceil_div(rows, kTileH);
  return mask_type == wm::kMaskME && p == 3 ? piped_blocks(tiles) : tiles;
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
  // ME p = 3 takes the pipelined schedule, the rest the one-shot one
  if (mask_type == wm::kMaskME) {
    switch (p) {
      case 3:
        return launch_piped(img, wmark, coeffs, partials, batch, rows, cols,
                            top, top + rows + bottom, clamp_top, clamp_bottom,
                            valid, corr, done, s);
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
// cols, mask_type, p), 3) f32.
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

// As wm_detect_partials on whole frames, and each frame's last block (at
// ME p = 3 the last of a chunk of frames) reduces the frame's partials into
// corr (batch,) f32: valid[b] ? dot /
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
