// The embed finish: after the embed field (u_raw, sum u_raw^2, max |e|),
// each frame's strength and its marked pixels in one pass,
//
//   scale     = numerator / sqrt(sum_u2[b])        numerator = sf * sqrt(n)
//   strength  = valid[b] ? (ME ? scale * max_e[b] : scale) : 0
//   marked    = valid[b] ? clamp(output + u_raw * scale, 0, 255) : output
//
// with u_raw (batch, H, W) broadcast over the output's channels, the output
// (batch, H, W) or (batch, H, W, C), f32 or u8 (the video's lumas: read as
// u8, widened exactly, written back truncated as a cast to u8 does).
//
// Replaces:
//   embed_finish_kernel <- the JAX package's
//       ops/pipelines.py::_embed_pipeline_fused, the lines after the embed
//       field (XLA code, not a Pallas kernel: inside the jitted step XLA
//       fuses them into "one AXPY pass"). Its plain PyTorch twin,
//       watermarking_gpu_tpu_torch/ops/cuda/finish.py::embed_finish_plain,
//       runs it eagerly as nine launches: five on (batch,) vectors (the
//       square root, the reciprocal and product that `float / tensor` is,
//       the product by max_e, the `where` of the strength) and four full
//       passes over the frames (multiply, add, clamp, `where`).
//
// What bounds it on an H100: bytes. It reads u_raw (4 bytes a pixel) and the
// output (4 or 1 bytes an element) once and writes the marked frames once:
// at 8 x 1080 x 1920 f32 199 MB, 0.059 ms at 3.35 TB/s, against ~730 MB
// for the four eager passes. Four operations an element: a product, a sum
// and the clamp's two comparisons.
//
// What the design does about it: one grid of (blocks a frame, frames); a
// thread handles 16 bytes of the output, 4 f32 or 16 u8 elements, with one
// 16-byte load and store where the frame's length and the pointers allow
// (and u_raw in 16-byte loads too when the output has one channel), else
// the same elements one at a time, neighbouring threads on neighbouring
// addresses. Each block computes its frame's scale from sum_u2[b] (a
// broadcast read), one thread a frame writes the strength. The arithmetic
// is the eager tail's, each operation rounded on its own (__f*_rn, never
// contracted into an FMA) in its order: torch's `float / tensor` is a
// reciprocal then a product by the float rounded to f32, so the scale is
// rn(rn(1 / rn(sqrt(s))) * numerator), and the clamp passes NaN through as
// ATen's does (an NVF constant frame: sum_u2 = 0, 0 * inf). The kernel thus
// gives the eager tail's bits on the card. Out of place: the chained step
// passes the same frames as image and output, and the video's lumas live in
// buffers that its pump reuses.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVectorBytes = 16;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ uint8_t narrow<uint8_t>(float x) {
  return static_cast<uint8_t>(__float2uint_rz(x));
}

__device__ __forceinline__ float finish(float out, float u, float scale,
                                        bool ok) {
  float v = __fadd_rn(out, __fmul_rn(u, scale));
  v = isnan(v) ? v : fminf(fmaxf(v, 0.0f), 255.0f);
  return ok ? v : out;
}

// Elements [e0, e0 + kV) of one frame, kV = 16 bytes of T.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads) embed_finish_kernel(
    const float* __restrict__ u_raw, const T* __restrict__ output,
    const float* __restrict__ sum_u2, const float* __restrict__ max_e,
    const bool* __restrict__ valid, T* __restrict__ marked,
    float* __restrict__ strength, int batch, int pixels, int channels,
    float numerator, int me) {
  constexpr int kV = kVectorBytes / static_cast<int>(sizeof(T));
  const long long elems = static_cast<long long>(pixels) * channels;
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const float scale =
        __fmul_rn(__frcp_rn(__fsqrt_rn(__ldg(sum_u2 + b))), numerator);
    const bool ok = valid[b];
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      strength[b] =
          ok ? (me ? __fmul_rn(scale, __ldg(max_e + b)) : scale) : 0.0f;
    }
    const float* u = u_raw + static_cast<size_t>(b) * pixels;
    const T* out = output + static_cast<size_t>(b) * elems;
    T* res = marked + static_cast<size_t>(b) * elems;
    const long long base = static_cast<long long>(blockIdx.x) * kThreads * kV;
    if (kVector) {
      // every frame holds a whole number of vectors (the host checks)
      const long long e0 = base + static_cast<long long>(threadIdx.x) * kV;
      if (e0 >= elems) continue;
      union {
        uint4 v;
        T e[kV];
      } in, result;
      in.v = __ldg(reinterpret_cast<const uint4*>(out + e0));
      float uu[kV];
      if (channels == 1) {
#pragma unroll
        for (int q = 0; q < kV / 4; ++q) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(u + e0) + q);
          uu[4 * q] = f.x;
          uu[4 * q + 1] = f.y;
          uu[4 * q + 2] = f.z;
          uu[4 * q + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < kV; ++q) uu[q] = __ldg(u + (e0 + q) / channels);
      }
#pragma unroll
      for (int q = 0; q < kV; ++q) {
        result.e[q] = narrow<T>(finish(widen(in.e[q]), uu[q], scale, ok));
      }
      *reinterpret_cast<uint4*>(res + e0) = result.v;
    } else {
#pragma unroll
      for (int q = 0; q < kV; ++q) {
        const long long e = base + q * kThreads + threadIdx.x;
        if (e < elems) {
          res[e] = narrow<T>(finish(widen(__ldg(out + e)),
                                    __ldg(u + e / channels), scale, ok));
        }
      }
    }
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % kVectorBytes == 0;
}

template <typename T>
int launch(const float* u_raw, const void* output, const float* sum_u2,
           const float* max_e, const bool* valid, void* marked,
           float* strength, int batch, int pixels, int channels,
           float numerator, int me, cudaStream_t stream) {
  constexpr int kV = kVectorBytes / static_cast<int>(sizeof(T));
  const long long elems = static_cast<long long>(pixels) * channels;
  const long long blocks = (elems + kThreads * kV - 1) / (kThreads * kV);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(batch < kMaxGridY ? batch
                                                          : kMaxGridY));
  const bool vector = elems % kV == 0 && aligned(output) && aligned(marked)
                      && (channels != 1 || aligned(u_raw));
  const auto out = static_cast<const T*>(output);
  const auto res = static_cast<T*>(marked);
  if (vector) {
    embed_finish_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        u_raw, out, sum_u2, max_e, valid, res, strength, batch, pixels,
        channels, numerator, me);
  } else {
    embed_finish_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        u_raw, out, sum_u2, max_e, valid, res, strength, batch, pixels,
        channels, numerator, me);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u_raw (batch, pixels) f32, output and marked (batch, pixels, channels)
// f32 (u8 = 0) or u8 (u8 = 1), sum_u2 and max_e (batch,) f32, valid (batch,)
// bool -> marked, strength (batch,) f32. me = 1 for the ME mask's strength
// (scale * max_e), 0 for NVF's (scale).
extern "C" int wm_embed_finish(const float* u_raw, const void* output,
                               const float* sum_u2, const float* max_e,
                               const bool* valid, void* marked,
                               float* strength, int batch, int pixels,
                               int channels, float numerator, int me, int u8,
                               void* stream) {
  if (batch < 1 || pixels < 1 || channels < 1) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return u8 ? launch<uint8_t>(u_raw, output, sum_u2, max_e, valid, marked,
                              strength, batch, pixels, channels, numerator,
                              me, s)
            : launch<float>(u_raw, output, sum_u2, max_e, valid, marked,
                            strength, batch, pixels, channels, numerator, me,
                            s);
}
