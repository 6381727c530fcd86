// U1: the 2x bilinear upsample (align_corners=False) of an NCHW tensor, the
// chart predictor's last step and the other 2x upsamples of the port.
//
// Port-only: it replaces no TPU kernel. The JAX package's upsample is XLA's
// (densepose_tpu/ops/resize.py::resize_bilinear), and the port first called
// F.interpolate, whose NCHW kernel (upsample_bilinear2d_out_frame) gives each
// thread one output pixel and loops over every (n, c) plane inside it: its
// grid has ceil(H_out * W_out / 1024) blocks, 13 at 112x112 and 4 at 56x56,
// so 4 to 13 of the card's 132 SMs work, each bound by the latency of its
// loads. That took a quarter to a third of a DensePose batch's device time.
//
// What bounds it on the card: bytes. Each input element is read once and
// four output elements are written; the arithmetic is a few operations an
// output. So the design spreads the grid over planes and rows, moves each
// byte once, and writes 16 bytes a store.
//
// Design: a thread owns M input columns (8 bytes: 4 halves or 2 floats) of
// a strip of kStrip input rows of one plane, and writes the 2 x kStrip
// output rows x 2M output columns (16 bytes a row) that they give. The grid
// covers (plane, strip, column chunk), chunks innermost, so a warp's stores
// are neighbouring 16-byte pieces of output rows. Output rows 2k and 2k+1
// read only input rows k-1, k and k+1: the thread forms each input row's
// horizontal sums once, keeps the previous and current rows' in registers,
// and reads one new row a step. Neighbouring threads read overlapping
// columns, which L1 serves; device memory sees each input byte about once.
// With W a multiple of M and aligned pointers and strides (the main path's
// 56x56 and 28x28 planes) the middle M columns are one 8-byte load and the
// output one 16-byte store a row; otherwise every element is loaded and
// stored alone, with the ragged last chunk masked.
//
// Strides: the input's planes, (H, W), are contiguous; N and C take any
// stride, so the int8 route's channel slices y[:, c:c + n] go through
// without a copy. The output is a contiguous (N, C, 2H, 2W) tensor that the
// wrapper allocates.
//
// Numerics: PyTorch's kernel computes each output as
//   h0 * (w0 * x[r0][c0] + w1 * x[r0][c1]) + h1 * (w0 * x[r1][c0] + w1 * x[r1][c1])
// in float, with (for scale 2) weights 1 and 0 at the first row or column and
// 0.25 / 0.75 elsewhere, the second tap clamped to the last row or column,
// compiled with multiply-add contraction. This source builds with
// --fmad=false and writes the same contraction out with __fmaf_rn: each
// a * b + c * d is fma(a, b, c * d). The weights are exact, so U1 performs
// the same roundings in the same order, and its output is bit-identical.
// The plain PyTorch version (ops/resize.py::upsample2x_plain) repeats it.

#include <stdint.h>
#include <string.h>

#include "roi_align_common.cuh"

namespace {

using roi_align_common::narrow;
using roi_align_common::widen;

constexpr int kThreads = 256;
constexpr int kStrip = 4;  // input rows a thread walks

// a * wa + b * wb as PyTorch's kernel rounds it: one product rounded, the
// other fused into the sum.
__device__ __forceinline__ float lerp2(float wa, float a, float wb, float b) {
  return __fmaf_rn(wa, a, __fmul_rn(wb, b));
}

// Input columns of a thread (8 bytes of T).
template <typename T>
struct Chunk {
  static constexpr int M = 8 / sizeof(T);
};

// The horizontal sums of one input row for output columns 2 m0 .. 2 m0 + 2M,
// from xs[0 .. M + 1], which holds the row's columns m0 - 1 .. m0 + M clamped
// to [0, W - 1]. Output column 2m takes (m - 1, m) at 0.25 / 0.75, or (0,
// min(1, W - 1)) at 1 / 0 when m is 0; column 2m + 1 takes (m, min(m + 1,
// W - 1)) at 0.75 / 0.25.
template <int M>
__device__ __forceinline__ void row_sums(const float (&xs)[M + 2], bool first, float (&s)[2 * M]) {
#pragma unroll
  for (int l = 0; l < M; ++l) {
    s[2 * l] = (l == 0 && first) ? lerp2(1.f, xs[1], 0.f, xs[2])
                                 : lerp2(0.25f, xs[l], 0.75f, xs[l + 1]);
    s[2 * l + 1] = lerp2(0.75f, xs[l + 1], 0.25f, xs[l + 2]);
  }
}

// Loads xs (row_sums' input) of row r of a plane at `in`.
template <typename T, bool kVec>
__device__ __forceinline__ void load_row(const T* __restrict__ in, int r, int w, int m0,
                                         float (&xs)[Chunk<T>::M + 2]) {
  constexpr int M = Chunk<T>::M;
  const T* row = in + static_cast<int64_t>(r) * w;
  xs[0] = widen(__ldg(row + max(m0 - 1, 0)));
  xs[M + 1] = widen(__ldg(row + min(m0 + M, w - 1)));
  if (kVec) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + m0));
    T t[M];
    memcpy(t, &v, sizeof(v));
#pragma unroll
    for (int l = 0; l < M; ++l) xs[l + 1] = widen(t[l]);
  } else {
#pragma unroll
    for (int l = 0; l < M; ++l) xs[l + 1] = widen(__ldg(row + min(m0 + l, w - 1)));
  }
}

// Output row `dst` (2M columns from column 2 m0): a * top + b * bottom.
template <typename T, bool kVec>
__device__ __forceinline__ void store_row(T* __restrict__ dst, float wa,
                                          const float (&top)[2 * Chunk<T>::M], float wb,
                                          const float (&bottom)[2 * Chunk<T>::M], int valid) {
  constexpr int M = Chunk<T>::M;
  T o[2 * M];
#pragma unroll
  for (int i = 0; i < 2 * M; ++i) o[i] = narrow<T>(lerp2(wa, top[i], wb, bottom[i]));
  if (kVec) {
    uint4 v;
    memcpy(&v, o, sizeof(v));
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
#pragma unroll
    for (int i = 0; i < 2 * M; ++i)
      if (i < valid) dst[i] = o[i];
  }
}

// kVec: w % M == 0, and the input's base and strides and the output's base
// aligned for 8-byte loads and 16-byte stores (the host checks).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) upsample2x_kernel(
    const T* __restrict__ x, T* __restrict__ y, int c, int h, int w, int64_t sn, int64_t sc,
    int chunks, int strips, int64_t total) {
  constexpr int M = Chunk<T>::M;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; t < total;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int q = static_cast<int>(t % chunks);
    const int64_t rest = t / chunks;
    const int s = static_cast<int>(rest % strips);
    const int64_t plane = rest / strips;
    const T* in = x + (plane / c) * sn + (plane % c) * sc;
    const int m0 = q * M;
    const int valid = 2 * (w - m0);  // output columns of this chunk inside the row
    const int k0 = s * kStrip, k1 = min(k0 + kStrip, h);
    T* out = y + plane * (4 * static_cast<int64_t>(h) * w) + 2 * m0;
    const int64_t out_row = 2 * static_cast<int64_t>(w);

    float xs[M + 2], prev[2 * M], cur[2 * M], next[2 * M];
    load_row<T, kVec>(in, max(k0 - 1, 0), w, m0, xs);
    row_sums<M>(xs, m0 == 0, prev);
    load_row<T, kVec>(in, k0, w, m0, xs);
    row_sums<M>(xs, m0 == 0, cur);
#pragma unroll
    for (int k = k0; k < k0 + kStrip; ++k) {
      if (k >= k1) break;
      load_row<T, kVec>(in, min(k + 1, h - 1), w, m0, xs);
      row_sums<M>(xs, m0 == 0, next);
      // row 2k: rows (k - 1, k) at 0.25 / 0.75, or (0, min(1, h - 1)) at 1 / 0
      if (k == 0)
        store_row<T, kVec>(out, 1.f, cur, 0.f, next, valid);
      else
        store_row<T, kVec>(out + 2 * k * out_row, 0.25f, prev, 0.75f, cur, valid);
      // row 2k + 1: rows (k, min(k + 1, h - 1)) at 0.75 / 0.25
      store_row<T, kVec>(out + (2 * k + 1) * out_row, 0.75f, cur, 0.25f, next, valid);
#pragma unroll
      for (int i = 0; i < 2 * M; ++i) {
        prev[i] = cur[i];
        cur[i] = next[i];
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, int n, int c, int h, int w, int64_t sn, int64_t sc,
                   cudaStream_t stream) {
  constexpr int M = Chunk<T>::M;
  const int chunks = (w + M - 1) / M;
  const int strips = (h + kStrip - 1) / kStrip;
  const int64_t total = static_cast<int64_t>(n) * c * strips * chunks;
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (1LL << 30) ? want : (1LL << 30));
  const bool vec = w % M == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 && sn % M == 0 && sc % M == 0;
  auto kernel = vec ? upsample2x_kernel<T, true> : upsample2x_kernel<T, false>;
  kernel<<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<T*>(y), c, h,
                                          w, sn, sc, chunks, strips, total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n, c, h, w) of the element type `dtype` (a DtypeCode), each (h, w)
// plane contiguous, element strides sn and sc between frames and channels;
// y: a contiguous (n, c, 2h, 2w) tensor of the same type, written. Returns
// the cudaError_t of the launch.
int dp_upsample2x(const void* x, void* y, int n, int c, int h, int w, long long sn,
                  long long sc, int dtype, void* stream) {
  if (n < 0 || c < 0 || h < 0 || w < 0 || sn < 0 || sc < 0) return cudaErrorInvalidValue;
  if (static_cast<long long>(n) * c * h * w == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case roi_align_common::kFloat32:
      return launch<float>(x, y, n, c, h, w, sn, sc, s);
    case roi_align_common::kFloat16:
      return launch<__half>(x, y, n, c, h, w, sn, sc, s);
    case roi_align_common::kBFloat16:
      return launch<__nv_bfloat16>(x, y, n, c, h, w, sn, sc, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
