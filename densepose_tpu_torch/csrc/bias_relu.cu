// E1: a convolution's bias and the ReLU after it, in one pass, in place, over
// a channels-last (NHWC) float16 or bfloat16 tensor seen as (rows, C), C
// innermost: y = max(0, T(float(x) + float(b[c]))). The DensePose head's
// stacked convs (models/roi_heads.py::StackedHead) run through cuDNN
// channels-last with no bias, then through this.
//
// Port-only: it replaces no TPU kernel. The JAX package leaves the bias and
// the ReLU to XLA, which fuses them into its convolution
// (densepose_tpu/models/roi_heads.py's head convs). The port first ran
// nn.Conv2d and F.relu on NCHW tensors: cuDNN transposed each conv's input to
// NHWC and its output back, PyTorch added the bias in a broadcast pass that
// it cannot vectorize, and the ReLU was one more pass. Those passes took
// about 2.6 of the head's 6.0 device ms a frame.
//
// What bounds it on the card: bytes. Each element is read once and written
// once; the arithmetic is an add and a max. So the design moves 16 bytes a
// load and a store, keeps each thread's bias in registers, and reads nothing
// else.
//
// Design: a block is (tx, 256 / tx) threads. tx threads span the packs of a
// row (a pack: 16 bytes, 8 halves, where C is a multiple of 8 and the
// pointers are aligned; else one element), so a warp's loads are neighbouring
// 16-byte pieces of one row. A thread takes a pack column j, widens its bias
// once, and walks kRows rows at a time down its column: kRows loads in
// flight, then kRows stores. The grid covers the rows once (a grid-stride
// loop past 2^30 blocks).
//
// The stack's two ends: the head's input comes NCHW from the pooler and its
// output leaves NCHW for the predictor. PyTorch's layout copy of a half
// tensor moves ~0.3-0.6 TB/s (2.3 ms a batch for the flagship's exit), so
// the same source holds a tiled transpose (transpose_kernel): the last link's
// E1 writes NCHW through it, and without a bias it is the entry's
// channels-last copy. It too reads and writes each byte once.
//
// Numerics: PyTorch's broadcast add computes float(y) + float(b) and rounds
// once to T; its ReLU (clamp_min) keeps a NaN and otherwise takes
// fmaxf(v, 0) in float, which is exact in T. E1 does the same in the same
// order (--fmad=false; there is no product to contract), so it is
// bit-identical to F.relu(y + b.view(1, -1, 1, 1)) on the same y. The plain
// PyTorch version (ops/bias_relu.py::bias_relu_plain) repeats it.

#include <stdint.h>
#include <string.h>

#include "roi_align_common.cuh"

namespace {

using roi_align_common::narrow;
using roi_align_common::widen;

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows a thread has in flight
constexpr int kTile = 64;  // the transposing form's tile: kTile x kTile elements

// One element: T(float(v) + bias), then max(0, .) with a NaN kept.
template <typename T>
__device__ __forceinline__ T bias_relu1(T v, float bias) {
  const T s = narrow<T>(__fadd_rn(widen(v), bias));
  const float f = widen(s);
  return f != f ? s : narrow<T>(fmaxf(f, 0.f));  // f != f: a NaN
}

// V elements of T as one access: 16 bytes (uint4) or one element.
template <typename T, int V>
struct Pack {
  T v[V];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (V * sizeof(T) == 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      memcpy(v, &u, sizeof(u));
    } else {
#pragma unroll
      for (int l = 0; l < V; ++l) v[l] = p[l];
    }
  }
  __device__ __forceinline__ void store(T* p) const {
    if constexpr (V * sizeof(T) == 16) {
      uint4 u;
      memcpy(&u, v, sizeof(u));
      *reinterpret_cast<uint4*>(p) = u;
    } else {
#pragma unroll
      for (int l = 0; l < V; ++l) p[l] = v[l];
    }
  }
};

// x and y may be the same tensor (in place): each element is read and then
// written by one thread, so neither pointer is __restrict__.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) bias_relu_kernel(const T* x, T* y,
                                                             const T* __restrict__ b,
                                                             int64_t rows, int c) {
  const int packs = c / V;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.y * kRows;
  for (int j = threadIdx.x; j < packs; j += blockDim.x) {
    float bias[V];
#pragma unroll
    for (int l = 0; l < V; ++l) bias[l] = widen(__ldg(b + j * V + l));
    for (int64_t r0 = (static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y) * kRows;
         r0 < rows; r0 += step) {
      Pack<T, V> p[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (r0 + k < rows) p[k].load(x + (r0 + k) * c + j * V);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (r0 + k >= rows) break;
#pragma unroll
        for (int l = 0; l < V; ++l) p[k].v[l] = bias_relu1(p[k].v[l], bias[l]);
        p[k].store(y + (r0 + k) * c + j * V);
      }
    }
  }
}

// The transposing form, E1's NCHW exit and its channels-last entry: each of
// m contiguous r x s matrices of x written transposed, s x r, into y; with
// kBiasRelu each element first through bias_relu1 with bias[column]. A block
// moves one kTile x kTile tile through shared memory (float, a column of
// padding, so neither phase has bank conflicts): a warp reads 32 neighbouring
// elements of an input row and writes 32 of an output row; every thread
// starts all 16 of its loads before it uses one.
template <typename T, bool kBiasRelu>
__global__ void __launch_bounds__(kThreads) transpose_kernel(const T* __restrict__ x,
                                                             T* __restrict__ y,
                                                             const T* __restrict__ b, int r,
                                                             int s, int tiles_r, int tiles_s,
                                                             int64_t tiles) {
  __shared__ float tile[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;  // (32, 8)
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int ts = static_cast<int>(t % tiles_s);
    const int64_t rest = t / tiles_s;
    const int tr = static_cast<int>(rest % tiles_r);
    const int64_t base = (rest / tiles_r) * r * static_cast<int64_t>(s);
    const int r0 = tr * kTile, s0 = ts * kTile;
    float bias[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (kBiasRelu && s0 + tx + 32 * h < s) bias[h] = widen(__ldg(b + s0 + tx + 32 * h));
    // every load first (predicated, so all 16 are in flight), then the math
    T v[kTile / 8][2];
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      const int row = r0 + ty + 8 * i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = s0 + tx + 32 * h;
        v[i][h] = row < r && col < s ? x[base + static_cast<int64_t>(row) * s + col]
                                     : narrow<T>(0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        tile[ty + 8 * i][tx + 32 * h] = widen(kBiasRelu ? bias_relu1(v[i][h], bias[h]) : v[i][h]);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      const int row = s0 + ty + 8 * i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = r0 + tx + 32 * h;
        if (row < s && col < r)
          y[base + static_cast<int64_t>(row) * r + col] = narrow<T>(tile[tx + 32 * h][ty + 8 * i]);
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch_transpose(const void* x, void* y, const void* b, int64_t m, int r, int s,
                             cudaStream_t stream) {
  const int tiles_r = (r + kTile - 1) / kTile, tiles_s = (s + kTile - 1) / kTile;
  const int64_t tiles = m * tiles_r * tiles_s;
  const int blocks = static_cast<int>(tiles < (1LL << 30) ? tiles : (1LL << 30));
  const dim3 block(32, kThreads / 32);
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  const T* bs = static_cast<const T*>(b);
  if (b != nullptr)
    transpose_kernel<T, true><<<blocks, block, 0, stream>>>(xs, ys, bs, r, s, tiles_r, tiles_s,
                                                            tiles);
  else
    transpose_kernel<T, false><<<blocks, block, 0, stream>>>(xs, ys, bs, r, s, tiles_r, tiles_s,
                                                             tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, void* y, const void* b, int64_t rows, int c,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = c % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int packs = vec ? c / V : c;
  int tx = 1;
  while (tx < 32 && tx < packs) tx *= 2;
  const dim3 block(tx, kThreads / tx);
  const int64_t per_block = static_cast<int64_t>(block.y) * kRows;
  const int64_t want = (rows + per_block - 1) / per_block;
  const int blocks = static_cast<int>(want < (1LL << 30) ? want : (1LL << 30));
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  const T* bs = static_cast<const T*>(b);
  if (vec)
    bias_relu_kernel<T, V><<<blocks, block, 0, stream>>>(xs, ys, bs, rows, c);
  else
    bias_relu_kernel<T, 1><<<blocks, block, 0, stream>>>(xs, ys, bs, rows, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: a contiguous (rows, c) tensor of the element type `dtype` (a DtypeCode:
// float16 or bfloat16), the memory of a channels-last (M, c, H, W) tensor
// with rows = M * H * W; b: c elements of the same type; y: where the result
// goes, x itself (in place) or another contiguous (rows, c) tensor. Returns
// the cudaError_t of the launch.
int dp_bias_relu(const void* x, void* y, const void* b, long long rows, int c, int dtype,
                 void* stream) {
  if (rows < 0 || c < 0) return cudaErrorInvalidValue;
  if (rows == 0 || c == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case roi_align_common::kFloat16:
      return launch<__half>(x, y, b, rows, c, s);
    case roi_align_common::kBFloat16:
      return launch<__nv_bfloat16>(x, y, b, rows, c, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// x: m contiguous (r, s) matrices of the element type `dtype` (float16 or
// bfloat16), back to back; y: m contiguous (s, r) matrices, written, each the
// transpose of x's; b: s elements of the same type, or null. With b each
// element is y = max(0, T(float(x) + float(b[column of x]))), as
// dp_bias_relu computes it (x channels-last (M, C, H, W), r = H * W, s = C:
// E1 writing NCHW); without b a copy (x NCHW, r = C, s = H * W: the
// channels-last copy of x). x and y must not overlap. Returns the
// cudaError_t of the launch.
int dp_transpose(const void* x, void* y, const void* b, long long m, int r, int s, int dtype,
                 void* stream) {
  if (m < 0 || r < 0 || s < 0) return cudaErrorInvalidValue;
  if (m == 0 || r == 0 || s == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case roi_align_common::kFloat16:
      return launch_transpose<__half>(x, y, b, m, r, s, st);
    case roi_align_common::kBFloat16:
      return launch_transpose<__nv_bfloat16>(x, y, b, m, r, s, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
