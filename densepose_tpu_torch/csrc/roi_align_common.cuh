// What the two ROIAlign kernels share: K2 (roi_align.cu) and K3
// (roi_align_sparse.cu) compute the same function, so they share its
// sampling arithmetic, which must round exactly as the plain PyTorch versions
// (ops/roi_align.py::_axis_samples, _roi_geometry) do. Every source builds
// with --fmad=false, and these helpers use the _rn intrinsics.
//
// Both kernels read and write the feature dtype of TPU.COMPUTE_DTYPE: float,
// __half or __nv_bfloat16 (the element type T of their templates). A load
// widens T to float exactly; everything between runs in float; a store
// rounds to T once, to nearest even, as PyTorch's .to(dtype) does.
// U1 (upsample2x.cu) takes its element-type helpers and DtypeCode from here.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace roi_align_common {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

// The element type codes of the C entry points (ops/roi_align.py::DTYPE_CODES).
enum DtypeCode { kFloat32 = 0, kFloat16 = 1, kBFloat16 = 2 };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// A read-only feature load, widened to float.
template <typename T>
__device__ __forceinline__ float load(const T* p) {
  return widen(__ldg(p));
}

// float -> T, rounded to nearest even.
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __half narrow<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Per-level base pointers of contiguous (N, C, H, W) maps of one element type
// (N frames, N = 1 for one frame), their sizes and scales: every level in one
// launch. Frame f of level l starts f * C * h[l] * w[l] elements past feat[l].
struct LevelTable {
  const void* feat[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
  int n;
};

inline LevelTable make_table(const void* const* feats, const int* hs, const int* ws,
                             const float* scales, int n_levels) {
  LevelTable t{};
  for (int l = 0; l < n_levels; ++l) {
    t.feat[l] = feats[l];
    t.h[l] = hs[l];
    t.w[l] = ws[l];
    t.scale[l] = scales[l];
  }
  t.n = n_levels;
  return t;
}

// Blocks of kThreads for a grid-stride loop over `total` elements.
inline int blocks_for(long long total) {
  const long long want = (total + kThreads - 1) / kThreads;
  return static_cast<int>(want < (1LL << 30) ? want : (1LL << 30));
}

// Start and bin size of a box on its level, along y and x: the box scaled to
// the level, shifted by `offset` (0.5 when aligned), its size clamped to >= 1
// when not aligned, divided into oh x ow bins.
__device__ __forceinline__ void box_geometry(const float* box, float scale, float offset,
                                             int aligned, int oh, int ow, float& start_h,
                                             float& bin_h, float& start_w, float& bin_w) {
  start_w = __fsub_rn(__fmul_rn(box[0], scale), offset);
  start_h = __fsub_rn(__fmul_rn(box[1], scale), offset);
  const float end_w = __fsub_rn(__fmul_rn(box[2], scale), offset);
  const float end_h = __fsub_rn(__fmul_rn(box[3], scale), offset);
  float roi_w = __fsub_rn(end_w, start_w);
  float roi_h = __fsub_rn(end_h, start_h);
  if (!aligned) {
    roi_w = fmaxf(roi_w, 1.f);
    roi_h = fmaxf(roi_h, 1.f);
  }
  bin_h = __fdiv_rn(roi_h, static_cast<float>(oh));
  bin_w = __fdiv_rn(roi_w, static_cast<float>(ow));
}

// One sample coordinate along one axis: bin p, sub-sample i of g (at ratio 0
// g is the box's adaptive count, so the offsets are (i + 0.5) / g). `ok` is
// torchvision's border rule (-1 <= coord <= limit); the taps are `lo` and
// `hi` with weights 1 - lerp and lerp, both clamped to limit - 1 at the edge.
__device__ __forceinline__ void axis_sample(float start, float bin, int p, int i,
                                            int g, float limit, int& lo, int& hi,
                                            float& lerp, bool& ok) {
  const float frac = __fadd_rn(static_cast<float>(p),
                               __fdiv_rn(__fadd_rn(static_cast<float>(i), 0.5f),
                                         static_cast<float>(g)));
  const float coord = __fadd_rn(start, __fmul_rn(bin, frac));
  ok = coord >= -1.f && coord <= limit;
  const float c = fmaxf(coord, 0.f);
  float low = floorf(c);
  if (low >= __fsub_rn(limit, 1.f)) {
    low = __fsub_rn(limit, 1.f);
    lerp = 0.f;
    hi = static_cast<int>(low);
  } else {
    lerp = __fsub_rn(c, low);
    hi = static_cast<int>(low) + 1;
  }
  lo = static_cast<int>(low);
}

// Samples per bin at ratio 0 (adaptive), at most: the JAX package's
// _ADAPTIVE_CAP (densepose_tpu/ops/roi_align.py:64).
constexpr int kAdaptiveCap = 8;

// Samples per bin along one axis: `ratio`, or at ratio 0 the adaptive count
// min(ceil(bin), kAdaptiveCap), which is <= 0 (no sample) for an empty box.
__device__ __forceinline__ float samples_per_bin(float bin, int ratio) {
  return ratio > 0 ? static_cast<float>(ratio)
                   : fminf(ceilf(bin), static_cast<float>(kAdaptiveCap));
}

// One sample of one axis, as a table entry: axis_sample's taps and weights.
struct AxisTap {
  int lo, hi;
  float lerp, rlerp;  // weights of hi and lo: lerp and 1 - lerp
  int ok;             // the border rule
};

// table[p * g + i] for bins p < n_bins and sub-samples i < g, with
// axis_sample's roundings; the threads of the CTA share the entries. Nothing
// is written for g <= 0.
__device__ __forceinline__ void fill_axis_table(AxisTap* table, float start, float bin,
                                                int n_bins, int g, float limit) {
  for (int e = threadIdx.x; e < n_bins * g; e += blockDim.x) {
    const int p = e / g, i = e - p * g;
    AxisTap t;
    bool ok;
    axis_sample(start, bin, p, i, g, limit, t.lo, t.hi, t.lerp, ok);
    t.rlerp = __fsub_rn(1.f, t.lerp);
    t.ok = ok;
    table[e] = t;
  }
}

}  // namespace roi_align_common
