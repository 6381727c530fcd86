// K3: skip-flag multi-level ROIAlign (torchvision semantics), in two launches.
//
// Replaces the TPU kernel
// densepose_tpu/ops/pallas/roi_align_kernel.py::_kernel_sparse (reached
// through _pool_one_level_sparse from roi_align_multilevel_sparse). Same
// function as K2 (csrc/roi_align.cu), in the separable form of
// densepose_tpu/ops/roi_align.py::_axis_weights: for a box at level l,
//
//   out[b, c, y, x] = sum_w Wx[b, x, w] * (sum_h Wy[b, y, h] * feat_l[c, h, w])
//
// where row y of Wy (and row x of Wx) holds, per column, the sum over the
// bin's `ratio` sub-samples of their bilinear tap weights, divided by ratio.
// The schedule is the TPU kernel's: boxes sorted by (level, x1) (done by the
// wrapper), chunks of kChunk sorted boxes, tiles of kTile columns, a flag per
// (level, chunk, tile) that is set when a box of the chunk at that level has
// a nonzero Wx entry in the tile. Per box, the output is the sum over the
// active tiles of its chunk, in ascending order, of that tile's part; the
// result is written in the caller's box order.
//
// Launches: (1) flags_kernel marks the flag table from each box's x taps;
// (2) pool_kernel computes the outputs. What bounds it on the card: bytes,
// as for K2 (about 8 * ratio^2 operations per output on 4 * ratio^2 tap
// reads). Design of the pool kernel: one thread per output element
// (sorted box, c, oy, ox), ox innermost, as K2. The TPU kernel multiplied
// whole dense Wy and Wx tiles on its matrix unit; here each thread builds only
// the nonzero entries of its Wy and Wx rows (at most 2 * ratio each: a
// short span of columns) and contracts those, so no zero weight is ever
// multiplied. It walks its x columns in ascending order tile by tile, reads
// the tile's flag, and does no work for an inactive (chunk, tile) pair; the
// tiles its box does not touch it never visits. There are no atomics, so
// two runs give the same bits. The levels are read in place as contiguous
// (C, H, W) maps through a per-level table; no level is padded. Tensor
// cores, tap reuse in shared memory and TMA are later work.
//
// Numerics: built with --fmad=false and written with the _rn intrinsics.
// The weights are exactly those of the plain version's _axis_weights; the
// contraction sums in its own order, within fp32 rounding of the plain
// version's matrix products.

#include <stdint.h>

#include "roi_align_common.cuh"

namespace {

using namespace roi_align_common;

constexpr int kMaxRatio = 8;
constexpr int kMaxTaps = 2 * kMaxRatio;  // nonzero entries of one weight row, at most
constexpr int kChunk = 128;              // ops/roi_align_sparse.py::CHUNK
constexpr int kTile = 8;                 // ops/roi_align_sparse.py::TILE

__device__ __forceinline__ void insert_sorted(int* col, int& n, int c) {
  for (int j = 0; j < n; ++j)
    if (col[j] == c) return;
  int j = n++;
  for (; j > 0 && col[j - 1] > c; --j) col[j] = col[j - 1];
  col[j] = c;
}

// The nonzero entries of row p of one axis's weights: distinct columns in
// ascending order, each weighing (sum over sub-samples i, in order, of
// (1 - lerp_i) where low_i is the column plus lerp_i where high_i is, for
// in-border samples) / g, the plain version's _axis_weights to the bit.
__device__ int axis_row(float start, float bin, int p, int g, float limit, int* col,
                        float* wt) {
  int lo[kMaxRatio], hi[kMaxRatio];
  float wl[kMaxRatio], wh[kMaxRatio];
  int n = 0;
  for (int i = 0; i < g; ++i) {
    float lerp;
    bool ok;
    axis_sample(start, bin, p, i, g, limit, lo[i], hi[i], lerp, ok);
    wl[i] = ok ? __fsub_rn(1.f, lerp) : 0.f;
    wh[i] = ok ? lerp : 0.f;
    if (wl[i] != 0.f) insert_sorted(col, n, lo[i]);
    if (wh[i] != 0.f) insert_sorted(col, n, hi[i]);
  }
  for (int j = 0; j < n; ++j) {
    float s = 0.f;
    for (int i = 0; i < g; ++i) {
      float term = lo[i] == col[j] ? wl[i] : 0.f;
      if (hi[i] == col[j]) term = __fadd_rn(term, wh[i]);
      s = __fadd_rn(s, term);
    }
    wt[j] = __fdiv_rn(s, static_cast<float>(g));
  }
  return n;
}

__global__ void __launch_bounds__(kThreads) flags_kernel(
    LevelTable lv, const float* __restrict__ boxes, const int32_t* __restrict__ levels,
    int32_t* __restrict__ flags, int m, int ow, int g, float offset, int aligned,
    int max_tiles) {
  const int n_chunks = (m + kChunk - 1) / kChunk;
  const long long total = static_cast<long long>(m) * ow * g;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int i = static_cast<int>(idx % g);
    const long long t = idx / g;
    const int p = static_cast<int>(t % ow);
    const int s = static_cast<int>(t / ow);
    const int l = levels[s];
    if (l < 0 || l >= lv.n) continue;
    float start_h, bin_h, start_w, bin_w;
    box_geometry(boxes + 4 * static_cast<long long>(s), lv.scale[l], offset, aligned, 1, ow,
                 start_h, bin_h, start_w, bin_w);
    int lo, hi;
    float lerp;
    bool ok;
    axis_sample(start_w, bin_w, p, i, g, static_cast<float>(lv.w[l]), lo, hi, lerp, ok);
    if (!ok) continue;
    // Every thread that marks a pair stores the same 1: the table is the same
    // whichever store lands last.
    int32_t* row = flags + (static_cast<long long>(l) * n_chunks + s / kChunk) * max_tiles;
    row[lo / kTile] = 1;  // weight 1 - lerp > 0
    if (lerp != 0.f) row[hi / kTile] = 1;
  }
}

__global__ void __launch_bounds__(kThreads) pool_kernel(
    LevelTable lv, const float* __restrict__ boxes, const int32_t* __restrict__ levels,
    const int64_t* __restrict__ order, const int32_t* __restrict__ flags,
    float* __restrict__ out, int m, int c, int oh, int ow, int g, float offset,
    int aligned, int max_tiles) {
  const int n_chunks = (m + kChunk - 1) / kChunk;
  const long long per_box = static_cast<long long>(c) * oh * ow;
  const long long total = per_box * m;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int ox = static_cast<int>(idx % ow);
    long long t = idx / ow;
    const int oy = static_cast<int>(t % oh);
    t /= oh;
    const int ch = static_cast<int>(t % c);
    const int s = static_cast<int>(t / c);
    const long long dst = order[s] * per_box + (static_cast<long long>(ch) * oh + oy) * ow + ox;

    const int l = levels[s];
    float acc = 0.f;
    if (l >= 0 && l < lv.n) {
      const int h = lv.h[l], w = lv.w[l];
      float start_h, bin_h, start_w, bin_w;
      box_geometry(boxes + 4 * static_cast<long long>(s), lv.scale[l], offset, aligned, oh,
                   ow, start_h, bin_h, start_w, bin_w);
      int ycol[kMaxTaps], xcol[kMaxTaps];
      float ywt[kMaxTaps], xwt[kMaxTaps];
      const int ny = axis_row(start_h, bin_h, oy, g, static_cast<float>(h), ycol, ywt);
      const int nx = axis_row(start_w, bin_w, ox, g, static_cast<float>(w), xcol, xwt);
      const float* f = lv.feat[l] + static_cast<size_t>(ch) * h * w;
      const int32_t* active =
          flags + (static_cast<long long>(l) * n_chunks + s / kChunk) * max_tiles;
      int tile = -1;
      bool on = false;
      float part = 0.f;
      for (int j = 0; j < nx; ++j) {
        const int tj = xcol[j] / kTile;
        if (tj != tile) {  // the next tile, ascending: close the previous one
          if (tile >= 0) acc = __fadd_rn(acc, part);
          tile = tj;
          on = active[tj] != 0;
          part = 0.f;
        }
        if (!on) continue;
        float r = 0.f;  // (Wy . feat_tile)[oy, xcol[j]]
        for (int k = 0; k < ny; ++k)
          r = __fadd_rn(r, __fmul_rn(ywt[k], f[static_cast<size_t>(ycol[k]) * w + xcol[j]]));
        part = __fadd_rn(part, __fmul_rn(xwt[j], r));
      }
      if (tile >= 0) acc = __fadd_rn(acc, part);
    }
    out[dst] = acc;
  }
}

}  // namespace

extern "C" {

int dp_roi_align_sparse_max_levels() { return kMaxLevels; }
int dp_roi_align_sparse_max_ratio() { return kMaxRatio; }

// Launch (1). feats: host array of n_levels device pointers to contiguous
// (C, H, W) f32 levels; hs, ws, scales: host arrays per level. boxes (m, 4) f32
// and levels (m,) i32 in sorted order; flags (n_levels, ceil(m / kChunk),
// max_tiles) i32, zeroed by the caller, marked here. Returns the cudaError_t
// of the launch.
int dp_roi_align_sparse_flags(const void* const* feats, const int* hs, const int* ws,
                              const float* scales, int n_levels, const void* boxes,
                              const void* levels, void* flags, int m, int ow, int ratio,
                              int aligned, int max_tiles, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || ratio <= 0 || ratio > kMaxRatio)
    return cudaErrorInvalidValue;
  for (int l = 0; l < n_levels; ++l)
    if ((ws[l] + kTile - 1) / kTile > max_tiles) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(m) * ow * ratio;
  if (total == 0) return cudaSuccess;
  flags_kernel<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_table(feats, hs, ws, scales, n_levels), static_cast<const float*>(boxes),
      static_cast<const int32_t*>(levels), static_cast<int32_t*>(flags), m, ow, ratio,
      aligned ? 0.5f : 0.f, aligned, max_tiles);
  return cudaGetLastError();
}

// Launch (2). boxes, levels and flags as above; order (m,) i64: the caller's
// index of each sorted box. out (m, c, oh, ow) f32 in the caller's order,
// written. Returns the cudaError_t of the launch.
int dp_roi_align_sparse_pool(const void* const* feats, const int* hs, const int* ws,
                             const float* scales, int n_levels, const void* boxes,
                             const void* levels, const void* order, const void* flags,
                             void* out, int m, int c, int oh, int ow, int ratio,
                             int aligned, int max_tiles, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || ratio <= 0 || ratio > kMaxRatio)
    return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(m) * c * oh * ow;
  if (total == 0) return cudaSuccess;
  pool_kernel<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_table(feats, hs, ws, scales, n_levels), static_cast<const float*>(boxes),
      static_cast<const int32_t*>(levels), static_cast<const int64_t*>(order),
      static_cast<const int32_t*>(flags), static_cast<float*>(out), m, c, oh, ow, ratio,
      aligned ? 0.5f : 0.f, aligned, max_tiles);
  return cudaGetLastError();
}

}  // extern "C"
