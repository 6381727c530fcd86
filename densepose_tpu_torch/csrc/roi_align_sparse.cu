// K3: skip-flag multi-level ROIAlign (torchvision semantics), in one launch,
// as a two-stage separable contraction through shared memory.
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
//
// What bounds it on the card: bytes, as for K2. Each feature pixel a box
// taps is read once and each output written once; an output costs about
// 2 * 2g * (|U| / ow + 1) operations (under 40 at ratio 2) for the 4 bytes
// it writes alone, below fp32's 20 operations a byte (67 TFLOP/s over
// 3.35 TB/s).
//
// The sort and the flags are gone on the card. The TPU kernel sorted the
// boxes by (level, x1) and flagged the (chunk of 128 boxes, tile of 8
// columns) pairs that some box's Wx touches, so that its matrix unit could
// skip all-zero blocks of a dense Wy @ feat @ Wx^T. Here each box contracts
// only the nonzero entries of its own rows, so no zero block is ever visited
// and every flag such a box would read is set: the flags skipped nothing, and
// a box's output does not depend on its place in the sort. The kernel takes
// the boxes in the caller's order and writes each output at its caller's
// index. The plain version (ops/roi_align_sparse.py) keeps the JAX schedule
// and is held against the Pallas kernel.
//
// Design: one CTA per (box, slab of channels), as K2. The CTA computes the
// box geometry once and builds its tables in shared memory: each output
// row's distinct Y rows and weights, each output column's distinct X columns,
// weights and index into U, the box's sorted union of distinct X columns
// (at most min(2g * ow, W_l)). Then two stages, a barrier between them:
//
//   stage 1  R[c][oy][u] = sum_k Wy[oy][k] * feat[c][ycol[oy][k]][U[u]]
//   stage 2  out[c][oy][ox] = sum_j Wx[ox][j] * R[c][oy][xidx[ox][j]]
//
// A thread takes kCh channels of one (oy, u) in stage 1 and of one (oy, ox)
// in stage 2: it reads its table entries once for the kCh channels, and its
// kCh x (Y taps <= 2g) feature loads are in flight together. Consecutive
// threads take consecutive u (stage 1) and ox (stage 2), so a warp reads
// neighbouring columns of one feature row and writes neighbouring outputs.
// Per (channel, output row) stage 1 makes |U| * (Y taps) loads, where the
// one-stage form (K2, and this kernel's earlier design) made ow * (2g)^2:
// equal when the bins are 2 or more pixels wide at their level (no two bins
// share a column), fewer for narrower bins, down to about a half when
// neighbouring bins share their edge columns. Operations per output row
// fall the same way, from 2 * ow * (2g)^2 to 2 * |U| * (Y taps) in stage 1
// plus 2 * ow * (X taps) in stage 2. The Y contraction a column needs is
// done once for the output row and shared by the bins that use the column;
// stage 2 reads R from shared memory. The slab is sized from the
// bound on |U| so R stays under kSlabBytes (32 channels at 7x7, 8 at 14x14,
// ratio 2, in float; twice that in a 2-byte type). Index arithmetic is
// 32-bit and stepped with carries, as in K2: no division per output. The only atomics are the integer ORs of U's
// bitmap, so two runs give the same bits.
//
// Batched frames, as in K2: levels (N, C, H, W) contiguous and `frames`
// (M,) int32, each box's frame. A CTA's tables are its own box's, so the
// frame enters only as the offset of the box's level by frame * C * H * W:
// one launch pools every frame's boxes, with no sort by frame (the plain
// version keeps the JAX schedule per frame, its sort key (frame, level, x)).
//
// Numerics: built with --fmad=false and written with the _rn intrinsics.
// The weights are exactly the plain version's _axis_weights (each a sum over
// the sub-samples, in order, of 1 - lerp and lerp where the column matches,
// divided by g). Each R sums its Y taps in ascending row order; each output
// sums its X taps in ascending column order into one partial per tile of
// kTile columns and adds the tiles in ascending order, as the plain version
// does per (chunk, tile) pair: within fp32 rounding of its matrix products.
//
// Element types (TPU.COMPUTE_DTYPE): the levels and the output are float,
// __half or __nv_bfloat16, one type a launch, with the TPU kernel's
// roundings (roi_align_kernel.py:288, :291 and :174-176, output :301): each
// nonzero Wy and Wx weight is rounded to T when its row is built (the tables
// keep the rounded value as float); R is stored in shared memory as T, so
// each stage-1 sum is rounded to T once (this also halves R's footprint, and
// a slab holds twice the channels); stage 2 widens R, sums in float, and the
// output is rounded to T once. Feature loads are T widened exactly. At
// T = float every rounding is the identity, so K3<float> is the fp32 kernel.

#include <climits>
#include <stdint.h>

#include "roi_align_common.cuh"

namespace {

using namespace roi_align_common;

constexpr int kMaxRatio = 8;
constexpr int kTile = 8;                  // ops/roi_align_sparse.py::TILE
constexpr int kCh = 4;                    // channels a thread takes in each stage
constexpr int kSlabBytes = 25 * 1024;     // R of one CTA's slab of channels, at most
constexpr int kStaticSmem = 48 * 1024;    // dynamic shared memory without an opt-in
constexpr int kMaxSmem = 227 * 1024;      // a block's shared memory on sm_90

// Shared-memory words of the tables for an oh x ow output at ratio g and
// levels at most max_w wide: counts (oh + ow), Y rows (col, weight), X rows
// (col, weight, index into U) and U at 2g entries a row, and the bitmap of U.
inline size_t table_words(int oh, int ow, int g, int max_w) {
  return static_cast<size_t>(oh + ow) + 2 * static_cast<size_t>(oh) * 2 * g +
         4 * static_cast<size_t>(ow) * 2 * g + (max_w + 31) / 32;
}

// One output row (or column) of one axis from its g staged samples: the
// distinct columns with a nonzero weight, in ascending order (each round
// takes the least column above the last), each weighing (the sum over
// sub-samples i, in order, of 1 - lerp_i where lo_i is the column plus
// lerp_i where hi_i is, for in-border samples) / g: the plain version's
// _axis_weights to the bit, then rounded to T (held as float). Entries past
// the count get column -1.
template <typename T, int G>
__device__ __forceinline__ int axis_row(const AxisTap* t, int ratio, int* col, float* wt) {
  const int g = G > 0 ? G : ratio;
  int n = 0;
  for (int prev = -1;;) {
    int next = INT_MAX;
#pragma unroll
    for (int i = 0; i < g; ++i) {
      const AxisTap s = t[i];
      if (!s.ok) continue;
      if (s.lo > prev) next = min(next, s.lo);
      if (s.lerp != 0.f && s.hi > prev) next = min(next, s.hi);
    }
    if (next == INT_MAX) break;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < g; ++i) {
      const AxisTap s = t[i];
      float term = s.ok && s.lo == next ? s.rlerp : 0.f;
      if (s.ok && s.hi == next) term = __fadd_rn(term, s.lerp);
      sum = __fadd_rn(sum, term);
    }
    col[n] = next;
    wt[n] = widen(narrow<T>(__fdiv_rn(sum, static_cast<float>(g))));
    ++n;
    prev = next;
  }
  for (int j = n; j < 2 * g; ++j) col[j] = -1;
  return n;
}

// T: the element type of the levels, R and the output. G > 0: ratio G at
// compile time; G == 0: `ratio` at run time (1..kMaxRatio).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads) roi_align_sparse_kernel(
    LevelTable lv, const float* __restrict__ boxes, const int32_t* __restrict__ levels,
    const int32_t* __restrict__ frames, int n_frames, T* __restrict__ out, int c, int oh,
    int ow, int ratio, int slab, int max_w, float offset, int aligned) {
  extern __shared__ int smem[];
  const int g = G > 0 ? G : ratio;
  const int g2 = 2 * g;
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * slab;
  const int hw = oh * ow;
  const int n_ch = min(slab, c - c0);
  T* o = out + (static_cast<size_t>(b) * c + c0) * hw;
  const int l = levels[b];
  const int fr = frames != nullptr ? frames[b] : 0;
  if (l < 0 || l >= lv.n || fr < 0 || fr >= n_frames) {
    for (int e = threadIdx.x; e < n_ch * hw; e += blockDim.x) o[e] = narrow<T>(0.f);
    return;
  }
  const int h = lv.h[l], w = lv.w[l];

  int* ny = smem;                                          // oh
  int* nx = ny + oh;                                       // ow
  int* ycol = nx + ow;                                     // oh x 2g
  float* ywt = reinterpret_cast<float*>(ycol + oh * g2);   // oh x 2g
  int* xcol = reinterpret_cast<int*>(ywt + oh * g2);       // ow x 2g
  float* xwt = reinterpret_cast<float*>(xcol + ow * g2);   // ow x 2g
  int* xidx = reinterpret_cast<int*>(xwt + ow * g2);       // ow x 2g
  int* ucol = xidx + ow * g2;                              // U, at most ow x 2g
  unsigned* bits = reinterpret_cast<unsigned*>(ucol + ow * g2);  // U as a bitmap
  // R in stage 1, as T; before it, the samples staged for the rows
  T* rbuf = reinterpret_cast<T*>(bits + (max_w + 31) / 32);

  // The samples, with axis_sample's roundings, then one thread per row.
  float start_h, bin_h, start_w, bin_w;
  box_geometry(boxes + 4 * static_cast<size_t>(b), lv.scale[l], offset, aligned, oh, ow,
               start_h, bin_h, start_w, bin_w);
  AxisTap* ty = reinterpret_cast<AxisTap*>(rbuf);
  AxisTap* tx = ty + oh * g;
  fill_axis_table(ty, start_h, bin_h, oh, g, static_cast<float>(h));
  fill_axis_table(tx, start_w, bin_w, ow, g, static_cast<float>(w));
  __syncthreads();
  for (int p = threadIdx.x; p < oh + ow; p += blockDim.x) {
    if (p < oh)
      ny[p] = axis_row<T, G>(ty + p * g, ratio, ycol + p * g2, ywt + p * g2);
    else
      nx[p - oh] = axis_row<T, G>(tx + (p - oh) * g, ratio, xcol + (p - oh) * g2,
                                  xwt + (p - oh) * g2);
  }
  __syncthreads();

  const int slots = ow * g2;
  // U from a bitmap of the level's columns: each X entry sets its column's
  // bit (an integer OR: the same bits whatever the order), and its index
  // into U is the number of bits below it.
  const int words = (w + 31) / 32;
  for (int i = threadIdx.x; i < words; i += blockDim.x) bits[i] = 0u;
  __syncthreads();
  for (int e = threadIdx.x; e < slots; e += blockDim.x) {
    const int col = xcol[e];
    if (col >= 0) atomicOr(bits + (col >> 5), 1u << (col & 31));
  }
  __syncthreads();
  int nu = 0;
  for (int i = 0; i < words; ++i) nu += __popc(bits[i]);
  for (int e = threadIdx.x; e < slots; e += blockDim.x) {
    const int col = xcol[e];
    if (col < 0) continue;
    int rank = __popc(bits[col >> 5] & ((1u << (col & 31)) - 1u));
    for (int i = 0; i < (col >> 5); ++i) rank += __popc(bits[i]);
    xidx[e] = rank;
    ucol[rank] = col;
  }
  __syncthreads();

  // Stage 1 over (channel group, oy, u), u innermost: kCh channels a thread,
  // so its loads (kCh per Y tap) are in flight together.
  const int step = blockDim.x;
  const size_t plane = static_cast<size_t>(h) * w;
  const T* f0 = static_cast<const T*>(lv.feat[l]) +
                (static_cast<size_t>(fr) * c + c0) * plane;
  const int groups = (n_ch + kCh - 1) / kCh;
  const int n1 = groups * oh * nu;
  if (n1 > 0) {
    const int q = step / nu, du = step - q * nu, doy = q % oh, dgrp = q / oh;
    int e = threadIdx.x;
    const int r0 = e / nu;
    int u = e - r0 * nu, oy = r0 % oh, grp = r0 / oh;
    for (; e < n1; e += step) {
      const int k_n = ny[oy];
      const int* yc = ycol + oy * g2;
      const float* yw = ywt + oy * g2;
      const int cb = grp * kCh;
      const T* fc = f0 + cb * plane + ucol[u];
      float r[kCh];
#pragma unroll
      for (int j = 0; j < kCh; ++j) r[j] = 0.f;
#pragma unroll
      for (int k = 0; k < (G > 0 ? 2 * G : 2 * kMaxRatio); ++k) {
        if (k >= k_n) break;
        const float wk = yw[k];
        const T* row = fc + yc[k] * w;
#pragma unroll
        for (int j = 0; j < kCh; ++j)
          if (cb + j < n_ch) r[j] = __fadd_rn(r[j], __fmul_rn(wk, load(row + j * plane)));
      }
      T* rr = rbuf + (cb * oh + oy) * nu + u;
#pragma unroll
      for (int j = 0; j < kCh; ++j)
        if (cb + j < n_ch) rr[j * oh * nu] = narrow<T>(r[j]);
      u += du;
      oy += doy;
      grp += dgrp;
      if (u >= nu) {
        u -= nu;
        ++oy;
      }
      if (oy >= oh) {
        oy -= oh;
        ++grp;
      }
    }
  }
  __syncthreads();

  // Stage 2 over (channel group, oy, ox), ox innermost: kCh outputs a thread.
  {
    const int n2 = groups * hw;
    const int dgrp = step / hw, dbin = step - dgrp * hw, doy = dbin / ow, dox = dbin - doy * ow;
    int e = threadIdx.x;
    int grp = e / hw, oy = (e - grp * hw) / ow;
    int ox = e - grp * hw - oy * ow;
    for (; e < n2; e += step) {
      const int cb = grp * kCh;
      const T* rrow = rbuf + (cb * oh + oy) * nu;
      const int j_n = nx[ox];
      const int* xc = xcol + ox * g2;
      const float* xw = xwt + ox * g2;
      const int* xi = xidx + ox * g2;
      float acc[kCh], part[kCh];
#pragma unroll
      for (int c = 0; c < kCh; ++c) acc[c] = part[c] = 0.f;
      int tile = -1;
#pragma unroll
      for (int j = 0; j < (G > 0 ? 2 * G : 2 * kMaxRatio); ++j) {
        if (j >= j_n) break;
        const int tj = xc[j] / kTile;
        if (tj != tile) {  // the next tile, ascending: close the previous one
          if (tile >= 0) {
#pragma unroll
            for (int c = 0; c < kCh; ++c) acc[c] = __fadd_rn(acc[c], part[c]);
          }
          tile = tj;
#pragma unroll
          for (int c = 0; c < kCh; ++c) part[c] = 0.f;
        }
        const float wj = xw[j];
        const int ij = xi[j];
#pragma unroll
        for (int c = 0; c < kCh; ++c)
          if (cb + c < n_ch)
            part[c] = __fadd_rn(part[c], __fmul_rn(wj, widen(rrow[c * oh * nu + ij])));
      }
      if (tile >= 0) {
#pragma unroll
        for (int c = 0; c < kCh; ++c) acc[c] = __fadd_rn(acc[c], part[c]);
      }
      T* oo = o + cb * hw + oy * ow + ox;
#pragma unroll
      for (int c = 0; c < kCh; ++c)
        if (cb + c < n_ch) oo[c * hw] = narrow<T>(acc[c]);
      ox += dox;
      oy += doy;
      grp += dgrp;
      if (ox >= ow) {
        ox -= ow;
        ++oy;
      }
      if (oy >= oh) {
        oy -= oh;
        ++grp;
      }
    }
  }
}

// Sizes the launch for element type T and launches it.
template <typename T>
cudaError_t launch(const LevelTable& lv, int max_w, const void* boxes, const void* levels,
                   const void* frames, int n_frames, void* out, int m, int c, int oh, int ow,
                   int ratio, int aligned, cudaStream_t stream) {
  const int max_u = 2 * ratio * ow < max_w ? 2 * ratio * ow : max_w;
  const size_t per_ch = static_cast<size_t>(oh) * max_u * sizeof(T);
  const int fit = static_cast<int>(kSlabBytes / per_ch);
  const int want = fit < 1 ? 1 : (fit < c ? fit : c);
  const int n_slabs = (c + want - 1) / want;
  const int slab = (c + n_slabs - 1) / n_slabs;
  const size_t staged = static_cast<size_t>(oh + ow) * ratio * sizeof(AxisTap);
  const size_t rbytes = slab * per_ch > staged ? slab * per_ch : staged;
  const size_t smem = table_words(oh, ow, ratio, max_w) * sizeof(int) + rbytes;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = ratio == 2 ? roi_align_sparse_kernel<T, 2> : roi_align_sparse_kernel<T, 0>;
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(m, n_slabs);
  kernel<<<grid, kThreads, smem, stream>>>(
      lv, static_cast<const float*>(boxes), static_cast<const int32_t*>(levels),
      static_cast<const int32_t*>(frames), n_frames, static_cast<T*>(out), c, oh, ow, ratio,
      slab, max_w, aligned ? 0.5f : 0.f, aligned);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int dp_roi_align_sparse_max_levels() { return kMaxLevels; }
int dp_roi_align_sparse_max_ratio() { return kMaxRatio; }

// feats: host array of n_levels device pointers to contiguous
// (n_frames, C, H, W) levels of the element type `dtype` (a DtypeCode); hs,
// ws, scales: host arrays per level. boxes (m, 4) f32, levels (m,) i32 and
// frames (m,) i32 or null (every box on frame 0) in the caller's order; out
// (m, c, oh, ow) of the levels' type, written (zeros for a box whose level
// is not in [0, n_levels) or whose frame is not in [0, n_frames)). Returns
// the cudaError_t of the launch, or cudaErrorInvalidValue for inputs the
// kernel does not take.
int dp_roi_align_sparse(const void* const* feats, const int* hs, const int* ws,
                        const float* scales, int n_levels, const void* boxes,
                        const void* levels, const void* frames, void* out, int n_frames,
                        int m, int c, int oh, int ow, int ratio, int aligned, int dtype,
                        void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_frames < 1 || ratio <= 0 ||
      ratio > kMaxRatio || oh <= 0 || ow <= 0 || dtype < kFloat32 || dtype > kBFloat16)
    return cudaErrorInvalidValue;
  if (static_cast<long long>(m) * c == 0) return cudaSuccess;
  int max_w = 1;
  for (int l = 0; l < n_levels; ++l) max_w = ws[l] > max_w ? ws[l] : max_w;
  const LevelTable lv = make_table(feats, hs, ws, scales, n_levels);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat16:
      return launch<__half>(lv, max_w, boxes, levels, frames, n_frames, out, m, c, oh, ow,
                            ratio, aligned, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(lv, max_w, boxes, levels, frames, n_frames, out, m, c, oh,
                                   ow, ratio, aligned, s);
    default:
      return launch<float>(lv, max_w, boxes, levels, frames, n_frames, out, m, c, oh, ow,
                           ratio, aligned, s);
  }
}

}  // extern "C"
