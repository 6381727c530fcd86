// K2: multi-level ROIAlign (torchvision semantics) in one launch, with the
// sampling arithmetic in per-box tap tables in shared memory.
//
// Replaces the TPU kernel densepose_tpu/ops/pallas/roi_align_kernel.py::_kernel
// (reached through _pool_one_level from roi_align_multilevel_fused). Same
// function: each box pools from its assigned pyramid level with the
// `aligned` offset, the border rule (samples with y < -1 or y > H give 0),
// the edge rule (low >= H-1 clamps both taps to H-1 with lerp 0), a
// ratio x ratio sample grid per bin (or, at ratio 0, the adaptive
// min(ceil(bin), 8) samples per axis), 4 bilinear taps accumulated in fp32
// and a division by the sample count. The TPU kernel computed it as
// Wy @ feat @ Wx^T on the MXU; here each output is the sum of its taps, in
// the order of the JAX package's gather formulation
// (densepose_tpu/ops/roi_align.py:106-224): iy, ix, then v11, v12, v21, v22.
//
// Layout: the port's modules hold NCHW, so the kernel reads each level in
// place as a contiguous (C, H, W) map and writes (M, C, oh, ow), which is the
// box head's flatten order and the DensePose head's input.
//
// What bounds it on the card. Counted as the least work, bytes: each output
// is ~8 * ratio^2 operations on 4 * ratio^2 feature reads, most of them hits
// in L1 or L2. In the port's first design (one thread per output, a
// grid-stride loop over a 64-bit index) every output recomputed the box
// geometry, 6 axis samples with an IEEE division each, and four 64-bit
// div/mods of its index, ~400 instructions for 16 loads. Staging each box's
// footprint in shared memory (coalesced rows, taps read from the tile) was
// measured several times slower at these box sizes than the loads below.
//
// Design: one CTA per (box, slab of channels). The slab is sized so that a
// CTA has ~kTargetOutputs outputs (64 channels at 7x7, 6 at 28x28), which
// puts thousands of CTAs on the 132 SMs at both main-path sites (1000 boxes
// and 100 boxes). The CTA computes the box's geometry once and fills two
// tables in shared memory with axis_sample's exact roundings: oh x g entries
// (lo, hi, lerp, 1 - lerp, ok) for y, ow x g for x (28 + 28 entries at the box
// pooler, 56 + 56 at the DensePose pooler). Its threads then cover
// (c, oy, ox) with ox innermost, so a warp writes neighbouring outputs and
// its taps walk one feature row; each output reads its samples' entries,
// forms the four weight products and sums its taps. Index arithmetic is
// 32-bit: a thread decomposes its first index once and then steps (c, oy,
// ox) by the block size with carries, so no output pays a division. All
// levels are handled in one launch through a table of per-level base
// pointers and sizes; a box's level comes from `levels`.
//
// Batched frames: each level may hold N frames, (N, C, H, W) contiguous, and
// `frames` (M,) int32 names each box's frame, so one launch pools the boxes
// of every frame of a batch; the CTA of a box offsets its level's base by
// the per-frame stride times its frame, the stride being C * H * W. Without
// `frames` every box reads frame 0, which is the single-frame (C, H, W) call.
// A box whose frame is not in [0, N) gets zeros, as one whose level is not.
//
// No tensor cores, at any element type: the fp32 sum must match the plain
// version's bit for bit (and parity keeps TF32 off); the
// separable Wy @ feat @ Wx^T form multiplies mostly zeros at these box sizes
// (the TPU kernel's own docstring, roi_align_kernel.py:1-11; K3's plain
// version, which does that dense work, takes 21.28 ms at the box pooler); and
// the bound is in bytes, not operations.
//
// Numerics: built with --fmad=false and written with the _rn intrinsics, so
// it performs the same roundings as the plain PyTorch version, in the same
// order: the two are bit-identical.
//
// Element types (TPU.COMPUTE_DTYPE): the levels and the output are float,
// __half or __nv_bfloat16, one type a launch. Each tap is loaded as T and
// widened to float; the tables, weights and the sum stay float in the same
// order, and the output is rounded to T once. So K2<T>(f) is bit-identical
// to K2<float>(f.float()).to(T), and to the plain version at T, which
// upcasts its taps and rounds once at the end as the JAX package's gather
// does (densepose_tpu/ops/roi_align.py:213, :224). A half load is the design
// (the TPU kernel read the feature dtype too, roi_align_kernel.py:104): it
// halves the bytes the bound counts, and nothing upcasts the levels first.

#include <stdint.h>

#include "roi_align_common.cuh"

namespace {

using namespace roi_align_common;

constexpr int kTargetOutputs = 4096;  // outputs per CTA that size the channel slab
constexpr int kTableBytes = 48 * 1024;  // static limit of dynamic shared memory

// G > 0: the grid is G x G at compile time (ratio G), so a thread's tap
// loads are issued together; at ratio 2 this took 9% (box pooler) and 12%
// (DensePose pooler) off the time of G == 0 on an H100 SXM at 700 W, both
// timed in one run (PERF.md). G == 0: `ratio` at run time, or the adaptive
// count at ratio 0.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads) roi_align_kernel(
    LevelTable lv, const float* __restrict__ boxes, const int32_t* __restrict__ levels,
    const int32_t* __restrict__ frames, int n_frames, T* __restrict__ out, int c, int oh,
    int ow, int ratio, int slab, float offset, int aligned) {
  extern __shared__ AxisTap tables[];  // oh x gmax for y, then ow x gmax for x
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * slab;
  const int hw = oh * ow;
  const int n = min(slab, c - c0) * hw;
  T* o = out + (static_cast<size_t>(b) * c + c0) * hw;
  const int l = levels[b];
  const int fr = frames != nullptr ? frames[b] : 0;
  if (l < 0 || l >= lv.n || fr < 0 || fr >= n_frames) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) o[e] = narrow<T>(0.f);
    return;
  }
  const int h = lv.h[l], w = lv.w[l];
  float start_h, bin_h, start_w, bin_w;
  box_geometry(boxes + 4 * static_cast<size_t>(b), lv.scale[l], offset, aligned, oh, ow,
               start_h, bin_h, start_w, bin_w);
  const float ky = samples_per_bin(bin_h, ratio), kx = samples_per_bin(bin_w, ratio);
  const int gy = G > 0 ? G : static_cast<int>(ky), gx = G > 0 ? G : static_cast<int>(kx);
  const float count = ratio > 0 ? static_cast<float>(ratio * ratio)
                                : fmaxf(__fmul_rn(ky, kx), 1.f);
  AxisTap* ty = tables;
  AxisTap* tx = tables + oh * (ratio > 0 ? ratio : kAdaptiveCap);
  fill_axis_table(ty, start_h, bin_h, oh, gy, static_cast<float>(h));
  fill_axis_table(tx, start_w, bin_w, ow, gx, static_cast<float>(w));
  __syncthreads();

  // (ch, oy, ox) of this thread's first output, and the step of blockDim.x
  const int step = blockDim.x;
  const int dch = step / hw, dbin = step - dch * hw, doy = dbin / ow, dox = dbin - doy * ow;
  int e = threadIdx.x;
  int ch = e / hw, oy = (e - ch * hw) / ow;
  int ox = e - ch * hw - oy * ow;
  const size_t plane = static_cast<size_t>(h) * w;
  const T* f0 = static_cast<const T*>(lv.feat[l]) +
                (static_cast<size_t>(fr) * c + c0) * plane;
  for (; e < n; e += step) {
    const T* f = f0 + ch * plane;
    float acc = 0.f;
#pragma unroll
    for (int iy = 0; iy < gy; ++iy) {
      const AxisTap y = ty[oy * gy + iy];
      // Out-of-border samples weigh 0 in the reference, adding exact zeros.
      if (!y.ok) continue;
      const T* r0 = f + y.lo * w;
      const T* r1 = f + y.hi * w;
#pragma unroll
      for (int ix = 0; ix < gx; ++ix) {
        const AxisTap x = tx[ox * gx + ix];
        if (!x.ok) continue;
        const float v11 = load(r0 + x.lo);
        const float v12 = load(r0 + x.hi);
        const float v21 = load(r1 + x.lo);
        const float v22 = load(r1 + x.hi);
        acc = __fadd_rn(acc, __fmul_rn(v11, __fmul_rn(y.rlerp, x.rlerp)));
        acc = __fadd_rn(acc, __fmul_rn(v12, __fmul_rn(y.rlerp, x.lerp)));
        acc = __fadd_rn(acc, __fmul_rn(v21, __fmul_rn(y.lerp, x.rlerp)));
        acc = __fadd_rn(acc, __fmul_rn(v22, __fmul_rn(y.lerp, x.lerp)));
      }
    }
    o[e] = narrow<T>(__fdiv_rn(acc, count));
    ox += dox;
    oy += doy;
    ch += dch;
    if (ox >= ow) {
      ox -= ow;
      ++oy;
    }
    if (oy >= oh) {
      oy -= oh;
      ++ch;
    }
  }
}

template <typename T>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream, const LevelTable& lv,
                   const void* boxes, const void* levels, const void* frames, int n_frames,
                   void* out, int c, int oh, int ow, int ratio, int slab, int aligned) {
  auto kernel = ratio == 2 ? roi_align_kernel<T, 2> : roi_align_kernel<T, 0>;  // zoo: 2
  kernel<<<grid, kThreads, smem, stream>>>(
      lv, static_cast<const float*>(boxes), static_cast<const int32_t*>(levels),
      static_cast<const int32_t*>(frames), n_frames, static_cast<T*>(out), c, oh, ow, ratio,
      slab, aligned ? 0.5f : 0.f, aligned);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int dp_roi_align_max_levels() { return kMaxLevels; }

// Table entries (oh + ow) x samples per bin that one CTA's shared memory holds.
int dp_roi_align_max_table_entries() { return kTableBytes / sizeof(AxisTap); }

// feats: host array of n_levels device pointers to contiguous
// (n_frames, C, H, W) levels of the element type `dtype` (a DtypeCode); hs,
// ws, scales: host arrays per level. boxes (m, 4) f32, levels (m,) i32,
// frames (m,) i32 or null (every box on frame 0), out (m, c, oh, ow) of the
// levels' type, written. ratio 0 is the adaptive count. Returns the
// cudaError_t of the launch.
int dp_roi_align(const void* const* feats, const int* hs, const int* ws,
                 const float* scales, int n_levels, const void* boxes,
                 const void* levels, const void* frames, void* out, int n_frames, int m,
                 int c, int oh, int ow, int ratio, int aligned, int dtype, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_frames < 1 || ratio < 0 ||
      dtype < kFloat32 || dtype > kBFloat16)
    return cudaErrorInvalidValue;
  const int gmax = ratio > 0 ? ratio : kAdaptiveCap;
  const size_t smem = static_cast<size_t>(oh + ow) * gmax * sizeof(AxisTap);
  if (smem > kTableBytes) return cudaErrorInvalidValue;
  if (static_cast<long long>(m) * c * oh * ow == 0) return cudaSuccess;
  const long long per_box = static_cast<long long>(c) * oh * ow;
  const long long want = (per_box + kTargetOutputs - 1) / kTargetOutputs;
  const int n_slabs = static_cast<int>(want < c ? want : c);
  const int slab = (c + n_slabs - 1) / n_slabs;
  const dim3 grid(m, (c + slab - 1) / slab);
  const LevelTable lv = make_table(feats, hs, ws, scales, n_levels);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat16:
      return launch<__half>(grid, smem, s, lv, boxes, levels, frames, n_frames, out, c, oh,
                            ow, ratio, slab, aligned);
    case kBFloat16:
      return launch<__nv_bfloat16>(grid, smem, s, lv, boxes, levels, frames, n_frames, out,
                                   c, oh, ow, ratio, slab, aligned);
    default:
      return launch<float>(grid, smem, s, lv, boxes, levels, frames, n_frames, out, c, oh,
                           ow, ratio, slab, aligned);
  }
}

}  // extern "C"
