// K2: multi-level ROIAlign (torchvision semantics) in one launch.
//
// Replaces the TPU kernel densepose_tpu/ops/pallas/roi_align_kernel.py::_kernel
// (reached through _pool_one_level from roi_align_multilevel_fused). Same
// function: each box pools from its assigned pyramid level with the
// `aligned` offset, the border rule (samples with y < -1 or y > H give 0),
// the edge rule (low >= H-1 clamps both taps to H-1 with lerp 0), a fixed
// ratio x ratio sample grid per bin, 4 bilinear taps accumulated in fp32 and
// a division by ratio^2. The TPU kernel computed it as Wy @ feat @ Wx^T on
// the MXU; here each output is the sum of its taps, in the order of the JAX
// package's gather formulation (densepose_tpu/ops/roi_align.py:106-224).
//
// Layout: the port's modules hold NCHW, so the kernel reads each level in
// place as a contiguous (C, H, W) map and writes (M, C, oh, ow), which is the
// box head's flatten order and the DensePose head's input.
//
// What bounds it on the card: bytes. Per output element it does about
// 8 * ratio^2 operations on 4 * ratio^2 feature reads, so it is a gather.
// Design: one thread per output element (box, c, oy, ox) with ox innermost,
// so a warp writes 32 neighbouring outputs and its taps walk one feature row
// along W (neighbouring bins sample neighbouring columns). All levels are
// handled in one launch through a table of per-level base pointers and
// sizes; a box's level comes from `levels`. Taps of neighbouring bins and
// boxes hit the same lines, which L2 (50 MB) keeps. The kernel allocates
// nothing. Later work (tensor-core separable form, shared-memory tap reuse)
// is left to a PR that measures it.
//
// Numerics: built with --fmad=false and written with the _rn intrinsics, so
// it performs the same roundings as the plain PyTorch version.

#include <stdint.h>

#include "roi_align_common.cuh"

namespace {

using namespace roi_align_common;

__global__ void __launch_bounds__(kThreads) roi_align_kernel(
    LevelTable lv, const float* __restrict__ boxes,
    const int32_t* __restrict__ levels, float* __restrict__ out, int m, int c,
    int oh, int ow, int g, float offset, int aligned) {
  const long long total = static_cast<long long>(m) * oh * ow * c;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int ox = static_cast<int>(idx % ow);
    long long t = idx / ow;
    const int oy = static_cast<int>(t % oh);
    t /= oh;
    const int ch = static_cast<int>(t % c);
    const int b = static_cast<int>(t / c);

    const int l = levels[b];
    if (l < 0 || l >= lv.n) {
      out[idx] = 0.f;
      continue;
    }
    const int h = lv.h[l], w = lv.w[l];
    const float* f = lv.feat[l] + static_cast<size_t>(ch) * h * w;
    float start_h, bin_h, start_w, bin_w;
    box_geometry(boxes + 4 * static_cast<long long>(b), lv.scale[l], offset, aligned, oh, ow,
                 start_h, bin_h, start_w, bin_w);

    float acc = 0.f;
    for (int iy = 0; iy < g; ++iy) {
      int ylo, yhi;
      float ly;
      bool oky;
      axis_sample(start_h, bin_h, oy, iy, g, static_cast<float>(h), ylo, yhi, ly, oky);
      for (int ix = 0; ix < g; ++ix) {
        int xlo, xhi;
        float lx;
        bool okx;
        axis_sample(start_w, bin_w, ox, ix, g, static_cast<float>(w), xlo, xhi, lx, okx);
        // Out-of-border samples weigh 0 in the reference, adding exact zeros.
        if (!(oky && okx)) continue;
        const float hy = __fsub_rn(1.f, ly), hx = __fsub_rn(1.f, lx);
        const size_t r0 = static_cast<size_t>(ylo) * w, r1 = static_cast<size_t>(yhi) * w;
        const float v11 = f[r0 + xlo];
        const float v12 = f[r0 + xhi];
        const float v21 = f[r1 + xlo];
        const float v22 = f[r1 + xhi];
        acc = __fadd_rn(acc, __fmul_rn(v11, __fmul_rn(hy, hx)));
        acc = __fadd_rn(acc, __fmul_rn(v12, __fmul_rn(hy, lx)));
        acc = __fadd_rn(acc, __fmul_rn(v21, __fmul_rn(ly, hx)));
        acc = __fadd_rn(acc, __fmul_rn(v22, __fmul_rn(ly, lx)));
      }
    }
    out[idx] = __fdiv_rn(acc, static_cast<float>(g * g));
  }
}

}  // namespace

extern "C" {

int dp_roi_align_max_levels() { return kMaxLevels; }

// feats: host array of n_levels device pointers to contiguous (C, H, W) f32
// levels; hs, ws, scales: host arrays per level. boxes (m, 4) f32, levels
// (m,) i32, out (m, c, oh, ow) f32, written. Returns the cudaError_t of the launch.
int dp_roi_align(const void* const* feats, const int* hs, const int* ws,
                 const float* scales, int n_levels, const void* boxes,
                 const void* levels, void* out, int m, int c, int oh, int ow,
                 int ratio, int aligned, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || ratio <= 0) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(m) * oh * ow * c;
  if (total == 0) return cudaSuccess;
  roi_align_kernel<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_table(feats, hs, ws, scales, n_levels), static_cast<const float*>(boxes),
      static_cast<const int32_t*>(levels),
      static_cast<float*>(out), m, c, oh, ow, ratio, aligned ? 0.5f : 0.f, aligned);
  return cudaGetLastError();
}

}  // extern "C"
