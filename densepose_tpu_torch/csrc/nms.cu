// K1: exact greedy NMS over score-sorted boxes, one CTA per NMS problem.
//
// Replaces the TPU kernel densepose_tpu/ops/pallas/nms_kernel.py::_nms_kernel
// (reached through nms_keep_pallas). Same function: keep = valid &
// ~suppressed; IoU with (x2-x1)*(y2-y1) areas, a union > 0 guard and a
// strict '>' threshold; optional class ids restrict suppression to boxes of
// the same class.
//
// What bounds it on the card: neither bytes (18 per box) nor operations
// (about 13 per box pair) but the serial dependency of greedy NMS: step i
// needs the final keep flag of box i, which any earlier kept box may clear.
// Design: one CTA per problem, so the 5 RPN levels run as 5 CTAs of one
// launch. The boxes, their areas, classes and live flags sit in shared
// memory (25 bytes per box). The CTA walks the score order; for a live pivot
// every thread tests its stripe of later boxes, then one barrier. A pivot
// that is already suppressed costs no barrier, because nothing is written
// for it, so the number of barriers is the number of kept boxes.
//
// Numerics: the IoU is written with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn
// and the file is built with --fmad=false, so no product is contracted into
// an FMA. The IoU is then bit-identical to the plain PyTorch version and to
// the JAX package's fixed point, which keeps keep masks exact for IoUs at
// the 0.7 and 0.5 thresholds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) nms_keep_kernel(
    const float* __restrict__ boxes, const bool* __restrict__ valid,
    const int32_t* __restrict__ classes, bool* __restrict__ keep, int k,
    float thr) {
  extern __shared__ float smem[];
  float* sx1 = smem;
  float* sy1 = sx1 + k;
  float* sx2 = sy1 + k;
  float* sy2 = sx2 + k;
  float* sarea = sy2 + k;
  int32_t* scls = reinterpret_cast<int32_t*>(sarea + k);
  unsigned char* live = reinterpret_cast<unsigned char*>(scls + k);

  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float* b = boxes + (base + j) * 4;
    const float x1 = b[0], y1 = b[1], x2 = b[2], y2 = b[3];
    sx1[j] = x1;
    sy1[j] = y1;
    sx2[j] = x2;
    sy2[j] = y2;
    sarea[j] = __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
    scls[j] = classes ? classes[base + j] : 0;
    live[j] = valid[base + j] ? 1 : 0;
  }
  __syncthreads();

  for (int i = 0; i < k; ++i) {
    // Uniform across the CTA: live[i] was last written before a barrier,
    // and the writes of the current live pivot only touch j > i.
    if (!live[i]) continue;
    const float ix1 = sx1[i], iy1 = sy1[i], ix2 = sx2[i], iy2 = sy2[i];
    const float ia = sarea[i];
    const int32_t ic = scls[i];
    for (int j = i + 1 + threadIdx.x; j < k; j += blockDim.x) {
      if (!live[j] || scls[j] != ic) continue;
      const float iw = fmaxf(__fsub_rn(fminf(sx2[j], ix2), fmaxf(sx1[j], ix1)), 0.f);
      const float ih = fmaxf(__fsub_rn(fminf(sy2[j], iy2), fmaxf(sy1[j], iy1)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(sarea[j], ia), inter);
      const float iou = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
      if (iou > thr) live[j] = 0;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x) keep[base + j] = live[j] != 0;
}

}  // namespace

extern "C" {

// Shared memory per box: 5 floats, one int32 class, one live byte.
int dp_nms_smem_per_box() { return 5 * sizeof(float) + sizeof(int32_t) + 1; }

// boxes (problems, k, 4) f32 score-sorted; valid (problems, k) bool;
// classes (problems, k) i32 or null; keep (problems, k) bool, written.
// Returns the cudaError_t of the launch.
int dp_nms_keep(const void* boxes, const void* valid, const void* classes,
                void* keep, int problems, int k, float thr, void* stream) {
  const size_t smem = static_cast<size_t>(k) * dp_nms_smem_per_box();
  cudaError_t err = cudaFuncSetAttribute(
      nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  nms_keep_kernel<<<problems, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const bool*>(valid),
      static_cast<const int32_t*>(classes), static_cast<bool*>(keep), k, thr);
  return cudaGetLastError();
}

}  // extern "C"
