// K1: exact greedy NMS over score-sorted boxes, as an IoU bit-matrix and a
// one-warp scan.
//
// Replaces the TPU kernel densepose_tpu/ops/pallas/nms_kernel.py::_nms_kernel
// (reached through nms_keep_pallas). Same function: keep = valid &
// ~suppressed; IoU with (x2-x1)*(y2-y1) areas, a union > 0 guard and a
// strict '>' threshold; optional class ids restrict suppression to boxes of
// the same class. Greedy keep is "valid, and not suppressed by any earlier
// kept box", which this file computes in two launches.
//
// What bounds it on the card: neither bytes (18 per box) nor operations
// (about 13 per box pair) but the serial dependency of greedy NMS: step i
// needs the final keep flag of box i, which any earlier kept box may clear.
// The TPU kernel walked the pivots with the whole problem in one core's
// memory; carried over as one CTA per problem, that used 5 of 132 SMs at the
// RPN and paid one CTA barrier per kept pivot. Design:
//
// 1. nms_mask_kernel computes every IoU test at once. Grid (column block,
//    row block, problem), blocks of 64; only blocks with column block >= row
//    block work (~5 x 16 x 17 / 2 = 680 CTAs at the RPN). A CTA stages its
//    64 column boxes in shared memory; 4 threads own a row i, 16 columns
//    each, and together write one 64-bit word: bit j is set iff column j > i,
//    the classes match and IoU(i, j) > thr. Rows of invalid boxes are not
//    written: the scan never reads them.
// 2. nms_scan_kernel walks the score order with one warp per problem. The
//    `removed` bit set (initially ~valid) lives in the lanes' registers: lane
//    l holds words l, l + 32, ... Box i is kept iff its bit is 0. The rows
//    are staged into shared memory ahead of the walk in blocks of `rows`
//    (which divides 64), double buffered, each block by one bulk copy
//    (cp.async.bulk, completing on an mbarrier), so the serial chain never
//    waits on L2: per-lane 8-byte cp.async copies keep too few bytes in
//    flight for one warp, and took most of the scan's time. Per block, the
//    lane that owns the block's word walks its rows against that word alone
//    (a kept row ORs its diagonal word in), and broadcasts the rows' keep
//    bits with __shfl_sync; every lane then ORs the kept rows' later words
//    into its own. So the serial chain is a test and a masked OR per box in
//    one lane's registers, with no shuffle and no CTA barrier. keep is
//    ~removed at the end: a bit i is final once step i has read it, since
//    row i only sets bits after i.
//
// Numerics: the IoU is written with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn
// and the file is built with --fmad=false, so no product is contracted into
// an FMA. Row i is the earlier (pivot) box and column j the later one, with
// the operand order of the plain PyTorch version's tests, so the bits are
// the same tests and keep masks are exact at the 0.7 and 0.5 thresholds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;                             // boxes per mask word
constexpr int kSplit = 4;                              // mask threads per row
constexpr int kWordsPerLane = 8;                       // scan registers per lane
constexpr int kMaxWords = 32 * kWordsPerLane;
constexpr int kMaxBoxes = kMaxWords * kBlock;          // 16384 per problem
constexpr int kMaxProblems = 65535;                    // gridDim.z
constexpr int kScanSmem = 48 * 1024;                   // no opt-in attribute needed
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kBlock * kSplit) nms_mask_kernel(
    const float* __restrict__ boxes, const bool* __restrict__ valid,
    const int32_t* __restrict__ classes, unsigned long long* __restrict__ mask, int k,
    int ld, float thr) {
  const int cb = blockIdx.x, rb = blockIdx.y;
  if (cb < rb) return;
  __shared__ float sx1[kBlock], sy1[kBlock], sx2[kBlock], sy2[kBlock], sarea[kBlock];
  __shared__ int32_t scls[kBlock];
  __shared__ unsigned long long part[kSplit][kBlock];
  const size_t base = static_cast<size_t>(blockIdx.z) * k;
  const int t = threadIdx.x;
  if (t < kBlock) {
    const int col = cb * kBlock + t;
    if (col < k) {
      const float* b = boxes + (base + col) * 4;
      sx1[t] = b[0];
      sy1[t] = b[1];
      sx2[t] = b[2];
      sy2[t] = b[3];
      sarea[t] = __fmul_rn(__fsub_rn(b[2], b[0]), __fsub_rn(b[3], b[1]));
      scls[t] = classes ? classes[base + col] : 0;
    } else {  // past k: finite values, whose bits are masked off below
      sx1[t] = sy1[t] = sx2[t] = sy2[t] = sarea[t] = 0.f;
      scls[t] = 0;
    }
  }
  __syncthreads();
  // Row r of the block, columns [q * 16, q * 16 + 16): kSplit threads per row,
  // so that each SM holds enough warps to overlap the divisions' latency.
  const int r = t % kBlock, q = t / kBlock;
  const int row = rb * kBlock + r;
  const bool live = row < k && valid[base + row];
  unsigned long long bits = 0;
  if (live) {
    const float* b = boxes + (base + row) * 4;
    const float ix1 = b[0], iy1 = b[1], ix2 = b[2], iy2 = b[3];
    const float ia = __fmul_rn(__fsub_rn(ix2, ix1), __fsub_rn(iy2, iy1));
    const int32_t ic = classes ? classes[base + row] : 0;
    const int first = cb == rb ? r + 1 : 0;
    const int n_cols = min(kBlock, k - cb * kBlock);
    // Unrolled and without branches, so that the tests (and their
    // divisions) of different columns overlap.
#pragma unroll
    for (int jj = 0; jj < kBlock / kSplit; ++jj) {
      const int j = q * (kBlock / kSplit) + jj;
      const float iw = fmaxf(__fsub_rn(fminf(sx2[j], ix2), fmaxf(sx1[j], ix1)), 0.f);
      const float ih = fmaxf(__fsub_rn(fminf(sy2[j], iy2), fmaxf(sy1[j], iy1)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(sarea[j], ia), inter);
      const float iou = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
      const bool hit = j >= first && j < n_cols && scls[j] == ic && iou > thr;
      bits |= static_cast<unsigned long long>(hit) << j;
    }
  }
  part[q][r] = bits;
  __syncthreads();
  if (q == 0 && live) {
    unsigned long long word = 0;
#pragma unroll
    for (int p = 0; p < kSplit; ++p) word |= part[p][r];
    mask[(base + row) * ld + cb] = word;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// One bulk copy (the Tensor Memory Accelerator's 1-D form) of `bytes`, a
// multiple of 16 at 16-byte aligned addresses, whose arrival completes the
// current phase of `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :
      : "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// All ones if `on`, else 0.
__device__ __forceinline__ unsigned long long ones_if(bool on) {
  return 0ull - static_cast<unsigned long long>(on);
}

// Word `slot` of this lane's registers. A runtime index, or a select between
// loads that the compiler may fold into one, would move the array to local
// memory; masks keep every access at a constant index.
__device__ __forceinline__ unsigned long long pick(const unsigned long long (&rem)[kWordsPerLane],
                                                   int slot) {
  unsigned long long v = 0;
#pragma unroll
  for (int s = 0; s < kWordsPerLane; ++s) v |= rem[s] & ones_if(s == slot);
  return v;
}

__global__ void __launch_bounds__(32) nms_scan_kernel(
    const unsigned long long* __restrict__ mask, const bool* __restrict__ valid,
    bool* __restrict__ keep, int k, int n_words, int ld, int rows) {
  extern __shared__ __align__(16) unsigned long long stage[];  // 2 x rows x ld
  __shared__ __align__(8) unsigned long long bars[2];
  const int lane = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  const unsigned long long* m = mask + base * ld;
  const int n_stages = (k + rows - 1) / rows;
  // Stage st holds rows [st * rows, ...) whole, in buffer st & 1.
  auto fetch = [&](int st) {
    const int r0 = st * rows;
    bulk_copy(stage + (st & 1) * rows * ld, m + static_cast<size_t>(r0) * ld,
              min(rows, k - r0) * ld * 8, &bars[st & 1]);
  };
  if (lane == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fetch(0);
  }
  __syncwarp();

  // removed = ~valid, 32 boxes per ballot; bits at or past k stay set
  unsigned long long rem[kWordsPerLane];
#pragma unroll
  for (int s = 0; s < kWordsPerLane; ++s) rem[s] = 0;
#pragma unroll 16  // the flag loads of 16 ballots in flight
  for (int c = 0; c * 32 < k; ++c) {
    const int i = c * 32 + lane;
    const unsigned gone = __ballot_sync(kFull, i >= k || !valid[base + i]);
    const int word = c >> 1;
    const unsigned long long bits = static_cast<unsigned long long>(gone) << ((c & 1) * 32);
#pragma unroll
    for (int s = 0; s < kWordsPerLane; ++s) rem[s] |= bits & ones_if(word == s * 32 + lane);
  }

  for (int st = 0; st < n_stages; ++st) {
    // The buffer of stage st + 1 was last read at stage st - 1.
    if (lane == 0 && st + 1 < n_stages) fetch(st + 1);
    mbar_wait(&bars[st & 1], (st >> 1) & 1);
    const unsigned long long* buf = stage + (st & 1) * rows * ld;
    const int r0 = st * rows;
    const int nr = min(rows, k - r0);
    const int word = r0 / kBlock, owner = word & 31, slot = word >> 5, b0 = r0 % kBlock;
    // (1) The owner of the block's word walks its rows against that word
    //     alone: row r is kept iff its bit is still 0, and then removes the
    //     later boxes of the word that it suppresses.
    //     (32-bit halves with predicated ORs, and loads 8 rows ahead, were
    //     measured no faster than this chain.)
    unsigned long long kept = 0;
    if (lane == owner) {
      unsigned long long cur = pick(rem, slot);
#pragma unroll 8
      for (int r = 0; r < nr; ++r) {
        const bool live = !((cur >> (b0 + r)) & 1ull);
        cur |= buf[r * ld + word] & ones_if(live);
        kept |= static_cast<unsigned long long>(live) << r;
      }
#pragma unroll
      for (int s = 0; s < kWordsPerLane; ++s)
        rem[s] = (rem[s] & ~ones_if(s == slot)) | (cur & ones_if(s == slot));
    }
    // (2) Its keep bits go to every lane, and each lane ORs the kept rows'
    //     words after `word` into its own words. Branch-free: a guarded load
    //     per row and word diverges the warp, several times slower; here each
    //     active slot runs a loop of independent loads from a safe word,
    //     masked by the row's keep bit.
    kept = (static_cast<unsigned long long>(__shfl_sync(kFull, static_cast<unsigned>(kept >> 32),
                                                        owner)) << 32) |
           __shfl_sync(kFull, static_cast<unsigned>(kept), owner);
#pragma unroll
    for (int s = 0; s < kWordsPerLane; ++s) {
      if (s * 32 >= n_words || !kept) break;  // uniform across the warp
      const int w = s * 32 + lane;
      const bool mine = w > word && w < n_words;
      const unsigned long long* col = buf + (mine ? w : word);
      unsigned long long acc = 0;
#pragma unroll 8
      for (int r = 0; r < nr; ++r) acc |= col[r * ld] & ones_if((kept >> r) & 1ull);
      rem[s] |= acc & ones_if(mine);
    }
    __syncwarp();  // the buffer is refilled at the next stage
  }

  for (int c = 0; c * 32 < k; ++c) {
    const int word = c >> 1;
    const unsigned half = static_cast<unsigned>(pick(rem, word >> 5) >> ((c & 1) * 32));
    const unsigned gone = __shfl_sync(kFull, half, word & 31);
    const int i = c * 32 + lane;
    if (i < k) keep[base + i] = !((gone >> lane) & 1u);
  }
}

// Words per mask row in memory: n_words rounded up to even, so that rows and
// blocks of rows are 16-byte aligned for the bulk copy.
int row_stride(int k) { return ((k + kBlock - 1) / kBlock + 1) & ~1; }

// Rows per scan stage: the most of 64, 32, 16, 8 whose two buffers fit.
int scan_rows(int ld) {
  int rows = kBlock;
  while (rows > 8 && 2 * rows * ld * 8 > kScanSmem) rows /= 2;
  return rows;
}

}  // namespace

extern "C" {

int dp_nms_max_boxes() { return kMaxBoxes; }
int dp_nms_max_problems() { return kMaxProblems; }

// 64-bit words per row of the mask in memory (ceil(k / 64), rounded up to even).
int dp_nms_mask_stride(int k) { return row_stride(k); }

// boxes (problems, k, 4) f32 score-sorted; valid (problems, k) bool;
// classes (problems, k) i32 or null; mask (problems, k, dp_nms_mask_stride(k))
// 64-bit words, written for the rows of valid boxes. Returns the cudaError_t.
int dp_nms_mask(const void* boxes, const void* valid, const void* classes, void* mask,
                int problems, int k, float thr, void* stream) {
  if (k < 1 || k > kMaxBoxes || problems < 1 || problems > kMaxProblems)
    return cudaErrorInvalidValue;
  const int n_words = (k + kBlock - 1) / kBlock;
  const dim3 grid(n_words, n_words, problems);
  nms_mask_kernel<<<grid, kBlock * kSplit, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const bool*>(valid),
      static_cast<const int32_t*>(classes), static_cast<unsigned long long*>(mask), k,
      row_stride(k), thr);
  return cudaGetLastError();
}

// mask from dp_nms_mask; valid (problems, k) bool; keep (problems, k) bool,
// written. Returns the cudaError_t.
int dp_nms_scan(const void* mask, const void* valid, void* keep, int problems, int k,
                void* stream) {
  if (k < 1 || k > kMaxBoxes || problems < 1) return cudaErrorInvalidValue;
  const int ld = row_stride(k);
  const int rows = scan_rows(ld);
  const size_t smem = static_cast<size_t>(2) * rows * ld * sizeof(unsigned long long);
  nms_scan_kernel<<<problems, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(mask), static_cast<const bool*>(valid),
      static_cast<bool*>(keep), k, (k + kBlock - 1) / kBlock, ld, rows);
  return cudaGetLastError();
}

}  // extern "C"
