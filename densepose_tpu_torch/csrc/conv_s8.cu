// Q1: s8 x s8 -> s32 implicit-GEMM convolution with the fused integer
// epilogue of the int8 serving mode, for Hopper's int8 tensor cores.
//
// Port-only: no TPU kernel is replaced. The JAX package leaves its int8
// convolutions to XLA (densepose_tpu/ops/conv.py::conv2d_int8_chain, :273,
// and ::conv_transpose2d_int8_chain, :316, lax.conv_general_dilated with
// preferred_element_type=int32), and PyTorch has no int8 convolution on the
// card, so the port needs its own.
//
// The GEMM: M = N * Ho * Wo output pixels, N = Cout, K = kh * kw * Cin.
// Activations are s8 NHWC, so Cin is the contiguous K axis of a tap; weights
// are s8 (Cout, kh, kw, Cin). Sums are int32 and exact. Stride, padding and
// dilation are conv2d_int8_chain's. The transposed convolution (the chart
// predictor's 4x4 / stride 2 deconvolutions) is a gather: the output is cut
// into its stride x stride parity classes, and in class (py, px) only the taps
// with ky = py + pad (mod stride) meet an input pixel, at input row
// oy / stride + (py + pad - ky) / stride. Each class is a stride-1
// convolution over the input whose outputs land on every stride-th row and
// column. The holes of the input-dilated form the JAX package lowers (3/4 of
// its K at stride 2) are never visited. The weights of a transposed
// convolution are in ConvTranspose2d's tap order (not the flipped
// forward-conv form).
//
// The epilogue, per output channel, in this order (with --fmad=false and the
// _rn intrinsics it rounds as the plain version does):
//   1. acc += qb[co] (the bias pre-quantized to int32 counts), if given;
//   2. acc = max(acc, 0) if relu;
//   3. out_kind 0: acc as int32 (a check of the sums);
//      1: s8 out, clamp(rint(float(acc) * m[co]), -127, 127);
//      2, 3, 4: float(acc) * scale[co] as f32, or that rounded once to f16 /
//      bf16.
// `vec` is m[] (kind 1) or scale[] = sx * wscale (kinds 2-4); both, and qb,
// are device vectors made once when the scales are installed.
//
// What bounds it on the card: at the DensePose head's links (M = 78400,
// N = 512, K = 4608 at 100 detections) the operations, 2MNK / 1979 TOP/s;
// at the 1x1 backbone links with Cin 64..256 the bytes. Two variants serve
// it, chosen before the launch by a fixed rule on the shape
// (ops/conv_int8.py::q1_variant); the C entry checks the chosen variant's
// preconditions and returns cudaErrorInvalidValue if they are broken.
//
// Variant "wgmma" (the Hopper design; every site whose Cin is a multiple of
// 16). What held the first design back was its instruction family: mma.sync
// reads its operands from registers, so each k step waited on ldmatrix
// fragment loads, and every thread computed the gather's addresses, bounds
// and zero-fill sizes for its cp.async copies in the issue slots the
// products needed (19% of the int8 peak at a head link). Here a CTA of three
// warpgroups computes a 128 x BN tile of the output: one producer warp keeps
// TMA loads in flight into a ring of stages in dynamic shared memory, each
// stage signalled by an mbarrier that counts its bytes, and two consumer
// warpgroups (setmaxnreg hands them the producer's registers) each run
// wgmma.mma_async m64nBNk32 s32.s8.s8 with both operands read from shared
// memory through descriptors, accumulating 64 x BN int32 sums in registers.
// The activations arrive through an im2col tensor map: K is walked tap by
// tap in chunks of BK channels, and a tap is the same 128-pixel load at its
// own offset (ky * dil, kx * dil) in the instruction, so a 3x3 conv is nine
// loads of one M tile. The box's corners are the padding; the image's
// edges, the padding, the channel tail of a tap and the M tail are
// zero-filled by the hardware. The traversal stride is the conv's stride. A
// transposed convolution's parity class uses a box whose lower corner is
// the least input offset of any class's taps, stride 1, and its taps'
// offsets from that corner. The weights arrive through a tiled map over
// (Cin, kh * kw, Cout), whose zero fill covers the channel and Cout tails.
// Tiles: BK = 128 channels (128-byte swizzle) when Cin > 64, else 64
// (64-byte swizzle); BN = 256 for Cout > 128 (the head's 512 channels: two
// N tiles, so the 128 x 256 tile reads each A byte once per 256 outputs),
// 128 for Cout > 80, 80 for Cout > 64 (the 77-channel deconvolution: the
// weight load zero-fills its tail) and 64 below. The ring holds as many
// stages as fit in 192 KB, at most 8 (4 at 128 x 256 x 128). The consumers
// keep one wgmma group in flight and free a stage when its group is done.
// One CTA per output tile, N tiles fastest, so the CTAs that share an M
// tile run together and read its pixels from L2. The epilogue stages the
// output tile in the drained ring (each thread converts its sums, with the
// tile's bias and factors copied to shared memory once) and then writes
// whole rows of it with 16-byte stores where the output's pitch allows:
// written from the accumulators one element at a time, it took longer
// than the main loop (PERF.md section 6). At a head link the main loop
// runs near the int8 peak's time for the tile; the fill and the epilogue,
// which no other tile's loads overlap, are the rest. Sharing B tiles
// across a 2-CTA cluster by TMA multicast was slower: L2 bandwidth does
// not bound it.
//
// Variant "mma_sync" (the first design, kept for the shapes TMA cannot
// describe: a global stride must be a multiple of 16 bytes, so Cin 40 and
// 600, and any Cin not a multiple of 16). A CTA computes a 128 x (64, 128
// or 256) tile of the output, the narrowest that covers Cout well, with 8
// warps, each a 64 x (16, 32 or 64) sub-tile through
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32. K is walked tap by tap in
// chunks of 64 channels; each chunk's A (128 pixels x 64 bytes) and B (output
// channels x 64 bytes) tiles are filled by cp.async into a 3-stage ring in
// dynamic shared memory, and the warps read their fragments with
// ldmatrix.x4, double-buffered: the next 32-byte k step's loads issue before
// this step's products, and a stage's barrier sits between its two k steps.
// Out-of-image taps, the channel tail of a tap and the M and Cout tails are
// zero-filled by the copies' source size 0. A copy moves CH = 16, 8 or 4
// bytes, the largest that divides Cin. Rows in shared memory are padded to
// 80 bytes, so each 8-row phase of an ldmatrix hits 32 different banks.
//
// The driver's tensor-map encoders are reached through
// cudaGetDriverEntryPoint, so the library needs no -lcuda. Times of both
// variants: PERF.md section 6.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum OutKind { kS32 = 0, kS8 = 1, kF32 = 2, kF16 = 3, kBF16 = 4 };
enum Variant { kMmaSync = 0, kWgmma = 1 };
constexpr int kMaxTaps = 64;  // kh * kw a launch, at most

struct Geometry {
  int n, h, w, cin;        // input, NHWC
  int ho, wo, cout;        // output, NHWC
  int kh, kw;
  int sh, sw, ph, pw, dh, dw;
  int transposed;          // 1: ConvTranspose2d (stride sh, padding ph) as a gather
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The parity class's output rows / columns: pixel j of the class is output
// row py + stride * j. A forward convolution has one class, (0, 0), stride 1.
struct ClassGrid {
  int py, px, step_y, step_x, hc, wc;
};

__device__ __forceinline__ ClassGrid class_grid(const Geometry& g) {
  ClassGrid c;
  if (g.transposed) {
    c.py = blockIdx.z / g.sw;
    c.px = blockIdx.z % g.sw;
    c.step_y = g.sh;
    c.step_x = g.sw;
    c.hc = (g.ho - c.py + g.sh - 1) / g.sh;
    c.wc = (g.wo - c.px + g.sw - 1) / g.sw;
  } else {
    c.py = c.px = 0;
    c.step_y = c.step_x = 1;
    c.hc = g.ho;
    c.wc = g.wo;
  }
  return c;
}

// the output pixel (flat over N, Ho, Wo) of class pixel m (flat over the class grid)
__device__ __forceinline__ long long out_pixel(const Geometry& g, const ClassGrid& cg, int m) {
  const int i = m % cg.wc;
  const int j = (m / cg.wc) % cg.hc;
  const int n = m / (cg.wc * cg.hc);
  return (static_cast<long long>(n) * g.ho + cg.py + cg.step_y * j) * g.wo + cg.px +
         cg.step_x * i;
}

// The epilogue's conversions: a sum (after bias and ReLU) to the output
// kind's type, with vec[co] as the per-channel factor
template <int K> struct Out;
template <> struct Out<kS32> { using T = int; };
template <> struct Out<kS8> { using T = int8_t; };
template <> struct Out<kF32> { using T = float; };
template <> struct Out<kF16> { using T = __half; };
template <> struct Out<kBF16> { using T = __nv_bfloat16; };

template <int K>
__device__ __forceinline__ typename Out<K>::T convert(int a, float v) {
  if constexpr (K == kS32) {
    return a;
  } else {
    const float y = __fmul_rn(__int2float_rn(a), v);
    if constexpr (K == kS8) {
      const int q = __float2int_rn(y);  // round half to even, as torch.round
      return static_cast<int8_t>(min(max(q, -127), 127));
    } else if constexpr (K == kF32) {
      return y;
    } else if constexpr (K == kF16) {
      return __float2half_rn(y);
    } else {
      return __float2bfloat16_rn(y);
    }
  }
}

// the epilogue of one sum: bias, ReLU, then the output kind's conversion
__device__ __forceinline__ void store_out(int a, int co, long long o, const int* __restrict__ qb,
                                          const float* __restrict__ vec, void* __restrict__ out,
                                          int relu, int out_kind) {
  if (qb != nullptr) a += qb[co];
  if (relu) a = max(a, 0);
  switch (out_kind) {
    case kS32:
      static_cast<int*>(out)[o] = convert<kS32>(a, 0.f);
      break;
    case kS8:
      static_cast<int8_t*>(out)[o] = convert<kS8>(a, vec[co]);
      break;
    case kF32:
      static_cast<float*>(out)[o] = convert<kF32>(a, vec[co]);
      break;
    case kF16:
      static_cast<__half*>(out)[o] = convert<kF16>(a, vec[co]);
      break;
    default:
      static_cast<__nv_bfloat16*>(out)[o] = convert<kBF16>(a, vec[co]);
      break;
  }
}

// ---------------------------------------------------------------------------
// variant "mma_sync"
// ---------------------------------------------------------------------------

constexpr int kBM = 128;      // output pixels a CTA: 2 warps along M, 64 rows each
constexpr int kBK = 64;       // bytes of K a stage (channels of one tap)
constexpr int kLd = kBK + 16; // padded row stride in shared memory, bytes
constexpr int kStages = 3;
constexpr int kThreads = 256; // 8 warps: 2 along M x 4 along N

// shared memory of a CTA whose warps hold NT n8 tiles each: the ring of A
// (kBM rows) and B (32 * NT rows) tiles
template <int NT>
constexpr int smem_bytes() {
  return kStages * (kBM + 32 * NT) * kLd;
}

template <int CH>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const int n = valid ? CH : 0;  // source size 0: the CH bytes are zero-filled
  if constexpr (CH == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(CH), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 16-byte matrices from shared memory, one row address a lane
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// CH: bytes a cp.async moves (16, 8 or 4: the largest dividing Cin). NT: n8
// tiles a warp holds (2, 4 or 8), so the CTA tile is 128 x 32 * NT.
template <int CH, int NT>
__global__ void __launch_bounds__(kThreads, 1) conv_s8_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, const int* __restrict__ qb,
    const float* __restrict__ vec, void* __restrict__ out, Geometry g, int relu, int out_kind) {
  constexpr int kBN = 32 * NT;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* const sa = smem;                          // [kStages][kBM * kLd]
  int8_t* const sb = smem + kStages * kBM * kLd;    // [kStages][kBN * kLd]
  __shared__ int tap_dy[kMaxTaps], tap_dx[kMaxTaps], tap_w[kMaxTaps];
  __shared__ int n_taps;

  const ClassGrid cg = class_grid(g);
  const int m_total = g.n * cg.hc * cg.wc;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;

  // the class's taps: input row = base row + dy, column = base column + dx
  if (tid == 0) {
    int t = 0;
    for (int ky = 0; ky < g.kh; ++ky) {
      for (int kx = 0; kx < g.kw; ++kx) {
        if (g.transposed) {
          const int ry = cg.py + g.ph - ky, rx = cg.px + g.pw - kx;
          // a tap meets an input pixel only where the division is exact
          if (((ry % g.sh) + g.sh) % g.sh != 0 || ((rx % g.sw) + g.sw) % g.sw != 0) continue;
          tap_dy[t] = ry / g.sh;  // exact
          tap_dx[t] = rx / g.sw;
        } else {
          tap_dy[t] = ky * g.dh;
          tap_dx[t] = kx * g.dw;
        }
        tap_w[t] = ky * g.kw + kx;
        ++t;
      }
    }
    n_taps = t;
  }
  __syncthreads();

  // loaders: kBK / CH copies a row, kThreads / that rows a pass
  constexpr int kCpr = kBK / CH;
  constexpr int kRowsPerPass = kThreads / kCpr;
  constexpr int kPassesA = kBM / kRowsPerPass;
  constexpr int kPassesB = (kBN + kRowsPerPass - 1) / kRowsPerPass;
  const int lchunk = tid % kCpr;
  const int lrow = tid / kCpr;
  int a_n[kPassesA], a_y[kPassesA], a_x[kPassesA];
#pragma unroll
  for (int p = 0; p < kPassesA; ++p) {
    const int m = m0 + lrow + p * kRowsPerPass;
    if (m < m_total) {
      const int i = m % cg.wc;
      const int j = (m / cg.wc) % cg.hc;
      a_n[p] = m / (cg.wc * cg.hc);
      if (g.transposed) {
        a_y[p] = j;
        a_x[p] = i;
      } else {
        a_y[p] = j * g.sh - g.ph;
        a_x[p] = i * g.sw - g.pw;
      }
    } else {
      a_n[p] = -1;
      a_y[p] = a_x[p] = 0;
    }
  }

  const int k_chunks = (g.cin + kBK - 1) / kBK;
  const int iters = n_taps * k_chunks;
  const int ktaps = g.kh * g.kw;

  auto load_stage = [&](int stage, int it) {
    const int t = it / k_chunks;
    const int c = (it % k_chunks) * kBK + lchunk * CH;
    const bool c_ok = c < g.cin;  // Cin is a multiple of CH: a copy is all in or all out
    const int dy = tap_dy[t], dx = tap_dx[t];
    int8_t* const a_st = sa + stage * kBM * kLd;
    int8_t* const b_st = sb + stage * kBN * kLd;
#pragma unroll
    for (int p = 0; p < kPassesA; ++p) {
      const int iy = a_y[p] + dy, ix = a_x[p] + dx;
      const bool ok = c_ok && a_n[p] >= 0 && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
      const int8_t* src =
          ok ? x + ((static_cast<long long>(a_n[p]) * g.h + iy) * g.w + ix) * g.cin + c : x;
      cp_async<CH>(a_st + (lrow + p * kRowsPerPass) * kLd + lchunk * CH, src, ok);
    }
    const int tw = tap_w[t];
#pragma unroll
    for (int p = 0; p < kPassesB; ++p) {
      const int r = lrow + p * kRowsPerPass;
      if (r < kBN) {
        const int co = n0 + r;
        const bool ok = c_ok && co < g.cout;
        const int8_t* src = ok ? w + (static_cast<long long>(co) * ktaps + tw) * g.cin + c : w;
        cp_async<CH>(b_st + r * kLd + lchunk * CH, src, ok);
      }
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp % 2) * 64, wn = (warp / 2) * (8 * NT);
  const int gid = lane / 4, tig = lane % 4;
  // ldmatrix row addresses: A's four matrices are rows 0-7 / 8-15 at bytes
  // 0-15 / 16-31 of a 16 x 32 fragment (a0..a3 of the mma); B's are two n8
  // tiles' rows at bytes 0-15 / 16-31 (b0, b1 of each)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 16;
  int acc[4][NT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // fragments of one 32-byte k step, double-buffered: the next step's are
  // read from shared memory while this step's products issue
  unsigned af[2][4][4], bf[2][NT][2];
  auto load_frags = [&](int buf, const int8_t* a_tile, const int8_t* b_tile, int ks) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      ldmatrix_x4(af[buf][mi], a_tile + (wm + mi * 16 + a_row) * kLd + ks + a_col);
#pragma unroll
    for (int nj = 0; nj < NT; nj += 2) {
      unsigned r[4];
      ldmatrix_x4(r, b_tile + (wn + nj * 8 + b_row) * kLd + ks + b_col);
      bf[buf][nj][0] = r[0];
      bf[buf][nj][1] = r[1];
      bf[buf][nj + 1][0] = r[2];
      bf[buf][nj + 1][1] = r[3];
    }
  };
  auto mma_frags = [&](int buf) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        mma_s8(acc[mi][ni], af[buf][mi], bf[buf][ni][0], bf[buf][ni][1]);
  };
  static_assert(kBK == 64, "a stage is two 32-byte k steps");

  // the ring: stages 0 .. kStages-2 in flight, then one more a stage
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < iters) load_stage(s, s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();  // stage 0 has landed
  if (iters > 0) load_frags(0, sa, sb, 0);
  for (int it = 0; it < iters; ++it) {
    const int8_t* a_tile = sa + (it % kStages) * kBM * kLd;
    const int8_t* b_tile = sb + (it % kStages) * kBN * kLd;
    load_frags(1, a_tile, b_tile, 32);
    // refill the slot every warp finished reading before the last barrier
    const int next = it + kStages - 1;
    if (next < iters) load_stage(next % kStages, next);
    cp_async_commit();
    mma_frags(0);
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage it + 1 has landed; stage it is read out
    if (it + 1 < iters)
      load_frags(0, sa + ((it + 1) % kStages) * kBM * kLd, sb + ((it + 1) % kStages) * kBN * kLd, 0);
    mma_frags(1);
  }
  cp_async_wait<0>();

  // epilogue: acc[mi][ni][r] is output row wm + mi*16 + gid (+8 for r >= 2),
  // channel wn + ni*8 + 2*tig + (r & 1)
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mi * 16 + gid + half * 8;
      if (m >= m_total) continue;
      const long long pix = out_pixel(g, cg, m);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + wn + ni * 8 + 2 * tig + e;
          if (co >= g.cout) continue;
          store_out(acc[mi][ni][half * 2 + e], co, pix * g.cout + co, qb, vec, out, relu,
                    out_kind);
        }
      }
    }
  }
}

template <int CH, int NT>
int launch(dim3 grid, cudaStream_t s, const int8_t* x, const int8_t* w, const int* qb,
           const float* v, void* out, const Geometry& g, int relu, int out_kind) {
  // above 48 KB, dynamic shared memory is opted into once per instantiation
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      conv_s8_kernel<CH, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<NT>());
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  conv_s8_kernel<CH, NT><<<grid, kThreads, smem_bytes<NT>(), s>>>(x, w, qb, v, out, g, relu,
                                                                  out_kind);
  return static_cast<int>(cudaGetLastError());
}

template <int CH>
int launch_n(const long long m_max, int classes, cudaStream_t s, const int8_t* x, const int8_t* w,
             const int* qb, const float* v, void* out, const Geometry& g, int relu,
             int out_kind) {
  // the CTA's width: the narrowest of 64, 128, 256 output channels that
  // wastes little of Cout (the 77-channel deconvolution takes 128); with
  // 4-byte copies the 256-wide tile would spill, so 128 is the widest
  const int nt = g.cout > 128 && CH != 4 ? 8 : g.cout > 64 ? 4 : 2;
  const int bn = 32 * nt;
  if ((m_max + kBM - 1) / kBM > 0x7fffffffLL || (g.cout + bn - 1) / bn > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((m_max + kBM - 1) / kBM), (g.cout + bn - 1) / bn,
                  classes);
  switch (nt) {
    case 8:
      if constexpr (CH != 4) return launch<CH, 8>(grid, s, x, w, qb, v, out, g, relu, out_kind);
      return cudaErrorInvalidValue;
    case 4:
      return launch<CH, 4>(grid, s, x, w, qb, v, out, g, relu, out_kind);
    default:
      return launch<CH, 2>(grid, s, x, w, qb, v, out, g, relu, out_kind);
  }
}

int launch_mma_sync(const Geometry& g, long long m_max, int classes, cudaStream_t s,
                    const int8_t* x, const int8_t* w, const int* q, const float* v, void* out,
                    int relu, int out_kind) {
  if (g.cin % 4 != 0) return cudaErrorInvalidValue;
  if (g.cin % 16 == 0) return launch_n<16>(m_max, classes, s, x, w, q, v, out, g, relu, out_kind);
  if (g.cin % 8 == 0) return launch_n<8>(m_max, classes, s, x, w, q, v, out, g, relu, out_kind);
  return launch_n<4>(m_max, classes, s, x, w, q, v, out, g, relu, out_kind);
}

// ---------------------------------------------------------------------------
// variant "wgmma"
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;          // two consumer warpgroups of m64
constexpr int kWgThreads = 384;     // the producer warpgroup, then two consumer warpgroups
constexpr int kConsumerWarps = 8;   // arrivals that free a stage
constexpr int kRingBytes = 192 * 1024;
constexpr int kMinSmem = 120 * 1024;   // over half of an SM's 228 KB
constexpr int kMaxOffset = 254;     // an im2col offset of a rank-4 map (8 bits)
constexpr int kMaxCorner = 127;     // a rank-4 map's box corners lie in [-128, 127]

template <int BN, int BK>
struct WgTile {
  static constexpr int kA = kWgBM * BK;   // bytes of an A tile (128 pixels x BK channels)
  static constexpr int kB = BN * BK;      // bytes of a B tile (BN output channels x BK)
  static constexpr int kStage = kA + kB;
  static constexpr int kStages = kRingBytes / kStage > 8 ? 8 : kRingBytes / kStage;
  // the ring, aligned to 1024 bytes by hand (the swizzle atoms' alignment),
  // then the full and empty barriers, the tile's bias and factor vectors
  // and its rows' output offsets; at least kMinSmem, so that one CTA runs on an SM and
  // setmaxnreg always finds the registers it asks for
  static constexpr int kUsed = 1024 + kStages * kStage + 2 * 8 * kStages + 2 * 4 * BN + 8 * kWgBM;
  static constexpr int kSmem = kUsed > kMinSmem ? kUsed : kMinSmem;
  static_assert(kA % 1024 == 0 && kB % 1024 == 0, "tiles keep the swizzle atoms aligned");
  // the epilogue stages the output tile in the ring: 128 rows of BN
  // elements of up to 4 bytes, each row padded by 16 bytes
  static constexpr int kTileRow = 4 * BN + 16;
  static_assert(kWgBM * kTileRow <= kStages * kStage, "the output tile fits in the ring");
};

// what the wgmma kernel reads beyond the tensor maps
struct WgGeometry {
  Geometry g;
  int lower_h, lower_w;  // the im2col box's lower corner: a base pixel's offset
};

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival, and the bytes the stage's two loads will complete
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// 128 pixels x BK channels of the im2col box from base pixel (n, h, w) at
// channel c, each pixel moved by the tap's offsets (ow, oh)
__device__ __forceinline__ void tma_im2col(unsigned dst, const CUtensorMap* map, unsigned bar,
                                           int c, int w, int h, int n, uint16_t ow, uint16_t oh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n), "h"(ow),
      "h"(oh)
      : "memory");
}

// BN output channels x BK channels of tap t's weights
__device__ __forceinline__ void tma_tile3(unsigned dst, const CUtensorMap* map, unsigned bar,
                                          int c, int t, int co) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(t), "r"(co)
      : "memory");
}

// a K-major operand tile in shared memory: rows of BK bytes, swizzled by
// the tensor map (128-byte swizzle for BK 128, 64-byte for BK 64); the
// stride between 8-row groups is 8 * BK bytes, the leading offset unused.
// Adding 2 moves the start 32 bytes (one k32 step) along K.
template <int BK>
__device__ __forceinline__ uint64_t smem_desc(unsigned addr) {
  constexpr uint64_t kLayout = BK == 128 ? 1 : 2;
  constexpr uint64_t kSbo = (8 * BK) >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (kSbo << 32) |
         (kLayout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving the accumulators across the asynchronous
// products
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x N int32, the warpgroup's accumulator fragments) += A (64 x 32 s8)
// * B (N x 32 s8)^T, both read from shared memory through descriptors
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<80>(int (&d)[40], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// the 256 consumer threads (named barrier 1; barrier 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The wgmma variant's epilogue for output kind K: each consumer thread
// converts its sums (bias and factor from the CTA's copies qbs / vecs in
// shared memory) into the output tile staged in shared memory (128 rows of
// BN channels), then each warp copies whole rows of the tile to their
// output pixels (row_off: each row's first output element, -1 past the
// output) with the widest stores (16 bytes at most) that the rows' byte
// offsets allow, lane after lane along a row.
template <int K, int BN>
__device__ __forceinline__ void epilogue_tile(const int (&acc)[BN / 2], uint8_t* tile,
                                              const int* qbs, const float* vecs,
                                              long long* row_off, bool has_qb, int relu,
                                              const Geometry& g, const ClassGrid& cg, int m0,
                                              int m_total, int n0, void* out) {
  using T = typename Out<K>::T;
  constexpr int kRow = 4 * BN + 16;  // WgTile::kTileRow
  const int ct = threadIdx.x - 128;
  const int cw = ct / 128, warp = (ct % 128) / 32, lane = ct % 32, gid = lane / 4, tig = lane % 4;
  if (ct < kWgBM)
    row_off[ct] = m0 + ct < m_total ? out_pixel(g, cg, m0 + ct) * g.cout + n0 : -1;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = cw * 64 + warp * 16 + gid + half * 8;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * tig;
      T v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int a = acc[4 * j + 2 * half + e];
        if (has_qb) a += qbs[c + e];
        if (relu) a = max(a, 0);
        v[e] = convert<K>(a, vecs[c + e]);
      }
      T* dst = reinterpret_cast<T*>(tile + r * kRow) + c;
      dst[0] = v[0];
      dst[1] = v[1];
    }
  }
  consumers_sync();
  // each row: channels n0 .. n0 + cols - 1 of one output pixel, contiguous
  const int cols = min(BN, g.cout - n0);
  const int row_bytes = cols * static_cast<int>(sizeof(T));
  const int pitch = g.cout * static_cast<int>(sizeof(T));
  int width = 16;  // n0 * sizeof(T) is a multiple of 64: the pitch and the row decide
  while (row_bytes % width != 0 || pitch % width != 0) width /= 2;
  const int per_row = row_bytes / width;
  // a warp copies `rows` rows at a time: lane / per_row picks the row and
  // lane % per_row the first chunk when a row has under 32 chunks
  const int rows = per_row >= 32 ? 1 : 32 / per_row;
  const int sub = per_row >= 32 ? 0 : lane / per_row;
  const int k0 = per_row >= 32 ? lane : lane % per_row, step = per_row >= 32 ? 32 : per_row;
  const int warps = 8;  // the consumer warps
  for (int r = (ct / 32) * rows + sub; sub < rows && r < kWgBM; r += warps * rows) {
    const long long o = row_off[r];
    if (o < 0) continue;
    uint8_t* const dst = static_cast<uint8_t*>(out) + o * static_cast<long long>(sizeof(T));
    const uint8_t* const src = tile + r * kRow;
    for (int k = k0 * width; k < row_bytes; k += step * width) {
      switch (width) {
        case 16:
          *reinterpret_cast<int4*>(dst + k) = *reinterpret_cast<const int4*>(src + k);
          break;
        case 8:
          *reinterpret_cast<int2*>(dst + k) = *reinterpret_cast<const int2*>(src + k);
          break;
        case 4:
          *reinterpret_cast<int*>(dst + k) = *reinterpret_cast<const int*>(src + k);
          break;
        case 2:
          *reinterpret_cast<short*>(dst + k) = *reinterpret_cast<const short*>(src + k);
          break;
        default:
          dst[k] = src[k];
          break;
      }
    }
  }
}

// The wgmma variant: a CTA computes output rows m0 .. m0 + 127 (of the
// parity class blockIdx.z) x channels n0 .. n0 + BN - 1.
template <int BN, int BK>
__global__ void __launch_bounds__(kWgThreads, 1) conv_s8_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
    const int* __restrict__ qb, const float* __restrict__ vec, void* __restrict__ out,
    WgGeometry wg, int relu, int out_kind) {
  using T = WgTile<BN, BK>;
  extern __shared__ uint8_t smem_raw[];
  const Geometry& g = wg.g;
  const unsigned ring = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const unsigned bars = ring + T::kStages * T::kStage;  // full[s], then empty[s]

  const ClassGrid cg = class_grid(g);
  const int m_total = g.n * cg.hc * cg.wc;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kWgBM;
  // the class's taps: (ky, kx) meets an input pixel, at offsets (oy, ox)
  // from the box's base pixel
  auto tap = [&](int ky, int kx, int& oy, int& ox) {
    if (!g.transposed) {
      oy = ky * g.dh;
      ox = kx * g.dw;
      return true;
    }
    const int ry = cg.py + g.ph - ky, rx = cg.px + g.pw - kx;
    if (((ry % g.sh) + g.sh) % g.sh != 0 || ((rx % g.sw) + g.sw) % g.sw != 0) return false;
    oy = ry / g.sh - wg.lower_h;  // exact division
    ox = rx / g.sw - wg.lower_w;
    return true;
  };
  int n_taps = 0;
  for (int ky = 0; ky < g.kh; ++ky)
    for (int kx = 0; kx < g.kw; ++kx) {
      int oy, ox;
      n_taps += tap(ky, kx, oy, ox);
    }
  const int iters = n_taps * ((g.cin + BK - 1) / BK);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (T::kStages + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // producer: one thread issues every load of the tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_x))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_w))
                   : "memory");
      // the tile's first pixel in the box: the box walks the class's pixels
      // in the output's order, one traversal stride at a time
      const int i = m0 % cg.wc, j = (m0 / cg.wc) % cg.hc, n = m0 / (cg.wc * cg.hc);
      const int bw = (g.transposed ? i : i * g.sw) + wg.lower_w;
      const int bh = (g.transposed ? j : j * g.sh) + wg.lower_h;
      int it = 0;
      for (int ky = 0; ky < g.kh; ++ky) {
        for (int kx = 0; kx < g.kw; ++kx) {
          int oy, ox;
          if (!tap(ky, kx, oy, ox)) continue;
          for (int c = 0; c < g.cin; c += BK, ++it) {
            const int s = it % T::kStages;
            const unsigned full = bars + 8 * s, empty = bars + 8 * (T::kStages + s);
            mbar_wait(empty, ((it / T::kStages) & 1) ^ 1);  // the first round finds it free
            mbar_expect_tx(full, T::kStage);
            const unsigned a = ring + s * T::kStage;
            tma_im2col(a, &map_x, full, c, bw, bh, n, static_cast<uint16_t>(ox),
                       static_cast<uint16_t>(oy));
            tma_tile3(a + T::kA, &map_w, full, c, ky * g.kw + kx, n0);
          }
        }
      }
    }
  } else {
    // consumers: warpgroup cw computes rows 64 * cw .. 64 * cw + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = tid - 128;
    const int cw = ct / 128;
    // the tile's bias and factor vectors, read by the epilogue
    int* const qbs = reinterpret_cast<int*>(smem_raw + (bars + 16 * T::kStages - smem_addr(smem_raw)));
    float* const vecs = reinterpret_cast<float*>(qbs + BN);
    long long* const row_off = reinterpret_cast<long long*>(vecs + BN);
    if (ct < BN) {
      const bool in = n0 + ct < g.cout;
      qbs[ct] = in && qb != nullptr ? qb[n0 + ct] : 0;
      vecs[ct] = in && vec != nullptr ? vec[n0 + ct] : 0.f;
    }
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    fence_acc(acc);
    for (int it = 0; it < iters; ++it) {
      const int s = it % T::kStages;
      mbar_wait(bars + 8 * s, (it / T::kStages) & 1);
      const unsigned a = ring + s * T::kStage;
      const uint64_t da = smem_desc<BK>(a + cw * 64 * BK);
      const uint64_t db = smem_desc<BK>(a + T::kA);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      fence_acc(acc);
      // one group stays in flight; the one before it is done, so its stage is free
      wgmma_wait<1>();
      if (it > 0 && (ct & 31) == 0) mbar_arrive(bars + 8 * (T::kStages + (it - 1) % T::kStages));
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // epilogue: acc[4 * j + 2 * half + e] is row 16 * warp + gid (+8 for
    // half 1) of the warpgroup's 64, channel 8 * j + 2 * tig + e. Every
    // consumer is done reading the ring before the tile overwrites it.
    consumers_sync();
    uint8_t* const tile = smem_raw + (ring - smem_addr(smem_raw));
#define Q1_EPILOGUE(K)                                                                  \
  epilogue_tile<K, BN>(acc, tile, qbs, vecs, row_off, qb != nullptr, relu, g, cg, m0, m_total, \
                       n0, out)
    switch (out_kind) {
      case kS32:
        Q1_EPILOGUE(kS32);
        break;
      case kS8:
        Q1_EPILOGUE(kS8);
        break;
      case kF32:
        Q1_EPILOGUE(kF32);
        break;
      case kF16:
        Q1_EPILOGUE(kF16);
        break;
      default:
        Q1_EPILOGUE(kBF16);
        break;
    }
#undef Q1_EPILOGUE
  }
}

// the driver's tensor-map encoders, reached through the runtime (no -lcuda)
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

void* driver_entry(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(name, &fn, 12000, cudaEnableDefault,
                                                           &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? fn : nullptr;
}

// The wgmma variant's plan of a convolution: the box's corners and the
// largest tap offset, or false where a rank-4 im2col map cannot describe it
// (the preconditions ops/conv_int8.py::wgmma_takes mirrors).
bool plan_wgmma(const Geometry& g, const void* x, const void* w, WgGeometry& wg, int lower[2],
                int upper[2], unsigned traversal[2]) {
  if (g.cin % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return false;
  int max_off[2];
  if (g.transposed) {
    if (g.dh != 1 || g.dw != 1 || g.ho % g.sh != 0 || g.wo % g.sw != 0) return false;
    // over every class's taps: the least and largest input offset, per axis
    const int k[2] = {g.kh, g.kw}, st[2] = {g.sh, g.sw}, pad[2] = {g.ph, g.pw};
    const int cls[2] = {g.ho / g.sh, g.wo / g.sw}, in[2] = {g.h, g.w};
    for (int a = 0; a < 2; ++a) {
      int lo = 1 << 30, hi = -(1 << 30);
      for (int p = 0; p < st[a]; ++p)
        for (int t = 0; t < k[a]; ++t) {
          const int r = p + pad[a] - t;
          if (((r % st[a]) + st[a]) % st[a] != 0) continue;
          lo = r / st[a] < lo ? r / st[a] : lo;
          hi = r / st[a] > hi ? r / st[a] : hi;
        }
      if (lo > hi) return false;
      lower[a] = lo;
      upper[a] = cls[a] - in[a] + lo;  // the box walks exactly the class's cls[a] pixels
      max_off[a] = hi - lo;
      traversal[a] = 1;
    }
  } else {
    const int k[2] = {g.kh, g.kw}, st[2] = {g.sh, g.sw}, pad[2] = {g.ph, g.pw};
    const int dil[2] = {g.dh, g.dw}, out[2] = {g.ho, g.wo}, in[2] = {g.h, g.w};
    for (int a = 0; a < 2; ++a) {
      if (st[a] > 8) return false;
      lower[a] = -pad[a];
      upper[a] = pad[a] - (k[a] - 1) * dil[a];
      max_off[a] = (k[a] - 1) * dil[a];
      traversal[a] = static_cast<unsigned>(st[a]);
      const int span = in[a] - 1 + upper[a] - lower[a];
      if (span < 0 || span / st[a] + 1 != out[a]) return false;
    }
  }
  for (int a = 0; a < 2; ++a)
    if (lower[a] < -kMaxCorner - 1 || lower[a] > kMaxCorner || upper[a] < -kMaxCorner - 1 ||
        upper[a] > kMaxCorner || max_off[a] > kMaxOffset)
      return false;
  wg.g = g;
  wg.lower_h = lower[0];
  wg.lower_w = lower[1];
  return true;
}

template <int BN, int BK>
int launch_wgmma_tile(const CUtensorMap& mx, const CUtensorMap& mw, dim3 grid, cudaStream_t s,
                      const int* qb, const float* v, void* out, const WgGeometry& wg, int relu,
                      int out_kind) {
  using T = WgTile<BN, BK>;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      conv_s8_wgmma_kernel<BN, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  conv_s8_wgmma_kernel<BN, BK><<<grid, kWgThreads, T::kSmem, s>>>(mx, mw, qb, v, out, wg, relu,
                                                                  out_kind);
  return static_cast<int>(cudaGetLastError());
}

template <int BK>
int launch_wgmma_bn(int bn, const CUtensorMap& mx, const CUtensorMap& mw, dim3 grid,
                    cudaStream_t s, const int* qb, const float* v, void* out,
                    const WgGeometry& wg, int relu, int out_kind) {
  switch (bn) {
    case 256:
      return launch_wgmma_tile<256, BK>(mx, mw, grid, s, qb, v, out, wg, relu, out_kind);
    case 128:
      return launch_wgmma_tile<128, BK>(mx, mw, grid, s, qb, v, out, wg, relu, out_kind);
    case 80:
      return launch_wgmma_tile<80, BK>(mx, mw, grid, s, qb, v, out, wg, relu, out_kind);
    default:
      return launch_wgmma_tile<64, BK>(mx, mw, grid, s, qb, v, out, wg, relu, out_kind);
  }
}

int launch_wgmma(const Geometry& g, long long m_max, int classes, cudaStream_t s,
                 const int8_t* x, const int8_t* w, const int* q, const float* v, void* out,
                 int relu, int out_kind) {
  static const EncodeIm2col encode_im2col =
      reinterpret_cast<EncodeIm2col>(driver_entry("cuTensorMapEncodeIm2col"));
  static const EncodeTiled encode_tiled =
      reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  if (encode_im2col == nullptr || encode_tiled == nullptr) return cudaErrorNotSupported;
  WgGeometry wg;
  int lower[2], upper[2];  // (h, w)
  unsigned traversal[2];
  if (!plan_wgmma(g, x, w, wg, lower, upper, traversal)) return cudaErrorInvalidValue;
  const int bk = g.cin > 64 ? 128 : 64;
  const int bn = g.cout > 128 ? 256 : g.cout > 80 ? 128 : g.cout > 64 ? 80 : 64;
  const long long m_tiles = (m_max + kWgBM - 1) / kWgBM;
  if (m_tiles > 65535) return cudaErrorInvalidValue;
  const CUtensorMapSwizzle swizzle =
      bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;

  // the activations (C, W, H, N), innermost first; the box's corners and
  // traversal strides (W, H)
  CUtensorMap mx, mw;
  const cuuint64_t x_dim[4] = {static_cast<cuuint64_t>(g.cin), static_cast<cuuint64_t>(g.w),
                               static_cast<cuuint64_t>(g.h), static_cast<cuuint64_t>(g.n)};
  const cuuint64_t x_stride[3] = {static_cast<cuuint64_t>(g.cin),
                                  static_cast<cuuint64_t>(g.cin) * g.w,
                                  static_cast<cuuint64_t>(g.cin) * g.w * g.h};
  const int lo_wh[2] = {lower[1], lower[0]}, hi_wh[2] = {upper[1], upper[0]};
  const cuuint32_t x_elem[4] = {1, traversal[1], traversal[0], 1};
  CUresult r = encode_im2col(&mx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(x), x_dim,
                             x_stride, lo_wh, hi_wh, static_cast<cuuint32_t>(bk), kWgBM, x_elem,
                             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  // drivers up to 13.1 mis-encode an im2col map of a tensor under 128 KiB
  // unless bit 21 of its second word is cleared (as CUTLASS's
  // make_im2col_tma_copy_desc does)
  static const int driver = [] {
    int v = 0;
    return cudaDriverGetVersion(&v) == cudaSuccess ? v : 0;
  }();
  if (driver <= 13010 && static_cast<long long>(g.n) * g.h * g.w * g.cin < 131072)
    reinterpret_cast<uint64_t*>(&mx)[1] &= ~(1ull << 21);

  // the weights (Cin, kh * kw, Cout)
  const cuuint64_t w_dim[3] = {static_cast<cuuint64_t>(g.cin),
                               static_cast<cuuint64_t>(g.kh * g.kw),
                               static_cast<cuuint64_t>(g.cout)};
  const cuuint64_t w_stride[2] = {static_cast<cuuint64_t>(g.cin),
                                  static_cast<cuuint64_t>(g.cin) * g.kh * g.kw};
  const cuuint32_t w_box[3] = {static_cast<cuuint32_t>(bk), 1, static_cast<cuuint32_t>(bn)};
  const cuuint32_t w_elem[3] = {1, 1, 1};
  r = encode_tiled(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<int8_t*>(w), w_dim, w_stride,
                   w_box, w_elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;

  // N tiles fastest: the CTAs of one M tile run together
  const dim3 grid((g.cout + bn - 1) / bn, static_cast<unsigned>(m_tiles), classes);
  if (bk == 128) return launch_wgmma_bn<128>(bn, mx, mw, grid, s, q, v, out, wg, relu, out_kind);
  return launch_wgmma_bn<64>(bn, mx, mw, grid, s, q, v, out, wg, relu, out_kind);
}

}  // namespace

extern "C" {

int dp_conv_s8_max_taps() { return kMaxTaps; }

// x (n, h, w, cin) s8 and w (cout, kh, kw, cin) s8, contiguous on the device;
// qb (cout,) int32 or null; vec (cout,) f32 (m or scale; unused for kind 0);
// out (n, ho, wo, cout) of the kind's type, written. transposed: a
// ConvTranspose2d of stride (sh, sw) and padding (ph, pw), dilation 1, with w
// in its tap order. variant 0: mma_sync (cin a multiple of 4); 1: wgmma (its
// preconditions: plan_wgmma). Returns the cudaError_t of the launch, or
// cudaErrorInvalidValue for an input the variant does not take.
int dp_conv_s8(const void* x, const void* w, const void* qb, const void* vec, void* out, int n,
               int h, int wd, int cin, int ho, int wo, int cout, int kh, int kw, int sh, int sw,
               int ph, int pw, int dh, int dw, int transposed, int relu, int out_kind,
               int variant, void* stream) {
  if (kh * kw > kMaxTaps || kh < 1 || kw < 1 || sh < 1 || sw < 1 || dh < 1 || dw < 1 ||
      out_kind < kS32 || out_kind > kBF16 || (out_kind != kS32 && vec == nullptr) ||
      (transposed && (dh != 1 || dw != 1)) || (variant != kMmaSync && variant != kWgmma))
    return cudaErrorInvalidValue;
  const Geometry g{n, h, wd, cin, ho, wo, cout, kh, kw, sh, sw, ph, pw, dh, dw, transposed};
  const int classes = transposed ? sh * sw : 1;
  // rows of the largest parity class (the whole output for a forward conv)
  const int hc = transposed ? (ho + sh - 1) / sh : ho, wc = transposed ? (wo + sw - 1) / sw : wo;
  const long long m_max = static_cast<long long>(n) * hc * wc;
  if (m_max == 0 || cout == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xs = static_cast<const int8_t*>(x);
  const int8_t* ws = static_cast<const int8_t*>(w);
  const int* q = static_cast<const int*>(qb);
  const float* v = static_cast<const float*>(vec);
  if (variant == kWgmma) return launch_wgmma(g, m_max, classes, s, xs, ws, q, v, out, relu, out_kind);
  return launch_mma_sync(g, m_max, classes, s, xs, ws, q, v, out, relu, out_kind);
}

}  // extern "C"
