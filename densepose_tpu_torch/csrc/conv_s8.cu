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
// oy / stride + (py + pad - ky) / stride. The holes of the input-dilated form
// the JAX package lowers (3/4 of its K at stride 2) are never visited. The
// weights of a transposed convolution are in ConvTranspose2d's tap order
// (not the flipped forward-conv form).
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
// at the 1x1 backbone links with Cin 64..256 the bytes. Design (right
// before fast; the Hopper redesign with wgmma and TMA is later work): a CTA
// computes a 128 x (64, 128 or 256) tile of the output, the narrowest
// that covers Cout well, with 8 warps, each a 64 x (16, 32 or 64) sub-tile
// through mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32. K is walked tap by
// tap in chunks of 64 channels; each chunk's A (128 pixels x 64 bytes) and
// B (output channels x 64 bytes) tiles are filled by cp.async into a 3-stage
// ring in dynamic shared memory, and the warps read their fragments with
// ldmatrix.x4, double-buffered: the next 32-byte k step's loads issue before
// this step's products, and a stage's barrier sits between its two k steps.
// Out-of-image taps, the channel tail of a tap (Cin 40, 48, 600 ... are not
// multiples of 64) and the M and Cout tails are zero-filled by the copies'
// source size 0, so no tail is assumed. A copy moves CH = 16, 8 or 4 bytes,
// the largest that divides Cin (the row of a pixel is then aligned). Rows in
// shared memory are padded to 80 bytes, so each 8-row phase of an ldmatrix
// hits 32 different banks. On an H100 it reaches ~19% of the int8 peak at
// the head links, over twice cuDNN's float16 time (PERF.md section 6).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // output pixels a CTA: 2 warps along M, 64 rows each
constexpr int kBK = 64;       // bytes of K a stage (channels of one tap)
constexpr int kLd = kBK + 16; // padded row stride in shared memory, bytes
constexpr int kStages = 3;
constexpr int kThreads = 256; // 8 warps: 2 along M x 4 along N
constexpr int kMaxTaps = 64;  // kh * kw a launch, at most

enum OutKind { kS32 = 0, kS8 = 1, kF32 = 2, kF16 = 3, kBF16 = 4 };

struct Geometry {
  int n, h, w, cin;        // input, NHWC
  int ho, wo, cout;        // output, NHWC
  int kh, kw;
  int sh, sw, ph, pw, dh, dw;
  int transposed;          // 1: ConvTranspose2d (stride sh, padding ph) as a gather
};

// shared memory of a CTA whose warps hold NT n8 tiles each: the ring of A
// (kBM rows) and B (32 * NT rows) tiles
template <int NT>
constexpr int smem_bytes() {
  return kStages * (kBM + 32 * NT) * kLd;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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
      const int i = m % cg.wc;
      const int j = (m / cg.wc) % cg.hc;
      const int n = m / (cg.wc * cg.hc);
      const long long pix =
          (static_cast<long long>(n) * g.ho + cg.py + cg.step_y * j) * g.wo + cg.px + cg.step_x * i;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + wn + ni * 8 + 2 * tig + e;
          if (co >= g.cout) continue;
          int a = acc[mi][ni][half * 2 + e];
          if (qb != nullptr) a += qb[co];
          if (relu) a = max(a, 0);
          const long long o = pix * g.cout + co;
          switch (out_kind) {
            case kS32:
              static_cast<int*>(out)[o] = a;
              break;
            case kS8: {
              const float v = __fmul_rn(__int2float_rn(a), vec[co]);
              const int q = __float2int_rn(v);  // round half to even, as torch.round
              static_cast<int8_t*>(out)[o] = static_cast<int8_t>(min(max(q, -127), 127));
              break;
            }
            case kF32:
              static_cast<float*>(out)[o] = __fmul_rn(__int2float_rn(a), vec[co]);
              break;
            case kF16:
              static_cast<__half*>(out)[o] = __float2half_rn(__fmul_rn(__int2float_rn(a), vec[co]));
              break;
            default:
              static_cast<__nv_bfloat16*>(out)[o] =
                  __float2bfloat16_rn(__fmul_rn(__int2float_rn(a), vec[co]));
              break;
          }
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

}  // namespace

extern "C" {

int dp_conv_s8_max_taps() { return kMaxTaps; }

// x (n, h, w, cin) s8 and w (cout, kh, kw, cin) s8, contiguous on the device;
// qb (cout,) int32 or null; vec (cout,) f32 (m or scale; unused for kind 0);
// out (n, ho, wo, cout) of the kind's type, written. transposed: a
// ConvTranspose2d of stride (sh, sw) and padding (ph, pw), dilation 1, with w
// in its tap order. cin must be a multiple of 4. Returns the cudaError_t of
// the launch.
int dp_conv_s8(const void* x, const void* w, const void* qb, const void* vec, void* out, int n,
               int h, int wd, int cin, int ho, int wo, int cout, int kh, int kw, int sh, int sw,
               int ph, int pw, int dh, int dw, int transposed, int relu, int out_kind,
               void* stream) {
  if (cin % 4 != 0 || kh * kw > kMaxTaps || kh < 1 || kw < 1 || sh < 1 || sw < 1 || dh < 1 ||
      dw < 1 || out_kind < kS32 || out_kind > kBF16 || (out_kind != kS32 && vec == nullptr) ||
      (transposed && (dh != 1 || dw != 1)))
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
  if (cin % 16 == 0) return launch_n<16>(m_max, classes, s, xs, ws, q, v, out, g, relu, out_kind);
  if (cin % 8 == 0) return launch_n<8>(m_max, classes, s, xs, ws, q, v, out, g, relu, out_kind);
  return launch_n<4>(m_max, classes, s, xs, ws, q, v, out, g, relu, out_kind);
}

}  // extern "C"
