"""Where kernel Q1's time goes, and the designs its wgmma variant was held
against, on one CUDA card.

    python -m densepose_tpu_torch.tools.q1_timeline

Builds scratch copies of ``csrc/conv_s8.cu``, each a text patch of the
checkout's source, into ``densepose_tpu_torch/_build/timeline/`` (one nvcc
each, in parallel, with ``cuda_build.NVCC_FLAGS``):

- ``tree``: the source as it is;
- ``stamped``: the same with ``%globaltimer`` stamps a CTA (its start, the
  first full stage, the end of the main loop, the end of the epilogue) and
  its SM, written to a device array;
- ``elementwise``: the first wgmma design's epilogue, each sum stored from
  the accumulator fragments to the output one element at a time (bias and
  factor loaded from global memory for each), with the same stamps;
- ``multicast``: the B (weight) tile shared by a 2-CTA cluster along M, each
  CTA loading half of it by a TMA multicast into both, every stage freed by
  the consumer warps of both CTAs.

At four sites of ``chip_smoke.Q1_SITES`` (the head link, the last head link
with f32 out, the merged deconvolution, FPN p2) each build's wgmma variant
is held bit for bit against ``conv_s8_plain`` and timed by CUDA events
around back-to-back calls in turns (tree, each other build, tree); the
stamped builds print each tile phase's median and 90th percentile over the
CTAs and the gap between consecutive CTAs on an SM. Then the host's time a
call of each variant (back-to-back calls at HRNet-W32's 256-wide branch).
Prints the card's name, power limit and clocks. Exits non-zero without a
CUDA device.
"""

import ctypes
import subprocess
import sys

import numpy as np

SITES = [  # chip_smoke.Q1_SITES' (name, N, H, W, Cin, Cout, k, stride, pad, dil, transposed, out)
    ("head_link_100", 100, 28, 28, 512, 512, 3, 1, 1, 1, False, "s8"),
    ("head_last_100", 100, 28, 28, 512, 512, 3, 1, 1, 1, False, "float32"),
    ("deconv_77_100", 100, 28, 28, 512, 77, 4, 2, 1, 1, True, "float32"),
    ("fpn_output_p2", 1, 200, 272, 256, 256, 3, 1, 1, 1, False, "float32"),
]
REPS = 20


def _patch(src, old, new):
    if src.count(old) != 1:
        raise RuntimeError(f"q1_timeline: the source no longer holds {old[:60]!r}")
    return src.replace(old, new)


STAMP_HEADER = """__device__ long long q1_stamps[5 << 16];
__device__ __forceinline__ long long q1_time() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int dp_q1_stamps(void* dst, int n) {
  return cudaMemcpyFromSymbol(dst, q1_stamps, n * sizeof(long long));
}
"""

STAMP_WRITE = """    __syncwarp();
    if (tid == 128) {
      const long long b = 5LL * ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      q1_stamps[b] = q1_t0;
      q1_stamps[b + 1] = q1_t1;
      q1_stamps[b + 2] = q1_t2;
      q1_stamps[b + 3] = q1_time();
      q1_stamps[b + 4] = sm;
    }
"""

# the first wgmma design's epilogue, written from the accumulator fragments
ELEMENTWISE = """    const int warp = (ct % 128) / 32, lane = ct % 32, gid = lane / 4, tig = lane % 4;
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + cw * 64 + warp * 16 + gid + half * 8;
      if (m >= m_total) continue;
      const long long pix = out_pixel(g, cg, m);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + 8 * j + 2 * tig + e;
          if (co >= g.cout) continue;
          store_out(acc[4 * j + 2 * half + e], co, pix * g.cout + co, qb, vec, out, relu,
                    out_kind);
        }
      }
    }
"""

EPILOGUE_START = "    consumers_sync();\n    uint8_t* const tile = smem_raw + (ring - smem_addr(smem_raw));\n"
EPILOGUE_END = "#undef Q1_EPILOGUE\n"


def stamped(src):
    src = _patch(src, "namespace {\n\nenum OutKind", STAMP_HEADER + "namespace {\n\nenum OutKind")
    src = _patch(src, "  const int tid = threadIdx.x;\n  if (tid == 0) {\n    for (int s = 0;",
                 "  const int tid = threadIdx.x;\n  long long q1_t0 = q1_time(), q1_t1 = 0;\n"
                 "  if (tid == 0) {\n    for (int s = 0;")
    src = _patch(src, "      mbar_wait(bars + 8 * s, (it / T::kStages) & 1);\n",
                 "      mbar_wait(bars + 8 * s, (it / T::kStages) & 1);\n"
                 "      if (it == 0) q1_t1 = q1_time();\n")
    src = _patch(src, "    wgmma_wait<0>();\n    fence_acc(acc);\n",
                 "    wgmma_wait<0>();\n    fence_acc(acc);\n    const long long q1_t2 = q1_time();\n")
    return _patch(src, MARK, STAMP_WRITE)


MARK = "    // end of the epilogue\n"


def marked(src):
    """The source with MARK after the wgmma variant's epilogue."""
    return _patch(src, EPILOGUE_END, EPILOGUE_END + MARK)


def elementwise(src):
    a = src.index(EPILOGUE_START)
    b = src.index(EPILOGUE_END + MARK) + len(EPILOGUE_END + MARK)
    return src[:a] + ELEMENTWISE + MARK + src[b:]


def multicast(src):
    src = _patch(src, "constexpr int kWgBM = 128;", "constexpr int kCluster = 2;\nconstexpr int kWgBM = 128;")
    src = _patch(src, "// the 256 consumer threads (named barrier 1;", """__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\\nbarrier.cluster.wait.acquire;\\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_cluster(unsigned bar, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\\n" : "=r"(remote) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\\n" ::"r"(remote)
               : "memory");
}
__device__ __forceinline__ void tma_tile3_multicast(unsigned dst, const CUtensorMap* map,
                                                    unsigned bar, int c, int t, int co) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(t), "r"(co),
      "h"(static_cast<uint16_t>(3))
      : "memory");
}

// the 256 consumer threads (named barrier 1;""")
    src = _patch(src, "__global__ void __launch_bounds__(kWgThreads, 1) conv_s8_wgmma_kernel(",
                 "__global__ void __cluster_dims__(1, kCluster, 1) __launch_bounds__(kWgThreads, 1)"
                 "\n    conv_s8_wgmma_kernel(")
    src = _patch(src, "mbar_init(bars + 8 * (T::kStages + s), kConsumerWarps);",
                 "mbar_init(bars + 8 * (T::kStages + s), kConsumerWarps * kCluster);")
    src = _patch(src, "    asm volatile(\"fence.mbarrier_init.release.cluster;\\n\" ::: \"memory\");\n"
                      "  }\n  __syncthreads();\n",
                 "    asm volatile(\"fence.mbarrier_init.release.cluster;\\n\" ::: \"memory\");\n"
                 "  }\n  cluster_sync();\n  const unsigned rank = cluster_rank();\n")
    src = _patch(src, "            tma_tile3(a + T::kA, &map_w, full, c, ky * g.kw + kx, n0);\n",
                 "            tma_tile3_multicast(a + T::kA + rank * (BN / kCluster) * BK, &map_w, full,"
                 " c, ky * g.kw + kx, n0 + rank * (BN / kCluster));\n")
    src = _patch(src, "        }\n      }\n    }\n  } else {\n    // consumers:",
                 "        }\n      }\n    }\n    cluster_sync();\n  } else {\n    // consumers:")
    src = _patch(src, "      if (it > 0 && (ct & 31) == 0) mbar_arrive(bars + 8 * (T::kStages + (it - 1) % "
                      "T::kStages));\n",
                 "      if (it > 0 && (ct & 31) == 0)\n"
                 "        for (unsigned r = 0; r < kCluster; ++r)\n"
                 "          mbar_arrive_cluster(bars + 8 * (T::kStages + (it - 1) % T::kStages), r);\n")
    src = _patch(src, MARK, "    cluster_sync();\n")
    src = _patch(src, "static_cast<cuuint32_t>(bn)};\n  const cuuint32_t w_elem",
                 "static_cast<cuuint32_t>(bn / kCluster)};\n  const cuuint32_t w_elem")
    return _patch(src, "  const long long m_tiles = (m_max + kWgBM - 1) / kWgBM;\n",
                  "  const long long m_tiles = ((m_max + kWgBM - 1) / kWgBM + 1) / 2 * 2;\n")


def builds():
    """{name: source text} of the four builds."""
    from densepose_tpu_torch.ops import cuda_build
    src = marked((cuda_build.CSRC_DIR / "conv_s8.cu").read_text())
    return {"tree": src, "stamped": stamped(src), "elementwise": stamped(elementwise(src)),
            "multicast": multicast(src)}


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("q1_timeline: no CUDA device")
    from densepose_tpu_torch.ops import conv_int8, cuda_build
    out = cuda_build.BUILD_DIR / "timeline"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in builds().items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"q1_timeline: nvcc failed for {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.dp_conv_s8.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 19 + [ctypes.c_void_p]
        lib.dp_conv_s8.restype = ctypes.c_int
        libs[name] = lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi.stdout.strip()}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    kinds = {"s8": "s8", "float32": torch.float32}
    failed = False

    def timed(fn):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS

    for name, n, h, w, cin, cout, k, stride, pad, dil, transposed, own in SITES:
        qx = torch.randint(-127, 128, (n, h, w, cin), generator=g, device=dev, dtype=torch.int8)
        qw = torch.randint(-127, 128, (cout, k, k, cin), generator=g, device=dev, dtype=torch.int8)
        qb = torch.randint(-20000, 20000, (cout,), generator=g, device=dev, dtype=torch.int32)
        vec = torch.rand(cout, generator=g, device=dev) * 1e-3 + 1e-5
        kw = dict(stride=stride, padding=pad, dilation=dil, transposed=transposed, relu=True,
                  out_kind=kinds[own])
        want = conv_int8.conv_s8_plain(qx, qw, qb, vec, **kw)
        times = {}
        for build in ("tree", "stamped", "elementwise", "multicast", "tree"):
            conv_int8._lib = lambda build=build: libs[build]
            fn = lambda: conv_int8.conv_s8_cuda(qx, qw, qb, vec, **kw, variant="wgmma")
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                print(f"{name}: the {build} build differs from the plain version")
                failed = True
            times.setdefault(build, []).append(timed(fn))
        print(f"{name}: ms by build (CUDA events, {REPS} calls): "
              + "; ".join(f"{b} {' / '.join(f'{t:.4f}' for t in ts)}" for b, ts in times.items()))
        for build in ("stamped", "elementwise"):
            conv_int8._lib = lambda build=build: libs[build]
            conv_int8.conv_s8_cuda(qx, qw, qb, vec, **kw, variant="wgmma")
            torch.cuda.synchronize()
            bn = 256 if cout > 128 else 128 if cout > 80 else 80 if cout > 64 else 64
            classes = stride * stride if transposed else 1
            hc, wc = (h, w) if transposed else ((h + 2 * pad - dil * (k - 1) - 1) // stride + 1,
                                                 (w + 2 * pad - dil * (k - 1) - 1) // stride + 1)
            ctas = classes * -(-cout // bn) * -(-(n * hc * wc) // 128)
            buf = np.zeros(5 * ctas, np.int64)
            if libs[build].dp_q1_stamps(buf.ctypes.data, 5 * ctas) != 0:
                sys.exit("q1_timeline: reading the stamps failed")
            s = buf.reshape(-1, 5).astype(np.float64)
            phases = {"fill": s[:, 1] - s[:, 0], "main loop": s[:, 2] - s[:, 1],
                      "epilogue": s[:, 3] - s[:, 2]}
            gaps = []
            for sm in np.unique(s[:, 4]):
                r = s[s[:, 4] == sm]
                r = r[np.argsort(r[:, 0])]
                gaps += list(r[1:, 0] - r[:-1, 3])
            phases["gap between CTAs on an SM"] = np.asarray(gaps)
            span = (s[:, 3].max() - s[:, 0].min()) / 1e3
            print(f"  {build}: {ctas} CTAs on {len(np.unique(s[:, 4]))} SMs, span {span:.1f} us; "
                  + "; ".join(f"{p} p50 {np.percentile(v, 50) / 1e3:.2f} p90 "
                              f"{np.percentile(v, 90) / 1e3:.2f} us" for p, v in phases.items()))
    # the host's cost of a launch: back-to-back calls of each variant of the
    # tree's build at a small site (HRNet-W32's 256-wide branch), timed on
    # the host clock before the device catches up
    import time
    conv_int8._lib = lambda: libs["tree"]
    qx = torch.randint(-127, 128, (1, 26, 34, 256), generator=g, device=dev, dtype=torch.int8)
    qw = torch.randint(-127, 128, (256, 3, 3, 256), generator=g, device=dev, dtype=torch.int8)
    vec = torch.rand(256, generator=g, device=dev)
    line = []
    for variant in ("mma_sync", "wgmma", "wgmma", "mma_sync"):
        fn = lambda: conv_int8.conv_s8_cuda(qx, qw, None, vec, padding=1, out_kind="s8",
                                            variant=variant)
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        line.append(f"{variant} {host_us:.1f}")
    print("host us a call, 1x26x34x256 -> 256 3x3, s8 out (200 back-to-back calls): "
          + "; ".join(line))
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
