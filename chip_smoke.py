#!/usr/bin/env python3
"""Smoke run of the PyTorch port (densepose_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device and the CUDA
toolkit. Phases, each of which fails the run:

1. device: the card's name and power limit (torch and nvidia-smi);
2. build: every CUDA kernel of the port, one nvcc per source in parallel,
   with the ptxas register / shared-memory report;
3. kernel checks at the main paths' shapes (a 480x640 frame padded to
   800x1088): each kernel against its plain PyTorch version on the card,
   K1 (NMS) exactly at the RPN, box-stage and classed sites and at its edge
   cases (word edges, all invalid, all identical, zero area, a sweep across
   the threshold, three classes); K2 (ROIAlign) bit-identical at the box and
   DensePose poolers and within 1e-5 absolute at ratio 0 (adaptive) on the
   box pooler's inputs; K3 (the skip-flag ROIAlign, one launch a call)
   within 1e-5 of its plain version and 2e-5 of K2 on the same inputs, two
   runs bit-identical, at the box pooler and at the legacy DensePose pooler,
   and on its edge cases at 7x7 and 14x14 (K1's and K3's edge cases come
   from tests/torch_cases.py, which imports only numpy), with no stack frame
   or spills in ptxas; times per call from CUDA events around back-to-back
   calls (K1's mask and scan launches also apart; K2 on K3's inputs, and the
   ratio K3 / K2), printed beside the earlier design's times, each kernel's
   device time per call from torch.profiler (the same calls without the
   host's time between launches), and the least time the card could take
   (bytes over 3.35 TB/s or fp32 operations over 67 TFLOP/s, H100 SXM data
   sheet at 700 W); then K2 and K3 at float16 and bfloat16 on the same
   inputs, the levels rounded to the dtype: K2<T> bit-identical to K2<float>
   on the widened levels rounded to T and to its plain version at T (ratio 0:
   within one unit in the last place of T), K3<T> within one unit in the last
   place of T at the output's magnitude of its plain version at T, two runs
   the same bits, and at its edge cases; each timed as above (the bound at 2
   bytes an element) beside the upcast route it replaces (every level
   widened to float, the float kernel, the output rounded to T); and all six
   instantiations of K3 (and of K2) in ptxas, K3's with no stack frame or
   spills;
4. three paths, each at full width with random weights from seed 0: a
   DensePosePredictor answers a warm-up request and then distinct synthetic
   frames; outputs finite and of the expected shapes; the kernels' launch
   counters, set to 0 just before the timed requests and read just after,
   show the requests went through the path's kernels; then one more request
   under torch.profiler gives the device time of each stage range the model
   marks, the three device kernels that take the most time in the RPN and
   box-stage ranges, and the device's idle share. The paths:
   - the flagship densepose_rcnn_R_50_FPN_s1x: 2 K1 and 2 K2 per request
     (a K1 call is two kernel launches, mask and scan, counted once);
   - densepose_rcnn_R_101_FPN_s1x_legacy with DENSEPOSE_TPU_SPARSE_POOLER
     set: the box pooler and the multi-level DensePose pooler on K3, so 2 K1,
     0 K2 and 2 K3 per request;
   - densepose_rcnn_R_50_FPN_DL_s1x (DeepLab head) with
     TPU.DEVICE_POSTPROCESS: 2 K1 and 2 K2 per request, labels and UV out;
   - at half precision (TPU.COMPUTE_DTYPE), the flagship at float16 and the
     R101 legacy path at bfloat16, and, so that K2 and K3 run at both half
     types, DL at bfloat16 and R101 legacy at float16: detections and
     det_packed in fp32, the DensePose maps in the dtype.
   After the fp32 flagship's requests, one more with forward hooks prints
   the largest |output| of each stage (float16 ends at 65504). After the
   float16 flagship's, the DensePose stage at float16 on an fp32 request's
   features (cast) and boxes drifts under 0.5 std of the fp32 u-logits, and
   the whole request at float16 is printed against the fp32 one;
5. consumer, right after the flagship's, DL's and the float16 flagship's
   path phase (raw SIUV maps; a label map; float16 maps), each through the
   predictor its path built, on 8 distinct
   frames: the streaming loop of parallel/pipeline.py, frame by frame (frames
   staged through pinned memory, the overlay's maps fetched with
   start_fetch one frame behind) into the port's visualizer (the extractor
   and the native blends of native/fastvis.c, built with cc; the colormap
   table is built here, the machine has no cv2); each streamed frame's
   outputs bit-exact to numpy_outputs of blocking copies of the same outputs,
   2 K1 + 2 K2 launches per streamed frame, the overlays uint8 of the
   frame's shape; the frame served again, alone (a serial predict_numpy +
   visualize loop) and in pairs (predict_batch, batch 2), equal to the
   streamed one within SERVED_AGAIN_TOL (detections exact; labels and
   overlay pixels may differ at argmax near-ties, in at most TIE_SHARE of
   them); it prints ms per frame of both loops, host ms per frame of
   extraction + blend, bytes fetched per frame with the overlay's
   fetch_keys and without, and the differences of the frames served again;
6. reference: a narrowed flagship, and a narrowed R101 legacy model with the
   sparse pooler, on the card agree with the same models on the CPU (plain
   versions; tests/test_torch_*.py hold those against the JAX package); and
   the same at float16 (flagship) and bfloat16 (legacy), within the half
   tolerances of reference_check.

Prints a ``{"kernels": [...]}`` line with one entry per kernel and compute
dtype (K1 takes fp32 boxes at every dtype: one entry), the nvidia-smi line,
and as the last line ``{"ok": true, "device": {...}}``. Exits non-zero,
before that line, when there is no CUDA device or any phase fails.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_PER_S = 67e12      # fp32 outside the tensor cores, H100 SXM data sheet
FLAGSHIP = "densepose_rcnn_R_50_FPN_s1x"
LEGACY = "densepose_rcnn_R_101_FPN_s1x_legacy"
DEEPLAB = "densepose_rcnn_R_50_FPN_DL_s1x"
SPARSE_POOLER = "DENSEPOSE_TPU_SPARSE_POOLER"
FRAME_HW = (480, 640)
TIMED_REQUESTS = 3
K2_TOL = 1e-5
K3_TOL = 1e-5
K3_K2_TOL = 2e-5  # K3 sums the taps in another order (tests/test_ops.py:625)
SOURCES = {"nms_keep_cuda": "nms", "roi_align_cuda": "roi_align",
           "roi_align_sparse_cuda": "roi_align_sparse"}
HALF = ("float16", "bfloat16")  # TPU.COMPUTE_DTYPE's half types
EPS = {"float16": 2.0 ** -10, "bfloat16": 2.0 ** -7}  # a unit in the last place at 1
FP16_MAX = 65504.0
# per-site times of each kernel before its redesign for Hopper (K1: one CTA
# per NMS problem; K2: one thread per ROIAlign output; K3: a sort, a flags
# launch and one thread per output), as PERF.md section 6 records them with
# their runs, timed by cuda_ms as the kernels are here; printed beside the
# new times and kept out of the kernels line
EARLIER_CARD = "the earlier design, NVIDIA H100 80GB HBM3, 700.00 W"
EARLIER_MS = {("nms_keep_cuda", "rpn"): 0.7687, ("nms_keep_cuda", "box_stage"): 0.6472,
              ("roi_align_cuda", "box_pooler"): 0.2772,
              ("roi_align_cuda", "densepose_pooler"): 0.4051,
              ("roi_align_sparse_cuda", "box_pooler"): 0.7407,
              ("roi_align_sparse_cuda", "legacy_densepose_pooler"): 0.2710}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps=20):
    """Device time per call of ``fn``: the device events torch.profiler
    records over ``reps`` back-to-back calls, summed, over ``reps``. Unlike
    cuda_ms it leaves out the host's time between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / reps


def ulp(dtype, t):
    """One unit in the last place of ``dtype`` at the largest magnitude of
    tensor ``t`` (float32: 0)."""
    if dtype not in EPS or t.numel() == 0:
        return 0.0
    return EPS[dtype] * 2.0 ** np.floor(np.log2(max(float(t.abs().max()), 2.0 ** -14)))


def entry_name(kernel, dtype):
    """The kernels line's entry of a kernel at a compute dtype: K1 takes fp32
    boxes at every dtype (one entry); K2 and K3 one entry a dtype."""
    return kernel if dtype == "float32" or kernel == "nms_keep_cuda" else f"{kernel}[{dtype}]"


def path_dtype(extra):
    return dict(extra).get("TPU.COMPUTE_DTYPE", "float32")


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def main_path_shapes(cfg):
    from densepose_tpu_torch.models.rcnn import compute_resize, pad_to_divisible
    _, h1, w1 = compute_resize(*FRAME_HW, cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)
    hp, wp = pad_to_divisible(h1, w1)
    levels = {f"p{s}": (hp // 2 ** s, wp // 2 ** s) for s in (2, 3, 4, 5)}
    levels["p6"] = (-(-levels["p5"][0] // 2), -(-levels["p5"][1] // 2))
    return (hp, wp), levels


def clustered_boxes(rng, k, hw):
    """k boxes in clusters of 5 jittered copies, as RPN proposals around an
    object are: many IoUs near the thresholds."""
    n = -(-k // 5)
    ctr = rng.rand(n, 2) * (hw[1], hw[0])
    wh = np.exp(rng.uniform(np.log(16), np.log(512), size=(n, 2)))
    jitter = 1 + 0.15 * rng.randn(n, 5, 4)
    b = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1)[:, None, :] * jitter
    b = b.reshape(-1, 4)[:k]
    return np.concatenate([np.minimum(b[:, :2], b[:, 2:]), np.maximum(b[:, :2], b[:, 2:])],
                          1).astype(np.float32)


def torch_cases():
    """tests/torch_cases.py (numpy only: K1's and K3's edge cases), loaded by
    its path: an installed package named ``tests`` can shadow the repo's."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_cases.py")
    spec = importlib.util.spec_from_file_location("torch_cases", path)
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    return cases


def nms_work(boxes, valid, keep, thr, classes):
    """Bytes and operations greedy NMS needs on these inputs: each live box j
    is tested against every kept pivot before it, up to the one that
    suppresses it (13 fp32 operations per test)."""
    import torch
    from densepose_tpu_torch.ops.boxes import pairwise_iou
    p, k = valid.shape
    iou = pairwise_iou(boxes, boxes)                         # (P, i, j)
    idx = torch.arange(k, device=boxes.device)
    sup = (iou > thr) & keep[:, :, None] & (idx[:, None] < idx[None, :])
    if classes is not None:
        sup &= classes[:, :, None] == classes[:, None, :]
    first = torch.where(sup.any(1), sup.float().argmax(1), idx.expand(p, k) - 1)
    pivots = torch.cumsum(keep.int(), 1).gather(1, first.clamp(min=0)) * (first >= 0)
    tests = int((pivots * valid).sum())
    nbytes = p * k * (16 + 1 + 1 + (4 if classes is not None else 0))
    return nbytes, 13 * tests


def roi_align_work(feats, boxes, levels, scales, out_hw, ratio, aligned):
    """Bytes and operations ROIAlign needs on these inputs: every feature
    pixel some in-bound sample taps, read once, plus boxes, levels and the
    output, at the levels' element size; 12 operations per in-bound sample
    and channel, 1 per output. At ratio 0 the samples are each box's adaptive
    ones."""
    import torch
    from densepose_tpu_torch.ops.roi_align import box_samples
    c = feats[0].shape[0]
    hs = torch.tensor([f.shape[1] for f in feats], device=boxes.device)
    ws = torch.tensor([f.shape[2] for f in feats], device=boxes.device)
    offs = torch.cumsum(hs * ws, 0) - hs * ws
    lv = levels.long()
    sc = torch.tensor(scales, dtype=torch.float32, device=boxes.device)[lv]
    (ylo, yhi, _, yok), (xlo, xhi, _, xok), _, _ = box_samples(
        boxes, sc, hs[lv].float(), ws[lv].float(), out_hw, ratio, aligned)
    ok = (yok[:, :, None] & xok[:, None, :]).reshape(-1)
    taps = []
    for y in (ylo, yhi):
        for x in (xlo, xhi):
            flat = offs[lv][:, None, None] + y[:, :, None] * ws[lv][:, None, None] + x[:, None, :]
            taps.append(flat.reshape(-1)[ok])
    pixels = torch.unique(torch.cat(taps)).numel()
    m = boxes.shape[0]
    out = m * out_hw[0] * out_hw[1] * c
    esize = feats[0].element_size()
    nbytes = pixels * c * esize + m * 20 + out * esize
    return nbytes, 12 * int(ok.sum()) * c + out


def check_k3(torch, args, what, nondegenerate=True):
    """K3 on ``args`` against its plain version (K3_TOL) and K2 (K3_K2_TOL),
    two calls bit-identical. Returns both max abs errors."""
    from densepose_tpu_torch.ops import roi_align, roi_align_sparse
    got = roi_align_sparse.roi_align_sparse_cuda(*args)
    again = roi_align_sparse.roi_align_sparse_cuda(*args)
    want = roi_align_sparse.roi_align_sparse_plain(*args)
    gather = roi_align.roi_align_cuda(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    err_k2 = float((got - gather).abs().max())
    check(err <= K3_TOL, f"{what}: max abs error {err} > {K3_TOL}")
    check(err_k2 <= K3_K2_TOL, f"{what}: differs from K2 by {err_k2} > {K3_K2_TOL}")
    check(torch.equal(got, again), f"{what}: two runs differ")
    check(not nondegenerate or float(want.abs().max()) > 0.1,
          f"{what}: degenerate test (all zero)")
    return err, err_k2


def kernel_checks(torch, cfg, report, dev):
    from densepose_tpu_torch.model_zoo import get_config
    from densepose_tpu_torch.ops import nms, roi_align, roi_align_sparse
    (hp, wp), levels = main_path_shapes(cfg)
    rng = np.random.RandomState(0)

    # K1 at its two main-path sites, plus a classed problem
    rpn_k = cfg.MODEL.RPN.PRE_NMS_TOPK_TEST
    counts = [min(h * w * 3, rpn_k) for h, w in levels.values()]
    sites = [
        ("rpn", len(counts), rpn_k, counts, cfg.MODEL.RPN.NMS_THRESH, False),
        ("box_stage", 1, cfg.MODEL.RPN.POST_NMS_TOPK_TEST * cfg.MODEL.ROI_HEADS.NUM_CLASSES,
         None, cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST, False),
        ("classed", 1, 1000, None, 0.5, True),
    ]
    k1 = []
    for site, p, k, valid_counts, thr, classed in sites:
        b = torch.from_numpy(np.stack([clustered_boxes(rng, k, (hp, wp)) for _ in range(p)])).to(dev)
        v = torch.from_numpy(rng.rand(p, k) > 0.05).to(dev)
        if valid_counts is not None:
            v &= torch.arange(k, device=dev)[None] < torch.tensor(valid_counts, device=dev)[:, None]
        c = torch.from_numpy(rng.randint(0, 3, size=(p, k)).astype(np.int32)).to(dev) if classed else None
        got = nms.nms_keep_cuda(b, v, thr, c)
        want = nms.nms_keep_plain(b, v, thr, c)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        check(mismatches == 0, f"K1 {site}: {mismatches} keep flags differ from the plain version")
        check(0 < int(want.sum()) < int(v.sum()), f"K1 {site}: degenerate test (nothing suppressed)")
        ms = cuda_ms(lambda: nms.nms_keep_cuda(b, v, thr, c), reps=50)
        dev_ms = device_ms(torch, lambda: nms.nms_keep_cuda(b, v, thr, c))
        # the two launches apart, on scratch the timed calls reuse
        mask = torch.empty((p, k, nms.mask_words(k)), dtype=torch.int64, device=dev)
        keep = torch.empty((p, k), dtype=torch.bool, device=dev)
        mask_ms = cuda_ms(lambda: nms.nms_mask_launch(b, v, thr, c, mask), reps=50)
        scan_ms = cuda_ms(lambda: nms.nms_scan_launch(mask, v, keep), reps=50)
        check(torch.equal(keep, want), f"K1 {site}: the scan alone differs from the plain version")
        plain_ms = cuda_ms(lambda: nms.nms_keep_plain(b, v, thr, c), reps=5, warmup=1)
        bound_ms, bound_by = bound(*nms_work(b, v, want, thr, c))
        was = EARLIER_MS.get(("nms_keep_cuda", site))
        k1.append({"site": site, "shape": [p, k], "kept": int(want.sum()), "max_abs_err": 0.0,
                   "ms": ms, "device_ms": dev_ms, "mask_ms": mask_ms, "scan_ms": scan_ms,
                   "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"K1 nms_keep_cuda {site} P={p} K={k} iou>{thr}: exact ({int(want.sum())} kept); "
              f"{ms:.4f} ms (mask launch {mask_ms:.4f}, scan launch {scan_ms:.4f}; device "
              f"{dev_ms:.4f})"
              + (f", was {was:.4f} ms ({EARLIER_CARD})" if was else "")
              + f"; plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})")
    edge = torch_cases().k1_edge_cases()
    for name, eb, ev, ec, thr in edge:
        b = torch.from_numpy(eb)[None].to(dev)
        v = torch.from_numpy(ev)[None].to(dev)
        c = None if ec is None else torch.from_numpy(ec)[None].to(dev)
        got = nms.nms_keep_cuda(b, v, thr, c)
        want = nms.nms_keep_plain(b, v, thr, c)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K1 edge case {name}: {int((got != want).sum())} keep "
              "flags differ from the plain version")
    print(f"K1 nms_keep_cuda edge cases: {len(edge)} exact "
          f"({', '.join(name for name, *_ in edge)})")

    # K2 at its two main-path sites, the 4-level box pooler and the DensePose
    # pooler, bit-identical; and at ratio 0 on the box pooler's inputs
    c = cfg.MODEL.FPN.OUT_CHANNELS
    pyramid = [torch.randn(c, h, w, device=dev) for f, (h, w) in levels.items() if f != "p6"]
    scales = [1 / 4, 1 / 8, 1 / 16, 1 / 32]
    box_m = cfg.MODEL.RPN.POST_NMS_TOPK_TEST
    boxes = torch.from_numpy(clustered_boxes(rng, box_m, (hp, wp))).to(dev)
    boxes = torch.stack([boxes[:, 0].clamp(0, wp), boxes[:, 1].clamp(0, hp),
                         boxes[:, 2].clamp(0, wp), boxes[:, 3].clamp(0, hp)], 1)
    lv = roi_align.assign_boxes_to_levels(boxes, 2, 5)
    dp = cfg.MODEL.ROI_DENSEPOSE_HEAD
    res_b, res_d = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION, dp.POOLER_RESOLUTION
    det = boxes[:cfg.TEST.DETECTIONS_PER_IMAGE].contiguous()
    sites = [
        ("box_pooler", pyramid, boxes, lv, scales, (res_b, res_b),
         cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO, 0.0),
        ("densepose_pooler", pyramid[:1], det,
         torch.zeros(det.shape[0], dtype=torch.int32, device=dev), scales[:1], (res_d, res_d),
         dp.POOLER_SAMPLING_RATIO, 0.0),
        ("box_pooler_ratio0", pyramid, boxes, lv, scales, (res_b, res_b), 0, K2_TOL),
    ]
    k2 = []
    for site, feats, b, l, sc, out_hw, ratio, tol in sites:
        got = roi_align.roi_align_cuda(feats, b, l, sc, out_hw, ratio, False)
        want = roi_align.roi_align_plain(feats, b, l, sc, out_hw, ratio, False)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if tol == 0.0:
            check(torch.equal(got, want), f"K2 {site}: not bit-identical to the plain version "
                  f"(max abs error {err})")
        check(err <= tol, f"K2 {site}: max abs error {err} > {tol}")
        check(float(want.abs().max()) > 0.1, f"K2 {site}: degenerate test (all zero)")
        ms = cuda_ms(lambda: roi_align.roi_align_cuda(feats, b, l, sc, out_hw, ratio, False),
                     reps=20)
        dev_ms = device_ms(torch, lambda: roi_align.roi_align_cuda(feats, b, l, sc, out_hw,
                                                                   ratio, False))
        plain_ms = cuda_ms(lambda: roi_align.roi_align_plain(feats, b, l, sc, out_hw, ratio,
                                                             False), reps=3, warmup=1)
        bound_ms, bound_by = bound(*roi_align_work(feats, b, l, sc, out_hw, ratio, False))
        was = EARLIER_MS.get(("roi_align_cuda", site))
        k2.append({"site": site, "shape": [b.shape[0], c, *out_hw], "ratio": ratio,
                   "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms,
                   "bound_by": bound_by})
        print(f"K2 roi_align_cuda {site} M={b.shape[0]} {out_hw} C={c} levels={len(feats)} "
              f"ratio={ratio}: " + ("bit-identical" if tol == 0.0 else
                                    f"max abs err {err:.3e} (tol {tol})")
              + f"; {ms:.4f} ms (device {dev_ms:.4f})"
              + (f", was {was:.4f} ms ({EARLIER_CARD})" if was else "")
              + f"; plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})")

    # K3 at its two sites on the legacy path: the box pooler (K2's inputs
    # above) and the multi-level DensePose pooler, 100 detections at 14x14
    legacy_dp = get_config(LEGACY).MODEL.ROI_DENSEPOSE_HEAD
    k3 = []
    k3_sites = [
        ("box_pooler", boxes, (res_b, res_b), cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO),
        ("legacy_densepose_pooler", det,
         (legacy_dp.POOLER_RESOLUTION, legacy_dp.POOLER_RESOLUTION),
         legacy_dp.POOLER_SAMPLING_RATIO)]
    for site, b, out_hw, ratio in k3_sites:
        l = roi_align.assign_boxes_to_levels(b, 2, 5)
        args = (pyramid, b, l, scales, out_hw, ratio, False)
        err, err_k2 = check_k3(torch, args, f"K3 {site}")
        ms = cuda_ms(lambda: roi_align_sparse.roi_align_sparse_cuda(*args), reps=20)
        k2_ms = cuda_ms(lambda: roi_align.roi_align_cuda(*args), reps=20)
        dev_ms = device_ms(torch, lambda: roi_align_sparse.roi_align_sparse_cuda(*args))
        k2_dev_ms = device_ms(torch, lambda: roi_align.roi_align_cuda(*args))
        plain_ms = cuda_ms(lambda: roi_align_sparse.roi_align_sparse_plain(*args), reps=3,
                           warmup=1)
        bound_ms, bound_by = bound(*roi_align_work(*args))
        was = EARLIER_MS[("roi_align_sparse_cuda", site)]
        k3.append({"site": site, "shape": [b.shape[0], c, *out_hw], "levels": len(pyramid),
                   "max_abs_err": err, "max_abs_err_vs_k2": err_k2, "ms": ms, "k2_ms": k2_ms,
                   "k3_over_k2": ms / k2_ms, "device_ms": dev_ms, "k2_device_ms": k2_dev_ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by})
        print(f"K3 roi_align_sparse_cuda {site} M={b.shape[0]} {out_hw} C={c} "
              f"levels={len(pyramid)}: max abs err {err:.3e} (tol {K3_TOL}), vs K2 "
              f"{err_k2:.3e} (tol {K3_K2_TOL}); {ms:.4f} ms, was {was:.4f} ms ({EARLIER_CARD}); "
              f"K2 on the same inputs {k2_ms:.4f} ms, K3 / K2 {ms / k2_ms:.3f}; device "
              f"{dev_ms:.4f} ms, K2 {k2_dev_ms:.4f}, K3 / K2 {dev_ms / k2_dev_ms:.3f}; "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})")
    # K3's edge cases on the same pyramid, at both sites' output sizes
    edge3 = torch_cases().k3_edge_cases((hp, wp))
    worst = 0.0
    for name, eb, elv in edge3:
        for out_hw, aligned in [((res_b, res_b), False),
                                ((legacy_dp.POOLER_RESOLUTION,) * 2, True)]:
            args = (pyramid, torch.from_numpy(eb).to(dev), torch.from_numpy(elv).to(dev), scales,
                    out_hw, 2, aligned)
            worst = max(worst, *check_k3(torch, args, f"K3 edge case {name} {out_hw}",
                                         nondegenerate=False))
    print(f"K3 roi_align_sparse_cuda edge cases: {len(edge3)} at {res_b}x{res_b} and "
          f"{legacy_dp.POOLER_RESOLUTION}x{legacy_dp.POOLER_RESOLUTION}, max abs err {worst:.3e} "
          f"({', '.join(name for name, *_ in edge3)})")

    half = {dtype: kernel_checks_half(torch, dtype, sites, k3_sites, edge3, pyramid, scales,
                                      (res_b, legacy_dp.POOLER_RESOLUTION))
            for dtype in HALF}

    main = {"nms_keep_cuda": k1[:2], "roi_align_cuda": k2[:2], "roi_align_sparse_cuda": k3}
    for name, entries, route_src, replaces, tol in [
        ("nms_keep_cuda", k1, "densepose_tpu_torch/csrc/nms.cu",
         "densepose_tpu/ops/pallas/nms_kernel.py:30", f"exact, and at {len(edge)} edge cases"),
        ("roi_align_cuda", k2, "densepose_tpu_torch/csrc/roi_align.cu",
         "densepose_tpu/ops/pallas/roi_align_kernel.py:54",
         f"bit-identical; ratio 0 max_abs_err<={K2_TOL}"),
        ("roi_align_sparse_cuda", k3, "densepose_tpu_torch/csrc/roi_align_sparse.cu",
         "densepose_tpu/ops/pallas/roi_align_kernel.py:159",
         f"max_abs_err<={K3_TOL}, vs K2 <={K3_K2_TOL}, two runs equal, and at "
         f"{len(edge3)} edge cases"),
    ]:
        per_request = main[name]  # one launch per main-path site and request
        report[name] = {
            "name": name, "route": "cuda", "source": route_src, "replaces": replaces,
            "check": tol,
            "launches": 0,
            "launches_per_path": {},
            "max_abs_err": max(e["max_abs_err"] for e in entries),
            "ms": sum(e["ms"] for e in per_request),
            "device_ms": sum(e["device_ms"] for e in per_request),
            "plain_ms": sum(e["plain_ms"] for e in per_request),
            "bound_ms": sum(e["bound_ms"] for e in per_request),
            "bound_by": max(per_request, key=lambda e: e["bound_ms"])["bound_by"],
            "library_ms": None,
            "dtype": "float32",
            "sites": entries,
        }
    for dtype, (k2h, k3h) in half.items():
        for name, entries, route_src, replaces, tol in [
            ("roi_align_cuda", k2h, "densepose_tpu_torch/csrc/roi_align.cu",
             "densepose_tpu/ops/pallas/roi_align_kernel.py:54",
             f"bit-identical to K2<float> on the widened levels rounded to {dtype}, and to "
             "the plain version (ratio 0: within 1 ulp)"),
            ("roi_align_sparse_cuda", k3h, "densepose_tpu_torch/csrc/roi_align_sparse.cu",
             "densepose_tpu/ops/pallas/roi_align_kernel.py:159",
             f"within 1 ulp of {dtype} at the output's magnitude of the plain version, two "
             f"runs equal, and at {len(edge3)} edge cases"),
        ]:
            per_request = entries[:2]
            report[entry_name(name, dtype)] = {
                "name": entry_name(name, dtype), "route": "cuda", "source": route_src,
                "replaces": replaces, "check": tol, "launches": 0, "launches_per_path": {},
                "max_abs_err": max(e["max_abs_err"] for e in entries),
                "ms": sum(e["ms"] for e in per_request),
                "device_ms": sum(e["device_ms"] for e in per_request),
                "plain_ms": sum(e["plain_ms"] for e in per_request),
                "bound_ms": sum(e["bound_ms"] for e in per_request),
                "bound_by": max(per_request, key=lambda e: e["bound_ms"])["bound_by"],
                "library_ms": None,
                "dtype": dtype,
                "upcast_ms": sum(e["upcast_ms"] for e in per_request),
                "upcast_device_ms": sum(e["upcast_device_ms"] for e in per_request),
                "sites": entries,
            }


def kernel_checks_half(torch, dtype, k2_sites, k3_sites, edge3, pyramid, scales, res):
    """K2 and K3 at a half dtype on the fp32 sites' inputs, the levels
    rounded to ``dtype``: K2<T> bit-identical to K2<float> on the widened
    levels rounded to T, and to its plain version at T (ratio 0: within one
    ulp of T); K3<T> within one ulp of T at the output's magnitude of its
    plain version, two runs the same bits, and on the edge cases. Times each
    as the fp32 sites are timed, with the bound at the dtype's 2 bytes an
    element, and the alternative to the half load: every level widened to
    float, the float kernel, the output rounded to T (``upcast_ms``)."""
    from densepose_tpu_torch.ops import roi_align, roi_align_sparse
    t = getattr(torch, dtype)
    levels_t = [f.to(t) for f in pyramid]
    k2h, k3h = [], []
    for site, feats, b, l, sc, out_hw, ratio, _ in k2_sites:
        feats = levels_t[:len(feats)]
        args = (b, l, sc, out_hw, ratio, False)
        got = roi_align.roi_align_cuda(feats, *args)
        upcast = roi_align.roi_align_cuda([f.float() for f in feats], *args).to(t)
        want = roi_align.roi_align_plain(feats, *args)
        torch.cuda.synchronize()
        check(got.dtype == t, f"K2 {site} {dtype}: output {got.dtype}")
        gap = float((got.float() - upcast.float()).abs().max())
        check(torch.equal(got, upcast), f"K2 {site} {dtype}: not bit-identical to K2<float> on "
              f"the widened levels, rounded (max abs {gap})")
        err = float((got.float() - want.float()).abs().max())
        if ratio:
            check(torch.equal(got, want), f"K2 {site} {dtype}: not bit-identical to the plain "
                  f"version (max abs error {err})")
        check(err <= ulp(dtype, want), f"K2 {site} {dtype}: max abs error {err} > 1 ulp")
        ms = cuda_ms(lambda: roi_align.roi_align_cuda(feats, *args), reps=20)
        dev_ms = device_ms(torch, lambda: roi_align.roi_align_cuda(feats, *args))

        def upcast_route():
            return roi_align.roi_align_cuda([f.float() for f in feats], *args).to(t)

        up_ms = cuda_ms(upcast_route, reps=20)
        up_dev_ms = device_ms(torch, upcast_route)
        plain_ms = cuda_ms(lambda: roi_align.roi_align_plain(feats, *args), reps=3, warmup=1)
        bound_ms, bound_by = bound(*roi_align_work(feats, *args))
        k2h.append({"site": site, "shape": [b.shape[0], feats[0].shape[0], *out_hw],
                    "ratio": ratio, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                    "upcast_ms": up_ms, "upcast_device_ms": up_dev_ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"K2 roi_align_cuda<{dtype}> {site} M={b.shape[0]} {out_hw} ratio={ratio}: "
              f"bit-identical to K2<float> on the widened levels, rounded; vs plain max abs err "
              f"{err:.3e}; {ms:.4f} ms (device {dev_ms:.4f}); upcast route (levels to float, "
              f"K2<float>, output to {dtype}) {up_ms:.4f} ms (device {up_dev_ms:.4f}); plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})")
    for site, b, out_hw, ratio in k3_sites:
        l = roi_align.assign_boxes_to_levels(b, 2, 5)
        args = (levels_t, b, l, scales, out_hw, ratio, False)
        err, err_k2 = check_k3_half(torch, dtype, args, f"K3 {site} {dtype}")
        ms = cuda_ms(lambda: roi_align_sparse.roi_align_sparse_cuda(*args), reps=20)
        dev_ms = device_ms(torch, lambda: roi_align_sparse.roi_align_sparse_cuda(*args))

        def upcast_route():
            return roi_align_sparse.roi_align_sparse_cuda(
                [f.float() for f in levels_t], *args[1:]).to(t)

        up_ms = cuda_ms(upcast_route, reps=20)
        up_dev_ms = device_ms(torch, upcast_route)
        k2_ms = cuda_ms(lambda: roi_align.roi_align_cuda(*args), reps=20)
        plain_ms = cuda_ms(lambda: roi_align_sparse.roi_align_sparse_plain(*args), reps=3,
                           warmup=1)
        bound_ms, bound_by = bound(*roi_align_work(*args))
        k3h.append({"site": site, "shape": [b.shape[0], levels_t[0].shape[0], *out_hw],
                    "levels": len(levels_t), "max_abs_err": err, "max_abs_err_vs_k2": err_k2,
                    "ms": ms, "device_ms": dev_ms, "upcast_ms": up_ms,
                    "upcast_device_ms": up_dev_ms, "k2_ms": k2_ms, "k3_over_k2": ms / k2_ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"K3 roi_align_sparse_cuda<{dtype}> {site} M={b.shape[0]} {out_hw}: max abs err "
              f"{err:.3e} (tol 1 ulp), vs K2<{dtype}> {err_k2:.3e}; {ms:.4f} ms (device "
              f"{dev_ms:.4f}); upcast route {up_ms:.4f} ms (device {up_dev_ms:.4f}); K2 on the "
              f"same inputs {k2_ms:.4f} ms, K3 / K2 {ms / k2_ms:.3f}; plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.6f} ms ({bound_by})")
    worst = 0.0
    for name, eb, elv in edge3:
        for out_hw, aligned in [((res[0],) * 2, False), ((res[1],) * 2, True)]:
            dev = levels_t[0].device
            args = (levels_t, torch.from_numpy(eb).to(dev), torch.from_numpy(elv).to(dev), scales,
                    out_hw, 2, aligned)
            worst = max(worst, check_k3_half(torch, dtype, args,
                                             f"K3 edge case {name} {out_hw} {dtype}")[0])
    print(f"K3 roi_align_sparse_cuda<{dtype}> edge cases: {len(edge3)} at {res[0]}x{res[0]} and "
          f"{res[1]}x{res[1]}, max abs err {worst:.3e} (tol 1 ulp)")
    return k2h, k3h


def check_k3_half(torch, dtype, args, what):
    """K3<T> on ``args`` (levels of dtype T) against its plain version at T
    (within one ulp of T at its output's magnitude), two calls bit-identical.
    Returns the max abs errors against the plain version and K2<T>."""
    from densepose_tpu_torch.ops import roi_align, roi_align_sparse
    got = roi_align_sparse.roi_align_sparse_cuda(*args)
    again = roi_align_sparse.roi_align_sparse_cuda(*args)
    want = roi_align_sparse.roi_align_sparse_plain(*args)
    gather = roi_align.roi_align_cuda(*args)
    torch.cuda.synchronize()
    check(got.dtype == want.dtype == getattr(torch, dtype), f"{what}: output {got.dtype}")
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    err_k2 = float((got.float() - gather.float()).abs().max()) if got.numel() else 0.0
    check(err <= ulp(dtype, want), f"{what}: max abs error {err} > 1 ulp "
          f"({ulp(dtype, want)})")
    check(torch.equal(got, again), f"{what}: two runs differ")
    return err, err_k2


def frames(seed, n):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        img = rng.randint(0, 256, size=(*FRAME_HW, 3)).astype(np.uint8)
        # a smooth blob so the frames are not pure noise
        yy, xx = np.mgrid[:FRAME_HW[0], :FRAME_HW[1]]
        cy, cx = rng.rand(2) * FRAME_HW
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 80.0 ** 2))
        out.append(np.clip(img * 0.3 + blob[..., None] * 180, 0, 255).astype(np.uint8))
    return out


def path_config(name, extra=()):
    from densepose_tpu_torch.model_zoo import get_config
    cfg = get_config(name).clone()
    cfg.defrost()
    for key, value in extra:
        *path, leaf = key.split(".")
        node = cfg
        for p in path:
            node = node[p]
        node[leaf] = value
    cfg.freeze()
    return cfg


# (zoo name, config changes, DENSEPOSE_TPU_SPARSE_POOLER set, launches per request)
ON_K2 = {"nms_keep_cuda": 2, "roi_align_cuda": 2, "roi_align_sparse_cuda": 0}
ON_K3 = {"nms_keep_cuda": 2, "roi_align_cuda": 0, "roi_align_sparse_cuda": 2}
FP16 = (("TPU.COMPUTE_DTYPE", "float16"),)
BF16 = (("TPU.COMPUTE_DTYPE", "bfloat16"),)
PATHS = [
    (FLAGSHIP, (), False, ON_K2),
    (LEGACY, (), True, ON_K3),
    (DEEPLAB, (("TPU.DEVICE_POSTPROCESS", True),), False, ON_K2),
    # the half paths: the flagship at float16, R101 legacy at bfloat16; and the
    # other two (kernel, dtype) pairs, so that every one is driven
    (FLAGSHIP, FP16, False, ON_K2),
    (LEGACY, BF16, True, ON_K3),
    (DEEPLAB, (("TPU.DEVICE_POSTPROCESS", True),) + BF16, False, ON_K2),
    (LEGACY, FP16, True, ON_K3),
]


def drive_path(torch, report, dev, name, extra, sparse, per_request):
    """One path at full width: a warm-up request, timed requests with the
    launch counters set to 0 just before and read just after, output checks,
    then one profiled request. Returns the predictor."""
    from densepose_tpu_torch.ops import nms, roi_align, roi_align_sparse
    from densepose_tpu_torch.predictor import DensePosePredictor
    counters = {"nms_keep_cuda": nms.nms_keep_cuda, "roi_align_cuda": roi_align.roi_align_cuda,
                "roi_align_sparse_cuda": roi_align_sparse.roi_align_sparse_cuda}

    cfg = path_config(name, extra)
    tag = name + (f" with {SPARSE_POOLER}=1" if sparse else "") + "".join(
        f", {k}={v}" for k, v in extra)
    t0 = time.perf_counter()
    pred = DensePosePredictor(cfg, seed=0, device=dev)
    print(f"path {tag}: built with random weights (seed 0) in "
          f"{time.perf_counter() - t0:.1f} s")
    warm, *timed = frames(1, 1 + TIMED_REQUESTS)
    if sparse:
        os.environ[SPARSE_POOLER] = "1"
    try:
        pred(warm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        outs, lat = [], []
        for img in timed:
            t0 = time.perf_counter()
            out = pred(img)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
        launches = {k: fn.launches for k, fn in counters.items()}
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        breakdown(torch, pred, timed[0], float(np.median(lat)))
    finally:
        os.environ.pop(SPARSE_POOLER, None)

    n_req = len(timed)
    dtype = path_dtype(extra)
    for k, n in per_request.items():
        check(launches[k] == n * n_req, f"{name}: {launches[k]} {k} launches for {n_req} "
              f"requests, expected {n} per request")
        report[entry_name(k, dtype)]["launches"] += launches[k]
        report[entry_name(k, dtype)]["launches_per_path"][tag] = launches[k]
    d = cfg.TEST.DETECTIONS_PER_IMAGE
    dp = cfg.MODEL.ROI_DENSEPOSE_HEAD
    heat = dp.POOLER_RESOLUTION * 2 * dp.UP_SCALE  # deconv stride 2, then the upsample
    channels = {"coarse_segm": dp.NUM_COARSE_SEGM_CHANNELS, "fine_segm": dp.NUM_PATCHES + 1,
                "u": dp.NUM_PATCHES + 1, "v": dp.NUM_PATCHES + 1}
    half = getattr(torch, dtype)
    for i, out in enumerate(outs):
        res = pred.numpy_outputs(out)
        n = res["num_instances"]
        check(n >= 1, f"{name} request {i}: no detections")
        check(out["pred_boxes"].shape == (d, 4), f"request {i}: pred_boxes {out['pred_boxes'].shape}")
        for k in ("pred_boxes", "scores", "det_packed"):
            check(out[k].dtype == torch.float32, f"{tag} request {i}: {k} {out[k].dtype}")
        for k, v in out.items():
            if k.startswith("pred_densepose_") and k not in ("pred_densepose_labels",
                                                             "pred_densepose_uv"):
                check(v.dtype == half, f"{tag} request {i}: {k} {v.dtype}, not {dtype}")
        if cfg.TPU.DEVICE_POSTPROCESS:
            check(out["pred_densepose_labels"].dtype == torch.uint8
                  and out["pred_densepose_labels"].shape == (d, heat, heat),
                  f"{name} request {i}: labels {out['pred_densepose_labels'].dtype} "
                  f"{tuple(out['pred_densepose_labels'].shape)}")
            check(out["pred_densepose_uv"].dtype == torch.float16
                  and out["pred_densepose_uv"].shape == (d, heat, heat, 2),
                  f"{name} request {i}: uv {out['pred_densepose_uv'].dtype} "
                  f"{tuple(out['pred_densepose_uv'].shape)}")
            check(res["pred_densepose_labels"].shape == (n, heat, heat)
                  and res["pred_densepose_uv"].shape == (n, 2, heat, heat),
                  f"{name} request {i}: trimmed labels / uv shapes")
            check(int(res["pred_densepose_labels"].max()) <= dp.NUM_PATCHES,
                  f"{name} request {i}: label beyond {dp.NUM_PATCHES}")
            check(not any(f"pred_densepose_{k}" in res for k in channels),
                  f"{name} request {i}: SIUV maps left beside labels and uv")
            shape = tuple(res["pred_densepose_uv"].shape)
        else:
            for k, ch in channels.items():
                v = res[f"pred_densepose_{k}"]
                check(v.shape == (n, ch, heat, heat), f"{name} request {i}: "
                      f"pred_densepose_{k} shape {v.shape}, expected {(n, ch, heat, heat)}")
            shape = tuple(res["pred_densepose_u"].shape)
        for k, v in res.items():
            if isinstance(v, np.ndarray) and v.dtype.kind == "f":
                check(np.isfinite(v).all(), f"{name} request {i}: non-finite {k}")
        print(f"path {tag}: request {i}: {lat[i]:.2f} ms, num_instances {n}, "
              f"{'uv' if cfg.TPU.DEVICE_POSTPROCESS else 'SIUV'} {shape}")
    print(f"path {tag}: {n_req} requests of {FRAME_HW[0]}x{FRAME_HW[1]} frames: latency ms "
          f"{', '.join(f'{x:.2f}' for x in lat)} (median {np.median(lat):.2f}); "
          f"kernel launches {launches}; max memory allocated {peak_mib:.1f} MiB")
    del outs
    torch.cuda.empty_cache()
    return pred


# the profiler ranges GeneralizedRCNN.forward runs its stages in (rcnn.py,
# roi_heads.py::densepose_stage_forward)
STAGES = ("preprocess", "backbone", "rpn", "box_stage", "postprocess", "decoder",
          "densepose_pooler", "densepose_head", "densepose_predictor", "densepose_pad",
          "densepose_postprocess")


TOP_KERNEL_STAGES = ("rpn", "box_stage")


def short_kernel_name(name):
    """A device kernel's name without its argument list and namespaces."""
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):  # cut at the argument list, outside template brackets
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name.removeprefix("void ")[:100]


def breakdown(torch, pred, img, latency_ms):
    """One more request under torch.profiler: the device time of each stage
    range, and the device's idle share, both over the profiled request's wall
    time and over ``latency_ms`` (an unprofiled request's); for the RPN and
    box-stage ranges also the three device kernels that take the most time.
    Prints "not measured" when the profiler sees no device activity.

    A device event belongs to the stage whose range holds the host call that
    launched it (matched by correlation id): the profiler links kernels only
    to PyTorch ops, and the port's kernels are launched through ctypes. The
    host wall time of each stage range is printed beside its device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("request"):
            pred(img)
            torch.cuda.synchronize()
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    wall_ms = next(e for e in host if e.name == "request").time_range.elapsed_us() / 1e3
    # kernels and copies; the profiler also mirrors each range on the device
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name not in STAGES + ("request",)]
    if not device:
        print("breakdown: not measured (the profiler saw no device activity)")
        return
    launched_at = {e.id: e.time_range.start for e in host if e.name.startswith("cu")}
    ranges = [(e.time_range.start, e.time_range.end, e.name) for e in host if e.name in STAGES]
    stages = dict.fromkeys(STAGES, 0.0)
    host_ms = dict.fromkeys(STAGES, 0.0)
    by_kernel = {s: {} for s in TOP_KERNEL_STAGES}
    for s, end, n in ranges:
        host_ms[n] += (end - s) / 1e3
    outside = 0.0
    for e in device:
        t = launched_at.get(e.id)
        stage = next((n for s, end, n in ranges if t is not None and s <= t <= end), None)
        ms = e.time_range.elapsed_us() / 1e3
        if stage is None:
            outside += ms
        else:
            stages[stage] += ms
        if stage in by_kernel:
            name = short_kernel_name(e.name)
            by_kernel[stage][name] = by_kernel[stage].get(name, 0.0) + ms
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    busy_ms = busy_us / 1e3
    parts = ", ".join(f"{s} {ms:.3f}" for s, ms in stages.items())
    walls = ", ".join(f"{s} {ms:.3f}" for s, ms in host_ms.items())
    print(f"breakdown (device ms per stage, torch.profiler, {len(device)} device events): "
          f"{parts}; host wall ms per stage range: {walls}; outside the ranges "
          f"{outside:.3f}; device busy {busy_ms:.3f} of {wall_ms:.3f} ms profiled wall (idle share {1 - busy_ms / wall_ms:.4f}); of an "
          f"unprofiled request's {latency_ms:.3f} ms: idle share {1 - busy_ms / latency_ms:.4f}")
    for stage, kernels in by_kernel.items():
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:3]
        print(f"breakdown {stage}: top device kernels (ms of {stages[stage]:.3f}): "
              + "; ".join(f"{name} {ms:.3f}" for name, ms in top))


# the consumer phase: the paths it streams, each right after its path phase
# with the predictor drive_path built, and the frames per run
CONSUMER_PATHS = ((FLAGSHIP, "float32"), (DEEPLAB, "float32"), (FLAGSHIP, "float16"))
CONSUMER_FRAMES = 8


def chip_colormap():
    """A (256, 3) uint8 BGR colormap table, built here: the GPU machine has no
    cv2 to expand a cv2 colormap id."""
    i = np.arange(256)
    return np.stack([255 - i, (i * 3) % 256, i], 1).astype(np.uint8)


class RecordingVisualizer:
    """Wraps a visualizer: keeps each frame's host outputs and the host time
    of each ``visualize`` (extraction + blend), and asks for its fetch keys."""

    def __init__(self, visualizer):
        self.visualizer = visualizer
        self.outs, self.ms = [], []

    def fetch_keys(self):
        return self.visualizer.fetch_keys()

    def visualize(self, frame, outputs):
        self.outs.append(outputs)
        t0 = time.perf_counter()
        out = self.visualizer.visualize(frame, outputs)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


class KeepOutputs:
    """Wraps a predictor for the streaming loop and keeps every output dict
    its ``__call__`` serves; everything else goes to the predictor."""

    def __init__(self, pred):
        self.pred, self.outs = pred, []

    def __call__(self, image):
        out = self.pred(image)
        self.outs.append(out)
        return out

    def __getattr__(self, name):
        return getattr(self.pred, name)


def same_outputs(a, b):
    return sorted(a) == sorted(b) and all(
        np.asarray(a[k]).dtype == np.asarray(b[k]).dtype and np.array_equal(a[k], b[k])
        for k in a)


# A frame served again may differ in the last bits of its maps: cuDNN's
# transposed convolutions (the DensePose predictor) add with atomics. The maps
# are held to the bound reference_check holds the card to against the fp32 CPU
# run, a float16 map (the UV map; every map at TPU.COMPUTE_DTYPE float16) to
# that plus one float16 rounding; the detections come before those
# convolutions and stay exact. A label map, and an overlay, may differ where an
# argmax is near a tie, in at most TIE_SHARE of its pixels (the share
# tests/test_torch_cli.py allows against the JAX package).
SERVED_AGAIN_TOL = 1e-3
TIE_SHARE = 1e-3


def served_again(a, b, what):
    """Checks two host outputs of one frame, served apart, against each other
    (see SERVED_AGAIN_TOL); returns (max abs difference of the float maps,
    share of label pixels that differ)."""
    check(sorted(a) == sorted(b), f"{what}: keys {sorted(a)} vs {sorted(b)}")
    err = share = 0.0
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        check(x.dtype == y.dtype and x.shape == y.shape,
              f"{what}: {k} {x.dtype} {x.shape} vs {y.dtype} {y.shape}")
        if not k.startswith("pred_densepose_"):
            check(np.array_equal(x, y), f"{what}: {k} differs")
        elif k == "pred_densepose_labels":
            share = float((x != y).mean()) if x.size else 0.0
            check(share <= TIE_SHARE, f"{what}: {share:.2e} of the label pixels differ")
        else:
            tie_free = np.ones(x.shape, bool)
            if k == "pred_densepose_uv":  # (n, 2, H, W), gathered at the labels
                tie_free = np.broadcast_to(
                    (np.asarray(a["pred_densepose_labels"]) ==
                     np.asarray(b["pred_densepose_labels"]))[:, None], x.shape)
            # a float16 map rounds each value: an atomics-order difference may
            # move it by one unit in its last place
            rtol = 2.0 ** -10 if k == "pred_densepose_uv" or x.dtype == np.float16 else 0.0
            x, y = x[tie_free].astype(np.float64), y[tie_free].astype(np.float64)
            e = float(np.abs(x - y).max()) if x.size else 0.0
            check(np.allclose(x, y, rtol=rtol, atol=SERVED_AGAIN_TOL),
                  f"{what}: {k} differs by {e:.3e}")
            err = max(err, e)
    return err, share


def consumer(torch, report, pred, name, per_request, dtype="float32"):
    """The host consumer of one path on the card: the streaming loop
    (parallel/pipeline.py::stream), with stage_input / start_fetch and the
    visualizer (the port's extractor and native blends, keep_bg off as in
    the CLI, with chip_colormap), on distinct frames from memory. Checks:
    each streamed frame's outputs bit-exact to numpy_outputs of blocking
    copies of the same outputs; the launch counters (0 just before the loop,
    read just after) at the path's per-request count per frame; the native
    library built; the overlays uint8 of the frame's shape; the frames served
    again, alone (a serial predict_numpy + visualize loop) and in pairs
    (predict_batch), equal to the streamed ones within served_again's
    bounds, and the serial overlays to the streamed ones in all but
    TIE_SHARE of their pixels. Prints ms per frame of both loops, host ms
    per frame of extraction + blend, bytes fetched per frame with fetch_keys
    and without, and the differences of the frames served again."""
    from densepose_tpu_torch import native
    from densepose_tpu_torch.ops import nms, roi_align, roi_align_sparse
    from densepose_tpu_torch.parallel.pipeline import stream
    from densepose_tpu_torch.predictor import fetch_subset
    from densepose_tpu_torch.visualizer import End2EndVisualizer
    counters = {"nms_keep_cuda": nms.nms_keep_cuda, "roi_align_cuda": roi_align.roi_align_cuda,
                "roi_align_sparse_cuda": roi_align_sparse.roi_align_sparse_cuda}

    check(native.get_lib() is not None, f"consumer {name}: the native library did not build")
    imgs = frames(7, CONSUMER_FRAMES)
    vis = End2EndVisualizer(alpha=0.7, keep_bg=False, cmap=chip_colormap())
    fetch = vis.fetch_keys()
    pred(imgs[0])  # warm-up of this process's pinned-memory pool and host threads
    torch.cuda.synchronize()

    # rec keeps the views stream hands the overlay: pinned buffers, held
    # until this phase ends
    rec, overlays, kept = RecordingVisualizer(vis), [], KeepOutputs(pred)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    t_frames, steady_s = stream(kept, rec, [f.copy() for f in imgs], overlays.append)
    torch.cuda.synchronize()
    stream_ms = (time.perf_counter() - t0) * 1e3 / len(imgs)
    launches = {k: fn.launches for k, fn in counters.items()}
    for k, n in per_request.items():
        check(launches[k] == n * len(imgs), f"consumer {name}: {launches[k]} {k} launches for "
              f"{len(imgs)} streamed frames, expected {n} per frame")
        report[entry_name(k, dtype)]["launches"] += launches[k]
        report[entry_name(k, dtype)]["launches_per_path"][f"{name} {dtype} consumer"] = launches[k]
    check(len(overlays) == len(rec.outs) == len(imgs), f"consumer {name}: {len(overlays)} "
          f"overlays for {len(imgs)} frames")

    check(len(kept.outs) == len(imgs), f"consumer {name}: {len(kept.outs)} requests served")
    fetched = full = 0
    for i, img in enumerate(imgs):
        out = kept.outs[i]
        # the same outputs copied by blocking .cpu() calls, apart from start_fetch
        blocking = {k: v.cpu() for k, v in fetch_subset(out, fetch).items()}
        check(same_outputs(rec.outs[i], pred.numpy_outputs(blocking, keys=fetch)),
              f"consumer {name} frame {i}: the streamed fetch differs from a synchronous "
              "numpy_outputs of the same outputs")
        check(rec.outs[i]["num_instances"] >= 1, f"consumer {name} frame {i}: no detections")
        check(overlays[i].dtype == np.uint8 and overlays[i].shape == img.shape,
              f"consumer {name} frame {i}: overlay {overlays[i].dtype} {overlays[i].shape}")
        fetched += sum(v.numel() * v.element_size() for v in fetch_subset(out, fetch).values())
        full += sum(v.numel() * v.element_size() for v in out.values())
    del kept

    serial = []
    t0 = time.perf_counter()
    for img in imgs:
        serial.append(vis.visualize(img.copy(), pred.predict_numpy(img)))
    serial_ms = (time.perf_counter() - t0) * 1e3 / len(imgs)
    pixel_share = 0.0
    for i, (a, b) in enumerate(zip(overlays, serial)):
        share = float((a != b).any(-1).mean())
        check(share <= TIE_SHARE, f"consumer {name} frame {i}: {share:.2e} of the serial "
              "loop's overlay pixels differ from the streamed overlay's")
        pixel_share = max(pixel_share, share)

    # served again alone, with the overlay's keys
    again_err = again_share = 0.0
    for i, img in enumerate(imgs):
        e, sh = served_again(rec.outs[i], pred.numpy_outputs(pred(img), keys=fetch),
                             f"consumer {name} frame {i} served again")
        again_err, again_share = max(again_err, e), max(again_share, sh)
    # batch 2: predict_batch over pairs of the frames
    for i in range(0, len(imgs), 2):
        out = pred.predict_batch(np.stack(imgs[i:i + 2]))
        for j in range(len(imgs[i:i + 2])):
            e, sh = served_again(rec.outs[i + j],
                                 pred.numpy_outputs({k: v[j] for k, v in out.items()},
                                                    keys=fetch),
                                 f"consumer {name} frame {i + j} in a batch of 2")
            again_err, again_share = max(again_err, e), max(again_share, sh)
    n, rec_ms = [o["num_instances"] for o in rec.outs], rec.ms
    del rec
    print(f"consumer {name}: {len(imgs)} streamed {FRAME_HW[0]}x{FRAME_HW[1]} frames bit-exact "
          f"to a synchronous fetch of the same outputs; served again alone and in batches of "
          f"2 within {SERVED_AGAIN_TOL} (max abs difference of the maps {again_err:.3e}, label "
          f"pixels differing {again_share:.2e}, serial overlay pixels differing "
          f"{pixel_share:.2e}, limit {TIE_SHARE}); num_instances {n}; kernel launches "
          f"{launches}")
    print(f"consumer {name}: streaming loop {stream_ms:.2f} ms per frame (steady state "
          f"{steady_s * 1e3 / max(t_frames, 1):.2f} over {t_frames} frames) vs serial "
          f"predict_numpy + visualize {serial_ms:.2f} ms per frame; host extraction + blend "
          f"{np.mean(rec_ms):.2f} ms per frame (median {np.median(rec_ms):.2f}); bytes fetched "
          f"per frame {fetched / len(imgs):.0f} with fetch_keys, {full / len(imgs):.0f} "
          f"without")


# the flagship narrowed to toy widths (tests/test_torch_pipeline.py's)
NARROW = [
    ("MODEL.RESNETS.STEM_OUT_CHANNELS", 8), ("MODEL.RESNETS.RES2_OUT_CHANNELS", 16),
    ("MODEL.RESNETS.WIDTH_PER_GROUP", 4), ("MODEL.FPN.OUT_CHANNELS", 16),
    ("MODEL.ANCHOR_GENERATOR.SIZES", [[16], [32], [64], [128], [256]]),
    ("MODEL.RPN.PRE_NMS_TOPK_TEST", 80), ("MODEL.RPN.POST_NMS_TOPK_TEST", 60),
    ("MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.3), ("MODEL.ROI_BOX_HEAD.FC_DIM", 32),
    ("MODEL.ROI_DENSEPOSE_HEAD.POOLER_RESOLUTION", 8),
    ("MODEL.ROI_DENSEPOSE_HEAD.NUM_STACKED_CONVS", 2),
    ("MODEL.ROI_DENSEPOSE_HEAD.CONV_HEAD_DIM", 16),
    ("MODEL.ROI_DENSEPOSE_HEAD.DECODER_NUM_CLASSES", 16),
    ("MODEL.ROI_DENSEPOSE_HEAD.DECODER_CONV_DIMS", 16),
    ("INPUT.MIN_SIZE_TEST", 64), ("INPUT.MAX_SIZE_TEST", 96)]


# card against CPU at a half dtype (reference_check): the ranked scores, and
# the paired detections' maps in units in the last place at their magnitude
REF_SCORE_TOL = {"float16": 2e-3, "bfloat16": 1e-2}
REF_MAP_ULPS = 8


def reference_check(torch, dev, name, sparse, dtype="float32"):
    """A narrowed zoo model, card against CPU: in fp32 the same detections
    (count and classes exact, boxes and scores within 1e-3) and SIUV maps
    (1e-3). At a half dtype, with the three detection slots of
    tests/test_e2e.py::TINY, as tests/test_torch_dtype.py::test_end_to_end
    holds the CPU against the JAX package (random weights give near-tied
    detections that roundings may swap): counts and classes exact, the ranked
    scores within REF_SCORE_TOL, and each card detection whose box is within
    test_fp16_mode_runs' envelope (atol 2, rtol 0.1) of a CPU one has that
    one's maps within REF_MAP_ULPS units in the last place; at least one
    pairs up."""
    from densepose_tpu_torch.predictor import DensePosePredictor

    extra = NARROW if dtype == "float32" else NARROW + [
        ("TPU.COMPUTE_DTYPE", dtype), ("TEST.DETECTIONS_PER_IMAGE", 3)]
    cfg = path_config(name, extra)
    img = (np.random.RandomState(21).rand(64, 64, 3) * 255).astype(np.uint8)
    if sparse:
        os.environ[SPARSE_POOLER] = "1"
    try:
        gpu = DensePosePredictor(cfg, seed=5, device=dev).predict_numpy(img)
        cpu = DensePosePredictor(cfg, seed=5, device="cpu").predict_numpy(img)
    finally:
        os.environ.pop(SPARSE_POOLER, None)
    n = cpu["num_instances"]
    check(gpu["num_instances"] == n >= 1, f"reference {name}: {gpu['num_instances']} vs {n} "
          "detections")
    if dtype != "float32":
        reference_check_half(gpu, cpu, name, sparse, dtype)
        return
    # near-equal random-weight scores may swap order: match detections by box
    order = [np.lexsort(r["pred_boxes"].T[::-1]) for r in (gpu, cpu)]
    err = 0.0
    for k in ("pred_boxes", "scores", "pred_classes", "pred_densepose_coarse_segm",
              "pred_densepose_fine_segm", "pred_densepose_u", "pred_densepose_v"):
        a, b = gpu[k][order[0]], cpu[k][order[1]]
        e = float(np.abs(a.astype(np.float64) - b).max())
        check(e <= (0 if k == "pred_classes" else 1e-3), f"reference {name}: {k} differs by {e}")
        err = max(err, e)
    print(f"reference: narrowed {name}{f' with {SPARSE_POOLER}=1' if sparse else ''} on the "
          f"card == on the CPU: {n} detections, max abs difference {err:.3e} (tol 1e-3)")


def reference_check_half(gpu, cpu, name, sparse, dtype):
    what = f"reference {name} {dtype}"
    check(np.array_equal(gpu["pred_classes"], cpu["pred_classes"]), f"{what}: classes differ")
    score_err = float(np.abs(np.sort(gpu["scores"]) - np.sort(cpu["scores"])).max())
    check(score_err <= REF_SCORE_TOL[dtype], f"{what}: ranked scores differ by {score_err}")
    maps = [k for k in cpu if k.startswith("pred_densepose_")]
    pairs, map_err, box_err = 0, 0.0, 0.0
    for i, box in enumerate(gpu["pred_boxes"]):
        cb = cpu["pred_boxes"]
        close = (np.abs(cb - box) <= 2.0 + 0.1 * np.abs(cb)).all(1)
        for j in np.nonzero(close)[0][:1]:
            pairs += 1
            box_err = max(box_err, float(np.abs(cb[j] - box).max()))
            for k in maps:
                a, b = gpu[k][i].astype(np.float64), cpu[k][j].astype(np.float64)
                tol = REF_MAP_ULPS * EPS[dtype] * 2.0 ** np.floor(np.log2(np.abs(b).max()))
                e = float(np.abs(a - b).max())
                check(e <= tol, f"{what}: {k} of a paired detection differs by {e} > {tol}")
                map_err = max(map_err, e)
    check(pairs >= 1, f"{what}: no card detection pairs with a CPU one")
    print(f"reference: narrowed {name}{f' with {SPARSE_POOLER}=1' if sparse else ''} at {dtype}, "
          f"3 slots, card vs CPU: {cpu['num_instances']} detections, classes equal, ranked "
          f"scores within {score_err:.3e} (tol {REF_SCORE_TOL[dtype]}); {pairs} paired "
          f"detections, boxes within {box_err:.3e}, maps within {map_err:.3e} "
          f"(tol {REF_MAP_ULPS} ulp)")


def range_report(torch, pred, img):
    """One fp32 request with a forward hook on every leaf module: the largest
    |output| of each stage, so that a non-finite output at a half dtype can be
    told from a fault of the port (float16 ends at 65504). Returns the
    largest."""
    stages = {}

    def stage(name):
        parts = name.split(".")
        if parts[0] == "backbone":
            return "backbone." + (parts[2] if parts[1] == "bottom_up" else "fpn")
        return {"proposal_generator": "rpn_head"}.get(parts[0], ".".join(parts[:2]))

    def hook(name):
        def record(module, args, out):
            outs = out.values() if isinstance(out, dict) else [out]
            m = max(float(o.detach().abs().max()) for o in outs)
            stages[stage(name)] = max(stages.get(stage(name), 0.0), m)
        return record

    handles = [m.register_forward_hook(hook(n)) for n, m in pred.model.named_modules()
               if n and not list(m.children())]
    try:
        pred(img)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    top = max(stages.values())
    print("range (fp32 flagship request, largest |output| per stage): "
          + ", ".join(f"{k} {v:.4g}" for k, v in stages.items())
          + f"; largest {top:.4g}, float16's largest finite {FP16_MAX:.0f}")
    return top


def half_drift(torch, dev, pred16, dtype):
    """The DensePose stage at ``dtype`` on an fp32 flagship request's
    features (cast) and boxes, against the fp32 stage: the u-logit drift
    over std(u_fp32) on the valid detections, held under 0.5 (the JAX
    package's envelope, tests/test_realscale_parity.py:818-858). Also the
    whole request at ``dtype`` against the fp32 one, printed with no gate:
    random weights give near-tied detections."""
    from densepose_tpu_torch.models.rcnn import image_tensor
    from densepose_tpu_torch.predictor import DensePosePredictor
    pred32 = DensePosePredictor(path_config(FLAGSHIP), seed=0, device=dev)
    img = frames(1, 2)[1]
    half = getattr(torch, dtype)
    with torch.inference_mode():
        res32, feats, boxes = pred32.model.forward_stage1(image_tensor(img, dev))
        valid = res32["valid"]
        u32 = pred32.model.forward_densepose(feats, boxes)["pred_densepose_u"][valid].float()
        u16 = pred16.model.forward_densepose({k: v.to(half) for k, v in feats.items()},
                                             boxes)["pred_densepose_u"][valid]
        check(u16.dtype == half, f"drift: u at {u16.dtype}")
        u16 = u16.float()
        check(bool(torch.isfinite(u16).all()), f"drift: non-finite u at {dtype}")
        drift = float((u16 - u32).abs().max())
        sigma = drift / (float(u32.std()) + 1e-9)
        out32, out16 = pred32.numpy_outputs(pred32(img)), pred16.numpy_outputs(pred16(img))
    torch.cuda.synchronize()
    check(sigma < 0.5, f"drift: the DensePose stage at {dtype} drifts {sigma:.3f} std of the "
          "fp32 u-logits (limit 0.5)")
    b32, b16 = out32["pred_boxes"], out16["pred_boxes"]
    near = [float(np.abs(b32 - b).max(1).min()) for b in b16] if len(b32) else []
    n = min(len(b16), len(b32))
    ranked = np.abs(np.sort(out16["scores"])[::-1][:n] - np.sort(out32["scores"])[::-1][:n])
    print(f"drift: DensePose stage at {dtype} on the fp32 request's features and "
          f"{int(valid.sum())} boxes: u-logits max abs {drift:.4g} = {sigma:.4f} std of the fp32 "
          f"u-logits (limit 0.5); whole request at {dtype} vs fp32 (no gate): "
          f"{out16['num_instances']} vs {out32['num_instances']} detections, ranked scores "
          f"max abs {float(ranked.max()) if n else float('nan'):.4g}, "
          f"{sum(d <= 1.0 for d in near)} of {len(b16)} boxes within 1 px of an fp32 box")
    del pred32
    torch.cuda.empty_cache()


def main():
    try:
        import torch
    except ImportError:
        sys.exit("chip_smoke: torch is not installed")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    try:
        from densepose_tpu_torch.model_zoo import get_config
        from densepose_tpu_torch.ops import cuda_build
    except ImportError as e:
        sys.exit(f"chip_smoke: run from the root of a densepose-tpu checkout ({e})")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s)")
    print(f"nvidia-smi: {smi_line}")

    t0 = time.perf_counter()
    built = cuda_build.build()
    print(f"build: {len(built)} kernels in {time.perf_counter() - t0:.1f} s (parallel nvcc)")
    ptxas = {}
    for name, b in built.items():
        print(f"build: {name}: {b.seconds:.1f} s -> {b.path.name}")
        ptxas[name] = cuda_build.ptxas_report(b.log)
        check(ptxas[name], f"build: no ptxas report for {name}")
        for k in ptxas[name]:
            print(f"  ptxas {name}: {k['kernel']}: {k.get('registers')} registers, "
                  f"{k.get('smem')} bytes static smem, {k.get('stack')} bytes stack, "
                  f"{k.get('spill_stores')}/{k.get('spill_loads')} bytes spill stores/loads")
    check(len(ptxas["roi_align_sparse"]) == 6 and len(ptxas["roi_align"]) == 6,
          "build: K2 and K3 each have 6 instantiations (float, __half, __nv_bfloat16 x ratio "
          f"2, any ratio), got {len(ptxas['roi_align'])} and {len(ptxas['roi_align_sparse'])}")
    for k in ptxas["roi_align_sparse"]:
        check((k.get("stack"), k.get("spill_stores"), k.get("spill_loads")) == (0, 0, 0),
              f"build: K3's {k['kernel']} has a stack frame or spills")

    report = {}
    cfg = get_config(FLAGSHIP)
    dev = torch.device("cuda")
    kernel_checks(torch, cfg, report, dev)
    for entry in report.values():
        entry["ptxas"] = ptxas[SOURCES[entry["name"].split("[")[0]]]
    for name, extra, sparse, per_request in PATHS:
        dtype = path_dtype(extra)
        pred = drive_path(torch, report, dev, name, extra, sparse, per_request)
        if (name, dtype) == (FLAGSHIP, "float32"):
            top = range_report(torch, pred, frames(1, 1)[0])
            check(np.isfinite(top), "range: a non-finite activation in the fp32 request")
        if (name, dtype) in CONSUMER_PATHS:  # before the next path measures its peak memory
            consumer(torch, report, pred, name, per_request, dtype)
        if (name, dtype) == (FLAGSHIP, "float16"):
            half_drift(torch, dev, pred, dtype)
        del pred
        torch.cuda.empty_cache()
    reference_check(torch, dev, FLAGSHIP, False)
    reference_check(torch, dev, LEGACY, True)
    reference_check(torch, dev, FLAGSHIP, False, "float16")
    reference_check(torch, dev, LEGACY, True, "bfloat16")

    print(json.dumps({"kernels": list(report.values())}))
    print(f"nvidia-smi: {smi_line}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
