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
   K1 (NMS) exactly at the RPN, box-stage and classed sites, at TTA's
   class-aware merge (18 views x 100 detections) and at its edge
   cases (word edges, all invalid, all identical, zero area, a sweep across
   the threshold, three classes); K2 (ROIAlign) bit-identical at the box and
   DensePose poolers, also on the pyramids of TTA's largest view (1216x1600),
   of a geometry canvas (768x1344) and of HRNet-W32's HRFPN (the frame padded
   to 64, 832x1088: the box pooler over five levels p1..p5, the DensePose
   pooler on the stride-4 map), and within 1e-5 absolute at ratio 0
   (adaptive) on the box pooler's inputs; K3 (the skip-flag ROIAlign, one launch a call)
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
   Then Q1 (the s8 implicit-GEMM convolution of the int8 serving mode) at
   every link shape of the int8 paths (Q1_SITES: the head links at 8, 32 and
   100 rows, the GN link, the merged 77-channel deconvolution, a stride-2 1x1,
   a dilated 3x3, FPN and RPN 3x3 at p2, HRNet-W32's widths and W48's ragged
   48, 96 and 720), with each of its two variants that takes the site (wgmma
   on TMA tiles where conv_int8.wgmma_takes the shape; mma_sync everywhere):
   the int32 sums and the s8, f32, f16 and bf16 outputs bit-identical to the
   plain version (float64 sums, exact), two runs the same bits; the variant
   conv_int8.q1_variant routes the site to (the head's sites, Q1_WGMMA_SITES,
   must be wgmma), its times beside the other variant's in the same run, the
   bound (bytes at 3.35 TB/s, int8 operations at 1979 TOP/s) and two
   yardsticks the port never calls (the float16 cuDNN convolution of the same
   shape, library_ms; torch._int_mm on the unfolded input where its shape
   rules admit the site);
4. paths, each at full width with random weights from seed 0: a
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
     det_packed in fp32, the DensePose maps in the dtype;
   - densepose_rcnn_HRFPN_HRNet_w32_s1x in fp32 and at float16 (the input
     padded to 64; the box pooler over p1..p5; the backbone rescaled to
     unit-variance outputs first, path_params): 2 K1 and 2 K2 per request,
     and one more request with every K1 and K2 launch held against its plain
     version (HeldAgainstPlain: K1 exact, K2 bit-identical);
   - densepose_rcnn_R_50_FPN_s1x_cse: 2 K1 and 2 K2 per request, the
     embedding and coarse segmentation maps in place of the chart maps.
   After the fp32 flagship's and HRNet's requests, one more with forward
   hooks prints the largest |output| of each stage (float16 ends at 65504). After the
   float16 flagship's, the DensePose stage at float16 on an fp32 request's
   features (cast) and boxes drifts under 0.5 std of the fp32 u-logits, and
   the whole request at float16 is printed against the fp32 one;
   - the int8 paths (INT8_PATHS, int8_path): the flagship with INT8_HEAD +
     INT8_PREDICTOR in fp32, at float16 and at bfloat16 (the JAX package's
     headline serving configuration), "max serving" (all four
     TPU.INT8_* groups), DL with INT8_HEAD (the GN chain) and HRNet-W32 with
     INT8_BACKBONE + INT8_HEAD (backbone rescaled as above), each calibrated
     by calibrate_int8 on 4 distinct frames before its warm-up: 2 K1 + 2 K2
     and the Q1 launches its quantized convs make per request (one a conv,
     the four chart deconvs one, the RPN conv one a level), Q1's launches by
     variant, the saturation report, one more request with every K1, K2 and
     Q1 launch held against its plain version (the head's Q1 calls all on
     the wgmma variant), and against the fp request of the same model and
     dtype the detections bit-identical where the groups are post-detection
     (head, predictor) and the maps inside tests/test_int8.py's envelopes;
     the flagship's calibration saved and loaded into a second predictor
     gives the same int8 state and outputs bit for bit;
4b. batch (batch_phase): batched frames through predict_batch, one batched
   forward (the poolers with a frame index per box): the fp32 and float16
   flagship at B = 1, 2, 4 and 8 on distinct frames, each B a warm-up, two
   timed batches with the launch counters set to 0 just before and read
   just after (2 K1 + 2 K2 a batch, not a frame, and no plain version
   called: CountPlain) and one profiled batch, printed beside the
   frame-by-frame loop on other frames (ms a batch and a frame, frames/s,
   device-busy ms a frame, idle share, peak memory, with the nvidia-smi
   line); at B = 4 one batch with every K1 and K2 launch held against its
   plain version (in fp32 each call then timed at its batched site, beside
   its plain version and its bound: batched_sites on the kernels line),
   each frame against forward_batch of that frame alone and against the
   frame-by-frame request (on DETECTION_TAME weights, tamed_predictor:
   random weights tie every score; hold_frames: rows paired by class, box and
   score within BATCH_BOX_TOL / BATCH_SCORE_TOL, at most BATCH_MOVED_ROWS
   rows a frame without a partner (none in fp32), every paired row's maps
   within served_again's bound in fp32 and BATCH_MAP_REL_L2 at a half
   dtype or int8, the rows compared printed with two planted faults' readings;
   where cuDNN's batch-size-dependent algorithms move one past them, held
   again with cuDNN off); in fp32, data_parallel_forward with two replicas on this
   card against forward_batch of each shard, and the batched streaming
   loop (stream at batch 4 over 9 frames, the tail padded: each frame
   bit-exact to numpy_outputs_batch of blocking copies of its batch, the
   overlays uint8 of the frame's shape, ms a frame beside batch 1's); the
   int8 flagship (INT8_HEAD + INT8_PREDICTOR) at B = 4 and max serving at
   B = 2, calibrated on 4 frames: as many Q1 launches a batch as a request
   (not B times), one batch with every K1, K2 and Q1 launch held against
   its plain version (the head's links on wgmma; the head link's time at
   B = 4 kept); R101 legacy with DENSEPOSE_TPU_SPARSE_POOLER at B = 2: 2 K1
   + 2 K3 a batch, every launch held (K3 within K3_TOL, relative above 1),
   each K3 call timed; each of these against forward_batch of its frames
   alone, its DensePose stage given each frame's own features and boxes,
   and its box-stage decisions given each frame's own box-head outputs;
4c. spatial (spatial_phase): one frame's rows sharded over devices
   (parallel/mesh.py::spatial_parallel_forward: the preprocess, backbone and
   FPN / HRFPN as row slabs with a hand-written halo exchange, the pyramid
   gathered onto the first device): the fp32 and float16 flagship, R101
   legacy on K3, DL, HRNet-W32 and max serving (all four int8 groups,
   calibrated on 4 frames: Q1 on halo-extended s8 slabs), at full width on
   DETECTION_TAME weights, each over this card listed 2 and 4 times (one
   replica: a correctness check, speed across cards not measured) and over
   every card when more than one is visible: a warm-up and 2 frames with the
   launch counters set to 0 just before and read just after (2 K1 + 2 K2 or
   2 K3 a request, Q1's backbone links once a shard, no plain version
   called) beside the unsharded request (forward_batch of the frame) on the
   same frames; one sharded request with every K1, K2, K3 and Q1 launch held
   against its plain version (max serving over 4 shards: Q1 at a slab of FPN's
   p2 output conv timed beside the whole map's, spatial_sites on the kernels
   line); the detections and maps against the unsharded request's as
   hold_frames holds a batch's frames, and the gathered pyramid within
   SPATIAL_FEATURE_TOL of each level's largest magnitude, beside the
   readings of a planted fault (a halo one row short at each interior
   boundary); ms a request both ways, halo copies and bytes, gather bytes,
   rows per shard per level and peak memory per device;
4d. new backbones (new_backbones_phase): get_cfg()'s R50-C4 detector
   (detectron2's faster_rcnn_R_50_C4_1x with DensePose off: build_resnet_backbone
   to res4, the RPN on res4, Res5ROIHeads with 14x14 ROIAlignV2 at ratio 0
   and 80 classes) in fp32, at float16 and with INT8_BACKBONE calibrated on
   4 frames (tests/torch_cases.py::C4_TAME weights: random ones put no box
   inside the frame), the flagship with DEPTH 34 (BasicBlock) and the
   flagship on the RetinaNet FPN (RPN p3..p7, ROI heads p3..p5), at full
   width: a warm-up and 2 frames with the launch counters set to 0 just
   before and read just after (C4: 2 K1, the RPN's one level and the box
   stage's 80 class problems of 1000 proposals, 1 K2 and 42 Q1 links under
   INT8_BACKBONE; the FPN paths 2 K1 + 2 K2; no plain version called), the
   latency, device time and idle share beside the nvidia-smi line, the
   outputs' form, one request with every K1, K2 and Q1 launch held against
   its plain version; the C4 fp32 request's K1 and K2 calls timed at their
   sites beside their plain versions and bounds (c4_sites on the kernels
   line); narrowed C4 (R50, R18), R18-FPN and RetinaNet models card against
   CPU;
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
   visualize loop) and in pairs (predict_batch, batch 2: the raw maps of
   every slot, through the device postprocess where the path has one, on
   the path's configuration with DETECTION_TAME weights, held as
   hold_frames holds a batch), equal to the
   streamed one within SERVED_AGAIN_TOL (detections exact; labels and
   overlay pixels may differ at argmax near-ties, in at most TIE_SHARE of
   them); it prints ms per frame of both loops, host ms per frame of
   extraction + blend, bytes fetched per frame with the overlay's
   fetch_keys and without, and the differences of the frames served again;
6. CSE: R50-CSE with tamed detection weights (DETECTION_TAME) on one frame,
   2 K1 + 2 K2; visualizer.CseResultExtractor on the card (the SMPL mesh's
   vertex embeddings computed there, each box's embedding resized on the
   host, the closest-vertex lookups on the card in row chunks), each lookup
   timed apart from the host's resizes; then a whole 480x640 frame's pixels
   looked up, with the chunk size, device ms and peak memory. A sample of
   both lookups' pixels must choose vertices within CSE_TIE (1 + |p|) of a
   CPU float64 evaluation's minimum, every index below the vertex count;
7. geometry: the fp32 flagship with TPU.GEOMETRY_BUCKET_QUANT 64 and tamed
   detection weights (DETECTION_TAME) on frames of four sizes, two sharing a
   canvas: each canvas, built on the card, equal to the host's bucketize bit
   for bit; 2 K1 + 2 K2 per request; one more request a frame with every K1
   and K2 launch held against its plain version (HeldAgainstPlain); the detections against the exact path's
   within tests/test_bucketing.py's envelope; each frame's request ms on
   both paths;
8. detection buckets: on one fp32 flagship request's features, the switched
   DensePose stage ({8, 32, D}) and TPU.BUCKETED_DENSEPOSE's stage 2 ({8, 16,
   32, 64, D}) with the count forced to 5, 12, 20, 50 and 100: each bucket's
   rows equal the D-slot rows within SERVED_AGAIN_TOL + BUCKET_RTOL of the
   map's largest magnitude, each bucket's
   stage-2 device ms; stage 2 at each count with its K2 launches held
   against the plain version; with cuDNN off (one sample at a time), bucket
   8's rows within SERVED_AGAIN_TOL of the D-slot rows, the witness that
   cuDNN's batch-size-dependent algorithms make the gap; then
   BUCKETED_DENSEPOSE requests (2 K1 + 2 K2 each);
9. TTA: the flagship with the config's own TEST.AUG (nine scales 400..1200,
   flips: 18 views) in fp32 and at float16, a warm-up and two timed frames:
   37 K1 + 36 K2 per request, maps fp32 and finite, the peak memory, one
   more request with every K1 and K2 launch (the merge's and the 1200 px
   views' among them) held against its plain version, one
   profiled request split into TTA's stage 1, merge, stage 2 and reduce;
   and a single-view TTA (800, 1333, no flip) against the base request: the
   detections after the merge exact, the maps within SERVED_AGAIN_TOL of the
   DensePose stage on the merged boxes, and of the base request's maps on
   the shared detections that pool the same box;
10. reference: a narrowed flagship, and a narrowed R101 legacy model with the
   sparse pooler, on the card agree with the same models on the CPU (plain
   versions; tests/test_torch_*.py hold those against the JAX package); and
   the same at float16 (flagship) and bfloat16 (legacy), within the half
   tolerances of reference_check; a narrowed flagship under TTA (two
   scales, flips) and one with TPU.GEOMETRY_BUCKET_QUANT 64, in fp32; a
   narrowed HRNet (NARROW_HRNET) in fp32 and at float16, and a narrowed
   R50-CSE in fp32 and at bfloat16; a narrowed int8 flagship (INT8_HEAD +
   INT8_PREDICTOR) and a narrowed int8 HRNet (INT8_BACKBONE + INT8_HEAD),
   calibrated on the card and loaded on the CPU: the int8 state
   bit-identical, detections within 1e-3, maps within INT8_REF_RTOL
   (reference_check_int8);
11. deploy: each kernel's host time a call through its operator
   (torch.ops.densepose_tpu_torch, ops/library.py: what an exported program
   calls) and through its wrapper directly (what eager requests call), at a
   flagship site, both routes giving the same output (dispatch_costs);
   flagship bundles in fp32 and float16 written by export.export_bundle and
   loaded through run.load_predictor, their detections bit-identical to a
   predictor built in memory from the same weights and the maps within
   SERVED_AGAIN_TOL (cuDNN's atomics), and an int8 sidecar written by
   export.calibrate_bundle on 4 frames and loaded with the bundle: the int8
   state and every output bit-identical to an in-memory calibration's
   (bundle_phase); the flagship, the int8 flagship (INT8_HEAD +
   INT8_PREDICTOR) and R101 legacy with DENSEPOSE_TPU_SPARSE_POOLER set
   exported as programs (aot_export_bytes) at 480x640, written, loaded
   (aot_load) and run on 3 frames with the launch counters set to 0 just
   before and read just after (2 K1 and 2 K2, or 2 K3, and 9 Q1 on int8, a
   request, and no plain version called), against eager: detections
   bit-identical, maps within SERVED_AGAIN_TOL; export seconds, .pt2 size,
   load seconds and the latency of both (aot_program); then evaluate.evaluate
   over 8 square synthetic frames whose ground truth is the card's own
   predictions (boxes, and points sampled from the extracted labels and UV,
   tests/torch_cases.py::self_annotations), with cuDNN deterministic for the
   phase: box AP and GPS AP 100 (evaluate_phase).

Prints a ``{"kernels": [...]}`` line with one entry per kernel and compute
dtype (K1 takes fp32 boxes and Q1 s8 activations at every dtype: one entry
each), the nvidia-smi line,
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
H100_INT8_PER_S = 1979e12    # dense int8 tensor-core operations, H100 SXM data sheet
FLAGSHIP = "densepose_rcnn_R_50_FPN_s1x"
LEGACY = "densepose_rcnn_R_101_FPN_s1x_legacy"
DEEPLAB = "densepose_rcnn_R_50_FPN_DL_s1x"
HRNET = "densepose_rcnn_HRFPN_HRNet_w32_s1x"
CSE = "densepose_rcnn_R_50_FPN_s1x_cse"
SPARSE_POOLER = "DENSEPOSE_TPU_SPARSE_POOLER"
FRAME_HW = (480, 640)
TIMED_REQUESTS = 3
K2_TOL = 1e-5
K3_TOL = 1e-5
K3_K2_TOL = 2e-5  # K3 sums the taps in another order (tests/test_ops.py:625)
SOURCES = {"nms_keep_cuda": "nms", "roi_align_cuda": "roi_align",
           "roi_align_sparse_cuda": "roi_align_sparse", "conv_s8_cuda": "conv_s8"}
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
    cuda_ms it leaves out the host's time between launches. The profiler
    mirrors each record_function range of the model on the device; those
    events span kernels already counted and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and e.name not in STAGES + TTA_STAGES)
    return us / 1e3 / reps


def ulp(dtype, t):
    """One unit in the last place of ``dtype`` at the largest magnitude of
    tensor ``t`` (float32: 0)."""
    if dtype not in EPS or t.numel() == 0:
        return 0.0
    return EPS[dtype] * 2.0 ** np.floor(np.log2(max(float(t.abs().max()), 2.0 ** -14)))


def entry_name(kernel, dtype):
    """The kernels line's entry of a kernel at a compute dtype: K1 takes fp32
    boxes and Q1 s8 activations at every dtype (one entry each); K2 and K3
    one entry a dtype."""
    one = ("nms_keep_cuda", "conv_s8_cuda")
    return kernel if dtype == "float32" or kernel in one else f"{kernel}[{dtype}]"


def path_dtype(extra):
    return dict(extra).get("TPU.COMPUTE_DTYPE", "float32")


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def main_path_shapes(cfg, min_size=None, max_size=None):
    """The padded input (to the config's size divisibility) and the FPN levels
    of a FRAME_HW frame at the config's test resolution, or at ``min_size`` /
    ``max_size``."""
    from densepose_tpu_torch.models.rcnn import (compute_resize, pad_to_divisible,
                                                 size_divisibility)
    _, h1, w1 = compute_resize(*FRAME_HW, min_size or cfg.INPUT.MIN_SIZE_TEST,
                               max_size or cfg.INPUT.MAX_SIZE_TEST)
    hp, wp = pad_to_divisible(h1, w1, size_divisibility(cfg))
    return (hp, wp), pyramid_levels(hp, wp)


def pyramid_levels(hp, wp):
    levels = {f"p{s}": (hp // 2 ** s, wp // 2 ** s) for s in (2, 3, 4, 5)}
    levels["p6"] = (-(-levels["p5"][0] // 2), -(-levels["p5"][1] // 2))
    return levels


def hrfpn_levels(hp, wp):
    """HRFPN's p1..p5 of an (hp, wp) input padded to 64: strides 4..64."""
    return {f"p{i + 1}": (hp // 4 // 2 ** i, wp // 4 // 2 ** i) for i in range(5)}


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


def view_detections(rng, views, d, hw):
    """The TTA merge's input: ``views`` views' ``d`` detections of the same
    objects in a frame of size ``hw`` (each view's boxes the same clustered
    boxes, jittered by 2%), concatenated and in the order of the merge's
    global score sort (views interleaved)."""
    b = clustered_boxes(rng, d, hw)[None] * (1 + 0.02 * rng.randn(views, d, 4))
    b = b.reshape(-1, 4)[rng.permutation(views * d)]
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


def roi_align_work(feats, boxes, levels, scales, out_hw, ratio, aligned, frames=None):
    """Bytes and operations ROIAlign needs on these inputs: every feature
    pixel some in-bound sample taps, read once, plus boxes, levels (and the
    frame index) and the output, at the levels' element size; 12 operations
    per in-bound sample and channel, 1 per output. At ratio 0 the samples are
    each box's adaptive ones. Levels of N frames with ``frames``: a pixel is
    one of its frame's."""
    import torch
    from densepose_tpu_torch.ops.roi_align import box_samples
    c = feats[0].shape[-3]
    n = feats[0].shape[0] if feats[0].dim() == 4 else 1
    hs = torch.tensor([f.shape[-2] for f in feats], device=boxes.device)
    ws = torch.tensor([f.shape[-1] for f in feats], device=boxes.device)
    offs = torch.cumsum(n * hs * ws, 0) - n * hs * ws
    lv = levels.long()
    base = offs[lv] + (0 if frames is None else frames.long() * hs[lv] * ws[lv])
    sc = torch.tensor(scales, dtype=torch.float32, device=boxes.device)[lv]
    (ylo, yhi, _, yok), (xlo, xhi, _, xok), _, _ = box_samples(
        boxes, sc, hs[lv].float(), ws[lv].float(), out_hw, ratio, aligned)
    ok = (yok[:, :, None] & xok[:, None, :]).reshape(-1)
    taps = []
    for y in (ylo, yhi):
        for x in (xlo, xhi):
            flat = base[:, None, None] + y[:, :, None] * ws[lv][:, None, None] + x[:, None, :]
            taps.append(flat.reshape(-1)[ok])
    pixels = torch.unique(torch.cat(taps)).numel()
    m = boxes.shape[0]
    out = m * out_hw[0] * out_hw[1] * c
    esize = feats[0].element_size()
    nbytes = pixels * c * esize + m * (20 if frames is None else 24) + out * esize
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

    # K1 at its two main-path sites, plus a classed problem, plus TTA's
    # class-aware merge of every view's detections (K = views x D, the
    # config's own TEST.AUG, at the box stage's threshold)
    rpn_k = cfg.MODEL.RPN.PRE_NMS_TOPK_TEST
    counts = [min(h * w * 3, rpn_k) for h, w in levels.values()]
    merge_views = len(cfg.TEST.AUG.MIN_SIZES) * (2 if cfg.TEST.AUG.FLIP else 1)
    sites = [
        ("rpn", len(counts), rpn_k, counts, cfg.MODEL.RPN.NMS_THRESH, None, None),
        ("box_stage", 1, cfg.MODEL.RPN.POST_NMS_TOPK_TEST * cfg.MODEL.ROI_HEADS.NUM_CLASSES,
         None, cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST, None, None),
        ("classed", 1, 1000, None, 0.5, 3, None),
        ("tta_merge", 1, merge_views * cfg.TEST.DETECTIONS_PER_IMAGE, None,
         cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST, cfg.MODEL.ROI_HEADS.NUM_CLASSES, merge_views),
    ]
    k1 = []
    for site, p, k, valid_counts, thr, n_classes, views in sites:
        r = rng if views is None else np.random.RandomState(1)
        if views is None:
            b = np.stack([clustered_boxes(r, k, (hp, wp)) for _ in range(p)])
        else:
            b = view_detections(r, views, k // views, FRAME_HW)[None]
        b = torch.from_numpy(b).to(dev)
        v = torch.from_numpy(r.rand(p, k) > 0.05).to(dev)
        if valid_counts is not None:
            v &= torch.arange(k, device=dev)[None] < torch.tensor(valid_counts, device=dev)[:, None]
        c = None if n_classes is None else torch.from_numpy(
            r.randint(0, n_classes, size=(p, k)).astype(np.int32)).to(dev)
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
    ratio_b = cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO
    det = boxes[:cfg.TEST.DETECTIONS_PER_IMAGE].contiguous()
    sites = [
        ("box_pooler", pyramid, boxes, lv, scales, (res_b, res_b), ratio_b, 0.0),
        ("densepose_pooler", pyramid[:1], det,
         torch.zeros(det.shape[0], dtype=torch.int32, device=dev), scales[:1], (res_d, res_d),
         dp.POOLER_SAMPLING_RATIO, 0.0),
        ("box_pooler_ratio0", pyramid, boxes, lv, scales, (res_b, res_b), 0, K2_TOL),
    ]
    # and both poolers at the other pyramids the slice's paths give K2: TTA's
    # largest view (the frame at the config's largest TEST.AUG.MIN_SIZES) and
    # a geometry canvas, each with boxes inside its image
    rng2 = np.random.RandomState(2)
    (tp_h, tp_w), _ = main_path_shapes(cfg, max(cfg.TEST.AUG.MIN_SIZES), cfg.TEST.AUG.MAX_SIZE)
    for tag, (ph, pw) in [(f"tta_{tp_h}x{tp_w}", (tp_h, tp_w)),
                          (f"geometry_{GEOMETRY_CANVAS[0]}x{GEOMETRY_CANVAS[1]}",
                           GEOMETRY_CANVAS)]:
        pyr = [torch.randn(c, h, w, device=dev)
               for f, (h, w) in pyramid_levels(ph, pw).items() if f != "p6"]
        bx = torch.from_numpy(clustered_boxes(rng2, box_m, (ph, pw))).to(dev)
        bx = torch.stack([bx[:, 0].clamp(0, pw), bx[:, 1].clamp(0, ph),
                          bx[:, 2].clamp(0, pw), bx[:, 3].clamp(0, ph)], 1)
        dbx = bx[:cfg.TEST.DETECTIONS_PER_IMAGE].contiguous()
        sites += [
            (f"{tag}_box_pooler", pyr, bx, roi_align.assign_boxes_to_levels(bx, 2, 5), scales,
             (res_b, res_b), ratio_b, 0.0),
            (f"{tag}_densepose_pooler", pyr[:1], dbx,
             torch.zeros(dbx.shape[0], dtype=torch.int32, device=dev), scales[:1],
             (res_d, res_d), dp.POOLER_SAMPLING_RATIO, 0.0)]
    # and at HRNet-W32's HRFPN: the box pooler over its five levels p1..p5
    # (levels 2..6) and the DensePose pooler on its decoder map, on the
    # 480x640 frame's input padded to 64
    hcfg = get_config(HRNET)
    (hh, hw_), _ = main_path_shapes(hcfg)
    c_h = hcfg.MODEL.HRNET.HRFPN.OUT_CHANNELS
    pyr = [torch.randn(c_h, h, w, device=dev) for h, w in hrfpn_levels(hh, hw_).values()]
    bx = torch.from_numpy(clustered_boxes(np.random.RandomState(3), box_m, (hh, hw_))).to(dev)
    bx = torch.stack([bx[:, 0].clamp(0, hw_), bx[:, 1].clamp(0, hh),
                      bx[:, 2].clamp(0, hw_), bx[:, 3].clamp(0, hh)], 1)
    dbx = bx[:cfg.TEST.DETECTIONS_PER_IMAGE].contiguous()
    sites += [
        (f"hrfpn_{hh}x{hw_}_box_pooler", pyr, bx, roi_align.assign_boxes_to_levels(bx, 2, 6),
         [1 / 2 ** (i + 2) for i in range(5)], (res_b, res_b), ratio_b, 0.0),
        (f"hrfpn_{hh}x{hw_}_densepose_pooler", pyr[:1], dbx,
         torch.zeros(dbx.shape[0], dtype=torch.int32, device=dev), [1 / 4], (res_d, res_d),
         dp.POOLER_SAMPLING_RATIO, 0.0)]
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
        k2.append({"site": site, "shape": [b.shape[0], feats[0].shape[0], *out_hw],
                   "levels": len(feats), "ratio": ratio,
                   "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms,
                   "bound_by": bound_by})
        print(f"K2 roi_align_cuda {site} M={b.shape[0]} {out_hw} C={feats[0].shape[0]} "
              f"levels={len(feats)} "
              f"(first {tuple(feats[0].shape[1:])}) "
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
        feats = levels_t[:len(feats)] if feats[0] is pyramid[0] else [f.to(t) for f in feats]
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
    return [synthetic_frame(rng, FRAME_HW) for _ in range(n)]


def synthetic_frame(rng, hw):
    """A frame of size ``hw`` drawn from ``rng``: noise plus a smooth blob,
    so that it is not pure noise."""
    img = rng.randint(0, 256, size=(*hw, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    cy, cx = rng.rand(2) * hw
    blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 80.0 ** 2))
    return np.clip(img * 0.3 + blob[..., None] * 180, 0, 255).astype(np.uint8)


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


def path_params(cfg, dev):
    """The weights a path serves: None (the predictor's random init from seed
    0), or for HRNet those weights with the backbone rescaled to
    unit-variance outputs on the warm-up frame in fp32
    (tests/torch_cases.py::unit_variance_): with the plain init HRNet-W32's
    activations on these frames reach ~2e6 in fp32 at its depth, past
    float16's 65504, and a float16 request has no finite detection."""
    from densepose_tpu_torch.predictor import DensePosePredictor
    if cfg.MODEL.BACKBONE.NAME != "build_hrfpn_backbone":
        return None
    fp32_cfg = cfg.clone()
    fp32_cfg.defrost()
    fp32_cfg.TPU.COMPUTE_DTYPE = "float32"
    for key in INT8_FLAGS:  # the rescale runs the fp network
        fp32_cfg.TPU[key] = False
    fp32 = DensePosePredictor(fp32_cfg, seed=0, device=dev)
    warm = frames(1, 1)[0]
    torch_cases().unit_variance_(fp32.model.backbone, lambda: fp32(warm))
    return {k: v.cpu() for k, v in fp32.model.state_dict().items()}


def counters():
    """Each kernel wrapper, whose ``launches`` counts its kernel's launches."""
    from densepose_tpu_torch.ops import conv_int8, nms, roi_align, roi_align_sparse
    return {"nms_keep_cuda": nms.nms_keep_cuda, "roi_align_cuda": roi_align.roi_align_cuda,
            "roi_align_sparse_cuda": roi_align_sparse.roi_align_sparse_cuda,
            "conv_s8_cuda": conv_int8.conv_s8_cuda}


def count_launches(report, tag, dtype, launches, per_request, n_req, what="requests"):
    """Checks a run's launches against ``per_request`` for ``n_req`` requests
    and adds them to the kernels line."""
    for k, n in per_request.items():
        check(launches[k] == n * n_req, f"{tag}: {launches[k]} {k} launches for {n_req} "
              f"{what}, expected {n} per request")
        report[entry_name(k, dtype)]["launches"] += launches[k]
        report[entry_name(k, dtype)]["launches_per_path"][tag] = launches[k]


class HeldAgainstPlain:
    """Within the block, each K1, K2, K3 and Q1 launch a path makes is held
    against its plain version on the same inputs, as kernel_checks holds its
    sites: K1's keep flags exact, K2 bit-identical (ratio 0: within K2_TOL, or
    one unit in the last place of a half dtype), K3 within K3_TOL of the
    output's largest magnitude above 1 (one unit in the last place of a half
    dtype), Q1 bit-identical; a batch's poolers
    with their frame index. The wrappers are swapped in the modules that
    dispatch to them and restored on exit; the launches in the block are
    counted on the held wrappers, apart, and not read. ``keep``: also keep
    each call's arguments (``calls``), to time the kernels at those sites."""

    def __init__(self, torch, what, keep=False):
        self.torch, self.what, self.keep = torch, what, keep
        # (P, K, classed); (M, first level (H, W), dtype, levels, frames) for K2
        # and K3; (M, K, N, (H, W), variant, transposed)
        self.k1, self.k2, self.k3, self.q1 = [], [], [], []
        self.calls = {"k1": [], "k2": [], "k3": [], "q1": []}

    def __enter__(self):
        from densepose_tpu_torch.ops import conv_int8, nms, roi_align, roi_align_sparse
        torch, what = self.torch, self.what
        self.mods = (nms, roi_align, roi_align_sparse, conv_int8)
        self.orig = k1, k2, k3, q1 = (nms.nms_keep_cuda, roi_align.roi_align_cuda,
                                      roi_align_sparse.roi_align_sparse_cuda,
                                      conv_int8.conv_s8_cuda)

        def kept(kind, *args, **kw):
            if self.keep:
                self.calls[kind].append((args, kw))

        def held_k1(boxes, valid, thr, classes=None):
            keep = k1(boxes, valid, thr, classes)
            want = nms.nms_keep_plain(boxes, valid, thr, classes)
            check(torch.equal(keep, want), f"{what}: K1 at P={boxes.shape[0]} K={boxes.shape[1]}: "
                  f"{int((keep != want).sum())} keep flags differ from the plain version")
            self.k1.append((boxes.shape[0], boxes.shape[1], classes is not None))
            kept("k1", boxes, valid, thr, classes)
            return keep

        def pooler_site(feats, boxes, frames):
            n = 1 if feats[0].dim() == 3 else feats[0].shape[0]
            return (boxes.shape[0], tuple(feats[0].shape[-2:]), str(feats[0].dtype).split(".")[-1],
                    len(feats), n if frames is not None else 1)

        def held_k2(feats, boxes, levels, scales, out_hw, ratio, aligned, frames=None):
            out = k2(feats, boxes, levels, scales, out_hw, ratio, aligned, frames)
            want = roi_align.roi_align_plain(feats, boxes, levels, scales, out_hw, ratio, aligned,
                                             frames)
            err = float((out.float() - want.float()).abs().max()) if out.numel() else 0.0
            dtype = str(feats[0].dtype).split(".")[-1]
            check(torch.equal(out, want) if ratio else err <= max(K2_TOL, ulp(dtype, want)),
                  f"{what}: K2 at M={boxes.shape[0]} on {tuple(feats[0].shape)} {dtype}: max abs "
                  f"error {err} against the plain version")
            self.k2.append(pooler_site(feats, boxes, frames))
            kept("k2", feats, boxes, levels, scales, out_hw, ratio, aligned, frames)
            return out

        def held_k3(feats, boxes, levels, scales, out_hw, ratio, aligned, frames=None):
            out = k3(feats, boxes, levels, scales, out_hw, ratio, aligned, frames)
            want = roi_align_sparse.roi_align_sparse_plain(feats, boxes, levels, scales, out_hw,
                                                           ratio, aligned, frames)
            err = float((out.float() - want.float()).abs().max()) if out.numel() else 0.0
            top = float(want.float().abs().max()) if want.numel() else 0.0
            dtype = str(feats[0].dtype).split(".")[-1]
            # the two sum in other orders: K3_TOL at unit scale, relative above
            check(err <= max(K3_TOL * max(1.0, top), ulp(dtype, want)), f"{what}: K3 at "
                  f"M={boxes.shape[0]} on {tuple(feats[0].shape)} {dtype}: max abs error {err} "
                  f"against the plain version (largest magnitude {top:.3e})")
            self.k3.append(pooler_site(feats, boxes, frames))
            kept("k3", feats, boxes, levels, scales, out_hw, ratio, aligned, frames)
            return out

        def held_q1(qx, qw, qb, vec, **kw):
            out = q1(qx, qw, qb, vec, **kw)
            want = conv_int8.conv_s8_plain(qx, qw, qb, vec, **kw)
            check(torch.equal(out, want), f"{what}: Q1 at {tuple(qx.shape)} x {tuple(qw.shape)} "
                  f"{kw}: differs from the plain version")
            geo = {k: v for k, v in kw.items() if k in ("stride", "padding", "dilation",
                                                         "transposed")}
            self.q1.append((qx.numel() // qx.shape[-1], qw[0].numel(), qw.shape[0],
                            tuple(qx.shape[1:3]), conv_int8.q1_variant(qx.shape, qw.shape, **geo),
                            kw.get("transposed", False)))
            kept("q1", qx, qw, qb, vec, **kw)
            return out

        # a wrapper counts through its module's name, which is now the held
        # one's: the launches in the block land here and are not read
        held_k1.launches = held_k2.launches = held_k3.launches = held_q1.launches = 0
        held_q1.variant_launches = dict.fromkeys(conv_int8.Q1_VARIANTS, 0)
        nms.nms_keep_cuda, roi_align.roi_align_cuda = held_k1, held_k2
        roi_align_sparse.roi_align_sparse_cuda = held_k3
        conv_int8.conv_s8_cuda = held_q1
        return self

    def __exit__(self, *exc):
        (nms, roi_align, roi_align_sparse, conv_int8), (k1, k2, k3, q1) = self.mods, self.orig
        nms.nms_keep_cuda, roi_align.roi_align_cuda, conv_int8.conv_s8_cuda = k1, k2, q1
        roi_align_sparse.roi_align_sparse_cuda = k3
        return False

    def summary(self):
        k1 = (f"{len(self.k1)} K1 calls (largest K {max(k for _, k, _ in self.k1)}, "
              f"{sum(c for *_, c in self.k1)} classed)") if self.k1 else "no K1 call"
        k2 = (f"{len(self.k2)} K2 calls (first levels up to "
              f"{max((k[1] for k in self.k2), key=lambda hw: hw[0] * hw[1])}, M "
              f"{sorted({m for m, *_ in self.k2})}, levels "
              f"{sorted({k[3] for k in self.k2})}, frames "
              f"{sorted({k[4] for k in self.k2})})") if self.k2 else "no K2 call"
        if self.k3:
            k2 += (f", {len(self.k3)} K3 calls (M {sorted({m for m, *_ in self.k3})}, frames "
                   f"{sorted({k[4] for k in self.k3})})")
        q1 = (f", {len(self.q1)} Q1 calls ({sum(t for *_, t in self.q1)} transposed, input "
              f"pixels up to {max(m for m, *_ in self.q1)}; "
              f"{sum(k[4] == 'wgmma' for k in self.q1)} wgmma, "
              f"{sum(k[4] == 'mma_sync' for k in self.q1)} mma_sync)") if self.q1 else ""
        return f"{k1} and {k2}{q1} equal to their plain versions (K3 within its bound)"


# (zoo name, config changes, DENSEPOSE_TPU_SPARSE_POOLER set, launches per request)
ON_K2 = {"nms_keep_cuda": 2, "roi_align_cuda": 2, "roi_align_sparse_cuda": 0, "conv_s8_cuda": 0}
ON_K3 = {"nms_keep_cuda": 2, "roi_align_cuda": 0, "roi_align_sparse_cuda": 2, "conv_s8_cuda": 0}
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
    # HRNet-W32 + HRFPN (the box pooler over p1..p5) in fp32 and at float16,
    # and R50 with the CSE embedding predictor: 2 K1 + 2 K2 a request each
    (HRNET, (), False, ON_K2),
    (HRNET, FP16, False, ON_K2),
    (CSE, (), False, ON_K2),
]


def drive_path(torch, report, dev, name, extra, sparse, per_request, prepare=None):
    """One path at full width: a warm-up request, timed requests with the
    launch counters set to 0 just before and read just after, output checks,
    then one profiled request. ``prepare(pred)``, where given, runs after the
    predictor is built and before the warm-up (the int8 paths calibrate
    there). Returns the predictor."""
    from densepose_tpu_torch.predictor import DensePosePredictor

    cfg = path_config(name, extra)
    tag = name + (f" with {SPARSE_POOLER}=1" if sparse else "") + "".join(
        f", {k}={v}" for k, v in extra)
    t0 = time.perf_counter()
    params = path_params(cfg, dev)
    pred = DensePosePredictor(cfg, seed=0, device=dev, params=params)
    print(f"path {tag}: built with random weights (seed 0"
          f"{'' if params is None else ', backbone at unit variance'}) in "
          f"{time.perf_counter() - t0:.1f} s")
    if prepare is not None:
        prepare(pred)
    warm, *timed = frames(1, 1 + TIMED_REQUESTS)
    if sparse:
        os.environ[SPARSE_POOLER] = "1"
    try:
        pred(warm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters().values():
            fn.launches = 0
        q1 = counters()[Q1]
        q1.variant_launches = dict.fromkeys(q1.variant_launches, 0)
        outs, lat = [], []
        for img in timed:
            t0 = time.perf_counter()
            out = pred(img)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
        launches = {k: fn.launches for k, fn in counters().items()}
        q1_variants = dict(q1.variant_launches)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        breakdown(torch, pred, timed[0], float(np.median(lat)))
    finally:
        os.environ.pop(SPARSE_POOLER, None)

    n_req = len(timed)
    dtype = path_dtype(extra)
    count_launches(report, tag, dtype, launches, per_request, n_req)
    if per_request.get(Q1):
        check(sum(q1_variants.values()) == launches[Q1], f"{tag}: Q1's variant counts "
              f"{q1_variants} do not add up to its {launches[Q1]} launches")
        report[Q1]["variant_launches_per_path"][tag] = q1_variants
        print(f"path {tag}: Q1 launches by variant over {n_req} requests: {q1_variants}")
    d = cfg.TEST.DETECTIONS_PER_IMAGE
    dp = cfg.MODEL.ROI_DENSEPOSE_HEAD
    heat = dp.POOLER_RESOLUTION * 2 * dp.UP_SCALE  # deconv stride 2, then the upsample
    if dp.PREDICTOR_NAME == "DensePoseEmbeddingPredictor":
        channels = {"embedding": dp.CSE.EMBED_SIZE, "coarse_segm": dp.NUM_COARSE_SEGM_CHANNELS}
    else:
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
            check(sorted(k for k in res if k.startswith("pred_densepose_"))
                  == sorted(f"pred_densepose_{k}" for k in channels),
                  f"{name} request {i}: maps {sorted(res)}, expected {sorted(channels)}")
            for k, ch in channels.items():
                v = res[f"pred_densepose_{k}"]
                check(v.shape == (n, ch, heat, heat), f"{name} request {i}: "
                      f"pred_densepose_{k} shape {v.shape}, expected {(n, ch, heat, heat)}")
            shape = {k: tuple(res[f"pred_densepose_{k}"].shape) for k in channels}
        for k, v in res.items():
            if isinstance(v, np.ndarray) and v.dtype.kind == "f":
                check(np.isfinite(v).all(), f"{name} request {i}: non-finite {k}")
        print(f"path {tag}: request {i}: {lat[i]:.2f} ms, num_instances {n}, "
              f"{'uv' if cfg.TPU.DEVICE_POSTPROCESS else 'maps'} {shape}")
    print(f"path {tag}: {n_req} requests of {FRAME_HW[0]}x{FRAME_HW[1]} frames (input "
          f"{'x'.join(map(str, main_path_shapes(cfg)[0]))}): latency ms "
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
# the ranges TTAPredictor.__call__ runs its phases in (tta.py)
TTA_STAGES = ("tta_stage1", "tta_merge", "tta_stage2", "tta_reduce")


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


def breakdown(torch, pred, img, latency_ms, stages_of=STAGES, top_stages=TOP_KERNEL_STAGES):
    """One more request under torch.profiler: the device time of each stage
    range, and the device's idle share, both over the profiled request's wall
    time and over ``latency_ms`` (an unprofiled request's); for the RPN and
    box-stage ranges also the three device kernels that take the most time.
    Prints "not measured" when the profiler sees no device activity; returns
    the device's busy ms (None where not measured).
    ``stages_of``: the ranges to split by (TTA's four for a TTA request: the
    model's own ranges nest inside them); ``top_stages``: those to list the
    top kernels of.

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
              and e.name not in STAGES + TTA_STAGES + ("request",)]
    if not device:
        print("breakdown: not measured (the profiler saw no device activity)")
        return
    launched_at = {e.id: e.time_range.start for e in host if e.name.startswith("cu")}
    ranges = [(e.time_range.start, e.time_range.end, e.name) for e in host
              if e.name in stages_of]
    stages = dict.fromkeys(stages_of, 0.0)
    host_ms = dict.fromkeys(stages_of, 0.0)
    by_kernel = {s: {} for s in top_stages}
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
    return busy_ms


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
    its ``__call__`` and ``predict_batch`` serve; everything else goes to the
    predictor."""

    def __init__(self, pred):
        self.pred, self.outs = pred, []

    def __call__(self, image):
        out = self.pred(image)
        self.outs.append(out)
        return out

    def predict_batch(self, images):
        out = self.pred.predict_batch(images)
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
    from densepose_tpu_torch.models.rcnn import device_postprocess
    from densepose_tpu_torch.parallel.pipeline import stream
    from densepose_tpu_torch.predictor import fetch_subset
    from densepose_tpu_torch.visualizer import End2EndVisualizer

    check(native.get_lib() is not None, f"consumer {name}: the native library did not build")
    imgs = frames(7, CONSUMER_FRAMES)
    vis = End2EndVisualizer(alpha=0.7, keep_bg=False, cmap=chip_colormap())
    fetch = vis.fetch_keys()
    pred(imgs[0])  # warm-up of this process's pinned-memory pool and host threads
    torch.cuda.synchronize()

    # rec keeps the views stream hands the overlay: pinned buffers, held
    # until this phase ends
    rec, overlays, kept = RecordingVisualizer(vis), [], KeepOutputs(pred)
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    t_frames, steady_s = stream(kept, rec, [f.copy() for f in imgs], overlays.append)
    torch.cuda.synchronize()
    stream_ms = (time.perf_counter() - t0) * 1e3 / len(imgs)
    launches = {k: fn.launches for k, fn in counters().items()}
    count_launches(report, f"{name} {dtype} consumer", dtype, launches, per_request, len(imgs),
                   "streamed frames")
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
    # batch 2: predict_batch over pairs of the frames, on the path's
    # configuration with DETECTION_TAME weights (tamed_predictor); a batch
    # returns the raw maps of every slot (the JAX contract), which the path's
    # device postprocess, where it has one, collapses as a request does
    tamed = tamed_predictor(pred)

    def in_pairs():
        got = []
        for i in range(0, len(imgs), 2):
            out = tamed.predict_batch(np.stack(imgs[i:i + 2]))
            for j in range(len(imgs[i:i + 2])):
                one = frame_of(out, j)
                if tamed.cfg.TPU.DEVICE_POSTPROCESS:
                    maps = {k: v for k, v in one.items() if k.startswith("pred_densepose_")}
                    one = {k: v for k, v in one.items() if k not in maps}
                    one.update(device_postprocess(maps))
                got.append(tamed.numpy_outputs(one, keys=fetch))
        return got

    # against the frames served alone, as the batch phase holds a batch
    pairs = hold_frames(
        torch, in_pairs, lambda: [tamed.numpy_outputs(tamed(img), keys=fetch) for img in imgs],
        f"consumer {name}: frames in batches of 2", dtype)
    del tamed
    n, rec_ms = [o["num_instances"] for o in rec.outs], rec.ms
    del rec
    print(f"consumer {name}: {len(imgs)} streamed {FRAME_HW[0]}x{FRAME_HW[1]} frames bit-exact "
          f"to a synchronous fetch of the same outputs; served again alone within "
          f"{SERVED_AGAIN_TOL} (max abs difference of the maps {again_err:.3e}, label pixels "
          f"differing {again_share:.2e}, serial overlay pixels differing {pixel_share:.2e}, "
          f"limit {TIE_SHARE}); in batches of 2 against the frames alone: "
          f"{held_text(pairs, dtype)}; num_instances {n}; kernel launches {launches}")
    print(f"consumer {name}: streaming loop {stream_ms:.2f} ms per frame (steady state "
          f"{steady_s * 1e3 / max(t_frames, 1):.2f} over {t_frames} frames) vs serial "
          f"predict_numpy + visualize {serial_ms:.2f} ms per frame; host extraction + blend "
          f"{np.mean(rec_ms):.2f} ms per frame (median {np.median(rec_ms):.2f}); bytes fetched "
          f"per frame {fetched / len(imgs):.0f} with fetch_keys, {full / len(imgs):.0f} "
          f"without")


# the batch phase: batched frames on one card (predict_batch as one batched
# forward, the poolers with a frame index per box), data_parallel_forward and
# the batched streaming loop
BATCH_SIZES = (1, 2, 4, 8)
BATCH_HELD = 4           # the batch size held against the plain versions and timed per call
BATCH_TIMED = 2          # timed batches at each size
BATCH_STREAM_FRAMES = 9  # the batched loop's frames at batch 4: a tail of one, padded
OUT_BYTES = {"s8": 1, "s32": 4}  # Q1's output kinds that are not a dtype


def zero_counters():
    for fn in counters().values():
        fn.launches = 0
    q1 = counters()[Q1]
    q1.variant_launches = dict.fromkeys(q1.variant_launches, 0)


def frame_of(out, i):
    """Frame ``i`` of a batch's outputs: the outputs of a request."""
    return {k: v[i] for k, v in out.items()}


# A batch's frame against the same frame served otherwise (hold_frames).
# cuBLAS picks the box head's GEMM tiles by the rows it is given (B * 1000
# against 1000), so a batch's box logits differ from a frame's in the last
# bits even where cuDNN computes each frame alone, and at float16 they round
# to it. Rows are paired by class, box (each coordinate within BATCH_BOX_TOL
# of 1 + the box's larger side: the box gap) and score (within
# BATCH_SCORE_TOL), the nearest box first; near ties may trade places. In
# fp32 and with int8 every row pairs; at float16 the RPN's and the box
# stage's near ties let another proposal take a slot, anywhere in the list,
# so a frame may hold at most BATCH_MOVED_ROWS rows without a partner (the
# largest score margin of such a row above the cutoff, the D-th score, is
# printed). Every paired row's maps are compared: in fp32 each within
# SERVED_AGAIN_TOL + BATCH_MAP_RTOL of the map's largest magnitude
# (SERVED_AGAIN_TOL alone is not reached: the boxes' last-bit moves move the
# maps by up to ~4e-3 at magnitudes ~1e3); with int8 (a moved box's pooled
# values quantize to other steps) and at float16 within a relative L2
# distance of BATCH_MAP_REL_L2; label maps in all but TIE_SHARE of their
# pixels. Each limit sits between the largest reading of sound runs and the
# smallest reading of a planted fault (PERF.md §6): each frame against its
# neighbour (``apart``), the DensePose boxes moved by one pooling sample
# (hold_densepose_stage), a box moved by one pixel (at float16 a box moves
# by up to 3% of its size; the box stage is held bit for bit on the same
# head outputs, hold_box_decisions).
BATCH_BOX_TOL = {"float32": 1e-5, "int8": 1e-5, "float16": 3e-2}
BATCH_SCORE_TOL = {"float32": 1e-6, "int8": 1e-6, "float16": 1e-3}
BATCH_MAP_RTOL = 1e-4
BATCH_MAP_REL_L2 = {"int8": 1e-2, "float16": 5e-3}
BATCH_MOVED_ROWS = {"float32": 0, "int8": 0, "float16": 20}


def box_gaps(x, y):
    """Each coordinate's difference of boxes ``x`` and ``y`` (n, 4) over 1 +
    the larger side of ``y``, the largest a box."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    side = np.maximum(y[..., 2] - y[..., 0], y[..., 3] - y[..., 1])
    return np.abs(x - y).max(-1) / (1 + np.maximum(side, 0))


def pair_rows(a, b, kind):
    """Each valid detection of ``a`` (host outputs of one frame) with its
    row in ``b``: the same row where it agrees, else the unused row of the
    same class whose box and score agree (BATCH_BOX_TOL, BATCH_SCORE_TOL)
    with the smallest box gap; -1 where none does."""
    tol_box, tol_score = BATCH_BOX_TOL[kind], BATCH_SCORE_TOL[kind]
    ba, bb = (np.asarray(x["pred_boxes"], np.float64) for x in (a, b))
    sa, sb = (np.asarray(x["scores"], np.float64) for x in (a, b))
    ca, cb = np.asarray(a["pred_classes"]), np.asarray(b["pred_classes"])
    # agree[i, j]: row i of a and row j of b may be one detection
    gaps = box_gaps(ba[:, None], bb[None]).reshape(len(ba), len(bb))
    agree = ((ca[:, None] == cb[None]) & (np.abs(sa[:, None] - sb[None]) <= tol_score)
             & (gaps <= tol_box))
    perm, used = [], np.zeros(len(bb), bool)
    for i in range(len(ba)):
        free = agree[i] & ~used
        j = i if i < len(bb) and free[i] else (
            int(np.where(free, gaps[i], np.inf).argmin()) if free.any() else -1)
        perm.append(j)
        if j >= 0:
            used[j] = True
    return np.asarray(perm, np.int64)


def as_f32(x):
    """``x`` as a float32 array (a view where it is one): a batch's maps are
    ~400 MB a frame, compared in float32 with no float64 copies."""
    x = np.asarray(x)
    return x if x.dtype == np.float32 else x.astype(np.float32)


def rel_l2(x, y):
    x, y = as_f32(x), as_f32(y)
    return float(np.linalg.norm(x - y) / max(float(np.linalg.norm(y)), 1e-30)) if x.size else 0.0


def batch_agrees(a, b, what, kind):
    """One frame's host outputs from a batch (``a``) against the frame served
    otherwise (``b``), as the comment above BATCH_BOX_TOL says. Returns the
    readings: rows compared, rows without a partner (``moved``), the largest
    score margin above the cutoff of a row without a partner, each paired
    row's box gap (``gaps``), rows paired out of order, the largest box gap
    (BATCH_BOX_TOL's measure) and score difference, the largest absolute
    map difference, that over the map's largest magnitude (``map_scaled``),
    the largest relative L2 distance of a map, the share of label pixels
    that differ."""
    check(sorted(a) == sorted(b), f"{what}: keys {sorted(a)} vs {sorted(b)}")
    check(np.array_equal(a["image_size"], b["image_size"]), f"{what}: image_size differs")
    perm = pair_rows(a, b, kind)
    paired = perm >= 0
    ia, ib = np.nonzero(paired)[0], perm[paired]
    sa, sb = (np.asarray(x["scores"], np.float64) for x in (a, b))
    moved = max(len(sa), len(sb)) - len(ia)
    cutoff = max(sa.min(), sb.min()) if len(sa) and len(sb) else 0.0
    margin = sa[~paired] - cutoff
    check(moved <= BATCH_MOVED_ROWS[kind], f"{what}: {moved} of {len(sa)} / {len(sb)} "
          f"detections without a partner (limit {BATCH_MOVED_ROWS[kind]})")
    gaps = box_gaps(np.asarray(a["pred_boxes"])[ia], np.asarray(b["pred_boxes"])[ib])
    out = {"rows": len(ia), "moved": moved, "gaps": gaps,
           "margin": float(margin.max()) if margin.size else 0.0,
           "swapped": int((ia != ib).sum()), "box": float(gaps.max()) if gaps.size else 0.0,
           "score": float(np.abs(sa[ia] - sb[ib]).max()) if len(ia) else 0.0,
           "map_abs": 0.0, "map_scaled": 0.0, "map_rel": 0.0, "share": 0.0}
    labels = "pred_densepose_labels"
    for k in a:
        if not k.startswith("pred_densepose_"):
            continue
        x, y = np.asarray(a[k])[ia], np.asarray(b[k])[ib]
        check(x.dtype == y.dtype and x.shape == y.shape,
              f"{what}: {k} {x.dtype} {x.shape} vs {y.dtype} {y.shape}")
        if k == labels:
            out["share"] = share = float((x != y).mean()) if x.size else 0.0
            check(share <= TIE_SHARE, f"{what}: {share:.2e} of the label pixels differ")
            continue
        x, y = as_f32(x), as_f32(y)
        if k == "pred_densepose_uv":  # (n, 2, H, W), gathered at the labels
            tie_free = np.broadcast_to(
                (np.asarray(a[labels])[ia] == np.asarray(b[labels])[ib])[:, None], x.shape)
            x, y = x[tie_free], y[tie_free]
        e = float(np.abs(x - y).max()) if x.size else 0.0
        top = float(np.abs(y).max()) if y.size else 0.0
        r = rel_l2(x, y)
        if kind == "float32":
            check(e <= SERVED_AGAIN_TOL + BATCH_MAP_RTOL * top, f"{what}: {k} differs by "
                  f"{e:.3e} (largest magnitude {top:.3e})")
        else:
            check(r <= BATCH_MAP_REL_L2[kind], f"{what}: {k} at a relative L2 distance of "
                  f"{r:.3e} (limit {BATCH_MAP_REL_L2[kind]})")
        out["map_abs"], out["map_rel"] = max(out["map_abs"], e), max(out["map_rel"], r)
        out["map_scaled"] = max(out["map_scaled"], e / max(top, 1e-30))
    check(out["box"] <= BATCH_BOX_TOL[kind] and out["score"] <= BATCH_SCORE_TOL[kind],
          f"{what}: paired boxes differ by {out['box']:.3e}, scores by {out['score']:.3e}")
    return out


def apart(a, b, kind):
    """The planted fault of a frame served as its neighbour: frame i's
    outputs against frame i + 1's. Returns the fewest rows without a partner
    (pair_rows), the smallest relative L2 distance of a float map and the
    smallest share of differing label pixels (on the rows both hold) over
    the frames; None where there is no such map."""
    moved, rel, share = [], [], []
    for i, x in enumerate(a):
        y = b[(i + 1) % len(b)]
        moved.append(max(len(x["scores"]), len(y["scores"])) - int((pair_rows(x, y, kind)
                                                                     >= 0).sum()))
        for k in x:
            if k.startswith("pred_densepose_"):
                m = min(len(x[k]), len(y[k]))
                if k == "pred_densepose_labels":
                    share.append(float((x[k][:m] != y[k][:m]).mean()))
                else:
                    rel.append(rel_l2(x[k][:m], y[k][:m]))
    return {"moved": min(moved), "rel": min(rel) if rel else None,
            "share": min(share) if share else None}


def hold_frames(torch, got, want, what, kind="float32"):
    """Each frame of a batch (``got()``: the batch's host outputs per frame)
    against the same frames served otherwise (``want()``), by batch_agrees
    (``kind``: the dtype, or int8). Where cuDNN's batch-size-dependent
    algorithms move a detection or a map past these bounds, both are served
    again with cuDNN off (each frame's convolutions alone), where they must
    hold. Returns the readings over the frames (the largest of each; rows,
    moved rows and swaps summed, the largest count of moved rows in a frame
    as ``moved_frame``), the neighbouring frame's fault readings (``apart``)
    and whether cuDNN had to be off (``cudnn_off``)."""

    def compare(a, b):
        each = [batch_agrees(x, y, f"{what}, frame {i}", kind)
                for i, (x, y) in enumerate(zip(a, b))]
        out = {k: (sum if k in ("rows", "moved", "swapped") else max)(e[k] for e in each)
               for k in each[0] if k != "gaps"}
        out["moved_frame"] = max(e["moved"] for e in each)
        out["frames"] = len(each)
        out["apart"] = apart(a, b, kind)
        return out

    try:
        return dict(compare(got(), want()), cudnn_off=False)
    except RuntimeError as e:
        print(f"{what}: with cuDNN's batch-size-dependent algorithms, {e}; held again with "
              "cuDNN off")
    with torch.backends.cudnn.flags(enabled=False):
        a, b = got(), want()
    return dict(compare(a, b), cudnn_off=True)


def held_text(r, kind):
    """What hold_frames compared, and its readings, for a printed line."""
    limit = (f"SERVED_AGAIN_TOL + {BATCH_MAP_RTOL} of the map's largest magnitude"
             if kind == "float32" else f"relative L2 {BATCH_MAP_REL_L2[kind]}")
    maps = ("maps not compared (no row paired)" if not r["rows"] else
            f"maps at most {r['map_abs']:.3e} apart ({r['map_scaled']:.3e} of the map's largest "
            f"magnitude, relative L2 {r['map_rel']:.3e}; limit {limit}), label pixels "
            f"differing {r['share']:.2e}")
    f = r["apart"]
    return (f"{r['rows']} rows of {r['frames']} frames compared"
            f"{' (cuDNN off)' if r['cudnn_off'] else ''}: classes exact, box gaps at most "
            f"{r['box']:.3e} (limit {BATCH_BOX_TOL[kind]}), scores within {r['score']:.3e} "
            f"(limit {BATCH_SCORE_TOL[kind]}), {r['swapped']} rows paired out of order, "
            f"{r['moved']} rows without a partner (at most {r['moved_frame']} a frame, limit "
            f"{BATCH_MOVED_ROWS[kind]}; the largest score margin of one above the cutoff "
            f"{r['margin']:.3e}); {maps}; planted fault, each frame against its neighbour: at "
            f"least {f['moved']} rows without a partner, maps at relative L2 "
            f"{fmt(f['rel'], '.3e')}, label pixels differing {fmt(f['share'], '.3e')}")


def hold_box_decisions(torch, pred, imgs, what):
    """The batch's box-stage decisions given each frame's own box-head
    outputs: each frame's request alone up to its box head (preprocess,
    backbone, RPN, ``box_head_forward``), then ``box_stage_decisions`` once
    for the frames together (one class-aware NMS launch over B problems, a
    top-D per frame) against it for each frame alone: boxes, scores,
    classes and validity equal bit for bit."""
    from densepose_tpu_torch.models.rcnn import image_tensor
    from densepose_tpu_torch.models.roi_heads import box_head_forward, box_stage_decisions
    from densepose_tpu_torch.models.rpn import rpn_forward_batch
    model, cfg = pred.model, pred.cfg
    with torch.inference_mode():
        inputs = []
        for img in imgs:
            x, _, hw = model.preprocess(image_tensor(img, pred.device))
            feats = model.backbone(x)
            props, _, pvalid = rpn_forward_batch(model.proposal_generator.rpn_head, feats, hw,
                                                 cfg)
            inputs.append(box_head_forward(model.roi_heads, feats, props, cfg) + (props, pvalid))
        got = box_stage_decisions(*(torch.cat(t) for t in zip(*inputs)), cfg)
        for i, one in enumerate(inputs):
            want = box_stage_decisions(*one, cfg)
            for name, g, w in zip(("boxes", "scores", "classes", "valid"), got, want):
                check(torch.equal(g[i], w[0]), f"{what}, frame {i}: the batch's {name} differ "
                      "from the frame's given the same box-head outputs")
    print(f"{what}: the box stage's decisions for {len(imgs)} frames at once equal each "
          "frame's alone given the same box-head outputs, bit for bit")


def hold_densepose_stage(torch, pred, imgs, what, dtype="float32"):
    """The batched DensePose stage given the frames' own inputs: each frame's
    features and detection boxes from its request alone (``forward_stage1``),
    stacked, through ``forward_densepose_batch`` (one pooler launch with the
    frame index, the head over B * D rows) against ``forward_densepose`` of
    each frame: every map within SERVED_AGAIN_TOL plus BUCKET_RTOL (and, at a
    half dtype, 4 units in its last place) of the map's largest magnitude,
    the bound of the detection-bucket phase (cuDNN picks its algorithms by
    the rows). Also reads a planted fault: each frame's maps on its valid
    rows with the boxes moved right by one pooling sample (a box's width
    over POOLER_RESOLUTION * POOLER_SAMPLING_RATIO) against the maps as
    served. Returns the largest difference over that bound's scale, and of
    the fault over the frames the smallest: largest difference over that
    bound's scale, over the map's largest magnitude, and relative L2
    distance."""
    from densepose_tpu_torch.models.rcnn import image_tensor
    rtol = BUCKET_RTOL + 4 * EPS.get(dtype, 0.0)
    h = pred.cfg.MODEL.ROI_DENSEPOSE_HEAD
    step = h.POOLER_RESOLUTION * max(h.POOLER_SAMPLING_RATIO, 1)
    worst, faults = 0.0, []
    with torch.inference_mode():
        singles = [pred.model.forward_stage1(image_tensor(img, pred.device)) for img in imgs]
        feats = {k: torch.cat([s[1][k] for s in singles]) for k in singles[0][1]}
        got = pred.model.forward_densepose_batch(feats, torch.stack([s[2] for s in singles]))
        for i, (result, f, boxes) in enumerate(singles):
            served = pred.model.forward_densepose(f, boxes)
            for k, v in served.items():
                top = float(v.float().abs().max())
                e = float((got[k][i].float() - v.float()).abs().max())
                check(e <= SERVED_AGAIN_TOL + rtol * top, f"{what}, frame {i}: {k} differs by "
                      f"{e:.3e} (largest magnitude {top:.3e})")
                worst = max(worst, e / (SERVED_AGAIN_TOL + rtol * top))
            shift = (boxes[:, 2] - boxes[:, 0]) / step
            moved = pred.model.forward_densepose(
                f, boxes + torch.stack([shift, 0 * shift, shift, 0 * shift], 1))
            valid = result["valid"]
            fault = [0.0, 0.0, 0.0]
            for k, v in served.items():
                x, y = moved[k][valid].float(), v[valid].float()
                top = float(y.abs().max())
                e = float((x - y).abs().max())
                fault = [max(fault[0], e / (SERVED_AGAIN_TOL + rtol * top)),
                         max(fault[1], e / top), max(fault[2], rel_l2(x.cpu(), y.cpu()))]
            faults.append(fault)
    return (worst,) + tuple(min(f[j] for f in faults) for j in range(3))


def stage_text(stage, dtype="float32"):
    """hold_densepose_stage's readings for a printed line."""
    worst, ratio, scaled, rel = stage
    return (f"the batched DensePose stage given each frame's own features and boxes: every "
            f"map within {worst:.3f} of its bound (SERVED_AGAIN_TOL + "
            f"{BUCKET_RTOL + 4 * EPS.get(dtype, 0.0):.3g} of its largest magnitude); planted "
            f"fault, the boxes moved by one pooling sample: at least {ratio:.3g} times that "
            f"bound, {scaled:.3e} of the map's largest magnitude, relative L2 {rel:.3e}")


def batch_site(torch, report, kind, dtype, args, kw, site, key="batched_sites"):
    """One kernel call kept from a batch (or a sharded request), timed (CUDA
    events around back-to-back calls) beside its plain version, its largest
    difference from it and its bound for this call's work; added to the
    kernel's ``key`` sites on the kernels line. Returns the entry."""
    from densepose_tpu_torch.ops import conv_int8, nms, roi_align, roi_align_sparse
    name = {"k1": "nms_keep_cuda", "k2": "roi_align_cuda", "k3": "roi_align_sparse_cuda",
            "q1": Q1}[kind]
    kernel = counters()[name]
    plain = {"k1": nms.nms_keep_plain, "k2": roi_align.roi_align_plain,
             "k3": roi_align_sparse.roi_align_sparse_plain, "q1": conv_int8.conv_s8_plain}[kind]
    ms = cuda_ms(lambda: kernel(*args, **kw), reps=20)
    plain_ms = cuda_ms(lambda: plain(*args, **kw), reps=2, warmup=1)
    got, want = kernel(*args, **kw), plain(*args, **kw)
    err = float((got.float() - want.float()).abs().max()) if want.numel() else 0.0
    if kind == "k1":
        boxes, valid, thr, classes = args
        b_ms, by = bound(*nms_work(boxes, valid, plain(*args), thr, classes))
        shape = f"P={boxes.shape[0]} K={boxes.shape[1]}"
    elif kind == "q1":
        qx, qw = args[:2]
        out = kw["out_kind"]
        out_bytes = OUT_BYTES[out] if isinstance(out, str) else \
            torch.empty((), dtype=out).element_size()
        st, pad, dil = (int(np.atleast_1d(kw[k])[0]) for k in ("stride", "padding", "dilation"))
        b_ms, by = bound_int8(*q1_work(*qx.shape, qw.shape[0], qw.shape[1], st, pad, dil,
                                       kw["transposed"], out_bytes))
        shape = f"{tuple(qx.shape)} x {tuple(qw.shape)}"
    else:
        b_ms, by = bound(*roi_align_work(*args))
        shape = f"M={args[1].shape[0]} levels={len(args[0])} frames={args[0][0].shape[0]}"
    entry = {"site": site, "shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
             "bound_by": by, "max_abs_err": err}
    report[entry_name(name, dtype)].setdefault(key, []).append(entry)
    print(f"{key.split('_')[0]} site {name} [{dtype}] {site} {shape}: {ms:.4f} ms a call, "
          f"plain {plain_ms:.4f}, bound {b_ms:.6f} ({by}); max abs error {err:.3e}")
    return entry


def batch_run(torch, report, pred, tag, dtype, b, per_batch, seed):
    """``predict_batch`` at batch size ``b``: a warm-up batch, BATCH_TIMED
    timed batches of distinct frames with the launch counters set to 0 just
    before and read just after (``per_batch`` launches a batch, and no plain
    version called), the outputs' shapes and values checked, and one
    profiled batch (the device's busy time and idle share). Returns the
    numbers and the timed batches' frames and outputs."""
    imgs = frames(seed, b * (2 + BATCH_TIMED))
    groups = [np.stack(imgs[i * b:(i + 1) * b]) for i in range(2 + BATCH_TIMED)]
    warm, *timed, profiled = groups
    pred.predict_batch(warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    lat, outs = [], []
    with CountPlain() as plain:
        for g in timed:
            t0 = time.perf_counter()
            out = pred.predict_batch(g)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
        launches = {k: fn.launches for k, fn in counters().items()}
    check(plain.calls == 0, f"batch {tag} B={b}: {plain.calls} plain-version calls")
    count_launches(report, f"{tag} batch {b}", dtype, launches, per_batch, len(timed), "batches")
    peak = torch.cuda.max_memory_allocated() / 2**20
    ms = float(np.median(lat))
    cfg = pred.cfg
    d, dp = cfg.TEST.DETECTIONS_PER_IMAGE, cfg.MODEL.ROI_DENSEPOSE_HEAD
    heat = dp.POOLER_RESOLUTION * 2 * dp.UP_SCALE
    for out in outs:
        check(sorted(k for k in out if k.startswith("pred_densepose_"))
              == sorted(f"pred_densepose_{k}" for k in ("coarse_segm", "fine_segm", "u", "v")),
              f"batch {tag} B={b}: maps {sorted(out)} (a batch returns the raw maps)")
        check(out["det_packed"].shape == (b, d + 1, 7) and out["num_instances"].shape == (b,),
              f"batch {tag} B={b}: det_packed {tuple(out['det_packed'].shape)}")
        check(out["pred_densepose_u"].shape == (b, d, dp.NUM_PATCHES + 1, heat, heat)
              and out["pred_densepose_u"].dtype == getattr(torch, dtype),
              f"batch {tag} B={b}: u {tuple(out['pred_densepose_u'].shape)} "
              f"{out['pred_densepose_u'].dtype}")
        check(bool((out["num_instances"] >= 1).all()), f"batch {tag} B={b}: a frame without "
              "detections")
        check(all(bool(torch.isfinite(v).all()) for v in out.values() if v.is_floating_point()),
              f"batch {tag} B={b}: non-finite outputs")
    busy = breakdown(torch, lambda g: pred.predict_batch(g), profiled, ms)
    row = {"b": b, "ms": ms, "ms_frame": ms / b, "fps": 1e3 * b / ms, "peak_mib": peak,
           "busy_frame": None if busy is None else busy / b,
           "idle": None if busy is None else 1 - busy / ms, "launches": launches}
    return row, timed, outs


def per_frame_loop(torch, pred, imgs):
    """The frame-by-frame loop on the same frames (``__call__``, switched
    DensePose stage): median ms per frame, device-busy ms per frame of one
    profiled request, idle share, peak memory."""
    pred(imgs[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for img in imgs:
        t0 = time.perf_counter()
        pred(img)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**20
    ms = float(np.median(lat))
    busy = breakdown(torch, pred, imgs[-1], ms)
    return {"ms_frame": ms, "fps": 1e3 / ms, "busy_frame": busy,
            "idle": None if busy is None else 1 - busy / ms, "peak_mib": peak}


def fmt(v, spec=".3f"):
    return "not measured" if v is None else format(v, spec)


def batch_flagship(torch, report, dev, extra, smi):
    """The flagship at batch sizes BATCH_SIZES (2 K1 + 2 K2 a batch), beside
    the frame-by-frame loop on the same frames; at BATCH_HELD one batch with
    every launch held against its plain version (each call's time kept for
    the kernels line in fp32), each frame against ``forward_batch`` of that
    frame alone and against the frame-by-frame request, and, in fp32,
    ``data_parallel_forward`` with two replicas on this card and the batched
    streaming loop."""
    from densepose_tpu_torch.models.rcnn import image_tensor
    from densepose_tpu_torch.parallel.mesh import data_parallel_forward
    from densepose_tpu_torch.predictor import DensePosePredictor
    dtype = path_dtype(extra)
    tag = f"{FLAGSHIP} {dtype}"
    pred = DensePosePredictor(path_config(FLAGSHIP, extra), seed=0, device=dev)
    rows = {}
    for b in BATCH_SIZES:
        rows[b], timed, outs = batch_run(torch, report, pred, tag, dtype, b, ON_K2, 40 + b)
        if b == BATCH_HELD:
            held_imgs = timed[0]
        del timed, outs
    loop = per_frame_loop(torch, pred, frames(48, 8))
    with HeldAgainstPlain(torch, f"batch {tag}", keep=dtype == "float32") as held:
        pred.predict_batch(held_imgs)
        torch.cuda.synchronize()
    check(len(held.k1) == 2 and len(held.k2) == 2
          and all(k[4] == BATCH_HELD for k in held.k2),
          f"batch {tag}: held {held.k1} K1 and {held.k2} K2 calls")
    print(f"held: one {tag} batch of {BATCH_HELD}, {held.summary()}")
    if held.keep:
        for (args, kw), site in zip(held.calls["k1"], ("rpn", "box_stage")):
            batch_site(torch, report, "k1", dtype, args, kw, f"{site} at B={BATCH_HELD}")
        for (args, kw), site in zip(held.calls["k2"], ("box_pooler", "densepose_pooler")):
            batch_site(torch, report, "k2", dtype, args, kw, f"{site} at B={BATCH_HELD}")
    del held
    tamed = tamed_predictor(pred)
    pnp = tamed.numpy_outputs
    with torch.inference_mode():
        alone = lambda: [pnp(frame_of(tamed.model.forward_batch(
            image_tensor(img, dev)[None]), 0)) for img in held_imgs]
        batched = lambda: [pnp(frame_of(out, i)) for out in [tamed.predict_batch(held_imgs)]
                           for i in range(BATCH_HELD)]
        held_alone = hold_frames(torch, batched, alone, f"batch {tag}: a batch of "
                                 f"{BATCH_HELD} against forward_batch of each frame alone", dtype)
        held_call = hold_frames(torch, batched,
                                lambda: [tamed.predict_numpy(img) for img in held_imgs],
                                f"batch {tag}: the valid rows against the frame-by-frame "
                                "requests", dtype)
    stage = hold_densepose_stage(torch, tamed, held_imgs, f"batch {tag}: the DensePose stage "
                                 "given each frame's features and boxes", dtype)
    hold_box_decisions(torch, tamed, held_imgs, f"batch {tag}")
    del tamed
    pnp = pred.numpy_outputs
    for what, held in (("forward_batch of each frame alone", held_alone),
                       ("the frame-by-frame request (switched stage) on the valid rows",
                        held_call)):
        print(f"batch {tag}: a batch of {BATCH_HELD} against {what}: {held_text(held, dtype)}")
    print(f"batch {tag}: {stage_text(stage, dtype)}")
    if dtype == "float32":
        dp = data_parallel_forward(pred.model, [dev, dev])
        zero_counters()
        got = dp(torch.from_numpy(held_imgs).to(dev))
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters().items()}
        check(launches["nms_keep_cuda"] == 4 and launches["roi_align_cuda"] == 4,
              f"data_parallel_forward: launches {launches}, expected 2 K1 + 2 K2 a shard")
        half = BATCH_HELD // 2
        with torch.inference_mode():
            shards = [pred.model.forward_batch(torch.from_numpy(held_imgs[i:i + half]).to(dev))
                      for i in (0, half)]
        err3 = 0.0
        for i in range(BATCH_HELD):
            err3 = max(err3, served_again(pnp(frame_of(got, i)),
                                          pnp(frame_of(shards[i // half], i % half)),
                                          f"data_parallel_forward frame {i}")[0])
        print(f"batch {tag}: data_parallel_forward over two replicas on {dev} (a correctness "
              f"check: one card), {BATCH_HELD} frames in shards of {half}: launches {launches}, "
              f"each frame against forward_batch of its shard: detections exact, maps within "
              f"{err3:.3e}")
        del dp, got, shards
        batch_consumer(torch, report, pred, tag)
    for b, r in rows.items():
        print(f"batch {tag} B={b}: {r['ms']:.2f} ms a batch, {r['ms_frame']:.2f} ms a frame, "
              f"{r['fps']:.2f} frames/s, device busy {fmt(r['busy_frame'])} ms a frame, idle "
              f"share {fmt(r['idle'], '.4f')}, peak memory {r['peak_mib']:.1f} MiB; launches "
              f"{r['launches']} over {BATCH_TIMED} batches; nvidia-smi: {smi}")
    print(f"batch {tag}: frame-by-frame loop {loop['ms_frame']:.2f} ms a frame, "
          f"{loop['fps']:.2f} frames/s, device busy {fmt(loop['busy_frame'])} ms a frame, idle "
          f"share {fmt(loop['idle'], '.4f')}, peak memory {loop['peak_mib']:.1f} MiB; "
          f"nvidia-smi: {smi}")


def batch_consumer(torch, report, pred, tag):
    """The batched streaming loop: ``stream(..., batch=4)`` over
    BATCH_STREAM_FRAMES frames (the tail group padded with its last frame),
    each frame's outputs bit-exact to ``numpy_outputs_batch`` of blocking
    copies of the same batch, 2 K1 + 2 K2 a batch, the overlays uint8 of the
    frame's shape; ms a frame beside the frame-by-frame loop's."""
    from densepose_tpu_torch.parallel.pipeline import stream
    from densepose_tpu_torch.predictor import fetch_subset
    from densepose_tpu_torch.visualizer import End2EndVisualizer
    imgs = frames(9, BATCH_STREAM_FRAMES)
    vis = End2EndVisualizer(alpha=0.7, keep_bg=False, cmap=chip_colormap())
    fetch = vis.fetch_keys()
    runs = {}
    for batch in (1, BATCH_HELD):
        rec, overlays, kept = RecordingVisualizer(vis), [], KeepOutputs(pred)
        zero_counters()
        t0 = time.perf_counter()
        t_frames, steady = stream(kept, rec, [f.copy() for f in imgs], overlays.append,
                                  batch=batch)
        torch.cuda.synchronize()
        runs[batch] = ((time.perf_counter() - t0) * 1e3 / len(imgs),
                       steady * 1e3 / max(t_frames, 1))
        launches = {k: fn.launches for k, fn in counters().items()}
        groups = -(-len(imgs) // batch)
        check(len(kept.outs) == groups and launches["nms_keep_cuda"] == 2 * groups
              and launches["roi_align_cuda"] == 2 * groups,
              f"batch consumer {tag} batch {batch}: {len(kept.outs)} dispatches, {launches}")
        check(len(overlays) == len(rec.outs) == len(imgs), f"batch consumer {tag}: "
              f"{len(overlays)} overlays for {len(imgs)} frames")
        for i, (img, ov) in enumerate(zip(imgs, overlays)):
            check(ov.dtype == np.uint8 and ov.shape == img.shape, f"batch consumer {tag} "
                  f"frame {i}: overlay {ov.dtype} {ov.shape}")
        if batch > 1:
            for g, out in enumerate(kept.outs):
                count = min(batch, len(imgs) - g * batch)
                blocking = {k: v.cpu() for k, v in fetch_subset(out, fetch).items()}
                for j, want in enumerate(pred.numpy_outputs_batch(blocking, keys=fetch,
                                                                  count=count)):
                    check(same_outputs(rec.outs[g * batch + j], want),
                          f"batch consumer {tag} frame {g * batch + j}: the streamed fetch "
                          "differs from a blocking copy of the same batch")
        del kept
    print(f"batch consumer {tag}: stream at batch {BATCH_HELD} over {len(imgs)} frames (the "
          f"tail padded): each frame bit-exact to a blocking copy of its batch; "
          f"{runs[BATCH_HELD][0]:.2f} ms a frame "
          f"(steady state {runs[BATCH_HELD][1]:.2f}) against {runs[1][0]:.2f} ({runs[1][1]:.2f}) "
          f"at batch 1")


def batch_int8(torch, report, dev, extra, b, smi):
    """An int8 flagship calibrated on CALIB_FRAMES frames at batch ``b``: the
    Q1 launches a batch one request's (not ``b`` times), one batch with every
    K1, K2 and Q1 launch held against its plain version (the head's links on
    the wgmma variant, each call's time kept for the kernels line at
    BATCH_HELD), each frame against ``forward_batch`` alone."""
    from densepose_tpu_torch.models.rcnn import image_tensor
    from densepose_tpu_torch.predictor import DensePosePredictor
    tag = FLAGSHIP + "".join(f", {k}={v}" for k, v in extra)
    pred = DensePosePredictor(path_config(FLAGSHIP, extra), seed=0, device=dev)
    pred.calibrate_int8(frames(7, CALIB_FRAMES))
    per_batch = dict(ON_K2, **{Q1: q1_per_request(pred)})
    row, timed, outs = batch_run(torch, report, pred, tag, "float32", b, per_batch, 60 + b)
    with HeldAgainstPlain(torch, f"batch int8 {tag}", keep=b == BATCH_HELD) as held:
        pred.predict_batch(timed[0])
        torch.cuda.synchronize()
    check(len(held.k1) == 2 and len(held.k2) == 2 and len(held.q1) == per_batch[Q1],
          f"batch int8 {tag}: held {len(held.k1)} K1, {len(held.k2)} K2, {len(held.q1)} Q1")
    res = pred.cfg.MODEL.ROI_DENSEPOSE_HEAD.POOLER_RESOLUTION
    rows = b * pred.cfg.TEST.DETECTIONS_PER_IMAGE  # the head's and predictor's links
    head = [k[0] == rows * res * res and k[3] == (res, res) for k in held.q1]
    check(sum(head) == pred.cfg.MODEL.ROI_DENSEPOSE_HEAD.NUM_STACKED_CONVS + 1
          and all(k[4] == "wgmma" for k, h in zip(held.q1, head) if h),
          f"batch int8 {tag}: the head's links at {rows} rows {held.q1}")
    print(f"held: one int8 {tag} batch of {b}, {held.summary()}")
    if held.keep:
        (args, kw), = [c for c, h in zip(held.calls["q1"], head) if h][:1]
        batch_site(torch, report, "q1", "float32", args, kw, f"head link at B={b}")
    del held
    tamed = tamed_predictor(pred)
    tamed.calibrate_int8(frames(7, CALIB_FRAMES))
    pnp = tamed.numpy_outputs
    with torch.inference_mode():
        held = hold_frames(
            torch, lambda: [pnp(frame_of(out, i)) for out in [tamed.predict_batch(timed[0])]
                            for i in range(b)],
            lambda: [pnp(frame_of(tamed.model.forward_batch(image_tensor(img, dev)[None]), 0))
                     for img in timed[0]],
            f"batch int8 {tag}: a batch of {b} against each frame alone", "int8")
    stage = hold_densepose_stage(torch, tamed, timed[0], f"batch int8 {tag}: the DensePose "
                                 "stage given each frame's features and boxes")
    hold_box_decisions(torch, tamed, timed[0], f"batch int8 {tag}")
    del tamed
    print(f"batch int8 {tag} B={b}: {row['ms']:.2f} ms a batch, {row['ms_frame']:.2f} ms a "
          f"frame, {row['fps']:.2f} frames/s, device busy {fmt(row['busy_frame'])} ms a frame, "
          f"idle share {fmt(row['idle'], '.4f')}, peak memory {row['peak_mib']:.1f} MiB; "
          f"{per_batch[Q1]} Q1 launches a batch; each frame against forward_batch alone: "
          f"{held_text(held, 'int8')}; {stage_text(stage)}; nvidia-smi: {smi}")


def batch_legacy(torch, report, dev, b, smi):
    """R101 legacy with DENSEPOSE_TPU_SPARSE_POOLER at batch ``b``: 2 K1 and
    2 K3 launches a batch (K3 takes every frame's boxes in one launch), one
    batch with every launch held against its plain version (each K3 call's
    time kept for the kernels line), each frame against ``forward_batch``
    alone."""
    from densepose_tpu_torch.models.rcnn import image_tensor
    from densepose_tpu_torch.predictor import DensePosePredictor
    tag = f"{LEGACY} with {SPARSE_POOLER}=1"
    pred = DensePosePredictor(path_config(LEGACY), seed=0, device=dev)
    os.environ[SPARSE_POOLER] = "1"
    try:
        row, timed, outs = batch_run(torch, report, pred, tag, "float32", b, ON_K3, 70 + b)
        with HeldAgainstPlain(torch, f"batch {tag}", keep=True) as held:
            pred.predict_batch(timed[0])
            torch.cuda.synchronize()
        check(len(held.k1) == 2 and not held.k2 and len(held.k3) == 2
              and all(k[4] == b for k in held.k3),
              f"batch {tag}: held {held.k1} K1, {held.k2} K2 and {held.k3} K3 calls")
        print(f"held: one {tag} batch of {b}, {held.summary()}")
        for (args, kw), site in zip(held.calls["k3"], ("box_pooler", "legacy_densepose_pooler")):
            batch_site(torch, report, "k3", "float32", args, kw, f"{site} at B={b}")
        del held
        tamed = tamed_predictor(pred)
        pnp = tamed.numpy_outputs
        with torch.inference_mode():
            held = hold_frames(
                torch, lambda: [pnp(frame_of(out, i)) for out in
                                [tamed.predict_batch(timed[0])] for i in range(b)],
                lambda: [pnp(frame_of(tamed.model.forward_batch(image_tensor(img, dev)[None]),
                                      0)) for img in timed[0]],
                f"batch {tag}: a batch of {b} against each frame alone")
        stage = hold_densepose_stage(torch, tamed, timed[0], f"batch {tag}: the DensePose "
                                     "stage given each frame's features and boxes")
        hold_box_decisions(torch, tamed, timed[0], f"batch {tag}")
        del tamed
    finally:
        os.environ.pop(SPARSE_POOLER, None)
    print(f"batch {tag} B={b}: {row['ms']:.2f} ms a batch, {row['ms_frame']:.2f} ms a frame, "
          f"{row['fps']:.2f} frames/s, device busy {fmt(row['busy_frame'])} ms a frame, idle "
          f"share {fmt(row['idle'], '.4f')}, peak memory {row['peak_mib']:.1f} MiB; 2 K3 a "
          f"batch; each frame against forward_batch alone: {held_text(held, 'float32')}; "
          f"{stage_text(stage)}; nvidia-smi: {smi}")


def batch_phase(torch, report, dev, smi):
    """Batched frames on this card: the fp32 and float16 flagship at every
    batch size, the int8 flagship at BATCH_HELD and max serving at 2, R101
    legacy on K3 at 2; the seconds each part took."""
    t0 = time.perf_counter()
    parts = [(f"flagship {path_dtype(extra)}", batch_flagship, (extra, smi))
             for extra in ((), FP16)]
    parts += [("int8 flagship", batch_int8, (INT8_HEAD_FLAGS, BATCH_HELD, smi)),
              ("int8 max serving", batch_int8, (INT8_ALL_FLAGS, 2, smi)),
              ("R101 legacy on K3", batch_legacy, (2, smi))]
    for what, run, args in parts:
        run(torch, report, dev, *args)
        torch.cuda.empty_cache()
        print(f"time: batch {what} done {time.perf_counter() - t0:.1f} s into the batch phase")


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


# HRNet narrowed further (tests/test_torch_hrnet.py's): one module of one
# BasicBlock a branch, branches of 8..64 channels, an HRFPN of 32
NARROW_HRNET = [
    ("MODEL.HRNET.STAGE2.NUM_CHANNELS", [8, 16]),
    ("MODEL.HRNET.STAGE3.NUM_CHANNELS", [8, 16, 32]),
    ("MODEL.HRNET.STAGE4.NUM_CHANNELS", [8, 16, 32, 64]),
    ("MODEL.HRNET.STAGE2.NUM_MODULES", 1), ("MODEL.HRNET.STAGE3.NUM_MODULES", 1),
    ("MODEL.HRNET.STAGE4.NUM_MODULES", 1),
    ("MODEL.HRNET.STAGE2.NUM_BLOCKS", [1, 1]), ("MODEL.HRNET.STAGE3.NUM_BLOCKS", [1, 1, 1]),
    ("MODEL.HRNET.STAGE4.NUM_BLOCKS", [1, 1, 1, 1]),
    ("MODEL.HRNET.HRFPN.OUT_CHANNELS", 32)]


# the narrowed TTA of the reference phase: two scales and flips
REF_TTA = (("TEST.AUG.ENABLED", True), ("TEST.AUG.MIN_SIZES", (64, 80)),
           ("TEST.AUG.MAX_SIZE", 128), ("TEST.AUG.FLIP", True))

# card against CPU at a half dtype (reference_check): the ranked scores, and
# the paired detections' maps in units in the last place at their magnitude
REF_SCORE_TOL = {"float16": 2e-3, "bfloat16": 1e-2}
REF_MAP_ULPS = 8


def reference_check(torch, dev, name, sparse, dtype="float32", extra=(), hw=(64, 64)):
    """A narrowed zoo model, card against CPU: in fp32 the same detections
    (count and classes exact, boxes and scores within 1e-3) and SIUV maps
    (1e-3). At a half dtype, with the three detection slots of
    tests/test_e2e.py::TINY, as tests/test_torch_dtype.py::test_end_to_end
    holds the CPU against the JAX package (random weights give near-tied
    detections that roundings may swap): counts and classes exact, the ranked
    scores within REF_SCORE_TOL, and each card detection whose box is within
    test_fp16_mode_runs' envelope (atol 2, rtol 0.1) of a CPU one has that
    one's maps within REF_MAP_ULPS units in the last place; at least one
    pairs up. ``extra``: more config changes (a TTA config gets a
    TTAPredictor); ``hw``: the frame's size."""
    from densepose_tpu_torch.predictor import DensePosePredictor
    from densepose_tpu_torch.tta import TTAPredictor

    changes = NARROW + (NARROW_HRNET if name == HRNET else [])
    if dtype != "float32":
        changes = changes + [("TPU.COMPUTE_DTYPE", dtype), ("TEST.DETECTIONS_PER_IMAGE", 3)]
    cfg = path_config(name, list(changes) + list(extra))
    img = (np.random.RandomState(21).rand(*hw, 3) * 255).astype(np.uint8)

    def predict(device):
        pred = DensePosePredictor(cfg, seed=5, device=device)
        return (TTAPredictor(pred) if cfg.TEST.AUG.ENABLED else pred).predict_numpy(img)

    if sparse:
        os.environ[SPARSE_POOLER] = "1"
    try:
        gpu, cpu = predict(dev), predict("cpu")
    finally:
        os.environ.pop(SPARSE_POOLER, None)
    name = name + "".join(f", {k}={v}" for k, v in extra)
    n = cpu["num_instances"]
    check(gpu["num_instances"] == n >= 1, f"reference {name}: {gpu['num_instances']} vs {n} "
          "detections")
    if dtype != "float32":
        reference_check_half(gpu, cpu, name, sparse, dtype)
        return
    # near-equal random-weight scores may swap order: match detections by box
    order = [np.lexsort(r["pred_boxes"].T[::-1]) for r in (gpu, cpu)]
    err = 0.0
    maps = sorted(k for k in cpu if k.startswith("pred_densepose_"))
    check(maps == sorted(k for k in gpu if k.startswith("pred_densepose_")) and len(maps) >= 2,
          f"reference {name}: maps {maps}")
    for k in ["pred_boxes", "scores", "pred_classes"] + maps:
        a, b = gpu[k][order[0]], cpu[k][order[1]]
        e = float(np.abs(a.astype(np.float64) - b).max())
        check(e <= (0 if k == "pred_classes" else 1e-3), f"reference {name}: {k} differs by {e}")
        err = max(err, e)
    print(f"reference: narrowed {name}{f' with {SPARSE_POOLER}=1' if sparse else ''} on the "
          f"card == on the CPU: {n} detections, {len(maps)} maps, max abs difference "
          f"{err:.3e} (tol 1e-3)")


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


def range_report(torch, pred, img, what="flagship"):
    """One fp32 request with a forward hook on every leaf module: the largest
    |output| of each stage, so that a non-finite output at a half dtype can be
    told from a fault of the port (float16 ends at 65504). Returns the
    largest."""
    stages = {}

    def stage(name):
        parts = name.split(".")
        if parts[0] == "backbone":
            if parts[1] != "bottom_up":
                return "backbone.fpn"
            return "backbone." + (parts[2] if not parts[2].startswith("conv") else "stem")
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
    print(f"range (fp32 {what} request, largest |output| per stage): "
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


# tests/test_realscale_parity.py's DETECTION_TAME: random weights at full
# width give every detection a score of ~1 and a box that the clip collapses
# to the image border; these factors on the detection stage's weights give
# spread scores and boxes of real size, so a comparison of two paths'
# detections means something (the JAX package's bucketing and TTA tests use
# them)
DETECTION_TAME = {"proposal_generator.rpn_head.anchor_deltas": 0.003,
                  "roi_heads.box_head.fc1": 0.2, "roi_heads.box_head.fc2": 0.2,
                  "roi_heads.box_predictor.cls_score": 0.02,
                  "roi_heads.box_predictor.bbox_pred": 0.01}


def tamed_params(cfg, seed=0, params=None):
    """The port's random weights from ``seed`` (or ``params``) with
    DETECTION_TAME applied."""
    from densepose_tpu_torch.predictor import load_params
    params = load_params(cfg, seed=seed) if params is None else params
    return torch_cases().tame(params, DETECTION_TAME)


def tamed_predictor(pred):
    """A predictor of ``pred``'s config on its device with DETECTION_TAME
    weights, for the batch holds (hold_frames and the stages): on random
    weights every detection scores ~1, the top 100 within ~3e-5 of each
    other, so at float16 the top-100 set is a draw among near-tied
    proposals, and R101 legacy's detections and maps do not depend on the
    frame, so a fault could not show."""
    from densepose_tpu_torch.predictor import DensePosePredictor
    return DensePosePredictor(pred.cfg, device=pred.device, params=tamed_params(pred.cfg))




# the CSE consumer: pixels whose closest vertex is held against a CPU float64
# evaluation of the same expression, and the slack allowed there (the card's
# fp32 dot products round in another order than float64: two vertices whose
# scores lie that close may trade places), times 1 + |p|
CSE_SAMPLE = 1000
CSE_TIE = 1e-5


def lookup_gate(pixels, verts, got, what):
    """CSE_SAMPLE of the looked-up pixels against the float64 argmin of -2
    p.v + |v|^2 on the CPU: each chosen vertex within CSE_TIE (1 + |p|) of the
    minimum; every index below the vertex count. Returns (worst slack, share
    of indices equal to the float64 argmin)."""
    n = verts.shape[0]
    check(int(got.max()) < n and int(got.min()) >= 0, f"{what}: an index outside 0..{n - 1}")
    pick = np.random.RandomState(0).permutation(len(got))[:CSE_SAMPLE]
    p = pixels[pick].astype(np.float64)
    v = verts.double().cpu().numpy()
    scores = -2.0 * p @ v.T + (v * v).sum(1)
    slack = scores[np.arange(len(pick)), got[pick]] - scores.min(1)
    limit = CSE_TIE * (1 + np.linalg.norm(p, axis=1))
    check((slack <= limit).all(), f"{what}: a closest vertex {float(slack.max()):.3e} above "
          "the float64 minimum")
    return float(slack.max()), float((got[pick] == scores.argmin(1)).mean())


def cse_phase(torch, report, dev):
    """R50-CSE with tamed detection weights (DETECTION_TAME: boxes of real
    size, not the whole frame) on one frame: 2 K1 + 2 K2 for the request
    (counters 0 just before, read just after); CseResultExtractor on the
    card (vertex embeddings of the SMPL mesh computed there once; each
    instance's embedding resized to its box on the host and its pixels'
    closest vertices looked up on the card in chunks), every lookup timed
    (CUDA events around each call: the pixels' upload and the chunks) apart
    from the host's resizes; then one lookup of a whole 480x640 frame's
    pixels with its chunk size, device ms and peak memory. Gates:
    lookup_gate on the extractor's pixels and on the whole-frame lookup."""
    from densepose_tpu_torch.models import cse
    from densepose_tpu_torch.ops.resize import resize_bilinear_np
    from densepose_tpu_torch.predictor import DensePosePredictor
    from densepose_tpu_torch.visualizer import CseResultExtractor
    cfg = path_config(CSE)
    pred = DensePosePredictor(cfg, device=dev, params=tamed_params(cfg))
    img = frames(9, 1)[0]
    keys = {"pred_densepose_embedding", "pred_densepose_coarse_segm"}
    pred.numpy_outputs(pred(img), keys=keys)
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    out = pred.numpy_outputs(pred(img), keys=keys)
    launches = {k: fn.launches for k, fn in counters().items()}
    count_launches(report, f"{CSE} CSE consumer, tamed weights", "float32", launches, ON_K2, 1)
    n = out["num_instances"]
    check(n >= 1, "cse: no detections")
    extractor = CseResultExtractor(pred)
    mesh = extractor.class_to_mesh[0]
    t0 = time.perf_counter()
    verts = extractor.vertices(mesh)
    torch.cuda.synchronize()
    verts_ms = (time.perf_counter() - t0) * 1e3
    n_vert = verts.shape[0]

    lookups, orig = [], cse.closest_vertices

    def timed(pixels, mesh_embeddings, chunk_elements=cse.LOOKUP_CHUNK_ELEMENTS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        idx = orig(pixels, mesh_embeddings, chunk_elements)
        end.record()
        torch.cuda.synchronize()
        lookups.append((pixels.shape[0], start.elapsed_time(end),
                        (time.perf_counter() - t0) * 1e3))
        return idx

    cse.closest_vertices = timed
    try:
        extractor(out)  # warm-up
        lookups.clear()
        t0 = time.perf_counter()
        results, boxes = extractor(out)
        total_ms = (time.perf_counter() - t0) * 1e3
    finally:
        cse.closest_vertices = orig
    check(len(results) == n and len(lookups) == n, f"cse: {len(results)} results and "
          f"{len(lookups)} lookups for {n} detections")
    pixels, got = [], []
    for i, res in enumerate(results):
        x, y, w, h = [int(q) for q in boxes[i]]
        emb = np.transpose(out["pred_densepose_embedding"][i], (1, 2, 0)).astype(np.float32)
        emb = resize_bilinear_np(emb, (max(h, 1), max(w, 1))).reshape(-1, emb.shape[-1])
        m = res["mask"].reshape(-1)
        check(res["closest_vertices"].shape == res["mask"].shape, "cse: result shapes")
        pixels.append(emb[m])
        got.append(res["closest_vertices"].reshape(-1)[m])
    pixels, got = np.concatenate(pixels), np.concatenate(got)
    check(len(got) >= CSE_SAMPLE, f"cse: only {len(got)} foreground pixels")
    slack, agree = lookup_gate(pixels, verts, got, "cse extractor")
    sizes = [int(p) for p, _, _ in lookups]
    lookup_dev = sum(ms for _, ms, _ in lookups)
    lookup_wall = sum(ms for _, _, ms in lookups)

    # one whole frame's pixels: the size the chunks are for
    emb0 = np.transpose(out["pred_densepose_embedding"][0], (1, 2, 0)).astype(np.float32)
    whole = resize_bilinear_np(emb0, FRAME_HW).reshape(-1, emb0.shape[-1])
    whole_dev = torch.from_numpy(whole).to(dev)
    rows = max(1, cse.LOOKUP_CHUNK_ELEMENTS // n_vert)
    cse.closest_vertices(whole_dev, verts)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    whole_ms = cuda_ms(lambda: cse.closest_vertices(whole_dev, verts), reps=3, warmup=0)
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    whole_idx = cse.closest_vertices(whole_dev, verts).cpu().numpy()
    w_slack, w_agree = lookup_gate(whole, verts, whole_idx, "cse whole-frame lookup")
    print(f"cse: {CSE} with tamed detection weights, one {FRAME_HW[0]}x{FRAME_HW[1]} frame: "
          f"{n} detections, kernel launches {launches}; mesh {mesh} ({n_vert} vertices), vertex "
          f"embeddings on the card in {verts_ms:.2f} ms (first call); extractor "
          f"{total_ms:.2f} ms: {len(lookups)} lookups of {sum(sizes)} pixels (boxes "
          f"{min(sizes)}..{max(sizes)} pixels) {lookup_dev:.3f} device ms ({lookup_wall:.2f} "
          f"ms of host wall), host resizes and masks {total_ms - lookup_wall:.2f} ms; "
          f"{CSE_SAMPLE} foreground pixels within {slack:.3e} of the float64 minimum (limit "
          f"{CSE_TIE} (1 + |p|)), {agree:.4f} equal to its argmin")
    print(f"cse: whole-frame lookup, {len(whole)} pixels x {n_vert} vertices in chunks of "
          f"{rows} rows ({rows * n_vert * 4 / 2 ** 20:.1f} MiB of fp32 scores a chunk): "
          f"{whole_ms:.3f} ms (CUDA events, the pixels on the card), peak memory above the "
          f"inputs {peak_mib:.1f} MiB; {CSE_SAMPLE} pixels within {w_slack:.3e} of the float64 "
          f"minimum, {w_agree:.4f} equal to its argmin")
    del pred, whole_dev
    torch.cuda.empty_cache()


# geometry phase: four frame sizes, two of which share a bucket (480x640 and
# 470x630 resize to 800x1066 and 799x1072: canvas 832x1088); 360x640 and
# 640x480 fall in 768x1344 and 1088x832
GEOMETRY_QUANT = 64
GEOMETRY_FRAMES = ((480, 640), (470, 630), (360, 640), (640, 480))
GEOMETRY_CANVAS = (768, 1344)  # the 360x640 frame's; kernel_checks holds K2 there
GEOMETRY_REPEATS = 3  # requests a frame on each path; the median is printed
# tests/test_bucketing.py's envelope of the bucketed path against the exact one
# (the 8 best detections of each: at least half matched within 8 px)
ENVELOPE = {"count": 3, "box": 8.0, "score": 0.08}


def envelope(a, b):
    """Count drift, worst matched box (px) and score of ``b`` against ``a``
    (tests/test_bucketing.py's matching of the 8 best detections)."""
    na, nb = a["num_instances"], b["num_instances"]
    k = min(na, nb, 8)
    check(k >= 1, f"envelope: {na} and {nb} detections")
    d = np.array([np.abs(b["pred_boxes"] - a["pred_boxes"][i]).max(1) for i in range(k)])
    nearest = d.argmin(1)
    matched = [i for i in range(k) if d[i, nearest[i]] < ENVELOPE["box"]]
    check(len(matched) >= max(1, k // 2), f"envelope: {len(matched)} of {k} detections matched")
    return (abs(na - nb), max(float(d[i, nearest[i]]) for i in matched),
            max(float(abs(a["scores"][i] - b["scores"][nearest[i]])) for i in matched))


def geometry_phase(torch, report, dev):
    """TPU.GEOMETRY_BUCKET_QUANT 64 on the fp32 flagship with tamed detection
    weights: each frame's canvas, built on the card from the uploaded frame,
    equals the host's bucketize bit for bit; the requests launch 2 K1 and 2
    K2 each (counters 0 just before, read just after); outputs finite; the
    detections against an exact-path predictor with the same weights within
    ENVELOPE. Prints each frame's median request ms of GEOMETRY_REPEATS on
    both paths (after a first pass that met every shape once)."""
    from densepose_tpu_torch.models.rcnn import image_tensor
    from densepose_tpu_torch.predictor import DensePosePredictor
    plain_cfg = path_config(FLAGSHIP)
    params = tamed_params(plain_cfg)
    geo = DensePosePredictor(path_config(FLAGSHIP, (("TPU.GEOMETRY_BUCKET_QUANT",
                                                     GEOMETRY_QUANT),)),
                             device=dev, params=params)
    plain = DensePosePredictor(plain_cfg, device=dev, params=params)
    imgs = [synthetic_frame(np.random.RandomState(40 + i), hw)
            for i, hw in enumerate(GEOMETRY_FRAMES)]
    canvases = set()
    for img in imgs:
        host, sizes = geo.bucketize(img)
        canvas, dsizes = geo.model.bucket_canvas(image_tensor(img, dev), GEOMETRY_QUANT)
        check(torch.equal(canvas.cpu(), torch.from_numpy(host)) and
              tuple(dsizes) == tuple(int(v) for v in sizes),
              f"geometry: the device canvas of a {img.shape[:2]} frame differs from the host's")
        canvases.add(host.shape[:2])
        geo(img), plain(img)  # every shape once
    check(len(canvases) == len(imgs) - 1 and GEOMETRY_CANVAS in canvases,
          f"geometry: canvases {sorted(canvases)}, expected {len(imgs) - 1} (two frames share "
          f"one) with {GEOMETRY_CANVAS}")
    with HeldAgainstPlain(torch, "geometry") as held:
        for img in imgs:
            geo(img)
        torch.cuda.synchronize()
    print(f"geometry: one request a frame, {held.summary()}")
    torch.cuda.synchronize()
    outs, ms = {}, {}
    for pred in (geo, plain):
        for fn in counters().values():
            fn.launches = 0
        outs[pred], ms[pred] = [], []
        for img in imgs:
            lat = []
            for _ in range(GEOMETRY_REPEATS):
                t0 = time.perf_counter()
                out = pred(img)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
            outs[pred].append(out)
            ms[pred].append(float(np.median(lat)))
        if pred is geo:
            launches = {k: fn.launches for k, fn in counters().items()}
    count_launches(report, f"{FLAGSHIP} geometry-bucketed", "float32", launches, ON_K2,
                   len(imgs) * GEOMETRY_REPEATS)
    worst = [0, 0.0, 0.0]
    for i, img in enumerate(imgs):
        g, p = geo.numpy_outputs(outs[geo][i]), plain.numpy_outputs(outs[plain][i])
        for k, v in g.items():
            if isinstance(v, np.ndarray) and v.dtype.kind == "f":
                check(np.isfinite(v).all(), f"geometry: non-finite {k}")
        check(g["pred_densepose_u"].shape[1:] == p["pred_densepose_u"].shape[1:],
              f"geometry: maps {g['pred_densepose_u'].shape} vs {p['pred_densepose_u'].shape}")
        drift = envelope(p, g)
        worst = [max(a, b) for a, b in zip(worst, drift)]
        print(f"geometry: {img.shape[0]}x{img.shape[1]} frame on a "
              f"{'x'.join(map(str, geo.bucketize(img)[0].shape[:2]))} canvas: request "
              f"{ms[geo][i]:.2f} ms bucketed, {ms[plain][i]:.2f} ms exact; {g['num_instances']} vs "
              f"{p['num_instances']} detections, count drift {drift[0]}, matched boxes "
              f"{drift[1]:.3f} px, scores {drift[2]:.4f}")
    check(worst[0] <= ENVELOPE["count"] and worst[1] < ENVELOPE["box"]
          and worst[2] < ENVELOPE["score"], f"geometry: envelope {worst} beyond {ENVELOPE}")
    print(f"geometry: {len(imgs)} frames, canvases equal to the host's, "
          f"{launches} kernel launches; envelope against the exact path: count drift "
          f"{worst[0]}, matched boxes {worst[1]:.3f} px, scores {worst[2]:.4f} (limits "
          f"{ENVELOPE}); request ms bucketed {[round(x, 2) for x in ms[geo]]}, exact "
          f"{[round(x, 2) for x in ms[plain]]}")
    del geo, plain, outs
    torch.cuda.empty_cache()


# detection counts forced onto one request's detections, and the buckets
# each reaches: the switched stage's {8, 32, D} and TPU.BUCKETED_DENSEPOSE's
# {8, 16, 32, 64, D}
FORCED_COUNTS = (5, 12, 20, 50, 100)
# A bucket's rows against the D-slot rows: cuDNN may choose another algorithm
# for another batch size, which sums each dot product in another order, and
# the fp32 rounding of a sum scales with its terms: random weights drive the
# maps to ~600, where an NVIDIA H100 80GB HBM3 (700 W) measured 3.0e-3 at
# bucket 8, and 0 with cuDNN off (the phase checks that witness each run).
# So SERVED_AGAIN_TOL plus BUCKET_RTOL of the map's largest magnitude.
BUCKET_RTOL = 1e-5


def detection_bucket_phase(torch, report, dev):
    """The DensePose stage's detection-count buckets on the card. Random
    weights give 100 detections a frame, so the count is forced: on one
    fp32 flagship request's features and boxes, forward_densepose_switched and
    TPU.BUCKETED_DENSEPOSE's stage 2 run with counts FORCED_COUNTS, and each
    bucket's rows equal the 100-slot rows within SERVED_AGAIN_TOL plus
    BUCKET_RTOL of the map's largest magnitude (cuDNN chooses algorithms by
    batch size); prints each bucket's stage-2 device ms.
    Then two BUCKETED_DENSEPOSE requests (2 K1 + 2 K2 each)."""
    from densepose_tpu_torch.models.rcnn import densepose_bucket, image_tensor
    from densepose_tpu_torch.predictor import DensePosePredictor
    pred = DensePosePredictor(path_config(FLAGSHIP, (("TPU.BUCKETED_DENSEPOSE", True),)),
                              seed=0, device=dev)
    d = pred.cfg.TEST.DETECTIONS_PER_IMAGE
    img = frames(1, 2)[1]
    with torch.inference_mode():
        _, feats, boxes = pred.model.forward_stage1(image_tensor(img, dev))
        full = pred.model.forward_densepose(feats, boxes)
        rows = []
        for count in FORCED_COUNTS:
            sw_b, two_b = densepose_bucket(count, d), pred.stage2_bucket(count)
            switched = pred.model.forward_densepose_switched(feats, boxes, count)
            two = pred.densepose_stage2(feats, boxes, count)
            err = rel = 0.0
            for k, v in full.items():
                check(switched[k].shape[0] == d and two[k].shape[0] == two_b,
                      f"buckets: {k} rows {switched[k].shape[0]}, {two[k].shape[0]}")
                check(not bool(switched[k][sw_b:].any()), f"buckets: {k} not zero past {sw_b}")
                tol = SERVED_AGAIN_TOL + BUCKET_RTOL * float(v.abs().max())
                for got in (switched[k][:count], two[k][:count]):
                    e = float((got.float() - v[:count].float()).abs().max())
                    check(e <= tol, f"buckets: count {count}: {k} rows differ from the "
                          f"{d}-slot rows by {e} > {tol}")
                    err, rel = max(err, e), max(rel, e / float(v.abs().max()))
            two_ms = device_ms(torch, lambda: pred.densepose_stage2(feats, boxes, count), reps=5)
            sw_ms = device_ms(torch, lambda: pred.model.forward_densepose_switched(
                feats, boxes, count), reps=5)
            rows.append((count, two_b, two_ms, sw_b, sw_ms, err, rel))
        with HeldAgainstPlain(torch, "buckets") as held:
            for count in FORCED_COUNTS:
                pred.densepose_stage2(feats, boxes, count)
            torch.cuda.synchronize()
        # the witness of the cause: with cuDNN off, convolutions go through
        # PyTorch's own im2col + GEMM, one sample at a time, so a row cannot
        # depend on the batch size; the smallest bucket's rows must then
        # equal the D-slot rows within SERVED_AGAIN_TOL
        count = FORCED_COUNTS[0]
        torch.backends.cudnn.enabled = False
        try:
            full_nc = pred.model.forward_densepose(feats, boxes)
            two_nc = pred.densepose_stage2(feats, boxes, count)
        finally:
            torch.backends.cudnn.enabled = True
        gap_nc = max(float((two_nc[k][:count].float() - v[:count].float()).abs().max())
                     for k, v in full_nc.items())
        check(gap_nc <= SERVED_AGAIN_TOL, f"buckets: with cuDNN off, bucket "
              f"{pred.stage2_bucket(count)} rows differ from the {d}-slot rows by {gap_nc}")
    del full, switched, two, full_nc, two_nc
    for fn in counters().values():
        fn.launches = 0
    n_req, counts = 2, []
    for img in frames(5, n_req):
        out = pred(img)
        torch.cuda.synchronize()
        n = int(out["num_instances"])
        counts.append(n)
        check(out["pred_densepose_u"].shape[0] == pred.stage2_bucket(n),
              f"buckets: a request of {n} detections has {out['pred_densepose_u'].shape[0]} rows")
    count_launches(report, f"{FLAGSHIP} BUCKETED_DENSEPOSE", "float32",
                   {k: fn.launches for k, fn in counters().items()}, ON_K2, n_req)
    print("buckets: forced counts on one fp32 request's features: "
          + "; ".join(f"count {c}: TPU.BUCKETED_DENSEPOSE bucket {b} stage 2 {t:.3f} device ms, "
                      f"switched bucket {sb} {st:.3f} device ms, rows within {e:.2e} of the "
                      f"{d}-slot rows ({r:.2e} of the map's largest magnitude)"
                      for c, b, t, sb, st, e, r in rows)
          + f" (tol {SERVED_AGAIN_TOL} + {BUCKET_RTOL} of the largest magnitude); with cuDNN "
          f"off, count {FORCED_COUNTS[0]}'s bucket {pred.stage2_bucket(FORCED_COUNTS[0])} rows "
          f"within {gap_nc:.3e} of the {d}-slot rows (tol {SERVED_AGAIN_TOL}); stage 2 at every "
          f"count, {held.summary()}; {n_req} BUCKETED_DENSEPOSE requests of {counts} detections")
    del pred, feats, boxes
    torch.cuda.empty_cache()


def tta_predictor(torch, dev, extra=(), params=None):
    """The flagship wrapped in a TTAPredictor with the config's own TEST.AUG
    (MIN_SIZES 400..1200 in nine steps, MAX_SIZE 4000, FLIP), or ``extra``."""
    from densepose_tpu_torch.predictor import DensePosePredictor
    from densepose_tpu_torch.tta import TTAPredictor
    cfg = path_config(FLAGSHIP, (("TEST.AUG.ENABLED", True),) + tuple(extra))
    return TTAPredictor(DensePosePredictor(cfg, seed=0, device=dev, params=params))


TTA_TIMED = 2


def tta_phase(torch, report, dev, dtype):
    """The flagship at full width under TTA (18 views of a 480x640 frame, up
    to 1200x1600), at ``dtype``: a warm-up and TTA_TIMED distinct frames with
    the counters 0 just before and read just after (per request: 2 K1 a view
    and the merge's, 37; 2 K2 a view, 36); outputs finite, maps fp32 of
    (100, C, 112, 112); the peak memory; then one profiled request split into
    TTA's stage 1, merge, stage 2 and reduce."""
    pred = tta_predictor(torch, dev, (("TPU.COMPUTE_DTYPE", dtype),))
    views = len(pred.min_sizes) * (2 if pred.flip else 1)
    per_request = {"nms_keep_cuda": 2 * views + 1, "roi_align_cuda": 2 * views,
                   "roi_align_sparse_cuda": 0}
    warm, *timed = frames(3, 1 + TTA_TIMED)
    pred(warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters().values():
        fn.launches = 0
    lat, outs = [], []
    for img in timed:
        t0 = time.perf_counter()
        out = pred(img)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = {k: fn.launches for k, fn in counters().items()}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    count_launches(report, f"{FLAGSHIP} TTA {dtype}", dtype, launches, per_request, len(timed))
    d, dp = pred.base.cfg.TEST.DETECTIONS_PER_IMAGE, pred.base.cfg.MODEL.ROI_DENSEPOSE_HEAD
    heat = dp.POOLER_RESOLUTION * 2 * dp.UP_SCALE
    for i, out in enumerate(outs):
        n = int(out["num_instances"])
        check(n >= 1, f"TTA {dtype} request {i}: no detections")
        for k, v in out.items():
            if k.startswith("pred_densepose_"):
                check(v.dtype == torch.float32 and v.shape[0] == d
                      and v.shape[2:] == (heat, heat), f"TTA {dtype}: {k} {v.dtype} "
                      f"{tuple(v.shape)}")
            if v.is_floating_point():
                check(bool(torch.isfinite(v).all()), f"TTA {dtype} request {i}: non-finite {k}")
    del outs
    with HeldAgainstPlain(torch, f"TTA {dtype}") as held:
        pred(warm)
        torch.cuda.synchronize()
    (top_h, top_w), top_levels = main_path_shapes(pred.base.cfg, max(pred.min_sizes),
                                                  pred.max_size)
    check((1, views * d, True) in held.k1, f"TTA {dtype}: no K1 call at the merge's "
          f"K = {views} x {d}, classed")
    check(any(hw == top_levels["p2"] for _, hw, *_ in held.k2),
          f"TTA {dtype}: no K2 call on the {top_h}x{top_w} view's p2 level")
    print(f"TTA {dtype}: one request, {held.summary()}")
    print(f"TTA {dtype}: {views} views of {FRAME_HW[0]}x{FRAME_HW[1]} frames (MIN_SIZES "
          f"{pred.min_sizes}, MAX_SIZE {pred.max_size}, flip {pred.flip}): request ms "
          f"{', '.join(f'{x:.2f}' for x in lat)}; kernel launches {launches}; max memory "
          f"allocated {peak_mib:.1f} MiB")
    breakdown(torch, pred, timed[0], float(np.median(lat)), TTA_STAGES, ("tta_merge",))
    del pred
    torch.cuda.empty_cache()


def single_view_tta(torch, dev):
    """A TTA of one view at the flagship's own resolution (MIN_SIZES (800,),
    MAX_SIZE 1333, no flip), tamed detection weights: the detections are the
    base request's after the merge (its class-aware NMS at the test threshold
    sees the boxes clipped to the frame, so it may drop a base detection;
    the count dropped is printed), exactly; the maps the DensePose stage on
    the merged boxes in the view's coordinates within SERVED_AGAIN_TOL. The
    base request's own maps pool the unclipped network boxes (the
    reference's discarded clip), and the TTA pools the rescaled boxes scaled
    back, in fp32: the detections the two share, paired by box, whose pooled
    box is the same on both (unclipped, and the fp32 round trip exact) hold
    the base request's maps within SERVED_AGAIN_TOL; the others' difference
    is printed, the clipped apart from those the round trip moved."""
    from densepose_tpu_torch.models.rcnn import image_tensor
    from densepose_tpu_torch.tta import merge_detections
    pred = tta_predictor(torch, dev, (("TEST.AUG.MIN_SIZES", (800,)),
                                      ("TEST.AUG.MAX_SIZE", 1333), ("TEST.AUG.FLIP", False)),
                         params=tamed_params(path_config(FLAGSHIP)))
    base = pred.base
    img = frames(1, 2)[1]
    base_out = base(img)
    merged = dict(zip(("pred_boxes", "scores", "pred_classes", "valid"), merge_detections(
        *(base_out[k] for k in ("pred_boxes", "scores", "pred_classes", "valid")),
        pred.nms_thresh, pred.topk)))
    want = base.numpy_outputs(dict(merged, image_size=base_out["image_size"],
                                   num_instances=merged["valid"].sum()))
    base_np = base.numpy_outputs(base_out)
    out = pred(img)
    got = pred.numpy_outputs(out)
    check(got["num_instances"] == want["num_instances"] >= 1,
          f"single-view TTA: {got['num_instances']} vs {want['num_instances']} detections")
    for k in ("pred_boxes", "scores", "pred_classes"):
        check(np.array_equal(got[k], want[k]), f"single-view TTA: {k} differ from the base's")
    with torch.inference_mode():
        res, feats, boxes_net = base.model.forward_stage1(image_tensor(img, dev))
        _, h1, w1 = base.model.resized_size(*FRAME_HW)
        scale = torch.tensor([w1 / FRAME_HW[1], h1 / FRAME_HW[0]] * 2, dtype=torch.float32,
                             device=dev)
        ref = base.model.forward_densepose(feats, out["pred_boxes"] * scale)
    err = max(float((out[k] - v.float()).abs().max()) for k, v in ref.items())
    check(err <= SERVED_AGAIN_TOL, f"single-view TTA: maps differ from the DensePose stage on "
          f"the merged boxes by {err}")
    # the base request's maps, paired by box
    check(torch.equal(res["pred_boxes"], base_out["pred_boxes"]),
          "single-view TTA: stage 1 run again gave other boxes than the base request")
    back = torch.tensor([FRAME_HW[1] / w1, FRAME_HW[0] / h1] * 2, dtype=torch.float32,
                        device=dev)  # the rescale of forward_stage1
    clipped = (boxes_net * back != res["pred_boxes"]).any(1)[base_out["valid"]].cpu().numpy()
    net = boxes_net[base_out["valid"]].cpu().numpy()            # rows of base_np
    pooled = (out["pred_boxes"] * scale)[out["valid"]].cpu().numpy()  # rows of got
    row_of = {b.tobytes(): j for j, b in enumerate(base_np["pred_boxes"])}
    maps = [k for k in got if k.startswith("pred_densepose_")]
    same, rounded, cut = [], [], []
    for i, b in enumerate(got["pred_boxes"]):
        j = row_of.get(b.tobytes())
        check(j is not None, f"single-view TTA: merged box {b} is none of the base's")
        e = max(float(np.abs(got[k][i] - base_np[k][j]).max()) for k in maps)
        (same if np.array_equal(pooled[i], net[j]) else cut if clipped[j] else rounded).append(e)
    check(len(same) >= 1, "single-view TTA: no shared detection pools the same box")
    check(max(same) <= SERVED_AGAIN_TOL, f"single-view TTA: on {len(same)} detections that pool "
          f"the same box, the maps differ from the base request's by {max(same)}")
    print(f"single-view TTA (800, 1333, no flip, tamed weights): {got['num_instances']} "
          f"detections equal to the base request's {base_np['num_instances']} after the "
          f"merge ({base_np['num_instances'] - got['num_instances']} dropped by its NMS on "
          f"the clipped boxes); maps within {err:.3e} of the DensePose "
          f"stage on the merged boxes (tol {SERVED_AGAIN_TOL}); against the base request's "
          f"maps, paired by box: {len(same)} detections pooling the same box within "
          f"{max(same):.3e} (tol {SERVED_AGAIN_TOL}); {len(rounded)} whose box the rescale's "
          f"fp32 round trip moved by an ulp within {max(rounded, default=0.0):.3e}, and "
          f"{len(cut)} clipped within {max(cut, default=0.0):.3e} (no gate)")
    del pred, base, feats, ref, res, boxes_net
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# int8 serving: kernel Q1 at its sites, then the int8 paths
# ---------------------------------------------------------------------------

INT8_FLAGS = ("INT8_HEAD", "INT8_PREDICTOR", "INT8_BACKBONE", "INT8_RPN")
Q1 = "conv_s8_cuda"
Q1_SOURCE = "densepose_tpu_torch/csrc/conv_s8.cu"
# port-only: the JAX package's int8 convolutions are XLA's (no Pallas kernel)
Q1_REPLACES = "densepose_tpu/ops/conv.py:273 (port-only; XLA's int8 conv in JAX)"
Q1_OUTS = ("s32", "s8", "float32", "float16", "bfloat16")
# (site, N, H, W, Cin, Cout, k, stride, padding, dilation, transposed, relu, the
# site's own output): every link kind of the five int8 paths at 480x640 frames
# (800x1088, HRFPN 832x1088), the head and predictor at 8, 32 and 100 rows
Q1_SITES = [
    ("head_first_100", 100, 28, 28, 256, 512, 3, 1, 1, 1, False, True, "s8"),
    ("head_link_8", 8, 28, 28, 512, 512, 3, 1, 1, 1, False, True, "s8"),
    ("head_link_32", 32, 28, 28, 512, 512, 3, 1, 1, 1, False, True, "s8"),
    ("head_link_100", 100, 28, 28, 512, 512, 3, 1, 1, 1, False, True, "s8"),
    ("head_last_100", 100, 28, 28, 512, 512, 3, 1, 1, 1, False, True, "float32"),
    ("gn_link_100", 100, 28, 28, 512, 512, 3, 1, 1, 1, False, False, "float32"),
    ("deconv_77_100", 100, 28, 28, 512, 77, 4, 2, 1, 1, True, False, "float32"),
    ("deconv_77_8", 8, 28, 28, 512, 77, 4, 2, 1, 1, True, False, "float32"),
    ("res3_conv1_s2", 1, 200, 272, 256, 128, 1, 2, 0, 1, False, True, "s8"),
    ("res3_shortcut_s2", 1, 200, 272, 256, 512, 1, 2, 0, 1, False, False, "float32"),
    ("res2_conv2", 1, 200, 272, 64, 64, 3, 1, 1, 1, False, True, "s8"),
    ("res5_conv2_dilated", 1, 50, 68, 512, 512, 3, 1, 2, 2, False, True, "s8"),
    ("fpn_output_p2", 1, 200, 272, 256, 256, 3, 1, 1, 1, False, False, "float32"),
    ("rpn_conv_p2", 1, 200, 272, 256, 256, 3, 1, 1, 1, False, True, "float32"),
    ("hrnet_w32_branch_32", 1, 208, 272, 32, 32, 3, 1, 1, 1, False, True, "s8"),
    ("hrnet_w32_branch_256", 1, 26, 34, 256, 256, 3, 1, 1, 1, False, False, "float32"),
    ("hrnet_w32_reduction_480", 1, 208, 272, 480, 256, 1, 1, 0, 1, False, False, "float32"),
    ("hrnet_w48_branch_48", 1, 208, 272, 48, 48, 3, 1, 1, 1, False, True, "s8"),
    ("hrnet_w48_branch_96", 1, 104, 136, 96, 96, 3, 1, 1, 1, False, False, "float32"),
    ("hrnet_w48_reduction_720", 1, 208, 272, 720, 256, 1, 1, 0, 1, False, False, "float32"),
]
# the Q1 calls of one flagship INT8_HEAD + INT8_PREDICTOR request at 100
# detections: the entry's ms, plain_ms, bound_ms and library_ms sum them
Q1_REQUEST = (("head_first_100", 1), ("head_link_100", 6), ("head_last_100", 1),
              ("deconv_77_100", 1))
# the head's sites, which q1_variant must route to the wgmma variant
Q1_WGMMA_SITES = ("head_first_100", "head_link_8", "head_link_32", "head_link_100",
                  "head_last_100", "gn_link_100")


def q1_work(n, h, w, cin, cout, k, stride, pad, dil, transposed, out_bytes):
    """(bytes, operations) Q1 must move and do at a site: each s8 input and
    weight read once, each output written once with the int32 bias and f32
    vector; 2 operations a product of the taps that meet the input (a
    transposed conv's holes are no work)."""
    import torch
    from densepose_tpu_torch.ops.conv_int8 import out_size
    qw_shape = torch.empty((cout, k, k, cin), device="meta")
    ho, wo = out_size(h, w, qw_shape, stride, pad, dil, transposed)
    taps = (k // stride) ** 2 if transposed else k * k
    m = n * ho * wo
    nbytes = n * h * w * cin + cout * k * k * cin + m * cout * out_bytes + cout * 8
    return nbytes, 2.0 * m * cout * taps * cin


def bound_int8(nbytes, ops):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_INT8_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def q1_yardsticks(torch, F, site, qx, qw, reps):
    """The two times Q1 is held beside at a site, neither called by the port:
    (float16 cuDNN convolution of the same shape, channels-last, in ms;
    torch._int_mm on the unfolded s8 input (the unfold not timed), in ms, or
    None where its shape rules do not admit the site)."""
    _, n, h, w, cin, cout, k, stride, pad, dil, transposed, *_ = site
    x16 = qx.permute(0, 3, 1, 2).half().contiguous(memory_format=torch.channels_last)
    if transposed:
        w16 = qw.permute(3, 0, 1, 2).half().contiguous(memory_format=torch.channels_last)
        lib = lambda: F.conv_transpose2d(x16, w16, stride=stride, padding=pad)
    else:
        w16 = qw.permute(0, 3, 1, 2).half().contiguous(memory_format=torch.channels_last)
        lib = lambda: F.conv2d(x16, w16, stride=stride, padding=pad, dilation=dil)
    lib_ms = cuda_ms(lib, reps)
    kk = k * k * cin
    if transposed or cout % 8 or kk % 8:
        return lib_ms, None
    if k == 1 and stride == 1:
        a = qx.reshape(-1, cin)
    else:
        cols = F.unfold(x16.contiguous(), k, dilation=dil, padding=pad, stride=stride)
        a = cols.transpose(1, 2).reshape(-1, kk).to(torch.int8).contiguous()
        del cols
    if a.shape[0] <= 16:
        return lib_ms, None
    b = qw.permute(3, 1, 2, 0).reshape(kk, cout).t().contiguous().t()  # column-major
    torch._int_mm(a, b)
    torch.cuda.synchronize()
    return lib_ms, cuda_ms(lambda: torch._int_mm(a, b), reps)


def q1_checks(torch, report, dev, ptxas):
    """Q1 at every int8 site shape, with each variant that takes the shape
    (conv_int8.wgmma_takes): the int32 sums and each epilogue output (s8,
    f32, f16, bf16) bit-identical to the plain version's (float64 sums,
    exact), two runs the same bits; the variant conv_int8.q1_variant routes
    the site to, and its times (CUDA events, device events) beside the
    mma_sync variant's in the same run (the row's "before" where wgmma serves
    it), the bound (bytes at 3.35 TB/s or operations at 1979 TOP/s int8) and
    the two yardsticks."""
    import torch.nn.functional as F
    from densepose_tpu_torch.ops import conv_int8
    g = torch.Generator(device=dev).manual_seed(0)
    out_dtype = {"s32": "s32", "s8": "s8", "float32": torch.float32,
                 "float16": torch.float16, "bfloat16": torch.bfloat16}
    sites = {}
    for site in Q1_SITES:
        name, n, h, w, cin, cout, k, stride, pad, dil, transposed, relu, own = site
        qx = torch.randint(-127, 128, (n, h, w, cin), generator=g, device=dev, dtype=torch.int8)
        # weights of a trained layer's spread: most |q| small, some at 127
        qw = (torch.randn((cout, k, k, cin), generator=g, device=dev) * 40).clamp(-127, 127)
        qw = qw.round().to(torch.int8)
        qb = torch.randint(-30000, 30000, (cout,), generator=g, device=dev, dtype=torch.int32)
        geo = dict(stride=stride, padding=pad, dilation=dil, transposed=transposed, relu=relu)
        shape_geo = {k_: v for k_, v in geo.items() if k_ != "relu"}
        routed = conv_int8.q1_variant(qx.shape, qw.shape, **shape_geo)
        variants = (("wgmma", "mma_sync") if conv_int8.wgmma_takes(qx.shape, qw.shape,
                                                                   **shape_geo)
                    else ("mma_sync",))
        acc = conv_int8.conv_s8_plain(qx, qw, qb, None, **geo, out_kind="s32")
        # an epilogue scale that brings the sums to about +-150 (some clip at 127)
        vec = 150.0 / (acc.float().abs().amax(dim=(0, 1, 2)) + 1.0)
        worst = 0.0
        for kind in Q1_OUTS:
            want = conv_int8.conv_s8_plain(qx, qw, qb, vec, **geo, out_kind=out_dtype[kind])
            for variant in variants:
                kw = dict(geo, out_kind=out_dtype[kind], variant=variant)
                got = conv_int8.conv_s8_cuda(qx, qw, qb, vec, **kw)
                again = conv_int8.conv_s8_cuda(qx, qw, qb, vec, **kw)
                torch.cuda.synchronize()
                check(torch.equal(got, again), f"Q1 {name} {kind} {variant}: two runs differ")
                err = float((got.double() - want.double()).abs().max())
                check(torch.equal(got, want), f"Q1 {name} {kind} {variant}: differs from the "
                      f"plain version (max abs {err})")
                worst = max(worst, err)
        big = n * h * w * cin > 10 ** 7
        times = {}
        for variant in variants:
            kw = dict(geo, out_kind=out_dtype[own], variant=variant)
            launch = lambda: conv_int8.conv_s8_cuda(qx, qw, qb, vec, **kw)
            times[variant] = (cuda_ms(launch, reps=20 if big else 50), device_ms(torch, launch))
        kw = dict(geo, out_kind=out_dtype[own])
        plain_ms = cuda_ms(lambda: conv_int8.conv_s8_plain(qx, qw, qb, vec, **kw), reps=3,
                           warmup=1)
        lib_ms, int_mm_ms = q1_yardsticks(torch, F, site, qx, qw, 20 if big else 50)
        out_bytes = {"s8": 1, "float32": 4}[own]
        bound_ms, bound_by = bound_int8(*q1_work(n, h, w, cin, cout, k, stride, pad, dil,
                                                 transposed, out_bytes))
        ms, dev_ms = times[routed]
        sites[name] = {"site": name, "shape": [n, h, w, cin, cout, k, stride, pad, dil],
                       "transposed": transposed, "out": own, "variant": routed,
                       "max_abs_err": worst, "ms": ms, "device_ms": dev_ms,
                       "ms_by_variant": {v: t[0] for v, t in times.items()},
                       "device_ms_by_variant": {v: t[1] for v, t in times.items()},
                       "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": lib_ms, "int_mm_ms": int_mm_ms}
        others = "; ".join(f"{v} {t[0]:.4f} ms [{t[1]:.4f}]" for v, t in times.items()
                           if v != routed)
        print(f"Q1 {Q1} {name}: {n}x{h}x{w}x{cin} -> {cout}, k{k} s{stride} p{pad} d{dil}"
              f"{' transposed' if transposed else ''}: {'/'.join(variants)} each s32/s8/f32/"
              f"f16/bf16 bit-identical to the plain version, two runs equal; routed to "
              f"{routed}: {ms:.4f} ms [{dev_ms:.4f}] ({own} out)"
              f"{f' (before: {others})' if others else ''}, bound {bound_ms:.6f} "
              f"({bound_by}), plain {plain_ms:.4f}, float16 cuDNN {lib_ms:.4f}, _int_mm "
              f"{'n/a' if int_mm_ms is None else f'{int_mm_ms:.4f}'}")
        del qx, qw, acc
        torch.cuda.empty_cache()
    for name in Q1_WGMMA_SITES:
        check(sites[name]["variant"] == "wgmma", f"Q1 {name}: routed to "
              f"{sites[name]['variant']}, not wgmma")
    per_request = [(sites[s], c) for s, c in Q1_REQUEST]
    report[Q1] = {
        "name": Q1, "route": "cuda", "source": Q1_SOURCE, "replaces": Q1_REPLACES,
        "check": "bit-identical (int32 sums, s8, f32, f16, bf16) at every site, each variant "
                 "that takes it, two runs equal",
        "launches": 0, "launches_per_path": {}, "variant_launches_per_path": {},
        "max_abs_err": max(e["max_abs_err"] for e in sites.values()),
        "ms": sum(e["ms"] * c for e, c in per_request),
        "device_ms": sum(e["device_ms"] * c for e, c in per_request),
        "before_ms": sum(e["ms_by_variant"]["mma_sync"] * c for e, c in per_request),
        "plain_ms": sum(e["plain_ms"] * c for e, c in per_request),
        "bound_ms": sum(e["bound_ms"] * c for e, c in per_request),
        "bound_by": "operations",
        "library_ms": sum(e["library_ms"] * c for e, c in per_request),
        "int_mm_ms": sum(e["int_mm_ms"] * c for e, c in per_request if e["int_mm_ms"]),
        "dtype": "int8", "sites": list(sites.values()), "ptxas": ptxas,
    }
    print(f"Q1 {Q1}: one flagship INT8_HEAD + INT8_PREDICTOR request's 9 calls at 100 rows "
          f"({', '.join(sorted({e['variant'] for e, _ in per_request}))}): "
          f"{report[Q1]['ms']:.4f} ms [{report[Q1]['device_ms']:.4f}] (mma_sync "
          f"{report[Q1]['before_ms']:.4f}), bound {report[Q1]['bound_ms']:.6f}, float16 cuDNN "
          f"{report[Q1]['library_ms']:.4f}")


def q1_per_request(pred):
    """Q1 launches a request of a calibrated predictor: one a quantized conv,
    but the four chart deconvs share one launch and the RPN conv takes one a
    level."""
    state = pred.int8_state()
    n = sum(k.endswith(".qweight") for k in state)
    if "roi_heads.densepose_predictor.in_scale" in state:
        n -= 3
    if "proposal_generator.rpn_head.conv.qweight" in state:
        n += len(pred.cfg.MODEL.RPN.IN_FEATURES) - 1
    return n


INT8_HEAD_FLAGS = (("TPU.INT8_HEAD", True), ("TPU.INT8_PREDICTOR", True))
INT8_ALL_FLAGS = INT8_HEAD_FLAGS + (("TPU.INT8_BACKBONE", True), ("TPU.INT8_RPN", True))
# (zoo name, config changes, whether its detections are the fp request's)
INT8_PATHS = [
    (FLAGSHIP, INT8_HEAD_FLAGS, True),
    (FLAGSHIP, INT8_HEAD_FLAGS + FP16, True),
    # the JAX package's headline serving configuration (bench.py:11-17)
    (FLAGSHIP, INT8_HEAD_FLAGS + BF16, True),
    (FLAGSHIP, INT8_ALL_FLAGS, False),  # "max serving"
    (DEEPLAB, (("TPU.INT8_HEAD", True),), True),
    (HRNET, (("TPU.INT8_BACKBONE", True), ("TPU.INT8_HEAD", True)), False),
]
CALIB_FRAMES = 4
# tests/test_int8.py's envelopes of the int8 maps against the fp request's
ENVELOPE_U = 0.15       # max |u8 - u| / max |u| (the V1ConvX head)
ENVELOPE_DL_L2 = 0.08   # DeepLab GN chain: relative L2 of u
ENVELOPE_DL_AGREE = 0.95  # DeepLab: fine-segm argmax agreement


def int8_path(torch, report, dev, name, extra, post_detection):
    """One int8 path at full width: the predictor calibrated by calibrate_int8
    on CALIB_FRAMES distinct frames, then drive_path (warm-up, timed requests
    with their launch counts, Q1's among them, profiled breakdown); the
    saturation report; one request with every K1, K2 and Q1 launch held
    against its plain version; against the same model's fp request (same
    dtype): detections bit-identical where the int8 groups are
    post-detection, and the maps inside tests/test_int8.py's envelopes; the
    flagship's calibration saved and loaded into a second predictor, which
    gives the same int8 state and outputs."""
    import tempfile
    from densepose_tpu_torch.predictor import DensePosePredictor
    dtype = path_dtype(extra)
    tag = name + "".join(f", {k}={v}" for k, v in extra)
    calib = frames(7, CALIB_FRAMES)
    per_request = dict(ON_K2)

    def prepare(pred):
        t0 = time.perf_counter()
        pred.calibrate_int8(calib)
        torch.cuda.synchronize()
        per_request[Q1] = q1_per_request(pred)
        print(f"int8 {tag}: calibrate_int8 on {CALIB_FRAMES} frames in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms; {per_request[Q1]} Q1 launches a "
              f"request, {sum(k.endswith('.in_scale') or '.in_scale_' in k for k in pred.int8_state())} "
              f"scales")

    pred = drive_path(torch, report, dev, name, extra, False, per_request, prepare)
    frame = frames(1, 2)[1]
    rep = pred.saturation_report([frame])
    worst = sorted(rep.items(), key=lambda kv: -kv[1])[:3]
    print(f"int8 {tag}: saturation_report on a timed frame: {len(rep)} sites, max "
          f"{max(rep.values()):.3e}; worst " + ", ".join(f"{k} {v:.3e}" for k, v in worst))
    with HeldAgainstPlain(torch, f"int8 {tag}") as held:
        pred(frame)
        torch.cuda.synchronize()
    check(len(held.k1) == 2 and len(held.k2) == 2 and len(held.q1) == per_request[Q1],
          f"int8 {tag}: held {len(held.k1)} K1, {len(held.k2)} K2, {len(held.q1)} Q1 calls")
    # the DensePose head's links and the predictor's deconvolution: the pooler's
    # resolution (28x28 at full width)
    res = path_config(name, extra).MODEL.ROI_DENSEPOSE_HEAD.POOLER_RESOLUTION
    head = [k[4] for k in held.q1 if k[3] == (res, res)]
    check(bool(head) == any(k.endswith("INT8_HEAD") for k, _ in extra)
          and all(v == "wgmma" for v in head),
          f"int8 {tag}: the head's Q1 calls were served by {head}, not all by wgmma")
    print(f"held: one int8 {tag} request, {held.summary()}")
    fp_cfg = path_config(name, [kv for kv in extra if kv[0].split(".")[-1] not in INT8_FLAGS])
    fp = DensePosePredictor(fp_cfg, seed=0, device=dev, params=path_params(fp_cfg, dev))
    got, want = pred.predict_numpy(frame), fp.predict_numpy(frame)
    del fp
    for k, v in got.items():
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            check(np.isfinite(v).all(), f"int8 {tag}: non-finite {k}")
    n = got["num_instances"]
    line = f"int8 {tag} against the fp request: {n} detections (fp {want['num_instances']})"
    if post_detection:
        for k in ("num_instances", "pred_boxes", "scores", "pred_classes"):
            check(np.array_equal(got[k], want[k]), f"int8 {tag}: {k} differs from the fp "
                  "request's (the int8 groups are post-detection)")
        u8 = got["pred_densepose_u"].astype(np.float64)
        u = want["pred_densepose_u"].astype(np.float64)
        rel = float(np.abs(u8 - u).max() / (np.abs(u).max() + 1e-9))
        if name == DEEPLAB:
            l2 = float(np.linalg.norm(u8 - u) / (np.linalg.norm(u) + 1e-9))
            agree = float(np.mean(got["pred_densepose_fine_segm"].argmax(1)
                                  == want["pred_densepose_fine_segm"].argmax(1)))
            check(l2 < ENVELOPE_DL_L2 and agree > ENVELOPE_DL_AGREE,
                  f"int8 {tag}: u relative L2 {l2}, fine-segm agreement {agree}")
            line += f", detections bit-identical; u relative L2 {l2:.4f} (< {ENVELOPE_DL_L2}), " \
                    f"fine-segm argmax agreement {agree:.4f} (> {ENVELOPE_DL_AGREE})"
        else:
            check(rel < ENVELOPE_U, f"int8 {tag}: u differs by {rel} of its largest magnitude")
            line += f", detections bit-identical; u within {rel:.4f} of max |u| (< {ENVELOPE_U})"
        line += f"; max |u| {float(np.abs(u).max()):.4f}"
    print(line)
    if (name, extra) == (FLAGSHIP, INT8_HEAD_FLAGS):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "flagship.calib.json")
            pred.save_calibration(path)
            again = DensePosePredictor(path_config(name, extra), seed=0, device=dev)
            again.load_calibration(path)
        sa, sb = pred.int8_state(), again.int8_state()
        check(set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa),
              "int8: the loaded calibration's state differs from the saved one's")
        a, b = pred.predict_numpy(frame), again.predict_numpy(frame)
        same = all(np.array_equal(a[k], b[k]) for k in a)
        check(same, "int8: save_calibration -> load_calibration gives other outputs")
        print(f"int8 {tag}: save_calibration -> load_calibration into a second predictor: "
              f"{len(sa)} int8 buffers and every output bit-identical")
        del again
    return pred


def reference_check_int8(torch, dev, name, extra, hw=(64, 64)):
    """A narrowed int8 model, card against CPU: the card calibrates, the CPU
    predictor loads its scales; the quantized weights and scales bit-identical
    on both; detections as reference_check holds them (1e-3), and the maps
    within INT8_REF_RTOL of their largest magnitude (an fp conv summed in
    another order before a quantization may round a value across an s8
    boundary: tests/test_torch_int8.py's rule), with at most INT8_REF_SHARE
    of them beyond 1e-3."""
    from densepose_tpu_torch.predictor import DensePosePredictor
    changes = NARROW + (NARROW_HRNET if name == HRNET else []) + list(extra)
    cfg = path_config(name, changes)
    img = (np.random.RandomState(21).rand(*hw, 3) * 255).astype(np.uint8)
    gpu = DensePosePredictor(cfg, seed=5, device=dev)
    gpu.calibrate_int8([img])
    cpu = DensePosePredictor(cfg, seed=5, device="cpu")
    cpu.load_calibration(gpu.export_calibration())
    sg, sc = gpu.int8_state(), cpu.int8_state()
    check(set(sg) == set(sc) and all(torch.equal(sg[k].cpu(), sc[k]) for k in sg),
          f"reference int8 {name}: quantized state differs card vs CPU")
    a, b = gpu.predict_numpy(img), cpu.predict_numpy(img)
    n = b["num_instances"]
    check(a["num_instances"] == n >= 1, f"reference int8 {name}: {a['num_instances']} vs {n}")
    order = [np.lexsort(r["pred_boxes"].T[::-1]) for r in (a, b)]
    det_err, map_err, share = 0.0, 0.0, 0.0
    for k in ("pred_boxes", "scores", "pred_classes"):
        e = float(np.abs(a[k][order[0]].astype(np.float64) - b[k][order[1]]).max())
        check(e <= (0 if k == "pred_classes" else 1e-3), f"reference int8 {name}: {k} by {e}")
        det_err = max(det_err, e)
    maps = sorted(k for k in b if k.startswith("pred_densepose_"))
    for k in maps:
        x, y = a[k][order[0]].astype(np.float64), b[k][order[1]].astype(np.float64)
        e = np.abs(x - y)
        top = float(np.abs(y).max()) + 1e-12
        check(e.max() <= INT8_REF_RTOL * top, f"reference int8 {name}: {k} by {e.max()} of {top}")
        map_err = max(map_err, float(e.max() / top))
        share = max(share, float(np.mean(e > 1e-3)))
    check(share <= INT8_REF_SHARE, f"reference int8 {name}: {share} of the maps beyond 1e-3")
    print(f"reference: narrowed {name} with {', '.join(k for k, _ in extra)} on the card vs the "
          f"CPU: {len(sg)} int8 buffers bit-identical, {n} detections within {det_err:.3e} "
          f"(tol 1e-3), maps within {map_err:.3e} of their largest magnitude (tol "
          f"{INT8_REF_RTOL}), {share:.4f} of them beyond 1e-3 (tol {INT8_REF_SHARE})")


INT8_REF_RTOL = 2e-2
INT8_REF_SHARE = 0.02


# -- deploy: bundles, the AOT program, the operators' dispatch, evaluation ------

HOST_REPS = 200   # calls a round of the host-time loops
HOST_ROUNDS = 5   # rounds of each route, interleaved; the best is kept
DISPATCH_ADDS_US = 5.0  # what the dispatcher may add to a call routed through it
AOT_TIMED = 3     # requests of each of the program and the eager predictor
EVAL_FRAMES = 8
# square frames: on a landscape frame the RPN's swapped (W, H) clip (a
# reference quirk) keeps proposals below the image, which the final clip
# flattens to zero-height boxes that no box AP can match
EVAL_HW = (640, 640)


def host_us(torch, calls):
    """Host microseconds a call of each of ``calls`` ({route: fn}): rounds of
    HOST_REPS calls with no synchronization inside (the card runs behind),
    the routes interleaved, the best round of each kept."""
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    best = dict.fromkeys(calls, float("inf"))
    for _ in range(HOST_ROUNDS):
        for route, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_REPS):
                fn()
            best[route] = min(best[route], (time.perf_counter() - t0) / HOST_REPS * 1e6)
    torch.cuda.synchronize()
    return best


def dispatch_costs(torch, dev):
    """Each kernel's host time a call through its operator
    (torch.ops.densepose_tpu_torch, what an exported program calls) against
    a direct call of its wrapper (what the model's eager calls make: the
    dispatcher adds more than DISPATCH_ADDS_US to some calls, PERF.md), at a
    flagship site: K1 at the RPN, K2 and K3 at the box pooler, Q1 at a head
    link of 100 rows; both routes' outputs equal."""
    from densepose_tpu_torch.ops import conv_int8, nms, roi_align, roi_align_sparse
    cfg = path_config(FLAGSHIP)
    (hp, wp), levels = main_path_shapes(cfg)
    rng = np.random.RandomState(3)
    ops = torch.ops.densepose_tpu_torch
    b = torch.from_numpy(np.stack([clustered_boxes(rng, 1000, (hp, wp)) for _ in range(5)])).to(dev)
    v = torch.ones((5, 1000), dtype=torch.bool, device=dev)
    feats = [torch.randn(256, h, w, device=dev) for f, (h, w) in levels.items() if f != "p6"]
    rois = torch.from_numpy(clustered_boxes(rng, 1000, (hp, wp))).to(dev)
    lv = torch.from_numpy(rng.randint(0, 4, 1000).astype(np.int32)).to(dev)
    scales = [1 / 4, 1 / 8, 1 / 16, 1 / 32]
    qx = torch.randint(-127, 128, (100, 28, 28, 512), dtype=torch.int8, device=dev)
    qw = torch.randint(-127, 128, (512, 3, 3, 512), dtype=torch.int8, device=dev)
    qb = torch.randint(-500, 500, (512,), dtype=torch.int32, device=dev)
    vec = torch.full((512,), 1e-4, device=dev)
    q1_kw = dict(stride=(1, 1), padding=(1, 1), dilation=(1, 1), transposed=False, relu=True,
                 out_kind="s8")
    sites = {
        "nms_keep_cuda": (lambda: nms.nms_keep_cuda(b, v, 0.7, None),
                          lambda: ops.nms_keep(b, v, 0.7, None)),
        "roi_align_cuda": (lambda: roi_align.roi_align_cuda(feats, rois, lv, scales, (7, 7), 2,
                                                            True),
                           lambda: ops.roi_align(feats, rois, lv, scales, [7, 7], 2, True)),
        "roi_align_sparse_cuda": (
            lambda: roi_align_sparse.roi_align_sparse_cuda(feats, rois, lv, scales, (7, 7), 2,
                                                           True),
            lambda: ops.roi_align_sparse(feats, rois, lv, scales, [7, 7], 2, True)),
        Q1: (lambda: conv_int8.conv_s8_cuda(qx, qw, qb, vec, **q1_kw),
             lambda: ops.conv_s8(qx, qw, qb, vec, [1, 1], [1, 1], [1, 1], False, True,
                                 torch.int8)),
    }
    costs = {}
    for name, (direct, dispatched) in sites.items():
        check(torch.equal(direct(), dispatched()), f"dispatch: {name}'s operator differs from "
              "its wrapper")
        us = host_us(torch, {"direct": direct, "dispatcher": dispatched})
        costs[name] = us
        added = us["dispatcher"] - us["direct"]
        print(f"dispatch: {name} host us a call, dispatcher {us['dispatcher']:.2f} / direct "
              f"{us['direct']:.2f} (adds {added:.2f}; best of {HOST_ROUNDS} rounds of "
              f"{HOST_REPS} calls)")
    worst = max(c["dispatcher"] - c["direct"] for c in costs.values())
    print(f"dispatch: eager calls take the direct route, exported programs the operators; the "
          f"dispatcher adds up to {worst:.2f} us a call (route limit {DISPATCH_ADDS_US})")
    return costs


def device_profile(torch, fn):
    """One call of ``fn`` under torch.profiler: (device busy ms, profiled
    wall ms, device events, device ms by kernel name), or None when the
    profiler sees no device activity. The device mirrors of the model's
    stage ranges (which an exported program does not have) are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and e.name not in STAGES + TTA_STAGES]
    if not device:
        return None
    by_kernel, busy_us, end = {}, 0.0, float("-inf")
    for e in device:
        name = short_kernel_name(e.name)
        by_kernel[name] = by_kernel.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in device):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    return busy_us / 1e3, wall_ms, len(device), by_kernel


class CountPlain:
    """Within the block, every call of a kernel's plain version is counted
    (the operators' CPU kernels look them up in their modules): a program on
    the card must make none."""

    NAMES = (("nms", "nms_keep_plain"), ("roi_align", "roi_align_plain"),
             ("roi_align_sparse", "roi_align_sparse_plain"), ("conv_int8", "conv_s8_plain"))

    def __enter__(self):
        import importlib
        self.calls, self.orig = 0, []
        for mod, name in self.NAMES:
            module = importlib.import_module(f"densepose_tpu_torch.ops.{mod}")
            fn = getattr(module, name)
            self.orig.append((module, name, fn))

            def counted(*a, _fn=fn, **kw):
                self.calls += 1
                return _fn(*a, **kw)
            setattr(module, name, counted)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.orig:
            setattr(module, name, fn)
        return False


def bundle_phase(torch, dev, tmp):
    """Flagship bundles (fp32 and float16) written by export_bundle and loaded
    through run.load_predictor on the card, against predictors built in
    memory from the same weights; then an int8 sidecar calibrated on
    CALIB_FRAMES frames with calibrate_bundle and loaded with the bundle.
    Returns (fp32 bundle, the int8 predictor loaded from it)."""
    from densepose_tpu_torch import export, run
    from densepose_tpu_torch.checkpoint.transform import fold_state, random_torch_state
    from densepose_tpu_torch.models.rcnn import build_model
    from densepose_tpu_torch.predictor import DensePosePredictor
    img = frames(5, 1)[0]
    bundles = {}
    for fp16 in (False, True):
        cfg = path_config(FLAGSHIP, FP16 if fp16 else ())
        t0 = time.perf_counter()
        bundle = export.export_bundle(cfg, "", fp16, tmp, FLAGSHIP)
        secs = time.perf_counter() - t0
        loaded = run.load_predictor(bundle, "", [], device=str(dev))
        # the weights the bundle stores: seed 0's, rounded to float16 with --fp16
        spec = build_model(cfg).spec()
        state = {k: v.astype(np.float16 if fp16 else np.float32)
                 for k, v in random_torch_state(spec, seed=0).items()}
        built = DensePosePredictor(cfg, device=dev, params=fold_state(state, spec))
        a, b = loaded.predict_numpy(img), built.predict_numpy(img)
        dets = [k for k in a if not k.startswith("pred_densepose_")]
        check(same_outputs({k: a[k] for k in dets}, {k: b[k] for k in dets}),
              f"bundle fp{16 if fp16 else 32}: detections differ from the in-memory predictor's")
        err, _ = served_again(a, b, f"bundle fp{16 if fp16 else 32}")
        check(loaded.cfg.TPU.COMPUTE_DTYPE == cfg.TPU.COMPUTE_DTYPE,
              f"bundle: loaded at {loaded.cfg.TPU.COMPUTE_DTYPE}, exported at "
              f"{cfg.TPU.COMPUTE_DTYPE}")
        print(f"bundle fp{16 if fp16 else 32}: export_bundle {secs:.2f} s, "
              f"{os.path.getsize(bundle) / 2**20:.1f} MiB; loaded through load_predictor on the "
              f"card: {a['num_instances']} detections bit-identical to the in-memory predictor's, "
              f"maps within {err:.3e} (SERVED_AGAIN_TOL {SERVED_AGAIN_TOL}: cuDNN's transposed "
              "convolutions add with atomics)")
        bundles[fp16] = bundle
        del loaded, built
    bundle = bundles[False]
    opts = ["TPU.INT8_HEAD", "True", "TPU.INT8_PREDICTOR", "True"]
    cfg8 = path_config(FLAGSHIP, INT8_HEAD_FLAGS)
    calib = frames(7, CALIB_FRAMES)
    t0 = time.perf_counter()
    sidecar = export.calibrate_bundle(cfg8, bundle, calib, str(dev))
    secs = time.perf_counter() - t0
    loaded = run.load_predictor(bundle, "", opts, device=str(dev))
    check(loaded.calibration_source == "sidecar", "bundle int8: the sidecar did not load")
    built = DensePosePredictor(cfg8, seed=0, device=dev)
    built.calibrate_int8(calib)
    sa, sb = loaded.int8_state(), built.int8_state()
    check(set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa),
          "bundle int8: the sidecar's state differs from an in-memory calibration's")
    a, b = loaded.predict_numpy(img), built.predict_numpy(img)
    check(same_outputs(a, b), "bundle int8: outputs differ from the in-memory calibration's")
    print(f"bundle int8: calibrate_bundle on {CALIB_FRAMES} frames {secs:.2f} s -> "
          f"{os.path.basename(sidecar)}; reloaded with the bundle: {len(sa)} int8 buffers and "
          f"every output bit-identical to an in-memory calibration's")
    del built
    return bundle, loaded


def aot_program(torch, report, dev, tmp, tag, pred, per_request, sparse=False):
    """``pred``'s request at FRAME_HW exported (aot_export_bytes), written,
    loaded (aot_load) and run on AOT_TIMED frames with the launch counters set
    to 0 just before and read just after (``per_request`` a request, and no
    plain version); against the eager request on the same frames: counts,
    classes and validity exact, boxes and scores exact, maps within
    SERVED_AGAIN_TOL; the latency of both."""
    from densepose_tpu_torch.predictor import DensePosePredictor
    if sparse:
        os.environ[SPARSE_POOLER] = "1"
    try:
        t0 = time.perf_counter()
        data = pred.aot_export_bytes(FRAME_HW)
        export_s = time.perf_counter() - t0
        path = os.path.join(tmp, f"{tag.split(' ')[0]}_{FRAME_HW[0]}x{FRAME_HW[1]}.pt2")
        with open(path, "wb") as f:
            f.write(data)
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            program = DensePosePredictor.aot_load(f.read())
        load_s = time.perf_counter() - t0
        consts = program.program.constants.values()
        on_host = sum(t.device.type == "cpu" for t in consts if isinstance(t, torch.Tensor))
        warm, *timed = frames(11, 1 + AOT_TIMED)
        program(warm)
        pred(warm)
        torch.cuda.synchronize()
        for fn in counters().values():
            fn.launches = 0
        outs, lat = [], []
        with CountPlain() as plain:
            for img in timed:
                t0 = time.perf_counter()
                outs.append(program(img))
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
        launches = {k: fn.launches for k, fn in counters().items()}
        check(plain.calls == 0, f"aot {tag}: the program called a plain version {plain.calls} "
              "times")
        eager_lat, err = [], 0.0
        for img, out in zip(timed, outs):
            t0 = time.perf_counter()
            want = pred(img)
            torch.cuda.synchronize()
            eager_lat.append((time.perf_counter() - t0) * 1e3)
            check(sorted(out) == sorted(want), f"aot {tag}: keys {sorted(out)}")
            a, b = pred.numpy_outputs(out), pred.numpy_outputs(want)
            check(a["num_instances"] >= 1, f"aot {tag}: no detections")
            e, _ = served_again(a, b, f"aot {tag}")
            err = max(err, e)
        # a request of each under the profiler, twice (the profiler's own
        # first use slows the first): device work against host time
        for _ in range(2):
            prof = {"program": device_profile(torch, lambda: program(timed[0])),
                    "eager": device_profile(torch, lambda: pred(timed[0]))}
    finally:
        os.environ.pop(SPARSE_POOLER, None)
    if None in prof.values():
        print(f"aot {tag}: device profile not measured (the profiler saw no device activity)")
    else:
        (pb, pw, pn, pk), (eb, ew, en, ek) = prof["program"], prof["eager"]
        delta = sorted(set(pk) | set(ek), key=lambda k: -abs(pk.get(k, 0.0) - ek.get(k, 0.0)))
        print(f"aot {tag}: profiled request, program against eager: device busy {pb:.3f} / "
              f"{eb:.3f} ms of {pw:.3f} / {ew:.3f} ms wall, {pn} / {en} device events; "
              "largest differences by kernel (ms): " + "; ".join(
                  f"{k} {pk.get(k, 0.0):.3f} / {ek.get(k, 0.0):.3f}" for k in delta[:4]))
    count_launches(report, f"aot {tag}", path_dtype(()), launches, per_request, AOT_TIMED,
                   "program requests")
    print(f"aot {tag}: aot_export_bytes {export_s:.2f} s, {os.path.getsize(path) / 2**20:.1f} "
          f"MiB .pt2 ({len(consts)} constants, {on_host} on the host), aot_load {load_s:.2f} s; "
          f"{AOT_TIMED} requests of the program "
          f"{', '.join(f'{x:.2f}' for x in lat)} ms (median {np.median(lat):.2f}) against eager "
          f"{', '.join(f'{x:.2f}' for x in eager_lat)} (median {np.median(eager_lat):.2f}); "
          f"launches {launches}, no plain version; detections bit-identical to eager, maps "
          f"within {err:.3e} (SERVED_AGAIN_TOL {SERVED_AGAIN_TOL})")
    os.remove(path)


def evaluate_phase(torch, dev):
    """evaluate() over EVAL_FRAMES synthetic EVAL_HW frames held in memory, on the
    flagship with tamed detection weights (DETECTION_TAME): the ground truth
    is the card's own predictions (boxes, and points sampled from the
    extracted labels and UV, tests/torch_cases.py::self_annotations), so box
    AP and GPS AP must both be 100. cuDNN runs deterministic algorithms for
    the phase, so that the evaluated requests give the ground truth's maps
    bit for bit (its transposed convolutions otherwise add with atomics)."""
    from densepose_tpu_torch.evaluate import evaluate
    from densepose_tpu_torch.predictor import DensePosePredictor
    from densepose_tpu_torch.visualizer import DensePoseResultExtractor
    cfg = path_config(FLAGSHIP)
    pred = DensePosePredictor(cfg, device=dev, params=tamed_params(cfg))
    rng = np.random.RandomState(13)
    imgs = [synthetic_frame(rng, EVAL_HW) for _ in range(EVAL_FRAMES)]
    torch.backends.cudnn.deterministic = True
    try:
        extractor = DensePoseResultExtractor()
        preds = []
        for i, img in enumerate(imgs):
            out = pred.predict_numpy(img)
            preds.append((i, out, extractor(out)))
        anns = torch_cases().self_annotations(preds)
        coco = {"images": [{"id": i, "file_name": f"frame{i}", "height": EVAL_HW[0],
                            "width": EVAL_HW[1]} for i in range(EVAL_FRAMES)],
                "annotations": anns}
        t0 = time.perf_counter()
        res = evaluate(pred, coco, lambda im: imgs[im["id"]])
        secs = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = False
    n = sum(out["num_instances"] for _, out, _ in preds)
    points = sum(len(a["dp_x"]) for a in anns)
    print(f"evaluate: {EVAL_FRAMES} frames, {n} detections, {points} ground-truth points "
          f"({sum(not a['dp_x'] for a in anns)} detections without foreground, ignore regions) "
          f"in {secs:.2f} s: " + json.dumps(res))
    check(res["bbox"]["AP"] == 100.0 and res["densepose_gps"]["AP"] == 100.0,
          f"evaluate: box AP {res['bbox']['AP']}, GPS AP {res['densepose_gps']['AP']} on the "
          "card's own predictions, expected 100")


def deploy_phase(torch, report, dev):
    """Bundles, the AOT programs, the operators' host time and evaluation."""
    import shutil
    import tempfile
    from densepose_tpu_torch.predictor import DensePosePredictor
    dispatch_costs(torch, dev)
    tmp = tempfile.mkdtemp(prefix="densepose-deploy-")
    try:
        bundle, int8_pred = bundle_phase(torch, dev, tmp)
        from densepose_tpu_torch import run
        aot_program(torch, report, dev, tmp, "flagship", run.load_predictor(
            bundle, "", [], device=str(dev)), ON_K2)
        aot_program(torch, report, dev, tmp, "flagship int8", int8_pred,
                    dict(ON_K2, **{Q1: q1_per_request(int8_pred)}))
        del int8_pred
        legacy = DensePosePredictor(path_config(LEGACY), seed=0, device=dev)
        aot_program(torch, report, dev, tmp, f"legacy with {SPARSE_POOLER}=1", legacy, ON_K3,
                    sparse=True)
        del legacy
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    evaluate_phase(torch, dev)

# Spatial sharding of one frame (spatial_phase): SPATIAL_PATHS at full width
# on DETECTION_TAME weights, each frame's rows over this card listed
# SPATIAL_SHARDS times (one replica: a correctness check) and over every card
# where more than one is visible, against the unsharded request of the same
# predictor (forward_batch of the frame: the JAX forward form). cuDNN picks
# its algorithms by the slab's shape, so a slab's convolutions may round
# apart from the whole map's: the detections and maps are held as
# hold_frames holds a batch's frames, the gathered pyramid within
# SPATIAL_FEATURE_TOL of each level's largest magnitude (the int8 chain
# requantizes the fp stem's output, where a last-bit move can step an s8
# value). Each limit sits between the sound readings and the planted fault's,
# a halo one row short at each interior boundary
# (tests/torch_cases.py::halo_one_row_short), PERF.md section 6: on an H100
# the fp32 and int8 pyramids read 0 (cuDNN picks a slab's algorithm as the
# whole map's), float16 up to 2.142e-03, the fault 0.5665 or more. At
# float16 the detections move as a batch's do (BATCH_MOVED_ROWS).
SPATIAL_SHARDS = (2, 4)
SPATIAL_TIMED = 2
SPATIAL_PATHS = [(FLAGSHIP, (), False), (FLAGSHIP, FP16, False), (LEGACY, (), True),
                 (DEEPLAB, (), False), (HRNET, (), False),
                 (FLAGSHIP, INT8_ALL_FLAGS, False)]  # max serving
SPATIAL_FEATURE_TOL = {"float32": 1e-5, "float16": 2e-2, "int8": 1e-2}


def spatial_features(torch, pred, fwd, img):
    """The pyramid of a sharded request (``features_rows``, gathered onto
    the first device) against the backbone on the whole input: each level's
    largest difference over its largest magnitude."""
    with torch.inference_mode():
        got, _, _ = pred.model.features_rows(img, fwd.shards)
        x, _, _ = pred.model.preprocess(img)
        want = pred.model.backbone(x)
        check(sorted(got) == sorted(want), f"spatial: levels {sorted(got)} vs {sorted(want)}")
        gaps = {}
        for k, w in want.items():
            g = got[k]
            check(g.shape == w.shape and g.dtype == w.dtype and g.device == w.device,
                  f"spatial: {k} {tuple(g.shape)} {g.dtype} {g.device} vs {tuple(w.shape)} "
                  f"{w.dtype} {w.device}")
            w = w.float()
            gaps[k] = float((g.float() - w).abs().max() / w.abs().max().clamp_min(1e-30))
    return gaps


def spatial_path(torch, report, dev, name, extra, sparse, smi):
    """One path over each shard set: a warm-up and SPATIAL_TIMED sharded
    requests with the launch counters set to 0 just before and read just
    after (2 K1 + 2 K2 or 2 K3, Q1's backbone links once a shard, no plain
    version called), beside the unsharded request's time on the same frames;
    one sharded request with every K1, K2, K3 and Q1 launch held against its
    plain version (int8, over the most shards: Q1 at a slab of FPN's p2
    output conv timed beside the same conv on the whole map); the holds
    above; the halo and gather copies, rows per shard per level and peak
    memory per device."""
    from densepose_tpu_torch.models.rcnn import image_tensor
    from densepose_tpu_torch.predictor import DensePosePredictor
    cfg = path_config(name, extra)
    dtype = path_dtype(extra)
    int8 = any(k.split(".")[-1] in INT8_FLAGS for k, _ in extra)
    kind = "int8" if int8 else dtype
    tag = name + (f" with {SPARSE_POOLER}=1" if sparse else "") + "".join(
        f", {k}={v}" for k, v in extra)
    t0 = time.perf_counter()
    pred = DensePosePredictor(cfg, device=dev, params=tamed_params(
        cfg, params=path_params(cfg, dev)))
    if int8:
        pred.calibrate_int8(frames(7, CALIB_FRAMES))
    imgs = [image_tensor(img, dev) for img in frames(90, 1 + SPATIAL_TIMED)]
    warm, timed = imgs[0], imgs[1:]
    unsharded = lambda img: pred.model.forward_batch(img[None])  # noqa: E731
    per_request = dict(ON_K3 if sparse else ON_K2)
    if sparse:
        os.environ[SPARSE_POOLER] = "1"
    try:
        with torch.inference_mode():
            unsharded(warm)
            x, _, _ = pred.model.preprocess(warm)
            zero_counters()
            pred.model.backbone(x)
            torch.cuda.synchronize()
            backbone_q1 = counters()[Q1].launches
            lat_whole = []
            for img in timed:
                t1 = time.perf_counter()
                unsharded(img)
                torch.cuda.synchronize()
                lat_whole.append((time.perf_counter() - t1) * 1e3)
        print(f"spatial {tag}: built on DETECTION_TAME weights in "
              f"{time.perf_counter() - t0:.1f} s; {backbone_q1} Q1 launches in the backbone")
        sets = [[dev] * n for n in SPATIAL_SHARDS]
        if torch.cuda.device_count() > 1:
            sets.append([torch.device("cuda", i) for i in range(torch.cuda.device_count())])
        for devices in sets:
            spatial_run(torch, report, pred, tag, dtype, kind, devices, per_request,
                        backbone_q1, warm, timed, lat_whole, smi)
    finally:
        os.environ.pop(SPARSE_POOLER, None)


def spatial_run(torch, report, pred, tag, dtype, kind, devices, per_request, backbone_q1,
                warm, timed, lat_whole, smi):
    """spatial_path over one device list."""
    from densepose_tpu_torch.parallel import halo, spatial_parallel_forward
    n = len(devices)
    cards = sorted({halo.device_key(d)[1] for d in devices})
    what = f"spatial {tag} over {n} shards on cuda:{','.join(map(str, cards))}"
    fwd = spatial_parallel_forward(pred.model, devices)
    check(len({id(r) for r in fwd.shards.replicas}) == len(cards),
          f"{what}: {len({id(r) for r in fwd.shards.replicas})} replicas")
    fwd(warm)
    torch.cuda.synchronize()
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    zero_counters()
    fwd.stats.reset()
    lat, outs = [], []
    with CountPlain() as plain:
        for img in timed:
            t0 = time.perf_counter()
            outs.append(fwd(img))
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        launches = {k: fn.launches for k, fn in counters().items()}
    stats = fwd.stats.as_dict()
    peaks = {f"cuda:{c}": torch.cuda.max_memory_allocated(c) / 2**20 for c in cards}
    check(plain.calls == 0, f"{what}: {plain.calls} plain-version calls")
    expected = dict(per_request)
    if kind == "int8":  # every shard owns rows at every level of a 480x640 frame
        expected[Q1] = q1_per_request(pred) + (n - 1) * backbone_q1
    count_launches(report, what, dtype, launches, expected, len(timed))
    d = pred.cfg.TEST.DETECTIONS_PER_IMAGE
    for out in outs:
        check(out["pred_boxes"].shape == (d, 4) and int(out["num_instances"]) >= 1
              and out["pred_densepose_u"].shape[0] == d
              and out["pred_densepose_u"].dtype == getattr(torch, dtype)
              and all(v.device == out["pred_boxes"].device for v in out.values()),
              f"{what}: outputs {({k: tuple(v.shape) for k, v in out.items()})}")
        check(all(bool(torch.isfinite(v).all()) for v in out.values() if v.is_floating_point()),
              f"{what}: non-finite outputs")
    del outs
    keep = kind == "int8" and n == max(SPATIAL_SHARDS)
    with HeldAgainstPlain(torch, what, keep=keep) as held:
        fwd(timed[0])
        torch.cuda.synchronize()
    pooled = held.k3 if SPARSE_POOLER in os.environ else held.k2
    check(len(held.k1) == 2 and len(pooled) == 2 and len(held.q1) == expected[Q1],
          f"{what}: held {len(held.k1)} K1, {len(held.k2)} K2, {len(held.k3)} K3 and "
          f"{len(held.q1)} Q1 calls")
    print(f"held: one {what} request, {held.summary()}")
    if keep:
        qw = pred.model.backbone.fpn_output2.qweight
        slab = next(c for c in held.calls["q1"] if c[0][1] is qw)
        with HeldAgainstPlain(torch, f"{what}, unsharded", keep=True) as whole, \
                torch.inference_mode():
            pred.model.forward_batch(timed[0][None])
            torch.cuda.synchronize()
        full = next(c for c in whole.calls["q1"] if c[0][1] is qw)
        for (args, kw), site in ((slab, f"FPN p2 output conv, the first of {n} slabs"),
                                 (full, "FPN p2 output conv, the whole map")):
            batch_site(torch, report, "q1", "float32", args, kw, site, key="spatial_sites")
        del whole
    del held
    pnp = pred.numpy_outputs
    with torch.inference_mode():
        r = hold_frames(torch, lambda: [pnp(fwd(img)) for img in timed],
                        lambda: [pnp(frame_of(pred.model.forward_batch(img[None]), 0))
                                 for img in timed],
                        f"{what} against the unsharded request", kind)
    gaps = spatial_features(torch, pred, fwd, timed[0])
    real = halo.fetch_rows
    halo.fetch_rows = torch_cases().halo_one_row_short(real)
    try:
        fault = spatial_features(torch, pred, fwd, timed[0])
    finally:
        halo.fetch_rows = real
    tol = SPATIAL_FEATURE_TOL[kind]
    worst, fault_min = max(gaps.values()), max(fault.values())
    check(worst <= tol, f"{what}: the pyramid differs by {gaps} of each level's largest "
          f"magnitude (limit {tol})")
    check(fault_min > tol, f"{what}: the planted fault's pyramid differs by only {fault}")
    rows = {k: [b[i + 1] - b[i] for i in range(n)] for k, b in stats["levels"].items()}
    per = len(timed)
    across = "one card: a correctness check, speed across cards not measured" \
        if len(cards) == 1 else f"{len(cards)} cards"
    print(f"{what} ({across}): {float(np.median(lat)):.2f} ms a request (median of "
          f"{', '.join(f'{x:.2f}' for x in lat)}) against {float(np.median(lat_whole)):.2f} "
          f"unsharded ({', '.join(f'{x:.2f}' for x in lat_whole)}), same frames and run; "
          f"halo {stats['halo_copies'] / per:.0f} copies, {stats['halo_bytes'] / per / 1e6:.3f} "
          f"MB a request; gather of the other shards' rows {stats['gather_copies'] / per:.0f} "
          f"copies, {stats['gather_bytes'] / per / 1e6:.3f} MB; rows per shard by level {rows}; "
          f"peak memory {', '.join(f'{k} {v:.1f} MiB' for k, v in peaks.items())}; launches "
          f"{launches} over {per} requests; nvidia-smi: {smi}")
    print(f"{what}: against the unsharded request: {held_text(r, kind)}; the pyramid within "
          f"{worst:.3e} of each level's largest magnitude (limit {tol}; by level "
          f"{', '.join(f'{k} {v:.3e}' for k, v in gaps.items())}); planted fault, a halo one "
          f"row short at each interior boundary: up to {fault_min:.3e} "
          f"({', '.join(f'{k} {v:.3e}' for k, v in fault.items())})")


def spatial_phase(torch, report, dev, smi):
    """Spatial sharding of one frame: every path of SPATIAL_PATHS; the
    seconds each took."""
    t0 = time.perf_counter()
    for name, extra, sparse in SPATIAL_PATHS:
        spatial_path(torch, report, dev, name, extra, sparse, smi)
        torch.cuda.empty_cache()
        print(f"time: spatial {name}{''.join(f', {k}={v}' for k, v in extra)} done "
              f"{time.perf_counter() - t0:.1f} s into the spatial phase")


# 4d. the C4 detector, BasicBlock R34 and the RetinaNet FPN (new_backbones_phase)
R34 = (("MODEL.RESNETS.DEPTH", 34), ("MODEL.RESNETS.RES2_OUT_CHANNELS", 64))
NEW_TIMED = 2  # timed requests a path
# per request: the C4 detector's 2 K1 (the RPN's one level, then 80 class
# problems) and 1 K2 (res4); the FPN paths 2 K1 + 2 K2; INT8_BACKBONE on C4 42
# Q1 links (res2..res4: 13 blocks of 3 convs and 3 shortcuts)
ON_C4 = {"nms_keep_cuda": 2, "roi_align_cuda": 1, "roi_align_sparse_cuda": 0, "conv_s8_cuda": 0}
C4_INT8_LINKS = 3 * (3 + 4 + 6) + 3


def new_backbone_paths():
    """(tag, config, weights, launches per request) of the phase: get_cfg()'s
    R50-C4 detector (detectron2's faster_rcnn_R_50_C4_1x) in fp32, at float16
    and with INT8_BACKBONE, on C4_TAME weights (random ones put no box
    inside the frame); the flagship with DEPTH 34 (BasicBlock, res2 64 wide);
    the flagship on the RetinaNet FPN (RPN p3..p7, ROI heads p3..p5); both on
    random weights from seed 0."""
    from densepose_tpu_torch.config import get_cfg
    from densepose_tpu_torch.predictor import load_params
    cases = torch_cases()
    paths = []
    for tag, extra in [("R50-C4", ()), ("R50-C4 float16", FP16),
                       ("R50-C4 INT8_BACKBONE", (("TPU.INT8_BACKBONE", True),))]:
        cfg = cases.set_cfg(get_cfg(), cases.C4_DETECTION + list(extra))
        cfg.freeze()
        per = dict(ON_C4, conv_s8_cuda=C4_INT8_LINKS if "INT8" in tag else 0)
        paths.append((tag, cfg, cases.tame(load_params(cfg, seed=0), cases.C4_TAME), per))
    paths.append(("R34-FPN", path_config(FLAGSHIP, R34), None, ON_K2))
    paths.append(("RetinaNet-FPN R50", path_config(FLAGSHIP, cases.RETINANET), None, ON_K2))
    return paths


def new_backbone_path(torch, report, dev, tag, cfg, params, per_request, smi):
    """One path at full width: (INT8_BACKBONE: calibrate_int8 on CALIB_FRAMES
    frames) a warm-up and NEW_TIMED requests with the launch counters set to 0
    just before and read just after, and no plain version called; one
    profiled request; the outputs' form; one request with every K1, K2 and Q1
    launch held against its plain version, its calls kept. Returns the
    HeldAgainstPlain."""
    from densepose_tpu_torch.predictor import DensePosePredictor
    dtype = cfg.TPU.COMPUTE_DTYPE
    pred = DensePosePredictor(cfg, seed=0, device=dev, params=params)
    if cfg.TPU.INT8_BACKBONE:
        t0 = time.perf_counter()
        pred.calibrate_int8(frames(7, CALIB_FRAMES))
        torch.cuda.synchronize()
        check(pred.model.backbone.int8_active(), f"{tag}: the s8 chain is not installed")
        print(f"new backbones {tag}: calibrate_int8 on {CALIB_FRAMES} frames in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms, "
              f"{len(pred.export_calibration())} scales (the unused backbone res5's among "
              "them)")
    warm, *timed = frames(1, 1 + NEW_TIMED)
    pred(warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    lat, outs = [], []
    with CountPlain() as plain:
        for img in timed:
            t0 = time.perf_counter()
            outs.append(pred(img))
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        launches = {k: fn.launches for k, fn in counters().items()}
        variants = dict(counters()[Q1].variant_launches)
    check(plain.calls == 0, f"{tag}: {plain.calls} plain-version calls")
    count_launches(report, tag, dtype, launches, per_request, len(timed))
    if per_request[Q1]:
        report[Q1]["variant_launches_per_path"][tag] = variants
    peak = torch.cuda.max_memory_allocated() / 2**20
    ms = float(np.median(lat))
    busy = breakdown(torch, pred, timed[0], ms)
    d = cfg.TEST.DETECTIONS_PER_IMAGE
    rows = d  # the C4 detector's are min(D, R * C), with no padding to D
    if cfg.MODEL.ROI_HEADS.NAME == "Res5ROIHeads":
        rows = min(d, cfg.MODEL.RPN.POST_NMS_TOPK_TEST * cfg.MODEL.ROI_HEADS.NUM_CLASSES)
    for i, out in enumerate(outs):
        check(out["pred_boxes"].shape == (rows, 4) and out["pred_boxes"].dtype == torch.float32,
              f"{tag} request {i}: pred_boxes {tuple(out['pred_boxes'].shape)} "
              f"{out['pred_boxes'].dtype}")
        check(all(bool(torch.isfinite(v).all()) for v in out.values() if v.is_floating_point()),
              f"{tag} request {i}: non-finite outputs")
        res = pred.numpy_outputs(out)
        n = res["num_instances"]
        check(n >= 1, f"{tag} request {i}: no detections")
        maps = sorted(k for k in out if k.startswith("pred_densepose_"))
        if cfg.MODEL.DENSEPOSE_ON:
            check(maps == [f"pred_densepose_{k}" for k in ("coarse_segm", "fine_segm", "u",
                                                           "v")]
                  and res["pred_densepose_u"].shape[0] == n,
                  f"{tag} request {i}: maps {maps}")
        else:
            check(not maps, f"{tag} request {i}: maps {maps} from a detector without DensePose")
        print(f"new backbones {tag}: request {i}: {lat[i]:.2f} ms, num_instances {n}, "
              f"classes {sorted(set(res['pred_classes'].tolist()))[:8]}")
    print(f"new backbones {tag} [{dtype}] ({smi}): {len(timed)} requests of "
          f"{FRAME_HW[0]}x{FRAME_HW[1]} frames (input "
          f"{'x'.join(map(str, main_path_shapes(cfg)[0]))}): latency ms "
          f"{', '.join(f'{x:.2f}' for x in lat)} (median {ms:.2f}); device busy "
          f"{fmt(busy)} ms; kernel launches {launches}"
          + (f" (Q1 by variant {variants})" if per_request[Q1] else "")
          + f"; max memory allocated {peak:.1f} MiB")
    with HeldAgainstPlain(torch, tag, keep=True) as held:
        pred(timed[0])
        torch.cuda.synchronize()
    check((len(held.k1), len(held.k2), len(held.q1)) == (
        per_request["nms_keep_cuda"], per_request["roi_align_cuda"], per_request[Q1]),
        f"{tag}: held {len(held.k1)} K1, {len(held.k2)} K2, {len(held.q1)} Q1 calls")
    print(f"held: one {tag} request, {held.summary()}")
    del pred, outs
    torch.cuda.empty_cache()
    return held


def reference_check_c4(torch, dev, tag, extra, hw=(64, 64)):
    """A narrowed C4 detector, card against CPU on seed-5 weights: the same
    detections (count and classes exact, boxes and scores within 1e-3),
    detections paired by box as reference_check pairs them."""
    from densepose_tpu_torch.config import get_cfg
    from densepose_tpu_torch.predictor import DensePosePredictor
    cases = torch_cases()
    cfg = cases.set_cfg(get_cfg(), cases.C4_DETECTION + list(extra))
    cfg.freeze()
    img = (np.random.RandomState(21).rand(*hw, 3) * 255).astype(np.uint8)
    gpu, cpu = (DensePosePredictor(cfg, seed=5, device=d).predict_numpy(img) for d in (dev, "cpu"))
    n = cpu["num_instances"]
    check(gpu["num_instances"] == n >= 1, f"reference {tag}: {gpu['num_instances']} vs {n} "
          "detections")
    order = [np.lexsort(r["pred_boxes"].T[::-1]) for r in (gpu, cpu)]
    err = 0.0
    for k in ("pred_boxes", "scores", "pred_classes"):
        e = float(np.abs(gpu[k][order[0]].astype(np.float64) - cpu[k][order[1]]).max())
        check(e <= (0 if k == "pred_classes" else 1e-3), f"reference {tag}: {k} differs by {e}")
        err = max(err, e)
    print(f"reference: narrowed {tag} on the card == on the CPU: {n} detections, max abs "
          f"difference {err:.3e} (tol 1e-3)")


def new_backbones_phase(torch, report, dev, smi):
    """The C4 detector, R34-FPN and RetinaNet-FPN at full width
    (new_backbone_paths), each through new_backbone_path; the R50-C4 fp32
    request's kept calls timed at their sites beside their plain versions and
    bounds (``c4_sites`` on the kernels line: K1 at the RPN's one level of
    PRE_NMS_TOPK_TEST boxes, K1's per-class route at 80 problems of 1000
    proposals, K2 at the res4 pooler); narrowed C4 (R50, R18), R18-FPN and
    RetinaNet models card against CPU."""
    t0 = time.perf_counter()
    for tag, cfg, params, per_request in new_backbone_paths():
        held = new_backbone_path(torch, report, dev, tag, cfg, params, per_request, smi)
        if tag == "R50-C4":
            (rpn, box), (pool,) = held.calls["k1"], held.calls["k2"]
            check(rpn[0][0].shape[:2] == (1, cfg.MODEL.RPN.PRE_NMS_TOPK_TEST)
                  and box[0][0].shape[:2] == (cfg.MODEL.ROI_HEADS.NUM_CLASSES,
                                              cfg.MODEL.RPN.POST_NMS_TOPK_TEST)
                  and box[0][3] is None,
                  f"R50-C4: K1 at {tuple(rpn[0][0].shape)} and {tuple(box[0][0].shape)}")
            check(tuple(pool[0][0][0].shape[:2]) == (1, 1024) and pool[0][5] == 0
                  and pool[0][6], f"R50-C4: K2 at {tuple(pool[0][0][0].shape)}")
            for kind, (args, kw), site in [("k1", rpn, "c4_rpn"),
                                           ("k1", box, "c4_box_stage_per_class"),
                                           ("k2", pool, "c4_box_pooler")]:
                batch_site(torch, report, kind, "float32", args, kw, site, key="c4_sites")
        del held
        torch.cuda.empty_cache()
        print(f"time: new backbones {tag} done {time.perf_counter() - t0:.1f} s into the phase")
    cases = torch_cases()  # the narrowed C4 detectors of tests/test_torch_c4.py
    reference_check_c4(torch, dev, "R50-C4", cases.C4_TINY + cases.R50_NARROW)
    reference_check_c4(torch, dev, "R18-C4",
                       cases.C4_TINY + [("MODEL.RESNETS.DEPTH", 18)] + cases.BASIC_BLOCK)
    reference_check(torch, dev, FLAGSHIP, False,
                    extra=(("MODEL.RESNETS.DEPTH", 18),) + tuple(cases.BASIC_BLOCK))
    reference_check(torch, dev, FLAGSHIP, False, extra=tuple(cases.RETINANET))
    print(f"time: new backbones phase {time.perf_counter() - t0:.1f} s")


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
    for k in ptxas["roi_align_sparse"] + ptxas["conv_s8"]:
        check((k.get("stack"), k.get("spill_stores"), k.get("spill_loads")) == (0, 0, 0),
              f"build: {k['kernel']} has a stack frame or spills")
    check(len(ptxas["conv_s8"]) == 16, "build: Q1 has 16 instantiations (wgmma: tiles 64, 80, "
          "128 and 256 channels wide x 64- and 128-channel K chunks; mma_sync: 16- and 8-byte "
          "copies x CTAs 64, 128 and 256 channels wide, 4-byte copies x 64 and 128), got "
          f"{len(ptxas['conv_s8'])}")

    report = {}
    cfg = get_config(FLAGSHIP)
    dev = torch.device("cuda")

    def lap(what):
        print(f"time: {what} done {time.perf_counter() - t0:.1f} s after the build started")

    kernel_checks(torch, cfg, report, dev)
    q1_checks(torch, report, dev, ptxas["conv_s8"])
    lap("kernel checks")
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
        if (name, dtype) == (HRNET, "float32"):
            top = range_report(torch, pred, frames(1, 1)[0], "HRNet-W32")
            check(np.isfinite(top), "range: a non-finite activation in the HRNet request")
        if name == HRNET:  # every launch of one more request against the plain versions
            with HeldAgainstPlain(torch, f"{name} {dtype}") as held:
                pred(frames(1, 1)[0])
                torch.cuda.synchronize()
            check(len(held.k1) == 2 and len(held.k2) == 2
                  and sorted(k[3] for k in held.k2) == [1, 5],
                  f"{name} {dtype}: held {held.k1} K1 and {held.k2} K2 calls")
            print(f"held: one {name} {dtype} request, {held.summary()}")
        del pred
        torch.cuda.empty_cache()
    lap("paths")
    for name, extra, post_detection in INT8_PATHS:
        pred = int8_path(torch, report, dev, name, extra, post_detection)
        del pred
        torch.cuda.empty_cache()
    lap("int8 paths")
    batch_phase(torch, report, dev, smi_line)
    lap("batch phase")
    spatial_phase(torch, report, dev, smi_line)
    lap("spatial phase")
    new_backbones_phase(torch, report, dev, smi_line)
    lap("new backbones phase")
    cse_phase(torch, report, dev)
    geometry_phase(torch, report, dev)
    detection_bucket_phase(torch, report, dev)
    for dtype in ("float32", "float16"):
        tta_phase(torch, report, dev, dtype)
    single_view_tta(torch, dev)
    lap("CSE, geometry, bucket and TTA phases")
    reference_check(torch, dev, FLAGSHIP, False)
    reference_check(torch, dev, LEGACY, True)
    reference_check(torch, dev, FLAGSHIP, False, "float16")
    reference_check(torch, dev, LEGACY, True, "bfloat16")
    reference_check(torch, dev, FLAGSHIP, False, extra=REF_TTA)
    reference_check(torch, dev, FLAGSHIP, False, extra=(("TPU.GEOMETRY_BUCKET_QUANT", 64),),
                    hw=(60, 80))
    reference_check(torch, dev, HRNET, False)
    reference_check(torch, dev, HRNET, False, "float16")
    reference_check(torch, dev, CSE, False)
    reference_check(torch, dev, CSE, False, "bfloat16")
    reference_check_int8(torch, dev, FLAGSHIP, INT8_HEAD_FLAGS)
    reference_check_int8(torch, dev, HRNET, (("TPU.INT8_BACKBONE", True),
                                             ("TPU.INT8_HEAD", True)))
    lap("reference checks")
    deploy_phase(torch, report, dev)
    lap("deploy phase")

    print(json.dumps({"kernels": list(report.values())}))
    print(f"nvidia-smi: {smi_line}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
