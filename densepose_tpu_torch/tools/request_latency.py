"""Single-frame request latency on the card, by serving path.

    python -m densepose_tpu_torch.tools.request_latency

Each path is a zoo model at full width with random weights from seed 0:
the flagship (densepose_rcnn_R_50_FPN_s1x) in fp32 (``fp32``), at
TPU.COMPUTE_DTYPE float16 (``float16``), with TPU.INT8_HEAD and
TPU.INT8_PREDICTOR calibrated on 4 frames (``int8``), and R101 legacy with
DENSEPOSE_TPU_SPARSE_POOLER set (``legacy``, the K3 path). After 3 warm-up
requests, 20 requests of distinct synthetic 480x640 frames are
each timed on the host clock around ``__call__`` and
``torch.cuda.synchronize()``; one more request under ``torch.profiler``
gives the device's busy time (the union of its kernels' and copies'
intervals). Prints one JSON line a path: the median and every latency, the
busy ms, the idle share of the median request, and the card's name and
power limit (``nvidia-smi``).

The script reads only the predictor's public API, so the same file measures
another checkout of the repo (run it with that checkout as the working
directory and on ``PYTHONPATH``): to compare two commits on one card, run
parent, change, change, parent back to back.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np

FLAGSHIP = "densepose_rcnn_R_50_FPN_s1x"
LEGACY = "densepose_rcnn_R_101_FPN_s1x_legacy"
PATHS = {
    "fp32": (FLAGSHIP, ()),
    "float16": (FLAGSHIP, (("TPU.COMPUTE_DTYPE", "float16"),)),
    "int8": (FLAGSHIP, (("TPU.INT8_HEAD", True), ("TPU.INT8_PREDICTOR", True))),
    "legacy": (LEGACY, ()),
}
WARMUP = 3
REQUESTS = 20
CALIB_FRAMES = 4


def synthetic_frames(seed, n, hw=(480, 640)):
    """Noise plus a smooth blob, as chip_smoke.py's frames."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    out = []
    for _ in range(n):
        img = rng.randint(0, 256, size=(*hw, 3)).astype(np.uint8)
        cy, cx = rng.rand(2) * hw
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 80.0 ** 2))
        out.append(np.clip(img * 0.3 + blob[..., None] * 180, 0, 255).astype(np.uint8))
    return out


def device_busy_ms(torch, fn):
    """The device's busy ms during ``fn()`` (torch.profiler): the union of
    its kernels' and copies' intervals, leaving out the device-side mirrors
    of the host's ``record_function`` ranges (which carry the host ranges'
    names); None where the profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    host = {e.name for e in events if e.device_type == DeviceType.CPU}
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA and e.name not in host)
    if not spans:
        return None
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def measure(torch, path):
    from densepose_tpu_torch.model_zoo import get_config
    from densepose_tpu_torch.predictor import DensePosePredictor
    name, extra = PATHS[path]
    cfg = get_config(name).clone()
    cfg.defrost()
    cfg.merge_from_list([v for kv in extra for v in kv])
    cfg.freeze()
    if path == "legacy":
        os.environ["DENSEPOSE_TPU_SPARSE_POOLER"] = "1"
    try:
        pred = DensePosePredictor(cfg, seed=0, device="cuda")
        if path == "int8":
            pred.calibrate_int8(synthetic_frames(7, CALIB_FRAMES))
        imgs = synthetic_frames(11, WARMUP + REQUESTS + 1)
        for img in imgs[:WARMUP]:
            pred(img)
        torch.cuda.synchronize()
        lat = []
        for img in imgs[WARMUP:-1]:
            t0 = time.perf_counter()
            pred(img)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        busy = device_busy_ms(torch, lambda: pred(imgs[-1]))
    finally:
        os.environ.pop("DENSEPOSE_TPU_SPARSE_POOLER", None)
    med = float(np.median(lat))
    return {"path": path, "model": name, "extra": [list(kv) for kv in extra],
            "median_ms": med, "latency_ms": lat, "busy_ms": busy,
            "idle": None if busy is None else 1 - busy / med}


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("request_latency: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    for path in PATHS:
        row = measure(torch, path)
        row["card"] = smi.splitlines()[0] if smi else None
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
