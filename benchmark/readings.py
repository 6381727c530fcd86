"""The readings that a cell's correctness limits are set from.

    python3 -m benchmark.readings --workload <cell> --seeds 12 --control-seeds 3 \\
        --seconds 3 [--first-seed N] [--variant KEY=VALUE ... --variant-seeds 3]

In one process, runs the cell (``run.run_cell``, a short window at the cell's
own load, the same sample and comparison as a benchmark run) on ``--seeds``
seeds, then its configuration's control (the program's own lower-precision
path, the configuration file's ``control``) on ``--control-seeds`` seeds, and
then, where ``--variant`` names config options (``TPU.COMPUTE_DTYPE=bfloat16``),
the program with those options on ``--variant-seeds`` seeds, and the program
with the box stage's NMS switched off (a planted fault) on ``--fault-seeds``
seeds. It prints one JSON line a run: the seed, which kind of run it was, and
each number compared. A limit lies above every sound run's number and below the
control's (PERF.md gives the readings and the limits).
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import sys
import time

from . import manifest, run


def box_stage_nms(threshold):
    """A stand-in for the box stage's NMS mask (``models/roi_heads.py``'s
    ``nms_mask``) run at ``threshold`` in place of the configured one; None
    keeps every valid candidate (NMS off). A fault planted for the readings
    and the tests."""
    from densepose_tpu_torch.ops.nms import nms_mask

    def mask(boxes, scores, valid, iou_threshold):
        if threshold is None:
            return valid.clone()
        return nms_mask(boxes, scores, valid, threshold)
    return mask


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 1000)
    p.add_argument("--variant", nargs="*", default=[], metavar="KEY=VALUE")
    p.add_argument("--variant-seeds", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=0)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    m = manifest.load()
    cell = manifest.cell(m, args.workload)
    conf = manifest.config(m, cell["config"])
    variant = copy.deepcopy(conf)
    variant["control"] = {"opts": dict(kv.split("=", 1) for kv in args.variant),
                          "calibrate_frames": 0}
    plan = [(args.first_seed + k, "sound", conf) for k in range(args.seeds)]
    plan += [(args.first_seed + k, "control", conf) for k in range(args.control_seeds)]
    if args.variant:
        plan += [(args.first_seed + k, "variant", variant) for k in range(args.variant_seeds)]
    plan += [(args.first_seed + k, "nms_off", conf) for k in range(args.fault_seeds)]
    from densepose_tpu_torch.models import roi_heads
    configured = roi_heads.nms_mask
    for seed, kind, c in plan:
        t0 = time.perf_counter()
        roi_heads.nms_mask = box_stage_nms(None) if kind == "nms_off" else configured
        r = run.run_cell(m, cell, seed, args.seconds, False, conf=c,
                         control=kind in ("control", "variant"), t_start=t0)
        roi_heads.nms_mask = configured
        row = {"workload": args.workload, "seed": seed, "run": kind,
               "opts": c["control"]["opts"] if kind in ("control", "variant") else {},
               "correct": r["correct"], "checked_frames": r["checked_frames"],
               "numbers": {k: v["value"] for k, v in r["compared"].items()},
               "diagnostics": r["diagnostics"], "timing_s": r["timing_s"],
               "metrics": r["metrics"]}
        print(json.dumps(run.clean(row)), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
