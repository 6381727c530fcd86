"""Tiny stand-ins of the cells' configurations and traffic for CPU tests:
the same code paths at a size a test run holds (narrow layers, small
frames, few proposals and slots)."""

from __future__ import annotations

import copy

from benchmark import manifest

SHRINK = {
    "INPUT.MIN_SIZE_TEST": 96, "INPUT.MAX_SIZE_TEST": 160,
    "MODEL.RESNETS.STEM_OUT_CHANNELS": 8, "MODEL.RESNETS.RES2_OUT_CHANNELS": 32,
    "MODEL.RESNETS.WIDTH_PER_GROUP": 8, "MODEL.FPN.OUT_CHANNELS": 16,
    "MODEL.RPN.PRE_NMS_TOPK_TEST": 60, "MODEL.RPN.POST_NMS_TOPK_TEST": 40,
    "MODEL.ROI_BOX_HEAD.FC_DIM": 32, "TEST.DETECTIONS_PER_IMAGE": 10,
    "MODEL.ROI_DENSEPOSE_HEAD.CONV_HEAD_DIM": 16,
    "MODEL.ROI_DENSEPOSE_HEAD.NUM_STACKED_CONVS": 2,
    "MODEL.ROI_DENSEPOSE_HEAD.DECODER_CONV_DIMS": 16,
    "MODEL.ROI_DENSEPOSE_HEAD.DECODER_NUM_CLASSES": 16,
}


def conf(name: str, dtype: str = "float32") -> dict:
    """The configuration file of ``name`` at tiny widths, served in ``dtype``
    (the CPU serves float32)."""
    c = copy.deepcopy(manifest.config(manifest.load(), name))
    c["model"].update(SHRINK)
    c["model"]["TPU.COMPUTE_DTYPE"] = dtype
    c["opts"] = dict(SHRINK, **{"TPU.COMPUTE_DTYPE": dtype})
    c["dtype"] = dtype
    return c


def traffic(batch: int = 2) -> dict:
    """cams8 at a tiny size; the batch checked is the window's first, which
    every run reaches however slow the CPU (no trace precedes it)."""
    t = copy.deepcopy(manifest.traffic("cams8"))
    t.update({"batch": batch, "frame_hw": [90, 160], "base_batches": 2, "warmup_batches": 1,
              "check_batches": 2, "check_batches_per_s": 1, "trace_batches": 0})
    t["frame"] = dict(t["frame"], blob_sigma=[8, 30])
    return t
