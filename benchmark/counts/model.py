"""FLOPs of one frame's forward (multiply-adds counted as 2), from the
configuration: every convolution, linear and transposed convolution of the
backbone, RPN head, box head, DensePose decoder, head and predictor at the
canvas, the RPN's POST_NMS_TOPK_TEST proposals and all DETECTIONS_PER_IMAGE
DensePose slots. Pooling, NMS, resizes and elementwise work are left out.
The backbone and the DensePose head count their own (``benchmark/parts.py``);
the levels' strides and widths are the backbone's."""

from __future__ import annotations

from typing import Dict, Tuple

from .. import parts
from .shapes import anchors_per_cell, level_hw


def conv_flops(cin: int, cout: int, k: int, hw: Tuple[int, int], n: int = 1) -> float:
    return 2.0 * cin * cout * k * k * hw[0] * hw[1] * n


def rpn_flops(cfg: dict, hw: Tuple[int, int]) -> float:
    backbone = parts.backbone(cfg)
    c = backbone.out_channels(cfg)
    strides = backbone.strides(cfg)
    a = anchors_per_cell(cfg)
    total = 0.0
    for f in cfg["MODEL.RPN.IN_FEATURES"]:
        lhw = level_hw(hw, strides[f])
        total += conv_flops(c, c, 3, lhw) + conv_flops(c, 5 * a, 1, lhw)
    return total


def box_head_flops(cfg: dict) -> float:
    b = "MODEL.ROI_BOX_HEAD."
    r = cfg["MODEL.RPN.POST_NMS_TOPK_TEST"]
    d = parts.backbone(cfg).out_channels(cfg) * cfg[b + "POOLER_RESOLUTION"] ** 2
    total = 0.0
    for _ in range(cfg[b + "NUM_FC"]):
        total += 2.0 * r * d * cfg[b + "FC_DIM"]
        d = cfg[b + "FC_DIM"]
    n = cfg["MODEL.ROI_HEADS.NUM_CLASSES"]
    return total + 2.0 * r * d * (n + 1 + 4 * n)


def decoder_flops(cfg: dict, hw: Tuple[int, int]) -> float:
    dp = "MODEL.ROI_DENSEPOSE_HEAD."
    if not cfg[dp + "DECODER_ON"]:
        return 0.0
    common = cfg[dp + "DECODER_COMMON_STRIDE"]
    dims = cfg[dp + "DECODER_CONV_DIMS"]
    backbone = parts.backbone(cfg)
    c = backbone.out_channels(cfg)
    strides = backbone.strides(cfg)
    total = 0.0
    for f in cfg["MODEL.ROI_HEADS.IN_FEATURES"]:
        stride = strides[f]
        steps = max(1, (stride // common).bit_length() - 1)
        for k in range(steps):
            total += conv_flops(c if k == 0 else dims, dims, 3, level_hw(hw, stride >> k))
    return total + conv_flops(dims, cfg[dp + "DECODER_NUM_CLASSES"], 1, level_hw(hw, common))


def densepose_head_flops(cfg: dict) -> float:
    """The head part on every DensePose slot."""
    return parts.head(cfg).flops(cfg, parts.head_in_channels(cfg),
                                 cfg["TEST.DETECTIONS_PER_IMAGE"])


def densepose_predictor_flops(cfg: dict) -> float:
    dp = "MODEL.ROI_DENSEPOSE_HEAD."
    d = cfg["TEST.DETECTIONS_PER_IMAGE"]
    res = cfg[dp + "POOLER_RESOLUTION"]
    cout = cfg[dp + "NUM_COARSE_SEGM_CHANNELS"] + 3 * (cfg[dp + "NUM_PATCHES"] + 1)
    return conv_flops(parts.head(cfg).out_channels(cfg), cout, cfg[dp + "DECONV_KERNEL"],
                      (res, res), d)


def forward_flops(cfg: dict, hw: Tuple[int, int]) -> Dict[str, float]:
    """FLOPs of one frame by stage, and their ``total``."""
    out = {"backbone": parts.backbone(cfg).flops(cfg, hw), "rpn": rpn_flops(cfg, hw),
           "box_stage": box_head_flops(cfg), "decoder": decoder_flops(cfg, hw),
           "densepose_head": densepose_head_flops(cfg),
           "densepose_predictor": densepose_predictor_flops(cfg)}
    out["total"] = sum(out.values())
    return out
