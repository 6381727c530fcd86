"""FLOPs of one frame's forward (multiply-adds counted as 2), from the
configuration: every convolution, linear and transposed convolution of the
backbone, FPN, RPN head, box head, DensePose decoder, head and predictor at
the canvas, the RPN's POST_NMS_TOPK_TEST proposals and all
DETECTIONS_PER_IMAGE DensePose slots. Pooling, NMS, resizes and elementwise
work are left out."""

from __future__ import annotations

from typing import Dict, Tuple

from .shapes import anchors_per_cell, level_hw, resnet_stage_blocks


def conv_flops(cin: int, cout: int, k: int, hw: Tuple[int, int], n: int = 1) -> float:
    return 2.0 * cin * cout * k * k * hw[0] * hw[1] * n


def backbone_flops(cfg: dict, hw: Tuple[int, int]) -> float:
    r = "MODEL.RESNETS."
    x = level_hw(hw, 2)
    total = conv_flops(3, cfg[r + "STEM_OUT_CHANNELS"], 7, x)
    cin = cfg[r + "STEM_OUT_CHANNELS"]
    cb, cout = cfg[r + "WIDTH_PER_GROUP"], cfg[r + "RES2_OUT_CHANNELS"]
    for s, n in enumerate(resnet_stage_blocks(cfg[r + "DEPTH"])):
        out_hw = level_hw(hw, 4 * 2 ** s)
        for i in range(n):
            total += conv_flops(cin, cb, 1, out_hw)       # conv1 (stride in the 1x1)
            total += conv_flops(cb, cb, 3, out_hw)
            total += conv_flops(cb, cout, 1, out_hw)
            if cin != cout:
                total += conv_flops(cin, cout, 1, out_hw)
            cin = cout
        cb, cout = cb * 2, cout * 2
    c = cfg["MODEL.FPN.OUT_CHANNELS"]
    for s, f in enumerate(cfg["MODEL.FPN.IN_FEATURES"]):
        lhw = level_hw(hw, 2 ** int(f[3:]))
        total += conv_flops(cfg[r + "RES2_OUT_CHANNELS"] * 2 ** s, c, 1, lhw)
        total += conv_flops(c, c, 3, lhw)
    return total


def rpn_flops(cfg: dict, hw: Tuple[int, int]) -> float:
    c = cfg["MODEL.FPN.OUT_CHANNELS"]
    a = anchors_per_cell(cfg)
    total = 0.0
    for f in cfg["MODEL.RPN.IN_FEATURES"]:
        lhw = level_hw(hw, 2 ** int(f[1:]))
        total += conv_flops(c, c, 3, lhw) + conv_flops(c, 5 * a, 1, lhw)
    return total


def box_head_flops(cfg: dict) -> float:
    b = "MODEL.ROI_BOX_HEAD."
    r = cfg["MODEL.RPN.POST_NMS_TOPK_TEST"]
    d = cfg["MODEL.FPN.OUT_CHANNELS"] * cfg[b + "POOLER_RESOLUTION"] ** 2
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
    c = cfg["MODEL.FPN.OUT_CHANNELS"]
    total = 0.0
    for f in cfg["MODEL.ROI_HEADS.IN_FEATURES"]:
        stride = 2 ** int(f[1:])
        steps = max(1, (stride // common).bit_length() - 1)
        for k in range(steps):
            total += conv_flops(c if k == 0 else dims, dims, 3, level_hw(hw, stride >> k))
    return total + conv_flops(dims, cfg[dp + "DECODER_NUM_CLASSES"], 1, level_hw(hw, common))


def densepose_head_flops(cfg: dict) -> float:
    dp = "MODEL.ROI_DENSEPOSE_HEAD."
    d = cfg["TEST.DETECTIONS_PER_IMAGE"]
    res = cfg[dp + "POOLER_RESOLUTION"]
    cin = cfg[dp + "DECODER_NUM_CLASSES"] if cfg[dp + "DECODER_ON"] \
        else cfg["MODEL.FPN.OUT_CHANNELS"]
    hd = cfg[dp + "CONV_HEAD_DIM"]
    total = 0.0
    for i in range(cfg[dp + "NUM_STACKED_CONVS"]):
        total += conv_flops(cin if i == 0 else hd, hd, cfg[dp + "CONV_HEAD_KERNEL"],
                            (res, res), d)
    return total


def densepose_predictor_flops(cfg: dict) -> float:
    dp = "MODEL.ROI_DENSEPOSE_HEAD."
    d = cfg["TEST.DETECTIONS_PER_IMAGE"]
    res = cfg[dp + "POOLER_RESOLUTION"]
    cout = cfg[dp + "NUM_COARSE_SEGM_CHANNELS"] + 3 * (cfg[dp + "NUM_PATCHES"] + 1)
    return conv_flops(cfg[dp + "CONV_HEAD_DIM"], cout, cfg[dp + "DECONV_KERNEL"], (res, res), d)


def forward_flops(cfg: dict, hw: Tuple[int, int]) -> Dict[str, float]:
    """FLOPs of one frame by stage, and their ``total``."""
    out = {"backbone": backbone_flops(cfg, hw), "rpn": rpn_flops(cfg, hw),
           "box_stage": box_head_flops(cfg), "decoder": decoder_flops(cfg, hw),
           "densepose_head": densepose_head_flops(cfg),
           "densepose_predictor": densepose_predictor_flops(cfg)}
    out["total"] = sum(out.values())
    return out
