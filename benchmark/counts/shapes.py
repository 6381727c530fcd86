"""The shapes a cell's forward works on: the padded canvas of a frame, its
levels, the RPN's problems and the poolers' regions. The levels' strides and
the padding are the backbone part's (``benchmark/parts.py``)."""

from __future__ import annotations

from typing import List, Tuple

from .. import parts


def canvas(cfg: dict, frame_hw: Tuple[int, int]) -> Tuple[int, int]:
    """(Hp, Wp): the frame resized by detectron2's test rule, padded to a
    multiple of the backbone's size divisibility."""
    h0, w0 = frame_hw
    k = min(cfg["INPUT.MIN_SIZE_TEST"] / min(h0, w0), cfg["INPUT.MAX_SIZE_TEST"] / max(h0, w0))
    h1, w1 = int(h0 * k), int(w0 * k)
    d = parts.backbone(cfg).size_divisibility(cfg)
    return -(-h1 // d) * d, -(-w1 // d) * d


def level_hw(hw: Tuple[int, int], stride: int) -> Tuple[int, int]:
    """A level's size at ``stride`` on a canvas (a level past the padding's
    divisor, as p6, halves the one below it, rounding up)."""
    return -(-hw[0] // stride), -(-hw[1] // stride)


def anchors_per_cell(cfg: dict) -> int:
    return len(cfg["MODEL.ANCHOR_GENERATOR.SIZES"][0]) * \
        len(cfg["MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS"][0])


def rpn_problem_sizes(cfg: dict, hw: Tuple[int, int]) -> List[int]:
    """Boxes in each per-level NMS problem of one frame's RPN."""
    a = anchors_per_cell(cfg)
    strides = parts.backbone(cfg).strides(cfg)
    out = []
    for f in cfg["MODEL.RPN.IN_FEATURES"]:
        h, w = level_hw(hw, strides[f])
        out.append(min(h * w * a, cfg["MODEL.RPN.PRE_NMS_TOPK_TEST"]))
    return out


def box_problem_sizes(cfg: dict) -> List[int]:
    """Boxes in each class's NMS problem of one frame's box stage."""
    return [cfg["MODEL.RPN.POST_NMS_TOPK_TEST"]] * cfg["MODEL.ROI_HEADS.NUM_CLASSES"]
