"""The shapes a cell's forward works on: the padded canvas of a frame, its
FPN levels, the RPN's problems and the poolers' regions."""

from __future__ import annotations

from typing import List, Tuple


def canvas(cfg: dict, frame_hw: Tuple[int, int]) -> Tuple[int, int]:
    """(Hp, Wp): the frame resized by detectron2's test rule, padded to 32."""
    h0, w0 = frame_hw
    k = min(cfg["INPUT.MIN_SIZE_TEST"] / min(h0, w0), cfg["INPUT.MAX_SIZE_TEST"] / max(h0, w0))
    h1, w1 = int(h0 * k), int(w0 * k)
    return -(-h1 // 32) * 32, -(-w1 // 32) * 32


def level_hw(hw: Tuple[int, int], stride: int) -> Tuple[int, int]:
    """A level's size at ``stride`` on a canvas whose sides divide by 32
    (p6 halves p5, rounding up)."""
    return -(-hw[0] // stride), -(-hw[1] // stride)


def anchors_per_cell(cfg: dict) -> int:
    return len(cfg["MODEL.ANCHOR_GENERATOR.SIZES"][0]) * \
        len(cfg["MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS"][0])


def rpn_problem_sizes(cfg: dict, hw: Tuple[int, int]) -> List[int]:
    """Boxes in each per-level NMS problem of one frame's RPN."""
    a = anchors_per_cell(cfg)
    out = []
    for f in cfg["MODEL.RPN.IN_FEATURES"]:
        h, w = level_hw(hw, 2 ** int(f[1:]))
        out.append(min(h * w * a, cfg["MODEL.RPN.PRE_NMS_TOPK_TEST"]))
    return out


def box_problem_sizes(cfg: dict) -> List[int]:
    """Boxes in each class's NMS problem of one frame's box stage."""
    return [cfg["MODEL.RPN.POST_NMS_TOPK_TEST"]] * cfg["MODEL.ROI_HEADS.NUM_CLASSES"]


def resnet_stage_blocks(depth: int) -> Tuple[int, ...]:
    return {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[depth]
