"""Box tensor ops (port of densepose_tpu/ops/boxes.py).

All functions take and return (..., 4) XYXY float tensors. Decoding is done
in fp32, as the reference's fp32 islands do (box_regression.py:84). Each op
is written as the same sequence of elementwise roundings as the JAX version.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

DEFAULT_SCALE_CLAMP = math.log(1000.0 / 16)


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded once, on CPU and CUDA tensors alike. PyTorch's CUDA
    division by a Python scalar multiplies by the rounded reciprocal instead,
    which differs in the last bit for about half the quotients (by 7, 10, 28
    ...); a 0-dim tensor divisor takes the true division. The divisor is
    made by an operator, not as a tensor constant, so that an exported
    program can hold it inside a ``torch.cond`` branch."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def clip_boxes(boxes: torch.Tensor, size_hw) -> torch.Tensor:
    """Clamp x to [0, size[1]] and y to [0, size[0]] (structures.py:107-112)."""
    x1 = boxes[..., 0].clamp(0, size_hw[1])
    y1 = boxes[..., 1].clamp(0, size_hw[0])
    x2 = boxes[..., 2].clamp(0, size_hw[1])
    y2 = boxes[..., 3].clamp(0, size_hw[0])
    return torch.stack((x1, y1, x2, y2), dim=-1)


def clip_boxes_wh_swapped(boxes: torch.Tensor, size_wh) -> torch.Tensor:
    """The RPN proposal clip as the reference executes it: it passes
    (W, H) where clip_boxes expects (H, W) (rpn.py:320), so x clamps to H
    and y to W. A reference quirk kept for output parity."""
    return clip_boxes(boxes, size_wh)


def nonempty_boxes(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """structures.py:115-122: width and height >= threshold."""
    ws = boxes[..., 2] - boxes[..., 0]
    hs = boxes[..., 3] - boxes[..., 1]
    return (ws >= threshold) & (hs >= threshold)


def boxes_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def apply_deltas(
    deltas: torch.Tensor,
    boxes: torch.Tensor,
    weights: Tuple[float, float, float, float],
    scale_clamp: float = DEFAULT_SCALE_CLAMP,
) -> torch.Tensor:
    """Box2BoxTransform.apply_deltas (box_regression.py:74-112).

    deltas: (K, k*4); boxes: (K, 4). Computed in fp32. Returns the shape of
    ``deltas``."""
    orig_shape = deltas.shape
    deltas = deltas.float()
    boxes = boxes.float()

    widths = boxes[:, 2] - boxes[:, 0]
    heights = boxes[:, 3] - boxes[:, 1]
    ctr_x = boxes[:, 0] + 0.5 * widths
    ctr_y = boxes[:, 1] + 0.5 * heights

    wx, wy, ww, wh = weights
    dx = true_div(deltas[:, 0::4], wx)
    dy = true_div(deltas[:, 1::4], wy)
    dw = true_div(deltas[:, 2::4], ww).clamp(max=scale_clamp)
    dh = true_div(deltas[:, 3::4], wh).clamp(max=scale_clamp)

    pred_ctr_x = dx * widths[:, None] + ctr_x[:, None]
    pred_ctr_y = dy * heights[:, None] + ctr_y[:, None]
    pred_w = torch.exp(dw) * widths[:, None]
    pred_h = torch.exp(dh) * heights[:, None]

    x1 = pred_ctr_x - 0.5 * pred_w
    y1 = pred_ctr_y - 0.5 * pred_h
    x2 = pred_ctr_x + 0.5 * pred_w
    y2 = pred_ctr_y + 0.5 * pred_h
    return torch.stack((x1, y1, x2, y2), dim=-1).reshape(orig_shape)


def scale_boxes(boxes: torch.Tensor, scale_x: float, scale_y: float) -> torch.Tensor:
    """Boxes with x scaled by ``scale_x`` and y by ``scale_y`` (structures.py:
    132-140, functional where the reference scales in place)."""
    return boxes * torch.tensor([scale_x, scale_y, scale_x, scale_y], dtype=boxes.dtype,
                                device=boxes.device)


def matched_pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of two equal-length box sets (N, 4) (structures.py:
    8-31), torchvision's areas, 0 where the union is not positive."""
    lt = torch.maximum(a[:, :2], b[:, :2])
    rb = torch.minimum(a[:, 2:], b[:, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[:, 0] * wh[:, 1]
    union = boxes_area(a) + boxes_area(b) - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, 4) x (..., N, 4) -> (..., M, N) IoU, torchvision box_iou
    convention (area = (x2-x1)*(y2-y1), no +1), 0 where the union is not
    positive."""
    area_a = boxes_area(a)
    area_b = boxes_area(b)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))
