"""Anchor generation (host-side numpy; the PyTorch port's copy of
densepose_tpu/ops/anchors.py).

Mirrors DefaultAnchorGenerator (detectron2/modeling/anchor_generator.py):
cell anchors from sizes x aspect_ratios centered at origin
(:181-216), shifted over the feature grid by stride with a configurable
offset (:165-179). Anchors depend only on the feature sizes, so the RPN
builds them once per input geometry and keeps them on the device.

Flattened ordering matches the RPN head's logits layout
(N, Hi, Wi, A) -> (Hi*Wi*A): index = (y*W + x)*A + a  (rpn.py:318-330).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np


def generate_cell_anchors(
    sizes: Sequence[float] = (32, 64, 128, 256, 512),
    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
) -> np.ndarray:
    """(len(sizes)*len(aspect_ratios), 4) XYXY anchors centered at (0, 0)."""
    anchors = []
    for size in sizes:
        area = float(size) ** 2.0
        for ar in aspect_ratios:
            w = math.sqrt(area / ar)
            h = ar * w
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(anchors, dtype=np.float32)


def grid_anchors(
    feat_h: int,
    feat_w: int,
    stride: int,
    cell_anchors: np.ndarray,
    offset: float = 0.0,
) -> np.ndarray:
    """(feat_h*feat_w*A, 4) anchors for one feature level."""
    shifts_x = np.arange(offset * stride, feat_w * stride, step=stride, dtype=np.float32)
    shifts_y = np.arange(offset * stride, feat_h * stride, step=stride, dtype=np.float32)
    shift_y, shift_x = np.meshgrid(shifts_y, shifts_x, indexing="ij")
    shifts = np.stack(
        (shift_x.reshape(-1), shift_y.reshape(-1), shift_x.reshape(-1), shift_y.reshape(-1)),
        axis=1,
    )
    out = shifts[:, None, :] + cell_anchors[None, :, :]
    return out.reshape(-1, 4).astype(np.float32)


def anchors_for_levels(
    grid_sizes: List,
    strides: Sequence[int],
    sizes,
    aspect_ratios,
    offset: float = 0.0,
) -> List[np.ndarray]:
    """Per-level anchors; `sizes`/`aspect_ratios` follow the config broadcast
    rule (anchor_generator.py:62-86): one entry -> shared across levels."""
    n = len(strides)

    def _broadcast(params):
        if not isinstance(params[0], (list, tuple)):
            return [params] * n
        if len(params) == 1:
            return list(params) * n
        assert len(params) == n, (params, n)
        return params

    sizes = _broadcast(sizes)
    aspect_ratios = _broadcast(aspect_ratios)
    out = []
    for (h, w), stride, s, a in zip(grid_sizes, strides, sizes, aspect_ratios):
        cell = generate_cell_anchors(s, a)
        out.append(grid_anchors(h, w, stride, cell, offset))
    return out
