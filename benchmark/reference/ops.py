"""Plain float32 operations of the reference DensePose R-CNN.

Written from the published descriptions of the operations, not from the
program under test: torchvision's ROIAlign (``aligned`` False or True, a
fixed sampling ratio) and greedy NMS, detectron2's anchor generator,
``Box2BoxTransform`` and FPN level assignment, and a convolution read from
the weights by module name. Each takes and returns fp32 tensors; nothing
here is fused, batched or cached.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SCALE_CLAMP = math.log(1000.0 / 16)  # Box2BoxTransform's clamp of dw, dh
CANONICAL_BOX_SIZE = 224.0
CANONICAL_LEVEL = 4


def conv(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str, stride: int = 1,
         relu: bool = False) -> torch.Tensor:
    """The convolution ``name`` of the weights ``w`` (``name.weight`` OIHW,
    ``name.bias``), padded to keep the size at stride 1, and its ReLU."""
    weight = w[f"{name}.weight"]
    y = F.conv2d(x, weight, w[f"{name}.bias"], stride=stride, padding=weight.shape[-1] // 2)
    return F.relu(y) if relu else y


def cell_anchors(sizes: Sequence[float], ratios: Sequence[float]) -> torch.Tensor:
    """(len(sizes) * len(ratios), 4) anchors centred at 0: for each size and
    aspect ratio a (h / w), w = sqrt(size^2 / a), h = a * w."""
    out = []
    for size in sizes:
        for a in ratios:
            w = math.sqrt(size * size / a)
            h = a * w
            out.append([-w / 2, -h / 2, w / 2, h / 2])
    return torch.tensor(out, dtype=torch.float32)


def grid_anchors(h: int, w: int, stride: int, cells: torch.Tensor,
                 offset: float = 0.0) -> torch.Tensor:
    """(h * w * A, 4) anchors of one level, position-major then anchor."""
    xs = torch.arange(w, dtype=torch.float32) * stride + offset * stride
    ys = torch.arange(h, dtype=torch.float32) * stride + offset * stride
    sy, sx = torch.meshgrid(ys, xs, indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], dim=-1).reshape(-1, 1, 4)
    return (shifts + cells[None]).reshape(-1, 4)


def apply_deltas(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights: Sequence[float]) -> torch.Tensor:
    """Box2BoxTransform.apply_deltas: (N, 4) deltas on (N, 4) boxes."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    cx = boxes[:, 0] + 0.5 * w
    cy = boxes[:, 1] + 0.5 * h
    wx, wy, ww, wh = (float(v) for v in weights)
    dx = deltas[:, 0] / wx
    dy = deltas[:, 1] / wy
    dw = torch.clamp(deltas[:, 2] / ww, max=SCALE_CLAMP)
    dh = torch.clamp(deltas[:, 3] / wh, max=SCALE_CLAMP)
    px = dx * w + cx
    py = dy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack([px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw, py + 0.5 * ph], dim=1)


def clip(boxes: torch.Tensor, x_max: float, y_max: float) -> torch.Tensor:
    """x clamped to [0, x_max], y to [0, y_max]."""
    return torch.stack([boxes[:, 0].clamp(0, x_max), boxes[:, 1].clamp(0, y_max),
                        boxes[:, 2].clamp(0, x_max), boxes[:, 3].clamp(0, y_max)], dim=1)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torchvision's box_iou: areas (x2 - x1) * (y2 - y1), no +1."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def nms(boxes: torch.Tensor, scores: torch.Tensor, threshold: float) -> torch.Tensor:
    """torchvision.ops.nms: indices of the kept boxes, by decreasing score;
    a box is dropped when its IoU with a kept, higher-scored box exceeds
    ``threshold``. The IoU matrix is computed in fp32 on the boxes' device,
    the greedy walk on the host."""
    if boxes.shape[0] == 0:
        return torch.zeros(0, dtype=torch.long, device=boxes.device)
    order = torch.sort(scores, descending=True, stable=True).indices
    over = (box_iou(boxes[order], boxes[order]) > threshold).cpu().numpy()
    removed = np.zeros(len(order), dtype=bool)
    keep = []
    for i in range(len(order)):
        if removed[i]:
            continue
        keep.append(i)
        removed[i + 1:] |= over[i, i + 1:]
    return order[torch.as_tensor(keep, dtype=torch.long, device=boxes.device)]


def fpn_levels(boxes: torch.Tensor, min_level: int, max_level: int) -> torch.Tensor:
    """FPN paper eqn. (1) as detectron2's poolers assign: the level index
    from ``min_level``, for each box."""
    size = torch.sqrt((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))
    lvl = torch.floor(CANONICAL_LEVEL + torch.log2(size / CANONICAL_BOX_SIZE + 1e-8))
    return (lvl.clamp(min_level, max_level) - min_level).long()


def _axis_weights(start: torch.Tensor, extent: torch.Tensor, bins: int, grid: int,
                  size: int) -> torch.Tensor:
    """(R, bins, size) matrix of one axis of ROIAlign: row b of roi r holds
    the mean over ``grid`` sample points of bin b of each sample's two
    bilinear taps along the axis, zero for a sample outside [-1, size]."""
    r = start.shape[0]
    binsz = extent / bins
    idx = torch.arange(bins, dtype=torch.float32, device=start.device)
    sub = (torch.arange(grid, dtype=torch.float32, device=start.device) + 0.5) / grid
    pos = start[:, None, None] + (idx[None, :, None] + sub[None, None, :]) * binsz[:, None, None]
    inside = (pos >= -1.0) & (pos <= size)
    pos = pos.clamp(min=0)
    low = torch.floor(pos).long()
    top = low >= size - 1
    low = torch.where(top, torch.full_like(low, size - 1), low)
    high = torch.where(top, low, low + 1)
    pos = torch.where(top, low.float(), pos)
    frac = pos - low.float()
    w = torch.zeros(r, bins, grid, size, dtype=torch.float32, device=start.device)
    w.scatter_add_(3, low[..., None], ((1 - frac) * inside)[..., None])
    w.scatter_add_(3, high[..., None], (frac * inside)[..., None])
    return w.sum(2) / grid


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, scale: float, out: int,
              ratio: int, aligned: bool, chunk: int = 256) -> torch.Tensor:
    """torchvision.ops.roi_align of one frame's (C, H, W) map at boxes (R, 4)
    in input coordinates, with a fixed sampling ratio: (R, C, out, out).
    Bilinear interpolation is separable, and so is the rule that zeroes a
    sample outside the map, so each roi is Wy @ F @ Wx^T with the axis
    matrices of ``_axis_weights``."""
    if ratio <= 0:
        raise ValueError("the reference ROIAlign takes a fixed sampling ratio")
    c, h, w = feat.shape
    off = 0.5 if aligned else 0.0
    res = []
    for i in range(0, boxes.shape[0], chunk):
        b = boxes[i:i + chunk] * scale - off
        ext_w = b[:, 2] - b[:, 0]
        ext_h = b[:, 3] - b[:, 1]
        if not aligned:
            ext_w = ext_w.clamp(min=1.0)
            ext_h = ext_h.clamp(min=1.0)
        wy = _axis_weights(b[:, 1], ext_h, out, ratio, h)
        wx = _axis_weights(b[:, 0], ext_w, out, ratio, w)
        t = torch.einsum("rph,chw->rcpw", wy, feat)
        res.append(torch.einsum("rcpw,rqw->rcpq", t, wx))
    if not res:
        return feat.new_zeros((0, c, out, out))
    return torch.cat(res)


def roi_align_levels(feats: List[torch.Tensor], boxes: torch.Tensor, scales: List[float],
                     out: int, ratio: int, aligned: bool) -> torch.Tensor:
    """Multi-level ROIAlign (detectron2's ROIPooler): each box pooled from
    its FPN level. feats: one frame's (C, H, W) maps, finest first."""
    min_level = int(round(-math.log2(scales[0])))
    max_level = int(round(-math.log2(scales[-1])))
    lvl = fpn_levels(boxes, min_level, max_level)
    res = feats[0].new_zeros((boxes.shape[0], feats[0].shape[0], out, out))
    for i, (f, s) in enumerate(zip(feats, scales)):
        sel = torch.nonzero(lvl == i).flatten()
        if len(sel):
            res[sel] = roi_align(f, boxes[sel], s, out, ratio, aligned)
    return res


def resize_u8(image: torch.Tensor, k: float, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(H, W, 3) uint8 -> (3, h1, w1) float32 holding integers: a bilinear
    resize by the scale factor ``k`` (align_corners False, source = (dst +
    0.5) / k - 0.5), rounded to nearest and clipped, as resizing the uint8
    image gives."""
    x = image.permute(2, 0, 1)[None].float()
    y = torch.nn.functional.interpolate(x, scale_factor=(k, k), mode="bilinear",
                                        align_corners=False, recompute_scale_factor=False)
    if tuple(y.shape[-2:]) != tuple(out_hw):
        raise ValueError(f"resize by {k} gives {tuple(y.shape[-2:])}, expected {out_hw}")
    return torch.round(y[0]).clamp(0, 255)
