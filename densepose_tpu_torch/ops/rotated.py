"""Rotated boxes: delta transforms and rotated NMS (port of
densepose_tpu/ops/rotated.py), plain PyTorch.

The reference declares ``nms_rotated`` but calls a compiled extension its
repo does not have (``torch.ops.detectron2.nms_rotated``, layers/nms.py:86);
the JAX package supplies working functions, and so does the port:

* ``apply_deltas_rotated``: Box2BoxTransformRotated.apply_deltas
  (box_regression.py:115-224) on (x_ctr, y_ctr, w, h, angle in degrees);
* ``apply_deltas_linear``: Box2BoxTransformLinear.apply_deltas (FCOS-style
  distances, box_regression.py:226-303);
* ``rotated_pairwise_iou``: the exact IoU of two rectangles, one clipped by
  the other's four edges (Sutherland-Hodgman), for every pair at once;
* ``nms_rotated_mask``: greedy NMS over that IoU, the fixed point of
  ``ops/nms.py::nms_keep_plain`` (no kernel: no config reaches it).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .boxes import DEFAULT_SCALE_CLAMP, true_div


def apply_deltas_rotated(deltas: torch.Tensor, boxes: torch.Tensor,
                         weights: Tuple[float, float, float, float, float],
                         scale_clamp: float = DEFAULT_SCALE_CLAMP) -> torch.Tensor:
    """deltas (K, 5) and boxes (K, 5) as (cx, cy, w, h, angle) -> (K, 5), the
    angle wrapped into [-180, 180); fp32."""
    deltas, boxes = deltas.float(), boxes.float()
    wx, wy, ww, wh, wa = weights
    dx = true_div(deltas[:, 0], wx)
    dy = true_div(deltas[:, 1], wy)
    dw = true_div(deltas[:, 2], ww).clamp(max=scale_clamp)
    dh = true_div(deltas[:, 3], wh).clamp(max=scale_clamp)
    da = true_div(deltas[:, 4], wa)
    cx = dx * boxes[:, 2] + boxes[:, 0]
    cy = dy * boxes[:, 3] + boxes[:, 1]
    w = torch.exp(dw) * boxes[:, 2]
    h = torch.exp(dh) * boxes[:, 3]
    ang = true_div(da * 180.0, math.pi) + boxes[:, 4]
    ang = torch.remainder(ang + 180.0, 360.0) - 180.0
    return torch.stack([cx, cy, w, h, ang], dim=-1)


def apply_deltas_linear(deltas: torch.Tensor, boxes: torch.Tensor,
                        normalize_by_size: bool = True) -> torch.Tensor:
    """(l, t, r, b) distances from each box's center, scaled by its size
    where ``normalize_by_size`` -> XYXY (box_regression.py:266-303); fp32."""
    deltas, boxes = torch.relu(deltas.float()), boxes.float()
    ctr_x = 0.5 * (boxes[:, 0] + boxes[:, 2])
    ctr_y = 0.5 * (boxes[:, 1] + boxes[:, 3])
    if normalize_by_size:
        sw = boxes[:, 2] - boxes[:, 0]
        sh = boxes[:, 3] - boxes[:, 1]
        deltas = deltas * torch.stack([sw, sh, sw, sh], dim=-1)
    return torch.stack([ctr_x - deltas[:, 0], ctr_y - deltas[:, 1],
                        ctr_x + deltas[:, 2], ctr_y + deltas[:, 3]], dim=-1)


def box_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(K, 5) -> (K, 4, 2) corners, counter-clockwise."""
    cx, cy, w, h, a = boxes.unbind(-1)
    t = a * (math.pi / 180.0)
    c, s = torch.cos(t), torch.sin(t)
    dx = torch.stack([-w, w, w, -w], dim=-1) * 0.5
    dy = torch.stack([-h, -h, h, h], dim=-1) * 0.5
    x = cx[:, None] + dx * c[:, None] - dy * s[:, None]
    y = cy[:, None] + dx * s[:, None] + dy * c[:, None]
    return torch.stack([x, y], dim=-1)


def _polygon_area(pts: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """The shoelace area of the first ``n_valid`` points of pts (..., P, 2)."""
    idx = torch.arange(pts.shape[-2], device=pts.device)
    valid = idx < n_valid[..., None]
    nxt = (idx + 1) % n_valid[..., None].clamp(min=1)
    x, y = pts[..., 0], pts[..., 1]
    x2 = torch.take_along_dim(x, nxt, dim=-1)
    y2 = torch.take_along_dim(y, nxt, dim=-1)
    cross = x * y2 - x2 * y
    return 0.5 * torch.where(valid, cross, torch.zeros_like(cross)).sum(-1).abs()


def _clip_polygon(pts: torch.Tensor, n_valid: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor):
    """One Sutherland-Hodgman step: polygons (..., P, 2) of ``n_valid``
    points clipped to the half-plane left of a -> b (..., 2). Returns the
    clipped polygons, (..., 2P, 2) with their points first, and their
    counts."""
    p = pts.shape[-2]
    idx = torch.arange(p, device=pts.device)
    nxt = (idx + 1) % n_valid[..., None].clamp(min=1)
    nxt_pts = torch.take_along_dim(pts, nxt[..., None], dim=-2)
    d = (b - a)[..., None, :]

    def side(q):
        return d[..., 0] * (q[..., 1] - a[..., None, 1]) - d[..., 1] * (q[..., 0] - a[..., None, 0])

    s_cur, s_nxt = side(pts), side(nxt_pts)
    denom = s_cur - s_nxt
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    t = torch.where(denom.abs() > 1e-12, s_cur / safe, torch.zeros_like(denom))
    inter = pts + (nxt_pts - pts) * t[..., None]
    valid_edge = idx < n_valid[..., None]
    keep_cur = (s_cur >= 0) & valid_edge
    add_inter = ((s_cur >= 0) != (s_nxt >= 0)) & valid_edge
    # edge i emits its start point (if inside), then its crossing (if any)
    order = torch.stack([idx, idx + p], dim=1).reshape(-1)
    out_pts = torch.cat([pts, inter], dim=-2)[..., order, :]
    out_keep = torch.cat([keep_cur, add_inter], dim=-1)[..., order]
    rank = torch.cumsum(out_keep.int(), dim=-1) - 1
    key = torch.where(out_keep, rank, out_pts.shape[-2] + rank + 1)
    compact = torch.take_along_dim(out_pts, torch.argsort(key, dim=-1, stable=True)[..., None],
                                   dim=-2)
    return compact, out_keep.sum(-1)


def rotated_pairwise_iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """(M, 5) x (N, 5) -> (M, N) exact IoU of rotated boxes: each box of b1
    clipped by the four edges of each box of b2 (capacity 16 points)."""
    b1, b2 = b1.float(), b2.float()
    m, n = b1.shape[0], b2.shape[0]
    c1, c2 = box_corners(b1), box_corners(b2)
    pts = torch.cat([c1[:, None].expand(m, n, 4, 2),
                     torch.zeros((m, n, 12, 2), device=b1.device)], dim=-2)
    n_valid = torch.full((m, n), 4, dtype=torch.long, device=b1.device)
    for e in range(4):
        a = c2[None, :, e].expand(m, n, 2)
        b = c2[None, :, (e + 1) % 4].expand(m, n, 2)
        clipped, n_valid = _clip_polygon(pts, n_valid, a, b)
        pts = clipped[..., :pts.shape[-2], :]
    inter = _polygon_area(pts, n_valid)
    union = (b1[:, 2] * b1[:, 3])[:, None] + (b2[:, 2] * b2[:, 3])[None, :] - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, torch.ones_like(union)),
                       torch.zeros_like(inter))


def nms_rotated_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """Greedy rotated NMS: boxes (K, 5), scores and valid (K,) -> keep (K,)
    bool in the original order (stable score order, strict '>')."""
    k = boxes.shape[0]
    s = torch.where(valid, scores.float(), torch.full_like(scores, -1e30, dtype=torch.float32))
    order = torch.sort(-s, stable=True).indices
    v = valid[order]
    iou = rotated_pairwise_iou(boxes[order], boxes[order])
    idx = torch.arange(k, device=boxes.device)
    suppress = (iou > iou_threshold) & (idx[None, :] < idx[:, None]) & v[None, :] & v[:, None]
    keep = v.clone()
    while True:
        new = v & ~(suppress & keep[None, :]).any(dim=1)
        if torch.equal(new, keep):
            break
        keep = new
    return torch.zeros_like(valid).scatter(0, order, keep)
