"""Keypoint R-CNN head (port of densepose_tpu/models/keypoint_head.py), NCHW.

KRCNNConvDeconvUpsampleHead (detectron2/modeling/roi_heads/keypoint_head.py):
multi-level ROIAlign of each detection over ``ROI_HEADS.IN_FEATURES``
(kernel K2 on the card, ``mask_head.py::pool_levels``), the
``ROI_KEYPOINT_HEAD.CONV_DIMS`` 3x3 convs with ReLU, the k4 s2 p1
deconvolution to one heatmap a keypoint, and a 2x bilinear upsample: logits
(M, K, 4 res, 4 res). ``heatmaps_to_keypoints_np`` is the host-side
extraction (structures.py:34-104, with its per-box bicubic resize,
``_resize_bicubic_np``), as in the JAX package: per box and dynamic in
size, so it runs on numpy. Standalone, as in the JAX package: every
DensePose config sets KEYPOINT_ON False and ``GeneralizedRCNN`` does not
call it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..checkpoint.spec import ParamSpec, Spec, conv_spec
from ..ops.resize import resize_bilinear
from .mask_head import pool_levels


def keypoint_head_spec(cfg, prefix: str = "roi_heads.keypoint_head") -> Spec:
    """The JAX package's spec, in its order."""
    spec: Spec = {}
    d = cfg.MODEL.FPN.OUT_CHANNELS
    for i, c in enumerate(cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS):
        conv_spec(spec, f"{prefix}.conv_fcn{i + 1}", d, c, 3)
        d = c
    nkp = cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS
    spec[f"{prefix}.score_lowres.weight"] = ParamSpec((d, nkp, 4, 4), "convT")
    spec[f"{prefix}.score_lowres.bias"] = ParamSpec((nkp,), "vec")
    return spec


class KRCNNConvDeconvUpsampleHead(nn.Module):
    """``forward(features, boxes, strides)``: keypoint heatmap logits
    (M, NUM_KEYPOINTS, 4 res, 4 res) in the maps' dtype."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        dims = list(cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS)
        self.n = len(dims)
        d = cfg.MODEL.FPN.OUT_CHANNELS
        for i, c in enumerate(dims):
            self.add_module(f"conv_fcn{i + 1}", nn.Conv2d(d, c, 3, padding=1))
            d = c
        self.score_lowres = nn.ConvTranspose2d(d, cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS, 4,
                                               stride=2, padding=1)

    def forward(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor,
                strides: Dict[str, int]) -> torch.Tensor:
        x = pool_levels(features, boxes, self.cfg, self.cfg.MODEL.ROI_KEYPOINT_HEAD, strides)
        for i in range(self.n):
            x = F.relu(getattr(self, f"conv_fcn{i + 1}")(x))
        x = self.score_lowres(x)
        return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2), scale=(2.0, 2.0))


def _resize_bicubic_np(x: np.ndarray, out_hw) -> np.ndarray:
    """(H, W, C) -> (h, w, C) float32 with torch ``F.interpolate(mode=
    "bicubic", align_corners=False)``'s semantics: the cubic convolution
    kernel with a = -0.75, half-pixel source coordinates, replicated borders,
    no clamping of the values (the JAX package's ``_resize_bicubic_np``)."""
    h_in, w_in = x.shape[:2]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x.astype(np.float32)
    a = -0.75

    def weights(t):  # the 4 taps' distances from the source point, (n, 4)
        t = np.abs(t)
        w1 = ((a + 2) * t - (a + 3)) * t * t + 1          # |t| <= 1
        w2 = ((a * t - 5 * a) * t + 8 * a) * t - 4 * a    # 1 < |t| < 2
        return np.where(t <= 1, w1, np.where(t < 2, w2, 0.0))

    def axis(in_size, out_size):
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
        base = np.floor(src).astype(np.int64)
        taps = base[:, None] + np.arange(-1, 3)[None, :]
        dist = (src - base)[:, None] - np.arange(-1, 3)[None, :]
        return np.clip(taps, 0, in_size - 1), weights(dist).astype(np.float32)

    yi, yw = axis(h_in, h_out)
    xi, xw = axis(w_in, w_out)
    # tap by tap, so that the peak memory stays one (h_out, w_out, C) map
    rows = np.zeros((h_out, w_in) + x.shape[2:], dtype=np.float32)
    for tap in range(4):
        rows += x[yi[:, tap]] * yw[:, tap][:, None, None]
    out = np.zeros((h_out, w_out) + x.shape[2:], dtype=np.float32)
    for tap in range(4):
        out += rows[:, xi[:, tap]] * xw[:, tap][None, :, None]
    return out


def heatmaps_to_keypoints_np(maps: np.ndarray, rois: np.ndarray) -> np.ndarray:
    """Host-side keypoint extraction (structures.py:34-104, the JAX
    package's ``heatmaps_to_keypoints_np``): maps (N, K, H, W) logits, rois
    (N, 4) XYXY -> (N, K, 4) of (x, y, logit, score). Each box's maps are
    resized bicubically to its ceil'd size; a keypoint is the argmax there,
    its score the softmax of the argmax's logit over the unresized map."""
    n, k = maps.shape[:2]
    out = np.zeros((n, k, 4), dtype=np.float32)
    for i in range(n):
        x0, y0, x1, y1 = rois[i]
        w, h = max(x1 - x0, 1.0), max(y1 - y0, 1.0)
        wc, hc = int(np.ceil(w)), int(np.ceil(h))
        roi_map = _resize_bicubic_np(np.transpose(maps[i], (1, 2, 0)).astype(np.float32),
                                     (hc, wc))
        for kp in range(k):
            m = roi_map[..., kp]
            yy, xx = np.unravel_index(m.argmax(), m.shape)
            top = m.max()
            score = np.exp(m - top)[yy, xx] / np.exp(maps[i, kp] - top).sum()
            out[i, kp] = ((xx + 0.5) * (w / wc) + x0, (yy + 0.5) * (h / hc) + y0, m[yy, xx],
                          score)
    return out
