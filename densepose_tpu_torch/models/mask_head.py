"""Mask R-CNN mask head (port of densepose_tpu/models/mask_head.py), NCHW.

MaskRCNNConvUpsampleHead + mask_rcnn_inference
(detectron2/modeling/roi_heads/mask_head.py:29-209): multi-level ROIAlign of
each detection over ``ROI_HEADS.IN_FEATURES`` (kernel K2 on the card, its
plain version on the CPU), ``ROI_MASK_HEAD.NUM_CONV`` 3x3 convs with ReLU, a
2x deconvolution (k2 s2) with ReLU, a 1x1 predictor (one channel a class,
or one with ``CLS_AGNOSTIC_MASK``), then the sigmoid in fp32 and each
detection's predicted class channel. Standalone, as in the JAX package:
every DensePose config sets MASK_ON False and ``GeneralizedRCNN`` does not
call it.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..checkpoint.spec import ParamSpec, Spec, conv_spec
from ..ops.roi_align import assign_boxes_to_levels, roi_align_multilevel


def mask_head_spec(cfg, prefix: str = "roi_heads.mask_head") -> Spec:
    """The JAX package's spec, in its order."""
    m = cfg.MODEL.ROI_MASK_HEAD
    spec: Spec = {}
    d = cfg.MODEL.FPN.OUT_CHANNELS
    for k in range(m.NUM_CONV):
        conv_spec(spec, f"{prefix}.mask_fcn{k + 1}", d, m.CONV_DIM, 3)
        d = m.CONV_DIM
    spec[f"{prefix}.deconv.weight"] = ParamSpec((d, m.CONV_DIM, 2, 2), "convT")
    spec[f"{prefix}.deconv.bias"] = ParamSpec((m.CONV_DIM,), "vec")
    conv_spec(spec, f"{prefix}.predictor", m.CONV_DIM, mask_classes(cfg), 1)
    return spec


def mask_classes(cfg) -> int:
    return 1 if cfg.MODEL.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK else cfg.MODEL.ROI_HEADS.NUM_CLASSES


def pool_levels(features: Dict[str, torch.Tensor], boxes: torch.Tensor, cfg, head_cfg,
                strides: Dict[str, int]) -> torch.Tensor:
    """Multi-level ROIAlign of ``boxes`` (M, 4) over ROI_HEADS.IN_FEATURES of
    one frame's (1, C, H, W) or (C, H, W) maps, at ``head_cfg``'s resolution,
    ratio and type (JAX ``mask_head_forward``'s and
    ``keypoint_head_forward``'s pooling): (M, C, res, res)."""
    in_features: List[str] = list(cfg.MODEL.ROI_HEADS.IN_FEATURES)
    res = head_cfg.POOLER_RESOLUTION
    scales = [1.0 / strides[f] for f in in_features]
    levels = assign_boxes_to_levels(boxes, int(-math.log2(scales[0])),
                                    int(-math.log2(scales[-1])))
    return roi_align_multilevel([features[f] for f in in_features], boxes, levels, scales,
                                (res, res), head_cfg.POOLER_SAMPLING_RATIO,
                                head_cfg.POOLER_TYPE == "ROIAlignV2")


class MaskRCNNConvUpsampleHead(nn.Module):
    """``forward(features, boxes, pred_classes, strides)``: per-detection
    sigmoid mask probabilities (M, 2 res, 2 res), fp32, of each detection's
    class (``pred_classes`` clipped into the predictor's channels)."""

    def __init__(self, cfg):
        super().__init__()
        m = cfg.MODEL.ROI_MASK_HEAD
        self.cfg = cfg
        self.num_conv = m.NUM_CONV
        d = cfg.MODEL.FPN.OUT_CHANNELS
        for k in range(m.NUM_CONV):
            self.add_module(f"mask_fcn{k + 1}", nn.Conv2d(d, m.CONV_DIM, 3, padding=1))
            d = m.CONV_DIM
        self.deconv = nn.ConvTranspose2d(d, m.CONV_DIM, 2, stride=2)
        self.predictor = nn.Conv2d(m.CONV_DIM, mask_classes(cfg), 1)

    def forward(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor,
                pred_classes: torch.Tensor, strides: Dict[str, int]) -> torch.Tensor:
        x = pool_levels(features, boxes, self.cfg, self.cfg.MODEL.ROI_MASK_HEAD, strides)
        for k in range(self.num_conv):
            x = F.relu(getattr(self, f"mask_fcn{k + 1}")(x))
        x = F.relu(self.deconv(x))
        probs = torch.sigmoid(self.predictor(x).float())
        if probs.shape[1] == 1:
            return probs[:, 0]
        idx = pred_classes.long().clamp(0, probs.shape[1] - 1)
        return torch.take_along_dim(probs, idx[:, None, None, None], dim=1)[:, 0]
