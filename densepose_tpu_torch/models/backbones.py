"""Backbone dispatch: cfg.MODEL.BACKBONE.NAME -> (spec, module, strides)
(port of densepose_tpu/models/backbones.py). The flagship's ResNet-FPN is the
one backbone ported so far; the others are listed in ROADMAP.md."""

from __future__ import annotations

from typing import Dict

import torch.nn as nn

from ..checkpoint.spec import Spec
from .fpn import FPN, fpn_out_strides, fpn_spec

_BACKBONES = {"build_resnet_fpn_backbone": (fpn_spec, FPN, fpn_out_strides)}


def _entry(cfg):
    name = cfg.MODEL.BACKBONE.NAME
    if name not in _BACKBONES:
        raise NotImplementedError(f"backbone {name!r} is not ported yet")
    return _BACKBONES[name]


def backbone_spec(cfg) -> Spec:
    return _entry(cfg)[0](cfg)


def build_backbone(cfg) -> nn.Module:
    return _entry(cfg)[1](cfg)


def feature_strides(cfg) -> Dict[str, int]:
    return _entry(cfg)[2](cfg)
