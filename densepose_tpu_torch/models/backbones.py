"""Backbone dispatch: cfg.MODEL.BACKBONE.NAME -> (spec, module, strides)
(port of densepose_tpu/models/backbones.py): the ResNet-FPN (p2..p6) and
HRNet + HRFPN (p1..p5), both at strides 4..64. The plain C4 ResNet and the
RetinaNet FPN, which no zoo config uses, are not ported (ROADMAP.md).
``backbone_rows`` dispatches the row-sharded walk of each
(``spatial_parallel_forward``)."""

from __future__ import annotations

from typing import Dict

import torch.nn as nn

from ..checkpoint.spec import Spec
from .fpn import FPN, fpn_out_strides, fpn_spec
from .hrnet import HRFPN, hrfpn_out_strides, hrfpn_spec

_BACKBONES = {"build_resnet_fpn_backbone": (fpn_spec, FPN, fpn_out_strides),
              "build_hrfpn_backbone": (hrfpn_spec, HRFPN, hrfpn_out_strides)}


def _entry(cfg):
    name = cfg.MODEL.BACKBONE.NAME
    if name not in _BACKBONES:
        raise NotImplementedError(f"backbone {name!r} is not ported yet")
    return _BACKBONES[name]


def backbone_spec(cfg) -> Spec:
    return _entry(cfg)[0](cfg)


def build_backbone(cfg) -> nn.Module:
    return _entry(cfg)[1](cfg)


def backbone_rows(cfg, backbone: nn.Module, x):
    """The backbone's row-sharded walk (``forward_rows``) on input slabs
    ``x`` (``parallel/halo.py::RowSlabs``): the pyramid as row slabs."""
    name = cfg.MODEL.BACKBONE.NAME
    if name not in _BACKBONES:
        raise NotImplementedError(f"backbone {name!r} has no row-sharded walk: it is not "
                                  "ported yet (ROADMAP.md queue 1, items 5 and 6)")
    return backbone.forward_rows(x)


def feature_strides(cfg) -> Dict[str, int]:
    return _entry(cfg)[2](cfg)


def backbone_out_channels(cfg) -> int:
    """The width of every pyramid level, which the RPN and ROI heads take
    (JAX roi_heads.py::_backbone_out_channels)."""
    if cfg.MODEL.BACKBONE.NAME == "build_hrfpn_backbone":
        return cfg.MODEL.HRNET.HRFPN.OUT_CHANNELS
    return cfg.MODEL.FPN.OUT_CHANNELS
