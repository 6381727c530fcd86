"""Backbone dispatch: cfg.MODEL.BACKBONE.NAME -> (spec, module, strides)
(port of densepose_tpu/models/backbones.py): the ResNet-FPN (p2..p6), HRNet +
HRFPN (p1..p5), the plain ResNet of the C4 detector (``build_resnet_backbone``:
the ResNet itself under the prefix ``backbone``, its ``RESNETS.OUT_FEATURES``
at strides ``2**stage``) and the RetinaNet FPN (p3..p7).
``backbone_rows`` dispatches the row-sharded walk of each
(``spatial_parallel_forward``)."""

from __future__ import annotations

from typing import Dict

import torch.nn as nn

from ..checkpoint.spec import Spec
from .fpn import (FPN, RetinaNetFPN, fpn_out_strides, fpn_spec, retinanet_fpn_out_strides,
                  retinanet_fpn_spec)
from .hrnet import HRFPN, hrfpn_out_strides, hrfpn_spec
from .resnet import ResNet, resnet_spec


def _resnet_strides(cfg) -> Dict[str, int]:
    return {f: 2 ** int(f[3:]) for f in cfg.MODEL.RESNETS.OUT_FEATURES}


_BACKBONES = {"build_resnet_fpn_backbone": (fpn_spec, FPN, fpn_out_strides),
              "build_hrfpn_backbone": (hrfpn_spec, HRFPN, hrfpn_out_strides),
              "build_resnet_backbone": (lambda cfg: resnet_spec(cfg, prefix="backbone"), ResNet,
                                        _resnet_strides),
              "build_retinanet_resnet_fpn_backbone": (retinanet_fpn_spec, RetinaNetFPN,
                                                      retinanet_fpn_out_strides)}


def _entry(cfg):
    name = cfg.MODEL.BACKBONE.NAME
    if name not in _BACKBONES:
        raise NotImplementedError(f"backbone {name!r}: the JAX package has no such backbone")
    return _BACKBONES[name]


def backbone_spec(cfg) -> Spec:
    return _entry(cfg)[0](cfg)


def build_backbone(cfg) -> nn.Module:
    return _entry(cfg)[1](cfg)


def backbone_rows(cfg, backbone: nn.Module, x):
    """The backbone's row-sharded walk (``forward_rows``) on input slabs
    ``x`` (``parallel/halo.py::RowSlabs``): its features as row slabs."""
    _entry(cfg)
    return backbone.forward_rows(x)


def feature_strides(cfg) -> Dict[str, int]:
    return _entry(cfg)[2](cfg)


def backbone_out_channels(cfg) -> int:
    """The width of the features the RPN and ROI heads take (JAX
    roi_heads.py::_backbone_out_channels): for the C4 backbone that of
    ``RPN.IN_FEATURES[0]``'s stage (res4: 1024 on R50, 256 below depth 50)."""
    name = cfg.MODEL.BACKBONE.NAME
    if name == "build_hrfpn_backbone":
        return cfg.MODEL.HRNET.HRFPN.OUT_CHANNELS
    if name == "build_resnet_backbone":
        stage = int(cfg.MODEL.RPN.IN_FEATURES[0][3:])
        if cfg.MODEL.RESNETS.DEPTH >= 50:
            return cfg.MODEL.RESNETS.RES2_OUT_CHANNELS * 2 ** (stage - 2)
        return 64 * 2 ** (stage - 2)
    return cfg.MODEL.FPN.OUT_CHANNELS
