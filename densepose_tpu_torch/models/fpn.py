"""FPN (port of densepose_tpu/models/fpn.py), NCHW.

Lateral 1x1 and output 3x3 convs per level, a top-down exact 2x nearest
upsample with sum fusion (fpn.py:125-166) and LastLevelMaxPool p6
(fpn.py:187-199). DensePose configs use norm="" (bias convs) and
fuse_type="sum".
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..checkpoint.spec import Spec, conv_spec
from .resnet import ResNet, resnet_spec

_STAGE_LOG2 = {"res2": 2, "res3": 3, "res4": 4, "res5": 5}


def _in_channels(cfg) -> Dict[str, int]:
    base = cfg.MODEL.RESNETS.RES2_OUT_CHANNELS
    return {f: base * (2 ** (s - 2)) for f, s in _STAGE_LOG2.items()}


def fpn_spec(cfg, prefix: str = "backbone") -> Spec:
    if cfg.MODEL.FPN.NORM:
        raise NotImplementedError(f"FPN norm {cfg.MODEL.FPN.NORM!r} is not ported yet")
    spec = resnet_spec(cfg, prefix=f"{prefix}.bottom_up")
    out_channels = cfg.MODEL.FPN.OUT_CHANNELS
    ch = _in_channels(cfg)
    for f in cfg.MODEL.FPN.IN_FEATURES:
        stage = _STAGE_LOG2[f]
        conv_spec(spec, f"{prefix}.fpn_lateral{stage}", ch[f], out_channels, 1)
        conv_spec(spec, f"{prefix}.fpn_output{stage}", out_channels, out_channels, 3)
    return spec


def fpn_out_strides(cfg) -> Dict[str, int]:
    in_features = cfg.MODEL.FPN.IN_FEATURES
    strides = {f"p{_STAGE_LOG2[f]}": 2 ** _STAGE_LOG2[f] for f in in_features}
    top = _STAGE_LOG2[in_features[-1]] + 1
    strides[f"p{top}"] = 2 ** top
    return strides


class FPN(nn.Module):
    """x: (N, 3, H, W) -> {"p2": ..., "p6": ...} NCHW."""

    def __init__(self, cfg):
        super().__init__()
        if cfg.MODEL.FPN.NORM:
            raise NotImplementedError(f"FPN norm {cfg.MODEL.FPN.NORM!r} is not ported yet")
        self.in_features: List[str] = list(cfg.MODEL.FPN.IN_FEATURES)
        self.bottom_up = ResNet(cfg)
        out_channels = cfg.MODEL.FPN.OUT_CHANNELS
        ch = _in_channels(cfg)
        for f in self.in_features:
            stage = _STAGE_LOG2[f]
            self.add_module(f"fpn_lateral{stage}", nn.Conv2d(ch[f], out_channels, 1))
            self.add_module(f"fpn_output{stage}",
                            nn.Conv2d(out_channels, out_channels, 3, padding=1))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        bottom_up = self.bottom_up(x)
        results: Dict[str, torch.Tensor] = {}
        prev = None
        for f in reversed(self.in_features):
            stage = _STAGE_LOG2[f]
            lateral = getattr(self, f"fpn_lateral{stage}")(bottom_up[f])
            if prev is not None:
                lateral = lateral + F.interpolate(prev, scale_factor=2.0, mode="nearest")
            prev = lateral
            results[f"p{stage}"] = getattr(self, f"fpn_output{stage}")(prev)
        top = _STAGE_LOG2[self.in_features[-1]]
        results[f"p{top + 1}"] = results[f"p{top}"][:, :, ::2, ::2]
        return dict(sorted(results.items()))
