"""FPN (port of densepose_tpu/models/fpn.py), NCHW.

Lateral 1x1 and output 3x3 convs per level, a top-down exact 2x nearest
upsample with sum fusion (fpn.py:125-166) and LastLevelMaxPool p6
(fpn.py:187-199). DensePose configs use norm="" (bias convs) and
fuse_type="sum".

int8 serving (``TPU.INT8_BACKBONE``, JAX fpn.py:51-130): once calibrated, the
3x3 output convs run through kernel Q1 on the top-down sums quantized at their
scale, to f32 and then the compute dtype; the laterals stay fp. This holds at
any ResNet depth: FPN int8 has no depth gate. ``fpn_int8_scale_sites`` and
``FPN.int8_calibration`` are the site lists (FPN, then the RPN conv's per-level
inputs) and the walk that records them. ``FPN.forward_rows`` is the forward
on row slabs of the frame (``spatial_parallel_forward``).

``RetinaNetFPN`` (``build_retinanet_resnet_fpn_backbone``, JAX fpn.py:165-207)
is the same FPN with LastLevelP6P7 in place of the max pool: p6 a 3x3/2 conv
of res5, p7 a 3x3/2 conv of relu(p6) (``top_block.p6`` / ``.p7``).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..checkpoint.spec import Spec, conv_spec
from ..ops.conv_int8 import act_stat, link, quantized, to_nchw, to_s8_nhwc
from ..parallel.halo import (RowSlabs, conv_rows, link_rows, subsample_rows,
                             upsample_nearest_rows)
from .resnet import ResNet, resnet_spec

_STAGE_LOG2 = {"res2": 2, "res3": 3, "res4": 4, "res5": 5}


def _in_channels(cfg) -> Dict[str, int]:
    """Each stage's width (JAX fpn.py:34-40): 64..512 for BasicBlock ResNets,
    RES2_OUT_CHANNELS doubling per stage for bottlenecks."""
    if cfg.MODEL.RESNETS.DEPTH < 50:
        return {"res2": 64, "res3": 128, "res4": 256, "res5": 512}
    base = cfg.MODEL.RESNETS.RES2_OUT_CHANNELS
    return {f: base * (2 ** (s - 2)) for f, s in _STAGE_LOG2.items()}


def _check_supported(cfg) -> None:
    if cfg.MODEL.FPN.NORM:
        raise NotImplementedError(f"FPN.NORM {cfg.MODEL.FPN.NORM!r}: the JAX package declares the "
                                  "norm's parameters but applies none (fpn.py:30-47, 60-91); the "
                                  "port refuses it rather than copy that")


def fpn_spec(cfg, prefix: str = "backbone") -> Spec:
    _check_supported(cfg)
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


def fpn_int8_scale_sites(cfg, prefix: str = "backbone",
                         rpn_prefix: str = "proposal_generator.rpn_head"):
    """(FPN sites, RPN sites) in ``FPN.int8_calibration``'s order (JAX
    ``fpn_int8_scale_sites``): the output convs' input scales top-down, then
    the RPN conv's per-level input scales in RPN.IN_FEATURES order."""
    fpn_sites = [f"{prefix}.fpn_output{_STAGE_LOG2[f]}.in_scale"
                 for f in reversed(cfg.MODEL.FPN.IN_FEATURES)]
    rpn_sites = [f"{rpn_prefix}.conv.in_scale_{f}" for f in cfg.MODEL.RPN.IN_FEATURES]
    return fpn_sites, rpn_sites


class FPN(nn.Module):
    """x: (N, 3, H, W) -> {"p2": ..., "p6": ...} NCHW."""

    def __init__(self, cfg):
        super().__init__()
        _check_supported(cfg)
        self.in_features: List[str] = list(cfg.MODEL.FPN.IN_FEATURES)
        self.int8 = bool(cfg.TPU.INT8_BACKBONE)
        self.bottom_up = ResNet(cfg)
        out_channels = cfg.MODEL.FPN.OUT_CHANNELS
        ch = _in_channels(cfg)
        for f in self.in_features:
            stage = _STAGE_LOG2[f]
            self.add_module(f"fpn_lateral{stage}", nn.Conv2d(ch[f], out_channels, 1))
            self.add_module(f"fpn_output{stage}",
                            nn.Conv2d(out_channels, out_channels, 3, padding=1))

    def int8_active(self) -> bool:
        """``TPU.INT8_BACKBONE`` with the output convs' calibration installed
        (JAX ``fpn_int8_active``)."""
        return self.int8 and quantized(getattr(self, f"fpn_output{_STAGE_LOG2[self.in_features[0]]}"))

    def forward(self, x: torch.Tensor, stats: List[torch.Tensor] = None,
                stat: str = "max") -> Dict[str, torch.Tensor]:
        """``stats``: append each output conv's input statistic (the fp
        calibration walk) instead of running int8."""
        results, _ = self.levels(x, stats, stat)
        top = _STAGE_LOG2[self.in_features[-1]]
        results[f"p{top + 1}"] = results[f"p{top}"][:, :, ::2, ::2]
        return dict(sorted(results.items()))

    def levels(self, x: torch.Tensor, stats: List[torch.Tensor] = None,
               stat: str = "max"):
        """The lateral, top-down and output pass (JAX ``_fpn_levels``):
        (the p-levels of ``FPN.IN_FEATURES``, the bottom-up features)."""
        bottom_up = self.bottom_up(x)
        int8 = stats is None and self.int8_active()
        results: Dict[str, torch.Tensor] = {}
        prev = None
        for f in reversed(self.in_features):
            stage = _STAGE_LOG2[f]
            lateral = getattr(self, f"fpn_lateral{stage}")(bottom_up[f])
            if prev is not None:
                lateral = lateral + F.interpolate(prev, scale_factor=2.0, mode="nearest")
            prev = lateral
            out = getattr(self, f"fpn_output{stage}")
            if stats is not None:
                stats.append(act_stat(prev, stat, getattr(out, "in_scale", None)))
            if int8:
                y = link(out, to_s8_nhwc(prev, out.in_scale), out.in_scale)
                results[f"p{stage}"] = to_nchw(y, prev.dtype)
            else:
                results[f"p{stage}"] = out(prev)
        return results, bottom_up

    def forward_rows(self, x: RowSlabs) -> Dict[str, RowSlabs]:
        """``forward`` (its serving arm) on row slabs (``parallel/halo.py``):
        the top-down sums row-local, the output convs with a halo exchange, p6
        from the even global rows of p5."""
        results, _ = self.levels_rows(x)
        top = _STAGE_LOG2[self.in_features[-1]]
        results[f"p{top + 1}"] = subsample_rows(results[f"p{top}"])
        return dict(sorted(results.items()))

    def levels_rows(self, x: RowSlabs):
        """``levels`` on row slabs."""
        bottom_up = self.bottom_up.forward_rows(x)
        int8 = self.int8_active()
        results: Dict[str, RowSlabs] = {}
        prev = None
        for f in reversed(self.in_features):
            stage = _STAGE_LOG2[f]
            lateral = conv_rows(getattr(self, f"fpn_lateral{stage}"), bottom_up[f])
            if prev is not None:
                lateral = lateral.map(torch.add, upsample_nearest_rows(prev, 2))
            prev = lateral
            out = getattr(self, f"fpn_output{stage}")
            if int8:
                q = prev.map(to_s8_nhwc, out.in_scale, row_dim=1)
                results[f"p{stage}"] = link_rows(out, q, out.in_scale).map(
                    to_nchw, prev.dtype, row_dim=2)
            else:
                results[f"p{stage}"] = conv_rows(out, prev)
        return results, bottom_up

    def int8_calibration(self, x: torch.Tensor, rpn_conv: nn.Module, rpn_features: List[str],
                         stat: str = "max") -> torch.Tensor:
        """The fp pass recording the output convs' input statistics, then the
        RPN conv's per level (p6 from the pooled p5), in
        ``fpn_int8_scale_sites`` order (JAX ``fpn_int8_calibration``). The
        bottom-up runs as the model serves it."""
        stats: List[torch.Tensor] = []
        results = self.forward(x, stats, stat)
        for f in rpn_features:
            stats.append(act_stat(results[f], stat, getattr(rpn_conv, f"in_scale_{f}", None)))
        return torch.stack(stats)


def retinanet_fpn_spec(cfg, prefix: str = "backbone") -> Spec:
    """The FPN's spec and LastLevelP6P7's two convs (JAX
    ``retinanet_fpn_spec``: res5's width taken as 8 x RES2_OUT_CHANNELS)."""
    spec = fpn_spec(cfg, prefix)
    out_channels = cfg.MODEL.FPN.OUT_CHANNELS
    conv_spec(spec, f"{prefix}.top_block.p6", cfg.MODEL.RESNETS.RES2_OUT_CHANNELS * 8,
              out_channels, 3)
    conv_spec(spec, f"{prefix}.top_block.p7", out_channels, out_channels, 3)
    return spec


def retinanet_fpn_out_strides(cfg) -> Dict[str, int]:
    top = _STAGE_LOG2[cfg.MODEL.FPN.IN_FEATURES[-1]]
    strides = {f"p{_STAGE_LOG2[f]}": 2 ** _STAGE_LOG2[f] for f in cfg.MODEL.FPN.IN_FEATURES}
    strides.update({f"p{top + 1}": 2 ** (top + 1), f"p{top + 2}": 2 ** (top + 2)})
    return strides


class LastLevelP6P7(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.p6 = nn.Conv2d(cin, cout, 3, stride=2, padding=1)
        self.p7 = nn.Conv2d(cout, cout, 3, stride=2, padding=1)


class RetinaNetFPN(FPN):
    """x: (N, 3, H, W) -> {"p3": ..., "p7": ...} NCHW: the FPN levels, p6 a
    3x3/2 conv of res5 and p7 a 3x3/2 conv of relu(p6) (JAX
    ``retinanet_fpn_forward``)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.top_block = LastLevelP6P7(cfg.MODEL.RESNETS.RES2_OUT_CHANNELS * 8,
                                       cfg.MODEL.FPN.OUT_CHANNELS)

    def forward(self, x: torch.Tensor, stats: List[torch.Tensor] = None,
                stat: str = "max") -> Dict[str, torch.Tensor]:
        results, bottom_up = self.levels(x, stats, stat)
        top = _STAGE_LOG2[self.in_features[-1]]
        p6 = self.top_block.p6(bottom_up["res5"])
        results[f"p{top + 1}"] = p6
        results[f"p{top + 2}"] = self.top_block.p7(F.relu(p6))
        return dict(sorted(results.items()))

    def forward_rows(self, x: RowSlabs) -> Dict[str, RowSlabs]:
        """``forward`` on row slabs: p6 and p7 stride-2 convs with a halo
        exchange."""
        results, bottom_up = self.levels_rows(x)
        top = _STAGE_LOG2[self.in_features[-1]]
        p6 = conv_rows(self.top_block.p6, bottom_up["res5"])
        results[f"p{top + 1}"] = p6
        results[f"p{top + 2}"] = conv_rows(self.top_block.p7, p6.map(F.relu))
        return dict(sorted(results.items()))
