"""detectron2's DensePose V1ConvX head (``DensePoseV1ConvXHead``), a part of
the reference (``benchmark/parts.py`` says what a head part gives):
NUM_STACKED_CONVS convs of CONV_HEAD_KERNEL, each to CONV_HEAD_DIM channels
and a ReLU, on the pooled regions."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark.counts.model import conv_flops
from benchmark.reference.ops import conv

DP = "MODEL.ROI_DENSEPOSE_HEAD."


def _convs(cfg, cin: int):
    """(name, in channels, out channels) of each conv."""
    hd = cfg[DP + "CONV_HEAD_DIM"]
    return [(f"roi_heads.densepose_head.body_conv_fcn{i + 1}", cin if i == 0 else hd, hd)
            for i in range(cfg[DP + "NUM_STACKED_CONVS"])]


def out_channels(cfg) -> int:
    return cfg[DP + "CONV_HEAD_DIM"]


def shapes(cfg, cin: int) -> Dict[str, Tuple[int, ...]]:
    k = cfg[DP + "CONV_HEAD_KERNEL"]
    out: Dict[str, Tuple[int, ...]] = {}
    for name, i, o in _convs(cfg, cin):
        out[f"{name}.weight"] = (o, i, k, k)
        out[f"{name}.bias"] = (o,)
    return out


def forward(cfg, w: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    for name, _, _ in _convs(cfg, x.shape[1]):
        x = conv(x, w, name, relu=True)
    return x


def flops(cfg, cin: int, rows: int) -> float:
    """The convs on ``rows`` regions of POOLER_RESOLUTION^2."""
    res = cfg[DP + "POOLER_RESOLUTION"]
    return sum(conv_flops(i, o, cfg[DP + "CONV_HEAD_KERNEL"], (res, res), rows)
               for _, i, o in _convs(cfg, cin))
