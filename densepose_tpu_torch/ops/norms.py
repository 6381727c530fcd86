"""Normalisation ops (port of densepose_tpu/ops/norms.py).

FrozenBN is folded into the convs at load time (checkpoint/transform.py), so
GroupNorm, used by the DeepLab head, is the one norm that runs: two-pass
statistics on the fp path, one-pass ones in the int8 serving chain.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """torch ``nn.GroupNorm`` over NCHW x, statistics in fp32 (port of
    densepose_tpu/ops/norms.py:103-125, which computes the same on NHWC)."""
    return F.group_norm(x.float(), num_groups, weight.float(), bias.float(), eps).to(x.dtype)


def group_norm_onepass(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over channel-last x (..., H, W, C) with one-pass statistics,
    var = max(E[x^2] - mean^2, 0), in fp32 (port of
    densepose_tpu/ops/norms.py:70-100): the DeepLab int8 serving chain's
    norm only (``models/roi_heads.py::stacked_int8_chain``); the exact path
    and the calibration walk keep ``group_norm``'s two passes."""
    *lead, h, w, c = x.shape
    xf = x.float().reshape(*lead, h, w, num_groups, c // num_groups)
    dims = (len(lead), len(lead) + 1, len(lead) + 3)
    mean = xf.mean(dim=dims, keepdim=True)
    mean_sq = (xf * xf).mean(dim=dims, keepdim=True)
    var = (mean_sq - mean * mean).clamp_min(0.0)
    xf = ((xf - mean) / torch.sqrt(var + eps)).reshape(*lead, h, w, c)
    return (xf * weight.float() + bias.float()).to(x.dtype)


class GroupNorm32(nn.GroupNorm):
    """The reference's ``nn.GroupNorm(32, C)`` (deeplab.py), through
    ``group_norm``; its parameters are the state_dict's ``weight``/``bias``."""

    def __init__(self, channels: int):
        super().__init__(32, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps)
