"""Normalisation ops (port of densepose_tpu/ops/norms.py).

FrozenBN is folded into the convs at load time (checkpoint/transform.py)
unless ``TPU.FOLD_FROZEN_BN`` is off: then each conv keeps a
``FrozenBatchNorm2d`` child (``conv_bn``) that applies the statistics after
it, as the JAX package's ``frozen_batch_norm`` does. GroupNorm, used by the
DeepLab head, runs with two-pass statistics on the fp path and one-pass ones
in the int8 serving chain. ``layer_norm_cf`` and ``cycle_batch_norm`` are the
JAX package's twins of two reference norms that no config reaches.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def frozen_batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      running_mean: torch.Tensor, running_var: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """x * scale + shift over the channels of NCHW x; scale and shift in fp32
    from the statistics, then cast to x's dtype (JAX ``frozen_batch_norm``,
    batch_norm.py:44-51)."""
    scale = weight.float() / torch.sqrt(running_var.float() + eps)
    shift = bias.float() - running_mean.float() * scale
    return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class FrozenBatchNorm2d(nn.Module):
    """detectron2's FrozenBatchNorm2d (batch_norm.py:10-92) at inference,
    through ``frozen_batch_norm``. Its four vectors are parameters that take
    no gradient, so that the predictor casts them to the compute dtype as the
    JAX package casts every float32 param (``_cast_param``); their state_dict
    names are the reference's."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        for name, fill in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                           ("running_var", 1.0)):
            setattr(self, name, nn.Parameter(torch.full((channels,), fill), requires_grad=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return frozen_batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var,
                                 self.eps)


class Conv2dNorm(nn.Conv2d):
    """detectron2's Conv2d with a fused norm (layers/wrappers.py:82-112): the
    convolution, then ``self.norm``."""

    def __init__(self, *args, norm: nn.Module, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


def conv_bn(cin: int, cout: int, k: int, fold: bool, **kwargs) -> nn.Conv2d:
    """A conv followed by a FrozenBN: with ``fold`` (``TPU.FOLD_FROZEN_BN``)
    the BN lives in the conv's weight and bias; without, the conv has no bias
    and a ``FrozenBatchNorm2d`` ``norm`` child."""
    if fold:
        return nn.Conv2d(cin, cout, k, **kwargs)
    return Conv2dNorm(cin, cout, k, bias=False, norm=FrozenBatchNorm2d(cout), **kwargs)


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


def layer_norm_cf(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """ConvNeXt-style LayerNorm over the last (channel) axis of x (..., C),
    statistics in fp32, the result in x's dtype (JAX ``layer_norm_cf``;
    detectron2's LayerNorm, batch_norm.py:240-259, which no DensePose config
    uses)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) / torch.sqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def cycle_batch_norm(x: torch.Tensor, running_means: torch.Tensor, running_vars: torch.Tensor,
                     weight: Optional[torch.Tensor], bias: Optional[torch.Tensor], pos,
                     eps: float = 1e-5) -> torch.Tensor:
    """detectron2's ``CycleBatchNormList`` (batch_norm.py:193-238) at
    inference, on channel-last x (..., C), as the JAX package's twin takes
    it: the affine-free BN of domain ``pos`` (an int or a 0-dim integer
    tensor; the caller cycles it), then the shared affine where ``weight`` is
    given. running_means / running_vars (N, C)."""
    pos = torch.as_tensor(pos, device=running_means.device).long().reshape(1)
    mean = running_means.index_select(0, pos)[0].float()
    var = running_vars.index_select(0, pos)[0].float()
    y = (x.float() - mean) / torch.sqrt(var + eps)
    if weight is not None:
        y = y * weight.float() + bias.float()
    return y.to(x.dtype)
