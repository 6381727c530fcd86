"""HRNet-W32/40/48 + HRFPN backbone (port of densepose_tpu/models/hrnet.py,
its plain path), NCHW.

The reference declares ``build_hrfpn_backbone`` and its MODEL.HRNET keys but
ships no implementation; the JAX package supplies HRNetV2p (Sun et al., CVPR
2019) with the detectron2-DensePose / mmdetection HRFPN neck, under the
upstream HRNet parameter names (``conv1``/``bn1``, ``layer1``,
``transition{1..3}``, ``stage{2..4}.<m>.branches`` / ``fuse_layers``,
``reduction_conv``, ``fpn_conv``). This module is that network.

Every BatchNorm is inference-mode (FrozenBN) and is folded into its conv when
the weights load (``checkpoint/transform.py::fold_state`` folds the sibling
``bn{N}`` / ``.1`` modules), so every conv here carries a bias and no norm.
With ``TPU.FOLD_FROZEN_BN`` off each conv applies its BN after it instead
(``ops/norms.py::conv_bn``: the sibling's statistics under the conv's
``.norm``), as JAX ``_cbr`` and ``hrnet_forward``'s stem do (hrnet.py:108-118,
446-451). The int8 chains then do not run: the port refuses
``INT8_BACKBONE`` with the flag off (``models/rcnn.py::_check_supported``).

Structure (branch widths Ci from MODEL.HRNET.STAGEk.NUM_CHANNELS):
    stem: two 3x3/2 convs (64) -> 1/4 resolution
    layer1: 4 bottleneck blocks 64 -> 256
    stage2..4: 2, 3, 4 branches at 1/4 .. 1/32, NUM_MODULES modules each;
    a module runs NUM_BLOCKS BasicBlocks per branch, then fuses every branch
    into every other (a 1x1 conv and a nearest upsample from a coarser
    branch, a chain of 3x3/2 convs from a finer one, summed, ReLU)
    HRFPN: every branch bilinearly upsampled to 1/4, concatenated, a 1x1
    reduction, an average-pool pyramid and a 3x3 conv per level -> p1..p5
    (strides 4..64)

int8 serving (``TPU.INT8_BACKBONE``, JAX hrnet.py:273-433, 536-668): once
calibrated, layer1's bottlenecks, every branch's BasicBlock chain, the HRFPN
reduction and p1's conv run through kernel Q1 (``ops/conv_int8.py``); the stem,
transitions, fusions and the pooled levels' convs stay fp. As in the JAX
package, layer1's identity shortcut adds the fp input x while a BasicBlock's
adds its dequantized s8 input q * s_in. Passing ``calib`` (a list) to the
forwards runs the fp walk instead and appends each site's statistic in
``hrnet_int8_scale_sites`` order.

Each ``forward_rows`` / ``forward_int8_rows`` is the forward above it (its
serving arms, no calibration walk) on row slabs of the frame
(``parallel/halo.py``), for ``spatial_parallel_forward``.

Left out, as TPU-only: the width-packed branch convs (``hrnet_wpack_augment``:
lane occupancy on the TPU; the int8 chain quantizes the plain convs) and the
packed stem conv (``conv2d_rgb_s2``, another summation order of the same conv).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..checkpoint.spec import ParamSpec, Spec
from ..ops.conv_int8 import act_stat, link, quant_act_s8, quantized, to_nchw, to_s8_nhwc
from ..ops.norms import conv_bn
from ..ops.resize import resize_bilinear
from ..parallel.halo import (RowSlabs, avg_pool_rows, conv_rows, link_rows,
                             upsample_bilinear_rows, upsample_nearest_rows)
from ..utils.timing import span

_BN_SUFFIXES = ("weight", "bias", "running_mean", "running_var")
STEM_WIDTH = 64     # the stem's two convs
LAYER1_WIDTH = 256  # layer1's bottleneck output (64 inside)


def _conv_bn_spec(spec: Spec, conv_name: str, bn_name: str, cin: int, cout: int, k: int):
    spec[f"{conv_name}.weight"] = ParamSpec((cout, cin, k, k), "conv")
    for s in _BN_SUFFIXES:
        spec[f"{bn_name}.{s}"] = ParamSpec((cout,), "vec")


def _stages(cfg):
    """(branch widths, modules, blocks per branch) of stages 2, 3 and 4."""
    h = cfg.MODEL.HRNET
    return [(list(s.NUM_CHANNELS), s.NUM_MODULES, list(s.NUM_BLOCKS))
            for s in (h.STAGE2, h.STAGE3, h.STAGE4)]


def hrnet_spec(cfg, prefix: str = "backbone.bottom_up") -> Spec:
    """The JAX package's order, so a seed draws the same weights."""
    spec: Spec = {}
    _conv_bn_spec(spec, f"{prefix}.conv1", f"{prefix}.bn1", 3, STEM_WIDTH, 3)
    _conv_bn_spec(spec, f"{prefix}.conv2", f"{prefix}.bn2", STEM_WIDTH, STEM_WIDTH, 3)
    for i in range(4):
        b = f"{prefix}.layer1.{i}"
        _conv_bn_spec(spec, f"{b}.conv1", f"{b}.bn1", STEM_WIDTH if i == 0 else LAYER1_WIDTH,
                      64, 1)
        _conv_bn_spec(spec, f"{b}.conv2", f"{b}.bn2", 64, 64, 3)
        _conv_bn_spec(spec, f"{b}.conv3", f"{b}.bn3", 64, LAYER1_WIDTH, 1)
        if i == 0:
            _conv_bn_spec(spec, f"{b}.downsample.0", f"{b}.downsample.1", STEM_WIDTH,
                          LAYER1_WIDTH, 1)
    prev = [LAYER1_WIDTH]
    for si, (chans, n_modules, n_blocks) in enumerate(_stages(cfg)):
        t = f"{prefix}.transition{si + 1}"
        for b, c in enumerate(chans):
            if b >= len(prev):  # a new branch: a strided conv of the coarsest one
                _conv_bn_spec(spec, f"{t}.{b}.0.0", f"{t}.{b}.0.1", prev[-1], c, 3)
            elif prev[b] != c:
                _conv_bn_spec(spec, f"{t}.{b}.0", f"{t}.{b}.1", prev[b], c, 3)
        for m in range(n_modules):
            mod = f"{prefix}.stage{si + 2}.{m}"
            for b, c in enumerate(chans):
                for blk in range(n_blocks[b]):
                    bb = f"{mod}.branches.{b}.{blk}"
                    _conv_bn_spec(spec, f"{bb}.conv1", f"{bb}.bn1", c, c, 3)
                    _conv_bn_spec(spec, f"{bb}.conv2", f"{bb}.bn2", c, c, 3)
            for i in range(len(chans)):
                for j in range(len(chans)):
                    f = f"{mod}.fuse_layers.{i}.{j}"
                    if j > i:
                        _conv_bn_spec(spec, f"{f}.0", f"{f}.1", chans[j], chans[i], 1)
                    elif j < i:
                        for k in range(i - j):
                            cout = chans[i] if k == i - j - 1 else chans[j]
                            _conv_bn_spec(spec, f"{f}.{k}.0", f"{f}.{k}.1", chans[j], cout, 3)
        prev = chans
    return spec


def hrfpn_spec(cfg, prefix: str = "backbone") -> Spec:
    spec = hrnet_spec(cfg, prefix=f"{prefix}.bottom_up")
    out = cfg.MODEL.HRNET.HRFPN.OUT_CHANNELS
    total = sum(cfg.MODEL.HRNET.STAGE4.NUM_CHANNELS)
    spec[f"{prefix}.reduction_conv.weight"] = ParamSpec((out, total, 1, 1), "conv")
    spec[f"{prefix}.reduction_conv.bias"] = ParamSpec((out,), "vec")
    for i in range(5):
        spec[f"{prefix}.fpn_conv.{i}.weight"] = ParamSpec((out, out, 3, 3), "conv")
        spec[f"{prefix}.fpn_conv.{i}.bias"] = ParamSpec((out,), "vec")
    return spec


def hrfpn_out_strides(cfg) -> Dict[str, int]:
    return {"p1": 4, "p2": 8, "p3": 16, "p4": 32, "p5": 64}


def _branch_blocks(cfg, prefix: str):
    """The BasicBlock names of every branch, in stage / module / branch /
    block order."""
    for si, (chans, n_modules, n_blocks) in enumerate(_stages(cfg)):
        for m in range(n_modules):
            for b in range(len(chans)):
                for blk in range(n_blocks[b]):
                    yield f"{prefix}.stage{si + 2}.{m}.branches.{b}.{blk}"


def hrnet_int8_scale_sites(cfg, prefix: str = "backbone.bottom_up",
                           hrfpn_prefix: str = "backbone") -> List[str]:
    """The activation-scale names in the calibration walk's order (JAX
    ``hrnet_int8_scale_sites``): layer1's conv inputs, every branch
    BasicBlock's conv1 and conv2 inputs, the HRFPN reduction's and p1 conv's."""
    sites = [f"{prefix}.layer1.{i}.conv{k}.in_scale" for i in range(4) for k in (1, 2, 3)]
    for bb in _branch_blocks(cfg, prefix):
        sites += [f"{bb}.conv1.in_scale", f"{bb}.conv2.in_scale"]
    return sites + [f"{hrfpn_prefix}.reduction_conv.in_scale",
                    f"{hrfpn_prefix}.fpn_conv.0.in_scale"]


def hrnet_int8_quant_bases(cfg, prefix: str = "backbone.bottom_up",
                           hrfpn_prefix: str = "backbone") -> List[str]:
    """The convs quantized in int8 mode (JAX ``hrnet_int8_quant_bases`` on
    the plain path, where no width-packed ``.wp`` twin exists)."""
    bases = []
    for i in range(4):
        b = f"{prefix}.layer1.{i}"
        bases += [f"{b}.conv1", f"{b}.conv3", f"{b}.conv2"]
        if i == 0:
            bases.append(f"{b}.downsample.0")
    for bb in _branch_blocks(cfg, prefix):
        bases += [f"{bb}.conv1", f"{bb}.conv2"]
    return bases + [f"{hrfpn_prefix}.reduction_conv", f"{hrfpn_prefix}.fpn_conv.0"]


def _stat(calib, x: torch.Tensor, stat: str, conv: nn.Module) -> None:
    calib.append(act_stat(x, stat, getattr(conv, "in_scale", None)))


def _int8_ok(conv: nn.Module, calib) -> bool:
    return calib is None and getattr(conv, "in_scale", None) is not None and quantized(conv)


def _conv(cin: int, cout: int, k: int, fold: bool, stride: int = 1) -> nn.Conv2d:
    """A conv and its BN (``conv_bn``: folded in, or its ``.norm``), 'same'
    padding for odd k."""
    return conv_bn(cin, cout, k, fold, stride=stride, padding=k // 2)


def _seq(*modules: nn.Module) -> nn.Module:
    """A container whose children are named 0, 1, ... as a Sequential's; it
    is not called, its owner runs the children."""
    return nn.ModuleList(modules)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, downsample: bool, fold: bool):
        super().__init__()
        self.conv1 = _conv(cin, 64, 1, fold)
        self.conv2 = _conv(64, 64, 3, fold)
        self.conv3 = _conv(64, LAYER1_WIDTH, 1, fold)
        self.downsample = _seq(_conv(cin, LAYER1_WIDTH, 1, fold)) if downsample else None

    def forward(self, x: torch.Tensor, calib=None, stat: str = "max") -> torch.Tensor:
        if calib is not None:
            _stat(calib, x, stat, self.conv1)
        out = F.relu(self.conv1(x))
        if calib is not None:
            _stat(calib, out, stat, self.conv2)
        out = F.relu(self.conv2(out))
        if calib is not None:
            _stat(calib, out, stat, self.conv3)
        sc = x if self.downsample is None else self.downsample[0](x)
        return F.relu(self.conv3(out) + sc)

    def forward_int8(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, C, H, W) float -> the block through Q1 (JAX ``_layer1``'s int8
        arm): the shortcut is the downsample's s8 link, or the fp x itself;
        out in x's dtype."""
        s1, s2, s3 = self.conv1.in_scale, self.conv2.in_scale, self.conv3.in_scale
        q = to_s8_nhwc(x, s1)
        q1 = link(self.conv1, q, s1, s2, relu=True)
        q2 = link(self.conv2, q1, s2, s3, relu=True)
        y = link(self.conv3, q2, s3)
        sc = (link(self.downsample[0], q, s1) if self.downsample is not None
              else x.permute(0, 2, 3, 1).float())
        return to_nchw(F.relu(y + sc), x.dtype)

    def forward_rows(self, x: RowSlabs) -> RowSlabs:
        """``forward`` (fp) on row slabs (``parallel/halo.py``)."""
        out = conv_rows(self.conv1, x).map(F.relu)
        out = conv_rows(self.conv2, out).map(F.relu)
        sc = x if self.downsample is None else conv_rows(self.downsample[0], x)
        return conv_rows(self.conv3, out).map(lambda a, b: F.relu(a + b), sc)

    def forward_int8_rows(self, x: RowSlabs) -> RowSlabs:
        """``forward_int8`` on row slabs."""
        s1, s2, s3 = self.conv1.in_scale, self.conv2.in_scale, self.conv3.in_scale
        q = x.map(to_s8_nhwc, s1, row_dim=1)
        q1 = link_rows(self.conv1, q, s1, s2, relu=True)
        q2 = link_rows(self.conv2, q1, s2, s3, relu=True)
        y = link_rows(self.conv3, q2, s3)
        sc = (link_rows(self.downsample[0], q, s1) if self.downsample is not None
              else x.map(lambda t: t.permute(0, 2, 3, 1).float(), row_dim=1))
        return y.map(lambda a, b: F.relu(a + b), sc).map(to_nchw, x.dtype, row_dim=2)


class BasicBlock(nn.Module):
    def __init__(self, c: int, fold: bool):
        super().__init__()
        self.conv1 = _conv(c, c, 3, fold)
        self.conv2 = _conv(c, c, 3, fold)

    def forward(self, x: torch.Tensor, calib=None, stat: str = "max") -> torch.Tensor:
        if calib is not None:
            _stat(calib, x, stat, self.conv1)
        out = F.relu(self.conv1(x))
        if calib is not None:
            _stat(calib, out, stat, self.conv2)
        return F.relu(self.conv2(out) + x)

    def forward_int8(self, q: torch.Tensor, s_in: torch.Tensor) -> torch.Tensor:
        """q (N, H, W, C) s8 at ``s_in`` -> f32 NHWC (JAX ``_basic_block_int8``):
        the residual is q * s_in."""
        q1 = link(self.conv1, q, s_in, self.conv2.in_scale, relu=True)
        y = link(self.conv2, q1, self.conv2.in_scale)
        return F.relu(y + q.float() * s_in)

    def forward_rows(self, x: RowSlabs) -> RowSlabs:
        """``forward`` (fp) on row slabs."""
        out = conv_rows(self.conv1, x).map(F.relu)
        return conv_rows(self.conv2, out).map(lambda a, b: F.relu(a + b), x)

    def forward_int8_rows(self, q: RowSlabs, s_in: torch.Tensor) -> RowSlabs:
        """``forward_int8`` on NHWC s8 row slabs."""
        q1 = link_rows(self.conv1, q, s_in, self.conv2.in_scale, relu=True)
        y = link_rows(self.conv2, q1, self.conv2.in_scale)
        return y.map(lambda a, b, s: F.relu(a + b.float() * s), q, s_in)


def run_branch(branch: nn.Sequential, y: torch.Tensor, calib=None,
               stat: str = "max") -> torch.Tensor:
    """A branch's BasicBlock chain (JAX ``_branch_chain``, plain path): the s8
    chain once calibrated (each block requantizes its f32 input), else fp,
    recording statistics when ``calib`` is given."""
    if not _int8_ok(branch[0].conv1, calib):
        for block in branch:
            y = block(y, calib, stat)
        return y
    dtype = y.dtype
    y = y.permute(0, 2, 3, 1)
    for block in branch:
        s_in = block.conv1.in_scale
        y = block.forward_int8(quant_act_s8(y, s_in).contiguous(), s_in)
    return to_nchw(y, dtype)


def run_branch_rows(branch: nn.Sequential, y: RowSlabs) -> RowSlabs:
    """``run_branch`` (its serving arms) on row slabs."""
    if not _int8_ok(branch[0].conv1, None):
        for block in branch:
            y = block.forward_rows(y)
        return y
    dtype = y.dtype
    y = y.map(lambda t: t.permute(0, 2, 3, 1), row_dim=1)
    for block in branch:
        s_in = block.conv1.in_scale
        y = block.forward_int8_rows(y.map(lambda t, s: quant_act_s8(t, s).contiguous(), s_in),
                                    s_in)
    return y.map(to_nchw, dtype, row_dim=2)


class HRModule(nn.Module):
    """One stage module: a BasicBlock chain per branch, then the full
    cross-resolution fusion (JAX hrnet.py:486-512). Output branch i sums, in
    input order j: branch j itself (j == i); a 1x1 conv then a nearest
    upsample by 2^(j-i) (j > i); a chain of i-j 3x3/2 convs, ReLU on all but
    the last (j < i); then a ReLU."""

    def __init__(self, chans: List[int], n_blocks: List[int], fold: bool):
        super().__init__()
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(c, fold) for _ in range(n)))
            for c, n in zip(chans, n_blocks))
        n = len(chans)
        self.fuse_layers = nn.ModuleList()
        for i in range(n):
            row = nn.ModuleList()
            for j in range(n):
                if j > i:
                    row.append(_seq(_conv(chans[j], chans[i], 1, fold)))
                elif j < i:
                    row.append(_seq(*(
                        _seq(_conv(chans[j], chans[i] if k == i - j - 1 else chans[j], 3, fold,
                                   2))
                        for k in range(i - j))))
                else:
                    row.append(nn.Identity())
            self.fuse_layers.append(row)

    def forward(self, feats: List[torch.Tensor], calib=None,
                stat: str = "max") -> List[torch.Tensor]:
        outs = [run_branch(branch, x, calib, stat) for branch, x in zip(self.branches, feats)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                y = outs[j]
                if j > i:
                    y = F.interpolate(layer[0](y), scale_factor=float(2 ** (j - i)),
                                      mode="nearest")
                elif j < i:
                    for k, step in enumerate(layer):
                        y = step[0](y)
                        if k < len(layer) - 1:
                            y = F.relu(y)
                acc = y if acc is None else acc + y
            fused.append(F.relu(acc))
        return fused

    def forward_rows(self, feats: List[RowSlabs]) -> List[RowSlabs]:
        """``forward`` (its serving arms) on row slabs: the nearest upsample
        row-local, the strided chains with a halo exchange a conv."""
        outs = [run_branch_rows(branch, x) for branch, x in zip(self.branches, feats)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                y = outs[j]
                if j > i:
                    y = upsample_nearest_rows(conv_rows(layer[0], y), 2 ** (j - i))
                elif j < i:
                    for k, step in enumerate(layer):
                        y = conv_rows(step[0], y)
                        if k < len(layer) - 1:
                            y = y.map(F.relu)
                acc = y if acc is None else acc.map(torch.add, y)
            fused.append(acc.map(F.relu))
        return fused


class HRNet(nn.Module):
    """x: (N, 3, H, W) -> the four branch maps at 1/4, 1/8, 1/16, 1/32."""

    def __init__(self, cfg):
        super().__init__()
        fold = bool(cfg.TPU.FOLD_FROZEN_BN)
        self.conv1 = _conv(3, STEM_WIDTH, 3, fold, 2)
        self.conv2 = _conv(STEM_WIDTH, STEM_WIDTH, 3, fold, 2)
        self.layer1 = nn.Sequential(*(Bottleneck(STEM_WIDTH if i == 0 else LAYER1_WIDTH, i == 0,
                                                 fold) for i in range(4)))
        prev = [LAYER1_WIDTH]
        for si, (chans, n_modules, n_blocks) in enumerate(_stages(cfg)):
            transition = nn.ModuleList()
            for b, c in enumerate(chans):
                if b >= len(prev):
                    transition.append(_seq(_seq(_conv(prev[-1], c, 3, fold, 2))))
                elif prev[b] != c:
                    transition.append(_seq(_conv(prev[b], c, 3, fold)))
                else:
                    transition.append(nn.Identity())
            self.add_module(f"transition{si + 1}", transition)
            self.add_module(f"stage{si + 2}", nn.Sequential(
                *(HRModule(chans, n_blocks, fold) for _ in range(n_modules))))
            prev = chans

    def forward(self, x: torch.Tensor, calib=None, stat: str = "max") -> List[torch.Tensor]:
        x = F.relu(self.conv2(F.relu(self.conv1(x))))
        int8 = _int8_ok(self.layer1[0].conv1, calib)
        for block in self.layer1:
            x = block.forward_int8(x) if int8 else block(x, calib, stat)
        feats = [x]
        for s in (2, 3, 4):
            new = []
            for b, t in enumerate(getattr(self, f"transition{s - 1}")):
                if isinstance(t, nn.Identity):
                    new.append(feats[b])
                elif b >= len(feats):  # a new branch, from the coarsest
                    new.append(F.relu(t[0][0](feats[-1])))
                else:
                    new.append(F.relu(t[0](feats[b])))
            feats = new
            for module in getattr(self, f"stage{s}"):
                feats = module(feats, calib, stat)
        return feats

    def forward_rows(self, x: RowSlabs) -> List[RowSlabs]:
        """``forward`` (its serving arms) on row slabs."""
        x = conv_rows(self.conv2, conv_rows(self.conv1, x).map(F.relu)).map(F.relu)
        int8 = _int8_ok(self.layer1[0].conv1, None)
        for block in self.layer1:
            x = block.forward_int8_rows(x) if int8 else block.forward_rows(x)
        feats = [x]
        for s in (2, 3, 4):
            new = []
            for b, t in enumerate(getattr(self, f"transition{s - 1}")):
                if isinstance(t, nn.Identity):
                    new.append(feats[b])
                elif b >= len(feats):
                    new.append(conv_rows(t[0][0], feats[-1]).map(F.relu))
                else:
                    new.append(conv_rows(t[0], feats[b]).map(F.relu))
            feats = new
            for module in getattr(self, f"stage{s}"):
                feats = module.forward_rows(feats)
        return feats


class HRFPN(nn.Module):
    """x: (N, 3, H, W), H and W multiples of 64 -> {"p1": ..., "p5": ...} NCHW
    at strides 4..64 (JAX hrnet.py:536-585, its floating-point arm): branches
    1..3 bilinearly upsampled by 2^i to 1/4 (torch's scale-factor rule),
    concatenated, a 1x1 reduction, then per level i an average pool of 2^i
    (no padding) and a 3x3 conv."""

    def __init__(self, cfg):
        super().__init__()
        out = cfg.MODEL.HRNET.HRFPN.OUT_CHANNELS
        self.bottom_up = HRNet(cfg)
        self.reduction_conv = nn.Conv2d(sum(cfg.MODEL.HRNET.STAGE4.NUM_CHANNELS), out, 1)
        self.fpn_conv = nn.ModuleList(nn.Conv2d(out, out, 3, padding=1) for _ in range(5))

    def forward(self, x: torch.Tensor, calib=None, stat: str = "max") -> Dict[str, torch.Tensor]:
        """In int8 mode the two full-resolution convs (the 1x1 reduction and
        p1's 3x3) run through Q1 to the compute dtype; the pooled levels stay
        fp. ``calib``: the fp walk, appending statistics. The body runs in
        the span ``hrnet``, the neck in ``hrfpn``."""
        with span("hrnet"):
            feats = self.bottom_up(x, calib, stat)
        with span("hrfpn"):
            return self._neck(feats, calib, stat)

    def _neck(self, feats: List[torch.Tensor], calib, stat: str) -> Dict[str, torch.Tensor]:
        """HRFPN on the four branches: the upsamples, the concat, the
        reduction, the pyramid and the level convs."""
        hw = tuple(feats[0].shape[-2:])
        ups = [feats[0]] + [resize_bilinear(f, hw, scale=(float(2 ** i), float(2 ** i)))
                            for i, f in enumerate(feats[1:], 1)]
        cat = torch.cat(ups, dim=1)
        if calib is not None:
            _stat(calib, cat, stat, self.reduction_conv)
        int8 = _int8_ok(self.reduction_conv, calib)
        dtype = cat.dtype
        if int8:
            s_cat = self.reduction_conv.in_scale
            red = to_nchw(link(self.reduction_conv, to_s8_nhwc(cat, s_cat), s_cat,
                               out_dtype=dtype), dtype)
        else:
            red = self.reduction_conv(cat)
        if calib is not None:
            _stat(calib, red, stat, self.fpn_conv[0])
        outs = {}
        for i, conv in enumerate(self.fpn_conv):
            if i == 0 and int8 and quantized(conv):
                s_red = conv.in_scale
                outs["p1"] = to_nchw(link(conv, to_s8_nhwc(red, s_red), s_red, out_dtype=dtype),
                                     dtype)
            else:
                outs[f"p{i + 1}"] = conv(red if i == 0 else F.avg_pool2d(red, 2 ** i))
        return outs

    def forward_rows(self, x: RowSlabs) -> Dict[str, RowSlabs]:
        """``forward`` (its serving arms) on row slabs (``parallel/halo.py``):
        the bilinear upsamples from the source rows they read, the pools and
        3x3 convs with a halo exchange."""
        feats = self.bottom_up.forward_rows(x)
        ups = [feats[0]] + [upsample_bilinear_rows(f, 2 ** i) for i, f in enumerate(feats[1:], 1)]
        cat = ups[0].map(lambda *xs: torch.cat(xs, dim=1), *ups[1:])
        int8 = _int8_ok(self.reduction_conv, None)
        dtype = cat.dtype
        if int8:
            s_cat = self.reduction_conv.in_scale
            red = link_rows(self.reduction_conv, cat.map(to_s8_nhwc, s_cat, row_dim=1), s_cat,
                            out_dtype=dtype).map(to_nchw, dtype, row_dim=2)
        else:
            red = conv_rows(self.reduction_conv, cat)
        outs = {}
        for i, conv in enumerate(self.fpn_conv):
            if i == 0 and int8 and quantized(conv):
                s_red = conv.in_scale
                outs["p1"] = link_rows(conv, red.map(to_s8_nhwc, s_red, row_dim=1), s_red,
                                       out_dtype=dtype).map(to_nchw, dtype, row_dim=2)
            else:
                outs[f"p{i + 1}"] = conv_rows(conv, red if i == 0 else avg_pool_rows(red, 2 ** i))
        return outs

    def int8_calibration(self, x: torch.Tensor, stat: str = "max") -> torch.Tensor:
        """The fp walk's statistics in ``hrnet_int8_scale_sites`` order (JAX
        ``hrnet_int8_calibration``); x is the preprocessed input."""
        calib: List[torch.Tensor] = []
        self.forward(x, calib, stat)
        return torch.stack(calib)
