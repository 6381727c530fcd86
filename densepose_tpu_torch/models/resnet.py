"""ResNet bottom-up (port of densepose_tpu/models/resnet.py), NCHW.

BasicStem (resnet.py:325-354), BasicBlock (:27-92, R18/R34: two 3x3 convs,
widths fixed at 64/128/256/512 as in the JAX package) and BottleneckBlock
(:95-205, R50/101/152) with ``stride_in_1x1`` and res5 dilation. FrozenBN is
folded into the convs at load time (checkpoint/transform.py), so every conv
carries a bias and the blocks are conv -> ReLU chains on cuDNN. Module names
mirror the reference state_dict (``stem.conv1``, ``res2.0.conv1``, ...).
The module holds all four stages, as the JAX spec does, and runs the stages
up to the last of ``RESNETS.OUT_FEATURES``: the C4 backbone
(``build_resnet_backbone``, res4 out) holds an unused res5.

int8 serving (``TPU.INT8_BACKBONE``, JAX resnet.py:169-275): once calibrated
scales and quantized weights are installed, res2..res5 run as an s8 chain
through kernel Q1 (``ops/conv_int8.py``): conv1 and conv2 stay in the integer
domain, conv3 and the shortcut dequantize to f32 for the residual add (an
identity shortcut adds the dequantized s8 input, q * s_in, as the JAX
package does), the ReLU runs in f32 and the next block requantizes; the stem
stays fp. The port always folds FrozenBN, so the JAX package's refusal of
unfolded BN never applies. ``resnet_int8_scale_sites`` and
``ResNet.int8_calibration`` are the site list and the fp walk that records
its statistics, in the same order, over all four stages as the JAX walk goes
(the C4 backbone's res5 sites feed nothing). BasicBlock ResNets keep the fp
path under ``INT8_BACKBONE`` (JAX ``int8_backbone_active``).

Each ``forward_rows`` / ``forward_int8_rows`` is the forward above it on
row slabs of the frame (``parallel/halo.py``: a halo exchange before every
convolution and pool that reads a neighbour's rows), for
``spatial_parallel_forward``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..checkpoint.spec import Spec, conv_spec
from ..ops.conv_int8 import act_stat, link, quant_act_s8, quantized, to_nchw, to_s8_nhwc
from ..parallel.halo import RowSlabs, conv_rows, link_rows, max_pool_rows

NUM_BLOCKS_PER_STAGE = {
    18: [2, 2, 2, 2],
    34: [3, 4, 6, 3],
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
}


def _stage_channels(cfg) -> List[Tuple[int, int, int]]:
    """[(in, bottleneck, out)] per stage (build_resnet_backbone,
    resnet.py:602-689); BasicBlock ResNets (depth < 50) have no bottleneck
    and the widths 64, 128, 256, 512 whatever RES2_OUT_CHANNELS says (JAX
    resnet.py:58-60)."""
    if cfg.MODEL.RESNETS.DEPTH < 50:
        return [(64, 0, 64), (64, 0, 128), (128, 0, 256), (256, 0, 512)]
    bottleneck = cfg.MODEL.RESNETS.NUM_GROUPS * cfg.MODEL.RESNETS.WIDTH_PER_GROUP
    in_ch = cfg.MODEL.RESNETS.STEM_OUT_CHANNELS
    out_ch = cfg.MODEL.RESNETS.RES2_OUT_CHANNELS
    chans = []
    for _ in range(4):
        chans.append((in_ch, bottleneck, out_ch))
        in_ch = out_ch
        out_ch *= 2
        bottleneck *= 2
    return chans


def _check_supported(cfg) -> None:
    if cfg.MODEL.RESNETS.NORM != "FrozenBN":
        raise NotImplementedError(f"norm {cfg.MODEL.RESNETS.NORM!r}: the port folds "
                                  "FrozenBN only")
    if cfg.MODEL.RESNETS.NUM_GROUPS != 1:
        raise NotImplementedError("RESNETS.NUM_GROUPS != 1: the JAX package widens the "
                                  "bottleneck but groups no conv (resnet.py:47-49, 112-123); "
                                  "the port refuses it rather than copy that")
    if any(cfg.MODEL.RESNETS.DEFORM_ON_PER_STAGE):
        raise NotImplementedError("deformable conv blocks are nonfunctional in the "
                                  "reference (resnet.py:255-259)")


def _iter_blocks(cfg, prefix: str, num_stages: int = 4):
    """(stage, block name, stride, dilation, has shortcut, next block name or
    None, last of its stage) in forward order (JAX resnet.py::_iter_blocks)."""
    r = cfg.MODEL.RESNETS
    blocks = NUM_BLOCKS_PER_STAGE[r.DEPTH]
    names = []
    for stage_idx, (cin, _, cout) in enumerate(_stage_channels(cfg)[:num_stages]):
        stage = f"res{stage_idx + 2}"
        dilation = r.RES5_DILATION if stage_idx == 3 else 1
        first_stride = 1 if stage_idx == 0 or (stage_idx == 3 and dilation == 2) else 2
        for i in range(blocks[stage_idx]):
            names.append((stage, f"{prefix}.{stage}.{i}", first_stride if i == 0 else 1,
                          dilation, (cin if i == 0 else cout) != cout,
                          i == blocks[stage_idx] - 1))
    for j, (stage, name, stride, dil, sc, last) in enumerate(names):
        yield stage, name, stride, dil, sc, names[j + 1][1] if j + 1 < len(names) else None, last


def resnet_int8_scale_sites(cfg, prefix: str = "backbone.bottom_up"):
    """The activation-scale names of the int8 backbone, in the order of
    ``ResNet.int8_calibration``'s statistics (JAX
    ``resnet_int8_scale_sites``): res2.0's conv1 input, then per block its
    conv2 and conv3 inputs and the next block's conv1 input."""
    sites = [f"{prefix}.res2.0.conv1.in_scale"]
    for _, name, _, _, _, nxt, _ in _iter_blocks(cfg, prefix):
        sites += [f"{name}.conv2.in_scale", f"{name}.conv3.in_scale"]
        if nxt is not None:
            sites.append(f"{nxt}.conv1.in_scale")
    return sites


def resnet_spec(cfg, prefix: str = "backbone.bottom_up") -> Spec:
    """Reference-layout parameter spec, in the JAX package's order."""
    _check_supported(cfg)
    norm = cfg.MODEL.RESNETS.NORM
    spec: Spec = {}
    conv_spec(spec, f"{prefix}.stem.conv1", 3, cfg.MODEL.RESNETS.STEM_OUT_CHANNELS,
              7, bias=False, norm=norm)
    blocks = NUM_BLOCKS_PER_STAGE[cfg.MODEL.RESNETS.DEPTH]
    for stage_idx, ((cin, cb, cout), n) in enumerate(zip(_stage_channels(cfg), blocks)):
        name = f"{prefix}.res{stage_idx + 2}"
        for i in range(n):
            b_in = cin if i == 0 else cout
            if cfg.MODEL.RESNETS.DEPTH >= 50:
                conv_spec(spec, f"{name}.{i}.conv1", b_in, cb, 1, bias=False, norm=norm)
                conv_spec(spec, f"{name}.{i}.conv2", cb, cb, 3, bias=False, norm=norm)
                conv_spec(spec, f"{name}.{i}.conv3", cb, cout, 1, bias=False, norm=norm)
            else:
                conv_spec(spec, f"{name}.{i}.conv1", b_in, cout, 3, bias=False, norm=norm)
                conv_spec(spec, f"{name}.{i}.conv2", cout, cout, 3, bias=False, norm=norm)
            if b_in != cout:
                conv_spec(spec, f"{name}.{i}.shortcut", b_in, cout, 1, bias=False,
                          norm=norm)
    return spec


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, cb: int, cout: int, stride: int, stride_in_1x1: bool,
                 dilation: int):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = nn.Conv2d(cin, cb, 1, stride=s1)
        self.conv2 = nn.Conv2d(cb, cb, 3, stride=s3, padding=dilation, dilation=dilation)
        self.conv3 = nn.Conv2d(cb, cout, 1)
        self.shortcut = nn.Conv2d(cin, cout, 1, stride=stride) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        shortcut = self.shortcut(x) if self.shortcut is not None else x
        return F.relu(out + shortcut)

    def forward_int8(self, q: torch.Tensor, s_in: torch.Tensor) -> torch.Tensor:
        """q (N, H, W, Cin) s8 at ``s_in`` -> the block's f32 NHWC output
        (JAX ``_bottleneck_int8``)."""
        q1 = link(self.conv1, q, s_in, self.conv2.in_scale, relu=True)
        q2 = link(self.conv2, q1, self.conv2.in_scale, self.conv3.in_scale, relu=True)
        y = link(self.conv3, q2, self.conv3.in_scale)
        sc = link(self.shortcut, q, s_in) if self.shortcut is not None else q.float() * s_in
        return F.relu(y + sc)

    def forward_rows(self, x: RowSlabs) -> RowSlabs:
        """``forward`` on row slabs (``parallel/halo.py``)."""
        out = conv_rows(self.conv1, x).map(F.relu)
        out = conv_rows(self.conv2, out).map(F.relu)
        out = conv_rows(self.conv3, out)
        shortcut = conv_rows(self.shortcut, x) if self.shortcut is not None else x
        return out.map(lambda a, b: F.relu(a + b), shortcut)

    def forward_int8_rows(self, q: RowSlabs, s_in: torch.Tensor) -> RowSlabs:
        """``forward_int8`` on NHWC s8 row slabs."""
        q1 = link_rows(self.conv1, q, s_in, self.conv2.in_scale, relu=True)
        q2 = link_rows(self.conv2, q1, self.conv2.in_scale, self.conv3.in_scale, relu=True)
        y = link_rows(self.conv3, q2, self.conv3.in_scale)
        sc = link_rows(self.shortcut, q, s_in) if self.shortcut is not None else \
            q.map(lambda t, s: t.float() * s, s_in)
        return y.map(lambda a, b: F.relu(a + b), sc)


class BasicBlock(nn.Module):
    """Two 3x3 convs, the first with the stride, and a 1x1 shortcut where
    the width changes (JAX ``_basic_block``)."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.shortcut = nn.Conv2d(cin, cout, 1, stride=stride) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(F.relu(self.conv1(x)))
        shortcut = self.shortcut(x) if self.shortcut is not None else x
        return F.relu(out + shortcut)

    def forward_rows(self, x: RowSlabs) -> RowSlabs:
        """``forward`` on row slabs (``parallel/halo.py``)."""
        out = conv_rows(self.conv2, conv_rows(self.conv1, x).map(F.relu))
        shortcut = conv_rows(self.shortcut, x) if self.shortcut is not None else x
        return out.map(lambda a, b: F.relu(a + b), shortcut)


class BasicStem(nn.Module):
    def __init__(self, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, cout, 7, stride=2, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(F.relu(self.conv1(x)), kernel_size=3, stride=2, padding=1)

    def forward_rows(self, x: RowSlabs) -> RowSlabs:
        """``forward`` on row slabs: the pool's rows past the edges are -inf."""
        return max_pool_rows(conv_rows(self.conv1, x).map(F.relu), 3, 2, 1)


class ResNet(nn.Module):
    """x: (N, 3, H, W) normalized input -> {"res2": ..., "res5": ...} NCHW."""

    def __init__(self, cfg):
        super().__init__()
        _check_supported(cfg)
        r = cfg.MODEL.RESNETS
        self.int8 = bool(cfg.TPU.INT8_BACKBONE) and r.DEPTH >= 50
        self.out_features = tuple(r.OUT_FEATURES)
        self.stem = BasicStem(r.STEM_OUT_CHANNELS)
        blocks = NUM_BLOCKS_PER_STAGE[r.DEPTH]
        self.all_stages = []
        for stage_idx, (cin, cb, cout) in enumerate(_stage_channels(cfg)):
            dilation = r.RES5_DILATION if stage_idx == 3 else 1
            first_stride = 1 if stage_idx == 0 or (stage_idx == 3 and dilation == 2) else 2
            stage = nn.Sequential(*[
                BottleneckBlock(cin if i == 0 else cout, cb, cout,
                                first_stride if i == 0 else 1, r.STRIDE_IN_1X1, dilation)
                if r.DEPTH >= 50 else
                BasicBlock(cin if i == 0 else cout, cout, first_stride if i == 0 else 1)
                for i in range(blocks[stage_idx])])
            name = f"res{stage_idx + 2}"
            self.add_module(name, stage)
            self.all_stages.append(name)
        # the stages a forward runs: up to the last of out_features
        self.stage_names = self.all_stages[:max(
            {"res2": 1, "res3": 2, "res4": 3, "res5": 4}[f] for f in self.out_features)]

    def blocks(self, stages: Optional[List[str]] = None) -> List[Tuple[str, nn.Module]]:
        """(stage, block) of ``stages``, by default those a forward runs."""
        return [(name, b) for name in (stages or self.stage_names) for b in getattr(self, name)]

    def int8_active(self) -> bool:
        """``TPU.INT8_BACKBONE`` on a bottleneck ResNet with the calibration
        installed (JAX ``int8_backbone_active``)."""
        return self.int8 and quantized(self.res2[0].conv1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        if self.int8_active():
            return self._int8_stages(x)
        outputs = {}
        for name in self.stage_names:
            x = getattr(self, name)(x)
            if name in self.out_features:
                outputs[name] = x
        return outputs

    def _int8_stages(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """res2..resN as the s8 chain from the fp stem's output (JAX
        ``_resnet_int8_stages``); stage outputs in x's dtype, NCHW."""
        blocks = self.blocks()
        outputs = {}
        s_in = blocks[0][1].conv1.in_scale
        q = to_s8_nhwc(x, s_in)
        for j, (stage, block) in enumerate(blocks):
            y = block.forward_int8(q, s_in)
            nxt = blocks[j + 1] if j + 1 < len(blocks) else None
            if (nxt is None or nxt[0] != stage) and stage in self.out_features:
                outputs[stage] = to_nchw(y, x.dtype)
            if nxt is not None:
                s_in = nxt[1].conv1.in_scale
                q = quant_act_s8(y, s_in)
        return outputs

    def forward_rows(self, x: RowSlabs) -> Dict[str, RowSlabs]:
        """``forward`` on row slabs (``parallel/halo.py``)."""
        x = self.stem.forward_rows(x)
        if self.int8_active():
            return self._int8_stages_rows(x)
        outputs = {}
        for name in self.stage_names:
            for block in getattr(self, name):
                x = block.forward_rows(x)
            if name in self.out_features:
                outputs[name] = x
        return outputs

    def _int8_stages_rows(self, x: RowSlabs) -> Dict[str, RowSlabs]:
        """``_int8_stages`` on row slabs: the s8 chain's slabs NHWC."""
        blocks = self.blocks()
        outputs = {}
        dtype = x.dtype
        s_in = blocks[0][1].conv1.in_scale
        q = x.map(to_s8_nhwc, s_in, row_dim=1)
        for j, (stage, block) in enumerate(blocks):
            y = block.forward_int8_rows(q, s_in)
            nxt = blocks[j + 1] if j + 1 < len(blocks) else None
            if (nxt is None or nxt[0] != stage) and stage in self.out_features:
                outputs[stage] = y.map(to_nchw, dtype, row_dim=2)
            if nxt is not None:
                s_in = nxt[1].conv1.in_scale
                q = y.map(quant_act_s8, s_in)
        return outputs

    def int8_calibration(self, x: torch.Tensor, stat: str = "max") -> torch.Tensor:
        """The fp walk recording each site's statistic in
        ``resnet_int8_scale_sites`` order (JAX ``resnet_int8_calibration``),
        through all four stages: x is the preprocessed input."""
        blocks = [b for _, b in self.blocks(self.all_stages)]
        x = self.stem(x)
        stats = [act_stat(x, stat, getattr(blocks[0].conv1, "in_scale", None))]
        for j, b in enumerate(blocks):
            y1 = F.relu(b.conv1(x))
            stats.append(act_stat(y1, stat, getattr(b.conv2, "in_scale", None)))
            y2 = F.relu(b.conv2(y1))
            stats.append(act_stat(y2, stat, getattr(b.conv3, "in_scale", None)))
            x = F.relu(b.conv3(y2) + (b.shortcut(x) if b.shortcut is not None else x))
            if j + 1 < len(blocks):
                stats.append(act_stat(x, stat, getattr(blocks[j + 1].conv1, "in_scale", None)))
        return torch.stack(stats)
