"""detectron2's ResNet-FPN backbone (``build_resnet_fpn_backbone``), a part
of the reference (``benchmark/parts.py`` says what a backbone part gives).

ResNet-50/101 bottlenecks, one group, no dilation, the stride in the 1x1
conv (detectron2's MSRA style), FrozenBatchNorm folded into every conv as a
bias; the FPN fuses by sum with a nearest 2x top-down path and adds p6, p5
subsampled by 2. A level ``p<n>`` lies at stride 2^n: the stem's conv and
max-pool take the input to stride 4 (res2) and each later stage halves it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.counts.model import conv_flops
from benchmark.counts.shapes import level_hw
from benchmark.reference.ops import conv

_STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
BU = "backbone.bottom_up"


def resnet_blocks(cfg) -> List[Tuple[str, int, int, int, int]]:
    """(name, in channels, bottleneck channels, out channels, stride) of
    every bottleneck block, res2 first."""
    depth = cfg["MODEL.RESNETS.DEPTH"]
    if depth not in _STAGE_BLOCKS or cfg["MODEL.RESNETS.NUM_GROUPS"] != 1 \
            or cfg["MODEL.RESNETS.RES5_DILATION"] != 1:
        raise ValueError("the reference holds ResNet-50/101 bottlenecks, one group, no dilation")
    blocks = []
    cin = cfg["MODEL.RESNETS.STEM_OUT_CHANNELS"]
    cb = cfg["MODEL.RESNETS.WIDTH_PER_GROUP"]
    cout = cfg["MODEL.RESNETS.RES2_OUT_CHANNELS"]
    for s, n in enumerate(_STAGE_BLOCKS[depth]):
        for i in range(n):
            stride = 2 if (i == 0 and s > 0) else 1
            blocks.append((f"res{s + 2}.{i}", cin, cb, cout, stride))
            cin = cout
        cb *= 2
        cout *= 2
    return blocks


def _stage_widths(cfg) -> Dict[str, int]:
    return {f"res{s + 2}": cfg["MODEL.RESNETS.RES2_OUT_CHANNELS"] * 2 ** s for s in range(4)}


def _top(cfg) -> int:
    return max(int(f[3:]) for f in cfg["MODEL.FPN.IN_FEATURES"])


def strides(cfg) -> Dict[str, int]:
    """p<n> for each FPN input res<n>, and p<top + 1>: at stride 2^n."""
    levels = [int(f[3:]) for f in cfg["MODEL.FPN.IN_FEATURES"]] + [_top(cfg) + 1]
    return {f"p{n}": 2 ** n for n in levels}


def out_channels(cfg) -> int:
    return cfg["MODEL.FPN.OUT_CHANNELS"]


def size_divisibility(cfg) -> int:
    """The FPN's largest input stride (detectron2's FPN.size_divisibility)."""
    return 2 ** _top(cfg)


def shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Every weight, by detectron2 module name, with its shape: convs OIHW
    with a bias (FrozenBN folded)."""
    out: Dict[str, Tuple[int, ...]] = {}

    def add(name, cin, cout, k):
        out[f"{name}.weight"] = (cout, cin, k, k)
        out[f"{name}.bias"] = (cout,)

    add(f"{BU}.stem.conv1", 3, cfg["MODEL.RESNETS.STEM_OUT_CHANNELS"], 7)
    for name, cin, cb, cout, _ in resnet_blocks(cfg):
        add(f"{BU}.{name}.conv1", cin, cb, 1)
        add(f"{BU}.{name}.conv2", cb, cb, 3)
        add(f"{BU}.{name}.conv3", cb, cout, 1)
        if cin != cout:
            add(f"{BU}.{name}.shortcut", cin, cout, 1)
    c = out_channels(cfg)
    widths = _stage_widths(cfg)
    for f in cfg["MODEL.FPN.IN_FEATURES"]:
        add(f"backbone.fpn_lateral{f[3:]}", widths[f], c, 1)
        add(f"backbone.fpn_output{f[3:]}", c, c, 3)
    return out


def forward(cfg, w: Dict[str, torch.Tensor], x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{p2 .. p6} of the padded input x (1, 3, Hp, Wp)."""
    if not cfg["MODEL.RESNETS.STRIDE_IN_1X1"]:
        raise ValueError("the reference holds the stride in the 1x1 conv")
    x = conv(x, w, f"{BU}.stem.conv1", stride=2, relu=True)
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
    stages = {}
    for name, cin, _, cout, stride in resnet_blocks(cfg):
        b = f"{BU}.{name}"
        y = conv(x, w, f"{b}.conv1", stride=stride, relu=True)
        y = conv(y, w, f"{b}.conv2", relu=True)
        y = conv(y, w, f"{b}.conv3")
        short = conv(x, w, f"{b}.shortcut", stride=stride) if cin != cout else x
        x = F.relu(y + short)
        stages[name.split(".")[0]] = x
    out, prev = {}, None
    for f in reversed(cfg["MODEL.FPN.IN_FEATURES"]):
        lateral = conv(stages[f], w, f"backbone.fpn_lateral{f[3:]}")
        if prev is not None:
            lateral = lateral + F.interpolate(prev, scale_factor=2.0, mode="nearest")
        prev = lateral
        out[f"p{f[3:]}"] = conv(lateral, w, f"backbone.fpn_output{f[3:]}")
    top = _top(cfg)
    out[f"p{top + 1}"] = F.max_pool2d(out[f"p{top}"], kernel_size=1, stride=2)
    return out


def flops(cfg, hw: Tuple[int, int]) -> float:
    """Every conv of the stem, the bottlenecks and the FPN (laterals and
    outputs) on an (Hp, Wp) canvas."""
    total = conv_flops(3, cfg["MODEL.RESNETS.STEM_OUT_CHANNELS"], 7, level_hw(hw, 2))
    at = 4
    for _, cin, cb, cout, stride in resnet_blocks(cfg):
        at *= stride
        out_hw = level_hw(hw, at)
        total += conv_flops(cin, cb, 1, out_hw)       # conv1 (stride in the 1x1)
        total += conv_flops(cb, cb, 3, out_hw)
        total += conv_flops(cb, cout, 1, out_hw)
        if cin != cout:
            total += conv_flops(cin, cout, 1, out_hw)
    c = out_channels(cfg)
    widths, level_strides = _stage_widths(cfg), strides(cfg)
    for f in cfg["MODEL.FPN.IN_FEATURES"]:
        lhw = level_hw(hw, level_strides[f"p{f[3:]}"])
        total += conv_flops(widths[f], c, 1, lhw)
        total += conv_flops(c, c, 3, lhw)
    return total
