"""DensePose's HRNet + HRFPN backbone (``build_hrfpn_backbone``), a part of
the reference (``benchmark/parts.py`` says what a backbone part gives).

HRNetV2p (Sun et al., "High-Resolution Representations for Labeling Pixels
and Regions", 2019) as detectron2's DensePose project configures it, with
every BatchNorm folded into its conv as a bias:

* the stem: two 3x3/2 convs of ``STEM_INPLANES`` channels, each with a
  ReLU, to stride 4;
* ``layer1``: 4 Bottlenecks (1x1, 3x3, 1x1; 64 inside, 256 out), the first
  with a 1x1 projection shortcut;
* stages 2, 3 and 4 with 2, 3 and 4 branches at strides 4, 8, 16 and 32 and
  ``STAGEk.NUM_CHANNELS`` channels. Before each stage a transition: a branch
  whose width changes takes a 3x3 conv and a ReLU, a new branch a 3x3/2 conv
  and a ReLU of the coarsest branch before it. A stage is
  ``STAGEk.NUM_MODULES`` modules; a module runs ``NUM_BLOCKS`` BasicBlocks
  (two 3x3 convs, the identity added before the second ReLU) on each branch,
  then fuses: output branch i is the ReLU of the sum, in input order j, of
  branch j itself (j = i), a 1x1 conv and a nearest upsample by 2^(j - i)
  (j > i), or a chain of i - j 3x3/2 convs with a ReLU after all but the
  last (j < i). Every module keeps every branch (HRNetV2);
* HRFPN: branches 2, 3 and 4 bilinearly upsampled (``align_corners``
  False) by 2, 4 and 8 to stride 4, the four concatenated, a 1x1 reduction
  to ``HRFPN.OUT_CHANNELS``, level i (0 to 4) the reduction average-pooled
  by 2^i (no padding) and a 3x3 conv: p1 .. p5 at strides 4 .. 64. The
  input is padded to a multiple of 64.

Departures from that description: none in the arithmetic. The weights are
named as the served model's folded module state dict, which is upstream
HRNet's (``conv1``, ``layer1.<i>.downsample.0``, ``transition<k>``,
``stage<k>.<m>.branches`` / ``fuse_layers``) and, for the neck,
``reduction_conv`` where DensePose's HRFPN holds the 1x1 conv in a
Sequential (``reduction_conv.0``). The average pool sums in float32 here as
everywhere in the reference. Only the BASIC block and the SUM fusion are
held; other values of those keys raise.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.counts.model import conv_flops
from benchmark.counts.shapes import level_hw
from benchmark.reference.ops import conv

BU = "backbone.bottom_up"
H = "MODEL.HRNET."
BOTTLENECK = 64          # layer1's inner width
LAYER1_OUT = 256         # layer1's output width (expansion 4)
LEVELS = 5               # p1 .. p5
BRANCH_STRIDES = (4, 8, 16, 32)


def _stages(cfg) -> List[Tuple[List[int], int, List[int]]]:
    """(branch widths, modules, BasicBlocks a branch) of stages 2, 3, 4."""
    out = []
    for s in (2, 3, 4):
        k = f"{H}STAGE{s}."
        chans, blocks = list(cfg[k + "NUM_CHANNELS"]), list(cfg[k + "NUM_BLOCKS"])
        if (cfg[k + "BLOCK"] != "BASIC" or cfg[k + "FUSE_METHOD"] != "SUM"
                or cfg[k + "NUM_BRANCHES"] != len(chans) or len(blocks) != len(chans)
                or len(chans) != s):
            raise ValueError(f"the reference holds HRNet's stage {s} with {s} branches of "
                             "BasicBlocks fused by sum")
        out.append((chans, cfg[k + "NUM_MODULES"], blocks))
    return out


def _transition(prev: List[int], chans: List[int]):
    """(branch, source branch, cin, cout, stride, name suffix) of each conv
    of a transition: a changed width at stride 1, a new branch at stride 2
    from the coarsest branch before it."""
    out = []
    for b, c in enumerate(chans):
        if b >= len(prev):
            out.append((b, len(prev) - 1, prev[-1], c, 2, f"{b}.0.0"))
        elif prev[b] != c:
            out.append((b, b, prev[b], c, 1, f"{b}.0"))
    return out


def _fuse_chain(chans: List[int], i: int, j: int) -> List[Tuple[int, int]]:
    """(cin, cout) of each 3x3/2 conv taking branch j < i down to branch i."""
    return [(chans[j], chans[i] if k == i - j - 1 else chans[j]) for k in range(i - j)]


def strides(cfg) -> Dict[str, int]:
    return {f"p{i + 1}": 4 * 2 ** i for i in range(LEVELS)}


def out_channels(cfg) -> int:
    return cfg[H + "HRFPN.OUT_CHANNELS"]


def size_divisibility(cfg) -> int:
    """The coarsest level's stride: HRFPN's p5 pools the stride-4 map by 16."""
    return max(strides(cfg).values())


def shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Every weight, by the served model's module name, with its shape:
    convs OIHW with a bias (BatchNorm folded)."""
    out: Dict[str, Tuple[int, ...]] = {}

    def add(name, cin, cout, k):
        out[f"{name}.weight"] = (cout, cin, k, k)
        out[f"{name}.bias"] = (cout,)

    stem = cfg[H + "STEM_INPLANES"]
    add(f"{BU}.conv1", 3, stem, 3)
    add(f"{BU}.conv2", stem, stem, 3)
    for i in range(4):
        b = f"{BU}.layer1.{i}"
        cin = stem if i == 0 else LAYER1_OUT
        add(f"{b}.conv1", cin, BOTTLENECK, 1)
        add(f"{b}.conv2", BOTTLENECK, BOTTLENECK, 3)
        add(f"{b}.conv3", BOTTLENECK, LAYER1_OUT, 1)
        if i == 0:
            add(f"{b}.downsample.0", cin, LAYER1_OUT, 1)
    prev = [LAYER1_OUT]
    for s, (chans, modules, blocks) in enumerate(_stages(cfg), 2):
        for _, _, cin, cout, _, suffix in _transition(prev, chans):
            add(f"{BU}.transition{s - 1}.{suffix}", cin, cout, 3)
        for m in range(modules):
            mod = f"{BU}.stage{s}.{m}"
            for b, c in enumerate(chans):
                for k in range(blocks[b]):
                    add(f"{mod}.branches.{b}.{k}.conv1", c, c, 3)
                    add(f"{mod}.branches.{b}.{k}.conv2", c, c, 3)
            for i in range(len(chans)):
                for j in range(len(chans)):
                    if j > i:
                        add(f"{mod}.fuse_layers.{i}.{j}.0", chans[j], chans[i], 1)
                    for k, (cin, cout) in enumerate(_fuse_chain(chans, i, j)):
                        add(f"{mod}.fuse_layers.{i}.{j}.{k}.0", cin, cout, 3)
        prev = chans
    c = out_channels(cfg)
    add("backbone.reduction_conv", sum(prev), c, 1)
    for i in range(LEVELS):
        add(f"backbone.fpn_conv.{i}", c, c, 3)
    return out


def _module(w, mod: str, chans: List[int], blocks: List[int],
            xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """One stage module: each branch's BasicBlocks, then the fusion."""
    ys = []
    for b, x in enumerate(xs):
        for k in range(blocks[b]):
            name = f"{mod}.branches.{b}.{k}"
            y = conv(x, w, f"{name}.conv1", relu=True)
            x = F.relu(conv(y, w, f"{name}.conv2") + x)
        ys.append(x)
    fused = []
    for i in range(len(chans)):
        acc = None
        for j, y in enumerate(ys):
            if j > i:
                y = F.interpolate(conv(y, w, f"{mod}.fuse_layers.{i}.{j}.0"),
                                  scale_factor=float(2 ** (j - i)), mode="nearest")
            elif j < i:
                steps = len(_fuse_chain(chans, i, j))
                for k in range(steps):
                    y = conv(y, w, f"{mod}.fuse_layers.{i}.{j}.{k}.0", stride=2,
                             relu=k < steps - 1)
            acc = y if acc is None else acc + y
        fused.append(F.relu(acc))
    return fused


def _body(cfg, w: Dict[str, torch.Tensor], x: torch.Tensor) -> List[torch.Tensor]:
    """HRNet's four branches, at strides 4 .. 32, of the padded input x."""
    x = conv(x, w, f"{BU}.conv1", stride=2, relu=True)
    x = conv(x, w, f"{BU}.conv2", stride=2, relu=True)
    for i in range(4):
        b = f"{BU}.layer1.{i}"
        y = conv(x, w, f"{b}.conv1", relu=True)
        y = conv(y, w, f"{b}.conv2", relu=True)
        short = conv(x, w, f"{b}.downsample.0") if i == 0 else x
        x = F.relu(conv(y, w, f"{b}.conv3") + short)
    xs, prev = [x], [LAYER1_OUT]
    for s, (chans, modules, blocks) in enumerate(_stages(cfg), 2):
        new = xs + [None] * (len(chans) - len(xs))
        for b, src, _, _, stride, suffix in _transition(prev, chans):
            new[b] = conv(xs[src], w, f"{BU}.transition{s - 1}.{suffix}", stride=stride,
                          relu=True)
        xs = new
        for m in range(modules):
            xs = _module(w, f"{BU}.stage{s}.{m}", chans, blocks, xs)
        prev = chans
    return xs


def forward(cfg, w: Dict[str, torch.Tensor], x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{p1 .. p5} of the padded input x (1, 3, Hp, Wp)."""
    xs = _body(cfg, w, x)
    ups = [xs[0]] + [F.interpolate(y, scale_factor=float(2 ** i), mode="bilinear",
                                   align_corners=False) for i, y in enumerate(xs[1:], 1)]
    red = conv(torch.cat(ups, dim=1), w, "backbone.reduction_conv")
    return {f"p{i + 1}": conv(red if i == 0 else F.avg_pool2d(red, 2 ** i), w,
                              f"backbone.fpn_conv.{i}") for i in range(LEVELS)}


def flops(cfg, hw: Tuple[int, int]) -> float:
    """Every conv of the stem, layer1, the transitions, the BasicBlocks, the
    fusions and HRFPN (the reduction and the five level convs) on an
    (Hp, Wp) canvas."""
    stem = cfg[H + "STEM_INPLANES"]
    total = conv_flops(3, stem, 3, level_hw(hw, 2)) + conv_flops(stem, stem, 3, level_hw(hw, 4))
    at4 = level_hw(hw, 4)
    for i in range(4):
        cin = stem if i == 0 else LAYER1_OUT
        total += conv_flops(cin, BOTTLENECK, 1, at4) + conv_flops(BOTTLENECK, BOTTLENECK, 3, at4)
        total += conv_flops(BOTTLENECK, LAYER1_OUT, 1, at4)
        if i == 0:
            total += conv_flops(cin, LAYER1_OUT, 1, at4)
    prev = [LAYER1_OUT]
    for chans, modules, blocks in _stages(cfg):
        branch_hw = [level_hw(hw, BRANCH_STRIDES[b]) for b in range(len(chans))]
        for b, _, cin, cout, _, _ in _transition(prev, chans):
            total += conv_flops(cin, cout, 3, branch_hw[b])
        per_module = sum(2 * blocks[b] * conv_flops(c, c, 3, branch_hw[b])
                         for b, c in enumerate(chans))
        for i in range(len(chans)):
            for j in range(len(chans)):
                if j > i:
                    per_module += conv_flops(chans[j], chans[i], 1, branch_hw[j])
                for k, (cin, cout) in enumerate(_fuse_chain(chans, i, j)):
                    per_module += conv_flops(cin, cout, 3, branch_hw[j + k + 1])
        total += modules * per_module
        prev = chans
    c = out_channels(cfg)
    total += conv_flops(sum(prev), c, 1, at4)
    for i in range(LEVELS):
        total += conv_flops(c, c, 3, level_hw(hw, 4 * 2 ** i))
    return total
