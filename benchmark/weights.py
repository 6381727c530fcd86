"""The served weights, made from a seed on the device.

One ``torch.randn`` call on the device draws every weight; each tensor is
then scaled, in place, to ``gain / sqrt(fan_in)`` (a bias to ``bias_std``),
with the gain of the first rule of the configuration's ``init.gains`` whose
pattern matches its name (``init.default_gain`` otherwise). The factors keep
the activations of a random network near unit scale (inside float16's
range) and tame the detection stage so that boxes have real sizes and
scores are spread. The weights are rounded to the served dtype, so the
program and the reference read the same numbers.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Tuple

import torch

DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}


def fan_in(name: str, shape: Tuple[int, ...]) -> float:
    """Inputs summed into one output: a conv's Cin * kh * kw, a linear's
    in-features; a stride-2 transposed conv (Cin, Cout, kh, kw) sums a
    quarter of its kernel taps per output."""
    if ".densepose_predictor." in name:
        return shape[0] * shape[2] * shape[3] / 4
    return float(math.prod(shape[1:]))


def make_weights(shapes: Dict[str, Tuple[int, ...]], init: dict, seed: int,
                 device, dtype: str) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor on ``device``} holding values of ``dtype``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 64)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    rules = [(re.compile(p), float(g)) for p, g in init["gains"]]
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if name.endswith(".bias"):
            t.mul_(float(init["bias_std"]))
        else:
            gain = next((g for p, g in rules if p.search(name)), float(init["default_gain"]))
            t.mul_(gain / math.sqrt(fan_in(name, shape)))
        out[name] = t
    flat.copy_(flat.to(DTYPES[dtype]).float())
    return out


def host_params(weights: Dict[str, torch.Tensor]) -> Dict[str, "object"]:
    """The weights as host numpy arrays, the form the program's
    ``params=`` takes, in one device-to-host copy."""
    names = list(weights)
    flat = torch.cat([weights[k].reshape(-1) for k in names]).cpu().numpy()
    out, at = {}, 0
    for k in names:
        n = weights[k].numel()
        out[k] = flat[at:at + n].reshape(tuple(weights[k].shape))
        at += n
    return out
