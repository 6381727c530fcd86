"""Parameter specifications (the PyTorch port's copy of
densepose_tpu/checkpoint/spec.py).

Every model component declares its parameters as a ``Spec``: an ordered map
from the *reference state_dict name* (e.g.
``backbone.bottom_up.stem.conv1.weight``) to a ``ParamSpec`` carrying the
torch-layout shape and the tensor kind. The spec is the single source of
truth used for

* random initialization (tests / benches without a downloaded checkpoint),
* checkpoint alignment (the suffix matcher needs the model's key set —
  c2_model_loading.py:209-240),
* FrozenBN folding into the port's conv modules (checkpoint/transform.py).

Kinds (all shapes in torch layout, which the port's modules keep):
    conv    (Cout, Cin, kh, kw)
    convT   (Cin, Cout, kh, kw)
    linear  (out, in)
    vec     1-D (biases, norm params)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    kind: str  # conv | convT | linear | vec


Spec = Dict[str, ParamSpec]


def conv_spec(spec: Spec, name: str, cin: int, cout: int, k: int,
              bias: bool = True, norm: str = "") -> None:
    """Conv2d with the reference's optional fused norm
    (layers/wrappers.py:82-112). norm in {"", "FrozenBN", "GN"}."""
    spec[f"{name}.weight"] = ParamSpec((cout, cin, k, k), "conv")
    if bias:
        spec[f"{name}.bias"] = ParamSpec((cout,), "vec")
    if norm == "FrozenBN":
        for suffix in ("weight", "bias", "running_mean", "running_var"):
            spec[f"{name}.norm.{suffix}"] = ParamSpec((cout,), "vec")
    elif norm == "GN":
        gn_spec(spec, f"{name}.norm", cout)
    elif norm:
        raise ValueError(f"unsupported norm {norm!r}")


def conv_transpose_spec(spec: Spec, name: str, cin: int, cout: int, k: int) -> None:
    spec[f"{name}.weight"] = ParamSpec((cin, cout, k, k), "convT")
    spec[f"{name}.bias"] = ParamSpec((cout,), "vec")


def linear_spec(spec: Spec, name: str, din: int, dout: int) -> None:
    spec[f"{name}.weight"] = ParamSpec((dout, din), "linear")
    spec[f"{name}.bias"] = ParamSpec((dout,), "vec")


def gn_spec(spec: Spec, name: str, c: int) -> None:
    """A GroupNorm module's affine parameters (the ASPP sequentials, and a
    conv's fused ``.norm``)."""
    spec[f"{name}.weight"] = ParamSpec((c,), "vec")
    spec[f"{name}.bias"] = ParamSpec((c,), "vec")
