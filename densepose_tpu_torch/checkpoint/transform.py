"""Weight transforms for the PyTorch port (host-side numpy, run once at load).

* ``random_torch_state``: random reference-layout params for tests and runs
  without a checkpoint; the same numpy stream as the JAX package's
  ``densepose_tpu/checkpoint/transform.py::random_torch_state`` for the same
  spec and seed, so both packages build identical weights from one seed.
* ``fold_frozen_bn``: FrozenBN collapsed into the preceding conv's kernel and
  bias (the port of ``densepose_tpu/ops/norms.py::fold_frozen_bn`` on OIHW
  kernels). The port always folds: its backbone convs carry a bias and no
  norm module.
* ``fold_state``: reference state dict -> the port's module state dict,
  folding each FrozenBN into its conv: detectron2's ``X.norm`` children and
  HRNet's siblings (``conv1``/``bn1``, Sequential ``.0``/``.1``:
  ``bn_base_for``).
* ``params_from_jax``: the JAX package's param dict -> the port's module
  state dict, undoing the layout transforms of
  ``densepose_tpu/checkpoint/transform.py::torch_state_to_jax``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .spec import ParamSpec, Spec

StateDict = Dict[str, np.ndarray]

RANDOM_SCALE = 0.03  # std of random conv/linear weights, as in the JAX package


def random_torch_state(spec: Spec, seed: int = 0) -> StateDict:
    """Random torch-layout params (no checkpoint needed).

    Norm statistics must be plausible, not merely random: a running_var drawn
    from randn is negative half the time and the FrozenBN fold's sqrt then
    poisons the net with NaNs. A norm weight is any ``.norm.weight`` or any
    ``.weight`` whose prefix also owns a ``running_var``. The draw order is
    the spec's order, which keeps the stream identical to the JAX package's."""
    rng = np.random.RandomState(seed)
    out: StateDict = {}
    for name, ps in spec.items():
        if name.endswith("running_var"):
            out[name] = (rng.rand(*ps.shape).astype(np.float32) * 0.5 + 0.5)
        elif name.endswith(".norm.weight") or (
                name.endswith(".weight")
                and name[:-len("weight")] + "running_var" in spec):
            out[name] = (rng.rand(*ps.shape).astype(np.float32) * 0.5 + 0.75)
        else:
            out[name] = (rng.randn(*ps.shape) * RANDOM_SCALE).astype(np.float32)
    return out


def fold_frozen_bn(
    conv_w: np.ndarray,
    conv_b: Optional[np.ndarray],
    bn_weight: np.ndarray,
    bn_bias: np.ndarray,
    bn_mean: np.ndarray,
    bn_var: np.ndarray,
    eps: float = 1e-5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fold FrozenBN into a conv whose kernel is OIHW (out = first axis).

    Returns (w', b') with conv(x, w') + b' == BN(conv(x, w) + b), computed in
    float64 on the host; elementwise the same arithmetic as the JAX package's
    HWIO fold, so both give bit-identical float32 weights."""
    scale = bn_weight.astype(np.float64) / np.sqrt(bn_var.astype(np.float64) + eps)
    shift = bn_bias.astype(np.float64) - bn_mean.astype(np.float64) * scale
    w = conv_w.astype(np.float64) * scale[:, None, None, None]
    b = shift if conv_b is None else conv_b.astype(np.float64) * scale + shift
    return w.astype(np.float32), b.astype(np.float32)


def bn_base_for(conv_base: str) -> Optional[str]:
    """The base name of the BatchNorm HRNet pairs with conv ``conv_base`` as a
    sibling (upstream naming: ``conv{N}`` -> ``bn{N}``, a Sequential's ``.0``
    -> ``.1``), or None (a copy of the JAX package's
    ``models/hrnet.py::_bn_base_for``)."""
    head, _, tail = conv_base.rpartition(".")
    if tail.startswith("conv"):
        return f"{head}.bn{tail[4:]}"
    if tail == "0":
        return f"{head}.1"
    return None


def _frozen_bn_of(base: str, spec: Spec) -> Optional[str]:
    """The FrozenBN folded into conv ``base``: its ``.norm`` child, or its
    HRNet sibling (``bn_base_for``) where the spec has that BN's statistics."""
    if f"{base}.norm.running_mean" in spec:
        return f"{base}.norm"
    bn = bn_base_for(base)
    return bn if bn is not None and f"{bn}.running_mean" in spec else None


def fold_state(state: StateDict, spec: Spec) -> StateDict:
    """Reference state dict -> the port's module state dict: every conv with a
    FrozenBN in the spec (a ``.norm`` child, or an HRNet sibling,
    ``_frozen_bn_of``) gets it folded into a weight and a bias, in float64 as
    the JAX package folds both (``torch_state_to_jax``, ``hrnet_fold_bn``), so
    the folded weights are the JAX package's bits. Missing spec entries are
    zero-filled (``.norm`` scales and variances one-filled), as the
    reference's strict=False load and the JAX package's loader do."""

    def get(name: str, ps: ParamSpec) -> np.ndarray:
        if name in state:
            a = np.asarray(state[name], dtype=np.float32)
            if tuple(a.shape) != tuple(ps.shape):
                raise ValueError(f"{name}: checkpoint shape {a.shape} != spec {ps.shape}")
            return a
        if name.endswith(".norm.running_var") or name.endswith(".norm.weight"):
            return np.ones(ps.shape, dtype=np.float32)
        return np.zeros(ps.shape, dtype=np.float32)

    out: StateDict = {}
    handled = set()
    for name, ps in spec.items():
        if name in handled:
            continue
        bn = _frozen_bn_of(name[: -len(".weight")], spec) \
            if ps.kind == "conv" and name.endswith(".weight") else None
        if bn is not None:
            base = name[: -len(".weight")]
            bias_name = f"{base}.bias"
            b = None
            if bias_name in spec:
                b = get(bias_name, spec[bias_name])
                handled.add(bias_name)
            norm = {}
            for sfx in ("weight", "bias", "running_mean", "running_var"):
                n = f"{bn}.{sfx}"
                norm[sfx] = get(n, spec[n])
                handled.add(n)
            out[name], out[bias_name] = fold_frozen_bn(
                get(name, ps), b, norm["weight"], norm["bias"],
                norm["running_mean"], norm["running_var"])
            continue
        out[name] = get(name, ps)
    return out


def params_from_jax(jax_params: Dict[str, np.ndarray]) -> StateDict:
    """The JAX package's folded param dict -> the port's module state dict.

    Inverts ``torch_state_to_jax``'s layouts: HWIO -> OIHW for convs, the
    spatially flipped forward-conv form (kh, kw, Cin, Cout) -> (Cin, Cout, kh,
    kw) for the predictors' ConvTranspose2d kernels (the only 4-D weights
    under ``densepose_predictor.``), (in, out) -> (out, in) for linears. The
    CSE embedders' 2-D tables (kind "vec", ``models/cse.py::embedder_spec``:
    names under ``.embedder.``) pass through as they are, as every vector
    does. FrozenBN must already be folded (``TPU.FOLD_FROZEN_BN``, and for
    HRNet the JAX predictor's ``hrnet_fold_bn``): any BN statistic, of a
    ``.norm`` child or an HRNet sibling, is refused. A GroupNorm's
    ``.norm.weight``/``.norm.bias`` pass through as they are.

    The JAX predictor's params at a half compute dtype (``_cast_param``)
    keep it: float16 arrays come back float16. bfloat16 arrays (``ml_dtypes``
    on the host; numpy has no bfloat16) come back as float32 holding the same
    values, which the port's predictor casts to bfloat16 exactly. Every
    transform goes through float32, which holds both half types exactly.

    A calibrated dict's int8 entries (JAX predictor.py:296-315): a
    ``.qweight`` stays int8 and goes from (kh, kw, Cin, Cout) to the port's
    (Cout, kh, kw, Cin), a predictor deconvolution's also unflipped to
    ConvTranspose2d's tap order (``ops/conv_int8.py``); ``.wscale`` (Cout,)
    and the 0-dim ``.in_scale`` / ``.in_scale_<level>`` pass through as
    float32."""
    out: StateDict = {}
    for name, a in jax_params.items():
        if name.endswith((".running_mean", ".running_var")):
            raise ValueError(f"{name}: unfolded FrozenBN; the port takes folded params")
        if name.endswith(".qweight"):
            q = np.transpose(np.asarray(a, dtype=np.int8), (3, 0, 1, 2))
            if ".densepose_predictor." in name:
                q = q[:, ::-1, ::-1, :]
            out[name] = np.ascontiguousarray(q)
            continue
        dtype = np.float16 if np.asarray(a).dtype == np.float16 else np.float32
        a = np.asarray(a, dtype=np.float32)
        if a.ndim == 4 and ".densepose_predictor." in name:
            a = np.transpose(a, (2, 3, 0, 1))[:, :, ::-1, ::-1]
        elif a.ndim == 4:
            a = np.transpose(a, (3, 2, 0, 1))
        elif a.ndim == 2 and ".embedder." not in name:
            a = a.T
        out[name] = np.ascontiguousarray(a, dtype=dtype)
    return out
