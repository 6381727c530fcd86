"""int8 convolutions of the serving mode (port of densepose_tpu/ops/conv.py:148-327).

Post-training int8: per-output-channel symmetric weight scales
(``quantize_weight_int8``), per-tensor activation scales, either calibrated
(static, ``conv2d_int8_chain`` / ``conv_transpose2d_int8_chain``) or computed
per call (``conv2d_int8``). The sums are s8 x s8 -> s32 and exact; the
epilogue is the JAX package's, in its order: the bias pre-quantized to int32
counts, ReLU on int32, then one per-channel f32 multiply, to the next link's
s8 input (``out_scale``) or to float.

The convolution is kernel Q1 (``csrc/conv_s8.cu``: an implicit GEMM on the
int8 tensor cores, the transposed convolution as a gather over its parity
classes; two variants, ``q1_variant`` says which serves a shape) for CUDA
tensors, and ``conv_s8_plain`` for CPU tensors: the sums in
float64 through ``F.conv2d`` / ``F.conv_transpose2d``, exact because every
partial sum is an integer below 127^2 * K <= 1.4e8 (K <= 512 * 16 for the
deconvolution) << 2^53, then the same epilogue in float32 torch ops. PyTorch
has no int8 convolution on the card or the CPU; the JAX package leaves its own
to XLA.

Layouts, as the JAX package's: s8 activations NHWC (Cin contiguous, the
kernel's K axis). Quantized weights are (Cout, kh, kw, Cin); a transposed
convolution's keep ConvTranspose2d's tap order (the JAX package stores the
spatially flipped forward-conv form; ``checkpoint/transform.py`` converts).
``conv2d_int8`` (dynamic) takes NCHW activations and an OIHW weight, as
``F.conv2d`` does, since the model calls it on its float activations.

Numerics the JAX package fixes under ``jax.jit``: ``amax / 127.0`` becomes
``amax * float32(1 / 127)`` (a division by a constant), while the divisions by
scales (``w / sw``, ``x / scale``, ``b / scale``, ``scale / out_scale``) are
true divisions (the scales are jit arguments). The port does the same: a
0-dim tensor divisor keeps PyTorch's CUDA division true (``ops/boxes.py::
true_div``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.timing import span
from .cuda_build import library

IntPair = Union[int, Tuple[int, int]]

# float32(1 / 127): the reciprocal XLA multiplies by for ``/ 127.0``
INV_127 = float(np.float32(1.0) / np.float32(127.0))
SCALE_FLOOR = 1e-8  # the least scale, as the JAX package's maximum(..., 1e-8)

# Q1's epilogue outputs: the int32 sums (after bias and ReLU), s8 at the next
# link's scale, or float
OUT_KINDS = {"s32": 0, "s8": 1, torch.float32: 2, torch.float16: 3, torch.bfloat16: 4}
_OUT_DTYPES = {"s32": torch.int32, "s8": torch.int8}


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def quantize_weight_int8(w: torch.Tensor, transposed: bool = False):
    """Per-output-channel symmetric weight quantization (JAX
    ``quantize_weight_int8`` as the predictor jits it, bit for bit): a conv's
    (Cout, Cin, kh, kw) or, ``transposed``, a ConvTranspose2d's (Cin, Cout,
    kh, kw) weight -> (qweight (Cout, kh, kw, Cin) int8, wscale (Cout,)
    float32). wscale = max(amax, 1e-8) * float32(1/127); qweight =
    clip(round(w / wscale), -127, 127)."""
    wf = w.float()
    if transposed:
        wf = wf.permute(1, 0, 2, 3)  # (Cout, Cin, kh, kw)
    amax = wf.abs().amax(dim=(1, 2, 3))
    sw = amax.clamp_min(SCALE_FLOOR) * INV_127
    qw = torch.clamp(torch.round(wf / sw[:, None, None, None]), -127, 127).to(torch.int8)
    return qw.permute(0, 2, 3, 1).contiguous(), sw


def _scale_tensor(scale, like: torch.Tensor) -> torch.Tensor:
    """A scale as a float32 tensor on ``like``'s device (0-dim for a
    per-tensor scale), so that dividing by it is a true division."""
    return torch.as_tensor(scale, dtype=torch.float32, device=like.device)


def quant_act_s8(x: torch.Tensor, scale) -> torch.Tensor:
    """clip(round(x / scale), -127, 127) as int8, x in any float dtype and
    layout, the division in float32 (JAX ``quant_act_s8``)."""
    return torch.clamp(torch.round(x.float() / _scale_tensor(scale, x)), -127, 127).to(torch.int8)


def act_stat(x: torch.Tensor, stat: str, scale=None) -> torch.Tensor:
    """A quantization site's activation statistic (JAX ``act_stat``): "max",
    max |x| in float32; "sat", the fraction of |x| > 127 * scale (0 where the
    site has no installed ``scale``)."""
    x32 = x.float().abs()
    if stat == "max":
        return x32.max()
    if stat != "sat":
        raise ValueError(f"unknown statistic {stat!r}")
    if scale is None:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    return (x32 > 127.0 * _scale_tensor(scale, x)).float().mean()


class Epilogue(NamedTuple):
    """Q1's per-channel epilogue vectors for one link: ``qb`` (Cout,) int32
    or None, and ``vec`` (Cout,) float32, m = sx * wscale / out_scale for s8
    out, else the dequantization scale sx * wscale."""
    qb: Optional[torch.Tensor]
    vec: torch.Tensor


def make_epilogue(sx, wscale: torch.Tensor, bias: Optional[torch.Tensor],
                  out_scale=None) -> Epilogue:
    """The JAX chain's constants: scale = sx * wscale (float32), qb =
    round(bias / scale) as int32, m = scale / out_scale (true divisions)."""
    scale = _scale_tensor(sx, wscale) * wscale
    qb = None if bias is None else torch.round(bias.float() / scale).to(torch.int32)
    vec = scale if out_scale is None else scale / _scale_tensor(out_scale, wscale)
    return Epilogue(qb, vec.contiguous())


def out_size(h: int, w: int, qw: torch.Tensor, stride: IntPair, padding: IntPair,
             dilation: IntPair, transposed: bool) -> Tuple[int, int]:
    """The output (Ho, Wo) of an (h, w) input: the convolution's, or the
    transposed convolution's (output padding 0)."""
    kh, kw = qw.shape[1], qw.shape[2]
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    if transposed:
        return (h - 1) * sh - 2 * ph + kh, (w - 1) * sw - 2 * pw + kw
    return (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1, (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1


def _epilogue_plain(acc: torch.Tensor, qb, vec, relu: bool, out_kind) -> torch.Tensor:
    if qb is not None:
        acc = acc + qb
    if relu:
        acc = acc.clamp_min(0)
    if out_kind == "s32":
        return acc
    y = acc.float() * vec
    if out_kind == "s8":
        return torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return y.to(out_kind)


def conv_s8_plain(qx: torch.Tensor, qw: torch.Tensor, qb: Optional[torch.Tensor],
                  vec: Optional[torch.Tensor], *, stride: IntPair = 1, padding: IntPair = 0,
                  dilation: IntPair = 1, transposed: bool = False, relu: bool = False,
                  out_kind="s32") -> torch.Tensor:
    """Q1's plain version: qx (N, H, W, Cin) int8, qw (Cout, kh, kw, Cin)
    int8 -> (N, Ho, Wo, Cout) of ``out_kind`` ("s32", "s8" or a float dtype).
    The sums in float64 (exact), then the epilogue in float32."""
    x = qx.permute(0, 3, 1, 2).double()
    if transposed:
        acc = F.conv_transpose2d(x, qw.permute(3, 0, 1, 2).double(), stride=_pair(stride),
                                 padding=_pair(padding))
    else:
        acc = F.conv2d(x, qw.permute(0, 3, 1, 2).double(), stride=_pair(stride),
                       padding=_pair(padding), dilation=_pair(dilation))
    acc = acc.round().to(torch.int32).permute(0, 2, 3, 1)
    return _epilogue_plain(acc, qb, vec, relu, out_kind).contiguous()


# Q1's two variants, by their C code (csrc/conv_s8.cu::Variant)
Q1_VARIANTS = {"mma_sync": 0, "wgmma": 1}
WGMMA_MAX_CORNER = 127   # a rank-4 im2col map's box corners lie in [-128, 127]
WGMMA_MAX_OFFSET = 254   # and its tap offsets in [0, 254]
WGMMA_MAX_M_TILES = 65535  # M tiles of 128 rows (the grid's y extent)


def wgmma_takes(x_shape, w_shape, *, stride: IntPair = 1, padding: IntPair = 0,
                dilation: IntPair = 1, transposed: bool = False) -> bool:
    """Whether Q1's wgmma variant can describe the convolution of an
    (N, H, W, Cin) s8 input by (Cout, kh, kw, Cin) s8 weights: the
    preconditions ``csrc/conv_s8.cu::plan_wgmma`` checks (besides 16-byte
    aligned tensors, which a fresh contiguous tensor is). Cin a multiple of
    16 (TMA's global strides); the im2col box's corners in [-128, 127] and
    its tap offsets in [0, 254]; a forward conv's stride at most 8 (the
    traversal stride); a transposed conv's output a whole number of strides
    on each axis (every parity class walks the same box), dilation 1."""
    n, h, w, cin = (int(v) for v in x_shape)
    kh, kw = int(w_shape[1]), int(w_shape[2])
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    if cin % 16 or kh * kw > 64:
        return False
    if transposed:
        ho, wo = (h - 1) * sh - 2 * ph + kh, (w - 1) * sw - 2 * pw + kw
        if (dh, dw) != (1, 1) or ho % sh or wo % sw:
            return False
        m = n * (ho // sh) * (wo // sw)
        axes = []
        for k, s, p, size, out in ((kh, sh, ph, h, ho), (kw, sw, pw, w, wo)):
            offs = [(q + p - t) // s for q in range(s) for t in range(k) if (q + p - t) % s == 0]
            if not offs:
                return False
            lo = min(offs)
            axes.append((lo, out // s - size + lo, max(offs) - lo))
    else:
        ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
        wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
        m = n * ho * wo
        axes = []
        for k, s, p, d, size, out in ((kh, sh, ph, dh, h, ho), (kw, sw, pw, dw, w, wo)):
            lower, upper = -p, p - (k - 1) * d
            span = size - 1 + upper - lower
            if s > 8 or span < 0 or span // s + 1 != out:
                return False
            axes.append((lower, upper, (k - 1) * d))
    ok = all(-WGMMA_MAX_CORNER - 1 <= c <= WGMMA_MAX_CORNER for lo, up, _ in axes
             for c in (lo, up))
    return ok and all(off <= WGMMA_MAX_OFFSET for *_, off in axes) and \
        0 < m and (m + 127) // 128 <= WGMMA_MAX_M_TILES


def q1_variant(x_shape, w_shape, *, stride: IntPair = 1, padding: IntPair = 0,
               dilation: IntPair = 1, transposed: bool = False) -> str:
    """Which of Q1's variants serves a convolution, a fixed rule on its
    shapes: "wgmma" (wgmma on TMA tiles: an im2col tensor map for the
    activations) wherever ``wgmma_takes`` the shape, else "mma_sync" (the
    first design, cp.async and mma.sync: Cin 40 and 600, and any Cin not a
    multiple of 16). The rule has no exception by size: on an H100 the
    wgmma variant took less device time than mma_sync at every site shape
    ``chip_smoke.py`` times, from the head links (3.4x) to HRNet's
    32-channel branches (PERF.md section 6)."""
    geo = dict(stride=stride, padding=padding, dilation=dilation, transposed=transposed)
    return "wgmma" if wgmma_takes(x_shape, w_shape, **geo) else "mma_sync"


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Q1's library, built on first use, with its C signature set once."""
    lib = library("conv_s8")
    lib.dp_conv_s8.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 19 + [ctypes.c_void_p]
    lib.dp_conv_s8.restype = ctypes.c_int
    return lib


def conv_s8_cuda(qx: torch.Tensor, qw: torch.Tensor, qb: Optional[torch.Tensor],
                 vec: Optional[torch.Tensor], *, stride: IntPair = 1, padding: IntPair = 0,
                 dilation: IntPair = 1, transposed: bool = False, relu: bool = False,
                 out_kind="s32", variant: Optional[str] = None) -> torch.Tensor:
    """Kernel Q1 on CUDA tensors, ``conv_s8_plain``'s contract: one launch
    of the variant ``q1_variant`` picks for the shapes (or ``variant``, to
    time or test one), counted in ``conv_s8_cuda.launches`` and in
    ``conv_s8_cuda.variant_launches[variant]``. kh * kw at most 64; Cin a
    multiple of 4 (mma_sync) or ``wgmma_takes``'s shapes (wgmma). Raises on
    any other input or a failed launch; no variant stands in for another."""
    with span("conv_s8"):
        if qx.dim() != 4 or qw.dim() != 4 or qx.shape[3] != qw.shape[3]:
            raise ValueError(f"Q1 takes qx (N, H, W, Cin) and qw (Cout, kh, kw, Cin), got "
                             f"{tuple(qx.shape)} and {tuple(qw.shape)}")
        if out_kind not in OUT_KINDS:
            raise ValueError(f"Q1 has no output {out_kind!r}")
        geo = dict(stride=stride, padding=padding, dilation=dilation, transposed=transposed)
        variant = variant or q1_variant(qx.shape, qw.shape, **geo)
        if variant not in Q1_VARIANTS:
            raise ValueError(f"Q1 has no variant {variant!r}")
        cout = qw.shape[0]
        tensors = [("qx", qx, torch.int8), ("qw", qw, torch.int8)]
        if qb is not None:
            tensors.append(("qb", qb, torch.int32))
        if out_kind != "s32":
            if vec is None:
                raise ValueError(f"Q1's {out_kind} output needs its epilogue vector")
            tensors.append(("vec", vec, torch.float32))
        for name, t, dtype in tensors:
            if not t.is_cuda or t.device != qx.device:
                raise ValueError(f"{name} must be a CUDA tensor on {qx.device}")
            if t.dtype != dtype or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous {dtype}, got {t.dtype}")
            if name in ("qb", "vec") and tuple(t.shape) != (cout,):
                raise ValueError(f"{name} must be ({cout},), got {tuple(t.shape)}")
        n, h, w, cin = qx.shape
        (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
        ho, wo = out_size(h, w, qw, stride, padding, dilation, transposed)
        out = torch.empty((n, ho, wo, cout), device=qx.device,
                          dtype=out_dtype_of(out_kind))
        if out.numel() == 0:
            return out
        with torch.cuda.device(qx.device):
            err = _lib().dp_conv_s8(
                qx.data_ptr(), qw.data_ptr(), qb.data_ptr() if qb is not None else None,
                vec.data_ptr() if out_kind != "s32" else None, out.data_ptr(),
                n, h, w, cin, ho, wo, cout, qw.shape[1], qw.shape[2], sh, sw, ph, pw, dh, dw,
                int(transposed), int(relu), OUT_KINDS[out_kind], Q1_VARIANTS[variant],
                torch.cuda.current_stream(qx.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"Q1 launch failed: cudaError {err} ({variant})")
        conv_s8_cuda.launches += 1
        conv_s8_cuda.variant_launches[variant] += 1
        return out


conv_s8_cuda.launches = 0
conv_s8_cuda.variant_launches = dict.fromkeys(Q1_VARIANTS, 0)


def conv_s8(qx: torch.Tensor, qw: torch.Tensor, qb: Optional[torch.Tensor],
            vec: Optional[torch.Tensor], *, stride: IntPair = 1, padding: IntPair = 0,
            dilation: IntPair = 1, transposed: bool = False, relu: bool = False,
            out_kind="s32") -> torch.Tensor:
    """``conv_s8_plain``'s contract: Q1 for CUDA tensors, its plain version
    for CPU tensors; while ``torch.export`` traces, through the operator
    ``densepose_tpu_torch::conv_s8`` (``ops/library.py``)."""
    if torch.compiler.is_exporting():
        if out_kind not in OUT_KINDS:
            raise ValueError(f"Q1 has no output {out_kind!r}")
        return torch.ops.densepose_tpu_torch.conv_s8(
            qx, qw, qb, vec, list(_pair(stride)), list(_pair(padding)), list(_pair(dilation)),
            bool(transposed), bool(relu), out_dtype_of(out_kind))
    kw = dict(stride=stride, padding=padding, dilation=dilation, transposed=transposed,
              relu=relu, out_kind=out_kind)
    if qx.is_cuda:
        return conv_s8_cuda(qx, qw, qb, vec, **kw)
    if qx.device.type != "cpu":
        raise ValueError(f"no int8 convolution for device {qx.device}")
    return conv_s8_plain(qx, qw, qb, vec, **kw)


def out_dtype_of(out_kind) -> torch.dtype:
    """The dtype of Q1's output of kind ``out_kind``: int32 for "s32", int8
    for "s8", else the float dtype itself."""
    return _OUT_DTYPES.get(out_kind, out_kind)


def out_kind_of(dtype: torch.dtype):
    """The inverse of ``out_dtype_of``."""
    return {v: k for k, v in _OUT_DTYPES.items()}.get(dtype, dtype)


def conv2d_int8_chain(qx: torch.Tensor, sx, qw: torch.Tensor, wscale: torch.Tensor,
                      b: Optional[torch.Tensor], *, stride: IntPair = 1, padding: IntPair = 0,
                      dilation: IntPair = 1, out_scale=None, relu: bool = True,
                      out_dtype: Optional[torch.dtype] = None,
                      epilogue: Optional[Epilogue] = None) -> torch.Tensor:
    """One link of a calibrated int8 chain (JAX ``conv2d_int8_chain``): qx
    (N, H, W, Cin) s8 at scale ``sx`` -> with ``out_scale`` the next link's s8
    input, else float32 (or ``out_dtype``) values, NHWC. ``epilogue``: the
    link's vectors made once by ``make_epilogue`` (else made here)."""
    ep = epilogue or make_epilogue(sx, wscale, b, out_scale)
    kind = "s8" if out_scale is not None else (out_dtype or torch.float32)
    return conv_s8(qx, qw, ep.qb, ep.vec, stride=stride, padding=padding, dilation=dilation,
                   relu=relu, out_kind=kind)


def conv_transpose2d_int8_chain(qx: torch.Tensor, sx, qw: torch.Tensor, wscale: torch.Tensor,
                                b: Optional[torch.Tensor], *, stride: int = 2, padding: int = 1,
                                epilogue: Optional[Epilogue] = None) -> torch.Tensor:
    """Calibrated int8 ConvTranspose2d (JAX ``conv_transpose2d_int8_chain``):
    qx (N, H, W, Cin) s8 at ``sx``, qw (Cout, kh, kw, Cin) in
    ConvTranspose2d's tap order -> float32 (N, Ho, Wo, Cout); the bias in
    int32 counts, no ReLU."""
    ep = epilogue or make_epilogue(sx, wscale, b)
    return conv_s8(qx, qw, ep.qb, ep.vec, stride=stride, padding=padding, transposed=True,
                   out_kind=torch.float32)


def conv2d_int8(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
                padding: IntPair = 0) -> torch.Tensor:
    """Dynamically quantized conv (JAX ``conv2d_int8``, the uncalibrated int8
    head): x (N, Cin, H, W) and w (Cout, Cin, kh, kw) as ``F.conv2d`` takes
    them. sx = max(max|x|, 1e-8) * float32(1/127) on the device (no host
    sync), per-channel weight scales, s8 sums, then float(acc) * (sx * sw) +
    b in float32, cast to x's dtype. NCHW out."""
    xf = x.float()
    sx = xf.abs().max().clamp_min(SCALE_FLOOR) * INV_127
    qx = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    qw, sw = quantize_weight_int8(w)
    y = conv_s8(qx.permute(0, 2, 3, 1).contiguous(), qw, None, (sx * sw).contiguous(),
                padding=padding, out_kind=torch.float32)
    if b is not None:
        y = y + b.float()
    return y.permute(0, 3, 1, 2).to(x.dtype)


# ---------------------------------------------------------------------------
# a model's quantized convs: an nn.Conv2d / nn.ConvTranspose2d whose
# calibration state is installed as buffers under the JAX package's names
# (``<conv>.qweight``, ``<conv>.wscale``; the activation scales
# ``<site>.in_scale`` live on the module of the conv they feed)
# ---------------------------------------------------------------------------

INT8_SUFFIXES = (".qweight", ".wscale")


def is_int8_key(name: str) -> bool:
    """An int8 calibration entry of a param dict: a quantized weight, its
    scales, or an activation scale (``.in_scale``, ``.in_scale_<level>``)."""
    return name.endswith(INT8_SUFFIXES) or is_scale_key(name)


def is_scale_key(name: str) -> bool:
    return name.endswith(".in_scale") or ".in_scale_" in name


def quantized(conv) -> bool:
    """Whether ``conv`` has an installed quantized weight."""
    return getattr(conv, "qweight", None) is not None


def set_buffer(module, name: str, value: torch.Tensor) -> None:
    """Install (or replace) a non-persistent buffer: the calibration state
    stays out of ``state_dict``, which keeps the fp weights a checkpoint
    loads; the predictor's ``int8_state`` reads it."""
    module.register_buffer(name, value, persistent=False)
    module.__dict__.pop("_int8_epilogues", None)  # made again for the new state


def link(conv, qx: torch.Tensor, sx: torch.Tensor, out_scale: Optional[torch.Tensor] = None,
         relu: bool = False, out_dtype: Optional[torch.dtype] = None,
         padding: Optional[IntPair] = None) -> torch.Tensor:
    """One quantized conv of a chain through Q1: qx (N, H, W, Cin) s8 at
    scale ``sx`` -> NHWC s8 at ``out_scale``, or float32 (``out_dtype``).
    Stride, padding and dilation are the module's (``padding``: in its place,
    as a row slab with its halo rows takes row padding 0,
    ``parallel/halo.py::link_rows``); a ConvTranspose2d runs as
    ``conv_transpose2d_int8_chain``. The epilogue's vectors are made on the
    first call for each (sx, out_scale) and kept on the module; while
    ``torch.export`` traces, they are made in the program instead."""
    if torch.compiler.is_exporting():
        ep = make_epilogue(sx, conv.wscale, conv.bias, out_scale)
    else:
        cache = conv.__dict__.setdefault("_int8_epilogues", {})
        key = (id(sx), id(out_scale))
        hit = cache.get(key)
        if hit is None or hit[0] is not sx or hit[1] is not out_scale:
            hit = cache[key] = (sx, out_scale,
                                make_epilogue(sx, conv.wscale, conv.bias, out_scale))
        ep = hit[2]
    transposed = isinstance(conv, torch.nn.ConvTranspose2d)
    kind = "s8" if out_scale is not None else (out_dtype or torch.float32)
    return conv_s8(qx, conv.qweight, ep.qb, ep.vec, stride=conv.stride,
                   padding=conv.padding if padding is None else padding,
                   dilation=conv.dilation, transposed=transposed, relu=relu, out_kind=kind)


def to_s8_nhwc(x: torch.Tensor, scale) -> torch.Tensor:
    """An NCHW float map quantized at ``scale``, as a chain's (N, H, W, C)
    s8 input."""
    return quant_act_s8(x, scale).permute(0, 2, 3, 1).contiguous()


def to_nchw(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A chain's NHWC output as the model's NCHW map in ``dtype``."""
    return y.permute(0, 3, 1, 2).to(dtype).contiguous()
