"""Bilinear resizing with PyTorch ``F.interpolate`` semantics (port of
densepose_tpu/ops/resize.py).

Uses:

* the preprocess resize of the uint8 image (``resize_image``): fp32 taps
  from torch's scale-factor coordinate rule and a fp32 lerp per axis, the
  same roundings as the JAX package's ``resize_bilinear_packed`` and
  ``resize_bilinear_np``, so the result is bit-identical to theirs;
* ``resize_bilinear_np``, the same resize in numpy on the host (a copy of
  the JAX package's): the geometry-bucket canvas of
  ``predictor.DensePosePredictor.bucketize``;
* ``source_rows`` / ``row_weights``: the source rows and the tables of a
  range of output rows, for a row slab of the preprocess
  (``models/rcnn.py::preprocess_rows``) and of HRFPN's upsample
  (``parallel/halo.py::upsample_bilinear_rows``);
* the decoder, predictor and head upsamples (``resize_bilinear``): a 2x
  upsample of a CUDA tensor is kernel U1 (``upsample2x_cuda``,
  ``csrc/upsample2x.cu``); every other call, and every call on the CPU, is
  ``F.interpolate(..., align_corners=False)``.

Source coordinate rule (align_corners=False):
    src = (dst + 0.5) * ratio - 0.5,   clamped below at 0
with ratio = 1/scale_factor when a scale is given, else H_in / H_out.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.timing import span
from .cuda_build import library
from .roi_align import DTYPE_CODES


def _axis_weights(in_size: int, out_size: int, scale: Optional[float]):
    """Static (i0, i1, w0, w1) index/weight vectors for one axis, computed in
    float32 as torch does for float32 inputs."""
    if scale is not None:
        ratio = np.float32(1.0) / np.float32(scale)
    else:
        ratio = np.float32(in_size) / np.float32(out_size)
    dst = np.arange(out_size, dtype=np.float32)
    src = (dst + np.float32(0.5)) * ratio - np.float32(0.5)
    src = np.maximum(src, 0.0)
    i0 = np.floor(src).astype(np.int64)
    i0 = np.minimum(i0, in_size - 1)
    frac = src - i0
    i1 = np.minimum(i0 + 1, in_size - 1)
    # when i0 == in_size-1, i1 == i0 and the lerp degenerates to x[i0]
    w1 = np.where(i1 > i0, frac, 0.0)
    w0 = 1.0 - w1
    return i0, i1, w0.astype(np.float32), w1.astype(np.float32)


def resize_image(
    image: torch.Tensor,
    out_hw: Tuple[int, int],
    scale: Optional[Tuple[float, float]] = None,
) -> torch.Tensor:
    """(..., H, W, C) uint8 or float images -> (..., H_out, W_out, C) float32
    (a batch of same-shaped frames shares the tables).

    H pass then W pass, each ``a * w0 + b * w1`` as two rounded products and
    one rounded sum (separate elementwise kernels, so nothing is fused into an
    FMA): bit-identical to the JAX package's preprocess resize."""
    h_in = image.shape[-3]
    sh = scale[0] if scale is not None else None
    return _resize(image, _device_weights(h_in, out_hw[0], sh, image.device), out_hw[1], scale)


def resize_image_rows(source: torch.Tensor, h_in: int, out_hw: Tuple[int, int],
                      scale: Optional[Tuple[float, float]], r0: int, r1: int) -> torch.Tensor:
    """Output rows [r0, r1) of ``resize_image`` of an ``h_in``-row image,
    given only its rows [lo, hi) that ``source_rows`` names (``source``):
    the same taps, weights and roundings, so bitwise those rows."""
    sh = scale[0] if scale is not None else None
    lo, hi, *tables = row_weights(h_in, out_hw[0], sh, r0, r1, source.device)
    if source.shape[-3] != hi - lo:
        raise ValueError(f"output rows [{r0}, {r1}) read source rows [{lo}, {hi}), given "
                         f"{source.shape[-3]}")
    return _resize(source, tables, out_hw[1], scale)


def _resize(image: torch.Tensor, row_tables, w_out: int,
            scale: Optional[Tuple[float, float]]) -> torch.Tensor:
    """The H pass by ``row_tables`` (i0, i1, w0, w1), then the W pass."""
    w_in = image.shape[-2]
    sw = scale[1] if scale is not None else None
    i0, i1, w0, w1 = row_tables
    ya = image.index_select(-3, i0).float()
    yb = image.index_select(-3, i1).float()
    y = ya * w0[:, None, None] + yb * w1[:, None, None]

    j0, j1, v0, v1 = _device_weights(w_in, w_out, sw, image.device)
    ya = y.index_select(-2, j0)
    yb = y.index_select(-2, j1)
    return ya * v0[None, :, None] + yb * v1[None, :, None]


@functools.lru_cache(maxsize=64)
def _host_weights(in_size: int, out_size: int, scale: Optional[float]):
    return _axis_weights(in_size, out_size, scale)


def source_rows(in_size: int, out_size: int, scale: Optional[float], r0: int,
                r1: int) -> Tuple[int, int]:
    """The source rows [lo, hi) that output rows [r0, r1) of a resize read
    (``_axis_weights``' taps: clamped at the edges, never past them)."""
    i0, i1, _, _ = _host_weights(in_size, out_size, scale)
    return int(i0[r0:r1].min()), int(i1[r0:r1].max()) + 1


def row_weights(in_size: int, out_size: int, scale: Optional[float], r0: int, r1: int,
                device):
    """Output rows [r0, r1) of a resize: (lo, hi, i0, i1, w0, w1), the
    source rows ``source_rows`` gives and ``_axis_weights``' tables of those
    output rows on ``device``, the taps counted from ``lo``."""
    lo, hi = source_rows(in_size, out_size, scale, r0, r1)
    i0, i1, w0, w1 = _device_weights(in_size, out_size, scale, device)
    return lo, hi, i0[r0:r1] - lo, i1[r0:r1] - lo, w0[r0:r1], w1[r0:r1]


@functools.lru_cache(maxsize=64)
def _device_weights(in_size: int, out_size: int, scale: Optional[float], device):
    """``_axis_weights`` as tensors on ``device``, made once per geometry: a
    copy from pageable host memory waits for the device's queued work, so a
    request that made them anew would stall its host until the previous
    request finished."""
    return tuple(torch.from_numpy(a).to(device) for a in _axis_weights(in_size, out_size, scale))


def resize_bilinear_np(x: np.ndarray, out_hw: Tuple[int, int],
                       scale: Optional[Tuple[float, float]] = None) -> np.ndarray:
    """(H, W, C) uint8 or float array -> (H_out, W_out, C) float32 on the host:
    the taps and per-element fp32 lerps of ``resize_image`` (two rounded
    products and one rounded sum, the same in numpy and PyTorch), so the two
    agree bit for bit."""
    h_in, w_in = x.shape[:2]
    h_out, w_out = out_hw
    sh, sw = scale if scale is not None else (None, None)
    i0, i1, w0, w1 = _axis_weights(h_in, h_out, sh)
    y = x[i0].astype(np.float32) * w0[:, None, None] + x[i1].astype(np.float32) * w1[:, None, None]
    j0, j1, v0, v1 = _axis_weights(w_in, w_out, sw)
    return y[:, j0] * v0[None, :, None] + y[:, j1] * v1[None, :, None]


def resize_bilinear(
    x: torch.Tensor,
    out_hw: Tuple[int, int],
    scale: Optional[Tuple[float, float]] = None,
) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``out_hw``; ``scale`` mirrors
    torch's scale_factor mode (the coordinate ratio is then 1/scale). A
    scale of (2, 2) is ``upsample2x``: kernel U1 on a CUDA tensor. Every
    other call is PyTorch's ``F.interpolate`` and counts one in
    ``resize_bilinear.library_calls``, on any device."""
    if scale is not None and tuple(scale) == (2.0, 2.0):
        y = upsample2x(x)
    else:
        if not torch.compiler.is_compiling():
            resize_bilinear.library_calls += 1
        if scale is None:
            return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                                 align_corners=False)
        y = F.interpolate(x, scale_factor=tuple(scale), mode="bilinear",
                          align_corners=False)
    if tuple(y.shape[-2:]) != tuple(out_hw):
        raise ValueError(f"scale {scale} gives {tuple(y.shape[-2:])}, not {out_hw}")
    return y


resize_bilinear.library_calls = 0


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """``F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)``
    of an (N, C, H, W) tensor: kernel U1 for a CUDA tensor, ``F.interpolate``
    for the others; while ``torch.export`` traces, the operator
    ``densepose_tpu_torch::upsample2x`` (``ops/library.py``), whose CPU
    kernel is ``F.interpolate`` too, so a program on the CPU computes what
    the eager request does."""
    if torch.compiler.is_exporting():
        return torch.ops.densepose_tpu_torch.upsample2x(x)
    if x.is_cuda:
        return upsample2x_cuda(x)
    return upsample2x_library(x)


def upsample2x_library(x: torch.Tensor) -> torch.Tensor:
    """PyTorch's own 2x upsample: the CPU route, and a yardstick on the card."""
    return F.interpolate(x, scale_factor=(2.0, 2.0), mode="bilinear", align_corners=False)


def _taps2x(n: int, device) -> Tuple[torch.Tensor, ...]:
    """PyTorch's taps of a 2x upsample along an axis of n: for output 2k the
    input (k - 1, k) at 0.25 / 0.75, or (0, min(1, n - 1)) at 1 / 0 when k is
    0; for 2k + 1 the input (k, min(k + 1, n - 1)) at 0.75 / 0.25. Returns
    (i0, i1, w0, w1), the weights float64 (exact)."""
    k = np.arange(n)
    even0 = np.where(k >= 1, k - 1, 0)
    even1 = np.where(k >= 1, k, min(1, n - 1))
    i0 = np.stack([even0, k], axis=1).reshape(-1)
    i1 = np.stack([even1, np.minimum(k + 1, n - 1)], axis=1).reshape(-1)
    w0 = np.stack([np.where(k >= 1, 0.25, 1.0), np.full(n, 0.75)], axis=1).reshape(-1)
    w1 = np.stack([np.where(k >= 1, 0.75, 0.0), np.full(n, 0.25)], axis=1).reshape(-1)
    return tuple(torch.from_numpy(a).to(device) for a in (i0, i1, w0, w1))


def _lerp2(wa, a, wb, b):
    """fp32 ``fma(wa, a, wb * b)`` from float64 operands that hold fp32
    values: wb * b is exact in float64 and rounded to fp32 as the kernel's
    product; wa * a (the weights have two significant bits) and the sum are
    exact in float64 unless the two terms differ by a factor near 2^53, so
    one rounding to fp32 is the fused multiply-add's."""
    return (wa * a + (wb * b).float().double()).float().double()


def upsample2x_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of U1, on any device: its arithmetic, in the
    same order. Each output row's horizontal sums
    ``fma(w0, x[r][c0], w1 * x[r][c1])`` rounded to fp32, then
    ``fma(h0, sum(r0), h1 * sum(r1))`` rounded to fp32 and to x's dtype."""
    h, w = x.shape[-2:]
    r0, r1, h0, h1 = _taps2x(h, x.device)
    c0, c1, w0, w1 = _taps2x(w, x.device)
    xd = x.double()
    s = _lerp2(w0, xd[..., c0], w1, xd[..., c1])
    y = _lerp2(h0[:, None], s[..., r0, :], h1[:, None], s[..., r1, :])
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """U1's library, built on first use, with its C signature set once."""
    lib = library("upsample2x")
    lib.dp_upsample2x.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                                  + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
    lib.dp_upsample2x.restype = ctypes.c_int
    return lib


def upsample2x_cuda(x: torch.Tensor) -> torch.Tensor:
    """Kernel U1 on a CUDA tensor, one launch: x (N, C, H, W) float32, float16
    or bfloat16 whose (H, W) planes are contiguous (any N and C strides).
    Returns a new contiguous (N, C, 2H, 2W) tensor of x's dtype, bit-identical
    to ``F.interpolate``'s. Raises if x does not fit or the launch fails."""
    with span("upsample2x"):
        if not x.is_cuda or x.dtype not in DTYPE_CODES or x.dim() != 4:
            raise ValueError(f"U1 takes an (N, C, H, W) float32, float16 or bfloat16 CUDA "
                             f"tensor, got {x.dtype} {tuple(x.shape)} on {x.device}")
        n, c, h, w = x.shape
        if (h > 1 and x.stride(2) != w) or (w > 1 and x.stride(3) != 1):
            raise ValueError(f"U1 takes contiguous (H, W) planes, got strides {x.stride()} "
                             f"for shape {tuple(x.shape)}")
        out = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _lib().dp_upsample2x(x.data_ptr(), out.data_ptr(), n, c, h, w, x.stride(0),
                                       x.stride(1), DTYPE_CODES[x.dtype], stream)
        if err != 0:
            raise RuntimeError(f"upsample2x_cuda launch failed: cudaError {err}")
        upsample2x_cuda.launches += 1
        return out


upsample2x_cuda.launches = 0
