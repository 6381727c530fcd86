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
* the decoder and chart-predictor 2x upsamples (``resize_bilinear``), which
  call ``F.interpolate(..., align_corners=False)`` directly.

Source coordinate rule (align_corners=False):
    src = (dst + 0.5) * ratio - 0.5,   clamped below at 0
with ratio = 1/scale_factor when a scale is given, else H_in / H_out.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


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
    torch's scale_factor mode (the coordinate ratio is then 1/scale)."""
    if scale is None:
        return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                             align_corners=False)
    y = F.interpolate(x, scale_factor=tuple(scale), mode="bilinear",
                      align_corners=False)
    if tuple(y.shape[-2:]) != tuple(out_hw):
        raise ValueError(f"scale {scale} gives {tuple(y.shape[-2:])}, not {out_hw}")
    return y
