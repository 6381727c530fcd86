"""ROIAlign over FPN levels (port of densepose_tpu/ops/roi_align.py).

Semantics are torchvision ``roi_align`` (the op the reference wraps at
detectron2/layers/roi_align.py:7-74): ``aligned`` shifts coordinates by
-0.5, ``aligned=False`` clamps the ROI size to >= 1, samples with
``y < -1 or y > H`` contribute 0, coordinates clamp to ``[0, H-1]`` with the
lerp taken from the unclamped fraction, a ratio x ratio sample grid per
output bin is averaged. ``sampling_ratio == 0`` is the adaptive grid: per box
and axis min(ceil(bin), ADAPTIVE_CAP) samples, as the JAX gather computes it
(roi_align.py:64-103, 178-186, 219-221). Every zoo pooler uses 2; the default
config's box pooler uses 0.

Layouts are the port's NCHW: per-level features (C, H, W), boxes (M, 4)
XYXY in input-image coordinates, levels (M,) int32, output (M, C, oh, ow).
(The JAX package takes (H, W, C) levels and returns (M, oh, ow, C); the tests
permute explicitly.)

Batched frames (``models/rcnn.py::forward_batch``): the levels may be
(N, C, H, W), one map a frame, with ``frames`` (M,) int32 naming each box's
frame, so that one call pools the boxes of every frame; a box pools exactly
what the call on its own frame's (C, H, W) levels gives it. Without
``frames`` the levels hold one frame, (C, H, W) or (1, C, H, W), as before.
The kernels do not read the index on the host (that would wait for the
device); a frame outside [0, N) pools zeros there, and the plain version
raises on it for CPU tensors.

Dtypes: the levels are float32, float16 or bfloat16 (TPU.COMPUTE_DTYPE), all
of one dtype, and the output has theirs. Boxes, sample weights and sums are
float32; each output is rounded to the levels' dtype once, at the end, as the
JAX package's gather does (roi_align.py:151, :213, :224).

For CUDA tensors the pooling is kernel K2 (``csrc/roi_align.cu``): all levels
in one launch, one CTA per (box, slab of channels) with per-box tap tables in
shared memory. For CPU tensors it is ``roi_align_plain``, a PyTorch port of
the JAX package's gather formulation (roi_align.py:106-224), which is also
what the JAX package runs on the CPU.

With ``DENSEPOSE_TPU_SPARSE_POOLER`` set (read on every call), the
multi-level pooler takes the skip-flag schedule instead: kernel K3 for CUDA
tensors, its plain version for CPU tensors (``ops/roi_align_sparse.py``). The
single-level pooler stays on K2 whatever the variable says, as in the JAX
package.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .boxes import true_div
from .cuda_build import library


CANONICAL_BOX_SIZE = 224  # poolers.py:43-51 defaults, used by every pooler
CANONICAL_LEVEL = 4


def assign_boxes_to_levels(boxes: torch.Tensor, min_level: int, max_level: int) -> torch.Tensor:
    """FPN paper eqn (1); poolers.py:43-51. Returns level - min_level (int32)."""
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    sizes = torch.sqrt(area.float().clamp(min=0.0))
    lvl = torch.floor(CANONICAL_LEVEL + torch.log2(true_div(sizes, CANONICAL_BOX_SIZE) + 1e-8))
    lvl = lvl.clamp(min_level, max_level)
    return lvl.int() - min_level


ADAPTIVE_CAP = 8  # samples per bin and axis at ratio 0, at most (JAX _ADAPTIVE_CAP)


def _axis_samples(start, bin_size, n_bins: int, grid: int, limit, k=None):
    """Sample coordinates along one axis for every (bin, sub-sample):
    (low, high, lerp, ok), each (M, n_bins*grid), ``[:, i::grid]`` selecting
    sub-sample i across bins. ``limit``: (M,) float axis sizes. ``k``
    (adaptive mode): (M,) float samples per bin; sub-sample i of a box sits at
    (i + 0.5) / max(k, 1) of the bin and is masked when i >= k."""
    p = np.arange(n_bins, dtype=np.float32)
    if k is None:
        g = (np.arange(grid, dtype=np.float32) + np.float32(0.5)) / np.float32(grid)
        frac = torch.from_numpy((p[:, None] + g[None, :]).reshape(-1)).to(start.device)
        coord = start[:, None] + bin_size[:, None] * frac[None, :]
    else:
        i = torch.arange(grid, dtype=torch.float32, device=start.device)
        sub = (i[None, :] + 0.5) / k.clamp(min=1.0)[:, None]            # (M, grid)
        frac = torch.from_numpy(p).to(start.device)[None, :, None] + sub[:, None, :]
        coord = (start[:, None, None] + bin_size[:, None, None] * frac).reshape(
            start.shape[0], -1)
    lim = limit[:, None]
    ok = (coord >= -1.0) & (coord <= lim)
    if k is not None:
        ok &= (i[None, :] < k[:, None]).repeat(1, n_bins)
    c = coord.clamp(min=0.0)
    low = torch.floor(c)
    at_edge = low >= lim - 1.0
    low = torch.where(at_edge, lim - 1.0, low)
    lerp = torch.where(at_edge, torch.zeros_like(c), c - low)
    high = torch.where(at_edge, low, low + 1.0)
    return low.long(), high.long(), lerp, ok


def _roi_geometry(boxes, scale_b, output_size, aligned):
    """Per-box start, bin size (y then x) in level coordinates."""
    out_h, out_w = output_size
    offset = 0.5 if aligned else 0.0
    start_w = boxes[:, 0] * scale_b - offset
    start_h = boxes[:, 1] * scale_b - offset
    end_w = boxes[:, 2] * scale_b - offset
    end_h = boxes[:, 3] * scale_b - offset
    roi_w = end_w - start_w
    roi_h = end_h - start_h
    if not aligned:
        roi_w = roi_w.clamp(min=1.0)
        roi_h = roi_h.clamp(min=1.0)
    return start_h, true_div(roi_h, out_h), start_w, true_div(roi_w, out_w)


def box_samples(boxes, scale_b, h_b, w_b, output_size, sampling_ratio, aligned):
    """Each box's samples on its level: the ``_axis_samples`` tuples along y
    and x, the grid ``g`` (the ratio, or ``ADAPTIVE_CAP`` at ratio 0) and the
    per-box divisor (M,): g^2, or max(k_h * k_w, 1) with the adaptive
    k = min(ceil(bin), ADAPTIVE_CAP) (roi_align.py:178-186, 219-221)."""
    out_h, out_w = output_size
    start_h, bin_h, start_w, bin_w = _roi_geometry(boxes, scale_b, output_size, aligned)
    if sampling_ratio > 0:
        g, k_h, k_w = sampling_ratio, None, None
        count = torch.full_like(bin_h, float(g * g))
    else:
        g = ADAPTIVE_CAP
        k_h = torch.ceil(bin_h).clamp(max=float(g))
        k_w = torch.ceil(bin_w).clamp(max=float(g))
        count = (k_h * k_w).clamp(min=1.0)
    ys = _axis_samples(start_h, bin_h, out_h, g, h_b, k_h)
    xs = _axis_samples(start_w, bin_w, out_w, g, w_b, k_w)
    return ys, xs, g, count


def frame_count(feats: List[torch.Tensor], frames=None) -> int:
    """The frames N that every level holds: (C, H, W) levels hold one,
    (N, C, H, W) levels N. N > 1 needs a frame index. Raises ValueError."""
    ns = {f.shape[0] if f.dim() == 4 else 1 for f in feats}
    if len(ns) != 1 or any(f.dim() not in (3, 4) for f in feats):
        raise ValueError(f"levels must all be (C, H, W) or all (N, C, H, W) with one N, got "
                         f"{[tuple(f.shape) for f in feats]}")
    n = ns.pop()
    if n > 1 and frames is None:
        raise ValueError(f"levels of {n} frames need a frame index per box")
    return n


def roi_align_plain(
    feats: List[torch.Tensor],
    boxes: torch.Tensor,
    levels: torch.Tensor,
    scales: Sequence[float],
    output_size: Tuple[int, int],
    sampling_ratio: int,
    aligned: bool,
    frames: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version of K2: each box gathers its taps from its
    level of its frame in the flattened pyramid, widens them to fp32 and sums
    them in fp32, in the JAX package's order, then divides by its sample
    count and rounds to the levels' dtype."""
    out_h, out_w = output_size
    n = frame_count(feats, frames)
    feats = [f if f.dim() == 4 else f[None] for f in feats]
    c = feats[0].shape[1]
    dev = boxes.device
    # per level (C, N * H * W), frame-major within the level
    flat = torch.cat([f.transpose(0, 1).reshape(c, -1) for f in feats], dim=1)
    hs = np.array([f.shape[2] for f in feats], dtype=np.int64)
    ws = np.array([f.shape[3] for f in feats], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(n * hs * ws)[:-1]])
    levels = levels.long()
    h_b = torch.from_numpy(hs).to(dev)[levels]
    w_b = torch.from_numpy(ws).to(dev)[levels]
    off_b = torch.from_numpy(offs).to(dev)[levels]
    if frames is not None:
        frames = frames.long()
        if dev.type == "cpu" and len(frames) and not 0 <= int(frames.min()) <= \
                int(frames.max()) < n:
            raise ValueError(f"a frame index outside [0, {n})")
        off_b = off_b + frames * h_b * w_b
    scale_b = torch.tensor(scales, dtype=torch.float32, device=dev)[levels]

    ys, xs, g, count = box_samples(boxes.float(), scale_b, h_b.float(), w_b.float(),
                                   output_size, sampling_ratio, aligned)
    y_low, y_high, ly, y_ok = ys
    x_low, x_high, lx, x_ok = xs

    m = boxes.shape[0]
    acc = torch.zeros((m, c, out_h, out_w), dtype=torch.float32, device=dev)
    w_row = w_b[:, None, None]
    for iy in range(g):
        yl, yh, fy, oky = y_low[:, iy::g], y_high[:, iy::g], ly[:, iy::g], y_ok[:, iy::g]
        for ix in range(g):
            xl, xh, fx, okx = x_low[:, ix::g], x_high[:, ix::g], lx[:, ix::g], x_ok[:, ix::g]
            ok = (oky[:, :, None] & okx[:, None, :]).float()

            def take(yi, xi):
                idx = off_b[:, None, None] + yi[:, :, None] * w_row + xi[:, None, :]
                taps = flat[:, idx.reshape(-1)].reshape(c, m, out_h, out_w)
                return taps.transpose(0, 1).float()

            w11 = ((1 - fy)[:, :, None] * (1 - fx)[:, None, :] * ok)[:, None]
            w12 = ((1 - fy)[:, :, None] * fx[:, None, :] * ok)[:, None]
            w21 = (fy[:, :, None] * (1 - fx)[:, None, :] * ok)[:, None]
            w22 = (fy[:, :, None] * fx[:, None, :] * ok)[:, None]
            acc = (acc + take(yl, xl) * w11 + take(yl, xh) * w12
                   + take(yh, xl) * w21 + take(yh, xh) * w22)
    return (acc / count[:, None, None, None]).to(flat.dtype)


# the element type codes of K2's and K3's C entry points
# (csrc/roi_align_common.cuh::DtypeCode)
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

# the C signature of K2's and K3's entry points: per-level pointers, heights,
# widths, scales; the level count; boxes, levels, frames (or null), out; the
# frame count, m, c, oh, ow, ratio, aligned, the dtype code; the stream
ENTRY_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 4
                  + [ctypes.c_int] * 8 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """K2's library, built on first use, with its C signatures set once."""
    lib = library("roi_align")
    lib.dp_roi_align.argtypes = ENTRY_ARGTYPES
    for fn in (lib.dp_roi_align, lib.dp_roi_align_max_levels,
               lib.dp_roi_align_max_table_entries):
        fn.restype = ctypes.c_int
    return lib


def check_cuda_inputs(feats, boxes, levels, scales, frames=None) -> int:
    """What the ROIAlign kernels (K2, K3) take: per level a contiguous
    (C, H, W) or (N, C, H, W) CUDA tensor of float32, float16 or bfloat16,
    the same dtype and N for all, and a scale; boxes (M, 4) float32, levels
    (M,) int32 and, where N > 1, frames (M,) int32, contiguous, all on one
    device (the frames' values are not read: that would wait for the
    device). Returns N. Raises ValueError."""
    n = len(feats)
    if n < 1 or len(scales) != n:
        raise ValueError(f"need one scale per level, got {n} levels and "
                         f"{len(scales)} scales")
    n_frames = frame_count(feats, frames)
    dev = boxes.device
    c, dtype = feats[0].shape[-3], feats[0].dtype
    if dtype not in DTYPE_CODES:
        raise ValueError(f"levels must be float32, float16 or bfloat16, got {dtype}")
    for i, f in enumerate(feats):
        if (not f.is_cuda or f.device != dev or f.dtype != dtype
                or f.shape[-3] != c or not f.is_contiguous()):
            raise ValueError(f"level {i} must be a contiguous ({c}, H, W) or (N, {c}, H, W) "
                             f"{dtype} CUDA tensor on {dev}, got {f.dtype} {tuple(f.shape)}")
    if (not boxes.is_cuda or boxes.dtype != torch.float32 or boxes.dim() != 2
            or boxes.shape[1] != 4 or not boxes.is_contiguous()):
        raise ValueError(f"boxes must be contiguous (M, 4) float32 on CUDA, got "
                         f"{boxes.dtype} {tuple(boxes.shape)}")
    m = boxes.shape[0]
    for name, t in (("levels", levels), ("frames", frames)):
        if t is not None and (t.device != dev or t.dtype != torch.int32
                              or tuple(t.shape) != (m,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous ({m},) int32 on {dev}")
    return n_frames


def level_args(feats, scales):
    """The kernels' per-level table arguments: host arrays of the levels'
    device pointers, heights, widths and scales, and the level count."""
    n = len(feats)
    return ((ctypes.c_void_p * n)(*[f.data_ptr() for f in feats]),
            (ctypes.c_int * n)(*[f.shape[-2] for f in feats]),
            (ctypes.c_int * n)(*[f.shape[-1] for f in feats]),
            (ctypes.c_float * n)(*[float(s) for s in scales]), n)


def roi_align_cuda(
    feats: List[torch.Tensor],
    boxes: torch.Tensor,
    levels: torch.Tensor,
    scales: Sequence[float],
    output_size: Tuple[int, int],
    sampling_ratio: int,
    aligned: bool,
    frames: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel K2 on CUDA tensors, one launch: feats per level (C, H, W), or
    (N, C, H, W) with ``frames`` (M,) i32, contiguous, all float32, float16
    or bfloat16; boxes (M, 4) f32, levels (M,) i32, all on one device;
    sampling_ratio 0 is the adaptive count. Returns (M, C, oh, ow) in the
    levels' dtype. Raises if the inputs do not fit or the launch fails."""
    n_frames = check_cuda_inputs(feats, boxes, levels, scales, frames)
    if sampling_ratio < 0:
        raise ValueError(f"K2 takes a sampling_ratio >= 0, got {sampling_ratio}")
    n, m, c = len(feats), boxes.shape[0], feats[0].shape[-3]
    dev = boxes.device
    lib = _lib()
    if n > lib.dp_roi_align_max_levels():
        raise ValueError(f"K2 takes at most {lib.dp_roi_align_max_levels()} levels")
    oh, ow = output_size
    entries = (oh + ow) * (sampling_ratio or ADAPTIVE_CAP)
    if entries > lib.dp_roi_align_max_table_entries():
        raise ValueError(f"K2's tap tables ({entries} entries for {output_size} at ratio "
                         f"{sampling_ratio}) exceed {lib.dp_roi_align_max_table_entries()}")
    out = torch.empty((m, c, oh, ow), dtype=feats[0].dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dp_roi_align(*level_args(feats, scales), boxes.data_ptr(),
                               levels.data_ptr(), frame_ptr(frames), out.data_ptr(), n_frames,
                               m, c, oh, ow, int(sampling_ratio), int(bool(aligned)),
                               DTYPE_CODES[out.dtype], stream)
    if err != 0:
        raise RuntimeError(f"roi_align_cuda launch failed: cudaError {err}")
    roi_align_cuda.launches += 1
    return out


roi_align_cuda.launches = 0


def frame_ptr(frames: Optional[torch.Tensor]):
    """The kernels' frame-index argument: its device pointer, or null."""
    return None if frames is None else frames.data_ptr()


def roi_align_multilevel(
    feats: List[torch.Tensor],
    boxes: torch.Tensor,
    levels: torch.Tensor,
    scales: Sequence[float],
    output_size: Tuple[int, int],
    sampling_ratio: int,
    aligned: bool,
    frames: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pool each box from its assigned level (of its frame, where the
    levels are (N, C, H, W) and ``frames`` names it). Returns (M, C, oh, ow)
    in the levels' dtype.

    K2 for CUDA tensors and the plain version for CPU tensors; with
    ``DENSEPOSE_TPU_SPARSE_POOLER`` set and a fixed ratio, the skip-flag
    pooler (K3 or its plain version) as the JAX package routes it
    (roi_align.py:121-129); ratio 0 always takes the gather, as there."""
    if sampling_ratio > 0 and os.environ.get("DENSEPOSE_TPU_SPARSE_POOLER"):
        from .roi_align_sparse import roi_align_sparse
        return roi_align_sparse(feats, boxes, levels, scales, output_size, sampling_ratio,
                                aligned, frames)
    return _roi_align_gather(feats, boxes, levels, scales, output_size, sampling_ratio,
                             aligned, frames)


def call_args(feats, boxes, levels, scales, output_size, sampling_ratio, aligned, frames):
    """The ROIAlign kernels' positional arguments as their wrappers and
    operators take them: contiguous tensors of the kernels' dtypes, plain
    Python lists, and the frame index (or None) last."""
    return ([f.contiguous() for f in feats], boxes.float().contiguous(),
            levels.int().contiguous(), [float(s) for s in scales], list(output_size),
            int(sampling_ratio), bool(aligned),
            None if frames is None else frames.int().contiguous())


def _roi_align_gather(feats, boxes, levels, scales, output_size, sampling_ratio, aligned,
                      frames=None):
    """K2 for CUDA tensors, its plain version for CPU tensors; while
    ``torch.export`` traces, through the operator
    ``densepose_tpu_torch::roi_align`` (``ops/library.py``)."""
    args = call_args(feats, boxes, levels, scales, output_size, sampling_ratio, aligned,
                     frames)
    if torch.compiler.is_exporting():
        return torch.ops.densepose_tpu_torch.roi_align(*args)
    if boxes.is_cuda:
        return roi_align_cuda(*args)
    if boxes.device.type != "cpu":
        raise ValueError(f"no ROIAlign kernel for device {boxes.device}")
    return roi_align_plain(*args)


def roi_align_single(
    feat: torch.Tensor,
    boxes: torch.Tensor,
    scale: float,
    output_size: Tuple[int, int],
    sampling_ratio: int,
    aligned: bool,
    frames: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-level ROIAlign (the decoder-path DensePose pooler) of one
    (C, H, W) map, or of (N, C, H, W) maps with ``frames``: always K2 (or its
    plain version), as the JAX package's ``roi_align_single`` never reads the
    sparse-pooler switch."""
    levels = torch.zeros((boxes.shape[0],), dtype=torch.int32, device=boxes.device)
    return _roi_align_gather([feat], boxes, levels, [scale], output_size, sampling_ratio,
                             aligned, frames)
