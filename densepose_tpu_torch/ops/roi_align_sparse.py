"""Skip-flag multi-level ROIAlign (kernel K3; port of
densepose_tpu/ops/pallas/roi_align_kernel.py::roi_align_multilevel_sparse).

The same function as K2 (``ops/roi_align.py``), computed through the
separable weights of ``_axis_weights``: for box b at level l,

    out[b, c] = Wy[b] @ feat_l[c] @ Wx[b]^T

with Wy (oh, H_l) and Wx (ow, W_l) rows that sum each bin's ratio bilinear
taps per axis and divide by the ratio. The schedule is the JAX package's:

* boxes are sorted by the fp32 key ``level * 1e7 + clip(x1, 0, 1e6)``
  (stable), so each chunk of ``CHUNK`` sorted boxes clusters on one level and
  a narrow column range;
* per level, the Wx rows of boxes assigned elsewhere are zero;
* the level's columns fall into tiles of ``TILE``; a (chunk, tile) pair is
  active when some Wx entry of the chunk's boxes in that tile is nonzero;
* per box, the output is the sum over the active tiles of its chunk, in
  ascending order, of Wx_tile . (Wy . feat_tile); inactive pairs do no work;
* results return in the caller's box order.

Layouts are the port's: (C, H, W) levels, boxes (M, 4) XYXY in input-image
coordinates, levels (M,) int, output (M, C, oh, ow) in the levels' dtype.
Batched frames, as in ``ops/roi_align.py``: (N, C, H, W) levels and a frame
index (M,) int32. The schedule then sorts by the key (frame, level, x) and
cuts each frame's boxes into chunks of their own, so each box is pooled as
the call on its own frame pools it.

At a half dtype (float16 or bfloat16, TPU.COMPUTE_DTYPE) both versions round
where the Pallas kernel does (roi_align_kernel.py:288, :291, :174-176,
:301): every weight of Wy and Wx to the dtype, each stage-1 row
``Wy . feat`` (summed in fp32) to the dtype; stage 2 and the per-level
partials sum in fp32, and the output is rounded to the dtype once.

For CUDA tensors the pooling is kernel K3 (``csrc/roi_align_sparse.cu``), one
launch per call, every frame's boxes in it: each box contracts only the
nonzero entries of its own rows (``sparse_axis_rows``), so on the card the
sort and the flags would skip nothing, and the kernel has neither. For CPU tensors it is
``roi_align_sparse_plain``, which keeps the JAX schedule: it builds the dense
weight rows and runs the per-(chunk, tile) contraction in PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.timing import span
from .boxes import true_div
from .cuda_build import library
from .roi_align import (DTYPE_CODES, ENTRY_ARGTYPES, _axis_samples, _roi_geometry, call_args,
                        check_cuda_inputs, frame_count, frame_ptr, level_args)

CHUNK = 128  # boxes per chunk (roi_align_kernel.py:155, CHUNK_S)
TILE = 8     # feature columns per tile (roi_align_kernel.py:156, TW_S)
SORT_LEVEL_STRIDE = 1e7
SORT_X_MAX = 1e6


def _axis_weights(start, bin_size, n_bins: int, g: int, limit: int) -> torch.Tensor:
    """Per-box separable ROIAlign weights along one axis: (M, n_bins, limit)
    rows that sum the g sub-samples' bilinear taps and divide by g (port of
    densepose_tpu/ops/roi_align.py:227-242): the gather's taps, border rule
    and edge clamp included, as dense rows. The sub-samples are added in
    order, as the JAX package's sum does; torch's CPU ``sum`` over a
    sub-sample axis of 8 adds in another order."""
    m = start.shape[0]
    lim = torch.full((m,), float(limit), dtype=torch.float32, device=start.device)
    low, high, lerp, ok = _axis_samples(start, bin_size, n_bins, g, lim)
    okf = ok.float()
    w_low = (1.0 - lerp) * okf
    w_high = lerp * okf
    idx = torch.arange(limit, device=start.device)
    one_low = (low[:, :, None] == idx).float()
    one_high = (high[:, :, None] == idx).float()
    w = (w_low[:, :, None] * one_low + w_high[:, :, None] * one_high).reshape(m, n_bins, g, limit)
    total = w[:, :, 0]
    for i in range(1, g):
        total = total + w[:, :, i]
    return true_div(total, g)


def sparse_axis_rows(start, bin_size, n_bins: int, g: int, limit: int):
    """The nonzero entries of ``_axis_weights``'s rows, as K3 builds its
    tables: per box and bin, the distinct columns with a nonzero weight in
    ascending order, each weighing (the sum over sub-samples i, in order, of
    1 - lerp_i where low_i is the column plus lerp_i where high_i is, for
    in-border samples) / g. Returns columns (M, n_bins, 2g) int64, -1 past
    the count; weights (M, n_bins, 2g) float32, 0 past the count; and the
    counts (M, n_bins). Scattered into dense rows, the weights equal
    ``_axis_weights`` bit for bit."""
    m = start.shape[0]
    lim = torch.full((m,), float(limit), dtype=torch.float32, device=start.device)
    low, high, lerp, ok = (t.reshape(m, n_bins, g)
                           for t in _axis_samples(start, bin_size, n_bins, g, lim))
    # a lower tap always weighs 1 - lerp > 0; an upper one only if lerp > 0
    cand = torch.cat([torch.where(ok, low, limit),
                      torch.where(ok & (lerp != 0), high, limit)], dim=2).sort(dim=2).values
    dup = torch.zeros_like(cand, dtype=torch.bool)
    dup[..., 1:] = cand[..., 1:] == cand[..., :-1]
    cols = torch.where(dup, limit, cand).sort(dim=2).values
    valid = cols < limit
    total = torch.zeros(cols.shape, dtype=torch.float32, device=start.device)
    for i in range(g):
        lo_i, hi_i, lerp_i, ok_i = (t[..., i:i + 1] for t in (low, high, lerp, ok))
        term = torch.where(ok_i & (lo_i == cols), 1.0 - lerp_i, 0.0)
        term = torch.where(ok_i & (hi_i == cols), term + lerp_i, term)
        total = total + term
    weights = torch.where(valid, true_div(total, g), 0.0)
    return torch.where(valid, cols, -1), weights, valid.sum(dim=2)


def sort_order(boxes: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """The schedule's box order: a stable argsort of the fp32 key
    ``level * 1e7 + clip(x1, 0, 1e6)`` (roi_align_kernel.py:265-266)."""
    key = levels.float() * SORT_LEVEL_STRIDE + boxes[:, 0].float().clamp(0.0, SORT_X_MAX)
    return torch.argsort(key, stable=True)


class SparseSchedule(NamedTuple):
    order: torch.Tensor        # (M,) sorted position -> caller index
    inv: torch.Tensor          # (M,) caller index -> sorted position
    wy: List[torch.Tensor]     # per level (Mp, oh, H) f32 of levels'-dtype values, sorted boxes
    wx: List[torch.Tensor]     # per level (Mp, ow, W), as wy; other levels' rows zero
    flags: List[torch.Tensor]  # per level (Mp / CHUNK, ceil(W / TILE)) int32


def sparse_schedule(
    feats: List[torch.Tensor],
    boxes: torch.Tensor,
    levels: torch.Tensor,
    scales: Sequence[float],
    output_size: Tuple[int, int],
    sampling_ratio: int,
    aligned: bool,
) -> SparseSchedule:
    """The JAX package's host-side schedule (roi_align_kernel.py:256-301):
    order and inverse, per-level weight rows padded to whole chunks and
    rounded to the levels' dtype (held in float32), and the activity flags
    from the rounded ``Wx != 0`` over each (chunk, tile)."""
    out_h, out_w = output_size
    dtype = feats[0].dtype
    m = boxes.shape[0]
    mp = -(-m // CHUNK) * CHUNK
    dev = boxes.device
    order = sort_order(boxes, levels)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(m, device=dev)
    b_s = boxes.float()[order]
    lv_s = levels.long()[order]
    wys, wxs, flags = [], [], []
    for li, (feat, scale) in enumerate(zip(feats, scales)):
        h, w = feat.shape[1], feat.shape[2]
        scale_b = torch.full((m,), float(scale), dtype=torch.float32, device=dev)
        start_h, bin_h, start_w, bin_w = _roi_geometry(b_s, scale_b, output_size, aligned)
        wy = _axis_weights(start_h, bin_h, out_h, sampling_ratio, h)
        wx = _axis_weights(start_w, bin_w, out_w, sampling_ratio, w)
        wx = (wx * (lv_s == li).float()[:, None, None]).to(dtype).float()
        wy = wy.to(dtype).float()
        wy = torch.cat([wy, wy.new_zeros((mp - m, out_h, h))])
        wx = torch.cat([wx, wx.new_zeros((mp - m, out_w, w))])
        tiles = -(-w // TILE)
        nz = torch.nn.functional.pad(wx != 0, (0, tiles * TILE - w))
        flags.append(nz.reshape(mp // CHUNK, CHUNK, out_w, tiles, TILE)
                     .any(dim=4).any(dim=2).any(dim=1).int())
        wys.append(wy)
        wxs.append(wx)
    return SparseSchedule(order, inv, wys, wxs, flags)


def roi_align_sparse_plain(
    feats: List[torch.Tensor],
    boxes: torch.Tensor,
    levels: torch.Tensor,
    scales: Sequence[float],
    output_size: Tuple[int, int],
    sampling_ratio: int,
    aligned: bool,
    frames: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version of K3: per level and active (chunk, tile)
    pair, rows = Wy . feat_tile in fp32, rounded to the levels' dtype, then
    out += Wx_tile . rows in fp32; inactive pairs are skipped. Returns
    (M, C, oh, ow) in the caller's order, rounded to the levels' dtype.
    With (N, C, H, W) levels and ``frames``, frame by frame (the sort key
    (frame, level, x), each frame's boxes in chunks of their own), reading
    the frame index on the host."""
    n = frame_count(feats, frames)
    feats = [f if f.dim() == 4 else f[None] for f in feats]
    if frames is None:
        return _sparse_plain_frame([f[0] for f in feats], boxes, levels, scales, output_size,
                                   sampling_ratio, aligned)
    fr = frames.long().cpu()
    if len(fr) and not 0 <= int(fr.min()) <= int(fr.max()) < n:
        raise ValueError(f"a frame index outside [0, {n})")
    out = torch.empty((boxes.shape[0], feats[0].shape[1], *output_size),
                      dtype=feats[0].dtype, device=boxes.device)
    for i in range(n):
        sel = (fr == i).nonzero()[:, 0].to(boxes.device)
        if len(sel):
            out[sel] = _sparse_plain_frame([f[i] for f in feats], boxes[sel], levels[sel],
                                           scales, output_size, sampling_ratio, aligned)
    return out


def _sparse_plain_frame(feats, boxes, levels, scales, output_size, sampling_ratio, aligned):
    """``roi_align_sparse_plain`` of one frame's (C, H, W) levels."""
    out_h, out_w = output_size
    m = boxes.shape[0]
    c = feats[0].shape[0]
    sched = sparse_schedule(feats, boxes, levels, scales, output_size, sampling_ratio,
                            aligned)
    mp = -(-m // CHUNK) * CHUNK
    out = torch.zeros((mp, c, out_h, out_w), dtype=torch.float32, device=boxes.device)
    for feat, wy, wx, flags in zip(feats, sched.wy, sched.wx, sched.flags):
        f = feat.float()
        for k, t in flags.nonzero().tolist():
            rows = slice(k * CHUNK, (k + 1) * CHUNK)
            cols = slice(t * TILE, (t + 1) * TILE)
            tile_rows = torch.einsum("byh,chw->bcyw", wy[rows], f[:, :, cols])
            tile_rows = tile_rows.to(feat.dtype).float()
            out[rows] += torch.einsum("bcyw,bxw->bcyx", tile_rows, wx[rows, :, cols])
    return out[:m][sched.inv].to(feats[0].dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """K3's library, built on first use, with its C signature set once."""
    lib = library("roi_align_sparse")
    lib.dp_roi_align_sparse.argtypes = ENTRY_ARGTYPES
    for fn in (lib.dp_roi_align_sparse, lib.dp_roi_align_sparse_max_levels,
               lib.dp_roi_align_sparse_max_ratio):
        fn.restype = ctypes.c_int
    return lib


def roi_align_sparse_cuda(
    feats: List[torch.Tensor],
    boxes: torch.Tensor,
    levels: torch.Tensor,
    scales: Sequence[float],
    output_size: Tuple[int, int],
    sampling_ratio: int,
    aligned: bool,
    frames: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel K3 on CUDA tensors, in one launch: feats per level (C, H, W),
    or (N, C, H, W) with ``frames`` (M,) i32, contiguous, all float32,
    float16 or bfloat16; boxes (M, 4) f32, levels (M,) i32, all on one
    device. Returns (M, C, oh, ow) in the levels' dtype, in the caller's
    order; a box whose level is not in [0, len(feats)), or whose frame is
    not in [0, N), gets zeros. No sort and no flag table: on the card the
    flags skip nothing (``csrc/roi_align_sparse.cu``). Raises if the inputs
    do not fit or the launch fails."""
    with span("roi_align_sparse"):
        n_frames = check_cuda_inputs(feats, boxes, levels, scales, frames)
        lib = _lib()
        if len(feats) > lib.dp_roi_align_sparse_max_levels():
            raise ValueError(f"K3 takes at most {lib.dp_roi_align_sparse_max_levels()} levels")
        if not 0 < sampling_ratio <= lib.dp_roi_align_sparse_max_ratio():
            raise ValueError(f"K3 takes a fixed sampling_ratio in 1.."
                             f"{lib.dp_roi_align_sparse_max_ratio()}, got {sampling_ratio}")
        m, c = boxes.shape[0], feats[0].shape[-3]
        oh, ow = output_size
        out = torch.empty((m, c, oh, ow), dtype=feats[0].dtype, device=boxes.device)
        if out.numel() == 0:
            return out
        with torch.cuda.device(boxes.device):
            stream = torch.cuda.current_stream(boxes.device).cuda_stream
            err = lib.dp_roi_align_sparse(*level_args(feats, scales), boxes.data_ptr(),
                                          levels.data_ptr(), frame_ptr(frames), out.data_ptr(),
                                          n_frames, m, c, oh, ow, int(sampling_ratio),
                                          int(bool(aligned)), DTYPE_CODES[out.dtype], stream)
        if err != 0:
            raise RuntimeError(f"roi_align_sparse_cuda launch failed: cudaError {err}")
        roi_align_sparse_cuda.launches += 1
        return out


roi_align_sparse_cuda.launches = 0


def roi_align_sparse(
    feats: List[torch.Tensor],
    boxes: torch.Tensor,
    levels: torch.Tensor,
    scales: Sequence[float],
    output_size: Tuple[int, int],
    sampling_ratio: int,
    aligned: bool,
    frames: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The skip-flag pooler: K3 for CUDA tensors, its plain version for CPU
    tensors; while ``torch.export`` traces, through the operator
    ``densepose_tpu_torch::roi_align_sparse`` (``ops/library.py``). Returns
    (M, C, oh, ow) in the levels' dtype; ``frames`` as in
    ``roi_align_multilevel``."""
    if sampling_ratio <= 0:
        raise ValueError("the skip-flag pooler takes a fixed sampling_ratio > 0, as the JAX "
                         "package's does; ratio 0 takes the gather (roi_align_multilevel)")
    args = call_args(feats, boxes, levels, scales, output_size, sampling_ratio, aligned,
                     frames)
    if torch.compiler.is_exporting():
        return torch.ops.densepose_tpu_torch.roi_align_sparse(*args)
    if boxes.is_cuda:
        return roi_align_sparse_cuda(*args)
    if boxes.device.type != "cpu":
        raise ValueError(f"no ROIAlign kernel for device {boxes.device}")
    return roi_align_sparse_plain(*args)
