"""Row slabs of one frame and their halo exchange: the part of the JAX
package's ``spatial_parallel_forward`` (densepose_tpu/parallel/mesh.py) that
GSPMD writes there, as the collective-permutes of its partitioned
convolutions.

A map of the frame (N = 1) is cut along its rows into one slab per shard,
each on its shard's device (``RowSlabs``): shard i owns the global rows
``[b[i], b[i+1])`` of the map at its level. The input's boundaries are whole
blocks of the size divisibility (``row_bounds``), so a level at stride s has
the boundaries ``b / s`` down to the padding's stride; below it (FPN's p6) a
strided op starts a slab at its first output row, ``ceil(b / s)``. A shard may
own no rows at a level, and is then skipped there.

Before every operation that reads rows of its neighbours (a convolution with
a kernel taller than its stride, a pool, a bilinear upsample) each shard
assembles the input rows its output rows read (``fetch_rows``): its own, and
the halo rows of whichever shards own them (more than one where the slabs
are thinner than the halo), copied to its device on the current streams (a
copy between devices orders itself on both devices' current streams); rows
past the image's true edges are the operation's padding (zeros, or -inf for a
max pool) or, for the bilinear upsample, not read at all (its source rows
clamp at the edge). Each primitive computes, on every slab, the same
arithmetic as the operation on the whole map (``conv_rows``, ``link_rows``,
``max_pool_rows``, ``avg_pool_rows``, ``upsample_nearest_rows``,
``upsample_bilinear_rows``, ``subsample_rows``); the result equals the whole
map's rows where the backend picks the same algorithm for a slab as for the
whole (the CPU with oneDNN off; cuDNN picks by shape).

``Shards`` holds the device list, the model's replica on each distinct
device (a device listed twice holds two shards and one replica) and the
``HaloStats`` of the copies; a sharded walk names the modules and tensors of
the model it mirrors, and each shard runs the same-named one of its replica.
"""

from __future__ import annotations

import copy
import math
from itertools import chain
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv_int8 import link
from ..ops.resize import source_rows


def device_key(d: torch.device):
    """A device as (type, index), "cuda" resolved to the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return ("cuda", torch.cuda.current_device())
    return (d.type, d.index)


def row_bounds(height: int, block: int, n: int) -> List[int]:
    """The global row boundaries b[0..n] of ``n`` shards of a ``height``-row
    input cut into blocks of ``block`` rows, dealt as evenly as possible,
    the earlier shards taking the extra blocks (a shard may take none)."""
    if height % block:
        raise ValueError(f"{height} rows are not whole blocks of {block}")
    q, r = divmod(height // block, n)
    bounds = [0]
    for i in range(n):
        bounds.append(bounds[-1] + (q + (i < r)) * block)
    return bounds


class HaloStats:
    """What the exchanges moved: halo pieces drawn from another shard and
    their bytes; the rows of shards other than the first gathered onto it
    (pieces and bytes); and each gathered level's row boundaries."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.halo_copies = self.halo_bytes = 0
        self.gather_copies = self.gather_bytes = 0
        self.levels: Dict[str, List[int]] = {}

    def as_dict(self) -> Dict:
        return {"halo_copies": self.halo_copies, "halo_bytes": self.halo_bytes,
                "gather_copies": self.gather_copies, "gather_bytes": self.gather_bytes,
                "levels": dict(self.levels)}


class Shards:
    """The shards of a row-sharded forward: one a listed device, and the
    model's replica on each distinct device (``model`` itself where it lies,
    else a copy of it as it is now: make a new ``Shards`` after its state
    changes, an int8 calibration)."""

    def __init__(self, model: nn.Module, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a row-sharded forward needs at least one device")
        self.model = model
        self.stats = HaloStats()
        home = device_key(next(iter(model.parameters())).device)
        by_device = {}
        for d in self.devices:
            key = device_key(d)
            if key not in by_device:
                by_device[key] = model if key == home else copy.deepcopy(model).to(d).eval()
        self.replicas = [by_device[device_key(d)] for d in self.devices]
        self._module_names = {id(m): n for n, m in model.named_modules()}
        self._tensor_names = {id(t): n for n, t in chain(model.named_parameters(),
                                                         model.named_buffers())}
        self._modules = {id(r): dict(r.named_modules()) for r in by_device.values()}
        self._tensors = {id(r): dict(chain(r.named_parameters(), r.named_buffers()))
                         for r in by_device.values()}

    def __len__(self) -> int:
        return len(self.devices)

    def module(self, m: nn.Module, i: int) -> nn.Module:
        """``m`` of the model, as shard ``i``'s replica holds it."""
        r = self.replicas[i]
        return m if r is self.model else self._modules[id(r)][self._module_names[id(m)]]

    def tensor(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """A parameter or buffer of the model (an int8 scale), as shard
        ``i``'s replica holds it."""
        r = self.replicas[i]
        return t if r is self.model else self._tensors[id(r)][self._tensor_names[id(t)]]


class RowSlabs:
    """One map of a frame as row slabs: ``parts[i]`` (None where shard i
    owns no rows) holds the global rows ``[bounds[i], bounds[i+1])`` along
    ``row_dim`` (2 for NCHW, 1 for a chain's NHWC s8) on shard i's device."""

    def __init__(self, parts: List[Optional[torch.Tensor]], bounds: List[int], shards: Shards,
                 row_dim: int = 2):
        if len(parts) != len(shards) or len(bounds) != len(parts) + 1:
            raise ValueError(f"{len(parts)} slabs and {len(bounds)} boundaries for "
                             f"{len(shards)} shards")
        for i, p in enumerate(parts):
            rows = bounds[i + 1] - bounds[i]
            if (p is None) != (rows == 0) or (p is not None and p.shape[row_dim] != rows):
                raise ValueError(f"slab {i}: {None if p is None else tuple(p.shape)} for "
                                 f"rows [{bounds[i]}, {bounds[i + 1]})")
        self.parts, self.bounds, self.shards, self.row_dim = list(parts), list(bounds), shards, \
            row_dim

    @property
    def height(self) -> int:
        return self.bounds[-1]

    def template(self) -> torch.Tensor:
        """A slab (the first one with rows): its shape past the rows, dtype."""
        return next(p for p in self.parts if p is not None)

    @property
    def dtype(self) -> torch.dtype:
        return self.template().dtype

    def map(self, fn: Callable, *args, row_dim: Optional[int] = None) -> "RowSlabs":
        """A row-local operation on every slab: ``fn(slab, *args)``, where a
        ``RowSlabs`` argument gives the same shard's slab (its boundaries
        must be these) and a tensor argument (a parameter or buffer of the
        model) the shard's replica's; ``row_dim``: the result's, if the
        operation moves the rows."""
        for a in args:
            if isinstance(a, RowSlabs) and a.bounds != self.bounds:
                raise ValueError(f"row boundaries {a.bounds} against {self.bounds}")
        parts = []
        for i, x in enumerate(self.parts):
            if x is None:
                parts.append(None)
                continue
            local = [a.parts[i] if isinstance(a, RowSlabs) else
                     self.shards.tensor(a, i) if isinstance(a, torch.Tensor) else a for a in args]
            parts.append(fn(x, *local))
        return RowSlabs(parts, self.bounds, self.shards,
                        self.row_dim if row_dim is None else row_dim)


def fetch_rows(slabs: RowSlabs, a: int, b: int, device, shard: Optional[int] = None,
               fill: Optional[float] = None) -> torch.Tensor:
    """Global rows ``[a, b)`` of ``slabs`` on ``device``, assembled from the
    shards that own them; rows outside ``[0, height)`` are ``fill`` (an
    error where None). The pieces of shards other than ``shard`` (the one
    asking) count as halo copies. One piece of the asking shard's own rows is
    returned as a view, without a copy."""
    h, dim = slabs.height, slabs.row_dim
    if a < 0 or b > h:
        if fill is None:
            raise ValueError(f"rows [{a}, {b}) reach past the map's {h} rows")
    like = slabs.template()

    def filled(rows):
        shape = list(like.shape)
        shape[dim] = rows
        return torch.full(shape, fill, dtype=like.dtype, device=device)

    pieces = [filled(-a)] if a < 0 else []
    stats = slabs.shards.stats
    for j, part in enumerate(slabs.parts):
        lo, hi = max(a, slabs.bounds[j]), min(b, slabs.bounds[j + 1])
        if part is None or lo >= hi:
            continue
        piece = part.narrow(dim, lo - slabs.bounds[j], hi - lo)
        if j != shard:
            stats.halo_copies += 1
            stats.halo_bytes += piece.numel() * piece.element_size()
        pieces.append(piece.to(device))
    if b > h:
        pieces.append(filled(b - h))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)


def window_rows(slabs: RowSlabs, k: int, s: int, p: int, d: int, op: Callable,
                fill: float = 0.0) -> RowSlabs:
    """A sliding-window operation along the rows (kernel ``k``, stride
    ``s``, row padding ``p``, dilation ``d``) on every slab: shard i's
    output rows are ``[ceil(b_i / s), ceil(b_(i+1) / s))``, read from the
    input rows ``[o0 s - p, (o1 - 1) s - p + d (k - 1) + 1)`` with rows past
    the true edges ``fill``; ``op(i, rows)`` computes them with row padding
    0."""
    out_h = (slabs.height + 2 * p - d * (k - 1) - 1) // s + 1
    bounds = [min(-(-b // s), out_h) for b in slabs.bounds[:-1]] + [out_h]
    parts = []
    for i, dev in enumerate(slabs.shards.devices):
        o0, o1 = bounds[i], bounds[i + 1]
        if o1 <= o0:
            parts.append(None)
            continue
        rows = fetch_rows(slabs, o0 * s - p, (o1 - 1) * s - p + d * (k - 1) + 1, dev, i, fill)
        parts.append(op(i, rows))
    return RowSlabs(parts, bounds, slabs.shards, slabs.row_dim)


def conv_rows(conv: nn.Conv2d, slabs: RowSlabs) -> RowSlabs:
    """``conv`` (an ``nn.Conv2d`` of the model: groups, dilation and bias
    as it has them, and the FrozenBN of an unfolded ``conv_bn``, which is
    pointwise) on NCHW slabs."""
    (k, _), (s, sw), (p, pw), (d, dw) = conv.kernel_size, conv.stride, conv.padding, \
        conv.dilation

    def op(i, x):
        m = slabs.shards.module(conv, i)
        y = F.conv2d(x, m.weight, m.bias, (s, sw), (0, pw), (d, dw), m.groups)
        return m.norm(y) if hasattr(m, "norm") else y

    return window_rows(slabs, k, s, p, d, op)


def link_rows(conv: nn.Conv2d, slabs: RowSlabs, s_in: torch.Tensor,
              out_scale: Optional[torch.Tensor] = None, relu: bool = False,
              out_dtype: Optional[torch.dtype] = None) -> RowSlabs:
    """``ops/conv_int8.py::link`` of ``conv`` on NHWC s8 slabs at scale
    ``s_in`` (kernel Q1 on halo-extended slabs, row padding 0; the
    activation scales are static, so the requantization is row-local)."""
    (k, _), (s, _), (p, pw), (d, _) = conv.kernel_size, conv.stride, conv.padding, conv.dilation
    sh = slabs.shards

    def op(i, q):
        return link(sh.module(conv, i), q, sh.tensor(s_in, i),
                    None if out_scale is None else sh.tensor(out_scale, i), relu=relu,
                    out_dtype=out_dtype, padding=(0, pw))

    return window_rows(slabs, k, s, p, d, op)


def max_pool_rows(slabs: RowSlabs, k: int, s: int, p: int) -> RowSlabs:
    """``F.max_pool2d(x, k, s, p)``: the rows past the true edges are -inf,
    as the pool's own padding."""
    return window_rows(slabs, k, s, p, 1, lambda i, x: F.max_pool2d(x, k, s, padding=(0, p)),
                       fill=-math.inf)


def avg_pool_rows(slabs: RowSlabs, k: int) -> RowSlabs:
    """``F.avg_pool2d(x, k)`` (stride ``k``, no padding)."""
    return window_rows(slabs, k, k, 0, 1, lambda i, x: F.avg_pool2d(x, k))


def upsample_nearest_rows(slabs: RowSlabs, scale: int) -> RowSlabs:
    """``F.interpolate(x, scale_factor=scale, mode="nearest")``, an integer
    ``scale``: row-local, the boundaries times ``scale``."""
    parts = [None if x is None else F.interpolate(x, scale_factor=float(scale), mode="nearest")
             for x in slabs.parts]
    return RowSlabs(parts, [b * scale for b in slabs.bounds], slabs.shards, slabs.row_dim)


def upsample_bilinear_rows(slabs: RowSlabs, scale: int) -> RowSlabs:
    """``F.interpolate(x, scale_factor=scale, mode="bilinear",
    align_corners=False)`` (``ops/resize.py::resize_bilinear`` with a
    scale), an integer ``scale``: each shard reads the source rows
    ``source_rows`` gives for its output rows (clamped at the image's edges,
    never padded) and upsamples them alone. The source coordinate of a row
    is (dst + 0.5) / scale - 0.5, exact in float for a power-of-two scale, so
    a window starting at source row ``lo`` computes output row ``lo * scale
    + j`` with the whole map's taps and weights."""
    h = slabs.height
    bounds = [b * scale for b in slabs.bounds]
    parts = []
    for i, dev in enumerate(slabs.shards.devices):
        o0, o1 = bounds[i], bounds[i + 1]
        if o1 <= o0:
            parts.append(None)
            continue
        lo, hi = source_rows(h, h * scale, float(scale), o0, o1)
        y = F.interpolate(fetch_rows(slabs, lo, hi, dev, i), scale_factor=float(scale),
                          mode="bilinear", align_corners=False)
        parts.append(y.narrow(2, o0 - lo * scale, o1 - o0))
    return RowSlabs(parts, bounds, slabs.shards, slabs.row_dim)


def subsample_rows(slabs: RowSlabs) -> RowSlabs:
    """``x[:, :, ::2, ::2]`` (FPN's p6): shard i keeps the even global rows
    it owns, so a slab that starts on an odd row starts at the next one."""
    bounds = [-(-b // 2) for b in slabs.bounds]
    parts = [None if x is None or bounds[i + 1] <= bounds[i] else
             x[:, :, 2 * bounds[i] - slabs.bounds[i]::2, ::2]
             for i, x in enumerate(slabs.parts)]
    return RowSlabs(parts, bounds, slabs.shards, slabs.row_dim)


def gather(slabs: RowSlabs, device, name: Optional[str] = None) -> torch.Tensor:
    """The whole map on ``device``: every slab copied there, in row order.
    The rows of shards other than the first count as gathered bytes;
    ``name`` records the level's boundaries in the stats."""
    stats = slabs.shards.stats
    pieces = []
    for i, x in enumerate(slabs.parts):
        if x is None:
            continue
        if i:
            stats.gather_copies += 1
            stats.gather_bytes += x.numel() * x.element_size()
        pieces.append(x.to(device))
    if name is not None:
        stats.levels[name] = list(slabs.bounds)
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, slabs.row_dim)
