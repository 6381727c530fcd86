"""Fixed-shape non-maximum suppression (port of densepose_tpu/ops/nms.py).

``nms_mask`` and ``batched_nms_mask`` keep the JAX package's contract: boxes
of any number of independent problems (..., K, 4), a validity mask, and a
bool keep mask in the original index space. Each sorts by score (stable,
descending, as ``argsort(-s, stable=True)`` at nms.py:72), runs the keep
kernel on the sorted boxes and scatters the result back.

The keep step is kernel K1 (``csrc/nms.cu``: an IoU bit-matrix launch, then
a scan launch: one warp a problem up to 16384 boxes, one CTA with the
removed set in shared memory past that) for CUDA tensors, at any K whose
IoU scratch (K * mask_words(K) * 8 bytes a problem) the device can hold. For CPU
tensors it is ``nms_keep_plain``, a PyTorch port of the JAX package's
fixed-point iteration (nms.py:81-101): keep[i] = valid[i] and no earlier
kept j has IoU(i, j) > threshold, iterated from keep = valid until it stops
changing, which is exactly the greedy result. Semantics are torchvision's:
(x2-x1)*(y2-y1) areas, a strict '>' threshold, fp32.

``per_class_nms_mask`` is the class-aware NMS of a detector's box stage, R
proposals x C classes, as C problems of R boxes in one K1 call: boxes of
different classes never suppress each other, and within class c the stable
order by (-score, r * C + c) is the stable order by (-score, r), so its keep
mask is ``batched_nms_mask``'s bit for bit. It writes C R^2 bits of IoU
matrix where one problem of R C boxes with a class row writes C^2 R^2.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .boxes import pairwise_iou
from .cuda_build import library

_NEG = -1e30  # effective -inf for invalid scores (as in the JAX package)


def nms_keep_plain(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float,
                   classes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy NMS over score-sorted boxes (P, K, 4) with valid (P, K) and
    optional classes (P, K); returns keep (P, K) bool in sorted order."""
    k = boxes.shape[-2]
    iou = pairwise_iou(boxes, boxes)
    idx = torch.arange(k, device=boxes.device)
    earlier = idx[None, :] < idx[:, None]  # column j precedes row i
    suppress = (iou > iou_threshold) & earlier & valid[..., None, :] & valid[..., :, None]
    if classes is not None:
        suppress &= classes[..., :, None] == classes[..., None, :]
    keep = valid.clone()  # the result never aliases an input (an operator's contract)
    while True:
        new_keep = valid & ~(suppress & keep[..., None, :]).any(dim=-1)
        if torch.equal(new_keep, keep):
            return keep
        keep = new_keep


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """K1's library, built on first use, with its C signatures set once."""
    lib = library("nms")
    lib.dp_nms_mask.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                                        ctypes.c_float, ctypes.c_void_p]
    lib.dp_nms_scan.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                                        ctypes.c_void_p]
    for fn in (lib.dp_nms_mask, lib.dp_nms_scan, lib.dp_nms_max_boxes, lib.dp_nms_max_problems,
               lib.dp_nms_mask_stride):
        fn.restype = ctypes.c_int
    return lib


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def mask_words(k: int) -> int:
    """64-bit words per row of K1's IoU bit-matrix in memory: ceil(K / 64),
    rounded up to even so that the scan's bulk copies are 16-byte aligned."""
    return _lib().dp_nms_mask_stride(k)


def nms_mask_launch(boxes, valid, iou_threshold, classes, mask) -> None:
    """K1's first launch: the IoU bit-matrix of checked inputs into ``mask``
    (P, K, mask_words(K)) int64. Counts no launch."""
    p, k = valid.shape
    with torch.cuda.device(boxes.device):
        _raise_on(_lib().dp_nms_mask(boxes.data_ptr(), valid.data_ptr(),
                                     classes.data_ptr() if classes is not None else None,
                                     mask.data_ptr(), p, k, float(iou_threshold),
                                     _stream(boxes.device)), "K1 mask")


def nms_scan_launch(mask, valid, keep) -> None:
    """K1's second launch: the one-warp scan of ``mask`` into ``keep``.
    Counts no launch."""
    p, k = valid.shape
    with torch.cuda.device(valid.device):
        _raise_on(_lib().dp_nms_scan(mask.data_ptr(), valid.data_ptr(), keep.data_ptr(), p,
                                     k, _stream(valid.device)), "K1 scan")


def nms_keep_cuda(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float,
                  classes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K1 on CUDA tensors: boxes (P, K, 4) f32, valid (P, K) bool,
    classes (P, K) i32 or None, all contiguous on one device. Two kernel
    launches (the IoU bit-matrix into a (P, K, mask_words(K)) int64 scratch,
    then the scan), counted as ONE in ``nms_keep_cuda.launches``: the count is
    of calls. Raises ValueError if the inputs do not fit: K past
    ``dp_nms_max_boxes()`` (what the long scan's shared memory holds), or a
    scratch that the device cannot allocate (the message states its bytes);
    RuntimeError if a launch fails."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (P, K, 4), got {tuple(boxes.shape)}")
    p, k = boxes.shape[0], boxes.shape[1]
    tensors = [("boxes", boxes, torch.float32), ("valid", valid, torch.bool)]
    if classes is not None:
        tensors.append(("classes", classes, torch.int32))
    for name, t, dtype in tensors:
        if not t.is_cuda or t.device != boxes.device:
            raise ValueError(f"{name} must be a CUDA tensor on {boxes.device}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}, got {t.dtype}")
        if tuple(t.shape[:2]) != (p, k):
            raise ValueError(f"{name} must lead with {(p, k)}, got {tuple(t.shape)}")
    lib = _lib()
    if k > lib.dp_nms_max_boxes() or p > lib.dp_nms_max_problems():
        raise ValueError(f"K1 takes at most {lib.dp_nms_max_boxes()} boxes per problem and "
                         f"{lib.dp_nms_max_problems()} problems, got {(p, k)}")
    keep = torch.empty((p, k), dtype=torch.bool, device=boxes.device)
    if p == 0 or k == 0:
        return keep
    nbytes = p * k * mask_words(k) * 8
    try:
        mask = torch.empty((p, k, mask_words(k)), dtype=torch.int64, device=boxes.device)
    except torch.cuda.OutOfMemoryError as e:
        raise ValueError(f"K1's IoU scratch for {p} problems of {k} boxes takes {nbytes} bytes "
                         f"({nbytes / 2**30:.2f} GiB), more than {boxes.device} can "
                         "allocate") from e
    nms_mask_launch(boxes, valid, iou_threshold, classes, mask)
    nms_scan_launch(mask, valid, keep)
    nms_keep_cuda.launches += 1
    return keep


nms_keep_cuda.launches = 0


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float,
             classes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Keep mask of score-sorted (P, K, 4) boxes: K1 for CUDA tensors, the
    plain version for CPU tensors. While ``torch.export`` traces, the call
    goes through the operator ``densepose_tpu_torch::nms_keep``
    (``ops/library.py``); eager calls go to the wrapper directly, which
    costs less host time (PERF.md)."""
    args = (boxes.contiguous(), valid.contiguous(), float(iou_threshold),
            None if classes is None else classes.int().contiguous())
    if torch.compiler.is_exporting():
        return torch.ops.densepose_tpu_torch.nms_keep(*args)
    if boxes.is_cuda:
        return nms_keep_cuda(*args)
    if boxes.device.type != "cpu":
        raise ValueError(f"no NMS kernel for device {boxes.device}")
    return nms_keep_plain(*args)


def _sorted_keep(boxes, scores, valid, iou_threshold, classes=None):
    """Sort each problem by score, run the keep step, scatter back."""
    boxes = boxes.float()
    s = torch.where(valid, scores.float(), torch.full_like(scores, _NEG, dtype=torch.float32))
    order = torch.sort(-s, dim=-1, stable=True).indices
    b = torch.take_along_dim(boxes, order[..., None], dim=-2)
    v = torch.take_along_dim(valid, order, dim=-1)
    c = None if classes is None else torch.take_along_dim(classes, order, dim=-1)
    lead = boxes.shape[:-2]
    k = boxes.shape[-2]
    keep = nms_keep(b.reshape(-1, k, 4), v.reshape(-1, k), iou_threshold,
                    None if c is None else c.reshape(-1, k)).reshape(*lead, k)
    return torch.zeros_like(valid).scatter(-1, order, keep)


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """Greedy NMS of each problem: boxes (..., K, 4), scores and valid
    (..., K). Returns the keep mask (..., K) bool in the original order."""
    return _sorted_keep(boxes, scores, valid, iou_threshold)


def batched_nms_mask(boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor,
                     valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Class-aware NMS (torchvision batched_nms, detectron2/layers/nms.py:9-21):
    boxes of different ``idxs`` never suppress each other."""
    return _sorted_keep(boxes, scores, valid, iou_threshold, classes=idxs)


def per_class_nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                       iou_threshold: float) -> torch.Tensor:
    """Class-aware NMS of R proposals x C classes: boxes (..., R, C, 4),
    scores and valid (..., R, C); keep (..., R, C), equal to
    ``batched_nms_mask`` of the (R * C) flattened pairs with class c, run as
    one problem a class."""
    keep = nms_mask(boxes.transpose(-3, -2), scores.transpose(-2, -1), valid.transpose(-2, -1),
                    iou_threshold)
    return keep.transpose(-2, -1)
