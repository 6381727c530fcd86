"""Test-time augmentation, multi-scale + horizontal flip (port of
densepose_tpu/tta.py).

``TTAPredictor(base)`` serves the config's ``TEST.AUG`` views with the base
predictor's model:

* stage 1 (detection) on every view: each ``MIN_SIZES`` scale of the frame
  and, with ``FLIP``, of the frame mirrored on the device; a flipped view's
  boxes go back to the frame's coordinates as x -> W - x;
* every view's detections merged by class-aware NMS at the box stage's test
  threshold (kernel K1 with classes) and cut to the best
  ``TEST.DETECTIONS_PER_IMAGE`` (``merge_detections``);
* stage 2 (DensePose) on the merged boxes in every view's coordinates, and
  the views' maps averaged in fp32 (``StreamingReduce``): plain views give
  every map; flipped views give their segmentation mirrored and part-permuted
  (``unflip_chart_segm``) and, only with the continuous U/V symmetry tables
  (``TPU.UV_SYMMETRY_PATH``, ``load_uv_symmetry``), their U/V
  (``unflip_chart_uv``). A CSE model's flipped views give detections only:
  an embedding has no left/right permutation, so, as in the JAX package,
  its maps are the plain views' average.

The reduce keeps two running sums (plain views, flipped views) and frees
each view's maps as it adds them, in the JAX package's summation order, so
its result is the JAX list form's bit for bit while it holds two views' maps
in place of all of them (a flagship view's maps are 100 x 77 x 112 x 112
fp32, 386 MB). Maps are NCHW (D, C, H, W): the mirror is along the last
axis, the part permutation along axis 1. ``TPU.DEVICE_POSTPROCESS`` does not
apply under TTA, as in the JAX package.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .models.rcnn import image_tensor
from .ops.boxes import true_div
from .ops.nms import batched_nms_mask
from .utils.timing import span

_NEG = -1e30

# The DensePose 24-part left/right symmetry (parts are 1-indexed; torso
# front/back 1-2 map to themselves, every later left/right pair is adjacent):
# the Index_Symmetry_List of the DensePose-COCO tooling, a fixed involution.
PART_SYMMETRY = (1, 2, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13,
                 16, 15, 18, 17, 20, 19, 22, 21, 24, 23)
# as a 25-channel permutation of the fine segmentation (channel 0 background)
FINE_SEGM_PERM = (0,) + PART_SYMMETRY
# the legacy 15-channel coarse segmentation (background + 14 coarse parts in
# the DensePose chart order: 1 torso, 2/3 right/left hand, 4/5 left/right
# foot, 6/7 and 8/9 upper and lower legs right/left, 10/11 and 12/13 upper
# and lower arms left/right, 14 head): its left/right involution
COARSE_SEGM_PERM_15 = (0, 1, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10, 13, 12, 14)

_SEGM = ("pred_densepose_coarse_segm", "pred_densepose_fine_segm")
_UV = ("pred_densepose_u", "pred_densepose_v")


def load_uv_symmetry(source) -> Dict[str, np.ndarray]:
    """The continuous U/V left/right symmetry tables of the DensePose tooling
    (``densepose_UV_symmetry_transforms.mat``): 24 per-part (256, 256) tables
    indexed [v_bin, u_bin] under ``U_transforms`` and ``V_transforms``.

    Accepts a ``.mat`` path (scipy's cell layout, a (1, 24) object array, or
    a dense (24, 256, 256) array), an ``.npz`` path with dense arrays under
    the same keys, or a loaded mapping. Returns ``{"U_transforms": (24, 256,
    256) float32, "V_transforms": ...}``; raises ValueError on a missing key
    or another shape."""
    if isinstance(source, str):
        if source.endswith(".mat"):
            from scipy.io import loadmat
            source = loadmat(source)
        else:
            with np.load(source, allow_pickle=False) as f:
                source = dict(f)
    out = {}
    for key in ("U_transforms", "V_transforms"):
        if key not in source:
            raise ValueError(f"UV symmetry data lacks {key!r}")
        t = source[key]
        if isinstance(t, np.ndarray) and t.dtype == object:
            t = np.stack([np.asarray(t.reshape(-1)[i], np.float32) for i in range(t.size)])
        t = np.asarray(t, np.float32)
        if t.shape != (24, 256, 256):
            raise ValueError(f"{key}: expected (24, 256, 256), got {t.shape}")
        out[key] = t
    return out


def unflip_chart_segm(coarse_segm: torch.Tensor, fine_segm: torch.Tensor):
    """Segmentation maps (N, C, H, W) of a mirrored view back to the frame's
    orientation: mirrored along W, the fine parts permuted by
    ``PART_SYMMETRY``, a 15-channel coarse map by ``COARSE_SEGM_PERM_15`` (a
    2-channel one needs no permutation)."""
    nc = coarse_segm.shape[1]
    if nc not in (2, 15):
        raise ValueError(f"coarse segmentation of {nc} channels: expected 2 or 15")
    cs = coarse_segm.flip(-1)
    if nc == 15:
        cs = cs[:, list(COARSE_SEGM_PERM_15)]
    fs = fine_segm.flip(-1)[:, list(FINE_SEGM_PERM)]
    return cs, fs


def unflip_chart_uv(u: torch.Tensor, v: torch.Tensor, u_tab: torch.Tensor,
                    v_tab: torch.Tensor):
    """U/V maps (N, 25, H, W) of a mirrored view back to the frame's
    orientation with the symmetry tables ((24, 256, 256), [part - 1, v_bin,
    u_bin]): the DensePose ground-truth flip lifted to dense maps. Output
    channel q takes the table values of input channel sym(q), at bins
    floor(clip(x, 0, 1) * 255) in fp32; channel 0 (background) only mirrors."""
    u, v = u.flip(-1), v.flip(-1)
    ub = torch.floor(u[:, 1:].clamp(0.0, 1.0) * 255.0).long()
    vb = torch.floor(v[:, 1:].clamp(0.0, 1.0) * 255.0).long()
    part = torch.arange(24, device=u.device)[None, :, None, None]
    perm = [p - 1 for p in PART_SYMMETRY]
    nu = u_tab[part, vb, ub][:, perm]
    nv = v_tab[part, vb, ub][:, perm]
    return torch.cat([u[:, :1], nu], 1), torch.cat([v[:, :1], nv], 1)


def merge_detections(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
                     valid: torch.Tensor, nms_thresh: float, topk: int):
    """Class-aware NMS over the views' detections (K1 with classes on the
    card), then the ``topk`` best by score, ties in index order (the JAX
    package's ``argsort(-s, stable=True)``). Returns (boxes, scores,
    classes, valid) of ``topk`` slots."""
    keep = batched_nms_mask(boxes, scores, classes, valid, nms_thresh)
    s = torch.where(keep, scores.float(), torch.full_like(scores, _NEG, dtype=torch.float32))
    order = torch.sort(-s, stable=True).indices[:topk]
    return boxes[order], scores[order], classes[order], keep[order] & valid[order]


class StreamingReduce:
    """The JAX package's ``reduce_pred_densepose`` fed one view at a time:
    plain views' maps summed in fp32 in view order, flipped views' unflipped
    segmentation (and, with ``uv_tables``, U/V) in a sum of their own, the two
    added and divided at the end, so each view's maps can go as soon as they
    are added."""

    def __init__(self, uv_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        self.uv_tables = uv_tables
        self.plain: Dict[str, torch.Tensor] = {}
        self.flip: Dict[str, torch.Tensor] = {}
        self.n_plain = self.n_flip = 0

    @staticmethod
    def _add(acc: Dict[str, torch.Tensor], maps: Dict[str, torch.Tensor]) -> None:
        for k, v in maps.items():
            if k in acc:
                acc[k].add_(v.float())
            else:
                acc[k] = v.to(torch.float32, copy=True)

    def add(self, dp: Dict[str, torch.Tensor], flipped: bool) -> None:
        if not flipped:
            self._add(self.plain, dp)
            self.n_plain += 1
            return
        maps = dict(zip(_SEGM, unflip_chart_segm(*(dp[k].float() for k in _SEGM))))
        if self.uv_tables is not None:
            maps.update(zip(_UV, unflip_chart_uv(*(dp[k].float() for k in _UV),
                                                 *self.uv_tables)))
        self._add(self.flip, maps)
        self.n_flip += 1

    def result(self) -> Dict[str, torch.Tensor]:
        out = {k: true_div(v, self.n_plain) for k, v in self.plain.items()}
        n_all = float(self.n_plain + self.n_flip)
        for k, v in self.flip.items():
            out[k] = true_div(self.plain[k] + v, n_all)
        return out


class TTAPredictor:
    """A ``DensePosePredictor`` with the config's ``TEST.AUG`` multi-scale and
    flip views. ``__call__(image)`` returns the device outputs, fixed-size
    slots + num_instances, the maps in fp32 at every compute dtype;
    ``predict_numpy``, ``numpy_outputs``, ``stage_input`` and ``start_fetch``
    are the base predictor's, so ``parallel/pipeline.py::stream`` runs it
    unchanged."""

    def __init__(self, base, uv_symmetry=None):
        self.base = base
        self.cfg = cfg = base.cfg
        aug = cfg.TEST.AUG
        self.min_sizes: List[int] = [int(s) for s in aug.MIN_SIZES]
        self.max_size = int(aug.MAX_SIZE)
        self.flip = bool(aug.FLIP)
        self.nms_thresh = float(cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST)
        self.topk = int(cfg.TEST.DETECTIONS_PER_IMAGE)
        self.densepose_on = bool(cfg.MODEL.DENSEPOSE_ON)
        head = cfg.MODEL.ROI_DENSEPOSE_HEAD
        # flipped views give segmentation evidence to chart predictors with a
        # 2- or 15-channel coarse segmentation (JAX tta.py:219-224)
        self.flip_segm = (self.densepose_on and self.flip
                          and head.PREDICTOR_NAME in ("DensePoseChartPredictor",
                                                      "DensePoseChartWithConfidencePredictor")
                          and head.NUM_COARSE_SEGM_CHANNELS in (2, 15))
        if uv_symmetry is None:
            uv_symmetry = cfg.TPU.UV_SYMMETRY_PATH or None
        self.uv_tables = None
        if uv_symmetry is not None and not self.flip_segm:
            warnings.warn("uv_symmetry tables supplied but flipped views cannot contribute "
                          "(TEST.AUG.FLIP off, non-chart predictor, or unsupported "
                          "NUM_COARSE_SEGM_CHANNELS): tables ignored.", stacklevel=2)
        elif uv_symmetry is not None:
            t = load_uv_symmetry(uv_symmetry)
            self.uv_tables = tuple(torch.from_numpy(t[k]).to(base.device)
                                   for k in ("U_transforms", "V_transforms"))

    def stage_input(self, image_bgr_u8):
        return self.base.stage_input(image_bgr_u8)

    def start_fetch(self, outputs, keys=None) -> None:
        self.base.start_fetch(outputs, keys)

    def predict_numpy(self, image_bgr_u8: np.ndarray) -> Dict[str, np.ndarray]:
        return self.numpy_outputs(self(image_bgr_u8))

    def numpy_outputs(self, outputs, keys=None, copy: bool = True) -> Dict[str, np.ndarray]:
        return self.base.numpy_outputs(outputs, keys=keys, copy=copy)

    @torch.inference_mode()
    def __call__(self, image_bgr_u8) -> Dict[str, torch.Tensor]:
        with span("predict"):  # the request's root span, as the base predictor's
            return self._predict(image_bgr_u8)

    def _predict(self, image_bgr_u8) -> Dict[str, torch.Tensor]:
        model = self.base.model
        img = image_tensor(image_bgr_u8, self.base.device)
        h0, w0 = int(img.shape[0]), int(img.shape[1])
        img_flip = img.flip(1) if self.flip else None

        dets = []   # per view: (boxes in the frame's coordinates, scores, classes, valid)
        views = []  # (features, (h1 / h0, w1 / w0), flipped) of the views stage 2 runs on
        with span("tta_stage1"):
            for ms in self.min_sizes:
                _, h1, w1 = model.resized_size(h0, w0, ms, self.max_size)
                res, feats, _ = model.forward_stage1(img, ms, self.max_size)
                dets.append((res["pred_boxes"], res["scores"], res["pred_classes"],
                             res["valid"]))
                views.append((feats, (h1 / h0, w1 / w0), False))
                if self.flip:
                    res, feats, _ = model.forward_stage1(img_flip, ms, self.max_size)
                    dets.append((mirror(res["pred_boxes"], w0), res["scores"],
                                 res["pred_classes"], res["valid"]))
                    if self.flip_segm:
                        views.append((feats, (h1 / h0, w1 / w0), True))
                    del feats
        with span("tta_merge"):
            boxes, scores, classes, valid = merge_detections(
                *(torch.cat(x) for x in zip(*dets)), self.nms_thresh, self.topk)
        del dets
        result = {
            "image_size": torch.tensor([h0, w0], dtype=torch.int32, device=boxes.device),
            "pred_boxes": boxes,
            "scores": scores,
            "pred_classes": classes,
            "valid": valid,
            "num_instances": valid.sum().int(),
        }
        if not self.densepose_on:
            return result
        reduce = StreamingReduce(self.uv_tables)
        while views:
            feats, (sy, sx), flipped = views.pop(0)
            with span("tta_stage2"):
                bx = mirror(boxes, w0) if flipped else boxes
                scale = torch.tensor([sx, sy, sx, sy], dtype=torch.float32, device=bx.device)
                dp = model.forward_densepose(feats, bx * scale)
            del feats
            with span("tta_reduce"):
                reduce.add(dp, flipped)
            del dp
        with span("tta_reduce"):
            result.update(reduce.result())
        return result


def mirror(boxes: torch.Tensor, width: int) -> torch.Tensor:
    """XYXY boxes mirrored across a frame ``width`` wide: x -> width - x."""
    return torch.stack([width - boxes[:, 2], boxes[:, 1], width - boxes[:, 0], boxes[:, 3]],
                       dim=1)
