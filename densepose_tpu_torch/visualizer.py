"""Host-side result extraction + overlay rendering (the port's copy of
densepose_tpu/visualizer.py; numpy, C and, for some steps, cv2).

* ``resample_fine_and_uv`` (the reference's visualizer.py:10-30):
  bilinear-resize coarse + fine segm logits to the box size, argmax, mask fine
  labels by coarse foreground, and gather the per-part U/V values;
* ``DensePoseResultExtractor``: that per instance, in a thread pool on
  crowded frames, also for the device-postprocessed label / UV maps;
* ``MatrixVisualizer`` and the fine-segm / U / V overlays (:59-139): a
  colormap and an alpha blend, through the native fused blends
  (``native/fastvis.c``) where the library builds;
* ``End2EndVisualizer``: extract + overlay per frame, and ``fetch_keys``,
  the maps an overlay reads, for ``numpy_outputs(keys=...)``;
* ``CseResultExtractor`` and ``CseVisualizer`` (:322-387) for CSE models:
  per instance the embedding map resized to the box, masked by the coarse
  segmentation's foreground, and each pixel's closest mesh vertex, looked up
  on the predictor's device (``models/cse.py::closest_vertices``); the
  overlay colours the vertex indices modulo 255.

The outputs come from ``predictor.numpy_outputs``: trimmed to the valid
detections, DensePose maps NCHW. ``cv2`` is imported only where it is used:
building the colormap table from a cv2 colormap id, resizing a mask that is
not box-sized, and drawing boxes. Given a (256, 3) colormap table and the
native library, the chart and CSE overlays run without it (the GPU machine
has no cv2).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def colormap_table(cmap=None) -> np.ndarray:
    """A colormap as a (256, 3) uint8 BGR table: a table is returned as it
    is; a cv2 colormap id (default VIRIDIS) is expanded with
    ``cv2.applyColorMap``, which for uint8 input is this table lookup."""
    if isinstance(cmap, np.ndarray):
        if cmap.shape != (256, 3) or cmap.dtype != np.uint8:
            raise ValueError(f"colormap table must be (256, 3) uint8, got {cmap.dtype} "
                             f"{cmap.shape}")
        return np.ascontiguousarray(cmap)
    import cv2
    cmap = cv2.COLORMAP_VIRIDIS if cmap is None else cmap
    return cv2.applyColorMap(np.arange(256, dtype=np.uint8).reshape(1, 256), cmap).reshape(256, 3)


_POOL = None


def _extract_pool():
    """Process-wide extraction thread pool (lazy; numpy/C work releases the
    GIL, so threads give real parallelism for crowded frames)."""
    global _POOL
    if _POOL is None:
        from concurrent.futures import ThreadPoolExecutor
        _POOL = ThreadPoolExecutor(max_workers=8,
                                   thread_name_prefix="dp-extract")
    return _POOL


def _resize_bilinear_np(x: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) float32 -> (h, w, C), torch align_corners=False semantics
    (same rule as ops/resize.py, numpy edition for the host stage)."""
    h_in, w_in = x.shape[:2]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x

    def axis(in_size, out_size):
        ratio = np.float32(in_size) / np.float32(out_size)
        src = (np.arange(out_size, dtype=np.float32) + 0.5) * ratio - 0.5
        src = np.maximum(src, 0.0)
        i0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
        frac = src - i0
        i1 = np.minimum(i0 + 1, in_size - 1)
        w1 = np.where(i1 > i0, frac, 0.0).astype(np.float32)
        return i0, i1, 1.0 - w1, w1

    i0, i1, w0, w1 = axis(h_in, h_out)
    x = x[i0] * w0[:, None, None] + x[i1] * w1[:, None, None]
    j0, j1, v0, v1 = axis(w_in, w_out)
    x = x[:, j0] * v0[:, None] + x[:, j1] * v1[:, None]
    return x


def resample_fine_and_uv(
    coarse_segm: np.ndarray,
    fine_segm: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    box_xywh,
) -> Tuple[np.ndarray, np.ndarray]:
    """All inputs (H, W, C) float maps for ONE instance. Returns
    (labels (h, w) int64, uv (2, h, w) float32) in box-sized pixels."""
    x, y, w, h = [int(q) for q in box_xywh]
    w = max(w, 1)
    h = max(h, 1)
    # the numpy path of the extractor, taken where the native library (its
    # CHW entry, native/fastvis.c) is absent
    coarse = _resize_bilinear_np(coarse_segm.astype(np.float32), (h, w))
    fine = _resize_bilinear_np(fine_segm.astype(np.float32), (h, w))
    fg = coarse.argmax(-1) > 0
    labels = fine.argmax(-1) * fg
    u_box = _resize_bilinear_np(u.astype(np.float32), (h, w))
    v_box = _resize_bilinear_np(v.astype(np.float32), (h, w))
    lab = labels[..., None]
    u_sel = np.take_along_axis(u_box, lab, axis=-1)[..., 0]
    v_sel = np.take_along_axis(v_box, lab, axis=-1)[..., 0]
    uv = np.stack([np.where(labels > 0, u_sel, 0.0),
                   np.where(labels > 0, v_sel, 0.0)]).astype(np.float32)
    return labels.astype(np.int64), uv


class DensePoseResultExtractor:
    """Turns a predictor output dict into per-instance (labels, uv) results +
    XYWH boxes, like visualizer.py:47-56.

    Consumes the reference's NCHW map layout — what ``predict_numpy`` /
    ``numpy_outputs`` emit and every call site (run.py,
    parallel/pipeline.py) feeds — exactly like the reference's extractor
    consumes its (N, C, H, W) tensors.

    ``need_uv=False`` skips the U/V resample+gather (the fine-segm overlay —
    the reference's only one — consumes labels alone); each result's "uv"
    entry is then None."""

    def __call__(self, outputs: Dict[str, np.ndarray], need_uv: bool = True):
        from .native import resample_instance_native_chw

        n = int(outputs.get("num_instances", len(outputs["pred_boxes"])))
        boxes_xyxy = np.asarray(outputs["pred_boxes"])[:n]
        boxes_xywh = boxes_xyxy.copy()
        boxes_xywh[:, 2:] -= boxes_xywh[:, :2]
        device_pp = "pred_densepose_labels" in outputs
        if not device_pp:
            # one asarray per key (slices of the C-contiguous NCHW stack are
            # themselves contiguous CHW — the native kernel reads them with
            # no transpose/copy). U/V may be absent when the producer
            # filtered its device fetch (numpy_outputs(keys=...)).
            coarse_all = np.asarray(outputs["pred_densepose_coarse_segm"])
            fine_all = np.asarray(outputs["pred_densepose_fine_segm"])
            u_all = (np.asarray(outputs["pred_densepose_u"])
                     if need_uv or "pred_densepose_u" in outputs else None)
            v_all = (np.asarray(outputs["pred_densepose_v"])
                     if u_all is not None else None)

        def hwc(a):
            # (C, H, W) map -> the HWC form resample_fine_and_uv wants
            return np.ascontiguousarray(
                np.transpose(np.asarray(a), (1, 2, 0)))

        def extract(i):
            if device_pp:
                # device-postprocessed form (TPU.DEVICE_POSTPROCESS): labels
                # and UV already extracted at grid resolution; just paste
                x, y, w, h = [int(q) for q in boxes_xywh[i]]
                w, h = max(w, 1), max(h, 1)
                lab_grid = np.asarray(outputs["pred_densepose_labels"][i])
                gy = np.minimum((np.arange(h) * lab_grid.shape[0] / h).astype(int),
                                lab_grid.shape[0] - 1)
                gx = np.minimum((np.arange(w) * lab_grid.shape[1] / w).astype(int),
                                lab_grid.shape[1] - 1)
                labels = lab_grid[gy][:, gx].astype(np.int64)
                if need_uv:
                    uv_grid = np.asarray(outputs["pred_densepose_uv"][i],
                                         dtype=np.float32)  # (2,H,W)
                    uv = np.stack([
                        _resize_bilinear_np(uv_grid[0][..., None], (h, w))[..., 0],
                        _resize_bilinear_np(uv_grid[1][..., None], (h, w))[..., 0],
                    ])
                else:
                    uv = None
            else:
                x, y, w, h = [int(q) for q in boxes_xywh[i]]
                w, h = max(w, 1), max(h, 1)
                native = resample_instance_native_chw(
                    coarse_all[i], fine_all[i],
                    u_all[i] if need_uv else None,
                    v_all[i] if need_uv else None,
                    h, w, need_uv=need_uv)
                if native is not None:
                    labels, uv = native  # uv is None when !need_uv
                else:
                    ua = u_all if u_all is not None else np.zeros_like(fine_all)
                    va = v_all if v_all is not None else ua
                    labels, uv = resample_fine_and_uv(
                        hwc(coarse_all[i]), hwc(fine_all[i]),
                        hwc(ua[i]), hwc(va[i]), boxes_xywh[i])
                    if not need_uv:
                        uv = None
            return {"labels": labels, "uv": uv}

        if n > 4 and (os.cpu_count() or 1) > 1:
            # per-instance extraction is independent; numpy/C release the GIL.
            # One persistent pool — spawning threads per video frame would
            # cost more than the parallelism buys. On a single-core host the
            # pool is pure overhead — run serial.
            results = list(_extract_pool().map(extract, range(n)))
        else:
            results = [extract(i) for i in range(n)]
        return results, boxes_xywh


class MatrixVisualizer:
    """Colormapped matrix overlay inside a bbox (visualizer.py:59-106).
    ``cmap``: a cv2 colormap id (default VIRIDIS) or a (256, 3) uint8 BGR
    table."""

    def __init__(self, inplace=True, cmap=None, val_scale=1.0, alpha=0.7):
        self.inplace = inplace
        self.val_scale = val_scale
        self.alpha = alpha
        # BIT-EXACT fast blend: the overlay contract (pinned against the
        # reference's own visualizer) is trunc(roi*(1-a) + vis*a) in float64
        # per uint8 pair, enumerated once into a (256, 256) table
        r = np.arange(256, dtype=np.float64)
        self._blend_lut = (r[:, None] * (1.0 - alpha)
                           + r[None, :] * alpha).astype(np.uint8)
        self._ramp = colormap_table(cmap)
        # val_scale + colormap folded into one 256x3 BGR table (both are
        # pure per-value lookups; same float32-mult + truncation as the
        # direct chain below, so byte-identical)
        scale = (np.arange(256, dtype=np.float32) * self.val_scale
                 ).clip(0, 255).astype(np.uint8)
        self._cmap_table = np.ascontiguousarray(self._ramp[scale])

    def visualize(self, image_bgr, mask, matrix, bbox_xywh):
        from .native import blend_overlay_native
        image_target = image_bgr if self.inplace else image_bgr * 0
        x, y, w, h = [int(v) for v in bbox_xywh]
        if w <= 0 or h <= 0:
            return image_bgr
        if mask.shape[:2] != (h, w):
            import cv2
            mask = cv2.resize(mask, (w, h), cv2.INTER_NEAREST)
        if matrix.shape[:2] != (h, w):
            import cv2
            matrix = cv2.resize(matrix, (w, h), cv2.INTER_LINEAR)
        roi = image_target[y:y + h, x:x + w, :]
        if (matrix.dtype == np.uint8 and roi.shape == (h, w, 3)
                and blend_overlay_native(roi, matrix, mask,
                                         self._cmap_table, self._blend_lut)):
            return image_target
        scaled = (matrix.astype(np.float32) * self.val_scale).clip(0, 255).astype(np.uint8)
        vis = self._ramp[scaled]  # cv2.applyColorMap(scaled, cmap)
        bg = mask == 0
        vis[bg] = roi[bg]
        image_target[y:y + h, x:x + w, :] = self._blend_lut[roi, vis]
        return image_target

    def fill(self, image_bgr, val=0):
        cm = self._ramp[val]
        # the direct blend's float64->uint8 truncation, as one table per
        # channel (cv2.LUT with a 3-channel table)
        p = np.arange(256, dtype=np.float64)[:, None]
        lut = (cm[None, :] * self.alpha + p * (1.0 - self.alpha)).astype(np.uint8)
        for c in range(3):
            image_bgr[..., c] = lut[:, c][image_bgr[..., c]]


class DensePoseResultsFineSegmentationVisualizer:
    """Fine-segmentation (I channel) overlay (visualizer.py:113-131)."""

    def __init__(self, inplace=True, cmap=None, alpha=0.7, val_scale=255 / 24.0,
                 keep_bg=True):
        self.mask_visualizer = MatrixVisualizer(inplace=inplace, cmap=cmap,
                                                val_scale=val_scale, alpha=alpha)
        self.keep_bg = keep_bg

    def _matrix_mask(self, res):
        labels = res["labels"]
        return labels.astype(np.uint8), (labels > 0).astype(np.uint8)

    def visualize(self, image_bgr: np.ndarray, results_and_boxes) -> np.ndarray:
        results, boxes_xywh = results_and_boxes
        if results is None or boxes_xywh is None:
            return image_bgr
        if not self.keep_bg:
            self.mask_visualizer.fill(image_bgr, 0)
        for res, box in zip(results, boxes_xywh):
            matrix, mask = self._matrix_mask(res)
            self.mask_visualizer.visualize(image_bgr, mask, matrix, box)
        return image_bgr


class DensePoseResultsUVisualizer(DensePoseResultsFineSegmentationVisualizer):
    """U/V-channel overlay (beyond the reference, which ships only the
    fine-segm visualizer; mirrors upstream detectron2 DensePose's
    DensePoseResultsU/VVisualizer). The UV matrix is pre-scaled to 0..255,
    so the colormap val_scale is 1."""

    def __init__(self, inplace=True, cmap=None, alpha=0.7, keep_bg=True,
                 channel=0):
        super().__init__(inplace=inplace, cmap=cmap, alpha=alpha,
                         val_scale=1.0, keep_bg=keep_bg)
        self.channel = channel  # 0 = U, 1 = V

    def _matrix_mask(self, res):
        matrix = np.clip(res["uv"][self.channel] * 255.0, 0, 255).astype(np.uint8)
        return matrix, (res["labels"] > 0).astype(np.uint8)


class DensePoseResultsVVisualizer(DensePoseResultsUVisualizer):
    def __init__(self, **kw):
        super().__init__(channel=1, **kw)


class ScoredBboxVisualizer:
    """Detection boxes + scores overlay (upstream's ScoredBoundingBoxVisualizer
    analogue; the reference has no box visualizer at all). Needs cv2."""

    def __init__(self, color=(0, 255, 0), thickness=1):
        self.color = color
        self.thickness = thickness

    def visualize(self, image_bgr: np.ndarray, outputs) -> np.ndarray:
        import cv2
        n = int(outputs.get("num_instances", len(outputs["pred_boxes"])))
        boxes = np.asarray(outputs["pred_boxes"])[:n]
        scores = np.asarray(outputs["scores"])[:n]
        for box, score in zip(boxes, scores):
            x1, y1, x2, y2 = [int(v) for v in box]
            cv2.rectangle(image_bgr, (x1, y1), (x2, y2), self.color,
                          self.thickness)
            cv2.putText(image_bgr, f"{float(score):.2f}", (x1, max(y1 - 3, 0)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.4, self.color, 1)
        return image_bgr


class CseResultExtractor:
    """Per-instance closest-vertex maps of a CSE model's outputs (JAX
    visualizer.py:322-363): each detection's embedding and coarse
    segmentation (NCHW, as ``numpy_outputs`` gives them) resized to its box
    on the host (``ops/resize.py::resize_bilinear_np``, the JAX package's
    resize bit for bit), masked where the coarse argmax is foreground, and
    each pixel's nearest vertex of the class's mesh
    (``DATASETS.CLASS_TO_MESH_NAME_MAPPING``) looked up on the predictor's
    device (``closest_vertices``, in row chunks) against the mesh's vertex
    embeddings, computed once per mesh and kept."""

    def __init__(self, predictor):
        self.predictor = predictor
        self.class_to_mesh = {int(k): v for k, v in
                              predictor.cfg.DATASETS.CLASS_TO_MESH_NAME_MAPPING.items()}
        self.mesh_embeddings = {}

    def vertices(self, mesh: str):
        """The mesh's normalized vertex embeddings on the predictor's device."""
        import torch
        from .models.cse import vertex_embeddings
        if mesh not in self.mesh_embeddings:
            with torch.inference_mode():
                self.mesh_embeddings[mesh] = vertex_embeddings(
                    self.predictor.model.roi_heads.embedder, mesh)
        return self.mesh_embeddings[mesh]

    def __call__(self, outputs: Dict[str, np.ndarray]):
        import torch
        from .models.cse import closest_vertices
        from .ops.resize import resize_bilinear_np

        n = int(outputs.get("num_instances", len(outputs["pred_boxes"])))
        boxes_xywh = np.asarray(outputs["pred_boxes"])[:n].copy()
        boxes_xywh[:, 2:] -= boxes_xywh[:, :2]
        classes = np.asarray(outputs["pred_classes"])[:n]
        results = []
        for i in range(n):
            w, h = [max(int(q), 1) for q in boxes_xywh[i, 2:]]
            emb = np.transpose(np.asarray(outputs["pred_densepose_embedding"][i]), (1, 2, 0))
            segm = np.transpose(np.asarray(outputs["pred_densepose_coarse_segm"][i]), (1, 2, 0))
            emb = resize_bilinear_np(emb.astype(np.float32), (h, w))
            mask = resize_bilinear_np(segm.astype(np.float32), (h, w)).argmax(-1) > 0
            mesh = self.class_to_mesh[int(classes[i])]
            verts = self.vertices(mesh)
            with torch.inference_mode():
                idx = closest_vertices(torch.from_numpy(emb.reshape(-1, emb.shape[-1])), verts)
            verts_hw = idx.cpu().numpy().reshape(h, w) * mask
            results.append({"closest_vertices": verts_hw, "mask": mask, "mesh_name": mesh})
        return results, boxes_xywh


class CseVisualizer:
    """Overlay of each instance's closest-vertex indices, colour-mapped modulo
    255 (JAX visualizer.py:366-387). ``cmap``: a cv2 colormap id or a (256, 3)
    uint8 table."""

    def __init__(self, predictor, alpha=0.7, cmap=None, keep_bg=True):
        self.extractor = CseResultExtractor(predictor)
        self.mask_visualizer = MatrixVisualizer(cmap=cmap, val_scale=1.0, alpha=alpha)
        self.keep_bg = keep_bg

    def visualize(self, image_bgr: np.ndarray, outputs) -> np.ndarray:
        results, boxes_xywh = self.extractor(outputs)
        if not self.keep_bg:
            self.mask_visualizer.fill(image_bgr, 0)
        for res, box in zip(results, boxes_xywh):
            matrix = (res["closest_vertices"] % 255).astype(np.uint8)
            self.mask_visualizer.visualize(image_bgr, res["mask"].astype(np.uint8), matrix, box)
        return image_bgr

    def fetch_keys(self):
        return {"pred_densepose_embedding", "pred_densepose_coarse_segm"}


class End2EndVisualizer:
    """Extract + overlay, one call per frame (visualizer.py:132-139).

    ``mode``: "fine_segm" (the reference's only overlay), "u", "v"
    (UV-channel overlays), or "bbox" (boxes + scores, no extraction)."""

    def __init__(self, alpha=0.7, cmap=None, keep_bg=True, mode="fine_segm"):
        self.mode = mode
        self.extractor = DensePoseResultExtractor()
        if mode == "fine_segm":
            self.visualizer = DensePoseResultsFineSegmentationVisualizer(
                alpha=alpha, cmap=cmap, keep_bg=keep_bg)
        elif mode == "u":
            self.visualizer = DensePoseResultsUVisualizer(
                alpha=alpha, cmap=cmap, keep_bg=keep_bg)
        elif mode == "v":
            self.visualizer = DensePoseResultsVVisualizer(
                alpha=alpha, cmap=cmap, keep_bg=keep_bg)
        elif mode == "bbox":
            self.visualizer = ScoredBboxVisualizer()
        else:
            raise ValueError(f"unknown visualizer mode {mode!r}")

    def visualize(self, image_bgr: np.ndarray, outputs) -> np.ndarray:
        if self.mode == "bbox":
            return self.visualizer.visualize(image_bgr, outputs)
        if self.mode in ("fine_segm", "u", "v"):
            out = self._visualize_labels_fused(image_bgr, outputs)
            if out is not None:
                return out
        data = self.extractor(outputs, need_uv=self.mode in ("u", "v"))
        return self.visualizer.visualize(image_bgr, data)

    def _visualize_labels_fused(self, image_bgr: np.ndarray, outputs):
        """Fine-segm fast path: per instance, ONE fused C pass — for
        device-postprocess outputs a nearest label-grid resample + colormap +
        blend (fastvis.c::blend_labels_grid); for raw SIUV maps a bilinear
        resample + argmax + colormap + blend (::resample_blend_chw). Both are
        byte-identical to extractor + MatrixVisualizer (tested), with no
        box-sized intermediates. Returns None (caller runs the generic path)
        when the native lib is absent, any box's ROI doesn't slice cleanly,
        or a multi-core host would do better with the thread-pooled
        extractor; the checks run before any pixel is touched."""
        from .native import (blend_labels_grid_native, get_lib,
                             resample_blend_chw_native,
                             resample_blend_uv_chw_native)
        mv = self.visualizer.mask_visualizer
        if get_lib() is None or not mv.inplace:
            return None
        device_pp = "pred_densepose_labels" in outputs
        uv_key = {"u": "pred_densepose_u", "v": "pred_densepose_v"}.get(
            self.mode)
        # The native blends decline (return False) on any ROI whose dtype or
        # innermost strides they don't support. Every ROI here is a plain
        # slice of image_bgr, so checking the full image ONCE before any
        # pixel is touched guarantees no mid-frame decline — otherwise a
        # non-uint8 or channel-strided image (a flipped view, an RGBA
        # slice) would pass the geometry checks, every native call would
        # silently no-op, and with keep_bg=False the frame would come back
        # blank.
        if (image_bgr.ndim != 3 or image_bgr.shape[2] != 3
                or image_bgr.dtype != np.uint8
                or image_bgr.strides[2] != 1 or image_bgr.strides[1] != 3):
            return None
        img_h, img_w = image_bgr.shape[:2]
        n = int(outputs.get("num_instances", len(outputs["pred_boxes"])))
        if device_pp:
            if uv_key is not None:
                return None  # device-pp u/v: numpy-resized grid, generic path
        else:
            if ("pred_densepose_fine_segm" not in outputs
                    or "pred_densepose_coarse_segm" not in outputs
                    or (uv_key is not None and uv_key not in outputs)):
                return None
            if n > 4 and (os.cpu_count() or 1) > 1:
                # crowded frame on a multi-core host: the unfused path
                # parallelizes the (expensive) raw resample across instances;
                # the fused blend must stay serial (overlapping boxes)
                return None
        boxes_xyxy = np.asarray(outputs["pred_boxes"])[:n]
        rois = []
        for i in range(n):
            # same truncation chain as the extractor: XYWH floats, each
            # int()-truncated separately (w = int(x2 - x1), NOT int(x2) -
            # int(x1) — they differ on fractional boxes). The subtraction
            # must run in float32 like the extractor's boxes_xywh in-place
            # f32 arithmetic: within half an f32 ulp below an integer, f32
            # rounds up across the boundary where f64 would truncate low,
            # and the two paths would disagree by 1 px.
            bx, by, bx2, by2 = [np.float32(q) for q in boxes_xyxy[i]]
            x, y = int(bx), int(by)
            w, h = int(np.float32(bx2 - bx)), int(np.float32(by2 - by))
            if w <= 0 or h <= 0:
                # MatrixVisualizer skips degenerate boxes before blending
                rois.append(None)
                continue
            if (x < 0 or y < 0 or x + w > img_w or y + h > img_h
                    or w > 4096):
                return None  # clipped/odd box: generic path handles it
            rois.append((y, x, h, w))
        if device_pp:
            labels_all = np.asarray(outputs["pred_densepose_labels"])
        else:
            # one whole-stack contiguation (NCHW views out of numpy_outputs)
            # instead of a strided copy per instance
            coarse_all = np.ascontiguousarray(
                np.asarray(outputs["pred_densepose_coarse_segm"]),
                dtype=np.float32)
            fine_all = np.ascontiguousarray(
                np.asarray(outputs["pred_densepose_fine_segm"]),
                dtype=np.float32)
            uv_all = (np.ascontiguousarray(np.asarray(outputs[uv_key]),
                                           dtype=np.float32)
                      if uv_key is not None else None)
        if not self.visualizer.keep_bg:
            mv.fill(image_bgr, 0)
        for i, roi in enumerate(rois):
            if roi is None:
                continue
            y, x, h, w = roi
            if device_pp:
                ok = blend_labels_grid_native(
                    image_bgr[y:y + h, x:x + w], labels_all[i],
                    mv._cmap_table, mv._blend_lut)
            elif uv_key is not None:
                ok = resample_blend_uv_chw_native(
                    coarse_all[i], fine_all[i], uv_all[i],
                    image_bgr[y:y + h, x:x + w],
                    mv._cmap_table, mv._blend_lut)
            else:
                ok = resample_blend_chw_native(
                    coarse_all[i], fine_all[i],
                    image_bgr[y:y + h, x:x + w],
                    mv._cmap_table, mv._blend_lut)
            if not ok:
                # unreachable after the whole-image layout pre-check above;
                # surface it rather than return a frame missing overlays
                logger.warning(
                    "native blend declined instance %d despite layout "
                    "pre-checks; overlay for this instance is missing", i)
        return image_bgr

    def fetch_keys(self):
        """The pred_densepose_* maps this overlay actually consumes — a
        streaming consumer (parallel/pipeline.py) passes this to
        ``numpy_outputs(keys=...)`` so unused maps never cross the
        device->host link (the fine-segm overlay leaves the U/V maps on the
        device). Both the
        raw and device-postprocessed key names are listed; absent ones are
        ignored by the fetch."""
        if self.mode == "bbox":
            return set()
        keys = {"pred_densepose_labels", "pred_densepose_coarse_segm",
                "pred_densepose_fine_segm"}
        if self.mode in ("u", "v"):
            keys |= {"pred_densepose_uv", "pred_densepose_u",
                     "pred_densepose_v"}
        return keys
