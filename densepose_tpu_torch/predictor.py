"""DensePosePredictor for the PyTorch port (port of densepose_tpu/predictor.py).

``DensePosePredictor(cfg)`` builds the model, loads a detectron2 ``.pkl`` or
an exported ``.npz`` bundle (or random weights from a seed), and serves ``predictor(image_bgr_u8) ->
outputs`` on one CUDA device; ``device="cpu"`` runs the same path on the CPU
with the kernels' plain versions (the tests do). A requested CUDA device that
is absent raises. Outputs are fixed-size slots + ``num_instances``;
``numpy_outputs`` trims them to the valid detections.

The fetch API of a streaming consumer (``parallel/pipeline.py``):
``stage_input`` uploads a frame from pinned memory without blocking (from a
reader thread), ``start_fetch`` starts the device-to-host copies of the maps a
consumer reads, into pinned memory, right after a frame is dispatched, and
``numpy_outputs(outputs, keys)`` waits for those copies and reads only the
requested maps, with the small detection outputs in the one ``det_packed``
array. What it returns is the caller's own: copies of the valid rows, not
views of the pinned buffers (only the streaming loop, which draws each frame
at once and drops it, reads views with ``copy=False``).

Two bucketing modes, as in the JAX package (predictor.py:96-109, 516-588):

* ``TPU.GEOMETRY_BUCKET_QUANT`` q (a multiple of 32): each frame is resized
  and placed on a canvas whose sides are multiples of q
  (``GeneralizedRCNN.bucket_canvas``, on the device from the uploaded frame;
  ``bucketize`` is the same canvas built on the host), and
  ``forward_bucketed`` serves it. The JAX package buckets to compile one graph
  per canvas; the port compiles nothing, so here the mode only reproduces
  the JAX package's numbers on a mixed-size directory, at the cost of the
  wider canvas;
* ``TPU.BUCKETED_DENSEPOSE``: stage 1, one host sync on the detection count,
  then the DensePose stage on the smallest of {8, 16, 32, 64} and D covering
  it. The maps keep the bucket's rows, not D (``numpy_outputs`` trims to the
  valid rows either way), and, as in the JAX package, the device
  postprocess does not run in this mode.

The two are exclusive. ``predict_batch`` bypasses both, as the JAX
package's does.

Batched frames (JAX predictor.py:593-616): ``predict_batch(images (B, H, W,
3))`` runs the B frames as one batched forward (``GeneralizedRCNN.
forward_batch``) and returns what the JAX package's ``predict_batch``
returns: every output (B, ...), frame i's being the request of frame i with
the switched DensePose stage and the device postprocess off whatever the
config says (the JAX package vmaps ``forward`` with its defaults), so the
raw maps of all D slots, (B, D, C, HEATMAP, HEATMAP), with no host sync. A
CUDA predictor that sees more than one card, given a multiple of their
count, splits the batch over them instead (``parallel/mesh.py::
data_parallel_forward``), as the JAX package shards over its mesh.
``numpy_outputs_batch`` fetches a batch's outputs once per key and returns
each frame's ``numpy_outputs``.

Spans (``utils/timing.py``): ``__call__`` and ``predict_batch`` each open a
root span (``predict``, ``predict_batch``) that holds the call's ``upload``,
its stages and its kernel wrappers' spans, one call number for all of them.

Compute dtype (``TPU.COMPUTE_DTYPE``): float32, float16 or bfloat16, the
JAX package's policy (predictor.py:89-90, 147-152). After loading, every
float32 parameter is cast to the dtype; the ``pixel_mean``/``pixel_std``
buffers stay float32, so the normalize runs in fp32. The model keeps the
reference's fp32 islands (``models/rcnn.py``). Detections come back in fp32
and the DensePose maps in the dtype: float16 maps as float16 arrays;
bfloat16 maps cross to the host as their 2-byte payload and are widened to
float32 exactly there (numpy has no bfloat16; the JAX package returns
``ml_dtypes.bfloat16`` arrays holding the same values).

int8 serving (``TPU.INT8_HEAD`` / ``INT8_PREDICTOR`` / ``INT8_BACKBONE`` /
``INT8_RPN``, JAX predictor.py:110-145, 164-502): ``calibrate_int8(frames)``
records each quantization site's largest activation over the frames
(``GeneralizedRCNN.forward_int8_calibration``), sets the static scales
max / 127 and quantizes the site's convs per output channel; the state lives
in the model as buffers under the JAX package's names
(``roi_heads.densepose_head.body_conv_fcn1.qweight``, ``.wscale``,
``.in_scale``; ``proposal_generator.rpn_head.conv.in_scale_p2`` ...;
``int8_state`` lists them), and the quantized convs run through kernel Q1.
``save_calibration`` / ``load_calibration`` keep only the activation scales,
as ``{"format": "densepose-tpu-int8-calib", "scales": {...}}`` (the weights
are quantized again on load, bit for bit), and a ``<weights>.calib.json``
beside the weights loads when the predictor is built; a sidecar written by
either package loads into the other. A request that finds an int8 mode
without its scales calibrates on its own frame, loudly
(``calibration_source`` says where the scales came from);
``saturation_report`` measures each site's share of clipped values.

The AOT program (JAX predictor.py:622-646): ``aot_export_bytes((H, W))``
serializes the request at one input size as a ``torch.export`` program with
the weights inside, and ``aot_load(data)`` returns a callable of the frame
alone that runs it, with no model build (``export.py --aot`` writes it as
``<bundle>_<h>x<w>.pt2``).

Parity: TF32 is turned off for cuDNN convolutions and matmuls, which
otherwise run float32 convolutions at about three decimal digits, and cuBLAS
may not reduce float16 or bfloat16 products in reduced precision (the JAX
package's products accumulate in fp32). These flags are process-wide and set
once, when a predictor is built. A frame served twice may differ in the last
bits of its maps: cuDNN's transposed convolutions add with atomics.
"""

from __future__ import annotations

import io
import json
import logging
import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from .checkpoint.pkl_loader import align_state_dicts, load_checkpoint_file
from .checkpoint.transform import fold_state, random_torch_state
from .models.fpn import fpn_int8_scale_sites
from .models.hrnet import hrnet_int8_quant_bases, hrnet_int8_scale_sites
from .models.rcnn import (GeneralizedRCNN, batch_tensor, build_model, check_image,
                          image_tensor, resnet_prefix, size_divisibility)
from .models.resnet import resnet_int8_scale_sites
from .ops.conv_int8 import is_int8_key, is_scale_key, quantize_weight_int8, set_buffer
from .ops.resize import resize_bilinear_np
from .utils.timing import span

logger = logging.getLogger(__name__)


def load_params(cfg, weights_path: Optional[str] = None, seed: int = 0,
                model: Optional[GeneralizedRCNN] = None) -> Dict[str, np.ndarray]:
    """cfg + checkpoint -> the port's module state dict (host numpy).

    The reference load stack: pkl -> (optional Caffe2 rename) -> suffix
    alignment against the model's spec -> FrozenBN folding, or with
    ``TPU.FOLD_FROZEN_BN`` off the statistics kept for the model's
    ``FrozenBatchNorm2d`` modules (JAX predictor.py:72). Without a
    checkpoint, random weights drawn from ``seed`` (the JAX package's stream:
    the same seed gives the same weights in both packages)."""
    spec = (model or build_model(cfg)).spec()
    if weights_path:
        ckpt, needs_c2 = load_checkpoint_file(weights_path)
        state = align_state_dicts(list(spec), {k: v.shape for k, v in spec.items()},
                                  ckpt, needs_c2)
        logger.info("checkpoint: matched %d/%d params", len(state), len(spec))
    else:
        state = random_torch_state(spec, seed=seed)
    return fold_state(state, spec, fold=bool(cfg.TPU.FOLD_FROZEN_BN))


def data_parallel_devices(device: torch.device) -> List[torch.device]:
    """The devices ``predict_batch`` splits a batch over: for a CUDA
    predictor every card this process sees, its own first (the outputs come
    back there); otherwise its one device."""
    if device.type != "cuda":
        return [device]
    n = torch.cuda.device_count()
    first = device.index if device.index is not None else torch.cuda.current_device()
    return [torch.device("cuda", (first + i) % n) for i in range(n)]


class DensePosePredictor:
    def __init__(self, cfg, weights_path: Optional[str] = None, seed: int = 0,
                 device: str = "cuda", params: Optional[Dict] = None):
        """``params``: a ready module state dict (e.g. from
        ``checkpoint.transform.params_from_jax``) in place of loading."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but none is available; pass "
                               "device='cpu' to run on the CPU")
        set_backend_flags()
        self.cfg = cfg
        self.bucketed = bool(cfg.TPU.BUCKETED_DENSEPOSE) and cfg.MODEL.DENSEPOSE_ON
        self.geometry_quant = int(cfg.TPU.GEOMETRY_BUCKET_QUANT)
        div = size_divisibility(cfg)
        if self.geometry_quant % div:
            raise ValueError(f"TPU.GEOMETRY_BUCKET_QUANT {self.geometry_quant} must be a "
                             f"multiple of the backbone size divisibility ({div})")
        if self.geometry_quant and self.bucketed:
            raise ValueError("TPU.GEOMETRY_BUCKET_QUANT and TPU.BUCKETED_DENSEPOSE are "
                             "exclusive; TPU.SWITCHED_DENSEPOSE buckets the detection count "
                             "within a geometry-bucketed request")
        d = cfg.TEST.DETECTIONS_PER_IMAGE
        self.buckets = sorted({b for b in (8, 16, 32, 64) if b < d} | {d})
        self.model = build_model(cfg)
        self.compute_dtype = self.model.compute_dtype
        if params is None:
            params = load_params(cfg, weights_path, seed=seed, model=self.model)
        int8 = {k: v for k, v in params.items() if is_int8_key(k)}
        self.model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in
                                    params.items() if k not in int8})
        cast_parameters(self.model, self.compute_dtype)
        self.model.to(self.device).eval()
        self._int8_needed = int8_needed(cfg)
        self._int8_ready = False
        self._data_parallel = None  # predict_batch's replicas, made at first need
        # where the installed scales came from: None | "explicit" | "sidecar"
        # | "auto-single-frame" (saturation_report diagnoses the last)
        self.calibration_source = None
        if int8:  # a calibrated param dict (params_from_jax of the JAX package's)
            self._install({k: torch.as_tensor(np.asarray(v)) for k, v in int8.items()})
            self._int8_ready = not self._missing_scales(self._scale_names())
            self.calibration_source = "explicit"
        sidecar = f"{weights_path}.calib.json" if weights_path else None
        if self._int8_needed and sidecar and os.path.exists(sidecar):
            # a stale, partial or corrupt sidecar must not make the predictor
            # unconstructible: warn and calibrate at the first request instead
            # (an explicit load_calibration stays strict)
            try:
                self.load_calibration(sidecar)
                self.calibration_source = "sidecar"
            except ValueError as e:
                logger.warning("ignoring calibration sidecar %s (%s); falling back to "
                               "runtime auto-calibration", sidecar, e)

    def stage_input(self, image_bgr_u8: np.ndarray):
        """Upload a frame to the device ahead of ``__call__`` (e.g. from a
        video reader thread, so the copy overlaps the previous frame's fetch
        and overlay). The frame goes through pinned host memory, since a
        non-blocking copy from pageable memory blocks. On a CPU predictor the
        frame is returned unchanged. ``__call__`` accepts either."""
        if self.device.type != "cuda":
            return image_bgr_u8
        host = torch.from_numpy(check_image(image_bgr_u8)).pin_memory()
        return host.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def __call__(self, image_bgr_u8) -> Dict[str, torch.Tensor]:
        """image: (H, W, 3) uint8 BGR (the run.py contract), numpy or a
        ``stage_input`` tensor. Returns tensors on the device: fixed-size
        slots + num_instances (under ``TPU.BUCKETED_DENSEPOSE`` the maps hold
        the bucket's rows)."""
        with span("predict"):
            if self._int8_needed and not self._int8_ready:
                self._auto_calibrate(image_bgr_u8)
            image = image_tensor(image_bgr_u8, self.device)
            if self.geometry_quant:
                return self.model.forward_bucketed(
                    *self.model.bucket_canvas(image, self.geometry_quant))
            if self.bucketed:
                result, features, boxes_net = self.model.forward_stage1(image)
                result.update(self.densepose_stage2(features, boxes_net,
                                                    int(result["num_instances"])))  # the one sync
                return result
            return self.model(image)

    def stage2_bucket(self, num_valid: int) -> int:
        """``TPU.BUCKETED_DENSEPOSE``'s bucket: the smallest of
        ``self.buckets`` that holds ``num_valid`` (at least one slot)."""
        return next((b for b in self.buckets if b >= max(num_valid, 1)), self.buckets[-1])

    def densepose_stage2(self, features: Dict[str, torch.Tensor], boxes_net: torch.Tensor,
                         num_valid: int) -> Dict[str, torch.Tensor]:
        """``TPU.BUCKETED_DENSEPOSE``'s stage 2: the DensePose stage on the
        first ``stage2_bucket(num_valid)`` detections (valid ones are a
        score-sorted prefix), maps of that many rows (JAX predictor.py:541-553)."""
        return self.model.forward_densepose(features,
                                            boxes_net[:self.stage2_bucket(num_valid)])

    def bucketize(self, image_bgr_u8: np.ndarray):
        """The geometry-bucket canvas built on the host, a copy of the JAX
        package's ``bucketize`` (predictor.py:555-575): the reference's uint8
        resize in numpy, zero-padded to multiples of TPU.GEOMETRY_BUCKET_QUANT.
        Returns (canvas (HB, WB, 3) uint8, int32 [h0, w0, h1, w1]). Bitwise
        the canvas ``__call__`` builds on the device."""
        image = check_image(image_bgr_u8)
        h0, w0 = image.shape[:2]
        k, h1, w1 = self.model.resized_size(h0, w0)
        if self.cfg.INPUT.FORMAT == "RGB":  # defaults.py:81-83
            image = image[:, :, ::-1]
        y = resize_bilinear_np(image, (h1, w1), scale=(k, k))
        q = self.geometry_quant
        canvas = np.zeros((-(-h1 // q) * q, -(-w1 // q) * q, 3), np.uint8)
        canvas[:h1, :w1] = np.clip(np.rint(y), 0, 255).astype(np.uint8)
        return canvas, np.asarray([h0, w0, h1, w1], np.int32)

    def predict_numpy(self, image_bgr_u8: np.ndarray) -> Dict[str, np.ndarray]:
        return self.numpy_outputs(self(image_bgr_u8))

    @torch.inference_mode()
    def predict_batch(self, images_bgr_u8) -> Dict[str, torch.Tensor]:
        """Same-shaped frames (B, H, W, 3) uint8 BGR (numpy, or a tensor) ->
        the JAX package's ``predict_batch`` outputs, (B, ...) each, on this
        predictor's device: one batched forward (``forward_batch``: every
        DensePose slot, raw maps, no host sync), bypassing both bucketing
        modes. On more than one card, with B a multiple of their count, the
        frames split over them (``data_parallel_forward`` over
        ``data_parallel_devices``, this predictor's card first). An int8 mode
        without its scales calibrates on the first frame."""
        with span("predict_batch"):
            images = batch_tensor(images_bgr_u8, self.device)
            if self._int8_needed and not self._int8_ready:
                self._auto_calibrate(images[0])
            devices = data_parallel_devices(self.device)
            if len(devices) > 1 and images.shape[0] % len(devices) == 0:
                if self._data_parallel is None or self._data_parallel.devices != devices:
                    from .parallel.mesh import data_parallel_forward
                    self._data_parallel = data_parallel_forward(self.model, devices)
                return self._data_parallel(images)
            return self.model.forward_batch(images)

    # -- int8 calibration (JAX predictor.py:164-502) --------------------------

    def int8_state(self) -> Dict[str, torch.Tensor]:
        """The installed int8 state by its JAX param name: quantized weights
        (``.qweight`` (Cout, kh, kw, Cin) int8, ``.wscale``) and activation
        scales (0-dim float32)."""
        return {k: v for k, v in self.model.named_buffers() if is_int8_key(k)}

    def _scale_names(self) -> set:
        return {k for k in self.int8_state() if is_scale_key(k)}

    def _param_names(self) -> set:
        return {k for k, _ in self.model.named_parameters()}

    def _install(self, entries: Dict[str, torch.Tensor]) -> None:
        """Each entry as a buffer on the module its name's prefix names."""
        for name, value in entries.items():
            path, attr = name.rsplit(".", 1)
            set_buffer(self.model.get_submodule(path), attr, value.to(self.device))

    @torch.inference_mode()
    def calibrate_int8(self, frames) -> None:
        """Static int8 scales from representative frames (post-training
        calibration): one fp pass a frame records each site's largest
        |activation|, the scales are max / 127 (at least 1e-8), and the
        sites' convs are quantized per output channel. A request without
        scales runs this on its own frame (``_auto_calibrate``); call it with
        a calibration set for better coverage."""
        if not self._int8_needed:
            raise ValueError("no TPU.INT8_* mode is enabled")
        cfg, t = self.cfg, self.cfg.TPU
        mx: Dict[str, np.ndarray] = {}
        for f in frames:
            for k, v in self.model.forward_int8_calibration(image_tensor(f, self.device)).items():
                v = v.float().cpu().numpy()
                mx[k] = v if k not in mx else np.maximum(mx[k], v)
        scales: Dict[str, float] = {}
        bases: List[str] = []

        def put(names, values):
            if len(names) != len(values):
                raise RuntimeError(f"{len(values)} statistics for {len(names)} sites")
            for name, m in zip(names, values):
                scales[name] = _scale_of(m)

        if "head" in mx:
            n = cfg.MODEL.ROI_DENSEPOSE_HEAD.NUM_STACKED_CONVS
            head = self._group_sites("head", len(mx["head"]))
            if t.INT8_HEAD:
                put(head[:n], mx["head"][:n])
                bases += [k[:-len(".in_scale")] for k in head[:n]]
            if t.INT8_PREDICTOR and self._chart_predictor():
                put(head[n:], mx["head"][n:])
                bases += [f"{_PREDICTOR}.{h}" for h in _CHART_HEADS]
        if "backbone" in mx:
            put(self._group_sites("backbone", len(mx["backbone"])), mx["backbone"])
            bases += self._resnet_bases()
        if "hrnet" in mx:
            put(self._group_sites("hrnet", len(mx["hrnet"])), mx["hrnet"])
            bases += hrnet_int8_quant_bases(cfg)
        if "fpn" in mx:
            fpn_sites, rpn_sites = fpn_int8_scale_sites(cfg)
            if len(mx["fpn"]) != len(fpn_sites) + len(rpn_sites):
                raise RuntimeError(f"{len(mx['fpn'])} FPN statistics for "
                                   f"{len(fpn_sites) + len(rpn_sites)} sites")
            if t.INT8_BACKBONE:
                put(fpn_sites, mx["fpn"][:len(fpn_sites)])
                bases += [k[:-len(".in_scale")] for k in fpn_sites]
            if t.INT8_RPN:
                put(rpn_sites, mx["fpn"][len(fpn_sites):])
                bases.append(_RPN_CONV)
        self._quantize_install(scales, bases)
        self.calibration_source = "explicit"

    def _chart_predictor(self) -> bool:
        names = self._param_names()
        return all(f"{_PREDICTOR}.{h}.weight" in names for h in _CHART_HEADS)

    def _resnet_bases(self) -> List[str]:
        prefix = self.model.resnet_prefix()
        pat = re.compile(re.escape(prefix) + r"\.res[2-5]\.\d+\.(conv[123]|shortcut)\.weight$")
        return [k[:-len(".weight")] for k in self._param_names() if pat.match(k)]

    def _group_sites(self, group: str, count: int) -> List[str]:
        """The scale names of one calibration group, in the order of its
        statistics (JAX ``_group_sites``)."""
        cfg = self.cfg
        if group == "head":
            n = cfg.MODEL.ROI_DENSEPOSE_HEAD.NUM_STACKED_CONVS
            names = [f"{_HEAD}.body_conv_fcn{i + 1}.in_scale" for i in range(n)]
            if count == n + 1:  # TPU.INT8_PREDICTOR adds the deconvs' input
                names.append(f"{_PREDICTOR}.in_scale")
        elif group == "backbone":
            names = resnet_int8_scale_sites(cfg, self.model.resnet_prefix())
        elif group == "fpn":
            fpn_sites, rpn_sites = fpn_int8_scale_sites(cfg)
            names = fpn_sites + rpn_sites
        elif group == "hrnet":
            names = hrnet_int8_scale_sites(cfg)
        else:
            raise KeyError(group)
        if len(names) != count:
            raise RuntimeError(f"group {group}: {count} statistics for {len(names)} sites")
        return names

    @torch.inference_mode()
    def saturation_report(self, frames) -> Dict[str, float]:
        """Per installed quantization site, the largest share over ``frames``
        of activations outside its clip range (|x| > 127 * scale), keyed by
        the site's name without ``.in_scale``. Much above ~1e-3 on a
        representative set: calibrate again with more frames."""
        if not self._int8_ready:
            raise ValueError("no int8 calibration installed")
        agg: Dict[str, np.ndarray] = {}
        for f in frames:
            for g, v in self.model.forward_int8_calibration(image_tensor(f, self.device),
                                                            stat="sat").items():
                v = v.float().cpu().numpy()
                agg[g] = v if g not in agg else np.maximum(agg[g], v)
        installed = self._scale_names()
        report = {}
        for g, vec in agg.items():
            for name, v in zip(self._group_sites(g, len(vec)), vec):
                if name in installed:  # only sites actually quantized
                    key = name[:-len(".in_scale")] if name.endswith(".in_scale") else name
                    report[key] = float(v)
        return report

    @torch.inference_mode()
    def _quantize_install(self, scales: Dict[str, float], bases: List[str]) -> None:
        """Install the activation scales and quantize ``bases``'s conv
        weights (``qweight``, ``wscale``); the tail of ``calibrate_int8`` and
        ``load_calibration``."""
        self._install({k: torch.tensor(np.float32(v)) for k, v in scales.items()})
        for b in bases:
            conv = self.model.get_submodule(b)
            qw, sw = quantize_weight_int8(conv.weight,
                                          transposed=isinstance(conv, torch.nn.ConvTranspose2d))
            set_buffer(conv, "qweight", qw)
            set_buffer(conv, "wscale", sw)
        self._int8_ready = True
        self._data_parallel = None  # replicas hold the state they were copied with

    def _int8_quant_bases(self, present) -> List[str]:
        """The convs to quantize, from which activation scales are in
        ``present`` (a set of names): scales install a group at a time, so
        presence names the group (JAX ``_int8_quant_bases``)."""
        cfg = self.cfg
        bases = []
        n = cfg.MODEL.ROI_DENSEPOSE_HEAD.NUM_STACKED_CONVS
        for i in range(n):
            if f"{_HEAD}.body_conv_fcn{i + 1}.in_scale" in present:
                bases.append(f"{_HEAD}.body_conv_fcn{i + 1}")
        if f"{_PREDICTOR}.in_scale" in present:
            bases += [f"{_PREDICTOR}.{h}" for h in _CHART_HEADS]
        prefix = self.model.resnet_prefix()
        if prefix is not None:
            sites = resnet_int8_scale_sites(cfg, prefix)
            if all(s in present for s in sites):
                bases += self._resnet_bases()
        if cfg.MODEL.BACKBONE.NAME == "build_resnet_fpn_backbone":
            fpn_sites, rpn_sites = fpn_int8_scale_sites(cfg)
            if all(s in present for s in fpn_sites):
                bases += [s[:-len(".in_scale")] for s in fpn_sites]
            if all(s in present for s in rpn_sites):
                bases.append(_RPN_CONV)
        if cfg.MODEL.BACKBONE.NAME == "build_hrfpn_backbone":
            if all(s in present for s in hrnet_int8_scale_sites(cfg)):
                bases += hrnet_int8_quant_bases(cfg)
        return bases

    def _required_scale_keys(self) -> List[str]:
        """The activation scales the enabled TPU.INT8_* modes use: exactly
        what ``calibrate_int8`` installs for this config (JAX
        ``_required_scale_keys``): the ResNet's at depth 50 and more (the C4
        backbone's include its unused res5), the ResNet-FPN's output convs'
        at any depth."""
        cfg, t = self.cfg, self.cfg.TPU
        required = []
        if t.INT8_HEAD and cfg.MODEL.DENSEPOSE_ON:
            required += [f"{_HEAD}.body_conv_fcn{i + 1}.in_scale"
                         for i in range(cfg.MODEL.ROI_DENSEPOSE_HEAD.NUM_STACKED_CONVS)]
        if t.INT8_PREDICTOR and cfg.MODEL.DENSEPOSE_ON and self._chart_predictor():
            required.append(f"{_PREDICTOR}.in_scale")
        prefix = self.model.resnet_prefix()
        fpn = cfg.MODEL.BACKBONE.NAME == "build_resnet_fpn_backbone"
        if t.INT8_BACKBONE and prefix is not None and cfg.MODEL.RESNETS.DEPTH >= 50:
            required += resnet_int8_scale_sites(cfg, prefix)
        if t.INT8_BACKBONE and fpn:
            required += fpn_int8_scale_sites(cfg)[0]
        if t.INT8_RPN and fpn:
            required += fpn_int8_scale_sites(cfg)[1]
        if t.INT8_BACKBONE and cfg.MODEL.BACKBONE.NAME == "build_hrfpn_backbone":
            required += hrnet_int8_scale_sites(cfg)
        return required

    def _missing_scales(self, present) -> List[str]:
        return [k for k in self._required_scale_keys() if k not in present]

    def _check_calibration_complete(self, present) -> None:
        """Every enabled int8 mode must be covered whole: a partial group
        would leave some of its convs on the fp path unnoticed."""
        missing = self._missing_scales(present)
        if missing:
            raise ValueError(f"calibration is missing {len(missing)} scales required by the "
                             f"enabled TPU.INT8_* modes, e.g. {missing[:3]}")

    def export_calibration(self) -> Dict[str, float]:
        """The installed activation scales of the enabled groups as {name:
        float}: stray scales (of a mode this config does not enable) never
        reach a sidecar."""
        if not self._int8_ready:
            raise ValueError("calibrate_int8 was never run")
        allowed = set(self._required_scale_keys())
        return {k: float(v) for k, v in self.int8_state().items()
                if is_scale_key(k) and k in allowed}

    def save_calibration(self, path: str) -> None:
        """The activation scales as JSON, the JAX package's format: ship it as
        ``<weights>.calib.json`` and a deployment loads it when it builds the
        predictor, with no calibration pass (weights are quantized again on
        load, deterministically)."""
        with open(path, "w") as f:
            json.dump({"format": CALIB_FORMAT, "scales": self.export_calibration()}, f, indent=1)

    def load_calibration(self, source) -> None:
        """Install scales saved by ``save_calibration`` (a path, or a {name:
        float} dict) and quantize the weights: with the same scales, the state
        ``calibrate_int8`` installs, bit for bit. Scales of groups this config
        does not enable are ignored; a corrupt file, another format, a key
        that is not an activation scale or an incomplete group raise
        ValueError."""
        if not self._int8_needed:
            raise ValueError("no TPU.INT8_* mode is enabled")
        if isinstance(source, str):
            with open(source) as f:
                try:
                    data = json.load(f)
                except json.JSONDecodeError as e:
                    raise ValueError(f"corrupt calibration file {source}: {e}") from e
            if not isinstance(data, dict):
                raise ValueError(f"calibration file {source} is not a JSON object")
            fmt = data.get("format")
            if fmt is not None and fmt != CALIB_FORMAT:
                raise ValueError(f"unrecognized calibration format: {fmt!r}")
            scales = data.get("scales", data)
            if not isinstance(scales, dict):
                raise ValueError(f"calibration file {source}: 'scales' is not a dict")
        else:
            scales = dict(source)
        enabled = set(self._required_scale_keys())
        for k in scales:
            if not is_scale_key(k):
                raise ValueError(f"not an activation-scale key: {k}")
        use = {k: max(float(v), 1e-8) for k, v in scales.items() if k in enabled}
        if len(use) < len(scales):
            logger.info("load_calibration: ignored %d scales for TPU.INT8_* modes this config "
                        "does not enable", len(scales) - len(use))
        present = self._scale_names() | set(use)
        self._check_calibration_complete(present)
        bases = self._int8_quant_bases(present)
        if not bases:
            raise ValueError("calibration contains no usable scales for this config")
        names = self._param_names()
        missing = [b for b in bases if f"{b}.weight" not in names]
        if missing:
            raise ValueError(f"calibration does not match this model: {missing[:3]}")
        self._quantize_install(use, bases)
        self.calibration_source = "explicit"

    def _auto_calibrate(self, frame) -> None:
        """The last resort when a request finds an int8 mode without scales:
        calibrate on this one frame, loudly. A later frame with hotter
        activations saturates at the clip boundary; calibrate on a
        representative set (``calibrate_int8(frames)``) and check it with
        ``saturation_report(frames)``."""
        logger.warning(
            "int8 auto-calibration is running on the FIRST FRAME ONLY; frames with hotter "
            "activations will saturate at the clip boundary. Calibrate on a representative "
            "set (predictor.calibrate_int8(frames)) and verify with "
            "predictor.saturation_report(frames).")
        self.calibrate_int8([frame])
        self.calibration_source = "auto-single-frame"

    # -- the AOT program (JAX predictor.py:622-646) ----------------------------

    def aot_export_bytes(self, shape_hw) -> bytes:
        """The request at one input size (H, W) as a ``torch.export`` program,
        serialized by ``torch.export.save``: ``GeneralizedRCNN.forward`` on an
        (H, W, 3) uint8 frame on this predictor's device, with the weights
        (and an int8 calibration) inside. The kernels are recorded as the
        operators of ``ops/library.py``; the switched DensePose stage as nested
        ``torch.cond`` over its buckets; ``DENSEPOSE_TPU_SPARSE_POOLER`` as it
        is set now. ``aot_load`` runs it in another process with no model
        build. An int8 mode must be calibrated first (``calibrate_int8`` or a
        sidecar)."""
        if self._int8_needed and not self._int8_ready:
            raise ValueError("calibrate the int8 modes (calibrate_int8, or a .calib.json "
                             "sidecar) before exporting the program")
        h, w = (int(v) for v in shape_hw)
        example = torch.zeros((h, w, 3), dtype=torch.uint8, device=self.device)
        with torch.no_grad():
            # an eager request first fills the per-geometry caches (the RPN's
            # anchors) on the device: the program then holds them there as
            # constants, and copies nothing from the host in mid-request
            self.model(example)
            program = torch.export.export(self.model, (example,))
        buf = io.BytesIO()
        torch.export.save(program, buf)
        return buf.getvalue()

    @staticmethod
    def aot_load(data: bytes):
        """bytes of ``aot_export_bytes`` -> a callable ``run(image_bgr_u8)`` of
        the frame alone (numpy or a tensor, of the exported size), returning
        the outputs of ``__call__`` on the program's device; its ``program``
        is the loaded ``ExportedProgram``. The weights are inside the program
        (the JAX package's callable takes them as an argument). Registers the port's operators and sets the backend flags
        a ``DensePosePredictor`` sets."""
        from . import ops  # noqa: F401  (registers the operators the program calls)
        set_backend_flags()
        program = torch.export.load(io.BytesIO(data))
        module = program.module()
        device = next(iter(program.state_dict.values())).device

        def run(image_bgr_u8) -> Dict[str, torch.Tensor]:
            with torch.no_grad():
                return module(image_tensor(image_bgr_u8, device))
        run.program = program  # the ExportedProgram, to inspect
        return run

    @staticmethod
    def start_fetch(outputs: Dict[str, torch.Tensor], keys=None) -> None:
        """Start the device-to-host copies that ``numpy_outputs(outputs,
        keys)`` will read, without blocking: each CUDA tensor is copied into
        pinned host memory on a side stream, which first waits for the work
        queued so far (the outputs' own), so the copies overlap the next
        request's compute. An event recorded after the copies marks when they
        have landed; ``numpy_outputs`` waits on it before it reads. CPU
        tensors need no copy."""
        pending = [v for v in fetch_subset(outputs, keys).values()
                   if isinstance(v, torch.Tensor) and v.is_cuda and not hasattr(v, _HOST_COPY)]
        if not pending:
            return
        device = pending[0].device
        side = torch.cuda.Stream(device=device)
        side.wait_stream(torch.cuda.current_stream(device))
        done = torch.cuda.Event()
        with torch.cuda.stream(side):
            for v in pending:
                src = _payload(v)
                host = torch.empty(v.shape, dtype=src.dtype, pin_memory=True)
                host.copy_(src, non_blocking=True)
                v.record_stream(side)  # its memory is not reused before the copy ends
                setattr(v, _HOST_COPY, (host, done))
            done.record(side)

    @staticmethod
    def numpy_outputs_batch(outputs: Dict[str, torch.Tensor], keys=None, count=None,
                            copy: bool = True) -> List[Dict[str, np.ndarray]]:
        """``numpy_outputs`` of each frame of a batch's outputs (``predict_batch``):
        each key crosses to the host once for the whole batch (through
        ``start_fetch``'s pinned copy where one was started), then splits
        into the first ``count`` frames (all of them by default; a padded
        tail's rows are dropped)."""
        DensePosePredictor.start_fetch(outputs, keys)
        host = {k: _to_numpy(v) for k, v in fetch_subset(outputs, keys).items()}
        n = len(next(iter(host.values()))) if count is None else count
        return [DensePosePredictor.numpy_outputs({k: v[i] for k, v in host.items()}, keys,
                                                 copy) for i in range(n)]

    @staticmethod
    def numpy_outputs(outputs: Dict[str, torch.Tensor], keys=None,
                      copy: bool = True) -> Dict[str, np.ndarray]:
        """Trim padded slots to the valid detections (postprocessing.py:52-61
        key set). DensePose maps are already NCHW; the device postprocess's
        UV map (D, H, W, 2) goes to (n, 2, H, W), as the JAX package's
        ``numpy_outputs`` returns it. Values may be tensors (a copy started
        by ``start_fetch`` is waited for, others are copied now) or numpy
        arrays.

        ``keys``: which ``pred_densepose_*`` maps to fetch; the detections
        always come. When the outputs hold ``det_packed`` (one (D+1, 7)
        array, ``GeneralizedRCNN.pack_detections``) the detections are read
        from it alone, bit-exactly. CUDA tensors cross through
        ``start_fetch``'s pinned copies, which are several times faster than
        a copy into pageable memory.

        ``copy``: return arrays of their own, holding only the valid rows
        (the default). ``copy=False`` returns views where the valid slots are
        a prefix: no host copy, but each map then keeps the whole padded
        (pinned) buffer alive for as long as it is held."""
        DensePosePredictor.start_fetch(outputs, keys)  # where no earlier call started it
        host = {k: _to_numpy(v) for k, v in fetch_subset(outputs, keys).items()}
        if keys is not None and "det_packed" in host:
            packed = host.pop("det_packed")
            header, body = packed[-1], packed[:-1]
            idx = np.nonzero(body[:, 6] > 0.5)[0]
            rows = take_rows(body, idx, copy)
            result = {"image_size": header[1:3].astype(np.int32),
                      "num_instances": int(header[0]),
                      "pred_boxes": rows[:, :4],
                      "scores": rows[:, 4],
                      "pred_classes": rows[:, 5].astype(np.int32)}
        else:
            idx = np.nonzero(host.pop("valid"))[0]
            result = {"image_size": np.array(host["image_size"]),
                      "num_instances": int(host.pop("num_instances"))}
            for k in ("pred_boxes", "scores", "pred_classes"):
                result[k] = take_rows(host[k], idx, copy)
        for k, v in host.items():
            if k.startswith("pred_densepose_"):
                sel = take_rows(v, idx[idx < len(v)], copy)
                result[k] = sel.transpose(0, 3, 1, 2) if k == "pred_densepose_uv" else sel
        return result


CALIB_FORMAT = "densepose-tpu-int8-calib"
_HEAD = "roi_heads.densepose_head"
_PREDICTOR = "roi_heads.densepose_predictor"
_RPN_CONV = "proposal_generator.rpn_head.conv"
_CHART_HEADS = ("ann_index_lowres", "index_uv_lowres", "u_lowres", "v_lowres")


def _scale_of(m) -> float:
    """A site's scale from its largest |activation|: max(m / 127, 1e-8) in
    Python floats, rounded to float32 (JAX predictor.py:197)."""
    return float(np.float32(max(float(m) / 127.0, 1e-8)))


def int8_needed(cfg) -> bool:
    """Whether the config enables an int8 mode that has sites in its model
    (JAX predictor.py:110-125): the head or predictor on a DensePose model;
    the backbone on a bottleneck ResNet (the C4 and RetinaNet ResNets too),
    on ResNet-FPN (FPN's output convs at any depth) or HRFPN; the RPN on
    ResNet-FPN only (elsewhere ``INT8_RPN`` is a no-op, as in JAX)."""
    t, backbone = cfg.TPU, cfg.MODEL.BACKBONE.NAME
    return bool(((t.INT8_HEAD or t.INT8_PREDICTOR) and cfg.MODEL.DENSEPOSE_ON)
                or (t.INT8_BACKBONE and ((resnet_prefix(cfg) is not None
                                          and cfg.MODEL.RESNETS.DEPTH >= 50)
                                         or backbone in ("build_resnet_fpn_backbone",
                                                         "build_hrfpn_backbone")))
                or (t.INT8_RPN and backbone == "build_resnet_fpn_backbone"))


def set_backend_flags() -> None:
    """The process-wide numerics a predictor serves with: no TF32 in cuDNN
    convolutions or cuBLAS matmuls, and no reduced-precision reductions of
    float16 / bfloat16 products."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def cast_parameters(model: torch.nn.Module, dtype: torch.dtype) -> None:
    """Every float32 parameter to ``dtype``; other parameters and every
    buffer as they are (the JAX package's ``_cast_param``). Not
    ``Module.to(dtype)``: that would also cast the float32 normalize
    buffers."""
    for p in model.parameters():
        if p.dtype == torch.float32 and dtype != torch.float32:
            p.data = p.data.to(dtype)


_HOST_COPY = "_densepose_host_copy"  # tensor attribute: (pinned host copy, CUDA event)
_DETECTION_KEYS = ("num_instances", "valid", "image_size", "pred_boxes", "scores",
                   "pred_classes")


def fetch_subset(outputs: Dict, keys=None) -> Dict:
    """The entries ``numpy_outputs(outputs, keys)`` reads: every one without
    ``keys``; else the requested maps and ``det_packed``, or the six
    detection outputs where there is no ``det_packed``."""
    if keys is None:
        return dict(outputs)
    keep = set(keys) | ({"det_packed"} if "det_packed" in outputs else set(_DETECTION_KEYS))
    return {k: v for k, v in outputs.items() if k in keep}


def take_rows(v: np.ndarray, idx: np.ndarray, copy: bool = True) -> np.ndarray:
    """``v[idx]`` for ascending ``idx``, as an array of its own; with
    ``copy=False`` a view when ``idx`` is a prefix, as the valid detections
    mostly are (a frame's maps are then not copied again on the host)."""
    if copy:
        return np.take(v, idx, axis=0)
    return v[:len(idx)] if len(idx) == 0 or idx[-1] == len(idx) - 1 else v[idx]


def _payload(v: torch.Tensor) -> torch.Tensor:
    """What crosses to the host for ``v``: ``v`` itself, or for bfloat16 its
    2-byte payload as int16 (numpy and ``Tensor.numpy`` have no bfloat16)."""
    return v.view(torch.int16) if v.dtype == torch.bfloat16 else v


def bfloat16_to_float32(payload: np.ndarray) -> np.ndarray:
    """bfloat16 values from their 2-byte payload (int16 or uint16) as
    float32, exactly: a bfloat16 is the upper half of a float32."""
    return (payload.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def _to_numpy(v) -> np.ndarray:
    """A tensor or array as numpy: a copy ``start_fetch`` started is waited
    for and taken (once); any other tensor is copied now. A bfloat16 tensor
    comes back as float32 holding its values exactly."""
    if not isinstance(v, torch.Tensor):
        return np.asarray(v)
    started = getattr(v, _HOST_COPY, None)
    if started is None:
        host = _payload(v).cpu().numpy()
    else:
        delattr(v, _HOST_COPY)
        pinned, done = started
        done.synchronize()
        host = pinned.numpy()
    return bfloat16_to_float32(host) if v.dtype == torch.bfloat16 else host
