"""GeneralizedRCNN for the PyTorch port (port of densepose_tpu/models/rcnn.py).

One ``nn.Module`` whose state_dict keys are the reference's names with
FrozenBN folded (``backbone.bottom_up.stem.conv1.weight``,
``proposal_generator.rpn_head.conv.weight``, ``roi_heads.box_head.fc1.weight``
...). Inference runs eagerly, stage by stage:

1. ``preprocess``: the uint8 resize with torch's scale-factor rule, rounded
   and clipped (the reference resizes the uint8 tensor), normalized and
   zero-padded to a multiple of ``size_divisibility`` (32; HRFPN 64) in
   fp32, then cast once to the compute dtype — bit-identical to the JAX
   package;
2. the backbone: ResNet-FPN, HRNet + HRFPN, the RetinaNet FPN, or the plain
   ResNet of the C4 detector;
3. ``rpn_forward`` (NMS through kernel K1);
4. the box stage, by ``ROI_HEADS.NAME``: ``box_stage_forward`` (ROIAlign
   through K2, NMS through K1), or the C4 detector's ``res5_forward``
   (models/res5_roi_heads.py: K2 on res4, the res5 stage on every region,
   K1);
5. the box postprocess (detector_postprocess, postprocessing.py:11-61) and
   ``pack_detections``;
6. the DensePose stage on a detection-count bucket picked on the host
   (one device-to-host sync), zero-padded back to D slots; while
   ``torch.export`` traces, the bucket is picked on the device by nested
   ``torch.cond`` (``forward_densepose_cond``), as the JAX package's
   ``lax.switch``;
7. with ``TPU.DEVICE_POSTPROCESS``, ``device_postprocess``: the SIUV maps
   collapse into a label map and a UV map on the device.

int8 serving (``TPU.INT8_HEAD`` / ``INT8_PREDICTOR`` / ``INT8_BACKBONE`` /
``INT8_RPN``): the model's quantized convs run through kernel Q1 once their
calibration is installed (buffers under the JAX package's names, put there by
the predictor); ``forward_int8_calibration`` is the fp pass that records each
quantization site's statistic, by group (JAX rcnn.py:331-377).

``forward_batch`` runs B same-shaped frames as one batched forward, the JAX
package's ``predict_batch`` (``jax.vmap`` of ``forward`` with its defaults,
predictor.py:612-616): the B frames preprocessed together, the backbone and
every head at batch B (the RPN's and the box stage's NMS one K1 launch each,
the poolers one K2 or K3 launch each, with a frame index per box), the box
postprocess per frame, and the monolithic DensePose stage on all D slots of
every frame (B * D rows), whatever ``TPU.SWITCHED_DENSEPOSE`` and
``TPU.DEVICE_POSTPROCESS`` say: raw maps, fixed shapes, and no value read on
the host. Frame i's outputs are ``forward`` of frame i with the switched
stage and the device postprocess off.

``forward_rows`` (``parallel/mesh.py::spatial_parallel_forward``) runs one
frame with its rows sharded over several devices: the preprocess, backbone
and FPN / HRFPN as row slabs with a halo exchange before every convolution,
pool and upsample that reads a neighbour's rows (``features_rows``,
``parallel/halo.py``), the pyramid gathered onto the first device, and
there the detection stages (``_detect_features``, the part of
``_detect_batch`` after the backbone) and the monolithic DensePose stage:
``forward_batch``'s frame, all D slots and raw maps.

``forward_bucketed`` (``TPU.GEOMETRY_BUCKET_QUANT``) runs the same stages on
a geometry-bucket canvas: the resized image at the top left of a canvas
padded to a multiple of the quantum (``bucket_canvas``), normalized in fp32
and zeroed outside the resized extent, with the RPN's clip and anchor mask
at the minimal-pad extent. Inside that extent the input is bitwise the one
``preprocess`` gives; the wider zero border moves the convolutions' boundary
effects, so outputs agree with ``forward`` within an envelope, not exactly
(tests/test_torch_bucketing.py). ``preprocess`` and ``forward_stage1`` take
a test-resolution override (``min_size`` / ``max_size``), which TTA's views
use.

Each stage runs inside a ``torch.profiler.record_function`` range of its
name, so a profile of one request reads the device time of every stage.

Compute dtype (``TPU.COMPUTE_DTYPE``: float32, float16 or bfloat16), the JAX
package's policy: the predictor casts every float32 parameter to it, and
activations stay in it from the preprocess cast on (convolutions, linears,
upsamples, the poolers' outputs, the DensePose maps). The fp32 islands are
the reference's: the RPN's logits before its top-k, box decoding, the box
softmax, NMS (boxes and scores), GroupNorm's statistics, the device
postprocess's argmaxes, and every detection output (boxes, scores,
``det_packed``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from ..checkpoint.spec import Spec
from ..ops.boxes import clip_boxes, nonempty_boxes
from ..ops.resize import resize_image, resize_image_rows, source_rows
from ..parallel.halo import RowSlabs, Shards, gather, row_bounds
from .backbones import backbone_rows, backbone_spec, build_backbone
from .res5_roi_heads import Res5ROIHeads, res5_forward_batch, res5_spec
from .roi_heads import (ROIHeads, box_stage_forward_batch, densepose_stacked_calibration,
                        densepose_stage_forward, frame_index, roi_heads_spec)
from .rpn import RPNHead, rpn_forward_batch, rpn_spec


# TPU.COMPUTE_DTYPE -> the dtype of parameters and activations
COMPUTE_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                  "bfloat16": torch.bfloat16}


def compute_resize(h: int, w: int, min_size: int, max_size: int) -> Tuple[float, int, int]:
    """DefaultPredictor resize rule (defaults.py:85-89): one scale k, output
    floor(h*k) x floor(w*k)."""
    k = min(min_size / min(h, w), max_size / max(h, w))
    return k, int(h * k), int(w * k)


def size_divisibility(cfg) -> int:
    """What the network input is padded to a multiple of (JAX
    rcnn.py::size_divisibility): the FPN's largest stride, 32 (fpn.py:116);
    for HRFPN 64, so that the average-pool pyramid divides exactly down to
    p5 (stride 64) and the decoder's chains of 2x upsamples line up with p1."""
    return 64 if cfg.MODEL.BACKBONE.NAME == "build_hrfpn_backbone" else 32


def pad_to_divisible(h: int, w: int, d: int) -> Tuple[int, int]:
    return (int(math.ceil(h / d) * d), int(math.ceil(w / d) * d))


def _check_supported(cfg) -> None:
    if cfg.MODEL.META_ARCHITECTURE != "GeneralizedRCNN":
        raise NotImplementedError(cfg.MODEL.META_ARCHITECTURE)
    if cfg.MODEL.ROI_HEADS.NAME == "Res5ROIHeads" and cfg.MODEL.DENSEPOSE_ON:
        raise ValueError("Res5ROIHeads has no DensePose heads: set MODEL.DENSEPOSE_ON False "
                         "for the C4 detector (the JAX package's spec holds no decoder or "
                         "DensePose head under it, and its forward fails on "
                         "'roi_heads.decoder.res4.0.weight')")
    t = cfg.TPU
    if t.COMPUTE_DTYPE not in COMPUTE_DTYPES:
        raise ValueError(f"TPU.COMPUTE_DTYPE {t.COMPUTE_DTYPE!r}: expected one of "
                         f"{sorted(COMPUTE_DTYPES)}")


class ProposalGenerator(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.rpn_head = RPNHead(cfg)


class GeneralizedRCNN(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.compute_dtype = COMPUTE_DTYPES[cfg.TPU.COMPUTE_DTYPE]
        self.size_divisibility = size_divisibility(cfg)
        self.register_buffer("pixel_mean", torch.tensor(cfg.MODEL.PIXEL_MEAN,
                                                        dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.MODEL.PIXEL_STD,
                                                       dtype=torch.float32), persistent=False)
        self.backbone = build_backbone(cfg)
        self.proposal_generator = ProposalGenerator(cfg)
        self.res5 = cfg.MODEL.ROI_HEADS.NAME == "Res5ROIHeads"
        self.roi_heads = Res5ROIHeads(cfg) if self.res5 else ROIHeads(cfg)

    def spec(self) -> Spec:
        """Reference-layout (unfolded) parameter spec, in the JAX package's
        order: checkpoint alignment and random init read it. The C4 spec
        holds the backbone's four stages (res5 unused), the RPN, then
        ``roi_heads.res5``."""
        spec = backbone_spec(self.cfg)
        spec.update(rpn_spec(self.cfg))
        spec.update(res5_spec(self.cfg) if self.res5 else roi_heads_spec(self.cfg))
        return spec

    def resnet_prefix(self) -> Optional[str]:
        """Param prefix of the ResNet, or None for HRNet (the int8 backbone's
        bottleneck sites apply to ResNets only; JAX rcnn.py:233-242)."""
        return resnet_prefix(self.cfg)

    def forward_int8_calibration(self, image_u8: torch.Tensor,
                                 stat: str = "max") -> Dict[str, torch.Tensor]:
        """One fp pass per enabled group recording each quantization site's
        statistic (``stat``: "max" seeds the scales, "sat" measures
        saturation; JAX ``forward_int8_calibration``): ``head`` (the DensePose
        stacked convs' inputs, and the chart deconvs' with INT8_PREDICTOR,
        on the request's own detections), ``backbone`` (ResNet's block sites),
        ``fpn`` (FPN output convs, then the RPN conv per level) and ``hrnet``.
        The backbone, FPN and detection stages run as the model serves them,
        int8 where installed, as the JAX walks do."""
        cfg, t = self.cfg, self.cfg.TPU
        out = {}
        if (t.INT8_HEAD or t.INT8_PREDICTOR) and cfg.MODEL.DENSEPOSE_ON:
            _, features, boxes_net = self.forward_stage1(image_u8)
            out["head"] = densepose_stacked_calibration(self.roi_heads, features, boxes_net,
                                                        cfg, stat)
        resnet = self.resnet_prefix() is not None and cfg.MODEL.RESNETS.DEPTH >= 50
        fpn = cfg.MODEL.BACKBONE.NAME == "build_resnet_fpn_backbone"
        hrnet = cfg.MODEL.BACKBONE.NAME == "build_hrfpn_backbone"
        if t.INT8_BACKBONE and (resnet or hrnet) or (t.INT8_BACKBONE or t.INT8_RPN) and fpn:
            x, _, _ = self.preprocess(image_u8)
            if t.INT8_BACKBONE and resnet:
                out["backbone"] = self.get_submodule(self.resnet_prefix()).int8_calibration(
                    x, stat)
            if fpn:
                out["fpn"] = self.backbone.int8_calibration(
                    x, self.proposal_generator.rpn_head.conv, list(cfg.MODEL.RPN.IN_FEATURES),
                    stat)
            if t.INT8_BACKBONE and hrnet:
                out["hrnet"] = self.backbone.int8_calibration(x, stat)
        return out

    def resized_size(self, h0: int, w0: int, min_size: Optional[int] = None,
                     max_size: Optional[int] = None) -> Tuple[float, int, int]:
        """(k, h1, w1) of an (h0, w0) frame at the config's test resolution,
        or at ``min_size`` / ``max_size`` where given (TTA's views)."""
        return compute_resize(h0, w0, min_size or self.cfg.INPUT.MIN_SIZE_TEST,
                              max_size or self.cfg.INPUT.MAX_SIZE_TEST)

    def resize_u8(self, image_u8: torch.Tensor, min_size: Optional[int] = None,
                  max_size: Optional[int] = None) -> torch.Tensor:
        """The reference's uint8 resize, in network channel order, as fp32
        holding integers: (h1, w1, 3), or (B, h1, w1, 3) of (B, H0, W0, 3)
        frames."""
        k, h1, w1 = self.resized_size(image_u8.shape[-3], image_u8.shape[-2], min_size,
                                      max_size)
        x = image_u8
        if self.cfg.INPUT.FORMAT == "RGB":  # defaults.py:81-83
            x = x.flip(-1)
        y = resize_image(x, (h1, w1), scale=(k, k))
        # the reference resizes the uint8 tensor: round-to-nearest-even, clip
        return torch.round(y).clamp(0, 255)

    def preprocess(self, image_u8: torch.Tensor, min_size: Optional[int] = None,
                   max_size: Optional[int] = None):
        """image_u8: (H0, W0, 3) uint8 BGR on the model's device. Returns
        (padded image (1, 3, Hp, Wp) in the compute dtype, (h1, w1) resized
        size, (Hp, Wp)). Everything up to the cast runs in fp32, as in the JAX
        package (rcnn.py:143-155). ``min_size`` / ``max_size`` override the
        config's test resolution."""
        return self.preprocess_batch(image_u8[None], min_size, max_size)

    def preprocess_batch(self, images_u8: torch.Tensor, min_size: Optional[int] = None,
                         max_size: Optional[int] = None):
        """``preprocess`` of B same-shaped frames (B, H0, W0, 3) uint8 at once,
        one resize table for all: (B, 3, Hp, Wp) in the compute dtype, whose
        frame i is bitwise ``preprocess`` of frame i, (h1, w1) and (Hp, Wp)."""
        y = self.resize_u8(images_u8, min_size, max_size)
        h1, w1 = y.shape[1], y.shape[2]
        hp, wp = pad_to_divisible(h1, w1, self.size_divisibility)
        y = (y - self.pixel_mean) / self.pixel_std
        y = torch.nn.functional.pad(y.permute(0, 3, 1, 2), (0, wp - w1, 0, hp - h1))
        return y.to(self.compute_dtype).contiguous(), (h1, w1), (hp, wp)

    def preprocess_rows(self, image_u8: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
        """Rows [r0, r1) of ``preprocess``'s padded input, (1, 3, r1 - r0, Wp)
        in the compute dtype on this model's device, bitwise those rows: the
        uint8 resize of the source rows they read (only those rows of
        ``image_u8``, (H0, W0, 3) uint8 anywhere, are copied here), rounded
        and clipped, normalized, zero at rows >= h1 and columns >= w1, cast
        once."""
        h0, w0 = int(image_u8.shape[0]), int(image_u8.shape[1])
        k, h1, w1 = self.resized_size(h0, w0)
        _, wp = pad_to_divisible(h1, w1, self.size_divisibility)
        dev = self.pixel_mean.device
        top = min(r1, h1)  # the slab's last resized row, + 1
        if top > r0:
            lo, hi = source_rows(h0, h1, k, r0, top)
            x = image_u8[lo:hi].to(dev)
            if self.cfg.INPUT.FORMAT == "RGB":  # defaults.py:81-83
                x = x.flip(-1)
            y = torch.round(resize_image_rows(x, h0, (h1, w1), (k, k), r0, top)).clamp(0, 255)
            y = (y - self.pixel_mean) / self.pixel_std
            y = torch.nn.functional.pad(y.permute(2, 0, 1), (0, wp - w1, 0, r1 - top))
        else:
            y = torch.zeros((3, r1 - r0, wp), device=dev)
        return y[None].to(self.compute_dtype).contiguous()

    def forward_stage1(self, image_u8: torch.Tensor, min_size: Optional[int] = None,
                       max_size: Optional[int] = None):
        """Preprocess -> backbone -> RPN -> box stage -> box postprocess.
        Returns (result dict without DensePose, features, boxes_net): the
        detection boxes in network (resized) coordinates feed the DensePose
        pooler. ``min_size`` / ``max_size``: a test-resolution override (TTA's
        views)."""
        h0, w0 = int(image_u8.shape[0]), int(image_u8.shape[1])
        with record_function("preprocess"):
            x, (h1, w1), (hp, wp) = self.preprocess(image_u8, min_size, max_size)
        # detector_postprocess's rescale: w0 / w1 in double, then rounded to fp32
        scale = device_values([w0 / w1, h0 / h1], torch.float32, image_u8.device)
        return self._detect(x, (hp, wp), None, (h0, w0), scale)

    def _detect(self, x: torch.Tensor, clip_hw: Tuple[int, int], anchor_valid_hw,
                orig_hw: Tuple[int, int], scale_xy: torch.Tensor):
        """Backbone -> RPN -> box stage -> box postprocess on a normalized
        input ``x`` (1, 3, Hp, Wp); the RPN clips to ``clip_hw`` and masks
        anchors beyond ``anchor_valid_hw`` (or none); the boxes go back to the
        original resolution by the fp32 factors ``scale_xy`` (x, y). Returns
        the frame's result, the (batch-1) features and its boxes_net (D, 4)."""
        result, features, boxes_net = self._detect_batch(x, clip_hw, anchor_valid_hw,
                                                         orig_hw, scale_xy)
        return {k: v[0] for k, v in result.items()}, features, boxes_net[0]

    def _detect_batch(self, x: torch.Tensor, clip_hw: Tuple[int, int], anchor_valid_hw,
                      orig_hw: Tuple[int, int], scale_xy: torch.Tensor):
        """``_detect`` of B frames of one size, x (B, 3, Hp, Wp): every
        result (B, ...), the features (B, C, H, W) per level and boxes_net
        (B, D, 4)."""
        with record_function("backbone"):
            features = self.backbone(x)
        return self._detect_features(features, clip_hw, anchor_valid_hw, orig_hw, scale_xy)

    def _detect_features(self, features: Dict[str, torch.Tensor], clip_hw: Tuple[int, int],
                         anchor_valid_hw, orig_hw: Tuple[int, int], scale_xy: torch.Tensor):
        """``_detect_batch`` from the backbone's features (B, C, H, W) per
        level: RPN -> box stage -> box postprocess."""
        cfg = self.cfg
        h0, w0 = orig_hw
        b = next(iter(features.values())).shape[0]
        with record_function("rpn"):
            proposals, _, pvalid = rpn_forward_batch(self.proposal_generator.rpn_head,
                                                     features, clip_hw, cfg, anchor_valid_hw)
        with record_function("box_stage"):
            stage = res5_forward_batch if self.res5 else box_stage_forward_batch
            boxes_net, scores, classes, dvalid = stage(self.roi_heads, features, proposals,
                                                       pvalid, cfg)

        with record_function("postprocess"):
            # detector_postprocess: rescale to the original resolution, drop
            # empty boxes, clip with the correct (H, W) order
            boxes = boxes_net * scale_xy.repeat(2)
            valid = dvalid & nonempty_boxes(boxes)
            boxes = clip_boxes(boxes, (h0, w0))
            size = device_values([h0, w0], torch.int32, boxes.device)
            result = {
                "image_size": size.expand(b, 2),
                "pred_boxes": boxes,
                "scores": scores,
                "pred_classes": classes,
                "valid": valid,
                "num_instances": valid.sum(-1).int(),
            }
            result["det_packed"] = self.pack_detections(result)
        return result, features, boxes_net

    def bucket_canvas(self, image_u8: torch.Tensor, quant: int):
        """The geometry-bucket canvas of a frame on its device: the uint8
        resize at the top left of an (HB, WB, 3) uint8 canvas, HB and WB the
        resized size rounded up to a multiple of ``quant``, zero elsewhere.
        Bitwise the host's ``DensePosePredictor.bucketize``. Returns (canvas,
        (h0, w0, h1, w1))."""
        h0, w0 = int(image_u8.shape[0]), int(image_u8.shape[1])
        y = self.resize_u8(image_u8)
        h1, w1 = y.shape[0], y.shape[1]
        hb, wb = -(-h1 // quant) * quant, -(-w1 // quant) * quant
        canvas = torch.zeros((hb, wb, 3), dtype=torch.uint8, device=image_u8.device)
        canvas[:h1, :w1] = y.to(torch.uint8)
        return canvas, (h0, w0, h1, w1)

    def preprocess_bucketed(self, canvas_u8: torch.Tensor, h1: int, w1: int) -> torch.Tensor:
        """A bucket canvas normalized in fp32, zero outside its top-left
        (h1, w1), cast once: (1, 3, HB, WB) in the compute dtype, bitwise
        ``preprocess``'s input inside the minimal-pad extent (JAX
        rcnn.py:244-257)."""
        x = (canvas_u8.float() - self.pixel_mean) / self.pixel_std
        inside = torch.zeros(canvas_u8.shape[:2], dtype=torch.bool, device=x.device)
        inside[:h1, :w1] = True
        x = torch.where(inside[..., None], x, torch.zeros((), device=x.device))
        return x.permute(2, 0, 1)[None].to(self.compute_dtype).contiguous()

    def forward_bucketed(self, canvas_u8: torch.Tensor,
                         sizes: Tuple[int, int, int, int]) -> Dict[str, torch.Tensor]:
        """Full inference from a geometry-bucket canvas (JAX rcnn.py:259-329):
        ``canvas_u8`` (HB, WB, 3) uint8 from ``bucket_canvas``, ``sizes`` =
        (h0, w0, h1, w1). The RPN's swapped clip and its anchor mask use the
        minimal-pad extent (``pad_to_divisible`` at the size divisibility),
        not the canvas; the boxes rescale by w0 / w1 and h0 / h1 divided in
        fp32, as the JAX package divides its traced sizes. Outputs as
        ``forward``'s."""
        h0, w0, h1, w1 = sizes
        with record_function("preprocess"):
            x = self.preprocess_bucketed(canvas_u8, h1, w1)
        hp, wp = pad_to_divisible(h1, w1, self.size_divisibility)
        scale = torch.as_tensor(np.float32([w0, h0]) / np.float32([w1, h1]),
                                device=canvas_u8.device)
        result, features, boxes_net = self._detect(x, (hp, wp), (hp, wp), (h0, w0), scale)
        return self._with_densepose(result, features, boxes_net)

    @staticmethod
    def pack_detections(result: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One (D+1, 7) f32 array with every small detection output (of a
        batch's results, (B, D+1, 7)). Rows 0..D-1: [x1, y1, x2, y2, score,
        class, valid]; the last row: [num_instances, H, W, 0, 0, 0, 0]. Every
        value is exact in f32."""
        packed = torch.cat([
            result["pred_boxes"].float(),
            result["scores"].float()[..., None],
            result["pred_classes"].float()[..., None],
            result["valid"].float()[..., None],
        ], dim=-1)
        lead = packed.shape[:-2]
        header = torch.cat([result["num_instances"].float()[..., None],
                            result["image_size"].float(),
                            packed.new_zeros(lead + (4,))], dim=-1)
        return torch.cat([packed, header[..., None, :]], dim=-2)

    def forward_densepose(self, features: Dict[str, torch.Tensor],
                          boxes_net: torch.Tensor) -> Dict[str, torch.Tensor]:
        dp = densepose_stage_forward(self.roi_heads, features, boxes_net, self.cfg)
        return {f"pred_densepose_{k}": v for k, v in dp.items()}

    def forward_densepose_switched(self, features: Dict[str, torch.Tensor],
                                   boxes_net: torch.Tensor,
                                   num_valid: int) -> Dict[str, torch.Tensor]:
        """The DensePose stage on the smallest bucket in {8, 32, D} covering
        ``num_valid`` (valid detections are a score-sorted prefix), outputs
        zero-padded to D slots: the JAX package's ``lax.switch`` branches,
        chosen on the host."""
        d = boxes_net.shape[0]
        b = densepose_bucket(num_valid, d)
        dp = self.forward_densepose(features, boxes_net[:b])
        if d == b:
            return dp
        with record_function("densepose_pad"):
            return {k: torch.cat([v, v.new_zeros((d - b,) + tuple(v.shape[1:]))])
                    for k, v in dp.items()}

    def forward_densepose_cond(self, features: Dict[str, torch.Tensor], boxes_net: torch.Tensor,
                               num_valid: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``forward_densepose_switched`` as an exported program holds it:
        nested ``torch.cond`` on the count (the JAX package's ``lax.switch``,
        rcnn.py:375-407) over every bucket's branch, each padded to D slots,
        so that one program serves any count. Run eagerly, the program reads
        the count on the host once, as ``forward_densepose_switched`` does."""
        d = boxes_net.shape[0]
        names = sorted(features)
        buckets = [b for b in (8, 32) if b < d] + [d]

        def branch(b):
            def run(boxes, *maps):
                dp = self.forward_densepose_switched(dict(zip(names, maps)), boxes, b)
                return {k: v.contiguous() for k, v in dp.items()}
            return run

        def switch(i):  # the buckets from the i-th on
            if i == len(buckets) - 1:
                return branch(buckets[i])
            return lambda *ops: torch.cond(num_valid > buckets[i], switch(i + 1),
                                           branch(buckets[i]), ops)

        return switch(0)(boxes_net, *[features[k] for k in names])

    def forward(self, image_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Full single-image inference: fixed-size slots + num_instances,
        DensePose maps NCHW (D, C, HEATMAP, HEATMAP)."""
        return self._with_densepose(*self.forward_stage1(image_u8))

    def forward_batch(self, images_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """B same-shaped frames (B, H0, W0, 3) uint8 BGR on the model's device
        as one batched forward (the JAX package's vmapped ``forward``): every
        output (B, ...) (``image_size`` (B, 2), ``num_instances`` (B,),
        ``det_packed`` (B, D+1, 7), the raw DensePose maps (B, D, C, HEATMAP,
        HEATMAP)). The DensePose stage is the monolithic one on all D slots,
        with no device postprocess; nothing is read on the host."""
        b, h0, w0 = (int(v) for v in images_u8.shape[:3])
        with record_function("preprocess"):
            x, (h1, w1), (hp, wp) = self.preprocess_batch(images_u8)
        scale = device_values([w0 / w1, h0 / h1], torch.float32, images_u8.device)
        result, features, boxes_net = self._detect_batch(x, (hp, wp), None, (h0, w0), scale)
        if self.cfg.MODEL.DENSEPOSE_ON:
            result.update(self.forward_densepose_batch(features, boxes_net))
        return result

    def forward_densepose_batch(self, features: Dict[str, torch.Tensor],
                                boxes_net: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The DensePose stage on every slot of B frames: boxes_net (B, D, 4)
        in B frames' features, as B * D rows (one pooler launch, the head and
        predictor over B * D); maps (B, D, C, HEATMAP, HEATMAP)."""
        b, d = boxes_net.shape[:2]
        dp = densepose_stage_forward(self.roi_heads, features, boxes_net.reshape(-1, 4),
                                     self.cfg, frame_index(b, d, boxes_net.device))
        return {f"pred_densepose_{k}": v.reshape((b, d) + tuple(v.shape[1:]))
                for k, v in dp.items()}

    def features_rows(self, image_u8: torch.Tensor, shards: Shards):
        """The preprocess, backbone and FPN / HRFPN of one frame (H0, W0, 3)
        uint8 as row slabs over ``shards`` (``parallel/halo.py``), the input's
        rows cut into whole blocks of the size divisibility; the pyramid
        gathered onto the first device. Returns (features (1, C, H, W) per
        level, (Hp, Wp), (h1, w1))."""
        h0, w0 = int(image_u8.shape[0]), int(image_u8.shape[1])
        _, h1, w1 = self.resized_size(h0, w0)
        hp, wp = pad_to_divisible(h1, w1, self.size_divisibility)
        bounds = row_bounds(hp, self.size_divisibility, len(shards))
        with record_function("preprocess"):
            x = RowSlabs([shards.module(self, i).preprocess_rows(image_u8, r0, r1)
                          if r1 > r0 else None
                          for i, (r0, r1) in enumerate(zip(bounds[:-1], bounds[1:]))],
                         bounds, shards)
        with record_function("backbone"):
            levels = backbone_rows(self.cfg, self.backbone, x)
        with record_function("gather"):
            features = {k: gather(v, shards.devices[0], k) for k, v in levels.items()}
        return features, (hp, wp), (h1, w1)

    def forward_rows(self, image_u8: torch.Tensor, shards: Shards) -> Dict[str, torch.Tensor]:
        """One frame (H0, W0, 3) uint8 with its rows sharded over ``shards``
        (``parallel/mesh.py::spatial_parallel_forward``, the JAX package's
        ``forward`` under its row sharding): ``features_rows``, then on the
        first device the detection stages and the monolithic DensePose stage
        unchanged. Outputs as ``forward_batch``'s frame: all D slots, raw
        maps, no batch dimension."""
        h0, w0 = int(image_u8.shape[0]), int(image_u8.shape[1])
        features, hw, (h1, w1) = self.features_rows(image_u8, shards)
        scale = device_values([w0 / w1, h0 / h1], torch.float32, shards.devices[0])
        result, features, boxes_net = self._detect_features(features, hw, None, (h0, w0), scale)
        result = {k: v[0] for k, v in result.items()}
        if self.cfg.MODEL.DENSEPOSE_ON:
            result.update(self.forward_densepose(features, boxes_net[0]))
        return result

    def _with_densepose(self, result, features, boxes_net) -> Dict[str, torch.Tensor]:
        """Stage 1's result with the DensePose stage (switched on the count,
        and collapsed by the device postprocess, as the config says)."""
        if self.cfg.MODEL.DENSEPOSE_ON:
            if self.cfg.TPU.SWITCHED_DENSEPOSE and torch.compiler.is_exporting():
                dp = self.forward_densepose_cond(features, boxes_net, result["num_instances"])
            elif self.cfg.TPU.SWITCHED_DENSEPOSE:
                # the one device-to-host sync of the request
                dp = self.forward_densepose_switched(features, boxes_net,
                                                     int(result["num_instances"]))
            else:
                dp = self.forward_densepose(features, boxes_net)
            if self.cfg.TPU.DEVICE_POSTPROCESS and "pred_densepose_u" in dp:
                with record_function("densepose_postprocess"):
                    dp = device_postprocess(dp)
            result.update(dp)
        return result


_SIUV = ("pred_densepose_coarse_segm", "pred_densepose_fine_segm", "pred_densepose_u",
         "pred_densepose_v")


def device_postprocess(dp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The SIUV maps (D, C, H, W) collapsed on the device (port of JAX
    rcnn.py:410-445): ``pred_densepose_labels`` (D, H, W) uint8, the fine-segm
    argmax where the coarse argmax is foreground, else 0, and
    ``pred_densepose_uv`` (D, H, W, 2) float16, U and V at that label (0 on
    background). Other maps (``TPU.EMIT_CONFIDENCES``) pass through.

    As in the JAX package, the argmax is taken at the heatmap grid; the
    reference takes it after resizing the logits to the box
    (visualizer.py:10-17), so boundaries may move by about a pixel at box
    scale."""
    coarse = dp["pred_densepose_coarse_segm"].float()
    fine = dp["pred_densepose_fine_segm"].float()
    fg = coarse.argmax(dim=1) > 0
    labels = fine.argmax(dim=1).int() * fg
    lab = labels[:, None].long()
    zero = torch.zeros((), dtype=dp["pred_densepose_u"].dtype, device=fg.device)
    uv = torch.stack([torch.where(fg, dp[k].gather(1, lab)[:, 0], zero)
                      for k in ("pred_densepose_u", "pred_densepose_v")], dim=-1)
    out = {"pred_densepose_labels": labels.to(torch.uint8),
           "pred_densepose_uv": uv.half()}
    out.update({k: v for k, v in dp.items() if k not in _SIUV})
    return out


def densepose_bucket(num_valid: int, d: int) -> int:
    """The smallest of the buckets {8, 32, d} that holds ``num_valid``."""
    buckets = [b for b in (8, 32) if b < d] + [d]
    return buckets[sum(int(num_valid > x) for x in buckets[:-1])]


def build_model(cfg) -> GeneralizedRCNN:
    return GeneralizedRCNN(cfg)


def resnet_prefix(cfg) -> Optional[str]:
    """Where a config's ResNet lies: ``backbone.bottom_up`` under the FPNs,
    ``backbone`` for the C4 backbone, None for HRNet."""
    name = cfg.MODEL.BACKBONE.NAME
    if name in ("build_resnet_fpn_backbone", "build_retinanet_resnet_fpn_backbone"):
        return "backbone.bottom_up"
    return "backbone" if name == "build_resnet_backbone" else None


def check_image(image_bgr_u8: np.ndarray) -> np.ndarray:
    """The frame as a C-contiguous (H, W, 3) uint8 array, or ValueError."""
    image = np.asarray(image_bgr_u8)
    if image.ndim != 3 or image.shape[2] != 3 or image.dtype != np.uint8:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {image.dtype} "
                         f"{image.shape}")
    return np.ascontiguousarray(image)


def image_tensor(image_bgr_u8, device) -> torch.Tensor:
    """(H, W, 3) uint8 frame, numpy or an already uploaded tensor (the
    predictor's ``stage_input``) -> a uint8 tensor on ``device``."""
    if isinstance(image_bgr_u8, torch.Tensor):
        if image_bgr_u8.dim() != 3 or image_bgr_u8.shape[2] != 3 \
                or image_bgr_u8.dtype != torch.uint8:
            raise ValueError(f"expected an (H, W, 3) uint8 image, got {image_bgr_u8.dtype} "
                             f"{tuple(image_bgr_u8.shape)}")
        return image_bgr_u8.to(device)
    return torch.from_numpy(check_image(image_bgr_u8)).to(device)


def batch_tensor(images_bgr_u8, device) -> torch.Tensor:
    """(B, H, W, 3) uint8 frames, numpy or a tensor -> a contiguous uint8
    tensor on ``device``; ValueError otherwise. Host frames go to a CUDA
    device through pinned memory, without waiting for its queued work."""
    images = images_bgr_u8 if isinstance(images_bgr_u8, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(np.asarray(images_bgr_u8)))
    if images.dim() != 4 or images.shape[-1] != 3 or images.dtype != torch.uint8:
        raise ValueError(f"expected (B, H, W, 3) uint8 frames, got {images.dtype} "
                         f"{tuple(images.shape)}")
    if torch.device(device).type == "cuda" and images.device.type == "cpu":
        return images.contiguous().pin_memory().to(device, non_blocking=True)
    return images.to(device).contiguous()


def device_values(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A 1-D tensor of Python numbers made on ``device`` (each rounded to
    ``dtype`` as ``torch.tensor`` rounds it), with no copy from the host: a
    copy from pageable memory waits for the device's queued work, a host
    sync in the middle of a request."""
    return torch.stack([torch.full((), v, dtype=dtype, device=device) for v in values])
