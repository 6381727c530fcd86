"""ROI heads: the box path and the DensePose path, static shapes (port of
densepose_tpu/models/roi_heads.py), NCHW.

* FastRCNNConvFCHead (2 FC) + FastRCNNOutputLayers + fast_rcnn_inference:
  7x7 ROIAlign over the ROI_HEADS.IN_FEATURES levels (kernel K2; FPN's
  p2..p5, HRFPN's p1..p5), the NCHW flatten into fc1, softmax
  in fp32, the reference's discarded clip, NMS (kernel K1), top-D.
* The Panoptic-FPN style Decoder in its per-chain form (each chain upsamples
  on its own, the reference's order).
* The DensePose pooler: single-level ROIAlign on the decoder map (K2), or,
  for the legacy configs (``DECODER_ON=False``), multi-level ROIAlign over
  the FPN levels (K2, or K3 with ``DENSEPOSE_TPU_SPARSE_POOLER``).
* DensePoseV1ConvXHead or DensePoseDeepLabHead (ASPP with GroupNorm, then
  convs with GroupNorm, with a bias, or with FrozenBN folded in: DEEPLAB.NORM),
  and the chart predictor's four separate deconv heads with a 2x
  bilinear upsample; with ``TPU.EMIT_CONFIDENCES`` the WC predictors'
  confidence heads too.
* int8 serving (JAX roi_heads.py:350-416, 469-471, 510-560): with
  ``TPU.INT8_HEAD`` and calibrated scales installed, the stacked convs run as
  an s8 chain through kernel Q1 (``ops/conv_int8.py``; DeepLab: each GN link
  dequantizes to the compute dtype, one-pass GroupNorm, ReLU, requantizes);
  uncalibrated, each conv quantizes dynamically (``conv2d_int8``). With
  ``TPU.INT8_PREDICTOR`` the four chart deconvs run as ONE Q1 launch of the
  concatenated 77 channels (channelwise bit-identical to four), the WC
  confidence heads stay fp on the same input. ``densepose_stacked_calibration``
  is the fp walk that records each site's input statistic. A CSE config (``DensePoseEmbeddingPredictor``)
  takes the embedding predictor instead (``models/cse.py``: an embedding
  and a coarse segmentation map) and holds the vertex embedders' tables.

Boxes, scores and valid masks keep the JAX package's fixed slots. Every
stage also runs B frames at once (``box_stage_forward_batch``,
``densepose_stage_forward`` with a frame index): the poolers take the B
frames' maps and each box's frame, one launch for all of them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..checkpoint.spec import Spec, conv_spec, conv_transpose_spec, gn_spec, linear_spec
from ..ops.boxes import apply_deltas
from ..ops.conv_int8 import (act_stat, conv2d_int8, conv_s8, make_epilogue, link, quant_act_s8,
                             quantized, to_nchw, to_s8_nhwc)
from ..ops.nms import nms_mask, per_class_nms_mask
from ..ops.norms import Conv2dNorm, GroupNorm32, group_norm_onepass
from ..ops.resize import resize_bilinear
from ..ops.roi_align import assign_boxes_to_levels, roi_align_multilevel, roi_align_single
from ..utils.timing import span
from .backbones import backbone_out_channels, feature_strides
from .cse import DensePoseEmbeddingPredictor, Embedder, embedder_spec, embedding_predictor_spec
from .rpn import top_k

_NEG = -1e30
# DEEPLAB.NORM: the body convs' norm (JAX roi_heads.py:146-149): GroupNorm; none
# (a bias); or FrozenBN, folded into the convs at load
_DEEPLAB_NORMS = ("GN", "", "FrozenBN")
_CHART_HEADS = ("ann_index_lowres", "index_uv_lowres", "u_lowres", "v_lowres")


def _check_supported(cfg) -> None:
    h = cfg.MODEL.ROI_DENSEPOSE_HEAD
    if cfg.MODEL.ROI_BOX_HEAD.NUM_CONV:
        raise NotImplementedError("ROI_BOX_HEAD.NUM_CONV: the JAX package declares the convs "
                                  "but its box stage runs only the FCs (roi_heads.py:74-79, "
                                  "234-241); the port refuses it rather than copy that")
    if cfg.MODEL.DENSEPOSE_ON:
        if h.NAME not in ("DensePoseV1ConvXHead", "DensePoseDeepLabHead"):
            raise NotImplementedError(f"DensePose head {h.NAME!r} is not ported yet")
        if h.NAME == "DensePoseDeepLabHead":
            if h.DEEPLAB.NONLOCAL_ON:
                raise NotImplementedError("DEEPLAB.NONLOCAL_ON: the JAX package's spec asserts "
                                          "it off (roi_heads.py:131-132), as every shipped "
                                          "config sets it")
            if h.DEEPLAB.NORM not in _DEEPLAB_NORMS:
                raise NotImplementedError(f"DEEPLAB.NORM {h.DEEPLAB.NORM!r}: the JAX package "
                                          f"runs {sorted(_DEEPLAB_NORMS)}")
            if h.DEEPLAB.NORM == "FrozenBN" and not cfg.TPU.FOLD_FROZEN_BN:
                raise ValueError("DEEPLAB.NORM FrozenBN needs TPU.FOLD_FROZEN_BN: the JAX "
                                 "package's DeepLab forward applies only GroupNorm after its "
                                 "convs (roi_heads.py:476-483) and drops unfolded BatchNorm "
                                 "statistics")
        if h.DECODER_ON and h.DECODER_NORM:
            raise NotImplementedError("DECODER_NORM: the JAX package declares the norm but its "
                                      "decoder never applies it (roi_heads.py:100-110, "
                                      "293-345); the port refuses it rather than copy that")


# ---------------------------------------------------------------------------
# specs (the JAX package's order, so random init draws the same stream)
# ---------------------------------------------------------------------------

def box_head_spec(cfg, prefix: str = "roi_heads") -> Spec:
    spec: Spec = {}
    res = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
    fc_dim = cfg.MODEL.ROI_BOX_HEAD.FC_DIM
    flat = backbone_out_channels(cfg) * res * res
    for k in range(cfg.MODEL.ROI_BOX_HEAD.NUM_FC):
        linear_spec(spec, f"{prefix}.box_head.fc{k + 1}", flat if k == 0 else fc_dim, fc_dim)
    num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    nreg = 1 if cfg.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG else num_classes
    linear_spec(spec, f"{prefix}.box_predictor.cls_score", fc_dim, num_classes + 1)
    linear_spec(spec, f"{prefix}.box_predictor.bbox_pred", fc_dim, nreg * 4)
    return spec


def _decoder_chains(cfg):
    """(feature, conv indices, upsamples) per decoder chain (roi_head.py:22-79):
    module indices 0, 2, 4 ... when the chain upsamples, 0 otherwise."""
    common = cfg.MODEL.ROI_DENSEPOSE_HEAD.DECODER_COMMON_STRIDE
    strides = feature_strides(cfg)
    chains = []
    for f in cfg.MODEL.ROI_HEADS.IN_FEATURES:
        length = max(1, int(math.log2(strides[f]) - math.log2(common)))
        has_up = strides[f] != common
        chains.append((f, [k * 2 if has_up else k for k in range(length)], has_up))
    return chains


def decoder_spec(cfg, prefix: str = "roi_heads.decoder") -> Spec:
    spec: Spec = {}
    dims = cfg.MODEL.ROI_DENSEPOSE_HEAD.DECODER_CONV_DIMS
    in_ch = backbone_out_channels(cfg)
    for f, idxs, _ in _decoder_chains(cfg):
        for k, idx in enumerate(idxs):
            conv_spec(spec, f"{prefix}.{f}.{idx}", in_ch if k == 0 else dims, dims, 3)
    conv_spec(spec, f"{prefix}.predictor", dims,
              cfg.MODEL.ROI_DENSEPOSE_HEAD.DECODER_NUM_CLASSES, 1)
    return spec


def _head_in_channels(cfg) -> int:
    """The DensePose head's input width: the decoder's classes, or the FPN
    levels' width for the legacy multi-level pooler (JAX roi_heads.py:120-122)."""
    h = cfg.MODEL.ROI_DENSEPOSE_HEAD
    return h.DECODER_NUM_CLASSES if h.DECODER_ON else backbone_out_channels(cfg)


def densepose_head_spec(cfg, prefix: str = "roi_heads.densepose_head") -> Spec:
    h = cfg.MODEL.ROI_DENSEPOSE_HEAD
    spec: Spec = {}
    d = _head_in_channels(cfg)
    norm = ""
    if h.NAME == "DensePoseDeepLabHead":
        # ASPP (deeplab.py:33): out width = in width; branches 0-3 conv + GN,
        # branch 4 pool (index 0) + conv + GN, then the 1x1 projection; the
        # body convs' norm is DEEPLAB.NORM, the ASPP's GroupNorm in every mode
        norm = h.DEEPLAB.NORM
        a = f"{prefix}.ASPP"
        conv_spec(spec, f"{a}.convs.0.0", d, d, 1, bias=False)
        gn_spec(spec, f"{a}.convs.0.1", d)
        for i in range(1, 4):
            conv_spec(spec, f"{a}.convs.{i}.0", d, d, 3, bias=False)
            gn_spec(spec, f"{a}.convs.{i}.1", d)
        conv_spec(spec, f"{a}.convs.4.1", d, d, 1, bias=False)
        gn_spec(spec, f"{a}.convs.4.2", d)
        conv_spec(spec, f"{a}.project.0", 5 * d, d, 1, bias=False)
    for i in range(h.NUM_STACKED_CONVS):
        conv_spec(spec, f"{prefix}.body_conv_fcn{i + 1}", d, h.CONV_HEAD_DIM,
                  h.CONV_HEAD_KERNEL, bias=not norm, norm=norm)
        d = h.CONV_HEAD_DIM
    return spec


def _predictor_heads(cfg) -> List[Tuple[str, int]]:
    """(name, out channels) of every chart-predictor deconv, in spec order.
    The WC confidence deconvs are declared so WC checkpoints load; like the
    reference, the forward computes only the four SIUV heads unless
    ``TPU.EMIT_CONFIDENCES`` asks for them."""
    h = cfg.MODEL.ROI_DENSEPOSE_HEAD
    patches = h.NUM_PATCHES + 1
    heads = [("ann_index_lowres", h.NUM_COARSE_SEGM_CHANNELS),
             ("index_uv_lowres", patches), ("u_lowres", patches), ("v_lowres", patches)]
    if h.PREDICTOR_NAME == "DensePoseChartWithConfidencePredictor":
        if h.UV_CONFIDENCE.ENABLED:
            heads.append(("sigma_2_lowres", patches))
            if h.UV_CONFIDENCE.TYPE == "indep_aniso":
                heads += [("kappa_u_lowres", patches), ("kappa_v_lowres", patches)]
        if h.SEGM_CONFIDENCE.ENABLED:
            heads += [("fine_segm_confidence_lowres", 1),
                      ("coarse_segm_confidence_lowres", 1)]
    return heads


def _is_cse(cfg) -> bool:
    return cfg.MODEL.ROI_DENSEPOSE_HEAD.PREDICTOR_NAME == "DensePoseEmbeddingPredictor"


def densepose_predictor_spec(cfg, prefix: str = "roi_heads.densepose_predictor") -> Spec:
    if _is_cse(cfg):
        return embedding_predictor_spec(cfg, prefix)
    h = cfg.MODEL.ROI_DENSEPOSE_HEAD
    spec: Spec = {}
    for name, cout in _predictor_heads(cfg):
        conv_transpose_spec(spec, f"{prefix}.{name}", h.CONV_HEAD_DIM, cout,
                            h.DECONV_KERNEL)
    return spec


def roi_heads_spec(cfg, prefix: str = "roi_heads") -> Spec:
    _check_supported(cfg)
    spec = box_head_spec(cfg, prefix)
    if cfg.MODEL.DENSEPOSE_ON:
        if cfg.MODEL.ROI_DENSEPOSE_HEAD.DECODER_ON:
            spec.update(decoder_spec(cfg, f"{prefix}.decoder"))
        spec.update(densepose_head_spec(cfg, f"{prefix}.densepose_head"))
        spec.update(densepose_predictor_spec(cfg, f"{prefix}.densepose_predictor"))
        if cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.EMBEDDERS:
            spec.update(embedder_spec(cfg, f"{prefix}.embedder"))
    return spec


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class FastRCNNConvFCHead(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        res = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
        d = backbone_out_channels(cfg) * res * res
        fc_dim = cfg.MODEL.ROI_BOX_HEAD.FC_DIM
        self.num_fc = cfg.MODEL.ROI_BOX_HEAD.NUM_FC
        for k in range(self.num_fc):
            self.add_module(f"fc{k + 1}", nn.Linear(d if k == 0 else fc_dim, fc_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{k + 1}")(x))
        return x


class FastRCNNOutputLayers(nn.Module):
    """Class logits and box deltas of ``width``-wide region features (the
    box head's FC_DIM, or the C4 detector's res5 width)."""

    def __init__(self, cfg, width: int):
        super().__init__()
        n = cfg.MODEL.ROI_HEADS.NUM_CLASSES
        nreg = 1 if cfg.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG else n
        self.cls_score = nn.Linear(width, n + 1)
        self.bbox_pred = nn.Linear(width, nreg * 4)


class Decoder(nn.Module):
    """Sum of per-level conv (+2x bilinear upsample) chains at the common
    stride, then a 1x1 predictor (densepose roi_head.py:71-79)."""

    def __init__(self, cfg):
        super().__init__()
        dims = cfg.MODEL.ROI_DENSEPOSE_HEAD.DECODER_CONV_DIMS
        in_ch = backbone_out_channels(cfg)
        self.chains = _decoder_chains(cfg)
        for f, idxs, _ in self.chains:
            self.add_module(f, nn.ModuleDict({
                str(idx): nn.Conv2d(in_ch if k == 0 else dims, dims, 3, padding=1)
                for k, idx in enumerate(idxs)}))
        self.predictor = nn.Conv2d(dims, cfg.MODEL.ROI_DENSEPOSE_HEAD.DECODER_NUM_CLASSES, 1)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        acc = None
        for f, idxs, has_up in self.chains:
            x = features[f]
            for idx in idxs:
                x = F.relu(getattr(self, f)[str(idx)](x))
                if has_up:
                    x = resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2),
                                        scale=(2.0, 2.0))
            if acc is not None and acc.shape[-2:] != x.shape[-2:]:
                # a level whose size is not the first's halved exactly (the
                # RetinaNet FPN's p6 / p7 round odd sizes up): the JAX
                # package fails here on the add's shapes too
                raise ValueError(f"decoder: level {f} upsamples to {tuple(x.shape[-2:])}, not "
                                 f"the first level's {tuple(acc.shape[-2:])}; its stride does "
                                 "not divide the padded input exactly")
            acc = x if acc is None else acc + x
        return self.predictor(acc)


def stacked_int8_chain(convs: List[nn.Module], x: torch.Tensor, norm: bool) -> torch.Tensor:
    """The stacked convs as a calibrated s8 chain (JAX
    ``_stacked_int8_chain``): x (B, C, H, W) float -> the head's output in
    x's dtype. Without a norm, activations stay s8 between links (s32 bias
    and ReLU, one requantize each); with GN (DeepLab) each link dequantizes
    to x's dtype, takes one-pass GroupNorm statistics and a ReLU, and
    requantizes at the next link's scale."""
    dtype = x.dtype
    q = to_s8_nhwc(x, convs[0].in_scale)
    for i, conv in enumerate(convs):
        last = i == len(convs) - 1
        if norm:
            y = link(conv, q, conv.in_scale, out_dtype=dtype)
            y = F.relu(group_norm_onepass(y, conv.norm.weight, conv.norm.bias, 32))
            if last:
                return to_nchw(y, dtype)
            q = quant_act_s8(y, convs[i + 1].in_scale)
        else:
            out = link(conv, q, conv.in_scale, None if last else convs[i + 1].in_scale, relu=True)
            if last:
                return to_nchw(out, dtype)
            q = out
    raise AssertionError("unreachable")


class StackedHead(nn.Module):
    """The stacked ``body_conv_fcn{i}`` convs of both heads, and their int8
    routing (``TPU.INT8_HEAD``): the calibrated chain once ``body_conv_fcn1``
    holds a quantized weight, dynamic quantization before."""

    def __init__(self, cfg):
        super().__init__()
        self.n = cfg.MODEL.ROI_DENSEPOSE_HEAD.NUM_STACKED_CONVS
        self.int8 = bool(cfg.TPU.INT8_HEAD)

    def convs(self) -> List[nn.Module]:
        return [getattr(self, f"body_conv_fcn{i + 1}") for i in range(self.n)]

    def stack(self, x: torch.Tensor, norm: bool = False) -> torch.Tensor:
        convs = self.convs()
        if self.int8 and quantized(convs[0]):
            return stacked_int8_chain(convs, x, norm)
        for conv in convs:
            if self.int8:
                x = conv2d_int8(x, conv.weight, conv.bias, padding=conv.padding)
                x = conv.norm(x) if norm else x
            else:
                x = conv(x)
            x = F.relu(x)
        return x


class DensePoseV1ConvXHead(StackedHead):
    def __init__(self, cfg):
        super().__init__(cfg)
        h = cfg.MODEL.ROI_DENSEPOSE_HEAD
        d = _head_in_channels(cfg)
        for i in range(self.n):
            self.add_module(f"body_conv_fcn{i + 1}",
                            nn.Conv2d(d, h.CONV_HEAD_DIM, h.CONV_HEAD_KERNEL,
                                      padding=h.CONV_HEAD_KERNEL // 2))
            d = h.CONV_HEAD_DIM

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.stack(x)


def _gn_branch(*convs: nn.Module) -> nn.Sequential:
    c = convs[-1].out_channels
    return nn.Sequential(*convs, GroupNorm32(c), nn.ReLU())


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling with GroupNorm (deeplab.py:33-60; JAX
    roi_heads.py:421-458): a 1x1 branch, 3x3 branches at rates 6, 12 and 56,
    a global-pool branch, and a 1x1 projection of the five."""

    RATES = (6, 12, 56)

    def __init__(self, c: int):
        super().__init__()
        self.convs = nn.ModuleList(
            [_gn_branch(nn.Conv2d(c, c, 1, bias=False))]
            + [_gn_branch(nn.Conv2d(c, c, 3, padding=r, dilation=r, bias=False))
               for r in self.RATES]
            + [_gn_branch(nn.AdaptiveAvgPool2d(1), nn.Conv2d(c, c, 1, bias=False))])
        self.project = nn.Sequential(nn.Conv2d(5 * c, c, 1, bias=False), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        branches = []
        for conv, gn, relu in self.convs[:4]:
            d = conv.dilation[0]
            if d > 1 and d >= h and d >= w:
                # the JAX package's static rule (roi_heads.py:424-434): a 3x3
                # conv whose dilation is at least both ROI dims samples only
                # its center tap in bounds, so it is that tap's 1x1 conv
                y = F.conv2d(x, conv.weight[:, :, 1:2, 1:2])
            else:
                y = conv(x)
            branches.append(relu(gn(y)))
        _, conv, gn, relu = self.convs[4]
        g = relu(gn(conv(x.mean(dim=(-2, -1), keepdim=True))))
        branches.append(g.expand_as(branches[0]))  # bilinear resize of 1x1 == broadcast
        return self.project(torch.cat(branches, dim=1))


class DensePoseDeepLabHead(StackedHead):
    """ASPP, then the stacked convs (deeplab.py:16-86; JAX roi_heads.py:461-481)
    with ``DEEPLAB.NORM``: GroupNorm after each conv ("GN", every shipped
    config), or convs with a bias and no norm ("", and "FrozenBN", whose
    statistics ``fold_state`` folds into that bias and weight). In int8 mode
    the ASPP, which keeps its GroupNorm in every mode, stays fp, and the
    stacked convs run as ``stacked_int8_chain`` (with GroupNorm links, or as
    the bias chain of V1ConvX)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        h = cfg.MODEL.ROI_DENSEPOSE_HEAD
        k = h.CONV_HEAD_KERNEL
        d = _head_in_channels(cfg)
        self.gn = h.DEEPLAB.NORM == "GN"
        self.ASPP = ASPP(d)
        for i in range(self.n):
            conv = (Conv2dNorm(d, h.CONV_HEAD_DIM, k, padding=k // 2, bias=False,
                               norm=GroupNorm32(h.CONV_HEAD_DIM)) if self.gn else
                    nn.Conv2d(d, h.CONV_HEAD_DIM, k, padding=k // 2))
            self.add_module(f"body_conv_fcn{i + 1}", conv)
            d = h.CONV_HEAD_DIM

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.stack(self.ASPP(x), norm=self.gn)


_HEADS = {"DensePoseV1ConvXHead": DensePoseV1ConvXHead,
          "DensePoseDeepLabHead": DensePoseDeepLabHead}


class DensePoseChartPredictor(nn.Module):
    """Four ConvTranspose2d heads + a bilinear upsample (chart.py:45-90). With
    ``TPU.EMIT_CONFIDENCES`` a WC predictor also runs its confidence heads
    and emits their upsampled maps under the JAX package's names
    (roi_heads.py:604-614)."""

    def __init__(self, cfg):
        super().__init__()
        h = cfg.MODEL.ROI_DENSEPOSE_HEAD
        k = h.DECONV_KERNEL
        self.up = float(h.UP_SCALE)
        heads = _predictor_heads(cfg)
        for name, cout in heads:
            self.add_module(name, nn.ConvTranspose2d(h.CONV_HEAD_DIM, cout, k, stride=2,
                                                     padding=int(k / 2 - 1)))
        self.outputs = list(zip(("coarse_segm", "fine_segm", "u", "v"), _CHART_HEADS))
        if cfg.TPU.EMIT_CONFIDENCES:
            self.outputs += [(name[:-len("_lowres")], name) for name, _ in heads[4:]]
        self.int8 = bool(cfg.TPU.INT8_PREDICTOR)

    def upsample(self, y: torch.Tensor) -> torch.Tensor:
        out_hw = (int(y.shape[-2] * self.up), int(y.shape[-1] * self.up))
        return resize_bilinear(y, out_hw, scale=(self.up, self.up))

    def head(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.upsample(getattr(self, name)(x))

    def int8_ready(self) -> bool:
        return (self.int8 and getattr(self, "in_scale", None) is not None
                and all(quantized(getattr(self, n)) for n in _CHART_HEADS))

    def merged_int8(self):
        """The four chart deconvs' quantized weights, biases and epilogue
        concatenated along the output channels (2 + 25 + 25 + 25), made once
        per installed state (while ``torch.export`` traces, in the program)."""
        heads = [getattr(self, n) for n in _CHART_HEADS]
        refs = [self.in_scale] + [t for h in heads for t in (h.qweight, h.wscale)]
        exporting = torch.compiler.is_exporting()
        hit = None if exporting else self.__dict__.get("_int8_merged")
        if hit is None or any(a is not b for a, b in zip(hit[0], refs)):
            qw = torch.cat([h.qweight for h in heads]).contiguous()
            ep = make_epilogue(self.in_scale, torch.cat([h.wscale for h in heads]),
                               torch.cat([h.bias for h in heads]))
            hit = (refs, qw, ep)
            if not exporting:
                self.__dict__["_int8_merged"] = hit
        return hit[1], hit[2]

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if not self.int8_ready():
            return {key: self.head(name, x) for key, name in self.outputs}
        # TPU.INT8_PREDICTOR: the chart deconvs as one calibrated s8 launch
        qw, ep = self.merged_int8()
        first = getattr(self, _CHART_HEADS[0])
        y = conv_s8(to_s8_nhwc(x, self.in_scale), qw, ep.qb, ep.vec, stride=first.stride,
                    padding=first.padding, transposed=True, out_kind=torch.float32)
        y = to_nchw(y, x.dtype)
        out, c = {}, 0
        for key, name in self.outputs:
            if name in _CHART_HEADS:
                n = getattr(self, name).out_channels
                out[key] = self.upsample(y[:, c:c + n])
                c += n
            else:  # the WC confidence heads stay fp on the same input
                out[key] = self.head(name, x)
        return out


class ROIHeads(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        _check_supported(cfg)
        self.box_head = FastRCNNConvFCHead(cfg)
        self.box_predictor = FastRCNNOutputLayers(cfg, cfg.MODEL.ROI_BOX_HEAD.FC_DIM)
        if cfg.MODEL.DENSEPOSE_ON:
            if cfg.MODEL.ROI_DENSEPOSE_HEAD.DECODER_ON:
                self.decoder = Decoder(cfg)
            self.densepose_head = _HEADS[cfg.MODEL.ROI_DENSEPOSE_HEAD.NAME](cfg)
            if _is_cse(cfg):
                self.densepose_predictor = DensePoseEmbeddingPredictor(cfg)
            else:
                self.densepose_predictor = DensePoseChartPredictor(cfg)
            if cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.EMBEDDERS:
                self.embedder = Embedder(cfg)


# ---------------------------------------------------------------------------
# forward functions
# ---------------------------------------------------------------------------

def box_stage_forward(
    heads: ROIHeads,
    features: Dict[str, torch.Tensor],
    proposals: torch.Tensor,
    proposal_valid: torch.Tensor,
    cfg,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Box head + fast_rcnn inference of one frame (batch-1 features).
    Returns (boxes (D, 4) f32, scores (D,), classes (D,) int32, valid (D,)),
    D = TEST.DETECTIONS_PER_IMAGE, score-descending."""
    out = box_stage_forward_batch(heads, features, proposals[None], proposal_valid[None], cfg)
    return tuple(t[0] for t in out)


def frame_index(b: int, rows: int, device) -> Optional[torch.Tensor]:
    """Each of b frames' ``rows`` boxes, frame-major: the (b * rows,) int32
    frame index of the poolers, or None for one frame."""
    if b == 1:
        return None
    return torch.arange(b, dtype=torch.int32, device=device).repeat_interleave(rows)


def box_stage_forward_batch(
    heads: ROIHeads,
    features: Dict[str, torch.Tensor],
    proposals: torch.Tensor,
    proposal_valid: torch.Tensor,
    cfg,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``box_stage_forward`` of B frames: features (B, C, H, W) per level,
    proposals (B, R, 4), proposal_valid (B, R). Returns (boxes (B, D, 4),
    scores (B, D), classes (B, D), valid (B, D)), frame i's rows those of
    frame i alone. One pooler launch for the B * R proposals (each with its
    frame), the FCs over B * R rows, one class-aware NMS launch over B *
    classes problems of R boxes, a top-D per frame."""
    scores_logits, deltas = box_head_forward(heads, features, proposals, cfg)
    return box_stage_decisions(scores_logits, deltas, proposals, proposal_valid, cfg)


def box_head_forward(heads: ROIHeads, features: Dict[str, torch.Tensor],
                     proposals: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """The box head on B frames' proposals (B, R, 4): one pooler launch for
    the B * R proposals, each with its frame, and the FCs over B * R rows.
    Returns (class logits (B * R, classes + 1), box deltas (B * R, 4 * regs))
    in the compute dtype."""
    in_features: List[str] = list(cfg.MODEL.ROI_HEADS.IN_FEATURES)
    res = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
    aligned = cfg.MODEL.ROI_BOX_HEAD.POOLER_TYPE == "ROIAlignV2"
    nb, r = proposals.shape[:2]
    flat_props = proposals.reshape(-1, 4)
    scales, min_lvl, max_lvl = _fpn_pooling(cfg, in_features)
    levels = assign_boxes_to_levels(flat_props, min_lvl, max_lvl)
    frames = frame_index(nb, r, proposals.device)
    # K2 reads each (N, C, H, W) level in place
    pooled = roi_align_multilevel([features[f] for f in in_features],
                                  flat_props, levels, scales, (res, res),
                                  cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO, aligned, frames)
    # (B * R, C, res, res) is torch's Flatten order into fc1
    x = heads.box_head(pooled.reshape(nb * r, -1))
    return heads.box_predictor.cls_score(x), heads.box_predictor.bbox_pred(x)


def box_stage_decisions(
    scores_logits: torch.Tensor,
    deltas: torch.Tensor,
    proposals: torch.Tensor,
    proposal_valid: torch.Tensor,
    cfg,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """fast_rcnn_inference of B frames from the box head's outputs
    (``box_head_forward``): the fp32 softmax and decode, one class-aware NMS
    launch over B * classes problems of R boxes (one problem a frame with a
    single class), a top-D per frame. Returns
    ``box_stage_forward_batch``'s (boxes, scores, classes, valid)."""
    num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    topk = cfg.TEST.DETECTIONS_PER_IMAGE
    nb, r = proposals.shape[:2]
    flat_props = proposals.reshape(-1, 4)

    probs = torch.softmax(scores_logits.float(), dim=-1)
    boxes = apply_deltas(deltas, flat_props, tuple(cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS))
    # fast_rcnn.py:86-141: the reference's clip_boxes result is discarded
    # there, so detection boxes are NOT clipped at this stage.
    fg_scores = probs[:, :-1]
    nreg = 1 if cfg.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG else num_classes
    boxes = boxes.reshape(nb * r, nreg, 4).expand(nb * r, num_classes, 4)

    finite = torch.isfinite(boxes).all(dim=2).all(dim=1) & torch.isfinite(probs).all(dim=1)
    valid = proposal_valid.reshape(-1) & finite

    # each frame's (proposal, class) pairs, proposal-major
    flat_scores = fg_scores.reshape(nb, r * num_classes)
    flat_boxes = boxes.reshape(nb, r * num_classes, 4)
    flat_cls = torch.arange(num_classes, dtype=torch.int32,
                            device=probs.device).repeat(r).expand(nb, r * num_classes)
    flat_valid = (valid.reshape(nb, r).repeat_interleave(num_classes, dim=1)
                  & (flat_scores > cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST))

    nms_thresh = cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST
    if num_classes == 1:
        keep = nms_mask(flat_boxes, flat_scores, flat_valid, nms_thresh)
    else:  # one K1 problem a frame and class (ops/nms.py::per_class_nms_mask)
        keep = per_class_nms_mask(flat_boxes.reshape(nb, r, num_classes, 4),
                                  flat_scores.reshape(nb, r, num_classes),
                                  flat_valid.reshape(nb, r, num_classes),
                                  nms_thresh).reshape(nb, r * num_classes)

    sel_scores = torch.where(keep & flat_valid, flat_scores, torch.full_like(flat_scores, _NEG))
    k_out = min(topk, sel_scores.shape[1])
    out_scores, out_idx = top_k(sel_scores, k_out)
    out_boxes = torch.take_along_dim(flat_boxes, out_idx[..., None], dim=1)
    out_cls = torch.take_along_dim(flat_cls, out_idx, dim=1)
    out_valid = out_scores > _NEG / 2
    if k_out < topk:
        padn = topk - k_out
        out_boxes = torch.cat([out_boxes, out_boxes.new_zeros((nb, padn, 4))], dim=1)
        out_scores = torch.cat([out_scores, out_scores.new_full((nb, padn), _NEG)], dim=1)
        out_cls = torch.cat([out_cls, out_cls.new_zeros((nb, padn))], dim=1)
        out_valid = torch.cat([out_valid, out_valid.new_zeros((nb, padn))], dim=1)
    out_scores = torch.where(out_valid, out_scores, torch.zeros_like(out_scores))
    return out_boxes, out_scores, out_cls, out_valid


def _fpn_pooling(cfg, in_features: List[str]):
    """Per-level scales and the min / max FPN level of ``in_features``."""
    strides = feature_strides(cfg)
    scales = [1.0 / strides[f] for f in in_features]
    return scales, int(-math.log2(scales[0])), int(-math.log2(scales[-1]))


def _densepose_pooled(heads: ROIHeads, features: Dict[str, torch.Tensor],
                      boxes: torch.Tensor, cfg,
                      frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The DensePose head's input, (M, C, res, res): single-level ROIAlign
    (K2) of the decoder map, or for the legacy configs multi-level ROIAlign
    over the FPN levels (JAX roi_heads.py:633-643). ``frames``: each box's
    frame in features of N frames (the batched forward), None for one."""
    h = cfg.MODEL.ROI_DENSEPOSE_HEAD
    res = h.POOLER_RESOLUTION
    aligned = h.POOLER_TYPE == "ROIAlignV2"
    in_features: List[str] = list(cfg.MODEL.ROI_HEADS.IN_FEATURES)
    scales, min_lvl, max_lvl = _fpn_pooling(cfg, in_features)
    if h.DECODER_ON:
        with span("decoder"):
            sem = heads.decoder(features)
        with span("densepose_pooler"):
            return roi_align_single(sem, boxes, scales[0], (res, res),
                                    h.POOLER_SAMPLING_RATIO, aligned, frames)
    with span("densepose_pooler"):
        levels = assign_boxes_to_levels(boxes, min_lvl, max_lvl)
        return roi_align_multilevel([features[f] for f in in_features],
                                    boxes, levels, scales, (res, res), h.POOLER_SAMPLING_RATIO,
                                    aligned, frames)


def densepose_stage_forward(heads: ROIHeads, features: Dict[str, torch.Tensor],
                            boxes: torch.Tensor, cfg,
                            frames: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """(Decoder ->) ROIAlign -> head -> predictor on the given boxes
    (densepose roi_head.py:126-158). Maps NCHW, (M, C, HEATMAP, HEATMAP)
    each: SIUV, or a CSE model's embedding and coarse segmentation. Each step
    is a span. ``frames``: boxes (M, 4) of N frames' features,
    each with its frame (the batched forward's B * D rows), or None for one
    frame."""
    pooled = _densepose_pooled(heads, features, boxes, cfg, frames)
    with span("densepose_head"):
        x = heads.densepose_head(pooled)
    with span("densepose_predictor"):
        return heads.densepose_predictor(x)


def densepose_stacked_calibration(heads: ROIHeads, features: Dict[str, torch.Tensor],
                                  boxes: torch.Tensor, cfg, stat: str = "max") -> torch.Tensor:
    """The fp walk of decoder -> pooler -> stacked head convs (JAX
    ``densepose_stacked_calibration``): each stacked conv's input statistic
    (``ops/conv_int8.py::act_stat``, "max" or "sat"), and with
    ``TPU.INT8_PREDICTOR`` the head output's (the chart deconvs' input) last.
    DeepLab's walk starts at the ASPP's output, and its GN convs take two-pass
    GroupNorm, as the fp head does (JAX roi_heads.py:680-692)."""
    x = _densepose_pooled(heads, features, boxes, cfg)
    head = heads.densepose_head
    if isinstance(head, DensePoseDeepLabHead):
        x = head.ASPP(x)  # ASPP stays fp in int8 mode; the chain starts at its projection
    stats = []
    for conv in head.convs():
        stats.append(act_stat(x, stat, getattr(conv, "in_scale", None)))
        x = F.relu(conv(x))
    if cfg.TPU.INT8_PREDICTOR:
        stats.append(act_stat(x, stat, getattr(heads.densepose_predictor, "in_scale", None)))
    return torch.stack(stats)
