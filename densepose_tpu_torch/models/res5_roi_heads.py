"""Res5ROIHeads, the C4 detector's box stage (port of
densepose_tpu/models/res5_roi_heads.py), NCHW.

Single-level ROIAlign (kernel K2) of ``ROI_HEADS.IN_FEATURES[0]`` at 1/16,
``ROI_BOX_HEAD.POOLER_RESOLUTION`` with its sampling ratio, aligned iff
ROIAlignV2; the res5 bottleneck stage (three blocks, the first at stride 2
with a shortcut) on every region; a global average pool; then
FastRCNNOutputLayers and the class-aware NMS (kernel K1, one problem a
class). The C4 backbone is ``build_resnet_backbone`` (models/backbones.py).

Where this differs from the FPN box stage (``roi_heads.py::
box_stage_decisions``), it copies the JAX package:

* no finiteness filter: a (proposal, class) pair is valid when its proposal
  is and its score passes SCORE_THRESH_TEST;
* ``min(D, R * C)`` rows out, with no padding to D;
* scores zeroed where invalid.

Every function also runs B frames at once (features (B, C, H, W), proposals
(B, R, 4)): one K2 launch with a frame index per box, one K1 launch over the
B * C problems.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from ..checkpoint.spec import Spec, conv_spec, linear_spec
from ..ops.boxes import apply_deltas
from ..ops.nms import nms_mask, per_class_nms_mask
from ..ops.roi_align import roi_align_single
from .resnet import BottleneckBlock
from .roi_heads import FastRCNNOutputLayers, frame_index
from .rpn import top_k

_NEG = -1e30


def _widths(cfg) -> Tuple[int, int, int]:
    """(in, bottleneck, out) of the res5 head: a bottleneck stage at any
    depth (JAX ``res5_spec``)."""
    r = cfg.MODEL.RESNETS
    out_channels = r.RES2_OUT_CHANNELS * 8
    return out_channels // 2, r.NUM_GROUPS * r.WIDTH_PER_GROUP * 8, out_channels


def res5_spec(cfg, prefix: str = "roi_heads") -> Spec:
    """The res5 stage and box predictor, in the JAX package's order."""
    norm = cfg.MODEL.RESNETS.NORM
    cin, cb, cout = _widths(cfg)
    spec: Spec = {}
    for i in range(3):
        b_in = cin if i == 0 else cout
        name = f"{prefix}.res5.{i}"
        conv_spec(spec, f"{name}.conv1", b_in, cb, 1, bias=False, norm=norm)
        conv_spec(spec, f"{name}.conv2", cb, cb, 3, bias=False, norm=norm)
        conv_spec(spec, f"{name}.conv3", cb, cout, 1, bias=False, norm=norm)
        if b_in != cout:
            conv_spec(spec, f"{name}.shortcut", b_in, cout, 1, bias=False, norm=norm)
    num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    nreg = 1 if cfg.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG else num_classes
    linear_spec(spec, f"{prefix}.box_predictor.cls_score", cout, num_classes + 1)
    linear_spec(spec, f"{prefix}.box_predictor.bbox_pred", cout, nreg * 4)
    return spec


class Res5ROIHeads(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        cin, cb, cout = _widths(cfg)
        stride_in_1x1 = cfg.MODEL.RESNETS.STRIDE_IN_1X1
        self.res5 = nn.Sequential(*[
            BottleneckBlock(cin if i == 0 else cout, cb, cout, 2 if i == 0 else 1,
                            stride_in_1x1, 1) for i in range(3)])
        self.box_predictor = FastRCNNOutputLayers(cfg, cout)


def res5_head_forward(heads: Res5ROIHeads, features: Dict[str, torch.Tensor],
                      proposals: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pool -> res5 -> average pool -> predictor on B frames' proposals
    (B, R, 4): (class logits (B * R, classes + 1), box deltas (B * R, 4 *
    regs)) in the compute dtype."""
    b = cfg.MODEL.ROI_BOX_HEAD
    nb, r = proposals.shape[:2]
    res = b.POOLER_RESOLUTION
    x = roi_align_single(features[cfg.MODEL.ROI_HEADS.IN_FEATURES[0]], proposals.reshape(-1, 4),
                         1.0 / 16, (res, res), b.POOLER_SAMPLING_RATIO,
                         b.POOLER_TYPE == "ROIAlignV2", frame_index(nb, r, proposals.device))
    x = heads.res5(x).mean(dim=(-2, -1))
    return heads.box_predictor.cls_score(x), heads.box_predictor.bbox_pred(x)


def res5_decisions(scores_logits: torch.Tensor, deltas: torch.Tensor, proposals: torch.Tensor,
                   proposal_valid: torch.Tensor, cfg):
    """The fp32 softmax and decode, the class-aware NMS (one K1 problem a
    frame and class) and the top ``min(D, R * C)`` of B frames (JAX
    ``res5_forward`` after its predictor). Returns (boxes (B, k, 4), scores
    (B, k), classes (B, k) int32, valid (B, k))."""
    num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    nb, r = proposals.shape[:2]
    probs = torch.softmax(scores_logits.float(), dim=-1)
    boxes = apply_deltas(deltas, proposals.reshape(-1, 4),
                         tuple(cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS))
    nreg = boxes.shape[-1] // 4
    boxes = boxes.reshape(nb, r, nreg, 4).expand(nb, r, num_classes, 4)
    scores = probs[:, :-1].reshape(nb, r, num_classes)
    valid = proposal_valid[..., None] & (scores > cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST)
    thr = cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST
    if num_classes == 1:
        keep = nms_mask(boxes[:, :, 0], scores[..., 0], valid[..., 0], thr)[..., None]
    else:
        keep = per_class_nms_mask(boxes, scores, valid, thr)
    flat_scores = scores.reshape(nb, -1)
    flat_valid = valid.reshape(nb, -1)
    flat_boxes = boxes.reshape(nb, -1, 4)
    flat_cls = torch.arange(num_classes, dtype=torch.int32,
                            device=probs.device).repeat(r).expand(nb, r * num_classes)
    sel = torch.where(keep.reshape(nb, -1) & flat_valid, flat_scores,
                      torch.full_like(flat_scores, _NEG))
    out_scores, out_idx = top_k(sel, min(cfg.TEST.DETECTIONS_PER_IMAGE, sel.shape[1]))
    out_valid = out_scores > _NEG / 2
    return (torch.take_along_dim(flat_boxes, out_idx[..., None], dim=1),
            torch.where(out_valid, out_scores, torch.zeros_like(out_scores)),
            torch.take_along_dim(flat_cls, out_idx, dim=1), out_valid)


def res5_forward_batch(heads: Res5ROIHeads, features: Dict[str, torch.Tensor],
                       proposals: torch.Tensor, proposal_valid: torch.Tensor, cfg):
    """``res5_forward`` of B frames: features (B, C, H, W), proposals (B, R,
    4), proposal_valid (B, R); frame i's rows are those of frame i alone."""
    scores_logits, deltas = res5_head_forward(heads, features, proposals, cfg)
    return res5_decisions(scores_logits, deltas, proposals, proposal_valid, cfg)


def res5_forward(heads: Res5ROIHeads, features: Dict[str, torch.Tensor], proposals: torch.Tensor,
                 proposal_valid: torch.Tensor, cfg):
    """The C4 box stage of one frame (batch-1 features, proposals (R, 4)):
    (boxes (k, 4) f32, scores (k,), classes (k,) int32, valid (k,)), k =
    min(D, R * C), score-descending (JAX ``res5_forward``)."""
    out = res5_forward_batch(heads, features, proposals[None], proposal_valid[None], cfg)
    return tuple(t[0] for t in out)
