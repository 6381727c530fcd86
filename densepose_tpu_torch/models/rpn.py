"""RPN with static shapes (port of densepose_tpu/models/rpn.py).

Per level: top-k (k = min(H*W*A, PRE_NMS_TOPK_TEST)) on objectness, fp32
decode of those k boxes, the reference's swapped (W, H) clip (rpn.py:320),
then per-level NMS at RPN.NMS_THRESH as ONE launch of kernel K1 with the
levels as its problems (levels padded to a common K with invalid slots),
then the global top POST_NMS_TOPK_TEST -> (K, 4) proposals + valid mask,
exactly the slots of the JAX package. ``rpn_forward_batch`` runs B frames of
one size at once: one K1 launch over the B x L problems, (B, K, 4) out.

On a geometry-bucket canvas (``anchor_valid_hw``, rpn.py:60-72 of the JAX
package) anchors whose centre lies in the bucket's padding are masked out of
every level's top-k, so the proposal pool is the one the minimally padded
input would give.

int8 serving (``TPU.INT8_RPN``, JAX rpn.py:94-110): once calibrated, the
shared 3x3 conv runs through kernel Q1 with one input scale per level
(``conv.in_scale_<level>``), ReLU on int32, to f32 and then the features'
dtype; the 1x1 objectness and delta convs stay fp.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..checkpoint.spec import Spec, conv_spec
from ..ops.anchors import anchors_for_levels
from ..ops.boxes import apply_deltas, clip_boxes_wh_swapped, nonempty_boxes
from ..ops.conv_int8 import link, quantized, to_nchw, to_s8_nhwc
from ..ops.nms import nms_mask
from .backbones import backbone_out_channels, feature_strides

_NEG = -1e30


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last axis, ties to the lower index first (the
    order of ``jax.lax.top_k``, which ``torch.topk`` does not promise)."""
    s = torch.sort(x, dim=-1, descending=True, stable=True)
    return s.values[..., :k], s.indices[..., :k]


def num_cell_anchors(cfg) -> int:
    sizes = cfg.MODEL.ANCHOR_GENERATOR.SIZES
    ars = cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS
    s0 = sizes[0] if isinstance(sizes[0], (list, tuple)) else sizes
    a0 = ars[0] if isinstance(ars[0], (list, tuple)) else ars
    return len(s0) * len(a0)


def rpn_spec(cfg, prefix: str = "proposal_generator.rpn_head") -> Spec:
    c = backbone_out_channels(cfg)
    a = num_cell_anchors(cfg)
    spec: Spec = {}
    conv_spec(spec, f"{prefix}.conv", c, c, 3, bias=True)
    conv_spec(spec, f"{prefix}.objectness_logits", c, a, 1, bias=True)
    conv_spec(spec, f"{prefix}.anchor_deltas", c, a * 4, 1, bias=True)
    return spec


class RPNHead(nn.Module):
    """StandardRPNHead: shared 3x3 conv + ReLU, then 1x1 objectness and
    delta convs. Keeps the anchors of the last ``ANCHOR_CACHE`` input
    geometries on their device (a TTA request alternates nine)."""

    ANCHOR_CACHE = 32

    def __init__(self, cfg):
        super().__init__()
        c = backbone_out_channels(cfg)
        a = num_cell_anchors(cfg)
        self.conv = nn.Conv2d(c, c, 3, padding=1)
        self.objectness_logits = nn.Conv2d(c, a, 1)
        self.anchor_deltas = nn.Conv2d(c, a * 4, 1)
        self.int8 = bool(cfg.TPU.INT8_RPN)
        self._anchors: Dict[tuple, List[torch.Tensor]] = {}

    def anchors(self, grid_sizes, strides, cfg, device) -> List[torch.Tensor]:
        key = (tuple(map(tuple, grid_sizes)), tuple(strides), device)
        cached = self._anchors.get(key)
        if cached is None:
            g = cfg.MODEL.ANCHOR_GENERATOR
            anchors = anchors_for_levels(grid_sizes, strides, g.SIZES, g.ASPECT_RATIOS,
                                         g.OFFSET)
            cached = [torch.from_numpy(a).to(device) for a in anchors]
            if len(self._anchors) >= self.ANCHOR_CACHE:  # drop the oldest geometry
                del self._anchors[next(iter(self._anchors))]
            self._anchors[key] = cached
        return cached


def rpn_forward(
    head: RPNHead,
    features: Dict[str, torch.Tensor],
    image_size_hw: Tuple[int, int],
    cfg,
    anchor_valid_hw: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """features: NCHW maps (batch 1) for cfg.MODEL.RPN.IN_FEATURES;
    image_size_hw: (H_pad, W_pad) of the network input. Returns (proposals
    (K, 4) f32, objectness (K,), valid (K,) bool), K = POST_NMS_TOPK_TEST,
    sorted by objectness descending: ``rpn_forward_batch``'s one frame.

    ``anchor_valid_hw``: (H, W) bound of a geometry-bucket canvas's minimal-pad
    extent. Anchors whose centre is not below it get the objectness ``_NEG``
    (after the fp32 cast: -1e30 overflows float16) before the top-k, and those
    that still enter a level's top-k (a level with fewer unmasked anchors than
    PRE_NMS_TOPK_TEST) are dropped from ``valid``."""
    boxes, scores, valid = rpn_forward_batch(head, features, image_size_hw, cfg,
                                             anchor_valid_hw)
    return boxes[0], scores[0], valid[0]


def rpn_forward_batch(
    head: RPNHead,
    features: Dict[str, torch.Tensor],
    image_size_hw: Tuple[int, int],
    cfg,
    anchor_valid_hw: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``rpn_forward`` of B frames at once: features (B, C, H, W) per level,
    one input size for all. Returns (proposals (B, K, 4), objectness (B, K),
    valid (B, K)); frame i's rows are what ``rpn_forward`` gives frame i
    alone. The per-level NMS of every frame is one K1 launch over B x L
    problems; the top-k run along each frame's own axis."""
    in_features: List[str] = list(cfg.MODEL.RPN.IN_FEATURES)
    pre_topk = cfg.MODEL.RPN.PRE_NMS_TOPK_TEST
    post_topk = cfg.MODEL.RPN.POST_NMS_TOPK_TEST
    weights = tuple(cfg.MODEL.RPN.BBOX_REG_WEIGHTS)
    h_pad, w_pad = image_size_hw

    strides_map = feature_strides(cfg)
    feats = [features[f] for f in in_features]
    device = feats[0].device
    nb = feats[0].shape[0]
    anchors = head.anchors([(f.shape[-2], f.shape[-1]) for f in feats],
                           [strides_map[f] for f in in_features], cfg, device)

    lvl_boxes, lvl_scores, lvl_valid = [], [], []
    max_k = max(min(a.shape[0], pre_topk) for a in anchors)
    int8 = head.int8 and quantized(head.conv)
    for fname, feat, anc in zip(in_features, feats, anchors):
        if int8:
            s_in = getattr(head.conv, f"in_scale_{fname}")
            t = to_nchw(link(head.conv, to_s8_nhwc(feat, s_in), s_in, relu=True), feat.dtype)
        else:
            t = F.relu(head.conv(feat))
        # NCHW -> the JAX package's (y, x, a) order (rpn.py:117-127), per
        # frame: objectness (A, H, W) -> (H*W*A,); deltas channel a*4+d ->
        # (H*W*A, 4)
        logits = head.objectness_logits(t).permute(0, 2, 3, 1).reshape(nb, -1)
        deltas = head.anchor_deltas(t).permute(0, 2, 3, 1).reshape(nb, -1, 4)
        hwa = logits.shape[1]
        k = min(hwa, pre_topk)
        logits = logits.float()
        if anchor_valid_hw is not None:
            vh, vw = anchor_valid_hw
            cx = (anc[:, 0] + anc[:, 2]) * 0.5
            cy = (anc[:, 1] + anc[:, 3]) * 0.5
            logits = torch.where((cx < vw) & (cy < vh), logits, torch.full_like(logits, _NEG))
        top_scores, top_idx = top_k(logits, k)  # (B, k)
        boxes = apply_deltas(torch.take_along_dim(deltas, top_idx[..., None], dim=1)
                             .reshape(-1, 4), anc[top_idx].reshape(-1, 4),
                             weights).reshape(nb, k, 4)

        pad = max_k - k
        if pad:
            boxes = torch.cat([boxes, boxes.new_zeros((nb, pad, 4))], dim=1)
            top_scores = torch.cat([top_scores, top_scores.new_full((nb, pad), _NEG)], dim=1)
        valid = (torch.arange(max_k, device=device) < k).expand(nb, max_k)
        if anchor_valid_hw is not None:
            valid = valid & (top_scores > _NEG / 2)
        lvl_boxes.append(boxes)
        lvl_scores.append(top_scores)
        lvl_valid.append(valid)

    boxes = torch.stack(lvl_boxes, dim=1)     # (B, L, K, 4)
    scores = torch.stack(lvl_scores, dim=1)   # (B, L, K)
    valid = torch.stack(lvl_valid, dim=1)     # (B, L, K)

    # validity: finite boxes and scores (proposal_utils.py:102-110)
    valid = valid & torch.isfinite(boxes).all(-1) & torch.isfinite(scores)
    # the reference's swapped (W, H) clip (rpn.py:320)
    boxes = clip_boxes_wh_swapped(boxes, (w_pad, h_pad))
    valid = valid & nonempty_boxes(boxes, float(cfg.MODEL.PROPOSAL_GENERATOR.MIN_SIZE))

    # per-level NMS == the reference's level-offset batched NMS; one K1 launch
    # over every (frame, level) problem
    keep = nms_mask(boxes, scores, valid, cfg.MODEL.RPN.NMS_THRESH)

    flat_boxes = boxes.reshape(nb, -1, 4)
    flat_scores = torch.where(keep & valid, scores,
                              torch.full_like(scores, _NEG)).reshape(nb, -1)
    k_out = min(post_topk, flat_scores.shape[1])
    out_scores, out_idx = top_k(flat_scores, k_out)
    out_boxes = torch.take_along_dim(flat_boxes, out_idx[..., None], dim=1)
    out_valid = out_scores > _NEG / 2
    if k_out < post_topk:
        padn = post_topk - k_out
        out_boxes = torch.cat([out_boxes, out_boxes.new_zeros((nb, padn, 4))], dim=1)
        out_scores = torch.cat([out_scores, out_scores.new_full((nb, padn), _NEG)], dim=1)
        out_valid = torch.cat([out_valid, out_valid.new_zeros((nb, padn))], dim=1)
    return out_boxes, out_scores, out_valid
