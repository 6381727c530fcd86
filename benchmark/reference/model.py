"""The reference DensePose R-CNN in plain float32 PyTorch.

One frame at a time, no kernels, no batching, TF32 off: the backbone, the
RPN, the FastRCNN box stage, detector_postprocess, and the DensePose stage
(the Panoptic-FPN decoder and a single-level pooler, or the legacy
multi-level pooler; the head; the chart predictor's deconvs and 2x
upsample). The backbone and the DensePose head are parts found by the names
the configuration gives them (``benchmark/parts.py``); this module holds
what every configuration shares, and reads the levels' strides, widths and
padding from the backbone part. It is written from the published
descriptions of detectron2's DensePose models. It keeps the semantics that
the served configuration states where they differ from upstream detectron2:

* the RPN clips its proposals with the padded input's (W, H) passed where
  (H, W) is expected, so x is clamped to the padded height and y to the
  padded width;
* the box stage does not clip its detections; the DensePose stage pools at
  the unclipped detection boxes; the boxes are clipped only after they are
  scaled back to the frame;
* a detection is kept when its width and height, scaled back to the frame
  and before the clip, are >= 0.

The configuration is a flat dict of detectron2 keys (``MODEL.RPN.NMS_THRESH``
...); the weights a dict of fp32 tensors under detectron2's module names
(``state_shapes`` lists them). Nothing of the program under test is imported.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .. import parts
from . import ops

Weights = Dict[str, torch.Tensor]

_CHART = (("coarse_segm", "ann_index_lowres"), ("fine_segm", "index_uv_lowres"),
          ("u", "u_lowres"), ("v", "v_lowres"))


def decoder_chains(cfg) -> List[Tuple[str, int]]:
    """(feature, convs) of each decoder chain: a chain on a level of stride s
    has max(1, log2(s / common)) conv (+ 2x upsample) steps."""
    common = cfg["MODEL.ROI_DENSEPOSE_HEAD.DECODER_COMMON_STRIDE"]
    strides = parts.backbone(cfg).strides(cfg)
    return [(f, max(1, int(math.log2(strides[f] / common))))
            for f in cfg["MODEL.ROI_HEADS.IN_FEATURES"]]


def state_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Every weight the reference reads, by detectron2 module name, with its
    shape, in the order the weights are drawn: the backbone part's, the RPN
    head's, the box head's, the decoder's, the DensePose head part's and the
    chart predictor's; convs OIHW with a bias, linears (out, in), transposed
    convs (in, out, kh, kw)."""
    backbone = parts.backbone(cfg)
    shapes: Dict[str, Tuple[int, ...]] = dict(backbone.shapes(cfg))

    def conv(name, cin, cout, k):
        shapes[f"{name}.weight"] = (cout, cin, k, k)
        shapes[f"{name}.bias"] = (cout,)

    c = backbone.out_channels(cfg)
    strides = backbone.strides(cfg)
    g = "MODEL.ANCHOR_GENERATOR."
    a = len(cfg[g + "SIZES"][0]) * len(cfg[g + "ASPECT_RATIOS"][0])
    rpn = "proposal_generator.rpn_head"
    conv(f"{rpn}.conv", c, c, 3)
    conv(f"{rpn}.objectness_logits", c, a, 1)
    conv(f"{rpn}.anchor_deltas", c, 4 * a, 1)
    res = cfg["MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION"]
    fc = cfg["MODEL.ROI_BOX_HEAD.FC_DIM"]
    d = c * res * res
    for i in range(cfg["MODEL.ROI_BOX_HEAD.NUM_FC"]):
        shapes[f"roi_heads.box_head.fc{i + 1}.weight"] = (fc, d)
        shapes[f"roi_heads.box_head.fc{i + 1}.bias"] = (fc,)
        d = fc
    n = cfg["MODEL.ROI_HEADS.NUM_CLASSES"]
    shapes["roi_heads.box_predictor.cls_score.weight"] = (n + 1, fc)
    shapes["roi_heads.box_predictor.cls_score.bias"] = (n + 1,)
    shapes["roi_heads.box_predictor.bbox_pred.weight"] = (4 * n, fc)
    shapes["roi_heads.box_predictor.bbox_pred.bias"] = (4 * n,)
    dp = "MODEL.ROI_DENSEPOSE_HEAD."
    if cfg[dp + "DECODER_ON"]:
        dims = cfg[dp + "DECODER_CONV_DIMS"]
        for f, steps in decoder_chains(cfg):
            stride = 2 if strides[f] != cfg[dp + "DECODER_COMMON_STRIDE"] else 1
            for k in range(steps):
                conv(f"roi_heads.decoder.{f}.{k * stride}", c if k == 0 else dims, dims, 3)
        conv("roi_heads.decoder.predictor", dims, cfg[dp + "DECODER_NUM_CLASSES"], 1)
    head = parts.head(cfg)
    shapes.update(head.shapes(cfg, parts.head_in_channels(cfg)))
    hd = head.out_channels(cfg)
    patches = cfg[dp + "NUM_PATCHES"] + 1
    k = cfg[dp + "DECONV_KERNEL"]
    for _, name in _CHART:
        cout = cfg[dp + "NUM_COARSE_SEGM_CHANNELS"] if name == "ann_index_lowres" else patches
        shapes[f"roi_heads.densepose_predictor.{name}.weight"] = (hd, cout, k, k)
        shapes[f"roi_heads.densepose_predictor.{name}.bias"] = (cout,)
    return shapes


def rpn(cfg, w: Weights, feats: Dict[str, torch.Tensor], pad_hw: Tuple[int, int]):
    """StandardRPNHead + find_top_rpn_proposals of one frame: per level the
    top PRE_NMS_TOPK_TEST anchors by objectness, decoded; the clip; NMS at
    NMS_THRESH within each level; the top POST_NMS_TOPK_TEST of what every
    level kept. Returns proposals (K, 4)."""
    r = "MODEL.RPN."
    g = "MODEL.ANCHOR_GENERATOR."
    head = "proposal_generator.rpn_head"
    sizes, ratios = cfg[g + "SIZES"], cfg[g + "ASPECT_RATIOS"]
    strides = parts.backbone(cfg).strides(cfg)
    boxes_all, scores_all, levels_all = [], [], []
    for i, f in enumerate(cfg[r + "IN_FEATURES"]):
        # one entry is shared by every level, otherwise one entry a level
        cells = ops.cell_anchors(sizes[i if len(sizes) > 1 else 0],
                                 ratios[i if len(ratios) > 1 else 0])
        x = feats[f]
        t = ops.conv(x, w, f"{head}.conv", relu=True)
        logits = ops.conv(t, w, f"{head}.objectness_logits")[0].permute(1, 2, 0).reshape(-1)
        deltas = ops.conv(t, w, f"{head}.anchor_deltas")[0].permute(1, 2, 0).reshape(-1, 4)
        anchors = ops.grid_anchors(x.shape[-2], x.shape[-1], strides[f], cells,
                                   cfg[g + "OFFSET"]).to(x.device)
        k = min(logits.shape[0], cfg[r + "PRE_NMS_TOPK_TEST"])
        idx = torch.sort(logits, descending=True, stable=True).indices[:k]
        boxes = ops.apply_deltas(deltas[idx], anchors[idx], cfg[r + "BBOX_REG_WEIGHTS"])
        boxes_all.append(boxes)
        scores_all.append(logits[idx])
        levels_all.append(torch.full((k,), i, device=x.device))
    boxes = torch.cat(boxes_all)
    scores = torch.cat(scores_all)
    levels = torch.cat(levels_all)
    ok = torch.isfinite(boxes).all(1) & torch.isfinite(scores)
    boxes, scores, levels = boxes[ok], scores[ok], levels[ok]
    # the served configuration's clip: x to the padded height, y to the width
    boxes = ops.clip(boxes, pad_hw[0], pad_hw[1])
    min_size = cfg["MODEL.PROPOSAL_GENERATOR.MIN_SIZE"]
    ok = ((boxes[:, 2] - boxes[:, 0]) >= min_size) & ((boxes[:, 3] - boxes[:, 1]) >= min_size)
    boxes, scores, levels = boxes[ok], scores[ok], levels[ok]
    keep = []
    for i in range(len(cfg[r + "IN_FEATURES"])):
        sel = torch.nonzero(levels == i).flatten()
        keep.append(sel[ops.nms(boxes[sel], scores[sel], cfg[r + "NMS_THRESH"])])
    keep = torch.cat(keep)
    order = torch.sort(scores[keep], descending=True, stable=True).indices
    return boxes[keep[order[:cfg[r + "POST_NMS_TOPK_TEST"]]]]


def box_stage(cfg, w: Weights, feats: Dict[str, torch.Tensor], proposals: torch.Tensor):
    """FastRCNNConvFCHead + FastRCNNOutputLayers + fast_rcnn_inference of one
    frame. Returns every candidate, one a proposal and class (boxes (N, 4)
    in input coordinates, unclipped, scores (N,), classes (N,), finite (N,)),
    and ``keep``: the candidates the inference keeps (score above the
    threshold, per-class NMS), at most DETECTIONS_PER_IMAGE, by decreasing
    score."""
    b = "MODEL.ROI_BOX_HEAD."
    names = cfg["MODEL.ROI_HEADS.IN_FEATURES"]
    if cfg[b + "NUM_CONV"] or cfg[b + "CLS_AGNOSTIC_BBOX_REG"]:
        raise ValueError("the reference box head holds FCs and class-specific regression")
    strides = parts.backbone(cfg).strides(cfg)
    scales = [1.0 / strides[f] for f in names]
    pooled = ops.roi_align_levels([feats[f][0] for f in names], proposals, scales,
                                  cfg[b + "POOLER_RESOLUTION"], cfg[b + "POOLER_SAMPLING_RATIO"],
                                  cfg[b + "POOLER_TYPE"] == "ROIAlignV2")
    x = pooled.flatten(1)
    for i in range(cfg[b + "NUM_FC"]):
        x = F.relu(F.linear(x, w[f"roi_heads.box_head.fc{i + 1}.weight"],
                            w[f"roi_heads.box_head.fc{i + 1}.bias"]))
    logits = F.linear(x, w["roi_heads.box_predictor.cls_score.weight"],
                      w["roi_heads.box_predictor.cls_score.bias"])
    deltas = F.linear(x, w["roi_heads.box_predictor.bbox_pred.weight"],
                      w["roi_heads.box_predictor.bbox_pred.bias"])
    probs = torch.softmax(logits, dim=-1)
    n = cfg["MODEL.ROI_HEADS.NUM_CLASSES"]
    boxes = ops.apply_deltas(deltas.reshape(-1, 4), proposals.repeat_interleave(n, 0),
                             cfg[b + "BBOX_REG_WEIGHTS"])
    scores = probs[:, :n].reshape(-1)
    classes = torch.arange(n, device=boxes.device).repeat(proposals.shape[0])
    finite = (torch.isfinite(boxes).all(1).reshape(-1, n).all(1)
              & torch.isfinite(probs).all(1)).repeat_interleave(n)
    cand = torch.nonzero((scores > cfg["MODEL.ROI_HEADS.SCORE_THRESH_TEST"]) & finite).flatten()
    keep = []
    for c in range(n):
        sel = cand[classes[cand] == c]
        keep.append(sel[ops.nms(boxes[sel], scores[sel], cfg["MODEL.ROI_HEADS.NMS_THRESH_TEST"])])
    keep = torch.cat(keep)
    order = torch.sort(scores[keep], descending=True, stable=True).indices
    return boxes, scores, classes, finite, keep[order[:cfg["TEST.DETECTIONS_PER_IMAGE"]]]


def densepose(cfg, w: Weights, feats: Dict[str, torch.Tensor],
              boxes: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The DensePose stage at ``boxes`` (n, 4) in input coordinates: maps
    (n, C, HEATMAP_SIZE, HEATMAP_SIZE) of the coarse and fine segmentation,
    U and V."""
    dp = "MODEL.ROI_DENSEPOSE_HEAD."
    names = cfg["MODEL.ROI_HEADS.IN_FEATURES"]
    res = cfg[dp + "POOLER_RESOLUTION"]
    ratio = cfg[dp + "POOLER_SAMPLING_RATIO"]
    aligned = cfg[dp + "POOLER_TYPE"] == "ROIAlignV2"
    if cfg[dp + "DECODER_NORM"]:
        raise ValueError("the reference holds an unnormalized decoder")
    strides = parts.backbone(cfg).strides(cfg)
    if cfg[dp + "DECODER_ON"]:
        common = cfg[dp + "DECODER_COMMON_STRIDE"]
        acc = None
        for f, steps in decoder_chains(cfg):
            x = feats[f]
            up = strides[f] != common
            for k in range(steps):
                x = ops.conv(x, w, f"roi_heads.decoder.{f}.{k * 2 if up else k}", relu=True)
                if up:
                    x = F.interpolate(x, scale_factor=2.0, mode="bilinear", align_corners=False)
            acc = x if acc is None else acc + x
        sem = ops.conv(acc, w, "roi_heads.decoder.predictor")
        x = ops.roi_align(sem[0], boxes, 1.0 / common, res, ratio, aligned)
    else:
        scales = [1.0 / strides[f] for f in names]
        x = ops.roi_align_levels([feats[f][0] for f in names], boxes, scales, res, ratio,
                                 aligned)
    x = parts.head(cfg).forward(cfg, w, x)
    k = cfg[dp + "DECONV_KERNEL"]
    up = float(cfg[dp + "UP_SCALE"])
    out = {}
    for key, name in _CHART:
        p = f"roi_heads.densepose_predictor.{name}"
        y = F.conv_transpose2d(x, w[f"{p}.weight"], w[f"{p}.bias"], stride=2,
                               padding=int(k / 2 - 1))
        out[key] = F.interpolate(y, scale_factor=up, mode="bilinear", align_corners=False)
    return out


def preprocess(cfg, image: torch.Tensor):
    """(H0, W0, 3) uint8 BGR -> (1, 3, Hp, Wp) normalized and zero-padded to
    a multiple of the backbone part's size divisibility, the resized (h1, w1)
    and (Hp, Wp): detectron2's ResizeShortestEdge at test time."""
    h0, w0 = image.shape[:2]
    lo, hi = cfg["INPUT.MIN_SIZE_TEST"], cfg["INPUT.MAX_SIZE_TEST"]
    k = min(lo / min(h0, w0), hi / max(h0, w0))
    h1, w1 = int(h0 * k), int(w0 * k)
    if cfg["INPUT.FORMAT"] == "RGB":
        image = image.flip(-1)
    x = ops.resize_u8(image, k, (h1, w1))
    mean = torch.tensor(cfg["MODEL.PIXEL_MEAN"], dtype=torch.float32, device=x.device)
    std = torch.tensor(cfg["MODEL.PIXEL_STD"], dtype=torch.float32, device=x.device)
    x = (x - mean[:, None, None]) / std[:, None, None]
    d = parts.backbone(cfg).size_divisibility(cfg)
    hp, wp = -(-h1 // d) * d, -(-w1 // d) * d
    x = F.pad(x, (0, wp - w1, 0, hp - h1))
    return x[None], (h1, w1), (hp, wp)


@torch.no_grad()
def detect(cfg, w: Weights, image: torch.Tensor) -> dict:
    """One frame (H0, W0, 3) uint8 BGR on the weights' device, up to its
    detections: {"image_size" (2,), "features" (the p-levels), every box
    stage candidate's "net" box (input coordinates, unclipped), "boxes"
    (scaled to the frame and clipped), "scores", "classes" and "valid"
    (finite, width and height >= 0 once scaled and before the clip), and
    "keep": the candidates kept as detections, by decreasing score}."""
    h0, w0 = image.shape[:2]
    x, (h1, w1), pad_hw = preprocess(cfg, image)
    feats = parts.backbone(cfg).forward(cfg, w, x)
    proposals = rpn(cfg, w, feats, pad_hw)
    net, scores, classes, finite, keep = box_stage(cfg, w, feats, proposals)
    scale = torch.tensor([w0 / w1, h0 / h1, w0 / w1, h0 / h1], dtype=torch.float32,
                         device=x.device)
    boxes = net * scale
    valid = finite & ((boxes[:, 2] - boxes[:, 0]) >= 0) & ((boxes[:, 3] - boxes[:, 1]) >= 0)
    return {"image_size": torch.tensor([h0, w0]), "features": feats, "net": net,
            "boxes": ops.clip(boxes, w0, h0), "scores": scores, "classes": classes,
            "valid": valid, "keep": keep[valid[keep]]}


@torch.no_grad()
def maps_at(cfg, w: Weights, found: dict, rows: torch.Tensor, chunk: int = 128):
    """The DensePose maps of the candidates ``rows`` of ``detect``'s result."""
    parts = [densepose(cfg, w, found["features"], found["net"][rows[i:i + chunk]])
             for i in range(0, len(rows), chunk)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]} if parts else {}


def set_precision_flags() -> None:
    """float32 products in float32: TF32 off for matmuls and cuDNN convs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
