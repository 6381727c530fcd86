"""DensePoseDataFilter's IoU selection (port of densepose_tpu/models/filter.py).

The reference selects, for DensePose training, the proposals that overlap a
ground-truth box above FG_IOU_THRESHOLD (densepose/modeling/filter.py); no
inference path runs it. A fixed-shape mask, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..ops.boxes import pairwise_iou


def densepose_data_filter_mask(proposal_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                               gt_valid: torch.Tensor,
                               fg_iou_threshold: float = 0.7) -> torch.Tensor:
    """The proposals (P, 4) whose best IoU with a valid ground-truth box
    (gt_boxes (G, 4), gt_valid (G,)) is at least the threshold: (P,) bool."""
    iou = pairwise_iou(proposal_boxes, gt_boxes)
    iou = torch.where(gt_valid[None, :], iou, torch.zeros_like(iou))
    return iou.max(dim=1).values >= fg_iou_threshold
