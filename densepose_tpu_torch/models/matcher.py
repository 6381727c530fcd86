"""Matcher and label subsampling (port of densepose_tpu/models/matcher.py).

IoU-threshold assignment with low-quality-match promotion
(detectron2/modeling/matcher.py) and the fixed-size foreground / background
subsample (modeling/sampling.py::subsample_labels). Both are training-time
pieces that the reference builds and never runs at inference; the JAX
package keeps them as working functions, and so does the port, in plain
PyTorch.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch


def match_quality(iou_matrix: torch.Tensor, thresholds: List[float], labels: List[int],
                  allow_low_quality_matches: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """iou_matrix (G, P) ground truth x predictions -> (matches (P,) int32,
    the best ground truth of each prediction; match_labels (P,) int8 in
    {-1, 0, 1}: ``labels[i]`` for a best IoU in [edge i, edge i + 1) of
    [0] + thresholds + [inf]). With ``allow_low_quality_matches`` the
    predictions that tie some ground truth's best IoU (above 0) are labelled
    1 (matcher.py's ``set_low_quality_matches_``)."""
    matched_vals, matches = iou_matrix.max(dim=0)
    match_labels = torch.full(matched_vals.shape, labels[-1], dtype=torch.int8,
                              device=iou_matrix.device)
    edges = [0.0] + list(thresholds) + [float("inf")]
    for lo, hi, lab in zip(edges[:-1], edges[1:], labels):
        in_range = (matched_vals >= lo) & (matched_vals < hi)
        match_labels = torch.where(in_range, torch.full_like(match_labels, lab), match_labels)
    if allow_low_quality_matches:
        highest = iou_matrix.max(dim=1, keepdim=True).values
        promote = (iou_matrix == highest).any(dim=0) & (matched_vals > 0)
        match_labels = torch.where(promote, torch.ones_like(match_labels), match_labels)
    return matches.int(), match_labels


def subsample_labels(labels: torch.Tensor, num_samples: int, positive_fraction: float,
                     bg_label: int, generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-size random foreground / background subsample (sampling.py:12-54
    with static output sizes): (pos_mask, neg_mask) over ``labels``.
    min(num_samples * positive_fraction, available) positives (labels
    neither -1 nor ``bg_label``), then min(num_samples - positives taken,
    available) negatives, each drawn uniformly without replacement by a
    random priority from ``generator`` (on the labels' device). The JAX
    package draws from a ``jax.random`` key: the counts and the uniformity
    are the same, the draw is not."""
    positive = (labels != -1) & (labels != bg_label)
    negative = labels == bg_label

    def pick(mask, target):
        n_take = min(target, int(mask.sum()))
        pri = torch.rand(mask.shape, generator=generator, device=labels.device)
        pri = torch.where(mask, pri, torch.full_like(pri, -1.0))
        rank = torch.empty_like(labels, dtype=torch.long)
        rank[torch.argsort(-pri)] = torch.arange(mask.numel(), device=labels.device)
        return mask & (rank < n_take), n_take

    pos_mask, n_pos = pick(positive, int(num_samples * positive_fraction))
    neg_mask, _ = pick(negative, num_samples - n_pos)
    return pos_mask, neg_mask
