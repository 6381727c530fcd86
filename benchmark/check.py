"""The comparison that decides ``correct``: the program's outputs of the
sampled frames against the plain reference's on the same frames and weights.

A detection says: this box, of this class, scores this much. Each of the
program's detections pairs with one of the reference's candidates (every
proposal and class of its box stage before the score threshold, NMS and the
top-D cut): the candidate of its class whose box lies within PAIR_GAP (the
largest coordinate difference over 1 + the candidate's longer side) and
whose score lies within SCORE_TOL, the nearest by the larger of the two
shares of those limits, one to one. A detection of the same proposal moves
far less than that at float16; one of another proposal lies a sizeable share
of a box away or scores otherwise.

The paired candidates S, read with the reference's boxes and scores, have
to be what the box stage's selection keeps, but for near ties. Greedy NMS
keeps the one set in which no two boxes of a class overlap by more than
NMS_THRESH_TEST and every other candidate above the score threshold is
overlapped by more than that by a higher-scored member; where candidates
score or overlap within the served dtype's rounding of each other, either of
them may be kept, and what follows from that choice down the greedy walk
changes with it. So, with the tolerances SCORE_TOL and IOU_TOL:

1. every member of S scores at least SCORE_THRESH_TEST - SCORE_TOL;
2. no two members of a class overlap by more than NMS_THRESH_TEST + IOU_TOL
   (the lower-scored of such a pair counts as wrong);
3. every other candidate scoring more than SCORE_THRESH_TEST + SCORE_TOL,
   and, where the program filled all D slots, more than S's lowest score +
   SCORE_TOL, is covered: a member of its class overlaps it by more than
   NMS_THRESH_TEST - IOU_TOL and scores at least its score - SCORE_TOL.

A program detection that pairs with no candidate or breaks 1 or 2 is wrong,
and so is a candidate that breaks 3. So a detection too many breaks 1 or 2,
or finds no candidate, and one too few leaves a candidate uncovered: each
frame's count is held by the same rules.

The maps of each paired detection are judged against the reference's maps
at that candidate's box. The numbers compared, each against its limit from
the configuration file:

* ``size_err``: |H - h0| + |W - w0| of every frame's image size, over every
  batch of the window and the reference's (exact);
* ``unpaired``: the wrong detections and candidates over the program's
  detections and the reference's kept ones, over the sampled frames;
* ``unpaired_frame``: the same share in the sampled frame where it is
  largest (a fault confined to one camera of the batch);
* ``maps_rel``: for each paired detection, the largest over the coarse and
  fine segmentation, U and V of the L2 norm of the program's map minus the
  reference's over the reference's; the 90th percentile over the pairs (the
  order statistic at or above it). A few pairs read far more at float16 for
  a reason that is not a fault (a box whose area puts it on the boundary
  between two FPN levels by less than float16's rounding is pooled from the
  other level; a box of zero area pools nothing but the padding), so the
  percentile and not the pooled norm is compared; ``details`` gives both.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np

PAIR_GAP = 5e-3
SCORE_TOL = 1e-2
IOU_TOL = 2e-2
TOL_SCALES = (0.0, 1.0, 2.0)   # the rules read at these multiples of the tolerances
MAPS_QUANTILE = 0.9
MAPS = ("coarse_segm", "fine_segm", "u", "v")
NUMBERS = ("size_err", "unpaired", "unpaired_frame", "maps_rel")


def unpack(det: np.ndarray):
    """A frame's ``det_packed`` (D+1, 7) -> (boxes, scores, classes, valid,
    num_instances, (H, W))."""
    rows = det[:-1]
    head = det[-1]
    return (rows[:, :4], rows[:, 4], rows[:, 5].astype(np.int64), rows[:, 6] > 0.5,
            int(head[0]), (int(head[1]), int(head[2])))


def box_gap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(len(a), len(b)) gaps of boxes a to boxes b, relative to b's size."""
    side = np.maximum(b[:, 2] - b[:, 0], b[:, 3] - b[:, 1])
    return np.abs(a[:, None, :] - b[None, :, :]).max(-1) / (1.0 + side[None, :])


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(len(a), len(b)) IoU as torchvision's box_iou; 0 where both boxes
    have no area (0 / 0, which suppresses nothing)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    with np.errstate(invalid="ignore", divide="ignore"):
        iou = inter / (area_a[:, None] + area_b[None, :] - inter)
    return np.nan_to_num(iou, nan=0.0)


def pairs(a_boxes, a_scores, a_classes, b_boxes, b_scores, b_classes):
    """One-to-one pairs (i, j) of rows of a (in their order) with rows of b
    within PAIR_GAP and SCORE_TOL, the nearest by the larger share."""
    if len(a_boxes) == 0 or len(b_boxes) == 0:
        return []
    dist = np.maximum(box_gap(a_boxes, b_boxes) / PAIR_GAP,
                      np.abs(a_scores[:, None] - b_scores[None, :]) / SCORE_TOL)
    dist[a_classes[:, None] != b_classes[None, :]] = np.inf
    used = np.zeros(len(b_boxes), bool)
    out = []
    for i in range(len(a_boxes)):
        d = np.where(used, np.inf, dist[i])
        j = int(np.argmin(d))
        if d[j] <= 1.0:
            used[j] = True
            out.append((i, j))
    return out


def rule_breaks(sel: np.ndarray, ref: dict, rules: dict, full: bool, scale: float = 1.0):
    """(members of ``sel`` that break rule 1 or 2, candidates that break
    rule 3): ``sel`` the candidates the program's detections paired with,
    ``full`` whether the program filled every slot, the tolerances at
    ``scale`` times SCORE_TOL and IOU_TOL."""
    st, it = scale * SCORE_TOL, scale * IOU_TOL
    thresh, nms = rules["score_thresh"], rules["nms_thresh"]
    scores, classes, net = ref["scores"], ref["classes"], ref["net"]
    wrong = scores[sel] < thresh - st
    if len(sel) > 1:
        over = box_iou(net[sel], net[sel]) > nms + it
        over &= classes[sel][:, None] == classes[sel][None, :]
        # of each overlapping pair, the lower-scored member (the later by
        # index among equal scores)
        s = scores[sel]
        order = np.lexsort((np.arange(len(sel)), -s))
        rank = np.empty(len(sel), np.int64)
        rank[order] = np.arange(len(sel))
        wrong |= (over & (rank[None, :] < rank[:, None])).any(1)
    line = thresh + st
    if full and len(sel):
        line = max(line, float(scores[sel].min()) + st)
    others = np.setdiff1d(np.nonzero(ref["valid"] & (scores > line))[0], sel)
    if len(others) == 0:
        return int(wrong.sum()), 0
    if len(sel) == 0:
        return int(wrong.sum()), len(others)
    cover = box_iou(net[others], net[sel]) > nms - it
    cover &= classes[others][:, None] == classes[sel][None, :]
    cover &= scores[sel][None, :] >= scores[others][:, None] - st
    return int(wrong.sum()), int((~cover.any(1)).sum())


def order_stat(values, q: float) -> float:
    """The q-th quantile of ``values`` as the order statistic at or above
    it (no interpolation, so an infinite value stays infinite); NaN of none."""
    ranked = sorted(values)
    return float(ranked[math.ceil(q * (len(ranked) - 1))]) if ranked else math.nan


class Comparison:
    def __init__(self, frame_hw, cfg: dict):
        """``cfg``: the configuration file's ``model`` keys (the box stage's
        score threshold, NMS threshold and detections a frame)."""
        self.frame_hw = tuple(frame_hw)
        self.rules = {"score_thresh": float(cfg["MODEL.ROI_HEADS.SCORE_THRESH_TEST"]),
                      "nms_thresh": float(cfg["MODEL.ROI_HEADS.NMS_THRESH_TEST"]),
                      "slots": int(cfg["TEST.DETECTIONS_PER_IMAGE"])}
        self.size_err = 0
        self.judged = 0
        self.wrong = {s: 0 for s in TOL_SCALES}
        self.frame_share: List[float] = []
        self.pair_rel: List[float] = []
        self.near_gap: List[float] = []
        self.near_score: List[float] = []
        self.diff2 = {k: 0.0 for k in MAPS}
        self.ref2 = {k: 0.0 for k in MAPS}
        self.frames = 0

    def headers(self, dets: np.ndarray) -> None:
        """Every frame's image size in a batch's (B, D+1, 7) ``det_packed``."""
        h, w = self.frame_hw
        err = np.abs(dets[:, -1, 1] - h) + np.abs(dets[:, -1, 2] - w)
        self.size_err = max(self.size_err, int(err.max()))

    def frame(self, det: np.ndarray, maps: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
              ref_maps: Callable[[np.ndarray], Dict[str, np.ndarray]]) -> None:
        """One sampled frame: its ``det_packed`` and maps (D, C, S, S) against
        the reference's candidates (``reference.model.detect``, as numpy:
        "boxes" in the frame, "net" as the box stage's NMS saw them)
        and ``ref_maps(candidate rows)``."""
        boxes, scores, classes, valid, _, size = unpack(det)
        rh, rw = (int(v) for v in ref["image_size"])
        self.size_err = max(self.size_err, abs(size[0] - rh) + abs(size[1] - rw))
        self.frames += 1
        pi = np.nonzero(valid)[0]
        ci = np.nonzero(ref["valid"])[0]
        pb, ps, pc = boxes[pi], scores[pi], classes[pi]
        found = pairs(pb, ps, pc, ref["boxes"][ci], ref["scores"][ci], ref["classes"][ci])
        sel = np.array([ci[j] for _, j in found], np.int64)
        full = len(pi) >= self.rules["slots"]
        judged = len(pi) + len(ref["keep"])
        self.judged += judged
        for s in TOL_SCALES:
            bad_p, bad_r = rule_breaks(sel, ref, self.rules, full, s)
            wrong = len(pi) - len(found) + bad_p + bad_r
            self.wrong[s] += wrong
            if s == 1.0:
                self.frame_share.append(min(1.0, wrong / judged) if judged else 0.0)
        if len(pi) and len(ci):
            # each detection's nearest candidate of its class, by the pairing's
            # measure but unfiltered: the readings PAIR_GAP and SCORE_TOL are set from
            gap = box_gap(pb, ref["boxes"][ci])
            sgap = np.abs(ps[:, None] - ref["scores"][ci][None, :])
            dist = np.maximum(gap / PAIR_GAP, sgap / SCORE_TOL)
            dist[pc[:, None] != ref["classes"][ci][None, :]] = np.inf
            j = dist.argmin(1)
            ok = np.isfinite(dist[np.arange(len(pi)), j])
            self.near_gap.extend(gap[np.arange(len(pi)), j][ok].tolist())
            self.near_score.extend(sgap[np.arange(len(pi)), j][ok].tolist())
        if not found:
            return
        rows = np.array([pi[i] for i, _ in found])
        want = ref_maps(sel)
        for n, a in enumerate(rows):
            rel = []
            for k in MAPS:
                p = maps[k][a].astype(np.float64)
                r = want[k][n].astype(np.float64)
                d2, r2 = float(((p - r) ** 2).sum()), float((r ** 2).sum())
                self.diff2[k] += d2
                self.ref2[k] += r2
                rel.append(math.sqrt(d2 / r2) if r2 > 0 else (0.0 if d2 == 0 else math.inf))
            self.pair_rel.append(max(rel))

    def share(self, scale: float = 1.0) -> float:
        return min(1.0, self.wrong[scale] / self.judged) if self.judged else math.nan

    def numbers(self) -> Dict[str, float]:
        return {"size_err": float(self.size_err), "unpaired": self.share(),
                "unpaired_frame": max(self.frame_share) if self.frame_share else math.nan,
                "maps_rel": order_stat(self.pair_rel, MAPS_QUANTILE)}

    def details(self) -> Dict[str, float]:
        """Readings beside the numbers compared: ``unpaired`` with the
        tolerances at 0 and twice theirs; each detection's nearest candidate's
        box and score gaps; each map's pooled relative L2 over every pair, the
        pairs' median and largest; the counts."""
        out = {f"unpaired.tol{s:g}": self.share(s) for s in TOL_SCALES if s != 1.0}
        for name, vals in (("near_gap", self.near_gap), ("near_score", self.near_score)):
            out.update({f"{name}.p{q}": order_stat(vals, q / 100) for q in (50, 90, 100)})
        out.update({f"maps_pooled.{k}": math.sqrt(self.diff2[k] / self.ref2[k]) if self.ref2[k]
                    else math.nan for k in MAPS})
        out["maps_rel.p50"] = order_stat(self.pair_rel, 0.5)
        out["maps_rel.max"] = order_stat(self.pair_rel, 1.0)
        out.update({"judged": self.judged, "wrong": self.wrong[1.0],
                    "pairs": len(self.pair_rel), "frames": self.frames})
        return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number known and within its limit."""
    return all(not math.isnan(numbers[k]) and numbers[k] <= limits[k] for k in NUMBERS)
