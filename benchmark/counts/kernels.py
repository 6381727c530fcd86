"""K1 (NMS) and K2 (ROIAlign): operations and bytes one launch needs, and
the least time the chip could take for them.

K1 on a problem of K boxes computes the IoU of every pair once (13
operations a pair: four max / min, two widths, two clamps, the intersection,
the union's add and subtract, the divide and the compare) and reads each box
(16 bytes) and its valid flag and writes its keep flag. K2 computes, for
each region, channel and output bin, ratio^2 bilinear samples (4 multiplies
and 4 adds each) and one divide, and writes each output element once; its
reads of the feature maps depend on where the boxes lie and are not counted,
so the byte count is a floor. Both run in fp32 arithmetic.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from . import peaks

IOU_OPS = 13
BOX_BYTES = 16


def k1_work(problem_sizes: Iterable[int]) -> Tuple[float, float]:
    """(operations, bytes) of one K1 launch over the given problems."""
    ops = sum(k * (k - 1) / 2 * IOU_OPS for k in problem_sizes)
    nbytes = sum(k * (BOX_BYTES + 2) for k in problem_sizes)
    return float(ops), float(nbytes)


def k2_work(regions: int, channels: int, out: int, ratio: int,
            elem_bytes: int) -> Tuple[float, float]:
    """(operations, bytes) of one K2 launch pooling ``regions`` boxes of
    ``channels`` to out x out at ``ratio`` samples a bin and axis, written
    in an ``elem_bytes`` type; each box comes with its level and frame
    (4 bytes each)."""
    bins = regions * channels * out * out
    ops = bins * (ratio * ratio * 8 + 1)
    nbytes = bins * elem_bytes + regions * (BOX_BYTES + 8)
    return float(ops), float(nbytes)


def bound_s(ops: float, nbytes: float, flops_per_s: float = peaks.FP32_FLOPS) -> float:
    """The least time: the larger of operations over the peak rate and
    bytes over HBM bandwidth."""
    return max(ops / flops_per_s, nbytes / peaks.HBM_BYTES_PER_S)
