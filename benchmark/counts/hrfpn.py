"""HRFPN's bilinear upsamples by 4 and 8: the bytes they need and the least
time the card could take for them, from the configuration and the cell's
shapes alone.

HRFPN brings branches 2, 3 and 4 of HRNet (strides 8, 16 and 32) to stride
4 by bilinear upsamples of 2, 4 and 8. Kernel U1 takes the 2x; the 4x and
8x run as PyTorch's ``upsample_bilinear2d`` kernel, which
``metrics/hrfpn_upsample_roofline.py`` reads by that name. A change that
moves them to another kernel points that reader at the new kernel's name.
Each input element is read once and each output element written once, in
the served dtype.
"""

from __future__ import annotations

from typing import Tuple

from . import peaks
from .shapes import level_hw

BRANCH_STRIDE = 4   # HRNet's finest branch, and HRFPN's p1


def upsample_bytes(cfg: dict, hw: Tuple[int, int], batch: int, elem_bytes: int) -> float:
    """Bytes of the upsamples by 4 and 8 of ``batch`` frames on an
    (Hp, Wp) canvas: branch i (i >= 2, at stride 4 * 2^i) read, and its
    upsample to stride 4 written."""
    chans = cfg["MODEL.HRNET.STAGE4.NUM_CHANNELS"]
    oh, ow = level_hw(hw, BRANCH_STRIDE)
    elements = 0
    for i in range(2, len(chans)):
        ih, iw = level_hw(hw, BRANCH_STRIDE * 2 ** i)
        elements += chans[i] * (ih * iw + oh * ow)
    return float(batch * elements * elem_bytes)


def upsample_bound_s(cfg: dict, hw: Tuple[int, int], batch: int, elem_bytes: int) -> float:
    """The least time of those upsamples: their bytes over HBM bandwidth
    (they do a few operations a byte)."""
    return upsample_bytes(cfg, hw, batch, elem_bytes) / peaks.HBM_BYTES_PER_S
