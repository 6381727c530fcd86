"""The arithmetic of the end-to-end numbers, over a whole window."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def p95(values: Sequence[float]) -> float:
    """The 95th percentile of every value (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def rate(count: float, seconds: float) -> float:
    """Work completed per second of the whole window."""
    return float(count) / float(seconds)
