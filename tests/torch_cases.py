"""Inputs shared by the port's CPU tests, its card tests and ``chip_smoke.py``.

Numpy only, so that the card run imports nothing of JAX through it.
"""

import numpy as np


def k1_edge_cases(seed=0):
    """K1's edge cases as score-sorted problems (name, boxes (K, 4) f32,
    valid (K,) bool, classes (K,) int32 or None, IoU threshold): K at the
    64-box word edges, all boxes invalid, all identical, zero-area boxes (the
    union > 0 guard), IoUs swept across the threshold in steps of 1e-6, and
    three classes. tests/test_torch_ops.py holds the plain version against the
    TPU kernel on them; tests/test_torch_gpu.py and chip_smoke.py hold the
    kernel against the plain version."""
    rng = np.random.RandomState(seed)

    def boxes(k, span=60.0, size=30.0):
        ctr = rng.rand(k, 2) * span
        wh = rng.rand(k, 2) * size + 1
        return np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)

    cases = [(f"k{k}", boxes(k), rng.rand(k) > 0.1, None, 0.5) for k in (1, 63, 64, 65, 130)]
    cases.append(("all_invalid", boxes(70), np.zeros(70, bool), None, 0.5))
    cases.append(("identical", np.tile(np.float32([[10, 20, 50, 80]]), (70, 1)),
                  np.ones(70, bool), None, 0.7))
    zero = boxes(66)
    zero[::2, 2] = zero[::2, 0]       # zero width
    zero[1::4, 3] = zero[1::4, 1]     # zero height
    zero[2::6] = zero[0::6][:len(zero[2::6])]  # zero-area twins: union 0
    cases.append(("zero_area", zero, np.ones(66, bool), None, 0.0))
    for thr in (0.7, 0.5):  # pairs (unit box, box of height thr * 10 +- k * 1e-6)
        heights = np.float32(thr * 10) + (np.arange(65, dtype=np.float32) - 32) * np.float32(1e-6)
        near = []
        for i, h in enumerate(heights):
            near += [[30.0 * i, 0, 30.0 * i + 10, 10], [30.0 * i, 0, 30.0 * i + 10, h]]
        cases.append((f"near_{thr}", np.float32(near), np.ones(130, bool), None, thr))
    cases.append(("three_classes", boxes(100), rng.rand(100) > 0.1,
                  rng.randint(0, 3, size=100).astype(np.int32), 0.5))
    return cases
