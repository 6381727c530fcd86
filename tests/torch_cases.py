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


def k3_edge_cases(image_hw, seed=0):
    """K3's edge cases for a pyramid p2-p5 (scales 1/4 .. 1/32) of an
    ``image_hw`` input, as (name, boxes (M, 4) f32 XYXY in image coordinates,
    levels (M,) int32 in 0..3): boxes across and wholly past the borders, far
    edges at the last row and column (the edge clamp), bins under a pixel,
    zero width or height (an empty box when aligned), inverted boxes (bins
    below 0 when aligned), boxes as wide as the image (at p5 the box's
    distinct columns reach the level's width), and random ones.
    tests/test_torch_sparse_pooler.py holds K3's table rows against the
    JAX package's weights on them; tests/test_torch_gpu.py and chip_smoke.py
    hold the kernel against its plain version and K2."""
    h, w = (float(v) for v in image_hw)
    rng = np.random.RandomState(seed)

    def levels(k):
        return rng.randint(0, 4, size=k).astype(np.int32)

    def xyxy(x1, y1, bw, bh):
        return np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)

    k = 48
    cases = [("border", xyxy(rng.uniform(-0.4 * w, 1.1 * w, k), rng.uniform(-0.4 * h, 1.1 * h, k),
                             rng.uniform(4, 0.6 * w, k), rng.uniform(4, 0.6 * h, k)), levels(k))]
    bw, bh = rng.uniform(2, 0.3 * w, k), rng.uniform(2, 0.3 * h, k)
    end_x = w + rng.choice([-2.0, -0.5, 0.0, 0.25, 3.0], k)
    end_y = h + rng.choice([-2.0, -0.5, 0.0, 0.25, 3.0], k)
    cases.append(("edge_clamp", xyxy(end_x - bw, end_y - bh, bw, bh), levels(k)))
    cases.append(("sub_pixel", xyxy(rng.uniform(0, w, k), rng.uniform(0, h, k),
                                    rng.uniform(0.05, 3.0, k), rng.uniform(0.05, 3.0, k)),
                  levels(k)))
    zero = xyxy(rng.uniform(0, w, k), rng.uniform(0, h, k), rng.uniform(1, 80, k),
                rng.uniform(1, 80, k))
    zero[0::3, 2] = zero[0::3, 0]   # zero width
    zero[1::3, 3] = zero[1::3, 1]   # zero height
    zero[2::3, 2:] = zero[2::3, :2]  # a point
    cases.append(("zero_size", zero, levels(k)))
    cases.append(("inverted", xyxy(rng.uniform(0, w, k), rng.uniform(0, h, k),
                                   -rng.uniform(0.5, 60, k), rng.uniform(-60, 60, k)),
                  levels(k)))
    wide = xyxy(rng.uniform(-8, 8, k), rng.uniform(0, 0.5 * h, k), w + rng.uniform(-16, 16, k),
                rng.uniform(8, 0.5 * h, k))
    cases.append(("wide", wide, np.where(np.arange(k) % 2 == 0, 3, levels(k)).astype(np.int32)))
    cases.append(("random", xyxy(rng.uniform(0, 0.9 * w, k), rng.uniform(0, 0.9 * h, k),
                                 rng.uniform(1, 0.4 * w, k), rng.uniform(1, 0.4 * h, k)),
                  levels(k)))
    return cases



def unit_variance_(module, run):
    """Rescales every Conv2d of ``module`` in place so that its output has
    unit standard deviation on the input ``run()`` feeds the model: one pass
    in which a hook divides each conv's weight and bias, and its output, by
    the output's std, so the layers after it see what the rescaled weights
    give (LSUV, Mishkin and Matas, ICLR 2016, in one pass; each conv must run
    once in it). Random weights from ``random_torch_state`` grow HRNet-W32's
    activations to ~1e6 through its fusion sums, past float16's 65504 (and
    JAX's float16 HRFPN overflows on them too); a trained network's BatchNorm
    keeps them near unit scale, as this does."""
    import torch

    def hook(m, args, out):
        s = out.float().std()
        m.weight.data.div_(s)
        m.bias.data.div_(s)
        return out / s

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()


def self_annotations(predictions, points=12, seed=0):
    """COCO DensePose annotations whose ground truth is a model's own
    predictions: ``predictions`` holds, per image, (image id, numpy outputs of
    ``predict_numpy``, the extractor's (results, boxes_xywh)). Each detection
    becomes an annotation with its box, and up to ``points`` of its
    foreground pixels (drawn with ``seed``) as dp_x / dp_y at the pixel's
    centre on the box grid (0..255), with the label and U, V there as
    dp_I / dp_U / dp_V; a detection with no foreground gets no points (an
    ignore region). The same predictions then score box AP 100 and GPS AP
    100 (evaluate.py's metrics). Returns the annotations list."""
    rng = np.random.RandomState(seed)
    anns = []
    for image_id, outputs, (results, boxes_xywh) in predictions:
        for box, res in zip(boxes_xywh, results):
            labels, uv = res["labels"], res["uv"]
            iy, ix = np.nonzero(labels > 0)
            pick = rng.permutation(len(iy))[:points]
            iy, ix = iy[pick], ix[pick]
            h, w = labels.shape
            anns.append({"id": len(anns), "image_id": image_id, "category_id": 1,
                         "bbox": [float(v) for v in box],
                         "dp_x": ((ix + 0.5) / w * 255.0).tolist(),
                         "dp_y": ((iy + 0.5) / h * 255.0).tolist(),
                         "dp_I": labels[iy, ix].astype(int).tolist(),
                         "dp_U": uv[0, iy, ix].astype(float).tolist(),
                         "dp_V": uv[1, iy, ix].astype(float).tolist()})
    return anns


def op_cases(seed=0):
    """Each of the port's operators (``torch.ops.densepose_tpu_torch.*``) at a
    small shape, as (operator name, arguments): arrays stand for tensors, a
    list of arrays for a tensor list, and a string for a dtype
    (``op_args`` makes them tensors). K1 plain and classed; K2 at ratio 2
    and at ratio 0 (adaptive); K3 at ratio 2; Q1 a 3x3 link to s8 with ReLU
    and a 4x4 stride-2 transposed convolution to float32."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(2, 130, 2).astype(np.float32) * 40
    boxes = np.concatenate([xy, xy + 4 + rng.rand(2, 130, 2).astype(np.float32) * 20], -1)
    valid = rng.rand(2, 130) > 0.2
    classes = rng.randint(0, 3, (2, 130)).astype(np.int32)
    feats = [rng.randn(8, 32, 40).astype(np.float32), rng.randn(8, 16, 20).astype(np.float32)]
    rois = np.array([[1, 2, 30, 20], [5, 5, 60, 50], [0, 0, 8, 9], [40, 3, 150, 120]],
                    np.float32)
    levels = np.array([0, 1, 1, 0], np.int32)
    scales = [0.25, 0.125]
    qx = rng.randint(-127, 128, (1, 12, 14, 32)).astype(np.int8)
    qw = rng.randint(-127, 128, (24, 3, 3, 32)).astype(np.int8)
    qwt = rng.randint(-127, 128, (24, 4, 4, 32)).astype(np.int8)
    qb = rng.randint(-500, 500, (24,)).astype(np.int32)
    vec = (rng.rand(24) * 1e-3).astype(np.float32)
    return [("nms_keep", (boxes, valid, 0.5, None)),
            ("nms_keep", (boxes, valid, 0.5, classes)),
            ("roi_align", (feats, rois, levels, scales, [7, 7], 2, True)),
            ("roi_align", (feats, rois, levels, scales, [7, 7], 0, False)),
            ("roi_align_sparse", (feats, rois, levels, scales, [7, 7], 2, True)),
            ("conv_s8", (qx, qw, qb, vec, [1, 1], [1, 1], [1, 1], False, True, "int8")),
            ("conv_s8", (qx, qwt, None, vec, [2, 2], [1, 1], [1, 1], True, False, "float32"))]


def op_args(args, device="cpu"):
    """``op_cases``'s arguments as the operator takes them: tensors on
    ``device``, and torch dtypes."""
    import torch

    def conv(a):
        if isinstance(a, np.ndarray):
            return torch.from_numpy(a).to(device)
        if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            return [torch.from_numpy(x).to(device) for x in a]
        return getattr(torch, a) if isinstance(a, str) else a
    return tuple(conv(a) for a in args)
