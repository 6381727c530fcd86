"""The PyTorch port's ops held against the JAX package and the numpy oracles.

NMS and ROIAlign are the two ops with hand-written CUDA kernels (K1, K2).
Here, on the CPU, their plain PyTorch versions are held against:

* the JAX package's CPU routing (fixed-point ``nms_mask`` /
  ``batched_nms_mask``, gather ``roi_align_multilevel``),
* the numpy oracles of tests/reference_ops.py,
* the bodies of the TPU kernels the CUDA kernels replace
  (``nms_kernel.py::_nms_kernel`` and ``roi_align_kernel.py::_kernel``),
  run through ``pl.pallas_call(..., interpret=True)``.

Keep masks must match exactly. ROIAlign against the JAX gather is the same
fp32 arithmetic (1e-6); against the float64 numpy oracle and the separable
Pallas form it is a reassociation (1e-5 at unit-scale features). The port
pools NCHW: (C, H, W) levels into (M, C, oh, ow); the JAX package and the
oracles take (H, W, C) levels and return (M, oh, ow, C), so these tests
permute explicitly.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from densepose_tpu.ops import anchors as jax_anchors
from densepose_tpu.ops import boxes as jax_boxes
from densepose_tpu.ops import nms as jax_nms
from densepose_tpu.ops import resize as jax_resize
from densepose_tpu.ops import roi_align as jax_ra
from densepose_tpu.ops.pallas import roi_align_kernel as jax_rk
from densepose_tpu.ops.pallas.nms_kernel import _nms_kernel
from densepose_tpu_torch.ops import anchors, boxes, cuda_build, nms, resize, roi_align
from tests.reference_ops import nms_np, roi_align_np
from torch_cases import k1_edge_cases  # tests/ is on the path, as for test_torch_gpu.py

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a))


def random_boxes(rng, k, span=80.0, size=40.0):
    ctr = rng.rand(k, 2).astype(np.float32) * span
    wh = rng.rand(k, 2).astype(np.float32) * size + 1
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], 1)


def near_threshold_boxes(thr, k=64):
    """Pairs of boxes whose IoU sits within a few ulps of ``thr``: a unit box
    against one whose height sweeps across thr * 10 in steps of 1e-6."""
    heights = thr * 10 + (np.arange(k // 2, dtype=np.float32) - k // 4) * 1e-6
    out = []
    for i, h in enumerate(heights):
        x = 30.0 * i
        out += [[x, 0, x + 10, 10], [x, 0, x + 10, h]]
    return np.asarray(out, np.float32)


NMS_CASES = [
    ("random", 64, 0.5), ("random", 256, 0.7), ("near", 64, 0.7), ("near", 64, 0.5),
]


def nms_case(kind, k, thr, seed=0):
    rng = np.random.RandomState(seed)
    b = random_boxes(rng, k) if kind == "random" else near_threshold_boxes(thr, k)
    scores = rng.rand(len(b)).astype(np.float32)
    if kind == "near":  # the unit box first, so it decides the pair
        scores = np.repeat([0.9, 0.1], len(b) // 2).astype(np.float32)
        scores[1::2], scores[0::2] = 0.1, 0.9
    valid = rng.rand(len(b)) > 0.1
    return b, scores, valid


@pytest.mark.parametrize("kind,k,thr", NMS_CASES)
def test_nms_plain_matches_jax_and_numpy(kind, k, thr):
    b, s, v = nms_case(kind, k, thr)
    want = np.asarray(jax_nms.nms_mask(jnp.asarray(b), jnp.asarray(s), jnp.asarray(v), thr))
    got = nms.nms_mask(t(b), t(s), t(v), thr).numpy()
    np.testing.assert_array_equal(got, want)
    idx = np.nonzero(v)[0]
    oracle = set(idx[nms_np(b[idx], s[idx], thr)].tolist())
    assert set(np.nonzero(got)[0].tolist()) == oracle
    if kind == "near":  # the sweep really straddles the threshold
        kept_pairs = got[1::2]
        assert kept_pairs.any() and not kept_pairs.all()


@pytest.mark.parametrize("k,thr", [(64, 0.5), (300, 0.7)])
def test_batched_nms_plain_matches_jax(k, thr):
    rng = np.random.RandomState(1)
    b = random_boxes(rng, k, span=60, size=30)
    s = rng.rand(k).astype(np.float32)
    c = rng.randint(0, 3, size=k).astype(np.int32)
    v = rng.rand(k) > 0.1
    want = np.asarray(jax_nms.batched_nms_mask(jnp.asarray(b), jnp.asarray(s),
                                               jnp.asarray(c), jnp.asarray(v), thr))
    got = nms.batched_nms_mask(t(b), t(s), t(c), t(v), thr).numpy()
    np.testing.assert_array_equal(got, want)
    for cls in range(3):
        idx = np.nonzero(v & (c == cls))[0]
        kept = set(idx[nms_np(b[idx], s[idx], thr)].tolist())
        assert set(np.nonzero(got & (c == cls))[0].tolist()) == kept


def test_nms_problem_batch_matches_jax_vmap():
    """The RPN's layout: 5 level problems in one call (one K1 launch on the
    card), equal to the JAX package's vmapped per-level nms_mask."""
    rng = np.random.RandomState(2)
    b = np.stack([random_boxes(rng, 120) for _ in range(5)])
    s = rng.randn(5, 120).astype(np.float32)
    v = rng.rand(5, 120) > 0.2
    want = np.asarray(jax.vmap(jax_nms.nms_mask, in_axes=(0, 0, 0, None))(
        jnp.asarray(b), jnp.asarray(s), jnp.asarray(v), 0.7))
    got = nms.nms_mask(t(b), t(s), t(v), 0.7).numpy()
    np.testing.assert_array_equal(got, want)


def k1_body_interpret(b_sorted, v_sorted, thr, c_sorted=None):
    """The TPU kernel K1 (nms_kernel.py::_nms_kernel) run by Pallas's
    interpreter on the CPU."""
    k = b_sorted.shape[0]
    rows = jnp.asarray(b_sorted.T)
    if c_sorted is not None:
        rows = jnp.concatenate([rows, jnp.asarray(c_sorted, jnp.float32)[None]], 0)
    keep = pl.pallas_call(
        functools.partial(_nms_kernel, iou_threshold=float(thr), k=k,
                          classed=c_sorted is not None),
        out_shape=jax.ShapeDtypeStruct((1, k), jnp.float32),
        scratch_shapes=[pltpu.VMEM((1, k), jnp.float32)],
        interpret=True,
    )(rows, jnp.asarray(v_sorted, jnp.float32)[None])
    return np.asarray(keep[0]) > 0.5


@pytest.mark.parametrize("kind,k,thr,classed",
                         [("random", 64, 0.5, False), ("random", 96, 0.7, True),
                          ("near", 64, 0.7, False)])
def test_nms_plain_matches_k1_body(kind, k, thr, classed):
    b, s, v = nms_case(kind, k, thr, seed=3)
    order = np.argsort(-np.where(v, s, -1e30), kind="stable")
    c = np.random.RandomState(4).randint(0, 2, size=len(b)).astype(np.int32)
    c_sorted = c[order] if classed else None
    want = k1_body_interpret(b[order], v[order], thr, c_sorted)
    got = nms.nms_keep(t(b[order])[None], t(v[order])[None], thr,
                       None if c_sorted is None else t(c_sorted)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", k1_edge_cases(), ids=lambda case: case[0])
def test_nms_plain_edge_cases_match_k1_body_and_numpy(case):
    """K1's edge cases (tests/torch_cases.py::k1_edge_cases, which the card
    holds the kernel to): word edges, all invalid, all identical, zero area, the sweep
    across the threshold, three classes."""
    name, b, v, c, thr = case
    want = k1_body_interpret(b, v, thr, c)
    got = nms.nms_keep(t(b)[None], t(v)[None], thr, None if c is None else t(c)[None])[0]
    np.testing.assert_array_equal(got.numpy(), want)
    s = np.linspace(1, 0, len(b), dtype=np.float32)  # the problems are score-sorted
    for cls in (range(3) if c is not None else [None]):
        idx = np.nonzero(v & (True if cls is None else c == cls))[0]
        kept = set(idx[nms_np(b[idx], s[idx], thr)].tolist()) if len(idx) else set()
        sel = got.numpy() & (True if cls is None else c == cls)
        assert set(np.nonzero(sel)[0].tolist()) == kept
    if name.startswith("near"):  # the sweep really straddles the threshold
        assert got[1::2].any() and not got[1::2].all()
    if name == "identical":
        assert got.sum() == 1


def pyramid(rng, hw=(32, 48), c=16, levels=4):
    return [rng.randn(hw[0] // 2 ** i, hw[1] // 2 ** i, c).astype(np.float32)
            for i in range(levels)]


def pool_boxes(rng, m, span=(180, 120)):
    xy = rng.rand(m, 2).astype(np.float32) * np.float32(span)
    wh = rng.rand(m, 2).astype(np.float32) * 90 + 0.5
    b = np.concatenate([xy, xy + wh], 1)
    b[:3] = [[-20, -10, 30, 25], [150, 100, 260, 170], [5, 5, 5.2, 5.1]]  # borders, tiny
    return b


SCALES = [1 / 4, 1 / 8, 1 / 16, 1 / 32]


def chw(hwc_level):
    """An (H, W, C) numpy level -> the port's contiguous (C, H, W) tensor."""
    return t(hwc_level).permute(2, 0, 1).contiguous()


def hwc(pooled):
    """The port's (M, C, oh, ow) output -> the JAX package's (M, oh, ow, C)."""
    return pooled.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("aligned,out", [(False, 7), (True, 5)])
def test_roi_align_plain_matches_jax_gather_and_numpy(aligned, out):
    rng = np.random.RandomState(5)
    feats = pyramid(rng)
    b = pool_boxes(rng, 40)
    lv = jax_ra.assign_boxes_to_levels(jnp.asarray(b), 2, 5)
    got_lv = roi_align.assign_boxes_to_levels(t(b), 2, 5)
    np.testing.assert_array_equal(got_lv.numpy(), np.asarray(lv))
    want = np.asarray(jax_ra.roi_align_multilevel(
        [jnp.asarray(f) for f in feats], jnp.asarray(b), lv, SCALES, (out, out), 2, aligned))
    got = hwc(roi_align.roi_align_multilevel([chw(f) for f in feats], t(b), got_lv, SCALES,
                                             (out, out), 2, aligned))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # Under jit, XLA turns ``roi_h / out_h`` into a product with the rounded
    # reciprocal, so the JAX predictor's bin sizes can differ from the
    # port's (and torchvision's) true quotient in the last bit.
    jitted = np.asarray(jax.jit(lambda f, b, l: jax_ra.roi_align_multilevel(
        f, b, l, SCALES, (out, out), 2, aligned))([jnp.asarray(f) for f in feats],
                                                  jnp.asarray(b), lv))
    np.testing.assert_allclose(got, jitted, atol=5e-5, rtol=0)
    lvn = np.asarray(lv)
    for i in range(len(b)):
        oracle = roi_align_np(feats[lvn[i]], b[i:i + 1], SCALES[lvn[i]], (out, out), 2,
                              aligned)
        np.testing.assert_allclose(got[i:i + 1], oracle, atol=1e-5, rtol=0)


@pytest.mark.parametrize("aligned,out,m", [(False, 7, 40), (False, 8, 12), (True, 7, 20)])
def test_roi_align_plain_matches_k2_body(monkeypatch, aligned, out, m):
    """The TPU kernel K2 (roi_align_kernel.py::_kernel, through
    roi_align_multilevel_fused) in Pallas interpret mode."""
    rng = np.random.RandomState(6 + m)
    feats = pyramid(rng, c=8)
    b = pool_boxes(rng, m)
    lv = rng.randint(0, 4, size=m).astype(np.int32)
    monkeypatch.setattr(jax_rk.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    want = np.asarray(jax_rk.roi_align_multilevel_fused(
        [jnp.asarray(f) for f in feats], jnp.asarray(b), jnp.asarray(lv), SCALES,
        (out, out), 2, aligned))
    got = hwc(roi_align.roi_align_multilevel([chw(f) for f in feats], t(b), t(lv), SCALES,
                                             (out, out), 2, aligned))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_roi_align_single_is_level_zero():
    rng = np.random.RandomState(8)
    f = rng.randn(24, 40, 8).astype(np.float32)
    b = pool_boxes(rng, 10, span=(100, 60))
    want = np.asarray(jax_ra.roi_align_single(jnp.asarray(f), jnp.asarray(b), 0.25,
                                              (8, 8), 2, False))
    got = hwc(roi_align.roi_align_single(chw(f), t(b), 0.25, (8, 8), 2, False))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def adaptive_boxes(rng, m):
    """Boxes whose bins need one sample (tiny), some (medium) and more than
    the cap of 8 (large) on level 0 at scale 1/4."""
    sizes = np.repeat(np.float32([[2, 3], [30, 50], [300, 260]]), -(-m // 3), 0)[:m]
    xy = rng.rand(m, 2).astype(np.float32) * np.float32([150, 100]) - 20
    wh = sizes * (0.8 + 0.4 * rng.rand(m, 2).astype(np.float32))
    return np.concatenate([xy, xy + wh], 1)


@pytest.mark.parametrize("single,aligned,out", [(False, False, 7), (False, True, 5),
                                                (True, False, 4), (True, True, 3)])
def test_roi_align_adaptive_ratio_matches_jax(monkeypatch, single, aligned, out):
    """Ratio 0: per box and axis min(ceil(bin), 8) samples, as the JAX gather
    computes them; the multi-level pooler takes the gather at ratio 0 even
    with the sparse-pooler variable set, as the JAX package does."""
    rng = np.random.RandomState(14 + out)
    feats = pyramid(rng, c=8)
    b = adaptive_boxes(rng, 30)
    bins = np.asarray(roi_align._roi_geometry(t(b), torch.full((30,), 0.25), (out, out),
                                              aligned)[1::2])
    need = np.ceil(bins)
    assert (need <= 1).any() and ((need > 1) & (need <= 8)).any() and (need > 8).any()
    if single:
        want = np.asarray(jax_ra.roi_align_single(jnp.asarray(feats[0]), jnp.asarray(b),
                                                  0.25, (out, out), 0, aligned))
        got = hwc(roi_align.roi_align_single(chw(feats[0]), t(b), 0.25, (out, out), 0,
                                             aligned))
    else:
        monkeypatch.setenv("DENSEPOSE_TPU_SPARSE_POOLER", "1")
        lv = rng.randint(0, 4, size=30).astype(np.int32)
        lv[::3] = 0  # the large boxes exceed the cap on level 0
        want = np.asarray(jax_ra.roi_align_multilevel(
            [jnp.asarray(f) for f in feats], jnp.asarray(b), jnp.asarray(lv), SCALES,
            (out, out), 0, aligned))
        got = hwc(roi_align.roi_align_multilevel([chw(f) for f in feats], t(b), t(lv),
                                                 SCALES, (out, out), 0, aligned))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError):
        nms.nms_keep_cuda(torch.zeros(1, 4, 4), torch.ones(1, 4, dtype=torch.bool), 0.5)
    with pytest.raises(ValueError):
        roi_align.roi_align_cuda([torch.zeros(2, 4, 4)], torch.zeros(1, 4),
                                 torch.zeros(1, dtype=torch.int32), [1.0], (2, 2), 2, False)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build(["nms"])


@pytest.mark.parametrize("h,w,oh,ow", [(60, 80, 64, 85), (97, 61, 96, 60),
                                       (480, 640, 800, 1066)])
def test_preprocess_resize_bit_exact(h, w, oh, ow):
    img = (np.random.RandomState(h).rand(h, w, 3) * 255).astype(np.uint8)
    k = min(oh / h, ow / w)
    want = jax_resize.resize_bilinear_np(img, (oh, ow), scale=(k, k))
    np.testing.assert_array_equal(
        np.asarray(jax_resize.resize_bilinear_packed(jnp.asarray(img), (oh, ow),
                                                     scale=(k, k))), want)
    got = resize.resize_image(t(img), (oh, ow), scale=(k, k)).numpy()
    np.testing.assert_array_equal(got, want)


def test_resize_bilinear_2x_matches_jax():
    x = np.random.RandomState(9).randn(3, 14, 10, 5).astype(np.float32)
    want = np.asarray(jax_resize.resize_bilinear(jnp.asarray(x), (28, 20), scale=(2.0, 2.0)))
    got = resize.resize_bilinear(t(x).permute(0, 3, 1, 2), (28, 20), scale=(2.0, 2.0))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-6, rtol=0)


def test_box_ops_match_jax():
    rng = np.random.RandomState(10)
    b = random_boxes(rng, 50)
    d = rng.randn(50, 8).astype(np.float32) * 2
    np.testing.assert_allclose(
        boxes.apply_deltas(t(d), t(b), (10.0, 10.0, 5.0, 5.0)).numpy(),
        np.asarray(jax_boxes.apply_deltas(jnp.asarray(d), jnp.asarray(b),
                                          (10.0, 10.0, 5.0, 5.0))), rtol=1e-6, atol=1e-4)
    for fn, args in [(boxes.clip_boxes, (30, 50)), (boxes.clip_boxes_wh_swapped, (50, 30))]:
        np.testing.assert_array_equal(
            fn(t(b), args).numpy(), np.asarray(getattr(jax_boxes, fn.__name__)(
                jnp.asarray(b), args)))
    np.testing.assert_array_equal(boxes.nonempty_boxes(t(b[:, [2, 1, 0, 3]])).numpy(),
                                  np.asarray(jax_boxes.nonempty_boxes(
                                      jnp.asarray(b[:, [2, 1, 0, 3]]))))
    np.testing.assert_array_equal(
        boxes.pairwise_iou(t(b), t(b[:20])).numpy(),
        np.asarray(jax_boxes.pairwise_iou(jnp.asarray(b), jnp.asarray(b[:20]))))


def test_anchors_match_jax():
    args = ([(25, 34), (13, 17), (7, 9)], [4, 8, 16], [[32], [64], [128]], [[0.5, 1.0, 2.0]])
    for got, want in zip(anchors.anchors_for_levels(*args),
                         jax_anchors.anchors_for_levels(*args)):
        np.testing.assert_array_equal(got, want)
