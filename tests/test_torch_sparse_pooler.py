"""The skip-flag ROIAlign (kernel K3's schedule and its plain PyTorch version)
held against the JAX package's ``roi_align_multilevel_sparse``.

On the CPU the JAX function runs its Pallas kernel in interpret mode
(roi_align_kernel.py:231), so this compares with the TPU kernel's own body.
Tolerances: the port's plain version and the Pallas kernel take the same
weight rows and contract them in another order, and K2's gather sums the
taps in yet another, so outputs agree to fp32 reassociation: 2e-5 absolute
and relative on unit-scale features, the JAX package's own tolerance for
this pooler (tests/test_ops.py:625). The sort order and the flag table are
integers and must be equal. K3's table rows (``sparse_axis_rows``), scattered
into dense rows, must equal the port's and the JAX package's
``_axis_weights`` bit for bit on the edge cases of
``tests/torch_cases.py::k3_edge_cases``.

The kernel itself is held against the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from densepose_tpu.ops.pallas import roi_align_kernel as jax_rk
from densepose_tpu.ops.roi_align import _axis_weights as jax_axis_weights
from densepose_tpu_torch.ops import roi_align, roi_align_sparse
from torch_cases import k3_edge_cases  # tests/ is on the path (pytest's rootdir insertion)

torch.set_num_threads(2)

TOL = 2e-5
SCALES = [1 / 4, 1 / 8, 1 / 16, 1 / 32]


def pyramid(rng, c, h, w):
    """Unit-scale (H, W, C) levels for JAX and the same as (C, H, W) for the port."""
    hwc = [rng.randn(h // 2 ** i, w // 2 ** i, c).astype(np.float32) for i in range(4)]
    return hwc, [torch.from_numpy(f).permute(2, 0, 1).contiguous() for f in hwc]


def case(seed, m=150, span=100, c=16, h=32, w=64):
    """The geometry of tests/test_ops.py::test_sparse_pooler_interpret_parity
    (a narrower C, 150 boxes so there are two chunks), with a few boxes that
    share an x1 so the stable sort's tie order matters. Every JAX call here
    takes these shapes, so the interpreted kernel is traced once."""
    rng = np.random.RandomState(seed)
    hwc, chw = pyramid(rng, c, h, w)
    xy = rng.rand(m, 2).astype(np.float32) * span
    wh = rng.rand(m, 2).astype(np.float32) * 60 + 4
    boxes = np.concatenate([xy, xy + wh], axis=1)
    boxes[1:6, 0] = boxes[0, 0]
    levels = rng.randint(0, 4, size=m).astype(np.int32)
    levels[1:6] = levels[0]
    return hwc, chw, boxes, levels


def jax_sparse(hwc, boxes, levels, aligned, monkeypatch=None, flags_out=None):
    """JAX's roi_align_multilevel_sparse (Pallas, interpret mode), as
    (M, C, 7, 7); with ``flags_out``, also record the flag table it hands
    each level's pallas_call."""
    if flags_out is not None:
        inner = jax_rk._pool_one_level_sparse

        def spy(feat, wy2, wxt, flags, out_h, out_w):
            flags_out.append(np.asarray(flags))
            return inner(feat, wy2, wxt, flags, out_h, out_w)

        monkeypatch.setattr(jax_rk, "_pool_one_level_sparse", spy)
    out = jax_rk.roi_align_multilevel_sparse(
        [jnp.asarray(f) for f in hwc], jnp.asarray(boxes), jnp.asarray(levels), SCALES,
        (7, 7), 2, aligned)
    return np.transpose(np.asarray(out), (0, 3, 1, 2))


@pytest.mark.parametrize("aligned", [True, False])
def test_plain_matches_jax_sparse(aligned):
    hwc, chw, boxes, levels = case(7)
    want = jax_sparse(hwc, boxes, levels, aligned)
    got = roi_align_sparse.roi_align_sparse_plain(
        chw, torch.from_numpy(boxes), torch.from_numpy(levels), SCALES, (7, 7), 2, aligned)
    assert got.shape == want.shape == (150, 16, 7, 7)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("aligned", [True, False])
def test_schedule_matches_jax(aligned, monkeypatch):
    """Order and flags equal to JAX's; the boxes leave some (chunk, tile)
    pairs inactive."""
    hwc, chw, boxes, levels = case(8)
    flags = []
    want_out = jax_sparse(hwc, boxes, levels, aligned, monkeypatch, flags)
    key = (jnp.asarray(levels).astype(jnp.float32) * 1e7
           + jnp.clip(jnp.asarray(boxes)[:, 0], 0.0, 1e6))
    want_order = np.asarray(jnp.argsort(key))
    sched = roi_align_sparse.sparse_schedule(
        chw, torch.from_numpy(boxes), torch.from_numpy(levels), SCALES, (7, 7), 2, aligned)
    np.testing.assert_array_equal(sched.order.numpy(), want_order)
    np.testing.assert_array_equal(sched.order[sched.inv].numpy(), np.arange(150))
    assert len(flags) == len(sched.flags) == 4
    for li, (got, want) in enumerate(zip(sched.flags, flags)):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"level {li}")
    active = sum(int(f.sum()) for f in flags)
    total = sum(f.size for f in flags)
    assert 0 < active < total
    got_out = roi_align_sparse.roi_align_sparse_plain(
        chw, torch.from_numpy(boxes), torch.from_numpy(levels), SCALES, (7, 7), 2, aligned)
    np.testing.assert_allclose(got_out.numpy(), want_out, atol=TOL, rtol=TOL)


def test_axis_weights_match_jax():
    rng = np.random.RandomState(3)
    start = (rng.rand(40).astype(np.float32) * 70 - 10)
    bin_size = rng.rand(40).astype(np.float32) * 5 + 0.1
    want = np.asarray(jax_axis_weights(jnp.asarray(start), jnp.asarray(bin_size), 7, 2, 50))
    got = roi_align_sparse._axis_weights(torch.from_numpy(start), torch.from_numpy(bin_size),
                                         7, 2, 50)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("aligned", [True, False])
def test_plain_matches_gather(aligned):
    """K3's plain version against K2's, on the same inputs."""
    hwc, chw, boxes, levels = case(9)
    b, lv = torch.from_numpy(boxes), torch.from_numpy(levels)
    want = roi_align.roi_align_plain(chw, b, lv, SCALES, (7, 7), 2, aligned)
    got = roi_align_sparse.roi_align_sparse_plain(chw, b, lv, SCALES, (7, 7), 2, aligned)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)


def test_routing(monkeypatch):
    """With DENSEPOSE_TPU_SPARSE_POOLER set, the multi-level pooler takes K3's
    plain version on the CPU; the single-level pooler stays on K2's. Unset,
    both take K2's."""
    calls = []
    for mod, name in [(roi_align_sparse, "roi_align_sparse_plain"),
                      (roi_align, "roi_align_plain")]:
        inner = getattr(mod, name)

        def spy(*args, inner=inner, name=name):
            calls.append(name)
            return inner(*args)

        monkeypatch.setattr(mod, name, spy)
    _, chw, boxes, levels = case(10)
    b, lv = torch.from_numpy(boxes), torch.from_numpy(levels)

    monkeypatch.setenv("DENSEPOSE_TPU_SPARSE_POOLER", "1")
    sparse = roi_align.roi_align_multilevel(chw, b, lv, SCALES, (7, 7), 2, False)
    roi_align.roi_align_single(chw[0], b, 0.25, (5, 5), 2, False)
    assert calls == ["roi_align_sparse_plain", "roi_align_plain"]

    monkeypatch.delenv("DENSEPOSE_TPU_SPARSE_POOLER")
    calls.clear()
    gather = roi_align.roi_align_multilevel(chw, b, lv, SCALES, (7, 7), 2, False)
    assert calls == ["roi_align_plain"]
    np.testing.assert_allclose(sparse.numpy(), gather.numpy(), atol=TOL, rtol=TOL)


EDGE_HW = (96, 160)  # the edge cases' input size: levels 24x40, 12x20, 6x10, 3x5


@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("name", [case[0] for case in k3_edge_cases(EDGE_HW)])
def test_sparse_axis_rows_match_axis_weights(name, aligned, g):
    """K3's table rows at every level, along both axes: distinct ascending
    columns, and as dense rows the port's and the JAX package's weights to
    the bit."""
    boxes = torch.from_numpy(dict((c[0], c[1]) for c in k3_edge_cases(EDGE_HW))[name])
    m = boxes.shape[0]
    for li, scale in enumerate(SCALES):
        size = (EDGE_HW[0] // 4 // 2 ** li, EDGE_HW[1] // 4 // 2 ** li)
        start_h, bin_h, start_w, bin_w = roi_align._roi_geometry(
            boxes, torch.full((m,), scale), (7, 7), aligned)
        for start, bin_size, limit in ((start_h, bin_h, size[0]), (start_w, bin_w, size[1])):
            cols, weights, count = roi_align_sparse.sparse_axis_rows(start, bin_size, 7, g, limit)
            assert cols.shape == weights.shape == (m, 7, 2 * g)
            dense = torch.zeros(m, 7, limit + 1).scatter_(
                2, torch.where(cols < 0, limit, cols), weights)[..., :limit]
            want = roi_align_sparse._axis_weights(start, bin_size, 7, g, limit)
            assert torch.equal(dense, want), (li, limit)
            np.testing.assert_array_equal(dense.numpy(), np.asarray(jax_axis_weights(
                jnp.asarray(start.numpy()), jnp.asarray(bin_size.numpy()), 7, g, limit)))
            assert torch.equal(count, (want != 0).sum(dim=2))
            assert bool(((cols[..., 1:] > cols[..., :-1]) | (cols[..., 1:] < 0)).all())
