"""Spatial sharding of one frame (``densepose_tpu_torch/parallel/mesh.py::
spatial_parallel_forward`` on ``parallel/halo.py``'s row slabs) on the CPU,
shards listed as ``["cpu"] * n``.

1. Each halo primitive against the operation on the whole map, for every
   (kernel, stride, padding, dilation) the backbones use and n in {1, 2, 3,
   4, 8}: uneven shards, empty shards, slabs thinner than a halo, -inf
   max-pool edges, p6's subsample on a slab that starts on an odd row. The
   maps and weights hold small integers, so every sum is exact in float32 in
   any order and the results must be equal bit for bit, whatever the
   convolution algorithm (the CPU's BLAS picks its blocking by the output's
   width, so a slab's float sums may round apart from the whole's).
2. ``preprocess_rows`` against the rows of ``preprocess``, bit for bit.
3. Each backbone's row-sharded walk against its module forward on the same
   input, oneDNN off: the tiny R50-FPN at every compute dtype, the tiny HRNet
   + HRFPN, and both int8 backbones (calibrated, Q1 on its plain version).
   Within 1e-5 of the map's largest magnitude (float sums at other widths,
   above; at a half dtype one unit in its last place).
4. The whole path, fed the JAX package's weights through ``params_from_jax``,
   against JAX ``spatial_parallel_forward(model, make_mesh_2d(1, 8))`` and
   ``jax.jit(model.forward)``: counts, classes and validity exact, scores and
   maps within tests/test_torch_pipeline.py's ATOL = RTOL = 1e-4, boxes
   within 1e-3; the tiny flagship on a frame whose padded height is 2 blocks
   over 8 shards and on one of 3 blocks over 2 and 3 shards, and the tiny
   R101 legacy model with its poolers on K3's plain version.
5. A planted fault (a halo one row short at an interior boundary) fails the
   hold; a frame whose rows do not divide by the shard count raises
   ``ValueError`` in both packages.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from densepose_tpu.config import get_cfg as jax_get_cfg
from densepose_tpu.parallel.mesh import make_mesh_2d
from densepose_tpu.parallel.mesh import spatial_parallel_forward as jax_spatial_forward
from densepose_tpu.predictor import load_params as jax_load_params
from densepose_tpu.models.rcnn import build_model as jax_build_model
from densepose_tpu_torch.checkpoint.transform import params_from_jax
from densepose_tpu_torch.config import get_cfg as port_get_cfg
from densepose_tpu_torch.ops import conv_int8, roi_align_sparse
from densepose_tpu_torch.parallel import halo, spatial_parallel_forward
from densepose_tpu_torch.parallel.halo import RowSlabs, Shards, gather, row_bounds
from densepose_tpu_torch.predictor import DensePosePredictor
from tests.test_torch_hrnet import HRNET, NARROW_HRNET
from tests.test_torch_pipeline import ATOL, RTOL, SEED, tiny_cfg
from tests.test_torch_variants import build_pair, image, variant_cfg
from tests.torch_cases import halo_one_row_short

torch.set_num_threads(2)

FLAGSHIP = "densepose_rcnn_R_50_FPN_s1x"
LEGACY = "densepose_rcnn_R_101_FPN_s1x_legacy"
ALL_INT8 = [("TPU.INT8_HEAD", True), ("TPU.INT8_PREDICTOR", True),
            ("TPU.INT8_BACKBONE", True), ("TPU.INT8_RPN", True)]
SHARDS = [1, 2, 3, 4, 8]
WALK_RTOL = 1e-5
EPS = {torch.float16: 2.0 ** -10, torch.bfloat16: 2.0 ** -7}


# ---------------------------------------------------------------------------
# 1. the primitives
# ---------------------------------------------------------------------------

def int_tensor(shape, seed, lo=-4, hi=5):
    return torch.from_numpy(np.random.RandomState(seed).randint(lo, hi, size=shape)
                            .astype(np.float32))


def int_conv(k, s=1, p=0, d=1, groups=1, cin=4, cout=6, seed=0):
    conv = nn.Conv2d(cin, cout, k, stride=s, padding=p, dilation=d, groups=groups)
    with torch.no_grad():
        conv.weight.copy_(int_tensor(conv.weight.shape, seed, -2, 3))
        conv.bias.copy_(int_tensor(conv.bias.shape, seed + 1))
    return conv


def slabs_of(x, shards, block, row_dim=2):
    """``x`` cut into row slabs of whole ``block``-row blocks."""
    b = row_bounds(x.shape[row_dim], block, len(shards))
    return RowSlabs([x.narrow(row_dim, b[i], b[i + 1] - b[i]) if b[i + 1] > b[i] else None
                     for i in range(len(shards))], b, shards, row_dim)


# (name, the whole map's operation, the sharded one, input rows, block rows):
# the convolutions of the backbones (the stem's 7x7/2, 1x1, 3x3, the
# strided 1x1 and 3x3, res5's dilated 3x3) and a grouped one, the stem's
# pool, HRFPN's pools and bilinear upsamples, the nearest upsamples of FPN
# and the HRModule fuse, and p6's subsample on 1-row blocks (slabs starting
# on odd rows)
CONVS = {"conv 7x7/2 p3": int_conv(7, 2, 3), "conv 1x1": int_conv(1),
         "conv 3x3 p1": int_conv(3, 1, 1), "conv 1x1/2": int_conv(1, 2),
         "conv 3x3/2 p1": int_conv(3, 2, 1), "conv 3x3 p2 d2": int_conv(3, 1, 2, 2),
         "conv 3x3 p1 groups 2": int_conv(3, 1, 1, groups=2)}
PRIMITIVES = [(name, conv, lambda x, c=conv: halo.conv_rows(c, x), 10, 2)
              for name, conv in CONVS.items()]
PRIMITIVES += [
    ("max pool 3/2 p1", lambda x: F.max_pool2d(x, 3, 2, 1),
     lambda x: halo.max_pool_rows(x, 3, 2, 1), 10, 2),
    ("max pool 3/2 p1 negative", lambda x: F.max_pool2d(x - 9, 3, 2, 1),
     lambda x: halo.max_pool_rows(x.map(lambda t: t - 9), 3, 2, 1), 10, 2)]
PRIMITIVES += [(f"avg pool {k}", lambda x, k=k: F.avg_pool2d(x, k),
                lambda x, k=k: halo.avg_pool_rows(x, k), 16, 4) for k in (2, 4, 8)]
PRIMITIVES += [(f"nearest x{s}", lambda x, s=s: F.interpolate(x, scale_factor=float(s)),
                lambda x, s=s: halo.upsample_nearest_rows(x, s), 10, 2) for s in (2, 4, 8)]
PRIMITIVES += [(f"bilinear x{s}", lambda x, s=s: F.interpolate(
    x, scale_factor=float(s), mode="bilinear", align_corners=False),
    lambda x, s=s: halo.upsample_bilinear_rows(x, s), 10, 2) for s in (2, 4, 8)]
PRIMITIVES += [("subsample", lambda x: x[:, :, ::2, ::2], halo.subsample_rows, 5, 1)]


class Holder(nn.Module):
    """The model a ``Shards`` names its modules in."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(CONVS.values())


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("case", PRIMITIVES, ids=lambda c: c[0])
def test_primitive_equals_whole_map(case, n):
    name, whole, sharded, rows, block = case
    shards = Shards(Holder(), ["cpu"] * n)
    x = int_tensor((1, 4, rows, 16), 3)
    with torch.no_grad():
        want = whole(x)
        out = sharded(slabs_of(x, shards, block))
        got = gather(out, "cpu")
    assert out.bounds[-1] == want.shape[2]
    assert torch.equal(got, want), (name, float((got - want).abs().max()))
    if n == 8:  # 5 blocks over 8 shards: the last 3 own no rows
        assert all(p is None for p in out.parts[5:])


def quantized_conv(k, s=1, p=0, d=1, cin=16, cout=8, seed=0):
    conv = int_conv(k, s, p, d, cin=cin, cout=cout, seed=seed)
    qw, sw = conv_int8.quantize_weight_int8(conv.weight)
    conv_int8.set_buffer(conv, "qweight", qw)
    conv_int8.set_buffer(conv, "wscale", sw)
    conv_int8.set_buffer(conv, "in_scale", torch.tensor(0.05))
    conv_int8.set_buffer(conv, "out_scale", torch.tensor(0.5))
    return conv


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("geo", [(3, 1, 1, 1), (3, 2, 1, 1), (1, 2, 0, 1), (3, 1, 2, 2)],
                         ids=["3x3", "3x3/2", "1x1/2", "3x3 d2"])
@pytest.mark.parametrize("out", ["s8", "float32"])
def test_link_rows_equals_whole_map(geo, out, n):
    """Q1 (its plain version) on halo-extended NHWC s8 slabs with row
    padding 0: bit for bit the link on the whole map, s8 or float out."""
    conv = quantized_conv(*geo)
    holder = nn.Module()
    holder.conv = conv
    shards = Shards(holder, ["cpu"] * n)
    q = int_tensor((1, 10, 5, 16), 4, -127, 128).to(torch.int8)
    out_scale = conv.out_scale if out == "s8" else None
    want = conv_int8.link(conv, q, conv.in_scale, out_scale, relu=True)
    got = gather(halo.link_rows(conv, slabs_of(q, shards, 2, row_dim=1), conv.in_scale,
                                out_scale, relu=True), "cpu")
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_fetch_rows_draws_on_several_neighbours():
    """Rows of four 1-row slabs fetched for the first: its own row as a view,
    the halo from the next three shards (three copies counted), the rows
    past the edge filled."""
    shards = Shards(Holder(), ["cpu"] * 4)
    x = int_tensor((1, 2, 4, 3), 5)
    s = slabs_of(x, shards, 1)
    own = halo.fetch_rows(s, 0, 1, "cpu", 0)
    assert own.data_ptr() == x.data_ptr() and shards.stats.halo_copies == 0
    rows = halo.fetch_rows(s, -2, 4, "cpu", 0, fill=-1.0)
    assert torch.equal(rows[:, :, 2:], x) and bool((rows[:, :, :2] == -1).all())
    assert (shards.stats.halo_copies, shards.stats.halo_bytes) == (3, 3 * 2 * 3 * 4)
    with pytest.raises(ValueError, match="past"):
        halo.fetch_rows(s, 0, 5, "cpu", 0)


def test_row_bounds():
    assert row_bounds(64, 32, 8) == [0, 32, 64, 64, 64, 64, 64, 64, 64]
    assert row_bounds(96, 32, 2) == [0, 64, 96]
    assert row_bounds(320, 64, 4) == [0, 128, 192, 256, 320]
    with pytest.raises(ValueError):
        row_bounds(70, 32, 2)


# ---------------------------------------------------------------------------
# 2. the preprocess
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["BGR", "RGB"])
@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("hw", [(60, 80), (97, 61), (70, 200)])
def test_preprocess_rows_bit_exact(hw, n, fmt):
    """Each shard's rows bitwise the rows of ``preprocess``, at float32 and
    float16; the 70x200 frame resizes to 33 rows padded to 64, so a slab
    holds one resized row and 31 of padding."""
    for dtype in ("float32", "float16"):
        cfg = variant_cfg(port_get_cfg, FLAGSHIP, [("INPUT.FORMAT", fmt),
                                                   ("TPU.COMPUTE_DTYPE", dtype)])
        model = DensePosePredictor(cfg, device="cpu", seed=SEED).model
        img = torch.from_numpy(image(7, *hw))
        want, (h1, _), (hp, _) = model.preprocess(img)
        b = row_bounds(hp, model.size_divisibility, n)
        parts = [model.preprocess_rows(img, b[i], b[i + 1]) for i in range(n)]
        assert all(p.dtype == want.dtype and p.is_contiguous() for p in parts)
        for i, p in enumerate(parts):
            assert torch.equal(p, want[:, :, b[i]:b[i + 1]]), (i, b)
        assert (h1, hp) == (33, 64) or hw != (70, 200)


# ---------------------------------------------------------------------------
# 3. the backbones' walks
# ---------------------------------------------------------------------------

def walk_holds(model, img, n):
    """The backbone's row-sharded walk on ``preprocess``'s input against the
    module forward: every level within WALK_RTOL (or a unit in the last
    place of a half dtype) of its largest magnitude."""
    shards = Shards(model, ["cpu"] * n)
    with torch.backends.mkldnn.flags(enabled=False), torch.inference_mode():
        x, _, _ = model.preprocess(torch.from_numpy(img))
        want = model.backbone(x)
        got = model.backbone.forward_rows(slabs_of(x, shards, model.size_divisibility))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            g = gather(got[k], "cpu")
            assert g.dtype == w.dtype and g.shape == w.shape, k
            top = float(w.float().abs().max())
            err = float((g.float() - w.float()).abs().max())
            assert err <= max(WALK_RTOL, EPS.get(w.dtype, 0.0)) * top, (k, err, top)
    return shards


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_resnet_fpn_walk(dtype):
    cfg = variant_cfg(port_get_cfg, FLAGSHIP, [("TPU.COMPUTE_DTYPE", dtype)])
    model = DensePosePredictor(cfg, device="cpu", seed=SEED).model
    for n in (3, 8):
        walk_holds(model, image(8, 256, 96), n)


def test_hrnet_hrfpn_walk():
    cfg = variant_cfg(port_get_cfg, HRNET, NARROW_HRNET)
    model = DensePosePredictor(cfg, device="cpu", seed=SEED).model
    for n in (2, 8):
        walk_holds(model, image(8, 256, 96), n)


@pytest.mark.parametrize("name,extra", [(FLAGSHIP, ALL_INT8),
                                        (HRNET, NARROW_HRNET + [("TPU.INT8_BACKBONE", True)])],
                         ids=["resnet", "hrnet"])
def test_int8_backbone_walk(name, extra):
    """The calibrated int8 backbone: Q1's links (the plain version) on
    halo-extended s8 slabs."""
    pred = DensePosePredictor(variant_cfg(port_get_cfg, name, extra), device="cpu", seed=SEED)
    pred.calibrate_int8([image(21)])
    assert pred.model.backbone.int8_active() if name == FLAGSHIP else \
        conv_int8.quantized(pred.model.backbone.reduction_conv)
    calls = []
    plain = conv_int8.conv_s8_plain

    def spy(qx, *args, **kw):
        calls.append(kw.get("padding"))
        return plain(qx, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(conv_int8, "conv_s8_plain", spy)
        walk_holds(pred.model, image(8, 256, 96), 2)
    assert calls and any(p[0] == 0 and p[1] > 0 for p in calls if p is not None)


# ---------------------------------------------------------------------------
# 4.-5. the whole path against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship():
    jcfg, pcfg = tiny_cfg(jax_get_cfg), tiny_cfg(port_get_cfg)
    jparams = jax_load_params(jcfg, seed=SEED)
    port = DensePosePredictor(pcfg, device="cpu", params=params_from_jax(jparams))
    jp = {k: jnp.asarray(v) for k, v in jparams.items()}
    return jax_build_model(jcfg), jp, port, {}


def jax_outputs(jmodel, jp, frame, cache=None):
    """JAX ``spatial_parallel_forward`` on an 8-device mesh and
    ``jax.jit(forward)`` of one frame, as numpy (kept in ``cache`` by the
    frame's bytes)."""
    key = (frame.shape, frame.tobytes())
    if cache is not None and key in cache:
        return cache[key]
    spatial = jax_spatial_forward(jmodel, make_mesh_2d(1, 8))(jp, jnp.asarray(frame))
    single = jax.jit(jmodel.forward)(jp, jnp.asarray(frame))
    outs = [{k: np.asarray(v) for k, v in out.items()} for out in (spatial, single)]
    if cache is not None:
        cache[key] = outs
    return outs


def holds(got, want):
    """The port's sharded outputs (NCHW maps) against a JAX forward's (NHWC
    maps): counts, classes and validity exact, scores and maps within
    ATOL / RTOL, boxes within 1e-3, on the valid rows."""
    valid = want["valid"]
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    assert int(got["num_instances"]) == int(want["num_instances"]) >= 1
    np.testing.assert_array_equal(got["pred_classes"].numpy()[valid], want["pred_classes"][valid])
    np.testing.assert_allclose(got["scores"].numpy()[valid], want["scores"][valid], atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got["pred_boxes"].numpy()[valid], want["pred_boxes"][valid],
                               atol=1e-3, rtol=RTOL)
    maps = [k for k in want if k.startswith("pred_densepose_")]
    assert sorted(maps) == sorted(k for k in got if k.startswith("pred_densepose_"))
    for k in maps:
        w = np.transpose(want[k], (0, 3, 1, 2))
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy()[valid], w[valid], atol=ATOL, rtol=RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("hw,shard_counts", [((128, 160), (8,)), ((192, 96), (2, 3))],
                         ids=["2 blocks over 8", "3 blocks over 2 and 3"])
def test_flagship_matches_jax(flagship, hw, shard_counts):
    jmodel, jp, port, cache = flagship
    frame = image(2, *hw)
    spatial, single = jax_outputs(jmodel, jp, frame, cache)
    assert int(spatial["num_instances"]) == int(single["num_instances"])
    for n in shard_counts:
        fwd = spatial_parallel_forward(port.model, ["cpu"] * n)
        got = fwd(frame)
        assert len(fwd.shards.replicas) == n and all(r is port.model
                                                     for r in fwd.shards.replicas)
        assert got["pred_densepose_u"].shape[0] == port.cfg.TEST.DETECTIONS_PER_IMAGE
        assert "det_packed" in got and got["image_size"].tolist() == list(hw)
        for want in (spatial, single):
            holds(got, want)


def test_r101_legacy_on_k3_matches_jax(monkeypatch):
    """The tiny R101 legacy model, the box and DensePose poolers on K3's plain
    version (DENSEPOSE_TPU_SPARSE_POOLER), over 2 shards."""
    _, _, jmodel, jp, _, port = build_pair(LEGACY)
    frame = image(3, 192, 96)
    spatial, single = jax_outputs(jmodel, jp, frame)
    calls = []
    plain = roi_align_sparse.roi_align_sparse_plain
    monkeypatch.setattr(roi_align_sparse, "roi_align_sparse_plain",
                        lambda *a: calls.append(a[1].shape[0]) or plain(*a))
    monkeypatch.setenv("DENSEPOSE_TPU_SPARSE_POOLER", "1")
    got = spatial_parallel_forward(port.model, ["cpu"] * 2)(frame)
    assert len(calls) == 2
    for want in (spatial, single):
        holds(got, want)


def test_planted_halo_fault_fails(flagship, monkeypatch):
    """A halo one row short at an interior boundary (its last row zero,
    ``tests/torch_cases.py::halo_one_row_short``) breaks the hold against
    JAX, and a primitive's."""
    jmodel, jp, port, cache = flagship
    frame = image(2, 192, 96)
    spatial, _ = jax_outputs(jmodel, jp, frame, cache)
    holds(spatial_parallel_forward(port.model, ["cpu"] * 2)(frame), spatial)
    monkeypatch.setattr(halo, "fetch_rows", halo_one_row_short(halo.fetch_rows))
    with pytest.raises(AssertionError):
        holds(spatial_parallel_forward(port.model, ["cpu"] * 2)(frame), spatial)
    conv = CONVS["conv 3x3 p1"]
    x = int_tensor((1, 4, 10, 6), 3)
    with torch.no_grad():
        got = gather(halo.conv_rows(conv, slabs_of(x, Shards(Holder(), ["cpu"] * 2), 2)),
                     "cpu")
        assert not torch.equal(got, conv(x))


def test_rows_not_dividing_raise(flagship):
    jmodel, jp, port, _ = flagship
    frame = image(4, 60, 80)
    with pytest.raises(ValueError, match="does not split over 8 shards"):
        spatial_parallel_forward(port.model, ["cpu"] * 8)(frame)
    with pytest.raises(ValueError):
        jax_spatial_forward(jmodel, make_mesh_2d(1, 8))(jp, jnp.asarray(frame))


def test_devices_default_needs_a_card(flagship, monkeypatch):
    """``devices=None`` is every visible card, and there is none here; the
    CPU runs only when listed."""
    port = flagship[2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spatial_parallel_forward(port.model)
