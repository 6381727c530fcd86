"""The port's host consumer layer held against the JAX package's on the same
numpy inputs, in-process and without a predictor: the native library
(``densepose_tpu_torch/native``), the extractor and overlays
(``densepose_tpu_torch/visualizer.py``) and ``numpy_outputs``.

Byte-identical: both packages build one C source with the same flags, and
their Python around it is the same arithmetic, so every label, UV value and
overlay byte must agree. Within the port, the fused native blends are
byte-identical to extractor + ``MatrixVisualizer``, and the blends to their
numpy chains. The native resample (lerp form, contracted to FMA under
``-march=native``) and the numpy fallback (weight form) round differently,
so those two agree only up to argmax near-ties, in the JAX package's envelope
(tests/test_native.py::test_native_matches_numpy).
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from densepose_tpu import native as jax_native  # noqa: E402
from densepose_tpu import visualizer as jax_vis  # noqa: E402
from densepose_tpu.predictor import DensePosePredictor as JaxPredictor  # noqa: E402
from densepose_tpu_torch import native  # noqa: E402
from densepose_tpu_torch import visualizer as vis  # noqa: E402
from densepose_tpu_torch.predictor import DensePosePredictor  # noqa: E402

torch.set_num_threads(2)

IMG_HW = (240, 320)
HEAT = 56  # heatmap side of the synthetic maps


@pytest.fixture(scope="module", autouse=True)
def both_libs():
    if native.get_lib() is None or jax_native.get_lib() is None:
        pytest.fail("the C compiler builds neither native library")


def boxes_for(rng, n, img_hw=IMG_HW):
    """n XYXY boxes inside the image: fractional, 1 px wide, degenerate
    (int(w) = 0), touching the far edges and the origin, then random."""
    h, w = img_hw
    fixed = np.array([[10.7, 20.3, 110.2, 180.9], [50.0, 5.0, 51.0, 200.0],
                      [200.5, 100.5, 200.9, 140.0], [w - 70.0, h - 90.0, w, h],
                      [0.0, 0.0, 40.0, 40.0]], np.float32)
    xy = rng.rand(max(n - len(fixed), 0), 2) * (w - 60, h - 60)
    wh = rng.rand(len(xy), 2) * 55 + 2
    rand = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return np.concatenate([fixed, rand])[:n]


def raw_maps(rng, n):
    """Port-layout (NCHW) SIUV maps of n instances; U/V a little out of
    [0, 1] to exercise the clip."""
    return {"pred_densepose_coarse_segm": rng.randn(n, 2, HEAT, HEAT).astype(np.float32),
            "pred_densepose_fine_segm": rng.randn(n, 25, HEAT, HEAT).astype(np.float32),
            "pred_densepose_u": (rng.rand(n, 25, HEAT, HEAT) * 1.2 - 0.1).astype(np.float32),
            "pred_densepose_v": (rng.rand(n, 25, HEAT, HEAT) * 1.2 - 0.1).astype(np.float32)}


def pp_maps(rng, n):
    """Device-postprocessed maps as numpy_outputs returns them: labels
    (n, H, W) uint8, UV (n, 2, H, W) float16."""
    return {"pred_densepose_labels": rng.randint(0, 25, (n, HEAT, HEAT)).astype(np.uint8),
            "pred_densepose_uv": rng.rand(n, 2, HEAT, HEAT).astype(np.float16)}


def host_outputs(form, n, seed):
    rng = np.random.RandomState(seed)
    out = {"num_instances": n, "pred_boxes": boxes_for(rng, n),
           "scores": rng.rand(n).astype(np.float32),
           "pred_classes": np.zeros(n, np.int32)}
    out.update(raw_maps(rng, n) if form == "raw" else pp_maps(rng, n))
    return out


def frame(seed):
    return (np.random.RandomState(seed).rand(*IMG_HW, 3) * 255).astype(np.uint8)


# -- native against native, and against the numpy chains ----------------------


def native_case(entry, lib, rng):
    """Run one native entry point of ``lib`` (a package's native module) on
    inputs drawn from ``rng``; return everything it wrote."""
    img = (rng.rand(120, 160, 3) * 255).astype(np.uint8)
    cmap = (rng.rand(256, 3) * 255).astype(np.uint8)
    r = np.arange(256, dtype=np.float64)
    lut = (r[:, None] * 0.3 + r[None, :] * 0.7).astype(np.uint8)
    hwc = {k: rng.randn(HEAT, HEAT, c).astype(np.float32) for k, c in
           (("coarse", 2), ("fine", 25), ("u", 25), ("v", 25))}
    chw = {k: np.ascontiguousarray(v.transpose(2, 0, 1)) for k, v in hwc.items()}
    roi = img[9:96, 13:74]  # a view with the image's row stride
    if entry == "resample_instance":
        return lib.resample_instance_native(hwc["coarse"], hwc["fine"], hwc["u"], hwc["v"], 73, 41)
    if entry == "resample_instance_chw":
        return (lib.resample_instance_native_chw(chw["coarse"], chw["fine"], chw["u"], chw["v"],
                                                 73, 41)
                + lib.resample_instance_native_chw(chw["coarse"], chw["fine"], None, None, 37, 90,
                                                   need_uv=False)[:1])
    if entry == "blend_overlay":
        matrix = rng.randint(0, 25, roi.shape[:2]).astype(np.uint8)
        mask = (rng.rand(*roi.shape[:2]) > 0.4).astype(np.uint8)
        assert lib.blend_overlay_native(roi, matrix, mask, cmap, lut)
    elif entry == "blend_labels_grid":
        grid = rng.randint(0, 25, (HEAT, HEAT)).astype(np.uint8)
        assert lib.blend_labels_grid_native(roi, grid, cmap, lut)
    elif entry == "resample_blend_chw":
        assert lib.resample_blend_chw_native(chw["coarse"], chw["fine"], roi, cmap, lut)
    elif entry == "resample_blend_uv_chw":
        assert lib.resample_blend_uv_chw_native(chw["coarse"], chw["fine"], chw["u"], roi, cmap,
                                                lut)
    return (img,)


ENTRIES = ["resample_instance", "resample_instance_chw", "blend_overlay", "blend_labels_grid",
           "resample_blend_chw", "resample_blend_uv_chw"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_native_entry_matches_jax_native(entry):
    got = native_case(entry, native, np.random.RandomState(3))
    want = native_case(entry, jax_native, np.random.RandomState(3))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_native_source_is_the_jax_source():
    """One C source in two packages, each built into its own library."""
    assert native._SRC.read_bytes() == (
        native._SRC.parents[2] / "densepose_tpu" / "native" / "fastvis.c").read_bytes()
    assert native.library_path().parent == native._SRC.parents[1] / "_build"


def numpy_blend(roi, matrix, mask, cmap, lut):
    """MatrixVisualizer's numpy chain: colormap, background passthrough,
    blend table."""
    v = cmap[matrix]
    bg = mask == 0
    v[bg] = roi[bg]
    roi[:] = lut[roi, v]


def test_native_blends_match_numpy_chain():
    rng = np.random.RandomState(4)
    img = (rng.rand(120, 160, 3) * 255).astype(np.uint8)
    cmap = (rng.rand(256, 3) * 255).astype(np.uint8)
    lut = vis.MatrixVisualizer(alpha=0.7)._blend_lut
    matrix = rng.randint(0, 25, (87, 61)).astype(np.uint8)
    mask = (rng.rand(87, 61) > 0.4).astype(np.uint8)
    a, b = img.copy(), img.copy()
    assert native.blend_overlay_native(a[9:96, 13:74], matrix, mask, cmap, lut)
    numpy_blend(b[9:96, 13:74], matrix, mask, cmap, lut)
    np.testing.assert_array_equal(a, b)
    # the nearest label-grid paste of the extractor, then the same blend
    grid = rng.randint(0, 25, (HEAT, HEAT)).astype(np.uint8)
    a, b = img.copy(), img.copy()
    assert native.blend_labels_grid_native(a[9:96, 13:74], grid, cmap, lut)
    gy = np.minimum((np.arange(87) * HEAT / 87).astype(int), HEAT - 1)
    gx = np.minimum((np.arange(61) * HEAT / 61).astype(int), HEAT - 1)
    labels = grid[gy][:, gx]
    numpy_blend(b[9:96, 13:74], labels, (labels > 0).astype(np.uint8), cmap, lut)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("out_hw", [(200, 150), (37, 81), (56, 56), (13, 7)])
def test_native_resample_matches_numpy_fallback(out_hw):
    rng = np.random.RandomState(5)
    maps = [rng.randn(HEAT, HEAT, c).astype(np.float32) for c in (2, 25)]
    maps += [rng.rand(HEAT, HEAT, 25).astype(np.float32) for _ in range(2)]
    labels_n, uv_n = native.resample_instance_native(*maps, *out_hw)
    labels, uv = vis.resample_fine_and_uv(*maps, (3, 4, out_hw[1], out_hw[0]))
    assert labels.dtype == labels_n.dtype and uv.dtype == uv_n.dtype
    assert (labels_n != labels).mean() < 2e-3
    same = labels_n == labels
    np.testing.assert_allclose(uv_n[:, same], uv[:, same], atol=2e-5)


# -- extractor and overlays against the JAX package ----------------------------


@pytest.mark.parametrize("n", [3, 7])  # 7 > 4: the thread-pooled extractor
@pytest.mark.parametrize("need_uv", [True, False])
@pytest.mark.parametrize("form", ["raw", "device_pp"])
def test_extractor_matches_jax(form, need_uv, n):
    outputs = host_outputs(form, n, seed=10 + n)
    got, got_boxes = vis.DensePoseResultExtractor()(outputs, need_uv=need_uv)
    want, want_boxes = jax_vis.DensePoseResultExtractor()(outputs, need_uv=need_uv)
    np.testing.assert_array_equal(got_boxes, want_boxes)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g["labels"].dtype == w["labels"].dtype
        np.testing.assert_array_equal(g["labels"], w["labels"])
        if need_uv:
            assert g["uv"].dtype == w["uv"].dtype
            np.testing.assert_array_equal(g["uv"], w["uv"])
        else:
            assert g["uv"] is None and w["uv"] is None


@pytest.mark.parametrize("keep_bg", [True, False])
@pytest.mark.parametrize("n", [3, 7])
@pytest.mark.parametrize("form", ["raw", "device_pp"])
@pytest.mark.parametrize("mode", ["fine_segm", "u", "v", "bbox"])
def test_overlay_matches_jax(mode, form, n, keep_bg):
    outputs = host_outputs(form, n, seed=20 + n)
    got = vis.End2EndVisualizer(alpha=0.7, keep_bg=keep_bg, mode=mode).visualize(frame(1),
                                                                                  outputs)
    want = jax_vis.End2EndVisualizer(alpha=0.7, keep_bg=keep_bg, mode=mode).visualize(
        frame(1), outputs)
    assert got.dtype == np.uint8 and got.shape == (*IMG_HW, 3)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, frame(1))


@pytest.mark.parametrize("keep_bg", [True, False])
@pytest.mark.parametrize("mode", ["fine_segm", "u", "v"])
@pytest.mark.parametrize("form", ["raw", "device_pp"])
def test_fused_declines_a_box_past_the_frame(form, mode, keep_bg):
    """Before it touches a pixel, in both packages alike."""
    outputs = host_outputs(form, 3, seed=31)
    outputs["pred_boxes"][1] = [-5.0, 10.0, 50.0, 60.0]
    img = frame(2)
    e2e = vis.End2EndVisualizer(keep_bg=keep_bg, mode=mode)
    assert e2e._visualize_labels_fused(img, outputs) is None
    assert jax_vis.End2EndVisualizer(keep_bg=keep_bg, mode=mode)._visualize_labels_fused(
        img, outputs) is None
    np.testing.assert_array_equal(img, frame(2))


def test_colormap_table_replaces_cv2():
    """A (256, 3) table as ``cmap`` draws what the cv2 colormap id draws,
    also through the numpy fallback and the background fill, without cv2."""
    outputs = host_outputs("raw", 3, seed=40)
    table = vis.colormap_table(cv2.COLORMAP_VIRIDIS)
    want = jax_vis.End2EndVisualizer(keep_bg=False).visualize(frame(3), outputs)
    got = vis.End2EndVisualizer(keep_bg=False, cmap=table).visualize(frame(3), outputs)
    np.testing.assert_array_equal(got, want)
    data = vis.DensePoseResultExtractor()(outputs, need_uv=False)
    mv_port = vis.MatrixVisualizer(cmap=table, val_scale=255 / 24.0)
    mv_jax = jax_vis.MatrixVisualizer(val_scale=255 / 24.0)
    a, b = frame(4), frame(4)
    mv_port.fill(a, 3)
    mv_jax.fill(b, 3)
    np.testing.assert_array_equal(a, b)
    for (res, box) in zip(*data):  # the numpy chain: a float matrix has no native blend
        matrix = res["labels"].astype(np.float32)
        mask = (res["labels"] > 0).astype(np.uint8)
        mv_port.visualize(a, mask, matrix, box)
        mv_jax.visualize(b, mask, matrix, box)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        vis.colormap_table(np.zeros((255, 3), np.uint8))


# -- fused against generic, in the port ------------------------------------------


@pytest.mark.parametrize("keep_bg", [True, False])
@pytest.mark.parametrize("mode,form", [("fine_segm", "device_pp"), ("fine_segm", "raw"),
                                       ("u", "raw"), ("v", "raw")])
def test_fused_matches_generic(mode, form, keep_bg):
    outputs = host_outputs(form, 4, seed=50)  # <= 4: the fused path engages on any host
    e2e = vis.End2EndVisualizer(alpha=0.7, keep_bg=keep_bg, mode=mode)
    fused = e2e._visualize_labels_fused(frame(5), outputs)
    assert fused is not None, "the fused path declined"
    generic = e2e.visualizer.visualize(frame(5), e2e.extractor(outputs,
                                                                need_uv=mode != "fine_segm"))
    np.testing.assert_array_equal(fused, generic)


def test_fetch_keys_match_jax():
    for mode in ("fine_segm", "u", "v", "bbox"):
        assert (vis.End2EndVisualizer(mode=mode).fetch_keys()
                == jax_vis.End2EndVisualizer(mode=mode).fetch_keys())


# -- numpy_outputs against the JAX package's ----------------------------------


def device_outputs(form, d, n, seed, hole=False):
    """The same fixed-slot outputs in each package's layout: (port tensors,
    JAX numpy). The first n of d slots are valid (with ``hole``, all but the
    second), and there is det_packed."""
    rng = np.random.RandomState(seed)
    boxes = (rng.rand(d, 4) * 100).astype(np.float32)
    scores = rng.rand(d).astype(np.float32)
    classes = rng.randint(0, 3, d).astype(np.int32)
    valid = np.arange(d) < n
    valid[1] &= not hole
    packed = np.concatenate([boxes, scores[:, None], classes[:, None], valid[:, None]], 1)
    header = np.float32([[n, 48, 64, 0, 0, 0, 0]])
    base = {"image_size": np.int32([48, 64]), "pred_boxes": boxes, "scores": scores,
            "pred_classes": classes, "valid": valid, "num_instances": np.int32(n),
            "det_packed": np.concatenate([packed, header]).astype(np.float32)}
    port, jax = dict(base), dict(base)
    if form == "raw":
        for k, v in raw_maps(rng, d).items():
            port[k] = v
            jax[k] = np.ascontiguousarray(v.transpose(0, 2, 3, 1))
    else:
        port["pred_densepose_labels"] = jax["pred_densepose_labels"] = \
            rng.randint(0, 25, (d, HEAT, HEAT)).astype(np.uint8)
        port["pred_densepose_uv"] = jax["pred_densepose_uv"] = \
            rng.rand(d, HEAT, HEAT, 2).astype(np.float16)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in port.items()}, jax


@pytest.mark.parametrize("hole", [False, True])
@pytest.mark.parametrize("keys", [None, "fine_segm", "u"])
@pytest.mark.parametrize("form", ["raw", "device_pp"])
def test_numpy_outputs_matches_jax(form, keys, hole):
    """Valid slots as a prefix (the trim is a view) and with a hole."""
    port, jax = device_outputs(form, d=12, n=5, seed=60, hole=hole)
    fetch = None if keys is None else vis.End2EndVisualizer(mode=keys).fetch_keys()
    got = DensePosePredictor.numpy_outputs(port, keys=fetch)
    want = JaxPredictor.numpy_outputs(jax, keys=fetch)
    assert sorted(got) == sorted(want)
    assert got["num_instances"] == want["num_instances"] == 5
    assert len(got["scores"]) == 4 + (not hole)
    for k, w in want.items():
        if k != "num_instances":
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


# -- host utilities ----------------------------------------------------------------


def test_get_local_path_offline(tmp_path, monkeypatch):
    """The JAX package's cache names; offline, an uncached file raises and
    nothing is downloaded."""
    from densepose_tpu.utils import file_io as jax_file_io
    from densepose_tpu_torch.model_zoo import get_checkpoint_url
    from densepose_tpu_torch.utils.file_io import get_local_path
    monkeypatch.setenv("DENSEPOSE_TPU_OFFLINE", "1")
    monkeypatch.setenv("DENSEPOSE_TPU_CACHE", str(tmp_path))
    url = get_checkpoint_url("densepose_rcnn_R_50_FPN_s1x")
    with pytest.raises(IOError, match="not cached") as port_err:
        get_local_path(url)
    with pytest.raises(IOError, match="not cached") as jax_err:
        jax_file_io.get_local_path(url)
    name = lambda e: str(e.value).rsplit("/", 1)[-1]  # noqa: E731
    assert name(port_err) == name(jax_err)
    cached = tmp_path / name(port_err).rstrip("'")
    cached.write_bytes(b"")
    assert get_local_path(url) == str(cached)
    d2 = "detectron2://ImageNetPretrained/MSRA/R-50.pkl"
    with pytest.raises(IOError, match="dl.fbaipublicfiles.com/detectron2/ImageNetPretrained"):
        get_local_path(d2)
    assert get_local_path(str(cached)) == str(cached)
