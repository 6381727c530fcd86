"""Input-geometry bucketing (``TPU.GEOMETRY_BUCKET_QUANT``) and detection-count
bucketing (``TPU.BUCKETED_DENSEPOSE``) of the PyTorch port, held against the
JAX package on the CPU at the tiny flagship of tests/test_torch_pipeline.py
(narrow widths; inputs of 48-200 pixels resized to 64-96), as
tests/test_bucketing.py holds the JAX package.

Both packages get the same weights through ``params_from_jax``; each stage
of the port is given the JAX stage's inputs. Exact: the host and device
canvases, the bucketed preprocess, keep and valid masks, detection counts
and classes. Boxes, scores and maps within test_torch_pipeline.py's fp32
tolerances. The bucketed path against the port's exact path: within the
envelope of tests/test_bucketing.py (count drift <= 3, matched boxes < 8 px,
scores < 0.08), on its tamed detection weights.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from densepose_tpu.checkpoint.transform import random_torch_state, torch_state_to_jax
from densepose_tpu.config import get_cfg as jax_get_cfg
from densepose_tpu.models.fpn import fpn_forward
from densepose_tpu.models.rcnn import build_model as jax_build_model
from densepose_tpu.models.rcnn import compute_resize
from densepose_tpu.models.rpn import rpn_forward as jax_rpn_forward
from densepose_tpu.predictor import DensePosePredictor as JaxPredictor
from densepose_tpu.predictor import load_params as jax_load_params
from densepose_tpu_torch import run
from densepose_tpu_torch.checkpoint.transform import params_from_jax
from densepose_tpu_torch.config import get_cfg as port_get_cfg
from densepose_tpu_torch.models.rpn import RPNHead, rpn_forward
from densepose_tpu_torch.ops.anchors import anchors_for_levels
from densepose_tpu_torch.ops.resize import resize_bilinear_np, resize_image
from densepose_tpu_torch.predictor import DensePosePredictor
from tests.test_realscale_parity import DETECTION_TAME
from tests.test_torch_pipeline import ATOL, RTOL, SEED, TINY_DELTAS, image, nchw, tiny_cfg

torch.set_num_threads(2)

QUANT = 64
# raw sizes whose resized images (64-96 px) fall in three 64-quantized
# buckets, two of them (80x60, 97x61) in one
SIZES = [(60, 80), (80, 60), (97, 61), (64, 64)]
NARROW_OPTS = [s for key, value in TINY_DELTAS for s in (key, str(value))]


def cfg_pair(*opts):
    """The tiny flagship of both packages, with ``opts``."""
    out = []
    for get_cfg in (jax_get_cfg, port_get_cfg):
        cfg = tiny_cfg(get_cfg).clone()
        cfg.defrost()
        cfg.merge_from_list(list(opts))
        cfg.freeze()
        out.append(cfg)
    return out


def tamed_params(jcfg):
    """tests/test_bucketing.py's tamed detection weights at the tiny widths."""
    spec = jax_build_model(jcfg).spec()
    state = random_torch_state(spec, seed=SEED)
    for k in state:
        for prefix, f in DETECTION_TAME.items():
            if k.startswith(prefix + "."):
                state[k] = state[k] * f
    return torch_state_to_jax(state, spec, fold_bn=True)


@pytest.fixture(scope="module")
def jparams():
    return jax_load_params(cfg_pair()[0], seed=SEED)


@pytest.fixture(scope="module")
def geom(jparams):
    """(JAX geometry-bucketed predictor, the port's), same weights."""
    jcfg, pcfg = cfg_pair("TPU.GEOMETRY_BUCKET_QUANT", QUANT)
    return (JaxPredictor(jcfg, params=dict(jparams)),
            DensePosePredictor(pcfg, device="cpu", params=params_from_jax(jparams)))


@pytest.fixture(scope="module")
def jax_fpn(geom):
    """The JAX backbone, jitted once for the module (one compile a shape)."""
    jcfg = geom[0].cfg
    return jax.jit(lambda p, x: fpn_forward(p, x, jcfg))


@pytest.mark.parametrize("fmt", ["BGR", "RGB"])
def test_bucketize_matches_jax(jparams, fmt):
    """The host canvas and sizes bit for bit the JAX package's, and the
    device canvas the host's."""
    jcfg, pcfg = cfg_pair("TPU.GEOMETRY_BUCKET_QUANT", QUANT, "INPUT.FORMAT", fmt)
    jpred = JaxPredictor(jcfg, params=dict(jparams))
    pred = DensePosePredictor(pcfg, device="cpu", params=params_from_jax(jparams))
    shapes = set()
    for i, (h, w) in enumerate(SIZES):
        img = image(50 + i, h, w)
        want, wsizes = jpred.bucketize(img)
        got, sizes = pred.bucketize(img)
        assert got.dtype == np.uint8 and sizes.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(sizes, wsizes)
        canvas, dsizes = pred.model.bucket_canvas(torch.from_numpy(img), QUANT)
        np.testing.assert_array_equal(canvas.numpy(), got)
        assert tuple(dsizes) == tuple(sizes)
        shapes.add(got.shape)
    assert shapes == {(64, 128, 3), (128, 64, 3), (64, 64, 3)}, shapes


@pytest.mark.parametrize("h0,w0,ms,mx", [(97, 133, 64, 128), (97, 133, 200, 400),
                                         (97, 133, 97, 400)])
def test_host_resize_equals_device_resize(h0, w0, ms, mx):
    """resize_bilinear_np is resize_image bit for bit, at downscale, upscale
    and identity."""
    img = image(7, h0, w0)
    k, h1, w1 = compute_resize(h0, w0, ms, mx)
    got = resize_bilinear_np(img, (h1, w1), scale=(k, k))
    want = resize_image(torch.from_numpy(img), (h1, w1), scale=(k, k)).numpy()
    np.testing.assert_array_equal(got, want)


def test_preprocess_bucketed_bitwise(geom):
    """The canvas normalized: bitwise the JAX package's, bitwise the exact
    preprocess inside the minimal-pad extent, zero outside it."""
    jpred, pred = geom
    img = image(3, 97, 61)
    canvas, sizes = pred.bucketize(img)
    h1, w1 = int(sizes[2]), int(sizes[3])
    got = pred.model.preprocess_bucketed(torch.from_numpy(canvas), h1, w1)[0].permute(1, 2, 0)
    want = jpred.model.preprocess_bucketed(jnp.asarray(canvas), h1, w1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    exact, _, (hp, wp) = pred.model.preprocess(torch.from_numpy(img))
    np.testing.assert_array_equal(got[:hp, :wp].numpy(), exact[0].permute(1, 2, 0).numpy())
    assert (hp, wp) != tuple(got.shape[:2])
    assert not got[hp:].any() and not got[:, wp:].any()


@pytest.mark.parametrize("seed", [11, 12])
def test_rpn_anchor_mask_matches_jax(geom, jax_fpn, seed):
    """rpn_forward with anchor_valid_hw on a canvas's features: the valid mask
    exactly the JAX package's, proposals and scores within tolerance; and p5
    and p6, whose levels hold fewer anchors than PRE_NMS_TOPK_TEST, drop masked
    anchors that entered their top-k."""
    jpred, pred = geom
    jcfg, pcfg = jpred.cfg, pred.cfg
    canvas, sizes = pred.bucketize(image(seed, 60, 80))  # 64x85 resized on a 64x128 canvas
    h1, w1 = int(sizes[2]), int(sizes[3])
    x = jpred.model.preprocess_bucketed(jnp.asarray(canvas), h1, w1)
    feats = jax_fpn(jpred.params, x)
    hp, wp = -(-h1 // 32) * 32, -(-w1 // 32) * 32
    assert (hp, wp) == (64, 96) and canvas.shape[:2] == (64, 128)
    hw = (jnp.float32(hp), jnp.float32(wp))
    rpn = jax.jit(lambda p, f: jax_rpn_forward(p, f, hw, jcfg, anchor_valid_hw=hw))
    wb, ws, wv = (np.asarray(a) for a in rpn(jpred.params, feats))
    with torch.no_grad():
        gb, gs, gv = rpn_forward(pred.model.proposal_generator.rpn_head,
                                 {k: nchw(v) for k, v in feats.items()}, (hp, wp), pcfg,
                                 anchor_valid_hw=(hp, wp))
    np.testing.assert_array_equal(gv.numpy(), wv)
    assert wv.sum() > 10
    np.testing.assert_allclose(gs.numpy()[wv], ws[wv], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(gb.numpy()[wv], wb[wv], atol=1e-3, rtol=RTOL)
    # no proposal from an anchor centred in the padding (x beyond 96) survives:
    # the clip is at the minimal-pad extent, so every box stays inside it
    assert float(gb[gv][:, 2].max()) <= max(hp, wp)
    grids = [tuple(f.shape[-3:-1]) for f in feats.values()]
    small = [g for g in grids if g[0] * g[1] * 3 <= pcfg.MODEL.RPN.PRE_NMS_TOPK_TEST]
    assert small, grids


@pytest.mark.parametrize("switched", [True, False])
def test_forward_bucketed_matches_jax(jparams, geom, switched):
    """forward_bucketed against the JAX package's on the same canvases (two
    frame sizes that share one): counts, classes and valid exact; boxes,
    scores and maps within tolerance."""
    if switched:  # the config's default: the module's predictors
        jpred, pred = geom
    else:
        jcfg, pcfg = cfg_pair("TPU.GEOMETRY_BUCKET_QUANT", QUANT,
                              "TPU.SWITCHED_DENSEPOSE", False)
        jpred = JaxPredictor(jcfg, params=dict(jparams))
        pred = DensePosePredictor(pcfg, device="cpu", params=params_from_jax(jparams))
    for i, (h, w) in enumerate(SIZES[1:3]):
        img = image(30 + i, h, w)
        canvas, sizes = pred.bucketize(img)
        want = {k: np.asarray(v) for k, v in jpred(img).items()}  # its forward_bucketed
        with torch.inference_mode():
            got = {k: v.numpy() for k, v in pred.model.forward_bucketed(
                torch.from_numpy(canvas), tuple(int(s) for s in sizes)).items()}
        assert sorted(got) == sorted(want)
        v = want["valid"]
        assert int(got["num_instances"]) == int(want["num_instances"]) >= 1
        for k in ("valid", "image_size", "pred_classes"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got["pred_boxes"][v], want["pred_boxes"][v], atol=1e-3,
                                   rtol=RTOL)
        np.testing.assert_allclose(got["det_packed"][:-1][v], want["det_packed"][:-1][v],
                                   atol=1e-3, rtol=RTOL)
        for k in got:
            if k.startswith("pred_densepose_"):
                w = np.transpose(want[k], (0, 3, 1, 2))
                assert got[k].shape == w.shape, k
                np.testing.assert_allclose(got[k][v], w[v], atol=ATOL, rtol=RTOL, err_msg=k)


def test_predictor_geometry_matches_jax(geom):
    """The geometry-bucketed predictors end to end, numpy outputs, on two
    sizes that share a bucket."""
    jpred, pred = geom
    for i, (h, w) in enumerate(SIZES[1:3]):
        img = image(40 + i, h, w)
        want, got = jpred.predict_numpy(img), pred.predict_numpy(img)
        assert got["num_instances"] == want["num_instances"] >= 1
        np.testing.assert_array_equal(got["image_size"], want["image_size"])
        np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
        np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], atol=1e-3, rtol=RTOL)
        for k in ("coarse_segm", "fine_segm", "u", "v"):
            key = f"pred_densepose_{k}"
            np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=RTOL, err_msg=key)


def test_bucketed_envelope_against_exact_path():
    """The port's bucketed predictor against its exact one, within
    tests/test_bucketing.py's envelope, on the tamed detection weights."""
    jcfg, _ = cfg_pair()
    params = params_from_jax(tamed_params(jcfg))
    _, exact_cfg = cfg_pair("MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.3)
    _, buck_cfg = cfg_pair("MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.3,
                           "TPU.GEOMETRY_BUCKET_QUANT", QUANT)
    exact = DensePosePredictor(exact_cfg, device="cpu", params=params)
    buck = DensePosePredictor(buck_cfg, device="cpu", params=params)
    worst = dict(count=0, box=0.0, score=0.0)
    for i, (h, w) in enumerate(SIZES):
        img = image(60 + i, h, w)
        a, b = exact.predict_numpy(img), buck.predict_numpy(img)
        na, nb = a["num_instances"], b["num_instances"]
        worst["count"] = max(worst["count"], abs(na - nb))
        k = min(na, nb, 8)
        assert k >= 1, (na, nb)
        d = np.array([np.abs(b["pred_boxes"] - a["pred_boxes"][j]).max(1) for j in range(k)])
        nearest = d.argmin(1)
        matched = [j for j in range(k) if d[j, nearest[j]] < 8.0]
        assert len(matched) >= max(1, k // 2), (len(matched), k, (h, w))
        worst["box"] = max(worst["box"], max(float(d[j, nearest[j]]) for j in matched))
        worst["score"] = max(worst["score"], max(
            float(abs(a["scores"][j] - b["scores"][nearest[j]])) for j in matched))
    print(f"geometry-bucket envelope (port, tiny flagship): count drift {worst['count']}, "
          f"matched boxes {worst['box']:.3f} px, scores {worst['score']:.4f}")
    assert worst["count"] <= 3
    assert worst["box"] < 8.0
    assert worst["score"] < 0.08


@pytest.mark.parametrize("opts,match", [
    (("TPU.GEOMETRY_BUCKET_QUANT", 48), "multiple"),
    (("TPU.GEOMETRY_BUCKET_QUANT", 64, "TPU.BUCKETED_DENSEPOSE", True), "exclusive"),
])
def test_validation_errors(jparams, opts, match):
    """Where the JAX package asserts, the port raises ValueError."""
    jcfg, pcfg = cfg_pair(*opts)
    with pytest.raises(AssertionError):
        JaxPredictor(jcfg, params=dict(jparams))
    with pytest.raises(ValueError, match=match):
        DensePosePredictor(pcfg, device="cpu", params=params_from_jax(jparams))


@pytest.fixture(scope="module")
def two_stage(jparams):
    """(JAX BUCKETED_DENSEPOSE predictor, the port's), same weights."""
    jcfg, pcfg = cfg_pair("TPU.BUCKETED_DENSEPOSE", True)
    return (JaxPredictor(jcfg, params=dict(jparams)),
            DensePosePredictor(pcfg, device="cpu", params=params_from_jax(jparams)))


@pytest.mark.parametrize("num_valid,bucket", [(0, 8), (5, 8), (12, 16), (20, 32), (33, 40),
                                              (40, 40)])
def test_bucketed_densepose_stage2_matches_jax(two_stage, jax_fpn, num_valid, bucket):
    """Stage 2 on the bucket covering a forced count: the bucket's rows, equal
    to the JAX package's forward_densepose on the same boxes."""
    jpred, pred = two_stage
    assert pred.buckets == [8, 16, 32, 40] == jpred.buckets
    assert pred.stage2_bucket(num_valid) == bucket
    img = image(13)
    x, _, _ = jpred.model.preprocess(jnp.asarray(img), img.shape[:2])
    feats = jax_fpn(jpred.params, x)
    rng = np.random.RandomState(num_valid)
    xy = rng.rand(40, 2).astype(np.float32) * 70
    boxes = np.concatenate([xy, xy + rng.rand(40, 2).astype(np.float32) * 40 + 2], 1)
    want = jax.jit(jpred.model.forward_densepose)(jpred.params, feats,
                                                  jnp.asarray(boxes[:bucket]))
    with torch.inference_mode():
        got = pred.densepose_stage2({k: nchw(v) for k, v in feats.items()},
                                    torch.from_numpy(boxes), num_valid)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        w = np.transpose(np.asarray(want[k]), (0, 3, 1, 2))
        assert v.shape == w.shape and v.shape[0] == bucket, k
        np.testing.assert_allclose(v.numpy(), w, atol=ATOL, rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("thr,seeds,buckets", [(0.3, (21,), (40,)),
                                               (0.51425, (16, 21), (8, 16))])
def test_bucketed_densepose_predictor_matches_jax(jparams, thr, seeds, buckets):
    """The two-stage predictors end to end: the maps keep the bucket's rows,
    as the JAX package's do; the numpy outputs agree. At 0.51425 frame 16
    keeps 6 detections and frame 21 keeps 13; at 0.3 every slot is kept."""
    jcfg, pcfg = cfg_pair("TPU.BUCKETED_DENSEPOSE", True,
                          "MODEL.ROI_HEADS.SCORE_THRESH_TEST", thr)
    jpred = JaxPredictor(jcfg, params=dict(jparams))
    pred = DensePosePredictor(pcfg, device="cpu", params=params_from_jax(jparams))
    for seed, bucket in zip(seeds, buckets):
        check_two_stage(jpred, pred, image(seed, 64, 64), bucket)


def check_two_stage(jpred, pred, img, bucket):
    want, got = jpred(img), pred(img)
    n = int(want["num_instances"])
    assert int(got["num_instances"]) == n
    rows = {np.asarray(v).shape[0] for k, v in want.items() if k.startswith("pred_densepose_")}
    assert rows == {got[k].shape[0] for k in got if k.startswith("pred_densepose_")}
    assert rows == {pred.stage2_bucket(n)} == {bucket}
    want, got = jpred.numpy_outputs(want), pred.numpy_outputs(got)
    np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], atol=1e-3, rtol=RTOL)
    for k in ("coarse_segm", "fine_segm", "u", "v"):
        key = f"pred_densepose_{k}"
        assert got[key].shape[0] == n
        np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("mode", ["geometry", "two_stage"])
def test_predict_batch_takes_the_per_shape_path(jparams, geom, two_stage, mode):
    """predict_batch bypasses both bucketing modes, as the JAX package's
    does: every frame on the per-shape path, D-slot maps, equal to the
    requests of an unbucketed predictor with TPU.SWITCHED_DENSEPOSE off (the
    JAX ``predict_batch`` vmaps ``forward`` with the switched stage off,
    predictor.py:612-616), and on the valid rows to its switched requests.
    With oneDNN off the CPU's convolutions compute each frame and row alone,
    so a batch of two equals the single frames bit for bit."""
    pred = geom[1] if mode == "geometry" else two_stage[1]
    _, plain_cfg = cfg_pair()
    _, mono_cfg = cfg_pair("TPU.SWITCHED_DENSEPOSE", False)
    params = params_from_jax(jparams)
    plain = DensePosePredictor(plain_cfg, device="cpu", params=params)
    mono = DensePosePredictor(mono_cfg, device="cpu", params=params)
    frames = np.stack([image(s, 60, 80) for s in (71, 72)])
    d = pred.cfg.TEST.DETECTIONS_PER_IMAGE
    with torch.backends.mkldnn.flags(enabled=False):
        batch = pred.predict_batch(frames)
        for i, f in enumerate(frames):
            want, switched = mono(f), plain(f)
            assert sorted(batch) == sorted(want) == sorted(switched)
            for k, v in want.items():
                assert torch.equal(batch[k][i], v), k
            n = int(switched["num_instances"])
            for k, v in switched.items():  # detections exact, the valid rows' maps
                if k.startswith("pred_densepose_"):
                    np.testing.assert_allclose(batch[k][i][:n].numpy(), v[:n].numpy(),
                                               atol=ATOL, rtol=RTOL, err_msg=k)
                else:
                    assert torch.equal(batch[k][i], v), k
            assert batch["pred_densepose_u"].shape[1] == d


def test_anchor_cache_alternating_geometries(jparams):
    """RPNHead.anchors keyed by geometry: alternating geometries give the
    anchors of a fresh computation, and the cache stays bounded."""
    _, pcfg = cfg_pair()
    head = RPNHead(pcfg)
    strides = [4, 8, 16, 32, 64]
    g = pcfg.MODEL.ANCHOR_GENERATOR
    geoms = [[(h // s, w // s) for s in strides] for h, w in ((64, 96), (96, 64), (128, 128))]
    for grid in geoms * 2:
        got = head.anchors(grid, strides, pcfg, torch.device("cpu"))
        want = anchors_for_levels(grid, strides, g.SIZES, g.ASPECT_RATIOS, g.OFFSET)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)
    assert len(head._anchors) == 3
    assert head.anchors(geoms[0], strides, pcfg, torch.device("cpu")) is head.anchors(
        geoms[0], strides, pcfg, torch.device("cpu"))
    for n in range(RPNHead.ANCHOR_CACHE + 5):
        head.anchors([(n + 1, n + 1)] * len(strides), strides, pcfg, torch.device("cpu"))
    assert len(head._anchors) == RPNHead.ANCHOR_CACHE


def test_cli_auto_buckets_mixed_size_dir(tmp_path, capsys, monkeypatch):
    """The CLI's directory probe and auto-bucketing, as
    tests/test_bucketing.py::test_run_cli_auto_buckets_mixed_size_dir holds
    the JAX CLI: a mixed-size directory turns on quantum 64 with the JAX
    note, an explicit --opts or --no-bucket wins, a TTA config keeps its own
    geometry; the directory runs and writes every overlay."""
    cv2 = pytest.importorskip("cv2")
    monkeypatch.setenv("DENSEPOSE_TPU_OFFLINE", "1")
    flagship = "densepose_rcnn_R_50_FPN_s1x"
    mixed = tmp_path / "imgs"
    mixed.mkdir()
    for i, (h, w) in enumerate(SIZES[:3]):
        cv2.imwrite(str(mixed / f"im{i}.png"), image(80 + i, h, w))
    same = tmp_path / "same"
    same.mkdir()
    for i in range(2):
        cv2.imwrite(str(same / f"s{i}.png"), image(90 + i, 60, 80))
    assert len(run.scan_dir_sizes(str(mixed))) > 1
    assert len(run.scan_dir_sizes(str(same))) == 1

    pred = run.load_predictor(flagship, "", NARROW_OPTS, "cpu", auto_bucket=True)
    assert pred.geometry_quant == QUANT
    assert "enabling input-geometry bucketing (TPU.GEOMETRY_BUCKET_QUANT 64)" in \
        capsys.readouterr().err
    off = run.load_predictor(flagship, "", NARROW_OPTS + ["TPU.GEOMETRY_BUCKET_QUANT", "0"],
                             "cpu", auto_bucket=True)
    assert off.geometry_quant == 0
    tta = run.load_predictor(flagship, "", NARROW_OPTS + ["TEST.AUG.ENABLED", "True"], "cpu",
                             auto_bucket=True)
    assert tta.base.geometry_quant == 0
    two = run.load_predictor(flagship, "", NARROW_OPTS + ["TPU.BUCKETED_DENSEPOSE", "True"],
                             "cpu", auto_bucket=True)
    assert two.geometry_quant == 0 and two.bucketed
    capsys.readouterr()

    run.main([flagship, str(mixed), "--cpu", "--vis", "bbox", "--opts", *NARROW_OPTS])
    assert capsys.readouterr().err.count("enabling input-geometry bucketing") == 1
    for i in range(3):
        assert (mixed / f"im{i}_pred.png").exists()
    for args in ([str(mixed), "--no-bucket"], [str(same)]):
        run.main([flagship, *args, "--cpu", "--vis", "bbox", "--opts", *NARROW_OPTS])
        assert "geometry bucketing" not in capsys.readouterr().err
