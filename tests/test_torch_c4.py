"""The C4 detector (``build_resnet_backbone`` + ``Res5ROIHeads``) and the
per-class route of kernel K1's class-aware NMS, held against the JAX package
on the CPU.

Both packages get the same weights (the JAX package's ``load_params`` and the
port's ``params_from_jax`` of it) and the same numpy inputs; JAX runs on the
CPU, the port on its plain kernels (K1, K2 and Q1's plain versions).

Configs: ``tests/test_res5.py``'s C4 detector (get_cfg()'s R50-C4 at full
width, 4 classes, 64..128 px, 100 / 40 proposals, D = 5); the same narrowed
(stem 8, res2 16, 4 per group) for the trunk, the res5 stage, int8 and the
sharded paths; and R18-C4 (BasicBlock widths are fixed at 64..512, so only
the frames are small).

Tolerances (fp32): boxes and scores within tests/test_torch_pipeline.py's
ATOL = RTOL = 1e-4 (summation orders of XLA's and PyTorch's CPU
convolutions), features within RTOL and ATOL times the map's largest
magnitude (R18's random-weight maps reach ~500); NMS keep masks, classes, validity and row
counts exact. int8 within tests/test_torch_int8.py's QUANT_RTOL.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from densepose_tpu.config import get_cfg as jax_get_cfg
from densepose_tpu.models.backbones import _plain_resnet_forward
from densepose_tpu.models import resnet as jresnet
from densepose_tpu.models.rcnn import build_model as jax_build_model
from densepose_tpu.models.res5_roi_heads import res5_forward as jax_res5_forward
from densepose_tpu.ops import max_pool2d as jax_max_pool2d
from densepose_tpu.ops.nms import batched_nms_mask as jax_batched_nms_mask
from densepose_tpu.parallel.mesh import make_mesh_2d
from densepose_tpu.parallel.mesh import spatial_parallel_forward as jax_spatial_forward
from densepose_tpu.predictor import DensePosePredictor as JaxPredictor
from densepose_tpu.predictor import load_params as jax_load_params
from densepose_tpu_torch.checkpoint.transform import params_from_jax
from densepose_tpu_torch.config import get_cfg as port_get_cfg
from densepose_tpu_torch.models.rcnn import build_model
from densepose_tpu_torch.models.res5_roi_heads import res5_forward
from densepose_tpu_torch.ops import conv_int8, nms
from densepose_tpu_torch.parallel import spatial_parallel_forward
from densepose_tpu_torch.predictor import DensePosePredictor
from tests.test_torch_int8 import near
from tests.torch_cases import (BASIC_BLOCK, C4_DETECTION, C4_TINY, R50_NARROW,
                               per_class_nms_case, set_cfg)

torch.set_num_threads(2)

ATOL = RTOL = 1e-4
SEED = 0
RES5_TEST, NARROW = C4_TINY, R50_NARROW  # tests/test_res5.py's C4 detector; toy widths
R18 = [("MODEL.RESNETS.DEPTH", 18)] + BASIC_BLOCK
CASES = {"r50": RES5_TEST, "r50_narrow": RES5_TEST + NARROW, "r18": RES5_TEST + R18}


def c4_cfg(get_cfg, extra=()):
    cfg = set_cfg(get_cfg(), C4_DETECTION + list(extra))
    cfg.freeze()
    return cfg


def image(seed, h=48, w=64):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def nchw(a):
    a = np.asarray(a)
    return torch.from_numpy(np.array(a if a.ndim == 4 else a[None])).permute(0, 3, 1, 2)


class Pair:
    """Both packages' C4 models on the JAX package's seed-0 weights."""

    def __init__(self, extra):
        self.jcfg, self.pcfg = c4_cfg(jax_get_cfg, extra), c4_cfg(port_get_cfg, extra)
        self.jparams = jax_load_params(self.jcfg, seed=SEED)
        self.jp = {k: jnp.asarray(v) for k, v in self.jparams.items()}
        self.jmodel = jax_build_model(self.jcfg)
        self.port = DensePosePredictor(self.pcfg, device="cpu",
                                       params=params_from_jax(self.jparams))
        self._forward = jax.jit(self.jmodel.forward)

    def jax_forward(self, img):
        return {k: np.asarray(v) for k, v in self._forward(self.jp, jnp.asarray(img)).items()}

    def jax_input(self, img):
        x, _, hw = self.jmodel.preprocess(jnp.asarray(img), img.shape[:2])
        return x, hw


_PAIRS = {}


def pair(name):
    if name not in _PAIRS:
        _PAIRS[name] = Pair(CASES[name])
    return _PAIRS[name]


def detections_hold(got, want):
    """Port outputs (tensors) against a JAX forward's (numpy): the row count,
    validity, count and classes exact; boxes and scores within ATOL / RTOL on
    the valid rows."""
    valid = want["valid"]
    assert got["pred_boxes"].shape == want["pred_boxes"].shape
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    assert int(got["num_instances"]) == int(want["num_instances"]) >= 1
    np.testing.assert_array_equal(got["pred_classes"].numpy()[valid], want["pred_classes"][valid])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["pred_boxes"].numpy()[valid], want["pred_boxes"][valid],
                               atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# the per-class K1 route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,c,thr", [(60, 7, 0.5), (200, 3, 0.7), (40, 80, 0.5)])
def test_per_class_route_matches_batched_nms(r, c, thr):
    """``per_class_nms_mask`` (C problems of R boxes) keeps exactly what the
    JAX package's ``batched_nms_mask`` keeps of the R * C flattened pairs
    with a class each, on tied scores and invalid pairs; and its K1 problems
    are C of R boxes, never one of R * C."""
    boxes, scores, valid = per_class_nms_case(r + c, r, c)
    want = jax_batched_nms_mask(jnp.asarray(boxes.reshape(-1, 4)), jnp.asarray(scores.ravel()),
                                jnp.tile(jnp.arange(c, dtype=jnp.int32), r),
                                jnp.asarray(valid.ravel()), thr)
    shapes = []
    plain = nms.nms_keep_plain

    def spy(b, v, t, classes=None):
        shapes.append((tuple(b.shape), classes is None))
        return plain(b, v, t, classes)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nms, "nms_keep_plain", spy)
        got = nms.per_class_nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                                     torch.from_numpy(valid), thr)
    assert shapes == [((c, r, 4), True)]
    assert got.shape == (r, c)
    np.testing.assert_array_equal(got.reshape(-1).numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < int(valid.sum())  # something is suppressed, something kept


def test_box_stage_takes_the_per_class_route(monkeypatch):
    """The FPN box stage of 2 frames at 80 classes sends K1 one problem a
    frame and class (160 of R boxes), where it sent one of R * 80 a frame
    with a class row, and its detections equal that classed route's."""
    from tests.test_torch_pipeline import TINY_DELTAS
    from densepose_tpu_torch.model_zoo import _base_fpn
    from densepose_tpu_torch.models import roi_heads

    cfg = port_get_cfg()
    _base_fpn(cfg)
    set_cfg(cfg, TINY_DELTAS + [("MODEL.ROI_HEADS.NUM_CLASSES", 80),
                                ("MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.005)])
    cfg.freeze()
    rng = np.random.RandomState(3)
    r, c = 60, 80
    logits = torch.from_numpy(rng.randn(2 * r, c + 1).astype(np.float32) * 2)
    deltas = torch.from_numpy(rng.randn(2 * r, 4 * c).astype(np.float32) * 0.2)
    xy = rng.rand(2, r, 2) * 60
    props = torch.from_numpy(np.concatenate([xy, xy + rng.rand(2, r, 2) * 30 + 4], -1)
                             .astype(np.float32))
    pvalid = torch.from_numpy(rng.rand(2, r) > 0.1)
    problems = []
    plain = nms.nms_keep_plain

    def spy(b, v, t, classes=None):
        problems.append((tuple(b.shape), classes is None))
        return plain(b, v, t, classes)

    def classed(b, s, v, t):  # the route before: R * C boxes a frame, with a class row
        cls = torch.arange(c, dtype=torch.int32).repeat(r).expand(2, -1)
        return nms.batched_nms_mask(b.reshape(2, -1, 4), s.reshape(2, -1), cls,
                                    v.reshape(2, -1), t).reshape(v.shape)

    monkeypatch.setattr(nms, "nms_keep_plain", spy)
    got = roi_heads.box_stage_decisions(logits, deltas, props, pvalid, cfg)
    monkeypatch.setattr(roi_heads, "per_class_nms_mask", classed)
    want = roi_heads.box_stage_decisions(logits, deltas, props, pvalid, cfg)
    assert problems == [((2 * c, r, 4), True), ((2, r * c, 4), False)]
    assert int(got[3].sum()) > 10
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# specs, the trunk, the res5 stage, end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["r50", "r18"])
def test_spec_keys_and_order(name):
    """The C4 spec: the backbone's four stages (its res5 unused), the RPN,
    then ``roi_heads.res5`` and the box predictor, key for key and shape for
    shape in the JAX order; no FPN."""
    jcfg, pcfg = c4_cfg(jax_get_cfg, CASES[name]), c4_cfg(port_get_cfg, CASES[name])
    want = jax_build_model(jcfg).spec()
    got = build_model(pcfg).spec()
    assert list(got) == list(want)
    assert all(tuple(got[k].shape) == tuple(want[k].shape) for k in want)
    assert "backbone.res5.0.conv1.weight" in got and "roi_heads.res5.2.conv3.weight" in got
    assert not any("fpn" in k or "bottom_up" in k for k in got)


@pytest.mark.parametrize("name", ["r50_narrow", "r18"])
def test_c4_trunk_matches_jax(name):
    """The plain ResNet to res4 (stride 16) against JAX
    ``_plain_resnet_forward`` on the same input."""
    p = pair(name)
    x, _ = p.jax_input(image(11, 64, 96))
    want = jax.jit(lambda prm, x: _plain_resnet_forward(prm, x, p.jcfg))(p.jp, x)
    with torch.no_grad():
        got = p.port.model.backbone(nchw(x))
    assert sorted(got) == sorted(want) == ["res4"]
    w = np.asarray(want["res4"])
    g = got["res4"][0].permute(1, 2, 0).numpy()
    assert g.shape == w.shape and g.shape[:2] == (4, 6)
    np.testing.assert_allclose(g, w, atol=ATOL * max(1.0, float(np.abs(w).max())), rtol=RTOL)


@pytest.mark.parametrize("classes,topk,d", [(4, 40, 5), (4, 20, 100), (1, 30, 10)],
                         ids=["rows_D", "rows_RC_below_D", "one_class"])
def test_res5_stage_matches_jax(classes, topk, d):
    """``res5_forward`` given JAX's res4 features and proposals against JAX
    ``res5_forward``: boxes and scores within ATOL / RTOL; classes, validity
    and the row count exact, min(D, R * C) rows with no padding to D."""
    extra = RES5_TEST + NARROW + [("MODEL.ROI_HEADS.NUM_CLASSES", classes),
                                  ("MODEL.RPN.POST_NMS_TOPK_TEST", topk),
                                  ("TEST.DETECTIONS_PER_IMAGE", d),
                                  ("MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.2)]
    p = Pair(extra)
    x, _ = p.jax_input(image(12, 64, 96))
    feats = jax.jit(lambda prm, x: _plain_resnet_forward(prm, x, p.jcfg))(p.jp, x)
    rng = np.random.RandomState(classes + topk)
    xy = rng.rand(topk, 2) * 70
    props = np.concatenate([xy, xy + rng.rand(topk, 2) * 40 + 4], 1).astype(np.float32)
    pvalid = rng.rand(topk) > 0.2
    want = [np.asarray(a) for a in jax.jit(lambda prm, f, b, v: jax_res5_forward(
        prm, f, b, v, p.jcfg))(p.jp, feats, jnp.asarray(props), jnp.asarray(pvalid))]
    with torch.no_grad():
        got = [t.numpy() for t in res5_forward(
            p.port.model.roi_heads, {"res4": nchw(feats["res4"])}, torch.from_numpy(props),
            torch.from_numpy(pvalid), p.pcfg)]
    rows = min(d, topk * classes)
    assert [a.shape[0] for a in got] == [a.shape[0] for a in want] == [rows] * 4
    valid = want[3]
    assert valid.sum() >= 1
    np.testing.assert_array_equal(got[3], valid)
    np.testing.assert_array_equal(got[2][valid], want[2][valid])
    np.testing.assert_allclose(got[1], want[1], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[0][valid], want[0][valid], atol=ATOL, rtol=RTOL)
    assert (got[1][~valid] == 0).all()


@pytest.mark.parametrize("name", ["r50", "r18"])
def test_end_to_end_matches_jax(name):
    """The whole C4 request against ``jax.jit(model.forward)``: test_res5's
    R50-C4 at full width, and R18-C4."""
    p = pair(name)
    for seed, hw in [(0, (48, 64)), (3, (64, 48))]:
        img = image(seed, *hw)
        got = p.port(img)
        want = p.jax_forward(img)
        assert got["pred_boxes"].shape == (5, 4) and "det_packed" in got
        assert not any(k.startswith("pred_densepose_") for k in got)
        detections_hold(got, want)


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_pair(tmp_path_factory):
    """The narrowed C4 under INT8_BACKBONE (+ INT8_RPN, a no-op off the
    ResNet-FPN): JAX calibrated on two frames, the port loading its sidecar."""
    extra = RES5_TEST + NARROW + [("TPU.INT8_BACKBONE", True), ("TPU.INT8_RPN", True)]
    jcfg, pcfg = c4_cfg(jax_get_cfg, extra), c4_cfg(port_get_cfg, extra)
    jpred = JaxPredictor(jcfg, seed=SEED)
    fp_params = {k: np.asarray(v) for k, v in jpred.params.items()}
    jpred.calibrate_int8([image(21), image(22)])
    sidecar = str(tmp_path_factory.mktemp("c4calib") / "c4.calib.json")
    jpred.save_calibration(sidecar)
    port = DensePosePredictor(pcfg, device="cpu", params=params_from_jax(fp_params))
    port.load_calibration(sidecar)
    return jcfg, pcfg, jpred, port, fp_params, sidecar


def test_int8_sites_and_state_match_jax(int8_pair):
    """INT8_BACKBONE on C4 installs the s8 chain under ``backbone``: the site
    list is JAX's (over all four stages, the unused res5's too), the installed
    state equals JAX's calibrated params bit for bit, and the RPN conv is not
    quantized."""
    jcfg, pcfg, jpred, port, _, _ = int8_pair
    assert port._int8_needed and jpred._int8_needed
    sites = jresnet.resnet_int8_scale_sites(jcfg, "backbone")
    assert any(s.startswith("backbone.res5.") for s in sites)
    assert port._group_sites("backbone", len(sites)) == jpred._group_sites("backbone",
                                                                           len(sites))
    assert port._required_scale_keys() == jpred._required_scale_keys(jpred.params) == sites
    want = params_from_jax({k: np.asarray(v) for k, v in jpred.params.items()
                            if conv_int8.is_int8_key(k)})
    got = {k: v.numpy() for k, v in port.int8_state().items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not any(k.startswith("proposal_generator") for k in got)
    assert port.model.backbone.int8_active()


def test_int8_stages_and_request_match_jax(int8_pair):
    """res2..res4 as the s8 chain on the JAX stem's output within QUANT_RTOL
    of JAX ``_resnet_int8_stages`` (three stages, prefix ``backbone``), and
    the whole request's scores within QUANT_RTOL, counts exact."""
    jcfg, pcfg, jpred, port, _, _ = int8_pair
    img = image(23, 64, 96)
    model = jax_build_model(jcfg)
    x, _, _ = model.preprocess(jnp.asarray(img), img.shape[:2])
    jp = jpred.params
    stem = jax.jit(lambda p, x: jax_max_pool2d(jax.nn.relu(jresnet.stem_conv_norm(
        p, "backbone.stem.conv1", x)), kernel_size=3, stride=2, padding=1))(jp, x)
    want = jax.jit(lambda p, s: jresnet._resnet_int8_stages(p, s, jcfg, "backbone",
                                                            ("res4",)))(jp, stem)
    calls = []
    plain = conv_int8.conv_s8_plain
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(conv_int8, "conv_s8_plain", lambda *a, **k: calls.append(1) or plain(*a, **k))
        got = port.model.backbone._int8_stages(nchw(stem))
    assert sorted(got) == sorted(want) == ["res4"]
    assert len(calls) == 3 * (3 + 4 + 6) + 3  # 3 convs a block, 3 shortcuts
    near(got["res4"].permute(0, 2, 3, 1).numpy(), np.asarray(want["res4"])[None], "res4")
    g, w = port(img), jpred(img)
    assert int(g["num_instances"]) == int(w["num_instances"]) >= 1
    near(g["scores"].numpy(), np.asarray(w["scores"]), "scores")


def test_int8_sidecar_cross_loads(int8_pair, tmp_path):
    """A sidecar from either package loads into the other: the port's state
    from JAX's file equals JAX's params (above); JAX's params from the port's
    file equal the port's state."""
    jcfg, pcfg, _, port, fp_params, _ = int8_pair
    mine = DensePosePredictor(pcfg, device="cpu", params=params_from_jax(fp_params))
    mine.calibrate_int8([image(24)])
    path = str(tmp_path / "port.calib.json")
    mine.save_calibration(path)
    assert set(json.load(open(path))["scales"]) == set(
        jresnet.resnet_int8_scale_sites(jcfg, "backbone"))
    jpred = JaxPredictor(jcfg, params=dict(fp_params))
    jpred.load_calibration(path)
    theirs = params_from_jax({k: np.asarray(v) for k, v in jpred.params.items()
                              if conv_int8.is_int8_key(k)})
    state = {k: v.numpy() for k, v in mine.int8_state().items()}
    assert set(state) == set(theirs)
    for k in state:
        np.testing.assert_array_equal(state[k], theirs[k], err_msg=k)


def test_int8_rpn_alone_is_a_no_op():
    """INT8_RPN on C4 enables nothing (JAX predictor.py:124-125 takes only the
    ResNet-FPN): no calibration, the output bit-identical to fp."""
    extra = RES5_TEST + NARROW
    fp = DensePosePredictor(c4_cfg(port_get_cfg, extra), device="cpu", seed=SEED)
    rpn = DensePosePredictor(c4_cfg(port_get_cfg, extra + [("TPU.INT8_RPN", True)]),
                             device="cpu", seed=SEED)
    jpred = JaxPredictor(c4_cfg(jax_get_cfg, extra + [("TPU.INT8_RPN", True)]), seed=SEED)
    assert not rpn._int8_needed and not jpred._int8_needed
    img = image(25)
    a, b = fp(img), rpn(img)
    assert not rpn._int8_ready and not rpn.int8_state()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="no TPU.INT8"):
        rpn.calibrate_int8([img])


# ---------------------------------------------------------------------------
# batched and sharded frames
# ---------------------------------------------------------------------------

def test_predict_batch_matches_jax():
    """``predict_batch`` of 3 frames (K2 with a frame index per region,
    one K1 launch over 3 x 4 class problems) against JAX ``predict_batch``
    (its vmap route)."""
    p = pair("r50_narrow")
    jpred = JaxPredictor(p.jcfg, params=dict(p.jparams))
    batch = np.stack([image(s) for s in (30, 31, 32)])
    want = {k: np.asarray(v) for k, v in jpred.predict_batch(batch).items()}
    got = p.port.predict_batch(batch)
    for i in range(3):
        detections_hold({k: v[i] for k, v in got.items()}, {k: v[i] for k, v in want.items()})


@pytest.mark.parametrize("extra,shards", [(RES5_TEST + NARROW, (8,)), (RES5_TEST + R18, (2, 3))],
                         ids=["r50_narrow", "r18"])
def test_spatial_matches_jax(extra, shards):
    """``spatial_parallel_forward`` of the C4 detector (the plain trunk as
    row slabs, the Bottleneck or BasicBlock stages) against JAX
    ``spatial_parallel_forward`` on the 8 virtual CPU devices and
    ``jax.jit(forward)``."""
    p = Pair(extra)
    frame = image(2, 128, 192) if shards == (8,) else image(2, 192, 96)
    spatial = {k: np.asarray(v) for k, v in jax_spatial_forward(
        p.jmodel, make_mesh_2d(1, 8))(p.jp, jnp.asarray(frame)).items()}
    single = p.jax_forward(frame)
    for n in shards:
        got = spatial_parallel_forward(p.port.model, ["cpu"] * n)(frame)
        for want in (spatial, single):
            detections_hold(got, want)


# ---------------------------------------------------------------------------
# refusals, the CLI and the export bundle
# ---------------------------------------------------------------------------

def test_densepose_on_refused_as_jax_fails():
    """C4 with DENSEPOSE_ON (the get_cfg() default): the JAX spec has no
    DensePose heads under Res5ROIHeads and its forward fails with a KeyError;
    the port refuses the config with a ValueError naming the cause."""
    extra = RES5_TEST + NARROW + [("MODEL.DENSEPOSE_ON", True)]
    jcfg = c4_cfg(jax_get_cfg, extra)
    jp = {k: jnp.asarray(v) for k, v in jax_load_params(jcfg, seed=SEED).items()}
    with pytest.raises(KeyError, match="roi_heads.decoder"):
        jax.jit(jax_build_model(jcfg).forward)(jp, jnp.asarray(image(0)))
    with pytest.raises(ValueError, match="Res5ROIHeads has no DensePose heads"):
        DensePosePredictor(c4_cfg(port_get_cfg, extra), device="cpu")


def test_cli_on_a_c4_yaml(tmp_path, monkeypatch):
    """``python -m densepose_tpu_torch.run`` on a C4 YAML draws the boxes
    (``--vis bbox``, as the JAX CLI draws them); a chart overlay, which the
    JAX CLI fails on inside its visualizer (KeyError), is refused first."""
    import cv2
    import yaml
    from densepose_tpu_torch import run

    monkeypatch.setenv("DENSEPOSE_TPU_OFFLINE", "1")
    cfg_path = tmp_path / "c4.yaml"
    cfg_path.write_text(yaml.safe_dump(json.loads(json.dumps(
        c4_cfg(port_get_cfg, RES5_TEST + NARROW).dump_dict()))))
    img_path = tmp_path / "in.jpg"
    cv2.imwrite(str(img_path), image(4))
    with pytest.raises(ValueError, match="DENSEPOSE_ON False"):
        run.main([str(cfg_path), str(img_path), "--cpu"])
    assert not (tmp_path / "in_pred.jpg").exists()
    run.main([str(cfg_path), str(img_path), "--cpu", "--vis", "bbox"])
    out = cv2.imread(str(tmp_path / "in_pred.jpg"))
    assert out is not None and out.shape == (48, 64, 3)


def test_export_bundle_cross_loads(tmp_path, monkeypatch):
    """A C4 bundle written by each package's export CLI (the JAX one with its
    ``--aot`` program) loads into the other package's CLI loader with the
    same parameters, and its requests agree; the port's ``--aot`` program
    equals its eager request."""
    import sys

    import export as jax_export
    import run as jax_run
    import yaml
    from densepose_tpu_torch import export, run

    monkeypatch.setenv("DENSEPOSE_TPU_OFFLINE", "1")
    cfg_path = tmp_path / "c4.yaml"
    cfg_path.write_text(yaml.safe_dump(json.loads(json.dumps(
        c4_cfg(port_get_cfg, RES5_TEST + NARROW).dump_dict()))))
    common = ["--min_score", "0.05", "--aot", "48x64"]
    for pkg, main, flags in (("jax", jax_export.main, common),
                             ("port", export.main, common + ["--cpu"])):
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        monkeypatch.setattr(sys, "argv", ["prog", str(cfg_path)] + flags)
        main()
    jb, pb = (str(tmp_path / pkg / "exported" / "c4_fp32.npz") for pkg in ("jax", "port"))
    assert (tmp_path / "jax" / "exported" / "c4_fp32_48x64.stablehlo").exists()
    jpred = jax_run.load_predictor(pb, "", False, [])
    pred = run.load_predictor(jb, "", [], device="cpu")
    want = params_from_jax({k: np.asarray(v) for k, v in jpred.params.items()})
    got = pred.model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], torch.from_numpy(v)), k
    img = image(5)
    g, w = pred.predict_numpy(img), jpred.predict_numpy(img)
    assert g["num_instances"] == w["num_instances"] >= 1
    np.testing.assert_array_equal(g["pred_classes"], w["pred_classes"])
    np.testing.assert_allclose(g["pred_boxes"], w["pred_boxes"], atol=ATOL, rtol=RTOL)
    program = DensePosePredictor.aot_load(open(str(tmp_path / "port" / "exported" /
                                                   "c4_fp32_48x64.pt2"), "rb").read())
    eager = run.load_predictor(pb, "", [], device="cpu")(img)
    aot = program(img)
    for k in ("pred_boxes", "scores", "pred_classes", "valid", "num_instances"):
        assert torch.equal(aot[k], eager[k]), k
