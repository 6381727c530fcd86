"""The PyTorch port's DensePose variants held against the JAX package's CPU
routing at tiny geometry: the legacy multi-level DensePose pooler (with and
without ``DENSEPOSE_TPU_SPARSE_POOLER``), the R101 backbone, the DeepLab head
with GroupNorm, the WC confidence heads under ``TPU.EMIT_CONFIDENCES``, the
device postprocess, and the specs and weight bridge of the six configs with
published checkpoints.

As in tests/test_torch_pipeline.py, both packages get the same weights and
inputs, and each port stage is fed the JAX stage's inputs. The JAX package
ignores the sparse-pooler variable on the CPU, so with it set the port's
K3 plain version is held against the JAX gather. Tolerances (fp32): 1e-4
absolute and relative for features and maps (summation order of convs,
matmuls and GroupNorm statistics), 1e-3 for boxes; exact for detection
counts, classes, labels, spec keys and weights.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from densepose_tpu import model_zoo as jax_zoo
from densepose_tpu.checkpoint.transform import torch_state_to_jax
from densepose_tpu.config import get_cfg as jax_get_cfg
from densepose_tpu.models.fpn import fpn_forward
from densepose_tpu.models.rcnn import GeneralizedRCNN as JaxRCNN
from densepose_tpu.models.rcnn import build_model as jax_build_model
from densepose_tpu.models.roi_heads import densepose_stage_forward as jax_dp_stage
from densepose_tpu.predictor import DensePosePredictor as JaxPredictor
from densepose_tpu.predictor import load_params as jax_load_params
from densepose_tpu_torch import model_zoo
from densepose_tpu_torch.checkpoint.transform import (fold_state, params_from_jax,
                                                      random_torch_state)
from densepose_tpu_torch.config import get_cfg as port_get_cfg
from densepose_tpu_torch.models.rcnn import build_model, device_postprocess
from densepose_tpu_torch.models.roi_heads import densepose_stage_forward
from densepose_tpu_torch.ops import roi_align_sparse
from densepose_tpu_torch.predictor import DensePosePredictor, load_params
from tests.test_torch_pipeline import TINY_DELTAS

torch.set_num_threads(2)

ATOL = RTOL = 1e-4
SEED = 5
PUBLISHED = [f"densepose_rcnn_R_{d}_FPN{v}" for d in (50, 101)
             for v in ("_s1x", "_DL_s1x", "_s1x_legacy")]
# GroupNorm takes 32 groups, so the DeepLab head needs widths of 32 or more
DL_WIDTHS = [("MODEL.ROI_DENSEPOSE_HEAD.DECODER_NUM_CLASSES", 32),
             ("MODEL.ROI_DENSEPOSE_HEAD.CONV_HEAD_DIM", 32)]


def _set(cfg, pairs):
    for key, value in pairs:
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value


def variant_cfg(get_cfg, name, extra=()):
    """Zoo config ``name`` narrowed to the flagship tests' toy widths (the
    legacy pooler at 8x8 instead of 14x14), from either package's get_cfg."""
    from densepose_tpu_torch.model_zoo import _ZOO, _base_fpn
    cfg = get_cfg()
    _base_fpn(cfg)
    deltas = _ZOO[name]
    _set(cfg, zip(deltas[0::2], deltas[1::2]))
    _set(cfg, TINY_DELTAS)
    if "_DL" in name:
        _set(cfg, DL_WIDTHS)
    _set(cfg, extra)
    cfg.freeze()
    return cfg


def build_pair(name, extra=(), seed=SEED):
    jcfg, pcfg = variant_cfg(jax_get_cfg, name, extra), variant_cfg(port_get_cfg, name, extra)
    jparams = jax_load_params(jcfg, seed=seed)
    port = DensePosePredictor(pcfg, device="cpu", params=params_from_jax(jparams))
    jp = {k: jnp.asarray(v) for k, v in jparams.items()}
    return jcfg, pcfg, jax_build_model(jcfg), jp, jparams, port


@pytest.fixture(scope="module")
def legacy():
    return build_pair("densepose_rcnn_R_50_FPN_s1x_legacy")


def image(seed, h=64, w=64):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def nchw(hwc):
    return torch.from_numpy(np.array(hwc)).permute(2, 0, 1)[None].contiguous()


def jax_features(jmodel, jp, jcfg, img):
    x, _, _ = jmodel.preprocess(jnp.asarray(img), img.shape[:2])
    return jax.jit(lambda p, x: fpn_forward(p, x, jcfg))(jp, x), x


def det_boxes(seed, n=40):
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2).astype(np.float32) * 70
    return np.concatenate([xy, xy + rng.rand(n, 2).astype(np.float32) * 40 + 2], 1)


def stage_pair(pair, img_seed, box_seed, n_boxes=40):
    """The DensePose stage on the same features and boxes: (port maps NCHW,
    JAX maps transposed to NCHW)."""
    jcfg, pcfg, jmodel, jp, _, port = pair
    feats, _ = jax_features(jmodel, jp, jcfg, image(img_seed))
    boxes = det_boxes(box_seed, n_boxes)
    want = jax.jit(lambda p, f, b: jax_dp_stage(p, f, b, jcfg))(jp, feats, jnp.asarray(boxes))
    with torch.no_grad():
        got = densepose_stage_forward(port.model.roi_heads,
                                      {k: nchw(v) for k, v in feats.items()},
                                      torch.from_numpy(boxes), pcfg)
    return got, {k: np.transpose(np.asarray(v), (0, 3, 1, 2)) for k, v in want.items()}


def count_sparse_plain(monkeypatch):
    calls = []
    inner = roi_align_sparse.roi_align_sparse_plain

    def spy(*args):
        calls.append(args[1].shape[0])
        return inner(*args)

    monkeypatch.setattr(roi_align_sparse, "roi_align_sparse_plain", spy)
    return calls


@pytest.mark.parametrize("sparse", [False, True])
def test_legacy_densepose_stage(legacy, sparse, monkeypatch):
    """No decoder: 15 coarse channels, multi-level pooling over p2-p5."""
    calls = count_sparse_plain(monkeypatch)
    if sparse:
        monkeypatch.setenv("DENSEPOSE_TPU_SPARSE_POOLER", "1")
    got, want = stage_pair(legacy, 13, 3)
    assert calls == ([40] if sparse else [])
    assert sorted(got) == sorted(want) == ["coarse_segm", "fine_segm", "u", "v"]
    assert got["coarse_segm"].shape == (40, 15, 32, 32)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=ATOL, rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("sparse", [False, True])
def test_legacy_end_to_end(legacy, sparse, monkeypatch):
    """The tiny legacy predictor: the box pooler and the DensePose pooler both
    take K3's plain version with the variable set."""
    jcfg, pcfg, jmodel, jp, jparams, port = legacy
    calls = count_sparse_plain(monkeypatch)
    if sparse:
        monkeypatch.setenv("DENSEPOSE_TPU_SPARSE_POOLER", "1")
    jpred = JaxPredictor(jcfg, params=jparams)
    img = image(21)
    want = jpred.predict_numpy(img)
    got = port.predict_numpy(img)
    n = want["num_instances"]
    assert got["num_instances"] == n >= 1
    # the box pooler on every proposal slot, then the DensePose bucket
    assert len(calls) == (2 if sparse else 0)
    np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], atol=1e-3, rtol=RTOL)
    for k in ("coarse_segm", "fine_segm", "u", "v"):
        key = f"pred_densepose_{k}"
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=RTOL, err_msg=key)


def test_r101_backbone_features():
    jcfg, pcfg, jmodel, jp, _, port = build_pair("densepose_rcnn_R_101_FPN_s1x_legacy")
    assert len(port.model.backbone.bottom_up.res4) == 23
    want, x = jax_features(jmodel, jp, jcfg, image(11))
    with torch.no_grad():
        got = port.model.backbone(nchw(x))
    assert sorted(got) == sorted(want) == ["p2", "p3", "p4", "p5", "p6"]
    for k in want:
        np.testing.assert_allclose(got[k][0].permute(1, 2, 0).numpy(), np.asarray(want[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)


def test_deeplab_densepose_stage():
    """Decoder, then ASPP and the GN convs. At the 8x8 pooler, the rate-6
    branch is a dilated conv and the rate-12 and rate-56 branches take the
    center-tap rule, in both packages."""
    pair = build_pair("densepose_rcnn_R_50_FPN_DL_s1x")
    head = pair[-1].model.roi_heads.densepose_head
    assert [k for k in head.state_dict() if "ASPP" in k][:3] == [
        "ASPP.convs.0.0.weight", "ASPP.convs.0.1.weight", "ASPP.convs.0.1.bias"]
    assert "body_conv_fcn1.norm.weight" in head.state_dict()
    got, want = stage_pair(pair, 14, 4)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=ATOL, rtol=RTOL, err_msg=k)


def test_wc2m_emits_confidences():
    extra = [("TPU.EMIT_CONFIDENCES", True)]
    pair = build_pair("densepose_rcnn_R_50_FPN_WC2M_s1x", extra)
    got, want = stage_pair(pair, 15, 5)
    assert sorted(got) == sorted(want) == sorted(
        ["coarse_segm", "fine_segm", "u", "v", "sigma_2", "kappa_u", "kappa_v",
         "fine_segm_confidence", "coarse_segm_confidence"])
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=ATOL, rtol=RTOL, err_msg=k)
    # without the option the stage emits the four SIUV maps only
    port = DensePosePredictor(variant_cfg(port_get_cfg, "densepose_rcnn_R_50_FPN_WC2M_s1x"),
                              device="cpu", params=params_from_jax(pair[4]))
    assert [k for k, _ in port.model.roi_heads.densepose_predictor.outputs] == [
        "coarse_segm", "fine_segm", "u", "v"]


def test_device_postprocess_matches_jax():
    """Identical maps in, labels exact and UV exact after the fp16 cast; the
    extra maps pass through."""
    rng = np.random.RandomState(6)
    d, h, w = 5, 12, 12
    maps = {"pred_densepose_coarse_segm": rng.randn(d, h, w, 2),
            "pred_densepose_fine_segm": rng.randn(d, h, w, 25),
            "pred_densepose_u": rng.rand(d, h, w, 25),
            "pred_densepose_v": rng.rand(d, h, w, 25),
            "pred_densepose_sigma_2": rng.rand(d, h, w, 25)}
    maps = {k: v.astype(np.float32) for k, v in maps.items()}
    maps["pred_densepose_coarse_segm"][-1] = 0.0  # a zero-padded slot: all background
    want = {k: np.asarray(v) for k, v in
            JaxRCNN.device_postprocess({k: jnp.asarray(v) for k, v in maps.items()}).items()}
    got = device_postprocess({k: torch.from_numpy(v).permute(0, 3, 1, 2).contiguous()
                              for k, v in maps.items()})
    assert sorted(got) == sorted(want)
    assert got["pred_densepose_labels"].dtype == torch.uint8
    assert got["pred_densepose_uv"].dtype == torch.float16
    np.testing.assert_array_equal(got["pred_densepose_labels"].numpy(),
                                  want["pred_densepose_labels"])
    np.testing.assert_array_equal(got["pred_densepose_uv"].numpy(), want["pred_densepose_uv"])
    assert 0 < (want["pred_densepose_labels"] > 0).mean() < 1
    assert not want["pred_densepose_labels"][-1].any()
    np.testing.assert_array_equal(got["pred_densepose_sigma_2"].permute(0, 2, 3, 1).numpy(),
                                  want["pred_densepose_sigma_2"])


def test_device_postprocess_predictor():
    """TPU.DEVICE_POSTPROCESS on the tiny DL predictor: labels and UV in
    place of the SIUV maps, equal to the postprocess of the raw maps."""
    name = "densepose_rcnn_R_50_FPN_DL_s1x"
    params = load_params(variant_cfg(port_get_cfg, name), seed=SEED)
    raw = DensePosePredictor(variant_cfg(port_get_cfg, name), device="cpu", params=params)
    post = DensePosePredictor(variant_cfg(port_get_cfg, name,
                                          [("TPU.DEVICE_POSTPROCESS", True)]),
                              device="cpu", params=params)
    img = image(22)
    got = post.predict_numpy(img)
    n = got["num_instances"]
    assert n >= 1
    assert got["pred_densepose_labels"].shape == (n, 32, 32)
    assert got["pred_densepose_labels"].dtype == np.uint8
    assert got["pred_densepose_uv"].shape == (n, 2, 32, 32)
    assert got["pred_densepose_uv"].dtype == np.float16
    assert not any(k in got for k in ("pred_densepose_u", "pred_densepose_fine_segm"))
    out = raw(img)
    maps = {k: v for k, v in out.items() if k.startswith("pred_densepose_")}
    rest = {k: v for k, v in out.items() if k not in maps}
    want = DensePosePredictor.numpy_outputs({**rest, **device_postprocess(maps)})
    for k in ("pred_densepose_labels", "pred_densepose_uv"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", PUBLISHED)
def test_published_specs_match_jax(name):
    """Full width: the same keys in the same order, shapes and kinds."""
    want = jax_build_model(jax_zoo.get_config(name)).spec()
    got = build_model(model_zoo.get_config(name)).spec()
    assert list(got) == list(want)
    for k in want:
        assert (got[k].shape, got[k].kind) == (want[k].shape, want[k].kind), k


@pytest.mark.parametrize("name", PUBLISHED)
def test_published_weights_round_trip(name):
    """Tiny widths: the random stream, the FrozenBN fold and the JAX layouts
    undone (GroupNorm params included) give the port's module state dict."""
    jcfg, pcfg = variant_cfg(jax_get_cfg, name), variant_cfg(port_get_cfg, name)
    spec = build_model(pcfg).spec()
    state = random_torch_state(spec, seed=3)
    back = params_from_jax(torch_state_to_jax(state, jax_build_model(jcfg).spec()))
    want = fold_state(state, spec)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    got = load_params(pcfg, seed=3)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = build_model(pcfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in got.items()})
    if "_DL" in name:
        assert any(k.endswith(".norm.weight") for k in got)


# the other two families of the zoo, full width, specs only
ZOO_FAMILIES = ([f"densepose_rcnn_HRFPN_HRNet_w{w}_s1x" for w in (32, 40, 48)]
                + [f"densepose_rcnn_R_{d}_FPN{dl}{soft}_s1x_cse" for d in (50, 101)
                   for dl in ("", "_DL") for soft in ("", "_soft")])


@pytest.mark.parametrize("name", ZOO_FAMILIES)
def test_zoo_family_specs_match_jax(name):
    """The HRNet and CSE zoo configs at full width: the same keys in the same
    order, shapes and kinds as the JAX package's, and the port's module holds
    exactly the folded spec's keys and shapes."""
    want = jax_build_model(jax_zoo.get_config(name)).spec()
    model = build_model(model_zoo.get_config(name))
    got = model.spec()
    assert list(got) == list(want)
    for k in want:
        assert (got[k].shape, got[k].kind) == (want[k].shape, want[k].kind), k
    state = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    folded = fold_state({}, got)
    assert state == {k: v.shape for k, v in folded.items()}


# ROADMAP.md queue 3's paths that no port test held against the JAX package
UNTESTED_PATHS = {
    "two_classes": [("MODEL.ROI_HEADS.NUM_CLASSES", 2)],
    "roi_align_v2": [("MODEL.ROI_BOX_HEAD.POOLER_TYPE", "ROIAlignV2"),
                     ("MODEL.ROI_DENSEPOSE_HEAD.POOLER_TYPE", "ROIAlignV2")],
    "rgb_input": [("INPUT.FORMAT", "RGB")],
    "ratio_0": [("MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO", 0),
                ("MODEL.ROI_DENSEPOSE_HEAD.POOLER_SAMPLING_RATIO", 0)],
    "unswitched_densepose": [("TPU.SWITCHED_DENSEPOSE", False)],
}


@pytest.mark.parametrize("path", list(UNTESTED_PATHS))
def test_untested_paths_match_jax(path):
    """Each on the tiny flagship, end to end on one frame: counts and classes
    exact, boxes, scores and SIUV maps within the fp32 tolerances. At ratio 0
    stage by stage instead (the box stage given the JAX features and
    proposals, the DensePose stage given its boxes): end to end, zero-width
    detections from the reference's swapped RPN clip, which NMS never
    suppresses, can trade slots when their scores are near-tied."""
    from densepose_tpu.models.roi_heads import box_stage_forward as jax_box_stage
    from densepose_tpu.models.rpn import rpn_forward as jax_rpn_forward
    from densepose_tpu_torch.models.roi_heads import box_stage_forward
    # two classes: weights from seed 2, which detect both (seed 5's only class 0)
    jcfg, pcfg, jmodel, jp, jparams, port = build_pair(
        "densepose_rcnn_R_50_FPN_s1x", UNTESTED_PATHS[path], 2 if path == "two_classes" else SEED)
    if path == "ratio_0":
        feats, _ = jax_features(jmodel, jp, jcfg, image(21))
        props, _, pvalid = jax.jit(lambda p, f: jax_rpn_forward(p, f, (64, 64), jcfg))(jp, feats)
        want = [np.asarray(a) for a in jax.jit(
            lambda p, f, b, v: jax_box_stage(p, f, b, v, jcfg))(jp, feats, props, pvalid)]
        with torch.no_grad():
            got = [a.numpy() for a in box_stage_forward(
                port.model.roi_heads, {k: nchw(v) for k, v in feats.items()},
                torch.from_numpy(np.asarray(props)), torch.from_numpy(np.asarray(pvalid)), pcfg)]
        np.testing.assert_array_equal(got[3], want[3])
        assert want[3].sum() >= 1
        np.testing.assert_array_equal(got[2][want[3]], want[2][want[3]])
        np.testing.assert_allclose(got[1], want[1], atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got[0][want[3]], want[0][want[3]], atol=1e-3, rtol=RTOL)
        got_dp, want_dp = stage_pair((jcfg, pcfg, jmodel, jp, jparams, port), 21, 4)
        for k in want_dp:
            np.testing.assert_allclose(got_dp[k].numpy(), want_dp[k], atol=ATOL, rtol=RTOL,
                                       err_msg=k)
        return
    img = image(21)
    want = JaxPredictor(jcfg, params=jparams).predict_numpy(img)
    got = port.predict_numpy(img)
    n = want["num_instances"]
    assert got["num_instances"] == n >= 1
    if path == "two_classes":
        assert set(want["pred_classes"]) == {0, 1}
    np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], atol=1e-3, rtol=RTOL)
    for k in ("coarse_segm", "fine_segm", "u", "v"):
        key = f"pred_densepose_{k}"
        np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=RTOL, err_msg=key)
