"""The port's HRNet + HRFPN backbone (``densepose_tpu_torch/models/hrnet.py``)
held against the JAX package's (``densepose_tpu/models/hrnet.py``) on the CPU:
the spec, the weight bridge (the sibling FrozenBN fold and its refusal), the
p1..p5 features, each stage given the JAX stage's inputs, end to end, the pad
to 64 and the geometry quantum it implies, TTA, and one float16 stage.

The model is densepose_rcnn_HRFPN_HRNet_w32_s1x narrowed to toy widths: one
module of one BasicBlock per branch, branches of 8/16/32/64 channels, and an
HRFPN of 32 channels beside tests/test_torch_pipeline.py's FPN width of 16, so
a head sized by FPN.OUT_CHANNELS would not load. Both packages get the same
weights (the JAX predictor's, whose BN ``hrnet_fold_bn`` folded, through
``params_from_jax``) and the same numpy inputs. The JAX stem conv is taken in
its plain form (``DENSEPOSE_TPU_NO_PACKED_STEM``, set for this module before
anything is traced): the packed form sums in another order.

Tolerances (fp32): features, boxes, scores and maps differ by the summation
order of convolutions (XLA's against PyTorch's CPU kernels): 1e-4 absolute
and relative, boxes 1e-3 (test_torch_pipeline.py's). Exact: spec keys and
shapes, the folded weights, preprocess, valid and keep masks, detection
counts and classes. At float16: 4 units in the last place at the output's
magnitude (test_torch_dtype.py's ``half_tol``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from densepose_tpu.checkpoint.transform import torch_state_to_jax
from densepose_tpu.config import get_cfg as jax_get_cfg
from densepose_tpu.models.hrnet import hrfpn_forward, hrnet_fold_bn
from densepose_tpu.models.rcnn import build_model as jax_build_model
from densepose_tpu.models.roi_heads import box_stage_forward as jax_box_stage
from densepose_tpu.models.roi_heads import densepose_stage_forward as jax_dp_stage
from densepose_tpu.models.rpn import rpn_forward as jax_rpn_forward
from densepose_tpu.predictor import DensePosePredictor as JaxPredictor
from densepose_tpu.predictor import load_params as jax_load_params
from densepose_tpu.tta import TTAPredictor as JaxTTA
from densepose_tpu_torch.checkpoint.transform import (fold_state, params_from_jax,
                                                      random_torch_state)
from densepose_tpu_torch.config import get_cfg as port_get_cfg
from densepose_tpu_torch.models.backbones import backbone_out_channels
from densepose_tpu_torch.models.rcnn import build_model, size_divisibility
from densepose_tpu_torch.models.roi_heads import box_stage_forward, densepose_stage_forward
from densepose_tpu_torch.models.rpn import rpn_forward
from densepose_tpu_torch.predictor import DensePosePredictor, load_params
from densepose_tpu_torch.tta import TTAPredictor
from tests.test_torch_dtype import f32, half_tol, to_torch
from tests.test_torch_variants import det_boxes, image, nchw, variant_cfg

torch.set_num_threads(2)

ATOL = RTOL = 1e-4
SEED = 5
HRNET = "densepose_rcnn_HRFPN_HRNet_w32_s1x"
NARROW_HRNET = [
    ("MODEL.HRNET.STAGE2.NUM_CHANNELS", [8, 16]),
    ("MODEL.HRNET.STAGE3.NUM_CHANNELS", [8, 16, 32]),
    ("MODEL.HRNET.STAGE4.NUM_CHANNELS", [8, 16, 32, 64]),
    ("MODEL.HRNET.STAGE2.NUM_MODULES", 1), ("MODEL.HRNET.STAGE3.NUM_MODULES", 1),
    ("MODEL.HRNET.STAGE4.NUM_MODULES", 1),
    ("MODEL.HRNET.STAGE2.NUM_BLOCKS", [1, 1]), ("MODEL.HRNET.STAGE3.NUM_BLOCKS", [1, 1, 1]),
    ("MODEL.HRNET.STAGE4.NUM_BLOCKS", [1, 1, 1, 1]),
    ("MODEL.HRNET.HRFPN.OUT_CHANNELS", 32)]
LEVELS = ["p1", "p2", "p3", "p4", "p5"]


@pytest.fixture(scope="module", autouse=True)
def plain_stem():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DENSEPOSE_TPU_NO_PACKED_STEM", "1")
        yield


def hrnet_cfg(get_cfg, extra=()):
    return variant_cfg(get_cfg, HRNET, NARROW_HRNET + list(extra))


class Pair:
    """Both packages' tiny HRNet predictors on the JAX predictor's weights."""

    def __init__(self, extra=()):
        self.jcfg, self.pcfg = hrnet_cfg(jax_get_cfg, extra), hrnet_cfg(port_get_cfg, extra)
        self.jpred = JaxPredictor(self.jcfg, seed=SEED)
        self.jp = self.jpred.params
        self.port = DensePosePredictor(self.pcfg, device="cpu", params=params_from_jax(
            {k: np.asarray(v) for k, v in self.jp.items()}))
        self.jmodel = jax_build_model(self.jcfg)
        self._hrfpn = jax.jit(lambda p, x: hrfpn_forward(p, x, self.jcfg))

    def features(self, img):
        x, _, hw = self.jmodel.preprocess(jnp.asarray(img), img.shape[:2],
                                          compute_dtype=self.jpred.compute_dtype)
        return x, self._hrfpn(self.jp, x), hw


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def stage_inputs(pair):
    """The JAX features of one 64x64 frame, and its proposals."""
    x, feats, hw = pair.features(image(11))
    props, _, pvalid = jax.jit(lambda p, f: jax_rpn_forward(p, f, hw, pair.jcfg))(pair.jp, feats)
    return x, feats, hw, props, pvalid


def test_spec_matches_jax():
    """The narrowed model: the same keys in the same order, shapes and kinds,
    so one seed draws the same weights in both (the three zoo widths:
    tests/test_torch_variants.py::test_zoo_family_specs_match_jax)."""
    want = jax_build_model(hrnet_cfg(jax_get_cfg)).spec()
    got = build_model(hrnet_cfg(port_get_cfg)).spec()
    assert list(got) == list(want)
    for k in want:
        assert (got[k].shape, got[k].kind) == (want[k].shape, want[k].kind), k


def test_sibling_fold_matches_jax_fold():
    """The port's load folds HRNet's sibling BN (conv1/bn1, Sequential .0/.1)
    into the JAX package's bits: random_torch_state, then the JAX layout and
    hrnet_fold_bn (its f64 host fold), brought back by params_from_jax,
    equals the port's fold_state and load_params of the same seed."""
    jcfg, pcfg = hrnet_cfg(jax_get_cfg), hrnet_cfg(port_get_cfg)
    spec = build_model(pcfg).spec()
    state = random_torch_state(spec, seed=3)
    jparams = torch_state_to_jax(state, jax_build_model(jcfg).spec())
    assert "backbone.bottom_up.bn1.running_mean" in jparams  # unfolded: not a .norm child
    hrnet_fold_bn(jparams)
    want = params_from_jax(jparams)
    for got in (fold_state(state, spec), load_params(pcfg, seed=3)):
        assert sorted(got) == sorted(want)
        assert not any(".bn" in k or k.endswith(".running_var") for k in got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("backbone.bottom_up.conv1.bias", "backbone.bottom_up.layer1.0.downsample.0.bias",
              "backbone.bottom_up.transition1.1.0.0.bias",
              "backbone.bottom_up.stage4.0.fuse_layers.3.0.2.0.bias"):
        assert k in want, k


def test_params_from_jax_refuses_unfolded_sibling_bn():
    """The JAX package's load_params leaves HRNet's BN unfolded (its
    predictor folds it): the bridge refuses such params, as it refuses an
    unfolded .norm."""
    jparams = jax_load_params(hrnet_cfg(jax_get_cfg), seed=SEED)
    with pytest.raises(ValueError, match="bn1.running_mean: unfolded FrozenBN"):
        params_from_jax(jparams)


def test_jax_predictor_params_load(pair):
    """params_from_jax of the JAX predictor's params is the port module's
    state dict, key for key; the heads take HRFPN's width, not FPN's."""
    model = pair.port.model
    want = params_from_jax({k: np.asarray(v) for k, v in pair.jp.items()})
    assert sorted(model.state_dict()) == sorted(want)
    assert backbone_out_channels(pair.pcfg) == 32 != pair.pcfg.MODEL.FPN.OUT_CHANNELS
    assert model.proposal_generator.rpn_head.conv.in_channels == 32
    assert model.roi_heads.box_head.fc1.in_features == 32 * 7 * 7
    assert model.roi_heads.decoder.p1["0"].in_channels == 32


def test_backbone_features(pair, stage_inputs):
    x, want, _, _, _ = stage_inputs
    with torch.no_grad():
        got = pair.port.model.backbone(nchw(x))
    assert list(got) == LEVELS and sorted(want) == LEVELS
    for i, k in enumerate(LEVELS):
        assert got[k].shape[-2:] == (64 // 4 // 2 ** i,) * 2
        np.testing.assert_allclose(got[k][0].permute(1, 2, 0).numpy(), np.asarray(want[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)


def test_rpn_stage(pair, stage_inputs):
    """Anchors on five levels p1..p5 (strides 4..64): valid mask exact."""
    _, feats, hw, props, pvalid = stage_inputs
    wv = np.asarray(pvalid)
    with torch.no_grad():
        gb, gs, gv = rpn_forward(pair.port.model.proposal_generator.rpn_head,
                                 {k: nchw(v) for k, v in feats.items()}, hw, pair.pcfg)
    wb, ws, _ = jax.jit(lambda p, f: jax_rpn_forward(p, f, hw, pair.jcfg))(pair.jp, feats)
    np.testing.assert_array_equal(gv.numpy(), wv)
    assert wv.sum() > 10
    np.testing.assert_allclose(gs.numpy()[wv], np.asarray(ws)[wv], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(gb.numpy()[wv], np.asarray(wb)[wv], atol=1e-3, rtol=RTOL)


def test_box_stage(pair, stage_inputs):
    """The box pooler over five levels (2..6): valid mask and classes exact."""
    _, feats, _, props, pvalid = stage_inputs
    wb, wsc, wc, wv = (np.asarray(a) for a in jax.jit(
        lambda p, f, b, v: jax_box_stage(p, f, b, v, pair.jcfg))(pair.jp, feats, props, pvalid))
    with torch.no_grad():
        gb, gsc, gc, gv = (a.numpy() for a in box_stage_forward(
            pair.port.model.roi_heads, {k: nchw(v) for k, v in feats.items()},
            torch.from_numpy(np.asarray(props)), torch.from_numpy(np.asarray(pvalid)),
            pair.pcfg))
    np.testing.assert_array_equal(gv, wv)
    assert wv.sum() >= 1
    np.testing.assert_array_equal(gc[wv], wc[wv])
    np.testing.assert_allclose(gsc, wsc, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(gb[wv], wb[wv], atol=1e-3, rtol=RTOL)


def test_densepose_stage(pair, stage_inputs):
    """The decoder's five chains (p1 at stride 4 without an upsample, p5
    with four), the pooler on its map, the head and the chart predictor."""
    _, feats, _, _, _ = stage_inputs
    boxes = det_boxes(4, 40)
    want = jax.jit(lambda p, f, b: jax_dp_stage(p, f, b, pair.jcfg))(
        pair.jp, feats, jnp.asarray(boxes))
    with torch.no_grad():
        got = densepose_stage_forward(pair.port.model.roi_heads,
                                      {k: nchw(v) for k, v in feats.items()},
                                      torch.from_numpy(boxes), pair.pcfg)
    assert sorted(got) == sorted(want) == ["coarse_segm", "fine_segm", "u", "v"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.transpose(np.asarray(want[k]), (0, 3, 1, 2)),
                                   atol=ATOL, rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("hw", [(64, 64), (60, 80)])
def test_end_to_end(pair, hw):
    """Through both predictors. A 60x80 frame resizes to 64x85, which pads to
    64x96 at 32 and to 64x128 at HRFPN's 64: the port pads as the JAX
    package does."""
    img = image(21, *hw)
    x, _, (hp, wp) = pair.jmodel.preprocess(jnp.asarray(img), hw)
    got_x, _, got_hw = pair.port.model.preprocess(torch.from_numpy(img))
    assert size_divisibility(pair.pcfg) == 64
    assert got_hw == (hp, wp) == ((64, 64) if hw == (64, 64) else (64, 128))
    np.testing.assert_array_equal(got_x[0].permute(1, 2, 0).numpy(), np.asarray(x))
    want = pair.jpred.predict_numpy(img)
    got = pair.port.predict_numpy(img)
    n = want["num_instances"]
    assert got["num_instances"] == n >= 1
    np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], atol=1e-3, rtol=RTOL)
    for k in ("coarse_segm", "fine_segm", "u", "v"):
        key = f"pred_densepose_{k}"
        assert got[key].shape == want[key].shape == (n,) + got[key].shape[1:]
        np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=RTOL, err_msg=key)


def test_geometry_quantum_of_32_refused(pair):
    """HRFPN pads to 64, so a geometry quantum must be a multiple of 64; the
    JAX predictor asserts the same rule."""
    cfg = hrnet_cfg(port_get_cfg, [("TPU.GEOMETRY_BUCKET_QUANT", 32)])
    with pytest.raises(ValueError, match=r"multiple of the backbone size divisibility \(64\)"):
        DensePosePredictor(cfg, device="cpu", params=pair.port.model.state_dict())
    with pytest.raises(AssertionError, match=r"\(64\)"):
        JaxPredictor(hrnet_cfg(jax_get_cfg, [("TPU.GEOMETRY_BUCKET_QUANT", 32)]),
                     params=pair.jp)
    geo = DensePosePredictor(hrnet_cfg(port_get_cfg, [("TPU.GEOMETRY_BUCKET_QUANT", 64)]),
                             device="cpu", params=pair.port.model.state_dict())
    canvas, sizes = geo.bucketize(image(21, 60, 80))
    assert canvas.shape[:2] == (64, 128)
    assert int(geo(image(21, 60, 80))["num_instances"]) >= 1


def test_tta(pair):
    """TTA (one scale and its flip) of HRNet: each view padded to 64; the
    merged detections and averaged maps as the JAX package's. The merge
    keeps zero-width boxes of the reference's swapped RPN clip, which NMS
    never suppresses: near-tied ones, 1e-3 px apart, may take each other's
    slots (ROADMAP.md queue 3), so each box is held to its nearest box of
    the other package."""
    aug = [("TEST.AUG.ENABLED", True), ("TEST.AUG.MIN_SIZES", (64,)),
           ("TEST.AUG.MAX_SIZE", 96), ("TEST.AUG.FLIP", True), ("TEST.DETECTIONS_PER_IMAGE", 12)]
    jtta = JaxTTA(JaxPredictor(hrnet_cfg(jax_get_cfg, aug), params=pair.jp))
    ptta = TTAPredictor(DensePosePredictor(hrnet_cfg(port_get_cfg, aug), device="cpu",
                                           params=pair.port.model.state_dict()))
    img = image(22, 60, 80)
    want, got = jtta.predict_numpy(img), ptta.predict_numpy(img)
    assert got["num_instances"] == want["num_instances"] >= 1
    np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL, rtol=RTOL)
    gap = np.abs(got["pred_boxes"][:, None] - want["pred_boxes"][None]).max(-1)
    assert gap.min(0).max() <= 1e-3 and gap.min(1).max() <= 1e-3
    for k in ("coarse_segm", "fine_segm", "u", "v"):
        key = f"pred_densepose_{k}"
        np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=RTOL, err_msg=key)


def test_float16_backbone_stage():
    """HRNet + HRFPN at float16 against the JAX package at float16, on the
    same input cast once: p1..p5 within 4 units in the last place."""
    half = Pair([("TPU.COMPUTE_DTYPE", "float16")])
    x, want, _ = half.features(image(12))
    assert np.asarray(x).dtype == np.float16
    with torch.no_grad():
        got = half.port.model.backbone(to_torch(x).permute(2, 0, 1)[None].contiguous())
    for k in LEVELS:
        assert got[k].dtype == torch.float16 and np.asarray(want[k]).dtype == np.float16
        w = f32(want[k])
        assert np.isfinite(w).all()
        np.testing.assert_allclose(f32(got[k][0].permute(1, 2, 0)), w, rtol=0,
                                   atol=half_tol("float16", w), err_msg=k)


def test_float16_pool_window_sums_in_fp32():
    """A known divergence at float16 (ROADMAP.md queue 3): the JAX package's
    HRFPN average pool sums each window in float16, so a window whose sum
    passes 65504 gives inf though its mean fits; the port's pool
    (F.avg_pool2d) sums in fp32. Equal where the sums fit."""
    from densepose_tpu.models.hrnet import _avg_pool
    x = np.full((16, 16, 2), 3000.0, np.float16)
    x[:8, :8, 1] = 1.5  # a window that fits
    want = np.asarray(_avg_pool(jnp.asarray(x), 8))
    got = torch.nn.functional.avg_pool2d(torch.from_numpy(x).permute(2, 0, 1)[None], 8)
    got = got[0].permute(1, 2, 0).numpy()
    assert np.isinf(want[..., 0]).all() and (got[..., 0] == 3000).all()
    assert want[0, 0, 1] == got[0, 0, 1] == np.float16(1.5)
