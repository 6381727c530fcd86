"""The PyTorch port's flagship pipeline held against the JAX package, stage by
stage and end to end, at a tiny R50-FPN-s1x geometry on the CPU.

Both packages get the same weights (the JAX package's ``load_params`` and
the port's ``params_from_jax`` of it) and the same numpy inputs. Each stage
of the port is fed the JAX stage's inputs, so a near-threshold NMS flip in
one stage cannot spread into the next (as in
test_full_parity.py::test_densepose_stage_same_box_parity).

Tolerances (fp32): features, boxes and SIUV maps differ only by the
summation order of convolutions and matmuls (XLA's against PyTorch's CPU
kernels), ~1e-6 relative per layer; 1e-4 absolute / 1e-4 relative covers the
tiny net's depth. Exact: preprocess, keep/valid masks, detection counts and
classes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from densepose_tpu.config import get_cfg as jax_get_cfg
from densepose_tpu.models.fpn import fpn_forward
from densepose_tpu.models.rcnn import build_model as jax_build_model
from densepose_tpu.models.roi_heads import box_stage_forward as jax_box_stage
from densepose_tpu.models.rpn import rpn_forward as jax_rpn_forward
from densepose_tpu.predictor import DensePosePredictor as JaxPredictor
from densepose_tpu.predictor import load_params as jax_load_params
from densepose_tpu_torch.checkpoint.transform import params_from_jax
from densepose_tpu_torch.config import get_cfg as port_get_cfg
from densepose_tpu_torch.models.roi_heads import box_stage_forward
from densepose_tpu_torch.models.rpn import rpn_forward
from densepose_tpu_torch.predictor import DensePosePredictor

torch.set_num_threads(2)

ATOL = RTOL = 1e-4

TINY_DELTAS = [
    ("MODEL.RESNETS.STEM_OUT_CHANNELS", 8), ("MODEL.RESNETS.RES2_OUT_CHANNELS", 16),
    ("MODEL.RESNETS.WIDTH_PER_GROUP", 4), ("MODEL.FPN.OUT_CHANNELS", 16),
    ("MODEL.ANCHOR_GENERATOR.SIZES", [[16], [32], [64], [128], [256]]),
    ("MODEL.RPN.PRE_NMS_TOPK_TEST", 80), ("MODEL.RPN.POST_NMS_TOPK_TEST", 60),
    ("MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.3), ("MODEL.ROI_BOX_HEAD.FC_DIM", 32),
    ("MODEL.ROI_DENSEPOSE_HEAD.POOLER_RESOLUTION", 8),
    ("MODEL.ROI_DENSEPOSE_HEAD.NUM_STACKED_CONVS", 2),
    ("MODEL.ROI_DENSEPOSE_HEAD.CONV_HEAD_DIM", 16),
    ("MODEL.ROI_DENSEPOSE_HEAD.DECODER_NUM_CLASSES", 16),
    ("MODEL.ROI_DENSEPOSE_HEAD.DECODER_CONV_DIMS", 16),
    ("INPUT.MIN_SIZE_TEST", 64), ("INPUT.MAX_SIZE_TEST", 96),
    ("TEST.DETECTIONS_PER_IMAGE", 40),
]


def tiny_cfg(get_cfg):
    """The flagship (densepose_rcnn_R_50_FPN_s1x) narrowed to toy widths,
    built from either package's get_cfg. D = 40 detection slots, so the
    switched DensePose stage has the buckets 8, 32 and 40."""
    from densepose_tpu_torch.model_zoo import _base_fpn
    cfg = get_cfg()
    _base_fpn(cfg)
    for key, value in TINY_DELTAS:
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value
    cfg.freeze()
    return cfg


SEED = 5


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = tiny_cfg(jax_get_cfg), tiny_cfg(port_get_cfg)
    jparams = jax_load_params(jcfg, seed=SEED)
    port = DensePosePredictor(pcfg, device="cpu", params=params_from_jax(jparams))
    jmodel = jax_build_model(jcfg)
    jp = {k: jnp.asarray(v) for k, v in jparams.items()}
    return jcfg, pcfg, jmodel, jp, port


def image(seed, h=60, w=80):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def nchw(hwc):
    return torch.from_numpy(np.array(hwc)).permute(2, 0, 1)[None].contiguous()


def jax_features(jmodel, jp, jcfg, img):
    x, _, (hp, wp) = jmodel.preprocess(jnp.asarray(img), img.shape[:2])
    return jax.jit(lambda p, x: fpn_forward(p, x, jcfg))(jp, x), (hp, wp)


def test_preprocess_bit_exact(setup):
    jcfg, pcfg, jmodel, jp, port = setup
    for seed, (h, w) in [(1, (60, 80)), (2, (97, 61)), (3, (480, 640))]:
        img = image(seed, h, w)
        want, w_hw1, w_hwp = jmodel.preprocess(jnp.asarray(img), (h, w))
        got, g_hw1, g_hwp = port.model.preprocess(torch.from_numpy(img))
        assert (g_hw1, g_hwp) == (w_hw1, w_hwp)
        np.testing.assert_array_equal(got[0].permute(1, 2, 0).numpy(), np.asarray(want))


def test_backbone_features(setup):
    jcfg, pcfg, jmodel, jp, port = setup
    img = image(11)
    want, _ = jax_features(jmodel, jp, jcfg, img)
    x, _, _ = jmodel.preprocess(jnp.asarray(img), img.shape[:2])
    with torch.no_grad():
        got = port.model.backbone(nchw(x))
    assert sorted(got) == sorted(want) == ["p2", "p3", "p4", "p5", "p6"]
    for k in want:
        np.testing.assert_allclose(got[k][0].permute(1, 2, 0).numpy(), np.asarray(want[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("seed", [11, 12])
def test_rpn_stage(setup, seed):
    jcfg, pcfg, jmodel, jp, port = setup
    feats, hw = jax_features(jmodel, jp, jcfg, image(seed, 64, 64))
    wb, ws, wv = (np.asarray(a) for a in jax_rpn_forward(jp, feats, hw, jcfg))
    with torch.no_grad():
        gb, gs, gv = rpn_forward(port.model.proposal_generator.rpn_head,
                                 {k: nchw(v) for k, v in feats.items()}, hw, pcfg)
    np.testing.assert_array_equal(gv.numpy(), wv)
    assert wv.sum() > 10
    np.testing.assert_allclose(gs.numpy()[wv], ws[wv], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(gb.numpy()[wv], wb[wv], atol=1e-3, rtol=RTOL)


@pytest.mark.parametrize("seed", [11, 12])
def test_box_stage(setup, seed):
    jcfg, pcfg, jmodel, jp, port = setup
    feats, hw = jax_features(jmodel, jp, jcfg, image(seed, 64, 64))
    props, _, pvalid = jax_rpn_forward(jp, feats, hw, jcfg)
    want = [np.asarray(a) for a in jax.jit(
        lambda p, f, b, v: jax_box_stage(p, f, b, v, jcfg))(jp, feats, props, pvalid)]
    with torch.no_grad():
        got = [a.numpy() for a in box_stage_forward(
            port.model.roi_heads, {k: nchw(v) for k, v in feats.items()},
            torch.from_numpy(np.asarray(props)), torch.from_numpy(np.asarray(pvalid)),
            pcfg)]
    wb, wsc, wc, wv = want
    gb, gsc, gc, gv = got
    np.testing.assert_array_equal(gv, wv)
    assert wv.sum() >= 1
    np.testing.assert_array_equal(gc[wv], wc[wv])
    np.testing.assert_allclose(gsc, wsc, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(gb[wv], wb[wv], atol=1e-3, rtol=RTOL)


@pytest.mark.parametrize("num_valid,bucket", [(3, 8), (20, 32), (40, 40)])
def test_densepose_stage_buckets(setup, num_valid, bucket):
    """The switched DensePose stage on each detection-count bucket: outputs
    zero-padded past the bucket, equal to the JAX lax.switch branch."""
    jcfg, pcfg, jmodel, jp, port = setup
    feats, _ = jax_features(jmodel, jp, jcfg, image(13))
    rng = np.random.RandomState(num_valid)
    xy = rng.rand(40, 2).astype(np.float32) * 70
    boxes = np.concatenate([xy, xy + rng.rand(40, 2).astype(np.float32) * 40 + 2], 1)
    want = jax.jit(lambda p, f, b, n: jmodel.forward_densepose_switched(p, f, b, n))(
        jp, feats, jnp.asarray(boxes), jnp.asarray(num_valid, jnp.int32))
    with torch.no_grad():
        got = port.model.forward_densepose_switched(
            {k: nchw(v) for k, v in feats.items()}, torch.from_numpy(boxes), num_valid)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        w = np.transpose(np.asarray(want[k]), (0, 3, 1, 2))
        assert v.shape == w.shape == (40, w.shape[1], 32, 32)
        assert not v[bucket:].any()
        np.testing.assert_allclose(v.numpy(), w, atol=ATOL, rtol=RTOL, err_msg=k)


def test_end_to_end_predict_numpy(setup):
    """The tiny flagship predictor, port against JAX: detections exact on the
    valid prefix, SIUV maps within the fp32 tolerance."""
    jcfg, pcfg, jmodel, jp, port = setup
    jpred = JaxPredictor(jcfg, params=jax_load_params(jcfg, seed=SEED))
    # square and tall frames: on a wide frame the reference's swapped RPN clip
    # (x clamped to H) collapses most random-weight detections to zero width
    for seed, hw in [(21, (64, 64)), (22, (80, 60)), (23, (60, 80))]:
        img = image(seed, *hw)
        want = jpred.predict_numpy(img)
        got = port.predict_numpy(img)
        n = want["num_instances"]
        assert got["num_instances"] == n >= 1
        np.testing.assert_array_equal(got["image_size"], want["image_size"])
        np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
        np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], atol=1e-3,
                                   rtol=RTOL)
        for k in ("coarse_segm", "fine_segm", "u", "v"):
            key = f"pred_densepose_{k}"
            assert got[key].shape == want[key].shape == (n, want[key].shape[1], 32, 32)
            np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=RTOL,
                                       err_msg=key)


def test_same_seed_gives_jax_weights(setup):
    """The port's own loader draws the JAX package's weights from a seed."""
    jcfg, pcfg, jmodel, jp, port = setup
    own = DensePosePredictor(pcfg, device="cpu", seed=SEED)
    for k, v in port.model.state_dict().items():
        assert torch.equal(own.model.state_dict()[k], v), k


def test_cuda_requested_without_card_raises(setup, monkeypatch):
    jcfg, pcfg, jmodel, jp, port = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DensePosePredictor(pcfg, seed=SEED)
