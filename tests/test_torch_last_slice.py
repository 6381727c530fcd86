"""The port's last slice held against the JAX package on the CPU.

* The unfolded FrozenBN route (``TPU.FOLD_FROZEN_BN`` False): the R50-FPN
  flagship, the R50-C4 detector, R18-FPN (BasicBlock) and HRNet, each on the
  JAX package's unfolded params (``load_params`` with the flag off, which
  keeps the statistics: ``torch_state_to_jax(..., fold_bn=False)``, and HRNet
  without ``hrnet_fold_bn``) through ``params_from_jax(..., fold_bn=False)``:
  the backbone features against the jitted JAX backbone, the request against
  the JAX predictor; the port's own loader draws the same state; the
  row-sharded walk of ``spatial_parallel_forward`` applies the statistics
  too; and the refusals where the JAX package drops them (HRNet's s8
  chains, DeepLab's FrozenBN body convs), the ResNet's int8 backbone keeping
  the fp path as JAX ``int8_backbone_active`` does.
* The DeepLab head with ``DEEPLAB.NORM`` "" and "FrozenBN": the DensePose
  stage on the JAX stage's inputs, and in ``INT8_HEAD`` the calibrated s8
  chain on the JAX ASPP's output and the calibration walk's statistics.
* The standalone functions: the mask and keypoint heads
  (tests/test_extras.py:115-158's cases), the keypoint extraction and its
  bicubic resize, the matcher, subsampling, the DensePose data filter, the
  rotated boxes and rotated NMS, ``sem_seg_postprocess``,
  ``cycle_batch_norm`` and ``layer_norm_cf`` (tests/test_extras.py:24-198,
  tests/test_vestigial_twins.py:21-95), ``scale_boxes`` and
  ``matched_pairwise_iou``, the registry, and the OneDrive rewrite with the
  cache name it resolves to.

Tolerances (fp32), stated where they differ: features, maps, boxes and
scores within ATOL = RTOL = 1e-4 (summation orders of XLA's and PyTorch's
CPU convolutions and reductions; features scaled by the map's largest
magnitude, whose random-weight values reach ~1e3), boxes of a request 1e-3
(tests/test_torch_pipeline.py's); exact: spec keys, loaded weights,
detection counts, classes, keep masks, labels, the int8 chain without a
GroupNorm (tests/test_torch_int8.py's), the keypoint extraction on the same
maps, the registry and the URLs.
"""

import base64
import os
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from densepose_tpu.checkpoint.transform import random_torch_state as jax_random_state
from densepose_tpu.checkpoint.transform import torch_state_to_jax
from densepose_tpu.config import get_cfg as jax_get_cfg
from densepose_tpu.models import resnet as jresnet
from densepose_tpu.models import roi_heads as jroi
from densepose_tpu.models.backbones import backbone_fns
from densepose_tpu.models.filter import densepose_data_filter_mask as jax_filter
from densepose_tpu.models.keypoint_head import _resize_bicubic_np as jax_bicubic
from densepose_tpu.models.keypoint_head import heatmaps_to_keypoints_np as jax_heatmaps
from densepose_tpu.models.keypoint_head import keypoint_head_forward, keypoint_head_spec
from densepose_tpu.models.mask_head import mask_head_forward, mask_head_spec
from densepose_tpu.models.matcher import match_quality as jax_match_quality
from densepose_tpu.models.rcnn import build_model as jax_build_model
from densepose_tpu.models.rcnn import sem_seg_postprocess as jax_sem_seg
from densepose_tpu.ops import boxes as jboxes
from densepose_tpu.ops import norms as jnorms
from densepose_tpu.ops import rotated as jrot
from densepose_tpu.predictor import DensePosePredictor as JaxPredictor
from densepose_tpu.predictor import load_params as jax_load_params
from densepose_tpu.utils import file_io as jax_file_io
from densepose_tpu.utils.registry import Registry as JaxRegistry
from densepose_tpu_torch.checkpoint.transform import (fold_state, params_from_jax,
                                                      random_torch_state)
from densepose_tpu_torch.config import get_cfg as port_get_cfg
from densepose_tpu_torch.models import rcnn as prcnn
from densepose_tpu_torch.models.filter import densepose_data_filter_mask
from densepose_tpu_torch.models.keypoint_head import (KRCNNConvDeconvUpsampleHead,
                                                      _resize_bicubic_np,
                                                      heatmaps_to_keypoints_np)
from densepose_tpu_torch.models.keypoint_head import keypoint_head_spec as port_kp_spec
from densepose_tpu_torch.models.mask_head import MaskRCNNConvUpsampleHead
from densepose_tpu_torch.models.mask_head import mask_head_spec as port_mask_spec
from densepose_tpu_torch.models.matcher import match_quality, subsample_labels
from densepose_tpu_torch.models.rcnn import build_model
from densepose_tpu_torch.models.roi_heads import densepose_stage_forward
from densepose_tpu_torch.ops import boxes as pboxes
from densepose_tpu_torch.ops import norms as pnorms
from densepose_tpu_torch.ops import rotated as prot
from densepose_tpu_torch.predictor import DensePosePredictor, load_params
from densepose_tpu_torch.utils import file_io as port_file_io
from densepose_tpu_torch.utils.registry import Registry, locate
from tests.test_torch_hrnet import HRNET, NARROW_HRNET
from tests.test_torch_int8 import HEAD_INT8, Pair as Int8Pair, nchw as nhwc_to_nchw, nhwc
from tests.test_torch_spatial import walk_holds
from tests.test_torch_variants import det_boxes, image, nchw, variant_cfg
from tests.torch_cases import BASIC_BLOCK, C4_DETECTION, C4_TINY, R50_NARROW, set_cfg

torch.set_num_threads(2)

ATOL = RTOL = 1e-4
SEED = 5
FLAGSHIP = "densepose_rcnn_R_50_FPN_s1x"
DEEPLAB = "densepose_rcnn_R_50_FPN_DL_s1x"
UNFOLD = [("TPU.FOLD_FROZEN_BN", False)]
RNG = np.random.RandomState(5)


# ---------------------------------------------------------------------------
# the unfolded FrozenBN route
# ---------------------------------------------------------------------------

def unfolded_cfg(get_cfg, case):
    """The case's narrowed config with TPU.FOLD_FROZEN_BN off."""
    if case == "c4":
        cfg = set_cfg(get_cfg(), C4_DETECTION + C4_TINY + R50_NARROW + UNFOLD)
        cfg.freeze()
        return cfg
    extra = {"r50_fpn": [], "r18_fpn": [("MODEL.RESNETS.DEPTH", 18)] + BASIC_BLOCK,
             "hrnet": NARROW_HRNET}[case]
    return variant_cfg(get_cfg, HRNET if case == "hrnet" else FLAGSHIP, extra + UNFOLD)


class Unfolded:
    """Both packages on the JAX package's unfolded params of one seed."""

    def __init__(self, case):
        self.case = case
        self.jcfg, self.pcfg = unfolded_cfg(jax_get_cfg, case), unfolded_cfg(port_get_cfg, case)
        self.jparams = jax_load_params(self.jcfg, seed=SEED)
        self.jp = {k: jnp.asarray(v) for k, v in self.jparams.items()}
        self.port = DensePosePredictor(self.pcfg, device="cpu",
                                       params=params_from_jax(self.jparams, fold_bn=False))
        self.jmodel = jax_build_model(self.jcfg)


_UNFOLDED = {}


def unfolded(case):
    if case not in _UNFOLDED:
        _UNFOLDED[case] = Unfolded(case)
    return _UNFOLDED[case]


CASES = ["r50_fpn", "c4", "r18_fpn", "hrnet"]


@pytest.fixture
def plain_stem(monkeypatch):
    """The JAX HRNet stem conv in its plain form (the packed form sums in
    another order; tests/test_torch_hrnet.py)."""
    monkeypatch.setenv("DENSEPOSE_TPU_NO_PACKED_STEM", "1")


@pytest.mark.parametrize("case", CASES)
def test_unfolded_state_keeps_the_statistics(case):
    """The JAX params with the flag off hold the BN statistics; the bridge
    puts them under each conv's ``.norm`` (HRNet's siblings renamed), which
    is the port module's state dict, key for key, and the port's own loader
    draws it bit for bit; every backbone conv has a FrozenBatchNorm2d and no
    bias."""
    u = unfolded(case)
    assert any(k.endswith(".running_var") for k in u.jparams)
    want = params_from_jax(u.jparams, fold_bn=False)
    got = load_params(u.pcfg, seed=SEED)
    assert sorted(got) == sorted(want) == sorted(u.port.model.state_dict())
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    norms = [m for m in u.port.model.backbone.modules()
             if isinstance(m, pnorms.FrozenBatchNorm2d)]
    convs = [m for m in u.port.model.backbone.modules() if isinstance(m, pnorms.Conv2dNorm)]
    assert len(norms) == len(convs) > 10 and all(c.bias is None for c in convs)
    spec = build_model(u.pcfg).spec()
    assert sorted(fold_state(random_torch_state(spec, seed=1), spec, fold=False)) == sorted(want)


@pytest.mark.parametrize("case", CASES)
def test_unfolded_backbone_matches_jax(case, plain_stem, monkeypatch):
    """The backbone with its BN applied after each conv against the jitted
    JAX backbone on the same input: each level within ATOL / RTOL of its
    largest magnitude. With the statistics dropped (the fault that the flag
    used to hide: each FrozenBatchNorm2d an identity) the levels are far
    from it."""
    u = unfolded(case)
    img = image(31, 64, 96)
    x, _, _ = u.jmodel.preprocess(jnp.asarray(img), img.shape[:2])
    fwd = backbone_fns(u.jcfg)[1]
    want = {k: nchw(v).numpy()
            for k, v in jax.jit(lambda p, x: fwd(p, x, u.jcfg))(u.jp, x).items()}
    with torch.no_grad():
        got = u.port.model.backbone(nchw(x))
        monkeypatch.setattr(pnorms.FrozenBatchNorm2d, "forward", lambda self, y: y)
        dropped = u.port.model.backbone(nchw(x))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        top = float(np.abs(w).max())
        np.testing.assert_allclose(got[k].numpy(), w, atol=ATOL * max(top, 1.0), rtol=RTOL,
                                   err_msg=k)
        assert float(np.abs(dropped[k].numpy() - w).max()) > 0.05 * top, k


@pytest.mark.parametrize("case", CASES)
def test_unfolded_request_matches_jax(case, plain_stem):
    """The whole request against the JAX predictor with the flag off:
    detections exact on the valid prefix (boxes within 1e-3), the DensePose
    maps within ATOL / RTOL."""
    u = unfolded(case)
    jpred = JaxPredictor(u.jcfg, params=dict(u.jparams))
    for seed, hw in [(21, (64, 64)), (22, (80, 60))]:
        img = image(seed, *hw)
        want, got = jpred.predict_numpy(img), u.port.predict_numpy(img)
        n = want["num_instances"]
        assert got["num_instances"] == n >= 1
        np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
        np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], atol=1e-3, rtol=RTOL)
        maps = [k for k in want if k.startswith("pred_densepose_")]
        assert sorted(maps) == sorted(k for k in got if k.startswith("pred_densepose_"))
        assert bool(maps) == (case != "c4")
        for k in maps:
            np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("case", ["r50_fpn", "hrnet"])
def test_unfolded_row_walk(case):
    """``spatial_parallel_forward``'s backbone walk on row slabs applies
    each conv's FrozenBN on its slab (pointwise) and equals the unsharded
    backbone (tests/test_torch_spatial.py::walk_holds)."""
    u = unfolded(case)
    walk_holds(u.port.model, image(8, 256, 128), 3)


def test_hrnet_int8_backbone_unfolded_refused():
    """The JAX package's HRNet s8 chains take each conv's weight and bias and
    drop its unfolded statistics: the port refuses the combination, naming
    those lines."""
    cfg = unfolded_cfg(port_get_cfg, "hrnet")
    cfg.defrost()
    cfg.TPU.INT8_BACKBONE = True
    cfg.freeze()
    with pytest.raises(ValueError, match=r"hrnet.py:273-290.*drop its unfolded"):
        build_model(cfg)


def test_deeplab_frozen_bn_unfolded_refused():
    """The JAX DeepLab forward applies only GroupNorm after its body convs:
    with FrozenBN unfolded it would drop the statistics, so the port refuses,
    naming roi_heads.py:476-483; folded, it builds."""
    extra = [("MODEL.ROI_DENSEPOSE_HEAD.DEEPLAB.NORM", "FrozenBN")]
    with pytest.raises(ValueError, match="roi_heads.py:476-483"):
        build_model(variant_cfg(port_get_cfg, DEEPLAB, extra + UNFOLD))
    build_model(variant_cfg(port_get_cfg, DEEPLAB, extra))


def test_resnet_int8_backbone_unfolded_keeps_fp(tmp_path):
    """JAX ``int8_backbone_active`` keeps the fp bottleneck path where the
    statistics are unfolded (resnet.py:205-214): calibrated with the flag
    off, the port's ResNet runs fp, its features equal the fp model's, and
    the FPN's s8 convs (which hold no BN) are installed, as in JAX."""
    extra = [("TPU.INT8_BACKBONE", True)] + UNFOLD
    jcfg = variant_cfg(jax_get_cfg, FLAGSHIP, extra)
    jpred = JaxPredictor(jcfg, seed=SEED)
    jpred.calibrate_int8([image(21)])
    assert not jresnet.int8_backbone_active(jpred.params, jcfg, "backbone.bottom_up")
    port = DensePosePredictor(variant_cfg(port_get_cfg, FLAGSHIP, extra), device="cpu",
                              seed=SEED)
    port.calibrate_int8([image(21)])
    fp = DensePosePredictor(variant_cfg(port_get_cfg, FLAGSHIP, UNFOLD), device="cpu",
                            seed=SEED)
    resnet = port.model.backbone.bottom_up
    assert not resnet.int8_active() and port.model.backbone.fpn_output2.qweight is not None
    x, _, _ = port.model.preprocess(torch.from_numpy(image(23)))
    with torch.no_grad():
        got, want = resnet(x), fp.model.backbone.bottom_up(x)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# DeepLab without GroupNorm
# ---------------------------------------------------------------------------

DL_NORMS = ["", "FrozenBN"]


def dl_pair(norm, extra=()):
    from tests.test_torch_variants import build_pair
    return build_pair(DEEPLAB, [("MODEL.ROI_DENSEPOSE_HEAD.DEEPLAB.NORM", norm)] + list(extra))


@pytest.mark.parametrize("norm", DL_NORMS, ids=["none", "frozen_bn"])
def test_deeplab_norm_stage_matches_jax(norm):
    """The DensePose stage (decoder, ASPP with GroupNorm, body convs with a
    bias: none, or FrozenBN folded into them) on the JAX stage's features
    and boxes, within ATOL / RTOL; the spec is JAX's, the body convs hold no
    norm module."""
    jcfg, pcfg, jmodel, jp, jparams, port = dl_pair(norm)
    assert list(build_model(pcfg).spec()) == list(jax_build_model(jcfg).spec())
    head = port.model.roi_heads.densepose_head
    assert "body_conv_fcn1.bias" in head.state_dict()
    assert not any(k.startswith("body_conv_fcn1.norm") for k in head.state_dict())
    assert ("roi_heads.densepose_head.body_conv_fcn1.norm.running_var"
            in jax_build_model(jcfg).spec()) == (norm == "FrozenBN")
    x, _, _ = jmodel.preprocess(jnp.asarray(image(14)), (64, 64))
    feats = jax.jit(lambda p, x: backbone_fns(jcfg)[1](p, x, jcfg))(jp, x)
    boxes = det_boxes(4, 40)
    want = jax.jit(lambda p, f, b: jroi.densepose_stage_forward(p, f, b, jcfg))(
        jp, feats, jnp.asarray(boxes))
    with torch.no_grad():
        got = densepose_stage_forward(port.model.roi_heads,
                                      {k: nchw(v) for k, v in feats.items()},
                                      torch.from_numpy(boxes), pcfg)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.transpose(np.asarray(w), (0, 3, 1, 2)),
                                   atol=ATOL, rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("norm", DL_NORMS, ids=["none", "frozen_bn"])
def test_deeplab_norm_int8_matches_jax(norm, tmp_path):
    """INT8_HEAD: the port loads the JAX predictor's calibration; the head's
    s8 chain (the bias chain, no GroupNorm link) on the JAX ASPP's output is
    exact (tests/test_torch_int8.py's V1ConvX rule), and the calibration
    walk's statistics on one frame equal JAX's within RTOL."""
    pair = Int8Pair(DEEPLAB, HEAD_INT8 + [("MODEL.ROI_DENSEPOSE_HEAD.DEEPLAB.NORM", norm)],
                    tmp_path, [image(21)])
    head = pair.port.model.roi_heads.densepose_head
    assert not head.gn and head.int8
    res = pair.pcfg.MODEL.ROI_DENSEPOSE_HEAD.POOLER_RESOLUTION
    c = head.ASPP.project[0].in_channels // 5
    x = np.abs(np.random.RandomState(3).randn(5, res, res, c)).astype(np.float32) * 2
    hp = "roi_heads.densepose_head"
    aspp = jax.jit(lambda p, x: jroi._deeplab_aspp(p, x, pair.jcfg, hp))(pair.jp, jnp.asarray(x))
    want = jax.jit(lambda p, y: jroi._stacked_int8_chain(p, y, pair.jcfg, hp, norm=norm))(
        pair.jp, aspp)
    with torch.no_grad():
        got = head.stack(nhwc_to_nchw(aspp), norm=False)
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))
    img = image(22)
    jstats = jax.jit(pair.jmodel.forward_int8_calibration)(pair.jp, jnp.asarray(img))
    with torch.no_grad():
        pstats = pair.port.model.forward_int8_calibration(torch.from_numpy(img))
    np.testing.assert_allclose(pstats["head"].numpy(), np.asarray(jstats["head"]), rtol=RTOL)


# ---------------------------------------------------------------------------
# the mask and keypoint heads (tests/test_extras.py:115-158)
# ---------------------------------------------------------------------------

def heads_cfg(get_cfg):
    cfg = get_cfg()
    cfg.MODEL.ROI_HEADS.IN_FEATURES = ["p2", "p3"]
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 3
    cfg.MODEL.ROI_MASK_HEAD.NUM_CONV = 2
    cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 7
    cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS = (32, 32)
    cfg.MODEL.FPN.OUT_CHANNELS = 16
    cfg.MODEL.ROI_MASK_HEAD.CONV_DIM = 16
    cfg.MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION = 7
    return cfg


@pytest.fixture(scope="module")
def heads():
    """tests/test_extras.py's heads, features and boxes, in both packages,
    on one random state (the port's through the JAX layouts and back)."""
    jcfg, pcfg = heads_cfg(jax_get_cfg), heads_cfg(port_get_cfg)
    spec = {**mask_head_spec(jcfg), **keypoint_head_spec(jcfg)}
    pspec = {**port_mask_spec(pcfg), **port_kp_spec(pcfg)}
    assert list(pspec) == list(spec)
    assert all((pspec[k].shape, pspec[k].kind) == (spec[k].shape, spec[k].kind) for k in spec)
    jparams = torch_state_to_jax(jax_random_state(spec, 0), spec)
    state = params_from_jax(jparams)
    mask, kp = MaskRCNNConvUpsampleHead(pcfg), KRCNNConvDeconvUpsampleHead(pcfg)
    for module, prefix in ((mask, "roi_heads.mask_head."), (kp, "roi_heads.keypoint_head.")):
        module.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in state.items()
                                if k.startswith(prefix)})
    rng = np.random.RandomState(5)
    feats = {"p2": rng.randn(32, 32, 16).astype(np.float32),
             "p3": rng.randn(16, 16, 16).astype(np.float32)}
    boxes = np.float32([[4.0, 4.0, 60.0, 60.0], [10.0, 10.0, 40.0, 30.0]])
    return (jcfg, {k: jnp.asarray(v) for k, v in jparams.items()}, mask, kp,
            feats, boxes, np.int32([1, 2]), {"p2": 4, "p3": 8})


def test_mask_head_matches_jax(heads):
    """Per-detection sigmoid masks of the predicted class, (2, 14, 14) in
    [0, 1], within ATOL / RTOL of JAX ``mask_head_forward``; the pooling ran
    through the port's multilevel ROIAlign (K2's plain version here)."""
    jcfg, jp, mask, _, feats, boxes, classes, strides = heads
    want = mask_head_forward(jp, {k: jnp.asarray(v) for k, v in feats.items()},
                             jnp.asarray(boxes), jnp.asarray(classes), jcfg, strides)
    with torch.no_grad():
        got = mask({k: torch.from_numpy(v).permute(2, 0, 1)[None] for k, v in feats.items()},
                   torch.from_numpy(boxes), torch.from_numpy(classes), strides)
    assert got.shape == (2, 14, 14) and got.dtype == torch.float32
    assert bool(((got >= 0) & (got <= 1)).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_keypoint_head_matches_jax(heads):
    """Heatmap logits (2, 17, 28, 28) within ATOL / RTOL of JAX
    ``keypoint_head_forward`` (its (N, 28, 28, 17) transposed), and the
    keypoints extracted from the same maps by both packages equal, inside
    their boxes."""
    jcfg, jp, _, kp, feats, boxes, _, strides = heads
    want = keypoint_head_forward(jp, {k: jnp.asarray(v) for k, v in feats.items()},
                                 jnp.asarray(boxes), jcfg, strides)
    with torch.no_grad():
        got = kp({k: torch.from_numpy(v).permute(2, 0, 1)[None] for k, v in feats.items()},
                 torch.from_numpy(boxes), strides)
    want = np.transpose(np.asarray(want), (0, 3, 1, 2))
    assert got.shape == want.shape == (2, 17, 28, 28)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    kps = heatmaps_to_keypoints_np(want, boxes)
    np.testing.assert_array_equal(kps, jax_heatmaps(want, boxes))
    assert kps.shape == (2, 17, 4)
    assert (kps[0, :, 0] >= 4).all() and (kps[0, :, 0] <= 60).all()


@pytest.mark.parametrize("hw_in,hw_out", [((14, 14), (37, 22)), ((8, 12), (3, 5)),
                                          ((14, 14), (56, 56)), ((9, 9), (9, 9))])
def test_bicubic_resize_matches_jax_and_torch(hw_in, hw_out):
    """``_resize_bicubic_np`` equals the JAX package's bit for bit and torch's
    bicubic ``F.interpolate`` within 1e-4 (test_extras.py's bound)."""
    x = np.random.RandomState(0).randn(*hw_in, 3).astype(np.float32)
    got = _resize_bicubic_np(x, hw_out)
    np.testing.assert_array_equal(got, jax_bicubic(x, hw_out))
    want = torch.nn.functional.interpolate(torch.from_numpy(x.transpose(2, 0, 1))[None],
                                           size=hw_out, mode="bicubic", align_corners=False)
    np.testing.assert_allclose(got, want[0].numpy().transpose(1, 2, 0), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# matcher, subsampling, the data filter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iou,low_quality", [
    ([[0.9, 0.4, 0.1, 0.75], [0.2, 0.6, 0.05, 0.8]], False),
    ([[0.9, 0.1], [0.2, 0.25]], True),
    (np.round(RNG.rand(6, 40), 2).tolist(), True),
    (np.round(RNG.rand(6, 40), 2).tolist(), False)])
def test_match_quality_matches_jax(iou, low_quality):
    """Matches and labels exact (tests/test_extras.py:24-40's cases, and
    random IoUs with ties at two decimals)."""
    iou = np.float32(iou)
    want = jax_match_quality(jnp.asarray(iou), [0.3, 0.7], [0, -1, 1], low_quality)
    got = match_quality(torch.from_numpy(iou), [0.3, 0.7], [0, -1, 1], low_quality)
    for g, w in zip(got, want):
        assert g.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(np.int8): torch.int8}[np.asarray(w).dtype]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n_pos,n_neg,num,frac", [(20, 100, 64, 0.25), (5, 100, 64, 0.25),
                                                  (40, 10, 64, 0.5)])
def test_subsample_labels_counts_and_uniformity(n_pos, n_neg, num, frac):
    """The counts of JAX ``subsample_labels`` (min of the target and what is
    available, the negatives filling the rest), disjoint masks on the right
    labels, and a uniform draw: over 400 seeds each candidate is picked at
    its expected rate within 5 standard deviations."""
    from densepose_tpu.models.matcher import subsample_labels as jax_subsample
    labels = np.int64([1] * n_pos + [0] * n_neg + [-1] * 10)
    jpos, jneg = jax_subsample(jnp.asarray(labels), num, frac, 0, jax.random.PRNGKey(0))
    t = torch.from_numpy(labels)
    hits = torch.zeros(len(labels))
    runs = 400
    for seed in range(runs):
        pos, neg = subsample_labels(t, num, frac, 0, torch.Generator().manual_seed(seed))
        assert int(pos.sum()) == int(jpos.sum()) and int(neg.sum()) == int(jneg.sum())
        assert not bool((pos & neg).any()) and not bool((pos | neg)[n_pos + n_neg:].any())
        assert bool((t[pos] == 1).all()) and bool((t[neg] == 0).all())
        hits += (pos | neg).float()
    for lo, hi, taken in ((0, n_pos, int(jpos.sum())), (n_pos, n_pos + n_neg, int(jneg.sum()))):
        p = taken / (hi - lo)
        sd = np.sqrt(runs * p * (1 - p)) + 1e-9
        assert np.abs(hits[lo:hi].numpy() - runs * p).max() <= 5 * sd + 1e-6


def test_densepose_data_filter_matches_jax():
    rng = np.random.RandomState(2)
    props = det_boxes(7, 60)
    gt = det_boxes(8, 6)
    gt[2] = props[5]  # an exact match
    valid = rng.rand(6) > 0.3
    valid[2] = True
    for thr in (0.7, 0.5, 0.1):
        want = np.asarray(jax_filter(jnp.asarray(props), jnp.asarray(gt), jnp.asarray(valid),
                                     thr))
        got = densepose_data_filter_mask(torch.from_numpy(props), torch.from_numpy(gt),
                                         torch.from_numpy(valid), thr)
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


# ---------------------------------------------------------------------------
# rotated boxes (tests/test_extras.py:44-107)
# ---------------------------------------------------------------------------

ROTATED_PAIRS = [([0, 0, 4, 2, 0], [1, 0.5, 4, 2, 0]), ([0, 0, 2, 2, 0], [0, 0, 2, 2, 45]),
                 ([0, 0, 6, 2, 30], [1, 1, 4, 3, -20]), ([0, 0, 2, 2, 0], [5, 5, 2, 2, 10]),
                 ([0, 0, 4, 2, 90], [0, 0, 2, 4, 0])]


def rotated_boxes(rng, k):
    return np.concatenate([rng.rand(k, 2) * 40, rng.rand(k, 2) * 12 + 1,
                           rng.rand(k, 1) * 360 - 180], 1).astype(np.float32)


def test_rotated_iou_matches_jax():
    """test_extras.py's five pairs and 30 x 20 random boxes: the IoU within
    1e-5 of JAX ``rotated_pairwise_iou`` (the same clipping in another
    rounding order), and the corners within 1e-5."""
    a = np.float32([p for p, _ in ROTATED_PAIRS])
    b = np.float32([q for _, q in ROTATED_PAIRS])
    rng = np.random.RandomState(9)
    for x, y in ((a, b), (rotated_boxes(rng, 30), rotated_boxes(rng, 20))):
        want = np.asarray(jrot.rotated_pairwise_iou(jnp.asarray(x), jnp.asarray(y)))
        got = prot.rotated_pairwise_iou(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        np.testing.assert_allclose(prot.box_corners(torch.from_numpy(x)).numpy(),
                                   np.asarray(jrot._box_corners(jnp.asarray(x))), atol=1e-5)
    assert want.max() > 0.2


@pytest.mark.parametrize("case", ["duplicates", "random"])
def test_rotated_nms_matches_jax(case):
    """Keep masks exact: test_extras.py's near-duplicate case, and 80 random
    boxes with a tenth invalid at 0.3."""
    if case == "duplicates":
        boxes = np.float32([[0, 0, 4, 2, 10], [0.1, 0.0, 4, 2, 12], [10, 10, 4, 2, 45]])
        scores, valid, thr = np.float32([0.9, 0.8, 0.7]), np.ones(3, bool), 0.5
    else:
        rng = np.random.RandomState(4)
        boxes = rotated_boxes(rng, 80)
        scores, valid, thr = rng.rand(80).astype(np.float32), rng.rand(80) > 0.1, 0.3
    want = np.asarray(jrot.nms_rotated_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                            jnp.asarray(valid), thr))
    got = prot.nms_rotated_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                                torch.from_numpy(valid), thr)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def test_apply_deltas_rotated_and_linear_match_jax():
    """Identity deltas give the box back (test_extras.py:88-100); random
    deltas within 1e-5 of JAX's transforms, the angle wrapped into
    [-180, 180)."""
    boxes = np.float32([[10.0, 20.0, 4.0, 8.0, 30.0]])
    out = prot.apply_deltas_rotated(torch.zeros(1, 5), torch.from_numpy(boxes), (1, 1, 1, 1, 1))
    np.testing.assert_allclose(out.numpy(), boxes, atol=1e-5)
    out = prot.apply_deltas_linear(torch.full((1, 4), 0.5), torch.tensor([[0.0, 0.0, 4.0, 4.0]]))
    np.testing.assert_allclose(out.numpy(), [[0, 0, 4, 4]], atol=1e-5)
    rng = np.random.RandomState(3)
    boxes = rotated_boxes(rng, 50)
    deltas = (rng.randn(50, 5) * 0.5).astype(np.float32)
    weights = (10.0, 10.0, 5.0, 5.0, 1.0)
    want = np.asarray(jrot.apply_deltas_rotated(jnp.asarray(deltas), jnp.asarray(boxes), weights))
    got = prot.apply_deltas_rotated(torch.from_numpy(deltas), torch.from_numpy(boxes), weights)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert float(got[:, 4].min()) >= -180 and float(got[:, 4].max()) < 180
    xyxy = det_boxes(5, 50)
    for norm in (True, False):
        want = np.asarray(jrot.apply_deltas_linear(jnp.asarray(deltas[:, :4]), jnp.asarray(xyxy),
                                                   norm))
        got = prot.apply_deltas_linear(torch.from_numpy(deltas[:, :4]), torch.from_numpy(xyxy),
                                       norm)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)


# ---------------------------------------------------------------------------
# sem_seg_postprocess, the norms, the box helpers (test_vestigial_twins.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("in_hw,img_size,out_hw", [((32, 40), (28, 36), (56, 75)),
                                                   ((32, 40), (32, 40), (16, 20)),
                                                   ((24, 24), (17, 19), (17, 19))])
def test_sem_seg_postprocess_matches_jax(in_hw, img_size, out_hw):
    """The crop and the bilinear resize on (C, H, W) against JAX's on (H, W,
    C), within 1e-5 (test_vestigial_twins.py's bound)."""
    x = np.random.RandomState(0).randn(*in_hw, 5).astype(np.float32)
    want = np.asarray(jax_sem_seg(jnp.asarray(x), img_size, *out_hw))
    got = prcnn.sem_seg_postprocess(torch.from_numpy(x.transpose(2, 0, 1)), img_size, *out_hw)
    assert got.shape == (5, *out_hw)
    np.testing.assert_allclose(got.numpy().transpose(1, 2, 0), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("affine", [True, False])
def test_cycle_batch_norm_matches_jax(affine):
    """Each domain's statistics (an int position and a 0-dim tensor one),
    with and without the shared affine, within 1e-6 of JAX's."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 4, 6).astype(np.float32)
    means = rng.randn(3, 6).astype(np.float32)
    variances = rng.rand(3, 6).astype(np.float32) + 0.3
    weight, bias = rng.randn(6).astype(np.float32), rng.randn(6).astype(np.float32)
    for pos in range(3):
        want = np.asarray(jnorms.cycle_batch_norm(
            jnp.asarray(x), jnp.asarray(means), jnp.asarray(variances),
            jnp.asarray(weight) if affine else None, jnp.asarray(bias) if affine else None, pos))
        for p in (pos, torch.tensor(pos)):
            got = pnorms.cycle_batch_norm(
                torch.from_numpy(x), torch.from_numpy(means), torch.from_numpy(variances),
                torch.from_numpy(weight) if affine else None,
                torch.from_numpy(bias) if affine else None, p)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_layer_norm_cf_matches_jax(dtype):
    """Statistics in fp32, the result in x's dtype: within 1e-6 in fp32,
    one unit in the last place of float16."""
    rng = np.random.RandomState(2)
    x = (rng.randn(3, 5, 5, 8) * 3 + 1).astype(dtype)
    w, b = rng.randn(8).astype(np.float32), rng.randn(8).astype(np.float32)
    want = np.asarray(jnorms.layer_norm_cf(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = pnorms.layer_norm_cf(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert got.numpy().dtype == want.dtype
    tol = 1e-6 if dtype == "float32" else 2.0 ** -10 * 8
    np.testing.assert_allclose(got.numpy().astype(np.float32), want.astype(np.float32),
                               atol=tol, rtol=tol)


def test_frozen_batch_norm_matches_jax():
    """The unfolded route's norm: JAX ``frozen_batch_norm`` on NHWC, the
    port's on NCHW, within 1e-6."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 6, 7).astype(np.float32)
    w, b, m = (rng.randn(7).astype(np.float32) for _ in range(3))
    v = rng.rand(7).astype(np.float32) + 0.5
    want = np.asarray(jnorms.frozen_batch_norm(*(jnp.asarray(a) for a in (x, w, b, m, v))))
    got = pnorms.frozen_batch_norm(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                                   *(torch.from_numpy(a) for a in (w, b, m, v)))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=1e-6, atol=1e-6)


def test_box_helpers_match_jax():
    """``scale_boxes`` exact and ``matched_pairwise_iou`` within 1e-6 of
    JAX's, on boxes with empty and disjoint pairs."""
    a, b = det_boxes(1, 30), det_boxes(2, 30)
    b[:3] = a[:3]
    a[3, 2:] = a[3, :2]  # an empty box
    b[4] = a[4] + 500.0  # disjoint
    want = np.asarray(jboxes.scale_boxes(jnp.asarray(a), 0.5, 1.25))
    np.testing.assert_array_equal(pboxes.scale_boxes(torch.from_numpy(a), 0.5, 1.25).numpy(),
                                  want)
    want = np.asarray(jboxes.matched_pairwise_iou(jnp.asarray(a), jnp.asarray(b)))
    got = pboxes.matched_pairwise_iou(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert got[0] == 1.0 and got[3] == 0.0 and got[4] == 0.0


# ---------------------------------------------------------------------------
# the registry, and OneDrive links
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("registry", [Registry, JaxRegistry], ids=["port", "jax"])
def test_registry_behaves_as_jax(registry):
    """Both packages' registries under the same calls: the decorator forms,
    the two-argument form, lookup, membership, duplicate and missing names."""
    reg = registry("test")

    @reg.register
    def thing():
        return 1

    @reg.register()
    def other():
        return 2

    @reg.register("named")
    def third():
        return 3

    reg.register("lam", lambda: 4)
    assert [reg.get(k)() for k in ("thing", "other", "named", "lam")] == [1, 2, 3, 4]
    assert "thing" in reg and "third" not in reg
    assert sorted(reg.keys()) == ["lam", "named", "other", "thing"]
    with pytest.raises(KeyError):
        reg.get("missing")
    with pytest.raises(KeyError):
        reg.register("thing", thing)


def test_locate():
    from densepose_tpu_torch.ops.nms import nms_mask
    assert locate("densepose_tpu_torch.ops.nms.nms_mask") is nms_mask
    assert locate("densepose_tpu_torch.ops.boxes.DEFAULT_SCALE_CLAMP") == \
        pboxes.DEFAULT_SCALE_CLAMP
    with pytest.raises(ImportError):
        locate("no_such_package_here.thing")


@pytest.mark.parametrize("link", ["https://1drv.ms/u/s!AmkRs-xASEQ8a1Zb",
                                  "https://1drv.ms/u/s!Ab?e=x_y-z", "https://1drv.ms/f/s!A"])
def test_onedrive_link_resolves_as_jax(link, tmp_path, monkeypatch):
    """The port rewrites a share link to the JAX package's direct-download
    URL (base64url of the link, 'u!' prefix, no padding), fetches that URL,
    and caches it under the file name the JAX package then finds: one
    download serves both."""
    want = jax_file_io.onedrive_download_url(link)
    assert port_file_io.onedrive_download_url(link) == want
    b64 = want[len("https://api.onedrive.com/v1.0/shares/u!"):-len("/root/content")]
    assert base64.urlsafe_b64decode(b64 + "=" * (-len(b64) % 4)).decode() == link
    fetched = []

    def fake_fetch(url, path):  # no network: write the file where the cache wants it
        fetched.append(url)
        with open(path, "wb") as f:
            f.write(b"weights")

    monkeypatch.setenv("DENSEPOSE_TPU_CACHE", str(tmp_path))
    monkeypatch.delenv("DENSEPOSE_TPU_OFFLINE", raising=False)
    monkeypatch.setattr(urllib.request, "urlretrieve", fake_fetch)
    local = port_file_io.get_local_path(link)
    assert fetched == [want] and os.path.dirname(local) == str(tmp_path)
    monkeypatch.setattr(jax_file_io, "CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("DENSEPOSE_TPU_OFFLINE", "1")
    assert jax_file_io.get_local_path(link) == local
    assert port_file_io.get_local_path(link) == local and fetched == [want]
