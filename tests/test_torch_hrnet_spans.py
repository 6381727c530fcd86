"""The HRNet + HRFPN backbone's spans and the count of bilinear resizes that
kernel U1 cannot take (``ops/resize.py::resize_bilinear.library_calls``), on
the CPU at narrowed widths (imports no JAX): in a ``predict_batch`` call the
spans ``hrnet`` (the body) and ``hrfpn`` (the neck) each open once, under
``backbone``; the count rises by 2 a forward of HRFPN (its upsamples by 4
and 8) and by none a forward of a narrowed R50-FPN flagship, whose
upsamples are all by 2."""

import numpy as np
import pytest
import torch

from densepose_tpu_torch.model_zoo import get_config
from densepose_tpu_torch.ops import resize
from densepose_tpu_torch.predictor import DensePosePredictor
from densepose_tpu_torch.utils.timing import spans

torch.set_num_threads(2)

SMALL = [
    ("INPUT.MIN_SIZE_TEST", 64), ("INPUT.MAX_SIZE_TEST", 64),
    ("MODEL.RESNETS.STEM_OUT_CHANNELS", 8), ("MODEL.RESNETS.RES2_OUT_CHANNELS", 16),
    ("MODEL.RESNETS.WIDTH_PER_GROUP", 4), ("MODEL.FPN.OUT_CHANNELS", 16),
    ("MODEL.RPN.PRE_NMS_TOPK_TEST", 40), ("MODEL.RPN.POST_NMS_TOPK_TEST", 20),
    ("MODEL.ROI_BOX_HEAD.FC_DIM", 16), ("TEST.DETECTIONS_PER_IMAGE", 4),
    ("MODEL.ROI_DENSEPOSE_HEAD.NUM_STACKED_CONVS", 1),
    ("MODEL.ROI_DENSEPOSE_HEAD.CONV_HEAD_DIM", 8),
    ("MODEL.ROI_DENSEPOSE_HEAD.DECODER_CONV_DIMS", 8),
    ("MODEL.ROI_DENSEPOSE_HEAD.DECODER_NUM_CLASSES", 8),
]
NARROW_HRNET = [
    ("MODEL.HRNET.STAGE2.NUM_CHANNELS", [8, 16]),
    ("MODEL.HRNET.STAGE3.NUM_CHANNELS", [8, 16, 32]),
    ("MODEL.HRNET.STAGE4.NUM_CHANNELS", [8, 16, 32, 64]),
    ("MODEL.HRNET.STAGE2.NUM_MODULES", 1), ("MODEL.HRNET.STAGE3.NUM_MODULES", 1),
    ("MODEL.HRNET.STAGE4.NUM_MODULES", 1),
    ("MODEL.HRNET.STAGE2.NUM_BLOCKS", [1, 1]), ("MODEL.HRNET.STAGE3.NUM_BLOCKS", [1, 1, 1]),
    ("MODEL.HRNET.STAGE4.NUM_BLOCKS", [1, 1, 1, 1]),
    ("MODEL.HRNET.HRFPN.OUT_CHANNELS", 16)]
HRNET = "densepose_rcnn_HRFPN_HRNet_w48_s1x"
FLAGSHIP = "densepose_rcnn_R_50_FPN_s1x"


def predictor(name):
    cfg = get_config(name).clone()
    cfg.defrost()
    cfg.merge_from_list([v for kv in SMALL + (NARROW_HRNET if name == HRNET else [])
                         for v in kv])
    cfg.freeze()
    return DensePosePredictor(cfg, device="cpu", seed=3)


def frames(b=2):
    return (np.random.RandomState(1).rand(b, 64, 64, 3) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def hrnet():
    return predictor(HRNET)


def test_hrnet_spans_open_once_under_backbone(hrnet):
    hrnet.predict_batch(frames())
    got = spans()
    call = [s for s in got if s.call == got[-1].call]
    assert call[-1].name == "predict_batch"
    opened = [(s.name, s.parent) for s in call if s.name in ("hrnet", "hrfpn")]
    assert opened == [("hrnet", "backbone"), ("hrfpn", "backbone")]
    backbone = next(s for s in call if s.name == "backbone")
    body, neck = (next(s for s in call if s.name == n) for n in ("hrnet", "hrfpn"))
    assert backbone.start_ns <= body.start_ns <= body.end_ns <= neck.start_ns
    assert neck.end_ns <= backbone.end_ns


@pytest.mark.parametrize("name, per_forward", [(HRNET, 2), (FLAGSHIP, 0)],
                         ids=["hrnet", "r50_fpn"])
def test_library_resizes_a_forward(hrnet, name, per_forward):
    pred = hrnet if name == HRNET else predictor(name)
    before = resize.resize_bilinear.library_calls
    pred.predict_batch(frames())
    assert resize.resize_bilinear.library_calls - before == per_forward
    pred.predict_batch(frames(1))
    assert resize.resize_bilinear.library_calls - before == 2 * per_forward
