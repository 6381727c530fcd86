"""A run of the harness on the CPU, at tiny widths, with the timed path
broken underneath: ``correct`` comes out false for each fault a cell can
have (a serving cell has no state that a step could leave unchanged and no
exchange between chips), and true with nothing broken. The limits are the
configuration's own. Besides those, the box stage's NMS switched off or run
at too high a threshold, and one frame of a batch given another's answers."""

import numpy as np
import pytest
import torch

from benchmark import manifest, run
from benchmark.readings import box_stage_nms
from benchmark.tests import tiny
from densepose_tpu_torch.models import roi_heads


def half_the_batch(predict):
    """The second half of the frames left out; the first half's answers
    returned for them."""
    def broken(x):
        h = x.shape[0] // 2
        return predict(np.concatenate([x[:h], x[:h]]))
    return broken


def boxes_moved(predict):
    """Every detection box moved by one pixel where it is produced."""
    def broken(x):
        out = predict(x)
        with torch.inference_mode():
            out["det_packed"][:, :-1, :4] += 1.0
        return out
    return broken


def maps_scaled(predict):
    """The U map scaled by 1.1 where it is produced."""
    def broken(x):
        out = predict(x)
        with torch.inference_mode():
            out["pred_densepose_u"] *= 1.1
        return out
    return broken


def last_frame_swapped(predict):
    """The batch's last frame answered with the frame before it."""
    def broken(x):
        x = x.copy()
        x[-1] = x[-2]
        return predict(x)
    return broken


def crowded(name):
    """The tiny configuration with the RPN's NMS off and up to 1000
    proposals, so that the box stage's candidates overlap as densely as the
    cells' 1000 proposals do."""
    conf = tiny.conf(name)
    for keys in (conf["model"], conf["opts"]):
        keys.update({"MODEL.RPN.NMS_THRESH": 1.0, "MODEL.RPN.PRE_NMS_TOPK_TEST": 1000,
                     "MODEL.RPN.POST_NMS_TOPK_TEST": 1000})
    return conf


def one_run(name, wrap, batch=2, conf=None):
    m = manifest.load()
    return run.run_cell(m, manifest.cell(m, f"{name}.cams8"), 2 ** 31 + 21, 1.5, False,
                        device="cpu", conf=conf or tiny.conf(name),
                        traffic=tiny.traffic(batch), wrap=wrap)


@pytest.mark.parametrize("name", ["r50_fpn_s1x_f16", "r101_fpn_legacy_f16"])
@pytest.mark.parametrize("fault", [None, half_the_batch, boxes_moved, maps_scaled],
                         ids=["sound", "half_the_batch", "boxes_moved", "maps_scaled"])
def test_fault_is_caught(name, fault):
    r = one_run(name, fault)
    assert r["checked_frames"] > 0
    assert r["correct"] is (fault is None)


@pytest.mark.parametrize("name", ["r50_fpn_s1x_f16", "r101_fpn_legacy_f16"])
@pytest.mark.parametrize("nms_off", [False, True], ids=["sound", "nms_off"])
def test_box_stage_nms_off_is_caught(name, nms_off, monkeypatch):
    if nms_off:
        monkeypatch.setattr(roi_heads, "nms_mask", box_stage_nms(None))
    r = one_run(name, None, conf=crowded(name))
    assert r["checked_frames"] > 0
    assert r["correct"] is not nms_off


@pytest.mark.parametrize("name", ["r50_fpn_s1x_f16", "r101_fpn_legacy_f16"])
def test_one_frame_with_another_frames_answers_is_caught(name):
    """One frame of four wrong: the largest share of a frame catches it."""
    r = one_run(name, last_frame_swapped, batch=4)
    assert r["checked_frames"] == 4
    assert r["correct"] is False
    got = r["compared"]["unpaired_frame"]
    assert got["value"] > got["limit"]
