"""The port's evaluation (``densepose_tpu_torch/evaluation.py``, ``python -m
densepose_tpu_torch.evaluate``) on the CPU.

The copied metric functions against the JAX package's on
tests/test_evaluation.py's fixtures (equal results); then the port's CLI, in
process, on a synthetic COCO-DensePose set whose ground truth is the JAX
predictor's own detections on the same frames (tests/torch_cases.py::
self_annotations), with the same weights: box AP 100; the ``--geodesics``
hook; and the exit code on a ``TEST.EXPECTED_RESULTS`` miss.
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import run as jax_run  # noqa: E402  (the JAX package's CLI at the repo root)
from densepose_tpu import evaluation as jax_evaluation  # noqa: E402
from densepose_tpu.visualizer import DensePoseResultExtractor as JaxExtractor  # noqa: E402
from densepose_tpu_torch import evaluate, evaluation  # noqa: E402
from densepose_tpu_torch.checkpoint.transform import random_torch_state  # noqa: E402
from densepose_tpu_torch.config import get_cfg  # noqa: E402
from densepose_tpu_torch.models.rcnn import build_model  # noqa: E402
from tests.test_evaluation import _make_gt, _pred_from_gt  # noqa: E402
from tests.test_realscale_parity import DETECTION_TAME  # noqa: E402
from tests.test_torch_pipeline import tiny_cfg  # noqa: E402
from tests.torch_cases import self_annotations  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEODESICS = os.path.join(REPO, "tools", "geodesics_example.py")
FRAMES = (3, 4, 5)  # seeds of the 64x64 synthetic frames


def _dp(ann, labels, uv, **kw):
    return [{"pred_boxes_xywh": np.array([ann["bbox"]]), "scores": np.array([0.9]),
             "labels": [labels], "uv": [uv]}], [[dict(ann, **kw)]]


def metric_cases():
    """(function name, args) of tests/test_evaluation.py's fixtures."""
    a = lambda *rows: np.array(rows, float)  # noqa: E731
    gt1 = [a([10, 10, 50, 60], [70, 20, 120, 90])]
    cases = [
        ("coco_box_ap", ([{"pred_boxes": gt1[0].copy(), "scores": np.array([0.9, 0.8])}], gt1)),
        ("coco_box_ap", ([{"pred_boxes": a([10, 10, 50, 60], [200, 200, 250, 260]),
                           "scores": np.array([0.6, 0.9])}], [a([10, 10, 50, 60])])),
        ("coco_box_ap", ([{"pred_boxes": a([0, 0, 80, 80]), "scores": np.array([0.9])}],
                         [a([0, 0, 100, 100])])),
        ("coco_box_ap", ([{"pred_boxes": a([0, 0, 10, 10]), "scores": np.array([0.9])},
                          {"pred_boxes": np.zeros((0, 4)), "scores": np.zeros((0,))}],
                         [a([0, 0, 10, 10]), a([5, 5, 30, 30])])),
        ("coco_box_ap", ([{"pred_boxes": a([0, 0, 10, 10], [20, 0, 30, 7.7], [50, 50, 60, 60]),
                           "scores": np.array([0.9, 0.8, 0.7])}],
                         [a([0, 0, 10, 10], [20, 0, 30, 10])])),
        ("coco_box_ap", ([{"pred_boxes": a([50, 50, 60, 60], [0, 0, 10, 10]),
                           "scores": np.array([0.5, 0.5])}], [a([0, 0, 10, 10])])),
        ("rle_decode", ({"size": [4, 3], "counts": "236N"},)),
        ("rle_decode", ({"size": [4, 3], "counts": b"236N"},)),
        ("rle_decode", ({"size": [102, 1], "counts": "T32"},)),
        ("rle_decode", ({"size": [2, 3], "counts": [2, 3, 1]},)),
        ("check_expected_results", ({"bbox": {"AP": 59.27}},
                                    [("bbox", "AP", 59.27, 0.025), ("bbox", "AP", 60.0, 0.025),
                                     ("densepose_gps", "AP", 60.11, 0.02)])),
        ("planar_uv_distance", (np.array([3, 3, 0, 4]), np.array([.5, .5, .5, .1]),
                                np.array([.5, .5, .5, .2]), np.array([3, 4, 3, 4]),
                                np.array([.5, .8, .5, .4]), np.array([.5, .5, .5, .6]))),
    ]
    ann = _make_gt([10, 20, 80, 120])
    labels, uv = _pred_from_gt(ann)
    cases.append(("densepose_ap", _dp(ann, labels, uv) + ("gps",)))
    cases.append(("densepose_ap", _dp(ann, np.where(labels > 0, labels + 1, 0), uv) + ("gps",)))
    ann = _make_gt([0, 0, 100, 100])
    labels, uv = _pred_from_gt(ann)
    cases.append(("densepose_ap", _dp(ann, labels, uv + 0.35) + ("gps",)))
    cases.append(("densepose_ap", _dp(ann, labels, uv, mask=np.ones((32, 32), bool))
                  + ("gpsm",)))
    cases.append(("densepose_ap", _dp(ann, np.where(labels > 0, labels, 3), uv,
                                      dp_masks=[{"size": [4, 4], "counts": [0, 16]}])
                  + ("gpsm",)))
    cases.append(("densepose_ap", _dp(ann, labels, uv) + ("gpsm",)))
    cases.append(("densepose_ap", _dp(ann, np.zeros_like(labels), uv * 0)
                  + ("gps", lambda *p: np.zeros(np.shape(p[0])))))
    preds = [{"pred_boxes_xywh": np.array([ann["bbox"], [200.0, 200.0, 50, 50]]),
              "scores": np.array([0.8, 0.95]), "labels": [labels, np.zeros_like(labels)],
              "uv": [uv, np.zeros_like(uv)]}]
    cases.append(("densepose_ap", (preds, [[ann, {"bbox": np.array([200.0, 200, 50, 50]),
                                                  "dp_x": []}]], "gps")))
    return cases


def same(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("case", range(len(metric_cases())))
def test_metrics_equal_jax(case):
    """Each copied function gives the JAX package's result on its fixture."""
    name, args = metric_cases()[case]
    want = getattr(jax_evaluation, name)(*args)
    got = getattr(evaluation, name)(*args)
    assert same(got, want), (name, got, want)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The tiny flagship as an exported bundle, with random weights (seed 0)
    whose detection layers are tamed (tests/test_realscale_parity.py::
    DETECTION_TAME: untamed, the random net gives degenerate boxes that no
    box AP can match); three square frames as PNG files (on a tiny frame
    that is not square, the RPN's swapped (W, H) clip, a reference quirk,
    leaves zero-width boxes); annotations whose ground truth is the JAX
    predictor's detections on them, from the same bundle."""
    root = tmp_path_factory.mktemp("eval")
    cfg = tiny_cfg(get_cfg)
    spec = build_model(cfg).spec()
    state = random_torch_state(spec, seed=0)
    for k in state:
        for prefix, f in DETECTION_TAME.items():
            if k.startswith(prefix + "."):
                state[k] = state[k] * np.float32(f)
    bundle = str(root / "tiny_flagship_fp32.npz")
    np.savez(bundle, **state)
    with open(bundle + ".config.json", "w") as f:
        json.dump(cfg.dump_dict(), f)
    jpred, extractor = jax_run.load_predictor(bundle, "", False, []), JaxExtractor()
    images, predictions = [], []
    for i, seed in enumerate(FRAMES):
        img = (np.random.RandomState(seed).rand(64, 64, 3) * 255).astype(np.uint8)
        cv2.imwrite(str(root / f"im{i}.png"), img)
        images.append({"id": i, "file_name": f"im{i}.png", "height": 64, "width": 64})
        out = jpred.predict_numpy(img)
        predictions.append((i, out, extractor(out)))
    boxes = np.concatenate([out["pred_boxes"] for _, out, _ in predictions])
    assert len(boxes) >= 3 and (boxes[:, 2:] - boxes[:, :2] >= 1).all(), boxes
    ann_path = root / "ann.json"
    ann_path.write_text(json.dumps({"images": images,
                                    "annotations": self_annotations(predictions)}))
    return bundle, str(ann_path), str(root)


def run_cli(dataset, capsys, *extra):
    """The port's evaluate CLI in process on the CPU; (the results JSON,
    stdout, stderr)."""
    bundle, ann_path, img_dir = dataset
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["evaluate", bundle, ann_path, img_dir, "--cpu", *extra])
        evaluate.main()
    out, err = capsys.readouterr()
    return json.loads(out[out.index("{"):out.rindex("}") + 1]), out, err


def test_cli_flow_on_jax_ground_truth(dataset, capsys):
    """The port's detections are the JAX package's: box AP 100 on ground truth
    made of the JAX predictor's boxes. The planar-UV warning is printed."""
    res, _, err = run_cli(dataset, capsys)
    assert res["bbox"]["AP"] == 100.0, res
    assert sorted(res) == ["bbox", "densepose_gps", "densepose_gpsm"]
    assert res["densepose_gps"]["AP50"] == 100.0, res
    assert "PLANAR-UV STAND-IN" in err


def test_geodesics_hook(dataset, capsys):
    """``--geodesics file.py::fn``: a metric of zero distance everywhere
    matches every detection, so GPS and GPSm AP are 100; no stand-in warning."""
    res, _, err = run_cli(dataset, capsys, "--geodesics", GEODESICS + "::build_zero")
    assert res["densepose_gps"]["AP"] == res["densepose_gpsm"]["AP"] == 100.0, res
    assert "PLANAR-UV STAND-IN" not in err


@pytest.mark.parametrize("value,code", [(100.0, None), (50.0, 1)])
def test_expected_results(dataset, capsys, value, code):
    """``TEST.EXPECTED_RESULTS`` met: exit 0 with a note; missed: exit 1,
    naming the metric. ``--max-images`` evaluates the first images only."""
    opts = ["--max-images", "2", "--opts", "TEST.EXPECTED_RESULTS",
            f"[['bbox', 'AP', {value}, 0.01]]"]
    if code is None:
        assert "EXPECTED_RESULTS check passed" in run_cli(dataset, capsys, *opts)[1]
        return
    with pytest.raises(SystemExit) as exc:
        run_cli(dataset, capsys, *opts)
    assert exc.value.code == code
    assert "bbox/AP: got 100.0000, expected 50.0000" in capsys.readouterr().out
