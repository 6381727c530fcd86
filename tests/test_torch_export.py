"""Export bundles, the AOT program and the kernels as operators, on the CPU.

``python -m densepose_tpu_torch.export`` against the JAX package's export.py
on one tiny YAML (tests/test_torch_pipeline.py::tiny_cfg written out): the
same ``.npz`` arrays bit for bit and the same ``.config.json``; each
package's bundle loaded by the other package's CLI loader; the port's
``--calib`` sidecar loaded by the JAX predictor; the port's CLI on a bundle;
the ``--aot`` program against the eager request; and ``torch.library.opcheck``
on each of the five operators.

Tolerances: detection counts, classes and validity exact; boxes, scores and
maps within tests/test_torch_pipeline.py's fp32 tolerances (the two packages
sum convolutions in different orders). A float16 bundle's parameters after
loading are equal bit for bit in the two packages. The AOT program runs the
same kernels as the eager request on the same inputs: its outputs are equal
bit for bit.
"""

import json
import re
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
yaml = pytest.importorskip("yaml")

import export as jax_export  # noqa: E402  (the JAX package's CLI at the repo root)
import run as jax_run  # noqa: E402
from densepose_tpu_torch import export, run  # noqa: E402
from densepose_tpu_torch.checkpoint.transform import params_from_jax  # noqa: E402
from densepose_tpu_torch.config import get_cfg  # noqa: E402
from densepose_tpu_torch.models.rcnn import densepose_bucket  # noqa: E402
from densepose_tpu_torch.ops import (bias_relu, conv_int8, nms, resize, roi_align,  # noqa: E402
                                     roi_align_sparse)
from densepose_tpu_torch.predictor import DensePosePredictor  # noqa: E402
from tests.test_torch_pipeline import ATOL, RTOL, tiny_cfg  # noqa: E402
from tests.torch_cases import op_args, op_cases  # noqa: E402

torch.set_num_threads(2)

STEM = "tiny_flagship"
# at this score threshold the bundle's weights (random, seed 0) keep 1-7
# detections of frame 12 and 9-32 of frame 9 (64x64): two DensePose buckets
MIN_SCORE = "0.51025"
AOT_FRAMES = {12: 8, 9: 32}  # frame seed -> its DensePose bucket
CALIB_SEEDS = (1, 2)


def image(seed, h=64, w=64):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def run_cli(main, argv, cwd):
    """A CLI's ``main()`` in process, with ``argv`` and ``cwd``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cwd)
        mp.setattr(sys, "argv", ["prog"] + argv)
        main()


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The tiny flagship as a YAML, exported by both CLIs (fp32 and --fp16);
    the port's fp32 export also calibrates (over a stale sidecar) and writes
    the 64x64 program. Returns {(package, "fp32"|"fp16"): bundle path}."""
    root = tmp_path_factory.mktemp("export")
    cfg_path = root / f"{STEM}.yaml"
    cfg_path.write_text(yaml.safe_dump(json.loads(json.dumps(tiny_cfg(get_cfg).dump_dict()))))
    for seed in CALIB_SEEDS:
        cv2.imwrite(str(root / f"calib{seed}.png"), image(seed))
    jax_dir, port_dir = root / "jax", root / "port"
    (port_dir / "exported").mkdir(parents=True)
    jax_dir.mkdir()
    stale = port_dir / "exported" / f"{STEM}_fp32.npz.calib.json"
    stale.write_text(json.dumps({"format": "densepose-tpu-int8-calib", "scales": {"x": 1.0}}))
    common = [str(cfg_path), "--min_score", MIN_SCORE]
    for fp16 in ([], ["--fp16"]):
        run_cli(jax_export.main, common + fp16, jax_dir)
    run_cli(export.main, common + ["--cpu", "--aot", "64x64", "--calib"]
            + [str(root / f"calib{s}.png") for s in CALIB_SEEDS], port_dir)
    run_cli(export.main, common + ["--fp16"], port_dir)
    return {(pkg, fp): str(d / "exported" / f"{STEM}_{fp}.npz")
            for pkg, d in (("jax", jax_dir), ("port", port_dir)) for fp in ("fp32", "fp16")}


@pytest.mark.parametrize("fp", ["fp32", "fp16"])
def test_bundles_equal_across_packages(exported, fp):
    """The two export CLIs write the same arrays (names, dtypes, bits) and the
    same config."""
    j, p = exported[("jax", fp)], exported[("port", fp)]
    with np.load(j) as zj, np.load(p) as zp:
        assert sorted(zj.files) == sorted(zp.files)
        for k in zj.files:
            assert zj[k].dtype == zp[k].dtype == (np.float16 if fp == "fp16" else np.float32)
            assert np.array_equal(zj[k], zp[k]), k
    with open(j + ".config.json") as fj, open(p + ".config.json") as fp_:
        assert json.load(fj) == json.load(fp_)


def detections_agree(got, want):
    """Port numpy outputs against the JAX package's: counts and classes exact,
    boxes, scores and maps within the fp32 parity tolerance."""
    assert got["num_instances"] == want["num_instances"] >= 1
    np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], atol=1e-3, rtol=RTOL)
    for k in ("coarse_segm", "fine_segm", "u", "v"):
        key = f"pred_densepose_{k}"
        np.testing.assert_allclose(got[key], np.asarray(want[key], np.float32), atol=ATOL,
                                   rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("fp", ["fp32", "fp16"])
def test_bundles_cross_load(exported, fp):
    """Each package's CLI loader on the other package's bundle. A float16
    bundle computes in float16 in both (its config says so): the loaded
    parameters are the same float16 values, FrozenBN folded in float64 from
    the stored float16 weights. The requests then run in float32 (``--fp32``):
    random weights tie the tiny net's scores below float16's resolution, and
    the two packages' float16 roundings reorder them (ROADMAP queue 3)."""
    jpred = jax_run.load_predictor(exported[("port", fp)], "", False, [])
    pred = run.load_predictor(exported[("jax", fp)], "", [], device="cpu")
    assert pred.cfg.TPU.COMPUTE_DTYPE == jpred.cfg.TPU.COMPUTE_DTYPE == \
        ("float16" if fp == "fp16" else "float32")
    want = params_from_jax({k: np.asarray(v) for k, v in jpred.params.items()})
    got = pred.model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.from_numpy(v).dtype and \
            torch.equal(got[k], torch.from_numpy(v)), k
    jpred = jax_run.load_predictor(exported[("port", fp)], "", True, [])
    pred = run.load_predictor(exported[("jax", fp)], "", [], device="cpu", fp32=True)
    for seed in AOT_FRAMES:
        img = image(seed)
        detections_agree(pred.predict_numpy(img), jpred.predict_numpy(img))


def test_calib_sidecar_loads_into_jax(exported):
    """The port's ``--calib`` replaced the stale sidecar with scales of every
    INT8_HEAD site, which the JAX predictor loads from beside the bundle."""
    from densepose_tpu.predictor import DensePosePredictor as JaxPredictor
    bundle = exported[("port", "fp32")]
    with open(bundle + ".calib.json") as f:
        scales = json.load(f)["scales"]
    assert "x" not in scales
    opts = ["TPU.INT8_HEAD", "True"]
    pred = run.load_predictor(bundle, "", opts, device="cpu")
    assert pred.calibration_source == "sidecar"
    jpred = jax_run.load_predictor(bundle, "", False, opts)
    assert isinstance(jpred, JaxPredictor) and jpred.calibration_source == "sidecar"
    state = pred.int8_state()
    assert set(scales) == set(pred.export_calibration()) and len(scales) == \
        tiny_cfg(get_cfg).MODEL.ROI_DENSEPOSE_HEAD.NUM_STACKED_CONVS
    for k, v in scales.items():
        assert np.float32(jpred.params[k]) == np.float32(v) == state[k].item(), k


def test_cli_runs_a_bundle(exported, tmp_path):
    img_path = tmp_path / "in.jpg"
    cv2.imwrite(str(img_path), image(3))
    run.main([exported[("jax", "fp32")], str(img_path), "--cpu"])
    out = cv2.imread(str(tmp_path / "in_pred.jpg"))
    assert out is not None and out.shape == (64, 64, 3)


def test_aot_program_equals_eager(exported):
    """``export --aot 64x64`` wrote the request as a program; ``aot_load``
    runs it on frames whose DensePose stage takes two different buckets of
    the program's nested ``torch.cond``, with the same outputs as the eager
    request bit for bit, and the program takes only its size. K1 and K2 are
    nodes of the program, as its operators, and so is U1 (the decoder's and
    predictor's 2x upsamples)."""
    bundle = exported[("port", "fp32")]
    path = bundle[:-len(".npz")] + "_64x64.pt2"
    graphs = [m.code for _, m in torch.export.load(path).graph_module.named_modules()
              if hasattr(m, "code")]
    ops = {n for code in graphs for n in re.findall(r"densepose_tpu_torch\.(\w+)", code)}
    assert ops == {"nms_keep", "roi_align", "upsample2x"}  # the kernels are its operators
    assert sum("torch.ops.higher_order.cond" in code for code in graphs) == 2
    with open(path, "rb") as f:
        program = DensePosePredictor.aot_load(f.read())
    pred = run.load_predictor(bundle, "", [], device="cpu")
    buckets = set()
    for seed, bucket in AOT_FRAMES.items():
        img = image(seed)
        got, want = program(img), pred(img)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
        buckets.add(densepose_bucket(int(want["num_instances"]), 40))
        assert buckets.issuperset({bucket})
    assert buckets == set(AOT_FRAMES.values())
    with pytest.raises(Exception):
        program(image(3, 64, 80))


@pytest.mark.parametrize("case", range(len(op_cases())))
def test_opcheck(case):
    """``torch.library.opcheck`` (schema, fake kernel, autograd registration,
    AOT dispatch) on each operator at a tiny shape, and the operator equal
    to its kernel's plain version (U1's CPU kernel is ``F.interpolate``,
    which rounds as the plain version at the case's odd planes)."""
    name, args = op_cases()[case]
    args = op_args(args)
    op = getattr(torch.ops.densepose_tpu_torch, name)
    torch.library.opcheck(op, args)
    plain = {"nms_keep": lambda: nms.nms_keep_plain(*args),
             "roi_align": lambda: roi_align.roi_align_plain(*args),
             "roi_align_sparse": lambda: roi_align_sparse.roi_align_sparse_plain(*args),
             "conv_s8": lambda: conv_int8.conv_s8_plain(
                 *args[:4], stride=args[4], padding=args[5], dilation=args[6],
                 transposed=args[7], relu=args[8], out_kind=conv_int8.out_kind_of(args[9])),
             "upsample2x": lambda: resize.upsample2x_plain(*args),
             "bias_relu": lambda: bias_relu.bias_relu_plain(*args)}
    assert torch.equal(op(*args), plain[name]())

