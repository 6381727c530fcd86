"""Q1's routing rule, and the int8 head combined with the other serving modes,
held against the JAX package on the CPU.

Q1 (``ops/conv_int8.py``, the s8 convolution of the int8 serving mode) has
two variants on the card, and ``q1_variant`` picks one before the launch by a
fixed rule on the shapes: "wgmma" wherever ``wgmma_takes`` the shape (Cin a
multiple of 16, the im2col box's corners and offsets in range), else
"mma_sync". The rule is held at every site shape ``chip_smoke.py`` times
(``Q1_SITES``: the head's sites must take wgmma) and at HRNet-W40's Cin 40
and 600 (mma_sync), and ``wgmma_takes`` at the edges of each precondition.

Then the tiny flagship's int8 head (``TPU.INT8_HEAD`` + ``INT8_PREDICTOR``)
under geometry bucketing, ``TPU.BUCKETED_DENSEPOSE`` and TTA, and the tiny
R101 legacy model's 14x14 int8 head with the multi-level poolers on K3's
plain version (``DENSEPOSE_TPU_SPARSE_POOLER``; the JAX package gathers on
the CPU), end to end against the JAX package. Both packages run the same
weights and the same calibrated scales: the port calibrates, and the JAX
predictor loads the port's sidecar. Tolerances as tests/test_torch_int8.py
states them: detection counts and classes exact, scores within the fp32
tolerance, boxes within 1e-3, the maps within QUANT_RTOL of their largest
magnitude with at most FLIP_SHARE of them past the fp32 tolerance (an fp
conv summed in another order may round a value across an s8 boundary).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from densepose_tpu import tta as jax_tta
from densepose_tpu.config import get_cfg as jax_get_cfg
from densepose_tpu.predictor import DensePosePredictor as JaxPredictor
from densepose_tpu.predictor import load_params as jax_load_params
from densepose_tpu_torch import tta
from densepose_tpu_torch.checkpoint.transform import params_from_jax
from densepose_tpu_torch.config import get_cfg as port_get_cfg
from densepose_tpu_torch.ops import conv_int8, roi_align_sparse
from densepose_tpu_torch.predictor import DensePosePredictor
from tests.test_torch_int8 import HEAD_INT8, near
from tests.test_torch_pipeline import ATOL, RTOL, SEED, image
from tests.test_torch_variants import variant_cfg

torch.set_num_threads(2)


def _chip_smoke():
    """chip_smoke.py at the repo's root, loaded by path (it imports torch
    only inside its functions)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _chip_smoke()
Q1_SITES = {site[0]: site for site in CHIP_SMOKE.Q1_SITES}


def site_variant(site):
    _, n, h, w, cin, cout, k, stride, pad, dil, transposed, *_ = site
    return conv_int8.q1_variant((n, h, w, cin), (cout, k, k, cin), stride=stride, padding=pad,
                                dilation=dil, transposed=transposed)


# ---------------------------------------------------------------------------
# the routing rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(Q1_SITES))
def test_q1_variant_at_chip_smoke_sites(name):
    """Every timed site: wgmma where Cin is a multiple of 16 (all of
    Q1_SITES' widths, the head's sites among them), as the rule says."""
    site = Q1_SITES[name]
    want = "wgmma" if site[4] % 16 == 0 else "mma_sync"
    assert site_variant(site) == want
    if name in CHIP_SMOKE.Q1_WGMMA_SITES:
        assert want == "wgmma"


def test_head_sites_are_timed():
    """The sites chip_smoke.py requires on wgmma are timed sites, and they
    cover the head: its first link, the links at 8, 32 and 100 rows, the last
    link and the GN link."""
    assert set(CHIP_SMOKE.Q1_WGMMA_SITES) <= set(Q1_SITES)
    assert {"head_first_100", "head_link_8", "head_link_32", "head_link_100",
            "head_last_100", "gn_link_100"} == set(CHIP_SMOKE.Q1_WGMMA_SITES)


# HRNet-W40's narrow branch (Cin 40) and its HRFPN reduction (Cin 600): TMA's
# global strides must be multiples of 16 bytes, so these stay on mma_sync
@pytest.mark.parametrize("x_shape,w_shape", [
    ((1, 208, 272, 40), (40, 3, 3, 40)),
    ((1, 208, 272, 600), (256, 1, 1, 600)),
], ids=["hrnet_w40_branch_40", "hrnet_w40_reduction_600"])
def test_q1_variant_narrow_hrnet_w40(x_shape, w_shape):
    pad = w_shape[1] // 2
    assert not conv_int8.wgmma_takes(x_shape, w_shape, padding=pad)
    assert conv_int8.q1_variant(x_shape, w_shape, padding=pad) == "mma_sync"


@pytest.mark.parametrize("x_shape,w_shape,geo,takes", [
    ((1, 9, 9, 16), (8, 3, 3, 16), dict(padding=1), True),            # the least Cin
    ((1, 9, 9, 24), (8, 3, 3, 24), dict(padding=1), False),           # Cin 24
    ((1, 33, 33, 16), (8, 1, 1, 16), dict(stride=8), True),           # the largest stride
    ((1, 33, 33, 16), (8, 1, 1, 16), dict(stride=9), False),
    ((1, 300, 300, 16), (8, 3, 3, 16), dict(padding=127, dilation=127), True),
    ((1, 300, 300, 16), (8, 3, 3, 16), dict(padding=128, dilation=128), False),  # corner -128..127
    ((1, 300, 300, 16), (8, 2, 2, 16), dict(padding=0, dilation=255), False),    # offset 255
    ((100, 28, 28, 512), (77, 4, 4, 512), dict(stride=2, padding=1, transposed=True), True),
    ((1, 5, 5, 64), (8, 3, 3, 64), dict(stride=2, padding=1, transposed=True), False),  # odd Ho
    ((1, 5, 5, 64), (8, 3, 3, 64), dict(stride=2, padding=0, transposed=True), False),  # Ho 11
    ((1, 5, 5, 64), (8, 1, 1, 64), dict(stride=2, transposed=True), False),  # classes with no tap
    ((65535, 8, 16, 16), (8, 1, 1, 16), {}, True),                    # 65535 M tiles of 128
    ((65536, 8, 16, 16), (8, 1, 1, 16), {}, False),                   # past the grid's y extent
], ids=["cin16", "cin24", "stride8", "stride9", "corner127", "corner128", "offset255",
        "deconv", "deconv_odd", "deconv_odd_p0", "deconv_no_tap", "m_tiles", "m_tiles_over"])
def test_wgmma_takes_edges(x_shape, w_shape, geo, takes):
    """wgmma_takes at each precondition's edge (csrc/conv_s8.cu::plan_wgmma
    checks the same on the card)."""
    assert conv_int8.wgmma_takes(x_shape, w_shape, **geo) is takes
    assert conv_int8.q1_variant(x_shape, w_shape, **geo) == ("wgmma" if takes else "mma_sync")


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On the CPU no variant is asked for: conv_s8 runs the plain version and
    counts no launch."""
    g = torch.Generator().manual_seed(0)
    qx = torch.randint(-127, 128, (1, 6, 6, 32), generator=g, dtype=torch.int8)
    qw = torch.randint(-127, 128, (16, 3, 3, 32), generator=g, dtype=torch.int8)
    before = (conv_int8.conv_s8_cuda.launches, dict(conv_int8.conv_s8_cuda.variant_launches))
    got = conv_int8.conv_s8(qx, qw, None, None, padding=1)
    assert torch.equal(got, conv_int8.conv_s8_plain(qx, qw, None, None, padding=1))
    assert (conv_int8.conv_s8_cuda.launches, conv_int8.conv_s8_cuda.variant_launches) == before
    assert set(before[1]) == set(conv_int8.Q1_VARIANTS) == {"wgmma", "mma_sync"}


# ---------------------------------------------------------------------------
# the int8 head with the other modes, against the JAX package
# ---------------------------------------------------------------------------

FLAGSHIP = "densepose_rcnn_R_50_FPN_s1x"
LEGACY = "densepose_rcnn_R_101_FPN_s1x_legacy"
CALIB_FRAME = image(21)
# two scales and flips (tests/test_torch_tta.py's AUG), 12 detection slots
AUG = [("TEST.AUG.ENABLED", True), ("TEST.AUG.MIN_SIZES", (48, 64)),
       ("TEST.AUG.MAX_SIZE", 128), ("TEST.AUG.FLIP", True), ("TEST.DETECTIONS_PER_IMAGE", 12)]


def int8_pair(name, extra, tmp_path):
    """Both packages' tiny int8 predictors on the JAX package's seed-5
    weights; the port calibrates on CALIB_FRAME, the JAX predictor loads the
    port's sidecar, so both hold the same scales."""
    extra = list(HEAD_INT8) + list(extra)
    jcfg, pcfg = variant_cfg(jax_get_cfg, name, extra), variant_cfg(port_get_cfg, name, extra)
    params = jax_load_params(jcfg, seed=SEED)
    port = DensePosePredictor(pcfg, device="cpu", params=params_from_jax(params))
    port.calibrate_int8([CALIB_FRAME])
    path = str(tmp_path / "port.calib.json")
    port.save_calibration(path)
    jpred = JaxPredictor(jcfg, params=dict(params))
    jpred.load_calibration(path)
    return jpred, port


def check_outputs(got, want):
    """Numpy outputs of the port against the JAX package's. Rows are paired
    by their boxes (lexicographic order): random weights tie scores within
    ~1e-7, and the two packages may order tied detections apart (R101
    legacy's frame 21 has three zero-width boxes at one score)."""
    n = want["num_instances"]
    assert got["num_instances"] == n >= 1
    rows = [np.lexsort(r["pred_boxes"].T[::-1]) for r in (got, want)]
    got = {k: v[rows[0]] if isinstance(v, np.ndarray) and v.shape[:1] == (n,) else v
           for k, v in got.items()}
    want = {k: v[rows[1]] if isinstance(v, np.ndarray) and v.shape[:1] == (n,) else v
            for k, v in want.items()}
    np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], atol=1e-3, rtol=RTOL)
    for k in ("coarse_segm", "fine_segm", "u", "v"):
        key = f"pred_densepose_{k}"
        assert got[key].shape == want[key].shape, key
        near(got[key], want[key], key)


def test_int8_head_with_geometry_bucketing(tmp_path):
    """TPU.GEOMETRY_BUCKET_QUANT 64: two frames of one canvas."""
    jpred, port = int8_pair(FLAGSHIP, [("TPU.GEOMETRY_BUCKET_QUANT", 64)], tmp_path)
    for seed, hw in ((40, (80, 60)), (41, (97, 61))):
        img = image(seed, *hw)
        check_outputs(port.predict_numpy(img), jpred.predict_numpy(img))


def test_int8_head_with_bucketed_densepose(tmp_path):
    """TPU.BUCKETED_DENSEPOSE: the head runs on the two-stage dispatch's
    bucket of rows, as in the JAX package."""
    jpred, port = int8_pair(FLAGSHIP, [("TPU.BUCKETED_DENSEPOSE", True)], tmp_path)
    img = image(16)
    want, got = jpred(img), port(img)
    n = int(want["num_instances"])
    rows = {np.asarray(v).shape[0] for k, v in want.items() if k.startswith("pred_densepose_")}
    assert rows == {got[k].shape[0] for k in got if k.startswith("pred_densepose_")}
    assert rows == {port.stage2_bucket(n)}
    check_outputs(port.numpy_outputs(got), jpred.numpy_outputs(want))


def test_int8_head_with_tta(tmp_path):
    """Multi-scale + flip TTA around the int8 predictors: every view's head
    on the same scales."""
    jbase, base = int8_pair(FLAGSHIP, AUG, tmp_path)
    jpred, pred = jax_tta.TTAPredictor(jbase), tta.TTAPredictor(base)
    img = image(1, 48, 64)
    check_outputs(pred.predict_numpy(img), jpred.predict_numpy(img))


def test_int8_legacy_head_on_k3_plain(tmp_path, monkeypatch):
    """R101 legacy with its 14x14 DensePose head in int8: the box pooler and
    the multi-level DensePose pooler on K3's plain version."""
    calls = []
    inner = roi_align_sparse.roi_align_sparse_plain

    def spy(*args):
        calls.append(args[1].shape[0])
        return inner(*args)

    monkeypatch.setattr(roi_align_sparse, "roi_align_sparse_plain", spy)
    monkeypatch.setenv("DENSEPOSE_TPU_SPARSE_POOLER", "1")
    jpred, port = int8_pair(LEGACY, [("MODEL.ROI_DENSEPOSE_HEAD.POOLER_RESOLUTION", 14)],
                            tmp_path)
    assert port.cfg.MODEL.ROI_DENSEPOSE_HEAD.POOLER_RESOLUTION == 14
    calls.clear()  # the calibration pass pools too
    img = image(21)
    got = port.predict_numpy(img)
    assert len(calls) == 2
    want = jpred.predict_numpy(img)
    assert got["pred_densepose_u"].shape[-1] == 56  # 14 x 2 (deconv) x 2 (upsample)
    check_outputs(got, want)


def test_q1_timeline_patches_apply():
    """tools/q1_timeline.py rebuilds the designs the wgmma variant was held
    against as text patches of csrc/conv_s8.cu: every patch still finds its
    place in the source (no CUDA needed to check that)."""
    from densepose_tpu_torch.tools import q1_timeline
    builds = q1_timeline.builds()
    assert sorted(builds) == ["elementwise", "multicast", "stamped", "tree"]
    assert builds["stamped"].count("q1_time()") == builds["elementwise"].count("q1_time()") == 5
    assert "__cluster_dims__(1, kCluster, 1)" in builds["multicast"]
    assert builds["elementwise"].count("store_out(acc[") == 2  # both variants' epilogues
    assert builds["tree"].count("store_out(acc[") == 1  # mma_sync's alone
