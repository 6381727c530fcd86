"""The port at a half compute dtype (``TPU.COMPUTE_DTYPE`` float16 and
bfloat16) held against the JAX package at the same dtype, on the CPU, at the
tiny flagship geometry of tests/test_torch_pipeline.py.

Both packages get the same weights: the JAX predictor's, cast by its
``_cast_param``, through the port's ``params_from_jax``. Inputs are made with
numpy from a seed. Each stage of the port is fed the JAX stage's inputs at
the dtype.

Tolerances. Half-precision values of the two packages differ by the
rounding of sums taken in another order (XLA's CPU kernels against
PyTorch's), so a stage's output is held within ``ULPS`` units in the last
place of the dtype at the largest magnitude of the JAX output
(``half_tol``): 2^-10 relative for float16, 2^-7 for bfloat16. Exact:
the preprocess, the poolers' plain versions against the JAX gather (one
rounding of the same fp32 sum), NMS keep masks and valid masks, detection
counts and classes.

Random weights give the tiny net detections whose scores lie within a few
units of 1e-5 of each other, below what a half-precision logit resolves: one
rounding apart in a head logit reorders them. So the RPN and the box stage
are held exactly given the JAX head's half logits and deltas (the port's
fp32 islands then take the same decisions). End to
end, which of the tiny net's near-tied candidates take the three detection
slots of tests/test_e2e.py::TINY is decided by roundings, at float16 in one
frame of three and at bfloat16 in most: the test holds counts, classes and
the ranked scores, and the maps of the detections the two packages share
(ROADMAP.md queue 3).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from densepose_tpu.config import get_cfg as jax_get_cfg
from densepose_tpu.models.fpn import fpn_forward
from densepose_tpu.models import roi_heads as jax_roi_heads
from densepose_tpu.models.rcnn import build_model as jax_build_model
from densepose_tpu.models.roi_heads import box_stage_forward as jax_box_stage
from densepose_tpu.models.rpn import rpn_forward as jax_rpn_forward
from densepose_tpu.ops import roi_align as jax_ra
from densepose_tpu.ops.conv import conv2d as jax_conv2d
from densepose_tpu.ops.conv import linear as jax_linear
from densepose_tpu.ops.pallas import roi_align_kernel as jax_rk
from densepose_tpu.predictor import DensePosePredictor as JaxPredictor
from densepose_tpu.predictor import load_params as jax_load_params
from densepose_tpu_torch import run
from densepose_tpu_torch.checkpoint.transform import params_from_jax
from densepose_tpu_torch.config import get_cfg as port_get_cfg
from densepose_tpu_torch.models.roi_heads import box_stage_forward
from densepose_tpu_torch.models.rpn import rpn_forward
from densepose_tpu_torch.ops import nms, roi_align, roi_align_sparse
from densepose_tpu_torch.ops.boxes import apply_deltas
from densepose_tpu_torch.predictor import DensePosePredictor, bfloat16_to_float32
from tests.test_torch_pipeline import SEED, TINY_DELTAS, image, tiny_cfg

torch.set_num_threads(2)

DTYPES = ("float16", "bfloat16")
JAX_DTYPES = {"float16": jnp.float16, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16}
EPS = {"float16": 2.0 ** -10, "bfloat16": 2.0 ** -7}  # a unit in the last place at 1
ULPS = 4
BOX_ATOL = 1e-3  # fp32 box decode: XLA's jit divides by a rounded reciprocal (ROADMAP queue 3)
SCORE_TOL = {"float16": 1e-4, "bfloat16": 1e-3}  # fp32 softmax of logits one rounding apart
FRAMES = [21, 22, 23]  # 64x64 frames: one JAX compile a dtype


def half_cfg(get_cfg, dtype, **extra):
    cfg = tiny_cfg(get_cfg)
    cfg.defrost()
    cfg.TPU.COMPUTE_DTYPE = dtype
    for key, value in extra.items():
        node = cfg
        *path, leaf = key.split("__")
        for p in path:
            node = node[p]
        node[leaf] = value
    cfg.freeze()
    return cfg


def half_tol(dtype, ref, ulps=ULPS):
    """``ulps`` units in the last place of ``dtype`` at the largest magnitude
    of ``ref``."""
    return ulps * EPS[dtype] * float(np.abs(np.asarray(ref, np.float32)).max())


def to_torch(a) -> torch.Tensor:
    """A JAX or numpy array, float16 or bfloat16 included, as a tensor of its
    dtype (a bfloat16 array crosses as float32, which holds it exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def nchw_features(feats):
    return {k: to_torch(v).permute(2, 0, 1)[None].contiguous() for k, v in feats.items()}


class Setup:
    def __init__(self, dtype):
        self.dtype = dtype
        self.jdt, self.tdt = JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
        self.jcfg, self.pcfg = half_cfg(jax_get_cfg, dtype), half_cfg(port_get_cfg, dtype)
        self.jpred = JaxPredictor(self.jcfg, params=jax_load_params(self.jcfg, seed=SEED))
        self.jp = self.jpred.params
        self.port = DensePosePredictor(self.pcfg, device="cpu", params=params_from_jax(
            {k: np.asarray(v) for k, v in self.jp.items()}))
        self.jmodel = jax_build_model(self.jcfg)
        self._fpn = jax.jit(lambda p, x: fpn_forward(p, x, self.jcfg))

    def preprocess(self, img):
        return self.jmodel.preprocess(jnp.asarray(img), img.shape[:2], compute_dtype=self.jdt)

    def features(self, img):
        x, _, hw = self.preprocess(img)
        return self._fpn(self.jp, x), hw


@pytest.fixture(scope="module", params=DTYPES)
def setup(request):
    return Setup(request.param)


def test_parameter_dtypes(setup):
    """Every parameter at the JAX predictor's dtype for it, name by name; the
    normalize's buffers stay float32."""
    names = dict(setup.port.model.named_parameters())
    assert names
    for name, p in names.items():
        assert str(p.dtype).removeprefix("torch.") == np.asarray(setup.jp[name]).dtype.name, name
    assert {p.dtype for p in names.values()} == {setup.tdt}
    for name in ("pixel_mean", "pixel_std"):
        assert getattr(setup.port.model, name).dtype == torch.float32


@pytest.mark.parametrize("seed,hw", [(1, (60, 80)), (2, (97, 61))])
def test_preprocess_bit_exact(setup, seed, hw):
    img = image(seed, *hw)
    want, w_hw1, w_hwp = setup.preprocess(img)
    got, g_hw1, g_hwp = setup.port.model.preprocess(torch.from_numpy(img))
    assert (g_hw1, g_hwp) == (w_hw1, w_hwp)
    assert got.dtype == setup.tdt and np.asarray(want).dtype.name == setup.dtype
    np.testing.assert_array_equal(f32(got[0].permute(1, 2, 0)), f32(want))


def _pyramid(rng, dtype, c=16, hw=(32, 48)):
    hwc = [rng.randn(hw[0] // 2 ** i, hw[1] // 2 ** i, c).astype(np.float32) for i in range(4)]
    jax_levels = [jnp.asarray(f).astype(JAX_DTYPES[dtype]) for f in hwc]
    port_levels = [to_torch(f).permute(2, 0, 1).contiguous() for f in jax_levels]
    return jax_levels, port_levels


SCALES = [1 / 4, 1 / 8, 1 / 16, 1 / 32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ratio", [2, 0])
def test_roi_align_gather_matches_jax(dtype, ratio):
    """The plain gather at the dtype: fp32 taps and sums, one rounding at
    the end, bit for bit the JAX gather's (roi_align.py:151-224) on the
    CPU, eagerly (no jit, so no reciprocal rewrite)."""
    rng = np.random.RandomState(5)
    jax_levels, port_levels = _pyramid(rng, dtype)
    xy = rng.rand(30, 2).astype(np.float32) * np.float32((180, 120))
    b = np.concatenate([xy, xy + rng.rand(30, 2).astype(np.float32) * 90 + 0.5], 1)
    b[:2] = [[-20, -10, 30, 25], [5, 5, 5.2, 5.1]]
    lv = jax_ra.assign_boxes_to_levels(jnp.asarray(b), 2, 5)
    want = jax_ra.roi_align_multilevel(jax_levels, jnp.asarray(b), lv, SCALES, (7, 7), ratio,
                                       False)
    got = roi_align.roi_align_multilevel(port_levels, torch.from_numpy(b),
                                         torch.from_numpy(np.asarray(lv)), SCALES, (7, 7),
                                         ratio, False)
    assert got.dtype == TORCH_DTYPES[dtype] and np.asarray(want).dtype.name == dtype
    np.testing.assert_array_equal(f32(got.permute(0, 2, 3, 1)), f32(want))
    # and the kernels' contract: the plain version at the dtype is the fp32
    # one on the widened levels, rounded once
    up = roi_align.roi_align_plain([f.float() for f in port_levels], torch.from_numpy(b),
                                   torch.from_numpy(np.asarray(lv)), SCALES, (7, 7), ratio,
                                   False)
    assert torch.equal(got, up.to(got.dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_sparse_plain_matches_pallas(dtype):
    """K3's plain version at the dtype against the Pallas kernel in interpret
    mode (roi_align_multilevel_sparse): weights and stage-1 rows rounded to
    the dtype, stage 2 in fp32, one rounding at the end. Stage 1 sums in
    another order in the two, so a row may round the other way: within one
    unit in the last place of the dtype at the output's magnitude."""
    rng = np.random.RandomState(9)
    jax_levels, port_levels = _pyramid(rng, dtype, c=8)
    b = np.array([[3.0, 7.5, 60.0, 41.0], [100.2, 20.1, 171.9, 118.4]], np.float32)
    lv = np.array([0, 2], np.int32)
    want = jax_rk.roi_align_multilevel_sparse(jax_levels, jnp.asarray(b), jnp.asarray(lv),
                                              SCALES, (7, 7), 2, False)
    got = roi_align_sparse.roi_align_sparse(port_levels, torch.from_numpy(b),
                                            torch.from_numpy(lv), SCALES, (7, 7), 2, False)
    assert got.dtype == TORCH_DTYPES[dtype] and np.asarray(want).dtype.name == dtype
    w = np.transpose(f32(want), (0, 3, 1, 2))
    np.testing.assert_allclose(f32(got), w, rtol=0, atol=half_tol(dtype, w, ulps=1))


class OpLog(TorchDispatchMode):
    """Records (op name, input dtypes, output dtypes) of every aten op."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))

        def dtypes(x):
            flat = x if isinstance(x, (list, tuple)) else [x]
            return [t.dtype for t in flat if isinstance(t, torch.Tensor)]

        self.ops.append((func.__name__.split(".")[0], dtypes(list(args)), dtypes(out)))
        return out


def _iou_emulated(b1, b2, dt):
    """The IoU of one pair with every intermediate rounded to ``dt``
    (tests/test_realscale_parity.py::_iou_emulated)."""
    b1, b2 = b1.astype(dt), b2.astype(dt)
    a1 = (b1[2] - b1[0]) * (b1[3] - b1[1])
    a2 = (b2[2] - b2[0]) * (b2[3] - b2[1])
    wh = np.maximum(np.minimum(b1[2:], b2[2:]) - np.maximum(b1[:2], b2[:2]), dt(0))
    inter = wh[0] * wh[1]
    return inter / ((a1 + a2) - inter)


def test_fp32_islands(setup, monkeypatch):
    """The reference's fp32 islands at the dtype (as
    tests/test_realscale_parity.py::test_fp16_fp32_islands_real_width holds
    the JAX package): over a whole forward, every exp (box decode), softmax,
    sort and top-k runs in fp32 and every NMS (K1) input is fp32, while at
    least 3/4 of the convolutions and matrix products run at the dtype.
    Then apply_deltas on half inputs equals it on their fp32 upcast, and an
    IoU pair that half-precision arithmetic puts on the wrong side of 0.5 is
    suppressed as fp32 decides it."""
    k1_inputs = []
    inner = nms.nms_keep

    def spy(boxes, valid, iou_threshold, classes=None):
        k1_inputs.append(boxes.dtype)
        return inner(boxes, valid, iou_threshold, classes)

    monkeypatch.setattr(nms, "nms_keep", spy)
    log = OpLog()
    with torch.inference_mode(), log:
        setup.port.model(torch.from_numpy(image(21)))
    names = {name for name, _, _ in log.ops}
    islands = [(name, i, o) for name, i, o in log.ops
               if name in ("exp", "_softmax", "softmax", "sort", "topk")]
    assert {"exp", "sort"} <= names and names & {"softmax", "_softmax"}, sorted(names)
    assert all(set(i) | set(o) <= {torch.float32, torch.int64} for _, i, o in islands), \
        [op for op in islands if not set(op[1]) | set(op[2]) <= {torch.float32, torch.int64}]
    assert k1_inputs and set(k1_inputs) == {torch.float32}
    heavy = [o for name, _, o in log.ops
             if name in ("conv2d", "conv_transpose2d", "convolution", "linear", "addmm", "mm")]
    assert len(heavy) > 20
    assert sum(o == [setup.tdt] for o in heavy) >= len(heavy) * 3 // 4, (len(heavy), heavy)

    rng = np.random.RandomState(7)
    d = torch.from_numpy(rng.randn(64, 4) * 0.7).to(setup.tdt)
    xy = rng.rand(64, 2) * 300
    b = torch.from_numpy(np.concatenate([xy, xy + rng.rand(64, 2) * 150 + 3], 1)).to(setup.tdt)
    w = (10.0, 10.0, 5.0, 5.0)
    got = apply_deltas(d, b, w)
    assert got.dtype == torch.float32
    assert torch.equal(got, apply_deltas(d.float(), b.float(), w))

    np_dt = np.float16  # the pair is searched for in float16, as the JAX test does
    rng = np.random.RandomState(20240819)
    for _ in range(20000):
        a = np.array([0., 0., rng.uniform(20, 200), rng.uniform(20, 200)],
                     np.float32).astype(np_dt)
        sh = float(a[2]) * rng.uniform(0.30, 0.37)
        bb = np.array([sh, 0., a[2] + sh, a[3]], np.float32).astype(np_dt)
        i16, i32 = float(_iou_emulated(a, bb, np_dt)), float(_iou_emulated(a, bb, np.float32))
        if (i16 > 0.5) != (i32 > 0.5):
            break
    else:
        pytest.fail("no float16-flipping IoU pair found")
    boxes = torch.from_numpy(np.stack([a, bb])).to(setup.tdt)
    scores = torch.tensor([0.9, 0.8]).to(setup.tdt)
    keep = nms.nms_mask(boxes, scores, torch.ones(2, dtype=torch.bool), 0.5)
    assert keep[0] and bool(keep[1]) == (not i32 > 0.5), (keep, i32)


def test_backbone_stage(setup):
    img = image(11)
    want, _ = setup.features(img)
    x, _, _ = setup.preprocess(img)
    with torch.no_grad():
        got = setup.port.model.backbone(to_torch(x).permute(2, 0, 1)[None].contiguous())
    assert sorted(got) == sorted(want) == ["p2", "p3", "p4", "p5", "p6"]
    for k in want:
        assert got[k].dtype == setup.tdt and np.asarray(want[k]).dtype.name == setup.dtype
        w = f32(want[k])
        np.testing.assert_allclose(f32(got[k][0].permute(1, 2, 0)), w, rtol=0,
                                   atol=half_tol(setup.dtype, w), err_msg=k)


def _jax_rpn_head(setup, feats):
    """The JAX RPN head's half outputs per level, computed as rpn_forward
    computes them (rpn.py:109-123): objectness (H, W, A) and deltas
    (H, W, 4A)."""
    p, prefix = setup.jp, "proposal_generator.rpn_head"

    def head(feat):
        t = jax.nn.relu(jax_conv2d(feat, p[f"{prefix}.conv.weight"], p[f"{prefix}.conv.bias"],
                                   padding=1))
        a = p[f"{prefix}.objectness_logits.bias"].shape[0]
        w = jnp.concatenate([p[f"{prefix}.objectness_logits.weight"],
                             p[f"{prefix}.anchor_deltas.weight"]], axis=-1)
        b = jnp.concatenate([p[f"{prefix}.objectness_logits.bias"],
                             p[f"{prefix}.anchor_deltas.bias"]])
        both = jax_conv2d(t, w, b)
        return both[..., :a], both[..., a:]

    return [jax.jit(head)(feats[f]) for f in setup.jcfg.MODEL.RPN.IN_FEATURES]


def test_rpn_stage(setup):
    """Given the JAX head's half logits and deltas, the port's RPN (fp32
    top-k of the upcast logits, fp32 decode, K1's plain version) gives the
    JAX package's proposals: valid mask and scores exact, boxes within the
    fp32 decode's tolerance."""
    feats, hw = setup.features(image(12, 64, 64))
    wb, ws, wv = (np.asarray(a) for a in jax.jit(
        lambda p, f: jax_rpn_forward(p, f, hw, setup.jcfg))(setup.jp, feats))
    outs = _jax_rpn_head(setup, feats)
    head = setup.port.model.proposal_generator.rpn_head
    served = {"objectness_logits": iter([o for o, _ in outs]),
              "anchor_deltas": iter([d for _, d in outs])}

    def inject(name):
        def hook(module, args, out):
            v = to_torch(next(served[name])).permute(2, 0, 1)[None].contiguous()
            assert v.shape == out.shape and v.dtype == out.dtype == setup.tdt
            return v
        return hook

    handles = [getattr(head, n).register_forward_hook(inject(n)) for n in served]
    try:
        with torch.no_grad():
            gb, gs, gv = rpn_forward(head, nchw_features(feats), hw, setup.pcfg)
    finally:
        for h in handles:
            h.remove()
    assert gb.dtype == gs.dtype == torch.float32
    np.testing.assert_array_equal(gv.numpy(), wv)
    assert wv.sum() > 10
    np.testing.assert_array_equal(gs.numpy()[wv], ws[wv])
    np.testing.assert_allclose(gb.numpy()[wv], wb[wv], atol=BOX_ATOL, rtol=1e-4)


def test_box_stage(setup, monkeypatch):
    """Given the JAX half features and proposals: the pooled features equal
    the JAX pooler's bit for bit; given also the JAX head's half class logits
    and deltas, the port's box stage (fp32 softmax and decode, K1's plain
    version, top-D) gives the JAX package's detections: valid mask and
    classes exact, scores and boxes within fp32 tolerances. The JAX stage
    runs eagerly, so that its head's values can be read (jit would fuse them
    into other roundings) and its divisions are true ones."""
    feats, hw = setup.features(image(11, 64, 64))
    props, _, pvalid = jax.jit(lambda p, f: jax_rpn_forward(p, f, hw, setup.jcfg))(
        setup.jp, feats)
    calls = []

    def linear(x, w, b=None):
        y = jax_linear(x, w, b)
        calls.append((x, y))
        return y

    monkeypatch.setattr(jax_roi_heads, "linear", linear)
    wb, wsc, wc, wv = (np.asarray(a) for a in jax_box_stage(setup.jp, feats, props, pvalid,
                                                             setup.jcfg))
    pooled, logits, deltas = calls[0][0], calls[-2][1], calls[-1][1]
    heads = setup.port.model.roi_heads
    served = {"cls_score": logits, "bbox_pred": deltas}
    seen = []

    def inject(name):
        def hook(module, args, out):
            v = to_torch(served[name])
            assert v.shape == out.shape and v.dtype == out.dtype == setup.tdt
            return v
        return hook

    handles = [getattr(heads.box_predictor, n).register_forward_hook(inject(n))
               for n in served]
    handles.append(heads.box_head.fc1.register_forward_hook(
        lambda module, args, out: seen.append(args[0])))
    try:
        with torch.no_grad():
            gb, gsc, gc, gv = (a.numpy() for a in box_stage_forward(
                heads, nchw_features(feats), torch.from_numpy(np.asarray(props)),
                torch.from_numpy(np.asarray(pvalid)), setup.pcfg))
    finally:
        for h in handles:
            h.remove()
    np.testing.assert_array_equal(f32(seen[0]), f32(pooled))
    assert gb.dtype == gsc.dtype == np.float32
    np.testing.assert_array_equal(gv, wv)
    assert wv.sum() >= 1
    np.testing.assert_array_equal(gc[wv], wc[wv])
    np.testing.assert_allclose(gsc, wsc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gb[wv], wb[wv], atol=1e-4, rtol=1e-5)


def test_densepose_stage(setup):
    """Given the JAX half features and the same boxes: the DensePose maps at
    the dtype."""
    feats, _ = setup.features(image(13))
    rng = np.random.RandomState(3)
    xy = rng.rand(40, 2).astype(np.float32) * 70
    boxes = np.concatenate([xy, xy + rng.rand(40, 2).astype(np.float32) * 40 + 2], 1)
    want = jax.jit(setup.jmodel.forward_densepose)(setup.jp, feats, jnp.asarray(boxes))
    with torch.no_grad():
        got = setup.port.model.forward_densepose(nchw_features(feats), torch.from_numpy(boxes))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        w = np.transpose(f32(want[k]), (0, 3, 1, 2))
        assert v.dtype == setup.tdt and np.asarray(want[k]).dtype.name == setup.dtype
        np.testing.assert_allclose(f32(v), w, rtol=0, atol=half_tol(setup.dtype, w), err_msg=k)


@pytest.fixture(scope="module", params=DTYPES)
def three_slots(request):
    """Both predictors at the dtype with tests/test_e2e.py::TINY's three
    detection slots."""
    dtype = request.param
    jcfg = half_cfg(jax_get_cfg, dtype, TEST__DETECTIONS_PER_IMAGE=3)
    pcfg = half_cfg(port_get_cfg, dtype, TEST__DETECTIONS_PER_IMAGE=3)
    jpred = JaxPredictor(jcfg, params=jax_load_params(jcfg, seed=SEED))
    port = DensePosePredictor(pcfg, device="cpu", params=params_from_jax(
        {k: np.asarray(v) for k, v in jpred.params.items()}))
    return dtype, jpred, port


@pytest.mark.parametrize("seed", FRAMES)
def test_end_to_end(three_slots, seed):
    """The predictor at the dtype against the JAX predictor at the dtype:
    counts, classes and image sizes exact; the ranked scores within
    SCORE_TOL; detections in fp32, maps in the dtype (bfloat16 maps widened
    exactly to float32). Which near-tied candidates take the three slots is
    decided by roundings (the module docstring), so the boxes are held as
    pairs: every port detection whose box is within
    tests/test_e2e.py::test_fp16_mode_runs' envelope (atol 2, rtol 0.1) of a
    JAX detection's has that detection's maps within half_tol, and at least
    one detection a frame pairs up."""
    dtype, jpred, port = three_slots
    img = image(seed, 64, 64)
    want, got = jpred.predict_numpy(img), port.predict_numpy(img)
    n = want["num_instances"]
    assert got["num_instances"] == n >= 1
    np.testing.assert_array_equal(got["image_size"], want["image_size"])
    np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
    assert got["pred_boxes"].dtype == got["scores"].dtype == np.float32
    np.testing.assert_allclose(np.sort(got["scores"]), np.sort(want["scores"]), rtol=0,
                               atol=SCORE_TOL[dtype])
    maps = [k for k in want if k.startswith("pred_densepose_")]
    assert len(maps) == 4
    for k in maps:
        assert got[k].dtype == (np.float16 if dtype == "float16" else np.float32), k
        assert got[k].shape == want[k].shape and np.isfinite(got[k]).all(), k
    paired = 0
    for i, box in enumerate(got["pred_boxes"]):
        close = np.abs(want["pred_boxes"] - box) <= 2.0 + 0.1 * np.abs(want["pred_boxes"])
        for j in np.nonzero(close.all(1))[0][:1]:
            paired += 1
            for k in maps:
                w = f32(want[k][j])
                np.testing.assert_allclose(f32(got[k][i]), w, rtol=0, atol=half_tol(dtype, w),
                                           err_msg=k)
    assert paired >= 1


# --- the CLI and the fetch API ---------------------------------------------

NARROW_OPTS = [s for key, value in TINY_DELTAS for s in (key, str(value))]


@pytest.fixture
def offline(monkeypatch):
    """A zoo name without --weights looks for its checkpoint in the cache
    only: nothing is downloaded."""
    monkeypatch.setenv("DENSEPOSE_TPU_OFFLINE", "1")


def test_cli_writes_half_precision_image(tmp_path, offline):
    cv2 = pytest.importorskip("cv2")
    path = tmp_path / "frame.jpg"
    img = image(31)
    cv2.imwrite(str(path), img)
    run.main(["densepose_rcnn_R_50_FPN_s1x", str(path), "--cpu", "--opts", *NARROW_OPTS,
              "TPU.COMPUTE_DTYPE", "float16"])
    out = cv2.imread(str(tmp_path / "frame_pred.jpg"))
    assert out is not None and out.shape == img.shape


def test_fp32_flag_over_half_config(offline):
    """``--fp32`` forces float32 over the config's (here --opts') half dtype."""
    opts = [*NARROW_OPTS, "TPU.COMPUTE_DTYPE", "bfloat16"]
    half = run.load_predictor("densepose_rcnn_R_50_FPN_s1x", "", opts, device="cpu")
    full = run.load_predictor("densepose_rcnn_R_50_FPN_s1x", "", opts, device="cpu", fp32=True)
    assert half.compute_dtype == torch.bfloat16 and full.compute_dtype == torch.float32
    out = full.predict_numpy(image(32))
    assert {p.dtype for p in full.model.parameters()} == {torch.float32}
    assert all(out[k].dtype == np.float32 for k in out if k.startswith("pred_densepose_"))
    assert run.parse_args(["m", "i", "--fp32"]).fp32


def test_bfloat16_fetch_widens_exactly():
    """``numpy_outputs`` of a bfloat16 predictor: float32 arrays equal to the
    device maps widened, their own memory (no view of a fetch buffer), and
    the 2-byte payload is what crosses (``start_fetch`` copies int16)."""
    pred = DensePosePredictor(half_cfg(port_get_cfg, "bfloat16"), device="cpu", seed=SEED)
    out = pred(image(33))
    res = pred.numpy_outputs(out)
    n = res["num_instances"]
    assert n >= 1
    for k in ("pred_densepose_coarse_segm", "pred_densepose_fine_segm", "pred_densepose_u",
              "pred_densepose_v"):
        assert out[k].dtype == torch.bfloat16
        want = out[k][:n].float().numpy()
        assert res[k].dtype == np.float32 and res[k].flags.owndata
        np.testing.assert_array_equal(res[k], want)
    payload = out["pred_densepose_u"].view(torch.int16).numpy()
    np.testing.assert_array_equal(bfloat16_to_float32(payload),
                                  out["pred_densepose_u"].float().numpy())
    assert not np.shares_memory(res["pred_densepose_u"], payload)


def test_unknown_compute_dtype_raises():
    cfg = tiny_cfg(port_get_cfg)
    cfg.defrost()
    cfg.TPU.COMPUTE_DTYPE = "float64"
    with pytest.raises(ValueError, match="COMPUTE_DTYPE"):
        DensePosePredictor(cfg, device="cpu", seed=SEED)
