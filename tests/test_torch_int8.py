"""The port's int8 serving mode held against the JAX package on the CPU.

``TPU.INT8_HEAD``, ``INT8_PREDICTOR``, ``INT8_BACKBONE`` and ``INT8_RPN`` at
tiny geometry: the int8 ops (``ops/conv_int8.py``: kernel Q1's plain version
and the quantization helpers), each int8 stage given the JAX stage's inputs
with the same params and scales (the port loads the JAX predictor's
calibration through its ``.calib.json`` sidecar, and its weights through
``params_from_jax``), end to end, and the calibration API (site lists,
save / load, sidecar, validation, saturation report, auto-calibration)
mirroring tests/test_int8.py:455-675.

Tolerances, stated where they are used:
- exact: weight quantization (JAX's as the predictor jits it: ``/ 127.0``
  becomes a multiply by float32(1/127), the divisions by scales stay true),
  activation quantization, each chain link and the transposed chain, the
  stacked head chain, the predictor deconvolutions (before their fp
  upsample: 1e-6 after it), the installed calibration state, and
  detections against the port's own fp path under INT8_HEAD +
  INT8_PREDICTOR (the head is post-detection);
- ``act_stat`` "sat" within 1e-6 (a mean in another summation order);
- dynamic ``conv2d_int8`` within 1e-6 relative: XLA reassociates the
  dequantization product sx * sw with the two 1/127 constants;
- where an fp conv (summation order ~1e-7 relative) feeds a quantization,
  a value near a rounding boundary of the s8 grid may round the other way:
  FPN, RPN, HRNet, the DeepLab GN chain (one-pass statistics in another
  order) and end-to-end maps are held within QUANT_RTOL of the output's
  largest magnitude, with at most FLIP_SHARE of the elements differing by
  more than the fp32 tolerance (1e-4). The ResNet stages too: XLA's CPU
  backend contracts a block's dequantize-and-add (float(acc) * scale +
  shortcut) into one FMA, which the JAX code does not ask for; the port
  rounds the product and the sum apart, as written (1 ulp, which later
  requantizations may carry).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from densepose_tpu.config import get_cfg as jax_get_cfg
from densepose_tpu.models import fpn as jfpn
from densepose_tpu.models import hrnet as jhrnet
from densepose_tpu.models import resnet as jresnet
from densepose_tpu.models import roi_heads as jroi
from densepose_tpu.models.rcnn import build_model as jax_build_model
from densepose_tpu.models.rpn import rpn_forward as jax_rpn_forward
from densepose_tpu.ops import conv as jconv
from densepose_tpu.ops import max_pool2d as jax_max_pool2d
from densepose_tpu.predictor import DensePosePredictor as JaxPredictor
from densepose_tpu_torch.checkpoint.transform import params_from_jax
from densepose_tpu_torch.config import get_cfg as port_get_cfg
from densepose_tpu_torch.models.rcnn import build_model
from densepose_tpu_torch.models.rpn import rpn_forward
from densepose_tpu_torch.ops import conv_int8
from densepose_tpu_torch.predictor import DensePosePredictor
from tests.test_torch_variants import DL_WIDTHS, image, variant_cfg

torch.set_num_threads(2)

SEED = 5
FLAGSHIP = "densepose_rcnn_R_50_FPN_s1x"
ALL_INT8 = [("TPU.INT8_HEAD", True), ("TPU.INT8_PREDICTOR", True),
            ("TPU.INT8_BACKBONE", True), ("TPU.INT8_RPN", True)]
HEAD_INT8 = ALL_INT8[:2]
QUANT_RTOL = 2e-2
FLIP_SHARE = 0.02
ATOL = 1e-4


def nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous()


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def near(got, want, what):
    """Within QUANT_RTOL of the largest magnitude; at most FLIP_SHARE of the
    elements beyond the fp32 tolerance (a flipped s8 rounding)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    scale = float(np.abs(want).max()) + 1e-12
    assert err.max() <= QUANT_RTOL * scale, (what, err.max(), scale)
    assert np.mean(err > ATOL * (1 + np.abs(want))) <= FLIP_SHARE, (what, np.mean(err > ATOL))


class Pair:
    """Both packages' tiny predictors on one set of weights: the JAX one
    calibrated on a frame, the port one loading that calibration through
    its sidecar file."""

    def __init__(self, name, extra, tmp, frames):
        extra = list(extra) + (DL_WIDTHS if "_DL" in name else [])
        self.jcfg = variant_cfg(jax_get_cfg, name, extra)
        self.pcfg = variant_cfg(port_get_cfg, name, extra)
        self.jpred = JaxPredictor(self.jcfg, seed=SEED)
        self.fp_params = {k: np.asarray(v) for k, v in self.jpred.params.items()}
        self.jpred.calibrate_int8(frames)
        self.jp = self.jpred.params
        self.sidecar = str(tmp / f"{name}.calib.json")
        self.jpred.save_calibration(self.sidecar)
        self.port = DensePosePredictor(self.pcfg, device="cpu",
                                       params=params_from_jax(self.fp_params))
        self.port.load_calibration(self.sidecar)
        self.jmodel = jax_build_model(self.jcfg)

    def jax_input(self, img):
        x, _, hw = self.jmodel.preprocess(jnp.asarray(img), img.shape[:2])
        return x, hw


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    return Pair(FLAGSHIP, ALL_INT8, tmp_path_factory.mktemp("calib"), [image(21), image(22)])


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transposed", [False, True], ids=["conv", "deconv"])
def test_quantize_weight_matches_jitted_jax(transposed):
    """qweight and wscale bit for bit against JAX's quantize_weight_int8 as
    the predictor jits it, on weights where the reciprocal and the true
    division give other scales and other quantized values."""
    # seeds whose weights hold quotients that the two roundings split
    rng = np.random.RandomState(3 if transposed else 1)
    if transposed:  # ConvTranspose2d (Cin, Cout, kh, kw); JAX holds it flipped, HWIO
        w = (rng.randn(512, 77, 4, 4) * 0.03).astype(np.float32)
        wj = np.transpose(w, (2, 3, 0, 1))[::-1, ::-1]
    else:
        w = (rng.randn(512, 512, 3, 3) * 0.03).astype(np.float32)
        wj = np.transpose(w, (2, 3, 1, 0))
    qj, sj = jax.jit(lambda ws: {k: jconv.quantize_weight_int8(v) for k, v in ws.items()})(
        {"w": jnp.asarray(np.ascontiguousarray(wj))})["w"]
    qj, sj = np.asarray(qj), np.asarray(sj)
    qw, sw = conv_int8.quantize_weight_int8(torch.from_numpy(w), transposed=transposed)
    np.testing.assert_array_equal(sw.numpy(), sj)
    want = np.transpose(qj, (3, 0, 1, 2))
    if transposed:
        want = want[:, ::-1, ::-1, :]
    np.testing.assert_array_equal(qw.numpy(), want)
    # the weights tell the two roundings apart
    amax = np.abs(wj).max(axis=(0, 1, 2))
    assert (amax / np.float32(127) != sj).any()
    recip = np.clip(np.rint(wj * (np.float32(1) / sj)), -127, 127).astype(np.int8)
    assert (recip != qj).any()


def test_quant_act_and_stats():
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 7, 9, 24) * 3).astype(np.float32)
    s = np.float32(0.0173)
    got = conv_int8.quant_act_s8(torch.from_numpy(x), torch.tensor(s))
    want = jax.jit(jconv.quant_act_s8)(jnp.asarray(x), s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.abs(np.asarray(want)) == 127).any()  # some values clip
    mx = conv_int8.act_stat(torch.from_numpy(x), "max")
    assert float(mx) == float(jconv.act_stat(jnp.asarray(x), "max"))
    sat = conv_int8.act_stat(torch.from_numpy(x), "sat", torch.tensor(s))
    jsat = jconv.act_stat(jnp.asarray(x), "sat", {"s": s}, "s")
    assert 0 < float(jsat) and abs(float(sat) - float(jsat)) <= 1e-6
    assert float(conv_int8.act_stat(torch.from_numpy(x), "sat", None)) == 0.0


LINKS = [  # cin, cout, k, stride, padding, dilation, relu, out
    (40, 32, 3, 1, 1, 1, True, "s8"),
    (16, 24, 1, 2, 0, 1, False, "f32"),
    (32, 16, 3, 1, 2, 2, True, "f16"),
    (32, 16, 3, 1, 1, 1, False, "bf16"),
    (24, 8, 3, 1, 1, 1, False, "s8"),
]
OUT = {"f32": (None, None), "f16": (jnp.float16, torch.float16),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("case", LINKS, ids=lambda c: "-".join(map(str, c)))
def test_chain_link_matches_jax(case):
    """conv2d_int8_chain: stride 2, dilation 2, Cin 40, ReLU on and off, s8 /
    f32 / f16 / bf16 out, exactly JAX's."""
    cin, cout, k, stride, pad, dil, relu, out = case
    rng = np.random.RandomState(cin + cout)
    x = np.abs(rng.randn(2, 9, 11, cin)).astype(np.float32)
    w = (rng.randn(cout, cin, k, k) * 0.1).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    sx = np.float32(x.max() / 127)
    so = np.float32(0.05) if out == "s8" else None
    jdt, tdt = OUT.get(out, (None, None))
    qwj, swj = jax.jit(jconv.quantize_weight_int8)(jnp.asarray(np.transpose(w, (2, 3, 1, 0))))
    fn = jax.jit(lambda qx, sx, qw, sw, b, so: jconv.conv2d_int8_chain(
        qx, sx, qw, sw, b, stride=stride, padding=pad, dilation=dil, out_scale=so, relu=relu,
        out_dtype=jdt))
    want = np.asarray(fn(jconv.quant_act_s8(jnp.asarray(x), sx), sx, qwj, swj, jnp.asarray(b),
                         so).astype(jnp.float32))
    qw, sw = conv_int8.quantize_weight_int8(torch.from_numpy(w))
    got = conv_int8.conv2d_int8_chain(
        conv_int8.quant_act_s8(torch.from_numpy(x), torch.tensor(sx)), torch.tensor(sx), qw, sw,
        torch.from_numpy(b), stride=stride, padding=pad, dilation=dil,
        out_scale=None if so is None else torch.tensor(so), relu=relu, out_dtype=tdt)
    assert got.dtype == {"s8": torch.int8, "f32": torch.float32}.get(out, tdt)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("cout", [25, 77])
def test_conv_transpose_chain_matches_jax(cout):
    """conv_transpose2d_int8_chain at k4 s2 p1 (one head, and the four chart
    heads merged to 77 channels) exactly JAX's input-dilated form."""
    rng = np.random.RandomState(cout)
    x = np.abs(rng.randn(3, 7, 7, 32)).astype(np.float32)
    w = (rng.randn(32, cout, 4, 4) * 0.1).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    sx = np.float32(x.max() / 127)
    wj = np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))[::-1, ::-1])
    qwj, swj = jax.jit(jconv.quantize_weight_int8)(jnp.asarray(wj))
    want = np.asarray(jax.jit(lambda q, s, qw, sw, b: jconv.conv_transpose2d_int8_chain(
        q, s, qw, sw, b, stride=2, padding=1, kernel_size=4))(
        jconv.quant_act_s8(jnp.asarray(x), sx), sx, qwj, swj, jnp.asarray(b)))
    qw, sw = conv_int8.quantize_weight_int8(torch.from_numpy(w), transposed=True)
    got = conv_int8.conv_transpose2d_int8_chain(
        conv_int8.quant_act_s8(torch.from_numpy(x), torch.tensor(sx)), torch.tensor(sx), qw, sw,
        torch.from_numpy(b))
    assert got.shape == (3, 14, 14, cout)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dynamic_conv2d_int8_matches_jax():
    """The uncalibrated head's per-call quantization: the s8 operands are
    JAX's exactly; the result within 1e-6 of its largest magnitude (XLA
    reassociates sx * sw with its two 1/127 constants)."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 16, 8, 8).astype(np.float32)
    w = (rng.randn(24, 16, 3, 3) * 0.1).astype(np.float32)
    b = (rng.randn(24) * 0.1).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, w_, b_: jconv.conv2d_int8(a, w_, b_, padding=1))(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w.transpose(2, 3, 1, 0)),
        jnp.asarray(b)))
    got = nhwc(conv_int8.conv2d_int8(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b), padding=1))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_q1_plain_is_exact_integer_conv():
    """Q1's plain version: the int32 sums equal a direct numpy sum, for a
    strided / dilated conv and the transposed conv (ConvTranspose2d's tap
    order: output row iy * s - p + ky)."""
    rng = np.random.RandomState(2)
    qx = rng.randint(-127, 128, (1, 6, 7, 8)).astype(np.int8)
    qw = rng.randint(-127, 128, (5, 3, 3, 8)).astype(np.int8)
    got = conv_int8.conv_s8_plain(torch.from_numpy(qx), torch.from_numpy(qw), None, None,
                                  stride=2, padding=2, dilation=2).numpy()
    xp = np.pad(qx.astype(np.int64), ((0, 0), (2, 2), (2, 2), (0, 0)))
    want = np.zeros(got.shape, np.int64)
    for oy in range(got.shape[1]):
        for ox in range(got.shape[2]):
            for ky in range(3):
                for kx in range(3):
                    want[0, oy, ox] += qw[:, ky, kx].astype(np.int64) @ xp[0, oy * 2 + 2 * ky,
                                                                          ox * 2 + 2 * kx]
    np.testing.assert_array_equal(got, want)
    qw4 = rng.randint(-127, 128, (3, 4, 4, 8)).astype(np.int8)
    got = conv_int8.conv_s8_plain(torch.from_numpy(qx), torch.from_numpy(qw4), None, None,
                                  stride=2, padding=1, transposed=True).numpy()
    want = np.zeros((1, 12, 14, 3), np.int64)
    for iy in range(6):
        for ix in range(7):
            for ky in range(4):
                for kx in range(4):
                    oy, ox = iy * 2 - 1 + ky, ix * 2 - 1 + kx
                    if 0 <= oy < 12 and 0 <= ox < 14:
                        want[0, oy, ox] += qw4[:, ky, kx].astype(np.int64) @ qx[0, iy, ix]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# stages, on the JAX stage's inputs, params and scales
# ---------------------------------------------------------------------------

def test_installed_state_matches_jax(flagship):
    """The sidecar's scales and the weights quantized again on load: the
    port's int8 state equals the JAX predictor's calibrated params (through
    params_from_jax) bit for bit, key for key."""
    want = params_from_jax({k: np.asarray(v) for k, v in flagship.jp.items()
                            if conv_int8.is_int8_key(k)})
    got = {k: v.numpy() for k, v in flagship.port.int8_state().items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    assert flagship.port.calibration_source == "explicit"
    # a calibrated JAX param dict given whole: its int8 entries installed as they are
    whole = DensePosePredictor(flagship.pcfg, device="cpu", params=params_from_jax(
        {k: np.asarray(v) for k, v in flagship.jp.items()}))
    assert whole._int8_ready
    assert {k: v.numpy().tobytes() for k, v in whole.int8_state().items()} == {
        k: v.tobytes() for k, v in want.items()}


@pytest.mark.parametrize("name,extra", [
    (FLAGSHIP, ()), ("densepose_rcnn_R_50_FPN_DL_s1x", ()),
    ("densepose_rcnn_R_50_FPN_s1x_cse", ())], ids=["v1convx", "deeplab_gn", "cse"])
def test_stacked_head_chain_matches_jax(name, extra, tmp_path, flagship):
    """The head's calibrated s8 chain on the JAX pooled input: V1ConvX and
    CSE's head exactly; DeepLab's GN links (one-pass statistics summed in
    another order, then requantized) within QUANT_RTOL."""
    pair = flagship if name == FLAGSHIP else Pair(name, HEAD_INT8, tmp_path, [image(21)])
    res = pair.pcfg.MODEL.ROI_DENSEPOSE_HEAD.POOLER_RESOLUTION
    c = pair.port.model.roi_heads.densepose_head.convs()[0].in_channels
    x = np.abs(np.random.RandomState(3).randn(5, res, res, c)).astype(np.float32) * 2
    hp = "roi_heads.densepose_head"
    if name.endswith("_DL_s1x"):
        aspp = jax.jit(lambda p, x: jroi._deeplab_aspp(p, x, pair.jcfg, hp))(pair.jp,
                                                                            jnp.asarray(x))
        norm = pair.jcfg.MODEL.ROI_DENSEPOSE_HEAD.DEEPLAB.NORM
        want = jax.jit(lambda p, y: jroi._stacked_int8_chain(p, y, pair.jcfg, hp, norm=norm))(
            pair.jp, aspp)
        with torch.no_grad():
            got = pair.port.model.roi_heads.densepose_head.stack(nchw(aspp), norm=True)
        near(nhwc(got), want, "deeplab chain")
        return
    want = jax.jit(lambda p, y: jroi._stacked_int8_chain(p, y, pair.jcfg, hp))(pair.jp,
                                                                              jnp.asarray(x))
    with torch.no_grad():
        got = pair.port.model.roi_heads.densepose_head(nchw(x))
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))


def test_predictor_deconvs_match_jax(flagship, monkeypatch):
    """INT8_PREDICTOR: the port's one merged 77-channel launch against JAX's
    four separate int8 deconvolutions: exact before the upsample; after it
    within 1e-6 (the bilinear upsample rounds in another order, as on the fp
    path)."""
    cfg, jp = flagship.jcfg, flagship.jp
    pp = "roi_heads.densepose_predictor"
    c = cfg.MODEL.ROI_DENSEPOSE_HEAD.CONV_HEAD_DIM
    x = np.abs(np.random.RandomState(4).randn(6, 8, 8, c)).astype(np.float32)
    want = jax.jit(lambda p, y: jroi.densepose_predictor_forward(p, y, cfg))(jp, jnp.asarray(x))
    predictor = flagship.port.model.roi_heads.densepose_predictor
    with torch.no_grad():
        got = predictor(nchw(x))
        monkeypatch.setattr(predictor, "upsample", lambda y: y)
        raw = predictor(nchw(x))
    assert sorted(got) == sorted(want)
    qx = jconv.quant_act_s8(jnp.asarray(x), jp[f"{pp}.in_scale"])
    for k, head in zip(("coarse_segm", "fine_segm", "u", "v"),
                       ("ann_index_lowres", "index_uv_lowres", "u_lowres", "v_lowres")):
        h = f"{pp}.{head}"
        deconv = jconv.conv_transpose2d_int8_chain(
            qx, jp[f"{pp}.in_scale"], jp[f"{h}.qweight"], jp[f"{h}.wscale"], jp[f"{h}.bias"],
            stride=2, padding=1, kernel_size=4)
        np.testing.assert_array_equal(nhwc(raw[k]), np.asarray(deconv), err_msg=k)
        np.testing.assert_allclose(nhwc(got[k]), np.asarray(want[k]), atol=1e-6, rtol=1e-6,
                                   err_msg=k)


def test_resnet_int8_stages_match_jax(flagship):
    """res2..res5 as the s8 chain on the JAX stem's output: every stage's
    output within QUANT_RTOL of JAX's (XLA's CPU FMA in the residual add, see
    the module docstring), most of it exact."""
    cfg, jp = flagship.jcfg, flagship.jp
    x, _ = flagship.jax_input(image(23))
    prefix = "backbone.bottom_up"
    stem = jax.jit(lambda p, x: jax_max_pool2d(jax.nn.relu(jresnet.stem_conv_norm(
        p, f"{prefix}.stem.conv1", x)), kernel_size=3, stride=2, padding=1))(jp, x)
    want = jax.jit(lambda p, s: jresnet._resnet_int8_stages(
        p, s, cfg, prefix, ("res2", "res3", "res4", "res5")))(jp, stem)
    bottom_up = flagship.port.model.backbone.bottom_up
    assert bottom_up.int8_active()
    with torch.no_grad():
        got = bottom_up._int8_stages(nchw(stem[None] if stem.ndim == 3 else stem))
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        w = w if w.ndim == 4 else w[None]
        near(nhwc(got[k]), w, k)
        assert np.mean(nhwc(got[k]) == w) > 0.5, k


def test_fpn_and_rpn_match_jax(flagship, monkeypatch):
    """The int8 FPN output convs on the JAX bottom-up's outputs (fp laterals
    in another summation order before the quantization: QUANT_RTOL), then the
    int8 RPN conv per level on the JAX features: proposals within the fp32
    tolerance, validity exact."""
    cfg, jp = flagship.jcfg, flagship.jp
    x, hw = flagship.jax_input(image(23))
    levels, bottom_up = jax.jit(lambda p, x: jfpn._fpn_levels(p, x, cfg, "backbone"))(jp, x)
    fpn = flagship.port.model.backbone
    assert fpn.int8_active()
    feats = {k: nchw(v[None] if v.ndim == 3 else v) for k, v in bottom_up.items()}
    monkeypatch.setattr(fpn.bottom_up, "forward", lambda _: feats)
    with torch.no_grad():
        got = fpn(torch.zeros(1))
    monkeypatch.undo()
    for k, v in levels.items():
        near(nhwc(got[k]), np.asarray(v)[None] if v.ndim == 3 else v, k)
    jfeats = jax.jit(lambda p, x: jfpn.fpn_forward(p, x, cfg))(jp, x)
    props, _, pvalid = jax.jit(lambda p, f: jax_rpn_forward(p, f, hw, cfg))(jp, jfeats)
    with torch.no_grad():
        gp, _, gv = rpn_forward(flagship.port.model.proposal_generator.rpn_head,
                                {k: nchw(v[None] if v.ndim == 3 else v)
                                 for k, v in jfeats.items()}, hw, flagship.pcfg)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(pvalid))
    v = np.asarray(pvalid)
    np.testing.assert_allclose(gp.numpy()[v], np.asarray(props)[v], atol=1e-3, rtol=ATOL)


NARROW_HRNET = [
    ("MODEL.HRNET.STAGE2.NUM_CHANNELS", [8, 40]),
    ("MODEL.HRNET.STAGE3.NUM_CHANNELS", [8, 40, 16]),
    ("MODEL.HRNET.STAGE4.NUM_CHANNELS", [8, 40, 16, 32]),
    ("MODEL.HRNET.STAGE2.NUM_MODULES", 1), ("MODEL.HRNET.STAGE3.NUM_MODULES", 1),
    ("MODEL.HRNET.STAGE4.NUM_MODULES", 1),
    ("MODEL.HRNET.STAGE2.NUM_BLOCKS", [1, 1]), ("MODEL.HRNET.STAGE3.NUM_BLOCKS", [1, 1, 1]),
    ("MODEL.HRNET.STAGE4.NUM_BLOCKS", [1, 1, 1, 1]),
    ("MODEL.HRNET.HRFPN.OUT_CHANNELS", 32), ("TPU.INT8_BACKBONE", True)]


def test_hrnet_int8_matches_jax(tmp_path, monkeypatch):
    """HRNet with a 40-wide branch under INT8_BACKBONE: the site list and
    quantized convs equal the JAX lists, the installed state JAX's, and the
    five HRFPN levels on the same input within QUANT_RTOL (the fp stem and
    fusions feed quantizations)."""
    monkeypatch.setenv("DENSEPOSE_TPU_NO_PACKED_STEM", "1")
    name = "densepose_rcnn_HRFPN_HRNet_w32_s1x"
    pair = Pair(name, NARROW_HRNET, tmp_path, [image(21)])
    cfg = pair.jcfg
    from densepose_tpu_torch.models import hrnet
    assert hrnet.hrnet_int8_scale_sites(pair.pcfg) == jhrnet.hrnet_int8_scale_sites(cfg)
    assert hrnet.hrnet_int8_quant_bases(pair.pcfg) == jhrnet.hrnet_int8_quant_bases(
        cfg, pair.fp_params)
    want = params_from_jax({k: np.asarray(v) for k, v in pair.jp.items()
                            if conv_int8.is_int8_key(k)})
    got = {k: v.numpy() for k, v in pair.port.int8_state().items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    x, _ = pair.jax_input(image(24))
    jl = jax.jit(lambda p, x: jhrnet.hrfpn_forward(p, x, cfg))(pair.jp, x)
    with torch.no_grad():
        gl = pair.port.model.backbone(nchw(x[None] if x.ndim == 3 else x))
    for k in jl:
        near(nhwc(gl[k]), np.asarray(jl[k])[None] if jl[k].ndim == 3 else jl[k], k)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

def test_end_to_end_head_and_predictor(tmp_path):
    """INT8_HEAD + INT8_PREDICTOR: detections bit-identical to the port's fp
    request on the same weights, the maps within QUANT_RTOL of the JAX int8
    predictor's, and inside tests/test_int8.py's envelope of the fp maps."""
    pair = Pair(FLAGSHIP, HEAD_INT8, tmp_path, [image(21)])
    fp = DensePosePredictor(variant_cfg(port_get_cfg, FLAGSHIP), device="cpu",
                            params=params_from_jax(pair.fp_params))
    for seed, hw in [(21, (64, 64)), (22, (80, 60))]:
        img = image(seed, *hw)
        got, base = pair.port.predict_numpy(img), fp.predict_numpy(img)
        want = pair.jpred.predict_numpy(img)
        for k in ("num_instances", "pred_boxes", "scores", "pred_classes"):
            np.testing.assert_array_equal(got[k], base[k], err_msg=k)
        assert got["num_instances"] == want["num_instances"] >= 1
        for k in ("coarse_segm", "fine_segm", "u", "v"):
            key = f"pred_densepose_{k}"
            near(got[key], want[key], key)
        u8, u32 = got["pred_densepose_u"], base["pred_densepose_u"]
        assert np.abs(u8 - u32).max() / (np.abs(u32).max() + 1e-9) < 0.15


def test_int8_configs_build():
    """Every TPU.INT8_* flag builds a model (the port refused them before
    int8 was ported)."""
    for key, _ in ALL_INT8:
        cfg = variant_cfg(port_get_cfg, FLAGSHIP, [(key, True)])
        assert build_model(cfg) is not None


# ---------------------------------------------------------------------------
# the calibration API (tests/test_int8.py:455-675 against the port)
# ---------------------------------------------------------------------------

def port_pair(tmp_path, extra):
    """A JAX and a port predictor on the JAX package's seed-5 weights."""
    jcfg = variant_cfg(jax_get_cfg, FLAGSHIP, extra)
    pcfg = variant_cfg(port_get_cfg, FLAGSHIP, extra)
    jpred = JaxPredictor(jcfg, seed=SEED)
    params = {k: np.asarray(v) for k, v in jpred.params.items()}
    return jpred, DensePosePredictor(pcfg, device="cpu", params=params_from_jax(params)), params


def test_site_lists_match_jax(flagship):
    """_group_sites, _required_scale_keys and the quantized convs equal the
    JAX lists letter for letter."""
    jpred, port = flagship.jpred, flagship.port
    n_head = len(port._group_sites("head", 3))
    for group, count in [("head", n_head), ("backbone", None), ("fpn", None)]:
        count = count or len(jpred._group_sites(group, len(
            {"backbone": jresnet.resnet_int8_scale_sites(jpred.cfg),
             "fpn": sum(jfpn.fpn_int8_scale_sites(jpred.cfg), [])}[group])))
        assert port._group_sites(group, count) == jpred._group_sites(group, count)
    assert port._required_scale_keys() == jpred._required_scale_keys(jpred.params)
    installed = {k[:-len(".qweight")] for k in port.int8_state() if k.endswith(".qweight")}
    assert installed == set(jpred._int8_quant_bases(jpred.params))
    assert set(port._int8_quant_bases(port._scale_names())) == installed


def test_save_load_roundtrip(tmp_path):
    """Scales saved by a calibrated port predictor and loaded into a fresh
    one reproduce its int8 state and its outputs bit for bit (all four
    groups, so every group takes the derived-bases path)."""
    cfg = variant_cfg(port_get_cfg, FLAGSHIP, ALL_INT8)
    img = image(21)
    a = DensePosePredictor(cfg, device="cpu", seed=SEED)
    a.calibrate_int8([img])
    want = a.predict_numpy(img)
    path = str(tmp_path / "c.json")
    a.save_calibration(path)
    assert json.load(open(path))["format"] == "densepose-tpu-int8-calib"
    b = DensePosePredictor(cfg, device="cpu", seed=SEED)
    assert not b._int8_ready
    b.load_calibration(path)
    assert b._int8_ready
    sa, sb = a.int8_state(), b.int8_state()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    got = b.predict_numpy(img)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def test_sidecars_cross_packages(tmp_path):
    """A sidecar written by the JAX package loads into the port (state
    bit-identical to JAX's calibrated params), and one written by the port
    loads into the JAX package (its params then equal the port's state)."""
    jpred, port, params = port_pair(tmp_path, HEAD_INT8)
    jpred.calibrate_int8([image(21)])
    jpath = str(tmp_path / "jax.calib.json")
    jpred.save_calibration(jpath)
    port.load_calibration(jpath)
    want = params_from_jax({k: np.asarray(v) for k, v in jpred.params.items()
                            if conv_int8.is_int8_key(k)})
    got = port.int8_state()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # the other way: the port calibrates, JAX loads the port's file
    _, port2, _ = port_pair(tmp_path, HEAD_INT8)
    port2.calibrate_int8([image(22)])
    ppath = str(tmp_path / "port.calib.json")
    port2.save_calibration(ppath)
    jpred2 = JaxPredictor(variant_cfg(jax_get_cfg, FLAGSHIP, HEAD_INT8), params=dict(params))
    jpred2.load_calibration(ppath)
    mine = {k: v.numpy() for k, v in port2.int8_state().items()}
    theirs = params_from_jax({k: np.asarray(v) for k, v in jpred2.params.items()
                              if conv_int8.is_int8_key(k)})
    assert set(mine) == set(theirs)
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)


def test_sidecar_autoload(tmp_path):
    """<weights>.calib.json beside the weights loads when the predictor is
    built: no calibration pass, the same outputs."""
    cfg = variant_cfg(port_get_cfg, FLAGSHIP, HEAD_INT8)
    weights = str(tmp_path / "m.pkl")
    import pickle
    from densepose_tpu_torch.checkpoint.transform import random_torch_state
    with open(weights, "wb") as f:
        pickle.dump({"model": random_torch_state(build_model(cfg).spec(), seed=SEED)}, f)
    img = image(21)
    a = DensePosePredictor(cfg, weights_path=weights, device="cpu")
    assert not a._int8_ready and a.calibration_source is None
    a.calibrate_int8([img])
    want = a.predict_numpy(img)
    a.save_calibration(weights + ".calib.json")
    b = DensePosePredictor(cfg, weights_path=weights, device="cpu")
    assert b._int8_ready and b.calibration_source == "sidecar"
    got = b.predict_numpy(img)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def test_load_calibration_validation(tmp_path):
    """A key that is not an activation scale, a partial group, corrupt JSON,
    a non-object, another format: ValueError, and nothing installed; scales
    of groups the config does not enable are ignored and never exported; a
    bad sidecar does not make the predictor unconstructible."""
    cfg = variant_cfg(port_get_cfg, FLAGSHIP, [("TPU.INT8_HEAD", True)])
    pred = DensePosePredictor(cfg, device="cpu", seed=SEED)
    with pytest.raises(ValueError, match="not an activation-scale key"):
        pred.load_calibration({"roi_heads.densepose_head.body_conv_fcn1.weight": 1.0})
    with pytest.raises(ValueError, match="missing"):
        pred.load_calibration({"roi_heads.densepose_head.body_conv_fcn1.in_scale": 0.01})
    for text, match in [("{not json", "corrupt"), ("[1, 2, 3]", "not a JSON object"),
                        ('{"format": "something-else", "scales": {}}', "unrecognized")]:
        path = tmp_path / "bad.json"
        path.write_text(text)
        with pytest.raises(ValueError, match=match):
            pred.load_calibration(str(path))
    assert not pred._int8_ready and not pred.int8_state()
    pred.calibrate_int8([image(21)])
    scales = pred.export_calibration()
    dirty = dict(scales, **{"backbone.fpn_output2.in_scale": 0.5,
                            "proposal_generator.rpn_head.conv.in_scale_p2": 0.5})
    fresh = DensePosePredictor(cfg, device="cpu", seed=SEED)
    fresh.load_calibration(dirty)
    state = fresh.int8_state()
    assert "backbone.fpn_output2.in_scale" not in state
    assert "backbone.fpn_output2.qweight" not in state
    assert set(fresh.export_calibration()) == set(scales)
    weights = str(tmp_path / "m.pkl")
    import pickle
    with open(weights, "wb") as f:
        pickle.dump({"model": {}}, f)
    with open(weights + ".calib.json", "w") as f:
        f.write('{"format": "densepose-tpu-int8-calib", "scales": '
                '{"roi_heads.densepose_head.body_conv_fcn1.in_scale": 0.01}}')
    assert not DensePosePredictor(cfg, weights_path=weights, device="cpu")._int8_ready


def test_fpn_scales_required_without_bottleneck_sites(flagship):
    """INT8_BACKBONE requires the FPN output convs' scales with the
    bottleneck sites, as the JAX package's list (which has no depth gate for
    them)."""
    req = flagship.port._required_scale_keys()
    assert "backbone.fpn_output2.in_scale" in req
    assert "backbone.bottom_up.res2.0.conv1.in_scale" in req
    assert "proposal_generator.rpn_head.conv.in_scale_p6" in req


def test_saturation_report_and_auto_calibration(caplog):
    """Calibrated on one frame, the report is 0 at every site on that frame
    and fires exactly at the sites whose maxima another frame exceeds;
    auto-calibration warns and records its provenance."""
    import logging
    cfg = variant_cfg(port_get_cfg, FLAGSHIP, [("TPU.INT8_HEAD", True)])
    a, b = image(21), (image(21) // 10).astype(np.uint8)
    pred = DensePosePredictor(cfg, device="cpu", seed=SEED)
    with torch.inference_mode():
        walk = pred.model.forward_int8_calibration
        ma = walk(torch.from_numpy(a))["head"].numpy()
        mb = walk(torch.from_numpy(b))["head"].numpy()
    calib, probe, mc, mp = (a, b, ma, mb) if ma.max() < mb.max() else (b, a, mb, ma)
    assert (mp > mc).any()
    pred.calibrate_int8([calib])
    rep = pred.saturation_report([calib])
    assert rep and all(v == 0.0 for v in rep.values()), rep
    rep = pred.saturation_report([probe])
    for site, c, p in zip(sorted(rep), mc, mp):
        assert (rep[site] > 0.0) == (p > c), (site, c, p, rep)
    fresh = DensePosePredictor(cfg, device="cpu", seed=SEED)
    with caplog.at_level(logging.WARNING, logger="densepose_tpu_torch.predictor"):
        out = fresh.predict_numpy(b)
    assert fresh.calibration_source == "auto-single-frame"
    assert any("FIRST FRAME ONLY" in r.message for r in caplog.records)
    assert np.isfinite(out["pred_densepose_u"]).all()


def test_cli_int8_loads_sidecar(tmp_path, monkeypatch, caplog):
    """``python -m densepose_tpu_torch.run <zoo> img --weights x.pkl --opts
    TPU.INT8_HEAD True ...`` loads ``x.pkl.calib.json``: no auto-calibration
    warning, the overlay written."""
    import logging
    import pickle

    import cv2
    from densepose_tpu_torch import model_zoo, run
    from densepose_tpu_torch.checkpoint.transform import random_torch_state
    monkeypatch.setenv("DENSEPOSE_TPU_OFFLINE", "1")
    opts = ["INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "128",
            "MODEL.RPN.PRE_NMS_TOPK_TEST", "100", "MODEL.RPN.POST_NMS_TOPK_TEST", "40",
            "TEST.DETECTIONS_PER_IMAGE", "3", "TPU.INT8_HEAD", "True",
            "TPU.INT8_PREDICTOR", "True"]
    cfg = model_zoo.get_config(FLAGSHIP).clone()
    cfg.defrost()
    cfg.merge_from_list(opts)
    cfg.freeze()
    weights = str(tmp_path / "model.pkl")
    with open(weights, "wb") as f:
        pickle.dump({"model": random_torch_state(build_model(cfg).spec(), seed=SEED)}, f)
    img = image(21)
    pred = DensePosePredictor(cfg, weights_path=weights, device="cpu")
    pred.calibrate_int8([img])
    pred.save_calibration(weights + ".calib.json")
    img_path = tmp_path / "in.jpg"
    cv2.imwrite(str(img_path), img)
    with caplog.at_level(logging.WARNING, logger="densepose_tpu_torch.predictor"):
        run.main([FLAGSHIP, str(img_path), "--cpu", "--weights", weights, "--opts", *opts])
    assert (tmp_path / "in_pred.jpg").exists()
    assert not any("FIRST FRAME ONLY" in r.message for r in caplog.records)
