"""Batched frames in the port (``DensePosePredictor.predict_batch``,
``GeneralizedRCNN.forward_batch``, ``parallel/mesh.py::data_parallel_forward``,
the batched streaming loop and ``--batch``) against the JAX package on the CPU,
at tests/test_torch_pipeline.py's tiny flagship (D = 40 slots, so the
switched DensePose stage's buckets are 8, 32 and 40).

The JAX package's ``predict_batch`` vmaps ``forward`` with its defaults (the
switched stage and the device postprocess off, predictor.py:612-616) on one
device, and shards the same over its ``data`` mesh when the batch is a
multiple of the device count: with tests/conftest.py's 8 virtual devices, a
batch of 3 takes the vmap route and a batch of 8 the data-parallel one. The
port's batch must give the same outputs: the raw maps of all D slots.

Both packages get the same weights (the JAX package's ``load_params``, with
the box classifier's weights scaled and its bias zeroed so that the scores
spread: random weights tie them within 1e-5), and the frames are chosen so
that their detection counts fall in different DensePose buckets.

Tolerances (fp32, as tests/test_torch_pipeline.py): detection counts,
validity and classes exact; scores and maps within 1e-4; boxes within 1e-3
absolute. Within the port, a batch against the same frames alone: bit for
bit with oneDNN off (the CPU's convolutions then compute each frame and each
row alone; oneDNN picks other algorithms at other batch sizes); at float16
within tests/test_torch_dtype.py's rule, 4 units in the last place at the
output's largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from densepose_tpu.config import get_cfg as jax_get_cfg
from densepose_tpu.models.rcnn import build_model as jax_build_model
from densepose_tpu.models.roi_heads import box_stage_forward as jax_box_stage
from densepose_tpu.models.rpn import rpn_forward as jax_rpn_forward
from densepose_tpu.predictor import DensePosePredictor as JaxPredictor
from densepose_tpu.predictor import load_params as jax_load_params
from densepose_tpu_torch import run, visualizer
from densepose_tpu_torch.checkpoint.transform import params_from_jax
from densepose_tpu_torch.config import get_cfg as port_get_cfg
from densepose_tpu_torch.models.rcnn import batch_tensor, densepose_bucket
from densepose_tpu_torch.models.roi_heads import box_stage_forward_batch
from densepose_tpu_torch.ops import library  # noqa: F401  (registers the operators)
from densepose_tpu_torch.ops import roi_align, roi_align_sparse
from densepose_tpu_torch import predictor
from densepose_tpu_torch.parallel.pipeline import dispatch_batch, stream
from densepose_tpu_torch.predictor import DensePosePredictor, data_parallel_devices
from tests.test_torch_dtype import EPS, ULPS
from tests.test_torch_pipeline import ATOL, RTOL, SEED, image, jax_features, nchw, tiny_cfg
from tests.test_torch_variants import variant_cfg
from tests.torch_cases import batched_pooler_cases

torch.set_num_threads(2)

D = 40
DEEPLAB = "densepose_rcnn_R_50_FPN_DL_s1x"
CANDIDATES = list(range(20, 30))  # frame seeds the chosen frames come from (and 3 flat frames)
MARGIN = 1e-4  # the least distance of a chosen frame's score from the threshold


def spread(jparams):
    """The weights with the box classifier's weights x60 and its bias 0, so
    that the detection scores spread over ~0.46-0.50 instead of tying."""
    out = dict(jparams)
    out["roi_heads.box_predictor.cls_score.weight"] = \
        jparams["roi_heads.box_predictor.cls_score.weight"] * np.float32(60)
    out["roi_heads.box_predictor.cls_score.bias"] = \
        np.zeros_like(jparams["roi_heads.box_predictor.cls_score.bias"])
    return out


def with_opts(cfg, *opts):
    cfg = cfg.clone()
    cfg.defrost()
    cfg.merge_from_list(list(opts))
    cfg.freeze()
    return cfg


def choose_frames(port):
    """A score threshold and three frames whose detection counts under it
    fall in the buckets 8, 32 and 40, the rest of the candidates after them:
    the threshold lies midway between the first frame's 6th and 7th scores,
    and no chosen frame has a score within MARGIN of it. The counts follow
    from the scores at a low threshold: NMS and the top-D keep the highest."""
    frames = [image(s, 64, 64) for s in CANDIDATES] + [np.full((64, 64, 3), v, np.uint8)
                                                        for v in (0, 96, 192)]
    scores = [np.sort(port.predict_numpy(f)["scores"])[::-1] for f in frames]
    thr = float((scores[0][5] + scores[0][6]) / 2)

    def count(s):
        return min(D, int((s > thr).sum()))

    def clear(s):
        return np.abs(s - thr).min() > MARGIN

    chosen = [0]
    for bucket in (32, 40):
        chosen.append(next(i for i, s in enumerate(scores)
                           if densepose_bucket(count(s), D) == bucket and clear(s)))
    assert clear(scores[0]), "the first frame's scores crowd the threshold"
    rest = [i for i in range(len(frames)) if i not in chosen]
    return thr, [frames[i] for i in chosen + rest], [count(scores[i]) for i in chosen]


@pytest.fixture(scope="module")
def flagship():
    """(JAX predictor, port predictor, frames, counts of the first three)."""
    jparams = spread(jax_load_params(tiny_cfg(jax_get_cfg), seed=SEED))
    probe = DensePosePredictor(with_opts(tiny_cfg(port_get_cfg),
                                         "MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.05),
                               device="cpu", params=params_from_jax(jparams))
    thr, frames, counts = choose_frames(probe)
    opts = ("MODEL.ROI_HEADS.SCORE_THRESH_TEST", thr)
    jpred = JaxPredictor(with_opts(tiny_cfg(jax_get_cfg), *opts), params=jparams)
    port = DensePosePredictor(with_opts(tiny_cfg(port_get_cfg), *opts), device="cpu",
                              params=params_from_jax(jparams))
    return jpred, port, frames, counts


@pytest.fixture(scope="module")
def deeplab(flagship):
    """DeepLab with TPU.DEVICE_POSTPROCESS, which a batch does not run."""
    extra = [("TPU.DEVICE_POSTPROCESS", True)]
    jcfg, pcfg = variant_cfg(jax_get_cfg, DEEPLAB, extra), variant_cfg(port_get_cfg, DEEPLAB,
                                                                        extra)
    jparams = jax_load_params(jcfg, seed=SEED)
    return (JaxPredictor(jcfg, params=jparams),
            DensePosePredictor(pcfg, device="cpu", params=params_from_jax(jparams)))


def check_against_jax(got, want, b):
    """A port batch against a JAX batch: the same keys, every output (B, ...),
    detections exact, boxes and scores within the fp32 tolerances, the maps
    (NHWC in the JAX package) on all D rows within ATOL / RTOL."""
    want = {k: np.asarray(v) for k, v in want.items()}
    assert sorted(got) == sorted(want)
    for k in ("num_instances", "valid", "image_size"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    valid = want["valid"]
    np.testing.assert_array_equal(got["pred_classes"].numpy()[valid],
                                  want["pred_classes"][valid])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["pred_boxes"].numpy()[valid], want["pred_boxes"][valid],
                               atol=1e-3, rtol=RTOL)
    np.testing.assert_array_equal(got["det_packed"].numpy()[:, :, 6], want["det_packed"][:, :, 6])
    maps = [k for k in want if k.startswith("pred_densepose_")]
    assert maps
    for k in maps:
        w = np.transpose(want[k], (0, 1, 4, 2, 3))
        assert got[k].shape == w.shape and w.shape[:2] == (b, D), k
        np.testing.assert_allclose(got[k].numpy(), w, atol=ATOL, rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("route", ["vmap", "data_parallel", "deeplab_postprocess"])
def test_predict_batch_matches_jax(flagship, deeplab, route, monkeypatch):
    """The port's batch against the JAX package's ``predict_batch``: at B = 3
    the JAX vmap route (3 frames in the buckets 8, 32 and 40); at B = 8 the
    JAX data-parallel route over its 8 virtual devices against the port's
    ``predict_batch`` split by ``data_parallel_forward`` over two replicas on
    the CPU (``data_parallel_devices`` set to list the CPU twice, as the
    card count would list the cards); and DeepLab with
    TPU.DEVICE_POSTPROCESS, whose batch, as the JAX one, returns the raw
    maps. Every map row is compared, also past a frame's valid detections,
    where the switched per-frame stage leaves zeros."""
    jpred, port, frames, counts = flagship
    assert [densepose_bucket(n, D) for n in counts] == [8, 32, 40]
    if route == "deeplab_postprocess":
        jpred, port = deeplab
    b = 8 if route == "data_parallel" else 3
    batch = np.stack(frames[:b])
    assert len(jax.devices()) == 8 and (b % 8 == 0) == (route == "data_parallel")
    want = jpred.predict_batch(batch)
    if route == "data_parallel":
        cpu = torch.device("cpu")
        monkeypatch.setattr(predictor, "data_parallel_devices", lambda device: [cpu, cpu])
        port._data_parallel = None
        got = port.predict_batch(batch)
        forward = port._data_parallel
        assert len(forward.replicas) == 2 and forward.replicas[0] is port.model
        with pytest.raises(ValueError, match="does not split"):
            forward(batch_tensor(batch[:3], "cpu"))
        port._data_parallel = None
    else:
        got = port.predict_batch(batch)
    check_against_jax(got, want, b)
    if route == "vmap":
        np.testing.assert_array_equal(got["num_instances"].numpy(), counts)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_poolers_with_a_frame_index(sparse, dtype):
    """K2's and K3's plain versions on (N, C, H, W) levels with a frame index
    equal, box for box, their calls on each frame's (C, H, W) levels, bit for
    bit; one frame's (1, C, H, W) levels without an index give the (C, H, W)
    call's output; a frame index out of range, or none for N > 1, raises."""
    feats, boxes, levels, index, scales = batched_pooler_cases()
    fn = roi_align_sparse.roi_align_sparse_plain if sparse else roi_align.roi_align_plain
    feats = [torch.from_numpy(f).to(dtype) for f in feats]
    b, lv, fr = (torch.from_numpy(a) for a in (boxes, levels, index))
    got = fn(feats, b, lv, scales, (7, 7), 2, True, fr)
    assert got.dtype == dtype and got.shape == (len(boxes), 8, 7, 7)
    for i in range(feats[0].shape[0]):
        sel = (fr == i).nonzero()[:, 0]
        one = fn([f[i] for f in feats], b[sel], lv[sel], scales, (7, 7), 2, True)
        assert torch.equal(got[sel], one), i
    single = fn([f[1] for f in feats], b, lv, scales, (7, 7), 2, True)
    assert torch.equal(fn([f[1:2] for f in feats], b, lv, scales, (7, 7), 2, True), single)
    with pytest.raises(ValueError, match="frame index"):
        fn(feats, b, lv, scales, (7, 7), 2, True)
    with pytest.raises(ValueError, match="frame index"):
        fn(feats, b, lv, scales, (7, 7), 2, True, torch.full_like(fr, feats[0].shape[0]))


def test_poolers_route_the_frame_index(monkeypatch):
    """The routers hand the frame index to the pooler they pick (K3's with
    DENSEPOSE_TPU_SPARSE_POOLER set, for the multi-level pooler only), and a
    single frame's call hands it None."""
    feats, boxes, levels, index, scales = batched_pooler_cases(channels=4)
    feats = [torch.from_numpy(f) for f in feats]
    b, lv, fr = (torch.from_numpy(a) for a in (boxes, levels, index))
    calls = []
    for mod, name in [(roi_align_sparse, "roi_align_sparse_plain"),
                      (roi_align, "roi_align_plain")]:
        inner = getattr(mod, name)

        def spy(*args, inner=inner, name=name):
            calls.append((name, len(args), args[-1] is None))
            return inner(*args)

        monkeypatch.setattr(mod, name, spy)
    monkeypatch.setenv("DENSEPOSE_TPU_SPARSE_POOLER", "1")
    roi_align.roi_align_multilevel(feats, b, lv, scales, (7, 7), 2, True, fr)
    roi_align.roi_align_single(feats[0], b, 0.25, (5, 5), 2, True, fr)
    roi_align.roi_align_single(feats[0][0], b, 0.25, (5, 5), 2, True)
    assert calls == [("roi_align_sparse_plain", 8, False), ("roi_align_plain", 8, False),
                     ("roi_align_plain", 8, True)]


@pytest.mark.parametrize("name", ["roi_align", "roi_align_sparse"])
def test_opcheck_with_a_frame_index(name):
    """``torch.library.opcheck`` on the ROIAlign operators with the frame
    index (schema, fake kernel, AOT dispatch), equal to the plain version."""
    feats, boxes, levels, index, scales = batched_pooler_cases(channels=4, m=12)
    args = ([torch.from_numpy(f) for f in feats], torch.from_numpy(boxes),
            torch.from_numpy(levels), scales, [7, 7], 2, True, torch.from_numpy(index))
    op = getattr(torch.ops.densepose_tpu_torch, name)
    torch.library.opcheck(op, args)
    plain = roi_align.roi_align_plain if name == "roi_align" else \
        roi_align_sparse.roi_align_sparse_plain
    assert torch.equal(op(*args), plain(*args))


def frame_by_frame(pred, frames):
    """Each frame through ``forward_batch`` alone (B = 1)."""
    with torch.inference_mode():
        return [pred.model.forward_batch(batch_tensor(f[None], pred.device)) for f in frames]


@pytest.mark.parametrize("mode", ["head", "max_serving"])
def test_int8_batch_equals_frames(flagship, mode):
    """A calibrated int8 tiny model (INT8_HEAD + INT8_PREDICTOR; max serving
    adds INT8_BACKBONE + INT8_RPN, so the backbone's and the RPN's s8 links
    take N = B) batched equals its frames alone bit for bit, the head's and
    predictor's links over B * D rows; an uncalibrated predictor calibrates
    on the batch's first frame."""
    _, port, frames, _ = flagship
    opts = ["TPU.INT8_HEAD", True, "TPU.INT8_PREDICTOR", True]
    if mode == "max_serving":
        opts += ["TPU.INT8_BACKBONE", True, "TPU.INT8_RPN", True]
    pred = DensePosePredictor(with_opts(port.cfg, *opts), device="cpu",
                              params=port.model.state_dict())
    ref = DensePosePredictor(with_opts(port.cfg, *opts), device="cpu",
                             params=port.model.state_dict())
    with torch.backends.mkldnn.flags(enabled=False):
        batch = pred.predict_batch(np.stack(frames[:3]))
        assert pred.calibration_source == "auto-single-frame"
        singles = frame_by_frame(pred, frames[:3])
        ref.calibrate_int8(frames[:1])
    for k, v in ref.int8_state().items():
        assert torch.equal(pred.int8_state()[k], v), k
    for i, one in enumerate(singles):
        for k, v in one.items():
            assert torch.equal(batch[k][i], v[0]), (i, k)


def test_float16_batch_equals_frames(flagship):
    """At float16 a batch against its frames alone, oneDNN on (its
    algorithms depend on the batch size): detections exact, the maps within
    4 units in the last place of float16 at their largest magnitude."""
    _, port, frames, _ = flagship
    pred = DensePosePredictor(with_opts(port.cfg, "TPU.COMPUTE_DTYPE", "float16"),
                              device="cpu", params=port.model.state_dict())
    batch = pred.predict_batch(np.stack(frames[:3]))
    singles = frame_by_frame(pred, frames[:3])
    for i, one in enumerate(singles):
        for k, v in one.items():
            got, want = batch[k][i], v[0]
            if k.startswith("pred_densepose_"):
                assert got.dtype == torch.float16
                tol = ULPS * EPS["float16"] * float(want.float().abs().max())
                np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=tol,
                                           rtol=0, err_msg=k)
            elif k in ("pred_boxes", "scores", "det_packed"):
                np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3, rtol=RTOL,
                                           err_msg=k)
            else:
                assert torch.equal(got, want), (i, k)


class Recording:
    """A visualizer that keeps what the loop hands it."""

    def __init__(self, fetch=None):
        self.outs, self.fetch = [], fetch

    def visualize(self, frame, host_outputs):
        self.outs.append(host_outputs)
        return frame.copy()

    def fetch_keys(self):
        return self.fetch


def same_detections(a, b, n_maps_atol=ATOL):
    """Two frames' host outputs: detections exact, maps within the fp32
    tolerance (the monolithic stage against the switched one)."""
    assert sorted(a) == sorted(b)
    for k in a:
        if k.startswith("pred_densepose_"):
            np.testing.assert_allclose(a[k], b[k], atol=n_maps_atol, rtol=RTOL, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_data_parallel_devices(monkeypatch):
    """``predict_batch``'s devices: a CPU predictor's one device; on four
    cards, every card from the predictor's own, so that a predictor on
    cuda:2 gets its batch back on cuda:2."""
    assert data_parallel_devices(torch.device("cpu")) == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert data_parallel_devices(torch.device("cuda", 2)) == [
        torch.device("cuda", i) for i in (2, 3, 0, 1)]


def test_dispatch_batch(flagship):
    """The frames a dispatch of ``stream`` takes: the batch asked for; for 0
    the device count of a CUDA predictor, 1 on the CPU; 1 for a predictor
    without ``predict_batch`` (the TTA wrapper), whatever was asked."""
    _, port, _, _ = flagship

    class FrameByFrame:
        device = torch.device("cpu")

    assert [dispatch_batch(port, b) for b in (0, 1, 3)] == [1, 1, 3]
    assert [dispatch_batch(FrameByFrame(), b) for b in (0, 4)] == [1, 1]


@pytest.mark.parametrize("fetch", [None, ("pred_densepose_fine_segm",)])
def test_stream_in_pairs(flagship, fetch):
    """``stream(..., batch=2)`` over 3 frames (the second group padded with
    its last frame, the padded rows dropped) hands the visualizer what the
    frame-by-frame loop does: the detections exactly, the valid rows' maps
    within the fp32 tolerance; the frames counted after the first dispatch."""
    _, port, frames, _ = flagship
    runs = []
    for batch in (1, 2):
        rec = Recording(fetch)
        written = []
        with torch.backends.mkldnn.flags(enabled=False):
            t_frames, seconds = stream(port, rec, frames[:3], written.append, batch=batch)
        assert len(written) == 3 and t_frames == 3 - batch and seconds > 0
        runs.append(rec.outs)
    for a, b in zip(*runs):
        same_detections(a, b)


def test_cli_batch_video(flagship, tmp_path, monkeypatch, capsys):
    """``--batch 2`` through the CLI on a 3-frame video writes 3 frames and
    reports the batch it ran."""
    cv2 = pytest.importorskip("cv2")
    _, port, _, _ = flagship
    monkeypatch.setattr(run, "load_predictor", lambda *args, **kw: port)
    writer = cv2.VideoWriter(str(tmp_path / "clip.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (64, 48))
    for i in range(3):
        writer.write(image(60 + i, 48, 64))
    writer.release()
    rec = Recording()
    monkeypatch.setattr(visualizer, "End2EndVisualizer", lambda **kw: rec)
    run.main([str(tmp_path / "cfg.yaml"), str(tmp_path / "clip.mp4"), "--cpu", "--batch", "2"])
    assert "batch=2)" in capsys.readouterr().out
    assert len(rec.outs) == 3
    cap = cv2.VideoCapture(str(tmp_path / "clip_pred.mp4"))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3
    cap.release()


def test_cls_agnostic_box_stage_matches_jax():
    """``ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG`` with three classes (one box
    regression shared by the classes, the class-aware NMS): the port's box stage
    on two frames at once against the JAX box stage on each, given the JAX
    features and proposals."""
    opts = ("MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG", True, "MODEL.ROI_HEADS.NUM_CLASSES", 3,
            "MODEL.DENSEPOSE_ON", False, "MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.05)
    jcfg, pcfg = with_opts(tiny_cfg(jax_get_cfg), *opts), with_opts(tiny_cfg(port_get_cfg),
                                                                     *opts)
    jparams = spread(jax_load_params(jcfg, seed=SEED))  # the classes' scores apart
    assert jparams["roi_heads.box_predictor.bbox_pred.weight"].shape[-1] == 4
    port = DensePosePredictor(pcfg, device="cpu", params=params_from_jax(jparams))
    jmodel = jax_build_model(jcfg)
    jp = {k: jnp.asarray(v) for k, v in jparams.items()}
    stage = jax.jit(lambda p, f, b, v: jax_box_stage(p, f, b, v, jcfg))
    rpn = jax.jit(lambda p, f: jax_rpn_forward(p, f, (64, 64), jcfg))
    feats, props, pvalid, wants = [], [], [], []
    for seed in (11, 12):
        f, hw = jax_features(jmodel, jp, jcfg, image(seed, 64, 64))
        assert hw == (64, 64)
        pb, _, pv = rpn(jp, f)
        feats.append(f)
        props.append(np.asarray(pb))
        pvalid.append(np.asarray(pv))
        wants.append([np.asarray(a) for a in stage(jp, f, pb, pv)])
    with torch.no_grad():
        got = box_stage_forward_batch(
            port.model.roi_heads, {k: torch.cat([nchw(f[k]) for f in feats]) for k in feats[0]},
            torch.from_numpy(np.stack(props)), torch.from_numpy(np.stack(pvalid)), pcfg)
    for i, (wb, wsc, wc, wv) in enumerate(wants):
        gb, gsc, gc, gv = (a[i].numpy() for a in got)
        np.testing.assert_array_equal(gv, wv)
        assert wv.sum() >= 1
        np.testing.assert_array_equal(gc[wv], wc[wv])
        np.testing.assert_allclose(gsc, wsc, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(gb[wv], wb[wv], atol=1e-3, rtol=RTOL)
