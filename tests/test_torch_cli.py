"""The port's CLI, video pipeline and fetch API on the CPU
(``python -m densepose_tpu_torch.run``, ``parallel/pipeline.py``,
``DensePosePredictor.numpy_outputs / start_fetch / stage_input /
predict_batch``), and the slice as a whole against the JAX package.

The predictor is tests/test_torch_pipeline.py's narrowed flagship (built once
for the module), the same config the CLI gets from the zoo name and
``NARROW_OPTS``. Only the one subprocess smoke runs the zoo name at full width
(at a tiny input size, as tests/test_e2e.py does).

Tolerances: the port's outputs on the CPU are deterministic, so the fetch
paths and batch sizes agree bit for bit. Against the JAX package: detection
counts and classes exact, boxes and scores within test_torch_pipeline.py's
fp32 tolerances, and the overlays differ in at most 0.1% of their pixels
(a SIUV map within 1e-4 can still flip an argmax near a tie, or a box edge
across an integer).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from densepose_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from densepose_tpu.predictor import DensePosePredictor as JaxPredictor  # noqa: E402
from densepose_tpu.predictor import load_params as jax_load_params  # noqa: E402
from densepose_tpu.visualizer import End2EndVisualizer as JaxVisualizer  # noqa: E402
from densepose_tpu_torch import run, visualizer  # noqa: E402
from densepose_tpu_torch.config import get_cfg  # noqa: E402
from densepose_tpu_torch.models.rcnn import densepose_bucket  # noqa: E402
from densepose_tpu_torch.parallel.pipeline import stream  # noqa: E402
from densepose_tpu_torch.predictor import DensePosePredictor  # noqa: E402
from densepose_tpu_torch.visualizer import End2EndVisualizer  # noqa: E402
from tests.test_e2e import TINY  # noqa: E402
from tests.test_torch_pipeline import ATOL, RTOL, SEED, TINY_DELTAS, tiny_cfg  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = "densepose_rcnn_R_50_FPN_s1x"
NARROW_OPTS = [s for key, value in TINY_DELTAS for s in (key, str(value))]
OVERLAY_SHARE = 1e-3  # of the pixels an overlay may differ from the JAX package's


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """A zoo name without --weights looks for its checkpoint in the cache
    only: nothing is downloaded."""
    monkeypatch.setenv("DENSEPOSE_TPU_OFFLINE", "1")


@pytest.fixture(scope="module")
def pred():
    return DensePosePredictor(tiny_cfg(get_cfg), device="cpu", seed=SEED)


def image(seed, h=64, w=64):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def assert_same(a, b, what=""):
    assert sorted(a) == sorted(b), what
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, f"{what} {k}"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def cli(*argv):
    run.main([*argv, "--cpu", "--opts", *NARROW_OPTS])


def write_video(path, n, hw=(48, 64)):
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, hw[::-1])
    rng = np.random.RandomState(0)
    for _ in range(n):
        w.write((rng.rand(*hw, 3) * 255).astype(np.uint8))
    w.release()


def frame_count(path):
    cap = cv2.VideoCapture(str(path))
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


# -- the fetch API --------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fine_segm", "u", "bbox"])
@pytest.mark.parametrize("device_pp", [False, True])
def test_packed_fetch_matches_unfiltered(pred, device_pp, mode):
    """numpy_outputs(keys) reads the detections from det_packed alone:
    the same values and dtypes as the six detection arrays."""
    p = pred
    if device_pp:
        cfg = tiny_cfg(get_cfg).clone()
        cfg.defrost()
        cfg.TPU.DEVICE_POSTPROCESS = True
        p = DensePosePredictor(cfg, device="cpu", params=pred.model.state_dict())
    out = p(image(21))
    keys = End2EndVisualizer(mode=mode).fetch_keys()
    full = p.numpy_outputs(out)
    got = p.numpy_outputs(out, keys=keys)
    assert got["num_instances"] >= 1
    assert_same(got, {k: v for k, v in full.items() if k in got})
    assert set(full) - set(got) == {k for k in full if k.startswith("pred_densepose_")
                                    and k not in keys}


def test_start_fetch_then_numpy_outputs(pred):
    """On a CPU predictor start_fetch copies nothing; the read is the same."""
    out = pred(image(22))
    keys = End2EndVisualizer().fetch_keys()
    want = pred.numpy_outputs(out, keys=keys)
    pred.start_fetch(out, keys=keys)
    assert_same(pred.numpy_outputs(out, keys=keys), want)
    assert_same(pred.numpy_outputs(pred(pred.stage_input(image(22)))), pred.predict_numpy(image(22)))
    assert_same(pred.numpy_outputs(pred(torch.from_numpy(image(22)))), pred.predict_numpy(image(22)))


@pytest.mark.parametrize("keys", [None, "fine_segm"])
@pytest.mark.parametrize("device_pp", [False, True])
def test_numpy_outputs_owns_its_arrays(pred, device_pp, keys):
    """What numpy_outputs returns holds only the valid rows, in memory of its
    own: no array is a view of the padded buffers it read (on the card,
    start_fetch's pinned copies). The streaming loop's ``copy=False`` reads
    views of them where the valid slots are a prefix."""
    p = pred
    if device_pp:
        cfg = tiny_cfg(get_cfg).clone()
        cfg.defrost()
        cfg.TPU.DEVICE_POSTPROCESS = True
        p = DensePosePredictor(cfg, device="cpu", params=pred.model.state_dict())
    out = p(image(23))
    fetch = None if keys is None else End2EndVisualizer(mode=keys).fetch_keys()
    buffers = [v.numpy() for v in out.values()]
    got = p.numpy_outputs(out, keys=fetch)
    n = got["num_instances"]
    assert n >= 1
    for k, v in got.items():
        if isinstance(v, np.ndarray):
            assert not any(np.may_share_memory(v, b) for b in buffers), k
            if k.startswith("pred_"):
                assert len(v) == n, k
    views = p.numpy_outputs(out, keys=fetch, copy=False)
    assert_same(views, got)
    prefix = bool(out["valid"][:n].all())
    for k, v in views.items():
        if k.startswith("pred_densepose_"):
            assert any(np.may_share_memory(v, b) for b in buffers) == prefix, k


def bucket_frames(pred):
    """Two frames and a score threshold under which they take different
    DensePose buckets: the threshold keeps 6 detections of the first frame,
    and the second frame is one that keeps more than 8 under it."""
    frames = [image(s) for s in range(20, 26)] + [np.full((64, 64, 3), v, np.uint8)
                                                  for v in (0, 96, 192)]
    scores = [np.sort(pred.predict_numpy(f)["scores"])[::-1] for f in frames]
    thr = float((scores[0][5] + scores[0][6]) / 2)
    second = next(i for i, s in enumerate(scores) if (s > thr).sum() > 8)
    return frames[0], frames[second], thr


def test_predict_batch_stacks_frames_of_different_buckets(pred):
    a, b, thr = bucket_frames(pred)
    cfg = tiny_cfg(get_cfg).clone()
    cfg.defrost()
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = thr
    p = DensePosePredictor(cfg, device="cpu", params=pred.model.state_dict())
    d = cfg.TEST.DETECTIONS_PER_IMAGE
    mono_cfg = cfg.clone()
    mono_cfg.TPU.SWITCHED_DENSEPOSE = False
    q = DensePosePredictor(mono_cfg, device="cpu", params=pred.model.state_dict())
    # the JAX contract (predictor.py:612-616): frame i of a batch is the
    # request of frame i with the switched DensePose stage off, all D slots;
    # with oneDNN off the CPU's convolutions compute each frame and row alone,
    # so the batch equals the single requests bit for bit
    with torch.backends.mkldnn.flags(enabled=False):
        singles = [p(a), p(b)]
        monos = [q(a), q(b)]
        batch = p.predict_batch(np.stack([a, b]))
    counts = [int(o["num_instances"]) for o in singles]
    assert len({densepose_bucket(n, d) for n in counts}) == 2, counts
    for k, v in batch.items():
        assert v.shape[0] == 2, k
        for i in range(2):
            assert torch.equal(v[i], monos[i][k]), k
            # the switched requests' valid rows: the monolithic stage's, on a
            # bucket of fewer rows (the CPU's matmuls may block it otherwise:
            # within the fp32 tolerance); the detections exactly
            if k.startswith("pred_densepose_"):
                np.testing.assert_allclose(v[i][:counts[i]].numpy(),
                                           singles[i][k][:counts[i]].numpy(), atol=ATOL,
                                           rtol=RTOL, err_msg=k)
            else:
                assert torch.equal(v[i], singles[i][k]), k
    with pytest.raises(ValueError):
        p.predict_batch(a)


def test_cuda_requested_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img_path = tmp_path / "in.jpg"
    cv2.imwrite(str(img_path), image(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main([FLAGSHIP, str(img_path), "--opts", *NARROW_OPTS])
    assert not (tmp_path / "in_pred.jpg").exists()


# -- the slice as a whole against the JAX package -------------------------------


JAX_FRAMES = (31, 32, 33)


@pytest.fixture(scope="module")
def both_outputs(pred):
    """Three frames through each package's predictor, with the same weights:
    [(frame, port numpy outputs, JAX numpy outputs)]."""
    jcfg = tiny_cfg(jax_get_cfg)
    jpred = JaxPredictor(jcfg, params=jax_load_params(jcfg, seed=SEED))
    return [(image(s, 128, 128), pred.predict_numpy(image(s, 128, 128)),
             jpred.predict_numpy(image(s, 128, 128))) for s in JAX_FRAMES]


def test_detections_match_jax(both_outputs):
    for img, got, want in both_outputs:
        n = want["num_instances"]
        assert got["num_instances"] == n >= 1
        np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
        np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], atol=1e-3, rtol=RTOL)


@pytest.mark.parametrize("mode", ["fine_segm", "u", "v"])
def test_overlays_match_jax(both_outputs, mode):
    """Each package's End2EndVisualizer (the CLI's keep_bg=False) on its own
    package's outputs of the same frame."""
    share = []
    for img, got, want in both_outputs:
        a = End2EndVisualizer(keep_bg=False, mode=mode).visualize(img.copy(), got)
        b = JaxVisualizer(keep_bg=False, mode=mode).visualize(img.copy(), want)
        assert not np.array_equal(a, img)
        share.append(float((a != b).any(-1).mean()))
    print(f"overlay pixels that differ from the JAX package's ({mode}): {share}")
    assert max(share) <= OVERLAY_SHARE, share


# -- the CLI ---------------------------------------------------------------------


def test_zoo_name_cli_subprocess(tmp_path):
    """Full width at a tiny input size, offline: random weights, a warning,
    and in_pred.jpg."""
    img_path = tmp_path / "in.jpg"
    cv2.imwrite(str(img_path), np.full((48, 64, 3), 70, np.uint8))
    env = dict(os.environ, DENSEPOSE_TPU_OFFLINE="1", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "densepose_tpu_torch.run", FLAGSHIP, str(img_path),
                        "--cpu", "--opts", *TINY], capture_output=True, text=True, env=env,
                       cwd=tmp_path, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "using random weights" in r.stderr
    assert (tmp_path / "in_pred.jpg").exists(), r.stdout


@pytest.mark.parametrize("mode", ["u", "v", "bbox"])
def test_vis_modes(tmp_path, mode):
    img_path = tmp_path / "in.png"
    cv2.imwrite(str(img_path), image(2))
    cli(FLAGSHIP, str(img_path), "--vis", mode)
    out = cv2.imread(str(tmp_path / "in_pred.png"))
    assert out.shape == (64, 64, 3) and not np.array_equal(out, image(2))


def test_directory_skips_its_outputs(tmp_path, capsys):
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"f{i}.png"), image(40 + i, 64, 64 + 16 * i))
    cv2.imwrite(str(tmp_path / "old_pred.png"), image(9))
    cli(FLAGSHIP, str(tmp_path), "--fp32")
    assert sorted(os.listdir(tmp_path)) == ["f0.png", "f0_pred.png", "f1.png", "f1_pred.png",
                                            "f2.png", "f2_pred.png", "old_pred.png"]
    err = capsys.readouterr().err
    assert err.count("enabling input-geometry bucketing") == 1
    cli(FLAGSHIP, str(tmp_path), "--no-bucket")  # again: the _pred files stay skipped
    assert len(os.listdir(tmp_path)) == 7
    assert "geometry bucketing" not in capsys.readouterr().err


@pytest.mark.parametrize("what", ["npz"])
def test_refuses_what_is_not_ported(tmp_path, what):
    """Exported bundles are ported now (tests/test_torch_export.py runs one
    through the CLI); a bundle path with no bundle there is refused before
    anything runs, naming the missing config."""
    img_path = tmp_path / "in.jpg"
    cv2.imwrite(str(img_path), image(3))
    with pytest.raises(FileNotFoundError, match=r"model\.npz\.config\.json"):
        run.main([str(tmp_path / f"model.{what}"), str(img_path), "--cpu"])
    assert not (tmp_path / "in_pred.jpg").exists()


def test_profile_writes_a_trace(tmp_path):
    img_path = tmp_path / "in.jpg"
    cv2.imwrite(str(img_path), image(4))
    cli(FLAGSHIP, str(img_path), "--profile", str(tmp_path / "prof"))
    assert (tmp_path / "in_pred.jpg").exists()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


# -- video -----------------------------------------------------------------------


def test_video_cli(tmp_path):
    write_video(tmp_path / "clip.mp4", 5)
    cli(FLAGSHIP, str(tmp_path / "clip.mp4"))
    assert frame_count(tmp_path / "clip_pred.mp4") == 5


class RecordingVisualizer:
    """Keeps the per-frame numpy outputs the pipeline hands the visualizer
    (and, with ``fetch``, asks for a filtered fetch)."""

    def __init__(self, fetch=None):
        self.outs = []
        self.fetch = fetch

    def visualize(self, frame, host_outputs):
        self.outs.append(host_outputs)
        return frame.copy()

    def fetch_keys(self):
        return self.fetch


@pytest.mark.parametrize("fetch", [None, "fine_segm"])
def test_video_batched_matches_serial(pred, tmp_path, fetch, monkeypatch, capsys):
    """``--batch 2`` over 5 frames (the tail group padded) gives the same
    bits as ``--batch 1`` on the valid detections: groups of two through
    ``predict_batch`` (the monolithic DensePose stage on every slot, whose
    valid rows are the switched stage's), with oneDNN off so that the CPU's
    convolutions compute each frame and row alone."""
    keys = None if fetch is None else End2EndVisualizer(mode=fetch).fetch_keys()
    monkeypatch.setattr(run, "load_predictor", lambda *args, **kw: pred)
    recs = []
    for batch in (1, 2):
        rec = RecordingVisualizer(keys)
        monkeypatch.setattr(visualizer, "End2EndVisualizer", lambda **kw: rec)
        write_video(tmp_path / f"b{batch}.mp4", 5)
        with torch.backends.mkldnn.flags(enabled=False):
            cli(FLAGSHIP, str(tmp_path / f"b{batch}.mp4"), "--batch", str(batch))
        assert frame_count(tmp_path / f"b{batch}_pred.mp4") == 5
        assert f"batch={batch})" in capsys.readouterr().out
        recs.append(rec.outs)
    assert len(recs[0]) == len(recs[1]) == 5
    for f, (a, b) in enumerate(zip(*recs)):
        assert_same(a, b, f"frame {f}")


def test_stream_from_memory(pred):
    """The loop without cv2: frames from a list, overlays to a callback, each
    the overlay of a synchronous predict_numpy; a failing frame source is
    raised in the caller."""
    seeds = (50, 51, 52)
    got = []
    t_frames, seconds = stream(pred, End2EndVisualizer(), [image(s) for s in seeds], got.append)
    assert t_frames == 2 and seconds > 0
    for s, vis in zip(seeds, got):
        np.testing.assert_array_equal(vis, End2EndVisualizer().visualize(
            image(s), pred.predict_numpy(image(s))))

    def broken():
        yield image(50)
        raise OSError("decode failed")
    with pytest.raises(OSError, match="decode failed"):
        stream(pred, End2EndVisualizer(), broken(), got.append)
