"""Test-time augmentation of the PyTorch port (``densepose_tpu_torch/tta.py``)
held against the JAX package's (``densepose_tpu/tta.py``) on the CPU, at the
tiny flagship of tests/test_torch_pipeline.py with two scales and flips.

Exact: the unflips (the port's NCHW maps against the JAX package's NHWC
ones), the symmetry-table loader, the merge (keep mask, order, slots), the
streaming reduce against the list form (bit for bit, also against the JAX
package's ``reduce_pred_densepose``), detection counts and classes. Boxes,
scores and maps of whole requests within test_torch_pipeline.py's fp32
tolerances. Synthetic symmetry tables as tests/test_tta.py:253-282 makes
them: neither repository ships the real ones.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from densepose_tpu import tta as jax_tta
from densepose_tpu.config import get_cfg as jax_get_cfg
from densepose_tpu.models.rcnn import compute_resize
from densepose_tpu.predictor import DensePosePredictor as JaxPredictor
from densepose_tpu.predictor import load_params as jax_load_params
from densepose_tpu_torch import run, tta
from densepose_tpu_torch.checkpoint.transform import params_from_jax
from densepose_tpu_torch.config import get_cfg as port_get_cfg
from densepose_tpu_torch.parallel.pipeline import stream
from densepose_tpu_torch.predictor import DensePosePredictor
from densepose_tpu_torch.visualizer import End2EndVisualizer
from tests.test_torch_pipeline import ATOL, RTOL, SEED, TINY_DELTAS, image, tiny_cfg

torch.set_num_threads(2)

FLAGSHIP = "densepose_rcnn_R_50_FPN_s1x"
NARROW_OPTS = [s for key, value in TINY_DELTAS for s in (key, str(value))]
# two scales and flips, 12 detection slots: 48 candidates merged into 12
AUG = ["TEST.AUG.ENABLED", "True", "TEST.AUG.MIN_SIZES", "(48, 64)",
       "TEST.AUG.MAX_SIZE", "128", "TEST.AUG.FLIP", "True", "TEST.DETECTIONS_PER_IMAGE", "12"]
FRAME_HW = (48, 64)


def cfg_pair(*opts):
    out = []
    for get_cfg in (jax_get_cfg, port_get_cfg):
        cfg = tiny_cfg(get_cfg).clone()
        cfg.defrost()
        cfg.merge_from_list(list(opts))
        cfg.freeze()
        out.append(cfg)
    return out


def nhwc(t):
    return np.transpose(np.asarray(t), (0, 2, 3, 1))


def uv_tables(seed):
    """(24, 256, 256) per-part tables with distinct content per part."""
    rng = np.random.RandomState(seed)
    return rng.rand(24, 256, 256).astype(np.float32), rng.rand(24, 256, 256).astype(np.float32)


@pytest.fixture(scope="module")
def jparams():
    return jax_load_params(cfg_pair(*AUG)[0], seed=SEED)


@pytest.fixture(scope="module")
def both(jparams, tmp_path_factory):
    """{"plain" | "tables": (JAX TTAPredictor, the port's)}, same weights; the
    "tables" pair reads synthesized U/V symmetry tables from an .npz (passed
    as ``uv_symmetry``, which TPU.UV_SYMMETRY_PATH also sets)."""
    npz = str(tmp_path_factory.mktemp("uv") / "uv.npz")
    u_tab, v_tab = uv_tables(11)
    np.savez(npz, U_transforms=u_tab, V_transforms=v_tab)
    jcfg, pcfg = cfg_pair(*AUG)
    jbase = JaxPredictor(jcfg, params=dict(jparams))
    base = DensePosePredictor(pcfg, device="cpu", params=params_from_jax(jparams))
    out = {"plain": (jax_tta.TTAPredictor(jbase), tta.TTAPredictor(base)),
           "tables": (jax_tta.TTAPredictor(jbase, uv_symmetry=npz),
                      tta.TTAPredictor(base, uv_symmetry=npz))}
    # one base, so the JAX views' jitted stages are the same functions: share
    # them, and each view compiles once for the module
    out["tables"][0]._s1_cache = out["plain"][0]._s1_cache
    out["tables"][0]._s2_cache = out["plain"][0]._s2_cache
    return out


@pytest.mark.parametrize("coarse", [2, 15])
def test_unflip_chart_segm_matches_jax(coarse):
    rng = np.random.RandomState(coarse)
    cs = rng.randn(3, coarse, 5, 7).astype(np.float32)
    fs = rng.randn(3, 25, 5, 7).astype(np.float32)
    got = tta.unflip_chart_segm(torch.from_numpy(cs), torch.from_numpy(fs))
    want = jax_tta.unflip_chart_segm(jnp.asarray(nhwc(cs)), jnp.asarray(nhwc(fs)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(nhwc(g), np.asarray(w))
    assert tta.PART_SYMMETRY == jax_tta.PART_SYMMETRY
    assert tta.COARSE_SEGM_PERM_15 == jax_tta.COARSE_SEGM_PERM_15
    with pytest.raises(ValueError):
        tta.unflip_chart_segm(torch.zeros(1, 3, 2, 2), torch.zeros(1, 25, 2, 2))


def test_unflip_chart_uv_matches_jax():
    rng = np.random.RandomState(7)
    u_tab, v_tab = uv_tables(5)
    # values beyond [0, 1] that the clip takes, and bin edges
    u = (rng.rand(2, 25, 6, 9) * 1.4 - 0.2).astype(np.float32)
    v = (rng.rand(2, 25, 6, 9) * 1.4 - 0.2).astype(np.float32)
    u[0, 1, 0, :3] = [1.0, 0.0, 254.5 / 255]
    got = tta.unflip_chart_uv(torch.from_numpy(u), torch.from_numpy(v),
                              torch.from_numpy(u_tab), torch.from_numpy(v_tab))
    want = jax_tta.unflip_chart_uv(jnp.asarray(nhwc(u)), jnp.asarray(nhwc(v)),
                                   jnp.asarray(u_tab), jnp.asarray(v_tab))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(nhwc(g), np.asarray(w))


def test_load_uv_symmetry_formats(tmp_path):
    """.mat in MATLAB's cell layout, .npz and a mapping, as the JAX loader
    reads them; a missing key or another shape raises ValueError."""
    from scipy.io import savemat
    u_tab, v_tab = uv_tables(3)
    cells_u, cells_v = np.empty((1, 24), object), np.empty((1, 24), object)
    for i in range(24):
        cells_u[0, i], cells_v[0, i] = u_tab[i].astype(np.float64), v_tab[i].astype(np.float64)
    mat = str(tmp_path / "uv.mat")
    savemat(mat, {"U_transforms": cells_u, "V_transforms": cells_v})
    npz = str(tmp_path / "uv.npz")
    np.savez(npz, U_transforms=u_tab, V_transforms=v_tab)
    for source in (mat, npz, {"U_transforms": u_tab, "V_transforms": v_tab}):
        got, want = tta.load_uv_symmetry(source), jax_tta.load_uv_symmetry(source)
        for k in ("U_transforms", "V_transforms"):
            assert got[k].dtype == np.float32 and got[k].shape == (24, 256, 256)
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_allclose(got["U_transforms"], u_tab, atol=1e-6)
    with pytest.raises(ValueError, match="U_transforms"):
        tta.load_uv_symmetry({"V_transforms": v_tab})
    with pytest.raises(ValueError, match="expected"):
        tta.load_uv_symmetry({"U_transforms": u_tab[:23], "V_transforms": v_tab})


def test_merge_detections_fixture():
    """tests/test_tta.py:403-447's hand-derived fixture: class-aware NMS at
    0.5, then the best by score; the invalid slot G suppresses nothing."""
    boxes = torch.tensor([[0, 0, 10, 10], [20, 20, 30, 30], [1, 0, 11, 10], [20, 20, 30, 31],
                          [1, 0, 11, 10], [2, 0, 12, 10], [8, 0, 18, 10], [0, 0, 10, 10]],
                         dtype=torch.float32)
    scores = torch.tensor([0.90, 0.80, 0.95, 0.70, 0.50, 0.60, 0.65, 0.99])
    classes = torch.tensor([0, 0, 0, 0, 1, 0, 0, 0], dtype=torch.int32)
    valid = torch.tensor([1, 1, 1, 1, 1, 1, 1, 0], dtype=torch.bool)
    b, s, c, v = tta.merge_detections(boxes, scores, classes, valid, 0.5, 6)
    n = int(v.sum())
    assert n == 4 and bool(v[:n].all())
    np.testing.assert_allclose(s[:n].numpy(), [0.95, 0.80, 0.65, 0.50])
    np.testing.assert_array_equal(c[:n].numpy(), [0, 0, 0, 1])
    np.testing.assert_array_equal(b[:n].numpy(), [[1, 0, 11, 10], [20, 20, 30, 30],
                                                  [8, 0, 18, 10], [1, 0, 11, 10]])
    b2, s2, c2, v2 = tta.merge_detections(boxes, scores, classes, valid, 0.5, 2)
    assert int(v2.sum()) == 2
    np.testing.assert_allclose(s2.numpy(), [0.95, 0.80])


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_detections_matches_jax(seed):
    """Random clustered boxes of three classes with tied scores and invalid
    slots: every returned slot exactly the JAX package's."""
    rng = np.random.RandomState(seed)
    ctr = np.repeat(rng.rand(40, 2) * 200, 5, axis=0)
    wh = np.repeat(rng.rand(40, 2) * 60 + 4, 5, axis=0) * (1 + 0.2 * rng.randn(200, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)
    scores = np.round(rng.rand(200), 2).astype(np.float32)  # ties
    classes = rng.randint(0, 3, 200).astype(np.int32)
    valid = rng.rand(200) > 0.1
    got = tta.merge_detections(*(torch.from_numpy(a) for a in (boxes, scores, classes, valid)),
                               0.5, 60)
    want = jax_tta.merge_detections(*(jnp.asarray(a) for a in (boxes, scores, classes, valid)),
                                    nms_thresh=0.5, topk=60)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 10 < int(got[3].sum()) < int(valid.sum())


def view_maps(rng, n, dtype):
    keys = {"pred_densepose_coarse_segm": 2, "pred_densepose_fine_segm": 25,
            "pred_densepose_u": 25, "pred_densepose_v": 25}
    return [{k: rng.randn(4, c, 6, 6).astype(dtype) for k, c in keys.items()} for _ in range(n)]


def list_reduce(plain, flip, tables):
    """The JAX package's reduce_pred_densepose in the port's layout: every
    view's maps held until the end."""
    f32 = torch.float32
    out = {k: sum(d[k].to(f32) for d in plain) / torch.tensor(float(len(plain)))
           for k in plain[0]}
    if flip:
        n_all = torch.tensor(float(len(plain) + len(flip)))
        acc = {k: sum(d[k].to(f32) for d in plain) for k in plain[0]}
        segm = [tta.unflip_chart_segm(d["pred_densepose_coarse_segm"].to(f32),
                                      d["pred_densepose_fine_segm"].to(f32)) for d in flip]
        for i, k in enumerate(("pred_densepose_coarse_segm", "pred_densepose_fine_segm")):
            out[k] = (acc[k] + _chain([s[i] for s in segm])) / n_all
        if tables is not None:
            uv = [tta.unflip_chart_uv(d["pred_densepose_u"].to(f32), d["pred_densepose_v"].to(f32),
                                      *tables) for d in flip]
            for i, k in enumerate(("pred_densepose_u", "pred_densepose_v")):
                out[k] = (acc[k] + _chain([s[i] for s in uv])) / n_all
    return out


def _chain(xs):
    """x0 + x1 + ... in order, starting from x0 (the JAX flip sums)."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("with_tables", [False, True])
@pytest.mark.parametrize("n_plain,n_flip", [(1, 0), (3, 3)])
def test_streaming_reduce_bit_exact(dtype, with_tables, n_plain, n_flip):
    """The two running sums, one view at a time, bit for bit the list form
    and the JAX package's reduce_pred_densepose on the same views."""
    rng = np.random.RandomState(n_plain + 10 * n_flip)
    plain, flip = view_maps(rng, n_plain, dtype), view_maps(rng, n_flip, dtype)
    tables = uv_tables(2) if with_tables else None
    ttabs = None if tables is None else tuple(torch.from_numpy(t) for t in tables)
    reduce = tta.StreamingReduce(ttabs)
    for i in range(max(n_plain, n_flip)):  # views interleaved, as TTAPredictor runs them
        for maps, flipped in ((plain, False), (flip, True)):
            if i < len(maps):
                reduce.add({k: torch.from_numpy(v) for k, v in maps[i].items()}, flipped)
    got = reduce.result()
    torch_maps = [[{k: torch.from_numpy(v) for k, v in d.items()} for d in m]
                  for m in (plain, flip)]
    listed = list_reduce(*torch_maps, ttabs)
    want = jax_tta.reduce_pred_densepose(
        [{k: jnp.asarray(nhwc(v)) for k, v in d.items()} for d in plain],
        [{k: jnp.asarray(nhwc(v)) for k, v in d.items()} for d in flip],
        *([] if tables is None else [jnp.asarray(t) for t in tables]))
    assert sorted(got) == sorted(listed) == sorted(want)
    for k, v in got.items():
        assert v.dtype == torch.float32, k
        np.testing.assert_array_equal(v.numpy(), listed[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(nhwc(v), np.asarray(want[k]), err_msg=k)


def test_single_view_tta_equals_base(jparams):
    """One view at the config's own resolution, no flip: the detections are
    the base predictor's, and the maps are the DensePose stage on the merged
    (postprocessed) boxes in the view's coordinates, the upstream TTA
    semantics (tests/test_tta.py::test_single_view_tta_equals_base)."""
    _, pcfg = cfg_pair(*AUG, "TEST.AUG.MIN_SIZES", "(64,)", "TEST.AUG.MAX_SIZE", "96",
                       "TEST.AUG.FLIP", "False")
    base = DensePosePredictor(pcfg, device="cpu", params=params_from_jax(jparams))
    tpred = tta.TTAPredictor(base)
    img = image(5, *FRAME_HW)
    want = base.predict_numpy(img)
    out = tpred(img)
    got = tpred.numpy_outputs(out)
    assert got["num_instances"] == want["num_instances"] >= 1
    np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
    np.testing.assert_array_equal(got["scores"], want["scores"])
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], atol=1e-4)
    with torch.inference_mode():
        _, feats, _ = base.model.forward_stage1(torch.from_numpy(img))
        _, h1, w1 = compute_resize(*FRAME_HW, 64, 96)
        scale = torch.tensor([w1 / 64, h1 / 48] * 2, dtype=torch.float32)
        ref = base.model.forward_densepose(feats, out["pred_boxes"] * scale)
    for k, v in ref.items():
        assert out[k].dtype == torch.float32
        np.testing.assert_allclose(out[k].numpy(), v.numpy(), atol=ATOL, rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("name", ["plain", "tables"])
def test_tta_matches_jax(both, name):
    """Multi-scale + flip TTA, the port's predictor against the JAX package's
    on two frames: counts and classes exact, the rest within tolerance."""
    jpred, pred = both[name]
    assert pred.flip_segm and (pred.uv_tables is not None) == (name == "tables")
    for seed in (1, 2):
        img = image(seed, *FRAME_HW)
        want, got = jpred.predict_numpy(img), pred.predict_numpy(img)
        n = want["num_instances"]
        assert got["num_instances"] == n >= 1
        np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
        np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], atol=1e-3, rtol=RTOL)
        for k in ("coarse_segm", "fine_segm", "u", "v"):
            key = f"pred_densepose_{k}"
            assert got[key].dtype == np.float32 and got[key].shape == want[key].shape
            np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=RTOL, err_msg=key)


def test_tta_streams_through_the_pipeline(both):
    """parallel/pipeline.py::stream runs a TTAPredictor unchanged (its
    stage_input, start_fetch and numpy_outputs(copy=False) are the base's),
    and each streamed frame's outputs equal a blocking predict_numpy's."""
    pred = both["plain"][1]
    frames = [image(20 + i, *FRAME_HW) for i in range(3)]

    class Recording:
        def __init__(self):
            self.outs = []

        def fetch_keys(self):
            return None

        def visualize(self, frame, outputs):
            self.outs.append({k: np.array(v) for k, v in outputs.items()})
            return frame

    rec = Recording()
    written = []
    stream(pred, rec, frames, written.append)
    assert len(written) == len(rec.outs) == 3
    for f, got in zip(frames, rec.outs):
        want = pred.predict_numpy(f)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_tta_half_precision_maps_are_fp32(jparams):
    """At TPU.COMPUTE_DTYPE float16 the views run at float16 and the reduce in
    fp32: the maps come back float32, the detections fp32, all finite."""
    _, pcfg = cfg_pair(*AUG, "TPU.COMPUTE_DTYPE", "float16")
    pred = tta.TTAPredictor(DensePosePredictor(pcfg, device="cpu",
                                               params=params_from_jax(jparams)))
    out = pred(image(3, *FRAME_HW))
    for k, v in out.items():
        if v.is_floating_point():
            assert v.dtype == torch.float32, k
            assert bool(torch.isfinite(v).all()), k
    assert int(out["num_instances"]) >= 1


def test_tables_without_flip_warn(jparams, tmp_path):
    npz = str(tmp_path / "uv.npz")
    np.savez(npz, **dict(zip(("U_transforms", "V_transforms"), uv_tables(1))))
    _, pcfg = cfg_pair(*AUG, "TEST.AUG.FLIP", "False")
    base = DensePosePredictor(pcfg, device="cpu", params=params_from_jax(jparams))
    with pytest.warns(UserWarning, match="tables ignored"):
        pred = tta.TTAPredictor(base, uv_symmetry=npz)
    assert pred.uv_tables is None and not pred.flip_segm
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tta.TTAPredictor(base).uv_tables is None


def test_tta_cli_flow(tmp_path, monkeypatch):
    """The CLI wraps the predictor in a TTAPredictor for TEST.AUG.ENABLED and
    writes the overlay, for an image and a directory."""
    cv2 = pytest.importorskip("cv2")
    monkeypatch.setenv("DENSEPOSE_TPU_OFFLINE", "1")
    opts = NARROW_OPTS + AUG
    pred = run.load_predictor(FLAGSHIP, "", opts, "cpu")
    assert isinstance(pred, tta.TTAPredictor)
    img_path = tmp_path / "in.jpg"
    cv2.imwrite(str(img_path), image(6, *FRAME_HW))
    run.main([FLAGSHIP, str(img_path), "--cpu", "--opts", *opts])
    out = cv2.imread(str(tmp_path / "in_pred.jpg"))
    assert out is not None and out.shape == (*FRAME_HW, 3)
    d = tmp_path / "dir"
    d.mkdir()
    for i, hw in enumerate([FRAME_HW, (64, 48)]):
        cv2.imwrite(str(d / f"f{i}.png"), image(30 + i, *hw))
    run.main([FLAGSHIP, str(d), "--cpu", "--vis", "bbox", "--opts", *opts])
    assert sorted(os.listdir(d)) == ["f0.png", "f0_pred.png", "f1.png", "f1_pred.png"]
