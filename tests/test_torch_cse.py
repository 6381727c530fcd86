"""The port's CSE models (``densepose_tpu_torch/models/cse.py``, the CSE
dispatch of ``models/roi_heads.py``, ``visualizer.py::CseResultExtractor`` /
``CseVisualizer``) held against the JAX package's on the CPU: specs, the
weight bridge's tables, vertex embeddings, the closest-vertex lookup, the
embedding predictor, end to end (with the DensePose buckets, the device
postprocess skipped and TTA), the extractor and the CLI.

The model is densepose_rcnn_R_50_FPN_s1x_cse at tests/test_torch_pipeline.py's
toy widths, with two classes and a mesh each: a ``vertex_feature`` embedder
(3000 vertices, 32 features) and a ``vertex_direct`` one (1000 vertices),
in place of the zoo's one 27554-vertex SMPL mesh (the animal configs of the
reference, which carry several meshes, are not in this repository). Both
packages get the same weights (the JAX predictor's through
``params_from_jax``) and the same numpy inputs.

Tolerances (fp32): maps and vertex embeddings differ by summation order:
1e-4 absolute and relative (test_torch_pipeline.py's), vertex embeddings
1e-6. Exact: spec keys and shapes, the embedder tables through the bridge,
detection counts and classes, foreground masks, and the lookup where a pixel
equals a vertex. Elsewhere the lookup follows the near-tie rule: the two
packages' dot products sum in other orders, so where two vertices score
within those roundings the argmin may differ. The port's vertex must score,
in float64, within NEAR_TIE (1 + |p|) of the JAX package's minimum for every
pixel p, and the indices must agree on at least AGREE of the pixels.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from densepose_tpu.config import get_cfg as jax_get_cfg
from densepose_tpu.models import cse as jax_cse
from densepose_tpu.models.rcnn import build_model as jax_build_model
from densepose_tpu.predictor import DensePosePredictor as JaxPredictor
from densepose_tpu.tta import TTAPredictor as JaxTTA
from densepose_tpu.visualizer import CseResultExtractor as JaxExtractor
from densepose_tpu_torch import run
from densepose_tpu_torch.checkpoint.transform import params_from_jax
from densepose_tpu_torch.config import get_cfg as port_get_cfg
from densepose_tpu_torch.models import cse
from densepose_tpu_torch.models.rcnn import build_model
from densepose_tpu_torch.ops.resize import resize_bilinear_np
from densepose_tpu_torch.predictor import DensePosePredictor
from densepose_tpu_torch.tta import TTAPredictor
from densepose_tpu_torch.visualizer import CseResultExtractor, CseVisualizer
from tests.test_torch_pipeline import TINY_DELTAS
from tests.test_torch_variants import image, variant_cfg

torch.set_num_threads(2)

ATOL = RTOL = 1e-4
SEED = 2  # random weights that detect both classes, so both meshes are looked up
CSE = "densepose_rcnn_R_50_FPN_s1x_cse"
MESHES = {"toy_human": {"TYPE": "vertex_feature", "NUM_VERTICES": 3000, "FEATURE_DIM": 32},
          "toy_animal": {"TYPE": "vertex_direct", "NUM_VERTICES": 1000}}
TWO_MESHES = [("MODEL.ROI_HEADS.NUM_CLASSES", 2),
              ("MODEL.ROI_DENSEPOSE_HEAD.CSE.EMBEDDERS", MESHES),
              ("DATASETS.CLASS_TO_MESH_NAME_MAPPING", {"0": "toy_human", "1": "toy_animal"})]
NEAR_TIE = 1e-5
AGREE = 0.99


def cse_cfg(get_cfg, extra=()):
    return variant_cfg(get_cfg, CSE, TWO_MESHES + list(extra))


def build_pair(extra=()):
    jcfg, pcfg = cse_cfg(jax_get_cfg, extra), cse_cfg(port_get_cfg, extra)
    jpred = JaxPredictor(jcfg, seed=SEED)
    port = DensePosePredictor(pcfg, device="cpu", params=params_from_jax(
        {k: np.asarray(v) for k, v in jpred.params.items()}))
    return jpred, port


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def outputs(pair):
    """Both predictors' outputs on one 64x64 frame."""
    jpred, port = pair
    img = image(21)
    return jpred.predict_numpy(img), port.predict_numpy(img)


def near_tie_check(pixels, verts, got, want):
    """The near-tie rule on float64 scores -2 p.v + |v|^2 of ``pixels`` (P, D)
    against ``verts`` (N, D): returns the share of equal indices."""
    p, v = pixels.astype(np.float64), verts.astype(np.float64)
    score = lambda idx: -2.0 * (p * v[idx]).sum(1) + (v[idx] ** 2).sum(1)
    slack = score(got) - score(want)
    assert (slack <= NEAR_TIE * (1 + np.linalg.norm(p, axis=1))).all(), slack.max()
    return float((got == want).mean())


def test_spec_matches_jax():
    """The toy model with one vertex_feature and one vertex_direct mesh: the
    same keys in the same order, shapes and kinds; the embedder tables last
    (tests/test_torch_variants.py::test_zoo_family_specs_match_jax holds the
    eight zoo configs)."""
    jcfg, pcfg = cse_cfg(jax_get_cfg), cse_cfg(port_get_cfg)
    want = jax_build_model(jcfg).spec()
    got = build_model(pcfg).spec()
    assert list(got) == list(want)
    for k in want:
        assert (got[k].shape, got[k].kind) == (want[k].shape, want[k].kind), k
    tables = [k for k in got if ".embedder." in k]
    assert tables == list(got)[-len(tables):]
    assert "roi_heads.densepose_predictor.embed_lowres.weight" in got


def test_params_from_jax_keeps_tables(pair):
    """The embedder tables are 2-D vectors, not linears: the bridge passes
    them through untransposed, and the port's module holds them."""
    jpred, port = pair
    keys = ["roi_heads.embedder.embedder_toy_human.features",
            "roi_heads.embedder.embedder_toy_human.embeddings",
            "roi_heads.embedder.embedder_toy_animal.embeddings"]
    back = params_from_jax({k: np.asarray(v) for k, v in jpred.params.items()})
    state = port.model.state_dict()
    for k in keys:
        np.testing.assert_array_equal(back[k], np.asarray(jpred.params[k]), err_msg=k)
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(jpred.params[k]), err_msg=k)
    assert state[keys[0]].shape == (3000, 32)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_vertex_embeddings(pair, mesh):
    jpred, port = pair
    want = np.asarray(jax_cse.vertex_embeddings(jpred.params, mesh))
    got = cse.vertex_embeddings(port.model.roi_heads.embedder, mesh)
    assert got.dtype == torch.float32 and got.shape == (MESHES[mesh]["NUM_VERTICES"], 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, atol=1e-6)


def test_closest_vertices_exact_on_vertices():
    """Pixels equal to vertices find them (JAX test_cse_vertex_lookup), also
    in chunks of one row."""
    rng = np.random.RandomState(0)
    mesh = cse.normalize_embeddings(torch.from_numpy(rng.randn(100, 16).astype(np.float32)))
    idx = np.array([3, 50, 99, 0])
    for chunk in (cse.LOOKUP_CHUNK_ELEMENTS, 100):
        got = cse.closest_vertices(mesh[idx], mesh, chunk_elements=chunk)
        np.testing.assert_array_equal(got.numpy(), idx)
    want = np.asarray(jax_cse.closest_vertices(jnp.asarray(mesh.numpy()[idx]),
                                               jnp.asarray(mesh.numpy())))
    np.testing.assert_array_equal(want, idx)


def test_closest_vertices_random(pair):
    """Random pixel embeddings against a mesh: the near-tie rule, whole and
    in chunks of 7 rows."""
    jpred, port = pair
    verts = cse.vertex_embeddings(port.model.roi_heads.embedder, "toy_human")
    pixels = np.random.RandomState(1).randn(2000, 16).astype(np.float32) * 3
    want = np.asarray(jax_cse.closest_vertices(jnp.asarray(pixels), jnp.asarray(verts.numpy())))
    for chunk in (cse.LOOKUP_CHUNK_ELEMENTS, 7 * 3000):
        got = cse.closest_vertices(torch.from_numpy(pixels), verts, chunk_elements=chunk)
        assert got.dtype == torch.int64
        assert near_tie_check(pixels, verts.numpy(), got.numpy(), want) >= AGREE


def test_embedding_predictor(pair):
    """The two deconv heads and their upsample against
    embedding_predictor_forward, on random head features."""
    jpred, port = pair
    x = np.random.RandomState(2).randn(5, 8, 8, 16).astype(np.float32)
    want = jax_cse.embedding_predictor_forward(jpred.params, jnp.asarray(x), jpred.cfg)
    with torch.no_grad():
        got = port.model.roi_heads.densepose_predictor(
            torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert list(got) == list(want) == ["embedding", "coarse_segm"]
    assert got["embedding"].shape == (5, 16, 32, 32)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.transpose(np.asarray(want[k]), (0, 3, 1, 2)),
                                   atol=ATOL, rtol=RTOL, err_msg=k)


def test_end_to_end(outputs):
    want, got = outputs
    n = want["num_instances"]
    assert got["num_instances"] == n >= 1
    assert set(got["pred_classes"]) == {0, 1}  # both meshes' classes
    np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], atol=1e-3, rtol=RTOL)
    maps = sorted(k for k in got if k.startswith("pred_densepose_"))
    assert maps == sorted(k for k in want if k.startswith("pred_densepose_")) == [
        "pred_densepose_coarse_segm", "pred_densepose_embedding"]
    assert got["pred_densepose_embedding"].shape == (n, 16, 32, 32)
    for k in maps:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("mode", ["switched", "bucketed", "device_postprocess"])
def test_modes_carry_the_embedding(pair, outputs, mode):
    """The switched stage at a forced count, TPU.BUCKETED_DENSEPOSE's stage
    2, and TPU.DEVICE_POSTPROCESS (skipped for a CSE model, as the JAX
    package gates it on U): the embedding and coarse segmentation maps."""
    _, base = pair
    _, want = outputs
    extra = {"switched": [], "bucketed": [("TPU.BUCKETED_DENSEPOSE", True)],
             "device_postprocess": [("TPU.DEVICE_POSTPROCESS", True)]}[mode]
    pred = DensePosePredictor(cse_cfg(port_get_cfg, extra), device="cpu",
                              params=base.model.state_dict())
    img = image(21)
    if mode == "switched":
        with torch.no_grad():
            res, feats, boxes = pred.model.forward_stage1(torch.from_numpy(img))
            dp = pred.model.forward_densepose_switched(feats, boxes, 5)
        assert sorted(dp) == ["pred_densepose_coarse_segm", "pred_densepose_embedding"]
        for k, v in dp.items():
            assert v.shape[0] == 40 and not v[8:].any()
            np.testing.assert_allclose(v[:5].numpy(), want[k][:5], atol=ATOL, rtol=RTOL)
        return
    got = pred.predict_numpy(img)
    assert sorted(k for k in got if k.startswith("pred_densepose_")) == [
        "pred_densepose_coarse_segm", "pred_densepose_embedding"]
    for k in ("pred_densepose_coarse_segm", "pred_densepose_embedding"):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL, err_msg=k)


def test_extractor_matches_jax(pair, outputs):
    """On the same (JAX) outputs: the same boxes, meshes and foreground
    masks, and closest vertices by the near-tie rule, per instance."""
    jpred, port = pair
    want_out, _ = outputs
    want, want_boxes = JaxExtractor(jpred)(want_out)
    extractor = CseResultExtractor(port)
    got, got_boxes = extractor(want_out)
    np.testing.assert_array_equal(got_boxes, want_boxes)
    assert len(got) == len(want) == want_out["num_instances"]
    equal = total = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["mesh_name"] == w["mesh_name"]
        np.testing.assert_array_equal(g["mask"], w["mask"])
        assert g["closest_vertices"].shape == g["mask"].shape
        assert g["closest_vertices"].max() < MESHES[g["mesh_name"]]["NUM_VERTICES"]
        bw, bh = [int(q) for q in got_boxes[i, 2:]]
        emb = np.transpose(want_out["pred_densepose_embedding"][i], (1, 2, 0))
        pix = resize_bilinear_np(emb, (max(bh, 1), max(bw, 1))).reshape(-1, emb.shape[-1])
        m = g["mask"].reshape(-1)
        verts = extractor.vertices(g["mesh_name"]).numpy()
        equal += near_tie_check(pix[m], verts, g["closest_vertices"].reshape(-1)[m],
                                w["closest_vertices"].reshape(-1)[m]) * m.sum()
        total += m.sum()
    assert total > 100 and equal / total >= AGREE
    assert {r["mesh_name"] for r in got} == set(MESHES)


def test_visualizer_overlay(pair, outputs):
    """CseVisualizer draws each instance's vertex indices modulo 255 through
    the colormap table; its fetch keys are the two CSE maps."""
    _, port = pair
    _, got = outputs
    table = np.stack([np.arange(256)] * 3, 1).astype(np.uint8)
    vis = CseVisualizer(port, cmap=table, keep_bg=False)
    assert vis.fetch_keys() == {"pred_densepose_embedding", "pred_densepose_coarse_segm"}
    img = image(21)
    out = vis.visualize(img.copy(), got)
    assert out.shape == img.shape and out.dtype == np.uint8
    assert (out != img).any()


def test_tta(pair):
    """TTA of a CSE model (two scales, flips): the JAX package averages the
    plain views' maps; flipped views add detections only (their embedding
    has no left/right permutation). The port does the same."""
    aug = [("TEST.AUG.ENABLED", True), ("TEST.AUG.MIN_SIZES", (48, 64)),
           ("TEST.AUG.MAX_SIZE", 128), ("TEST.AUG.FLIP", True),
           ("TEST.DETECTIONS_PER_IMAGE", 12)]
    jpred, port = pair
    jtta = JaxTTA(JaxPredictor(cse_cfg(jax_get_cfg, aug), params=jpred.params))
    ptta = TTAPredictor(DensePosePredictor(cse_cfg(port_get_cfg, aug), device="cpu",
                                           params=port.model.state_dict()))
    assert not jtta.flip_segm and not ptta.flip_segm
    img = image(22, 48, 64)
    want, got = jtta.predict_numpy(img), ptta.predict_numpy(img)
    assert got["num_instances"] == want["num_instances"] >= 1
    np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], atol=1e-3, rtol=RTOL)
    for k in ("pred_densepose_embedding", "pred_densepose_coarse_segm"):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_half_tables(pair, dtype):
    """At a half compute dtype the tables are rounded with every float32
    parameter, as the JAX predictor's _cast_param rounds them, and the
    vertex embeddings are computed from the rounded tables in fp32."""
    jpred, port = pair
    jhalf = JaxPredictor(cse_cfg(jax_get_cfg, [("TPU.COMPUTE_DTYPE", dtype)]),
                         params=jpred.params)
    phalf = DensePosePredictor(cse_cfg(port_get_cfg, [("TPU.COMPUTE_DTYPE", dtype)]),
                               device="cpu", params=port.model.state_dict())
    table = phalf.model.roi_heads.embedder.embedder_toy_human.features
    assert table.dtype == getattr(torch, dtype)
    for mesh in MESHES:
        want = np.asarray(jax_cse.vertex_embeddings(jhalf.params, mesh))
        got = cse.vertex_embeddings(phalf.model.roi_heads.embedder, mesh)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.fixture
def offline(monkeypatch):
    monkeypatch.setenv("DENSEPOSE_TPU_OFFLINE", "1")


def test_cli_bbox_and_refusal(tmp_path, offline):
    """The CLI on the zoo's CSE config: --vis bbox writes the overlay; a
    chart mode is refused with the way to a CSE overlay."""
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "frame.jpg")
    cv2.imwrite(path, image(23, 48, 64))
    opts = ["--opts", *[s for key, value in TINY_DELTAS for s in (key, str(value))]]
    run.main([CSE, path, "--cpu", "--vis", "bbox", *opts])
    out = cv2.imread(str(tmp_path / "frame_pred.jpg"))
    assert out is not None and out.shape == (48, 64, 3)
    with pytest.raises(ValueError, match="CseVisualizer"):
        run.main([CSE, path, "--cpu", "--vis", "fine_segm", *opts])
