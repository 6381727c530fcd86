"""The PyTorch port's configs, specs and weight loading held against the JAX
package: the same zoo, the same parameter specs and random stream, the same
FrozenBN folding, and ``params_from_jax`` undoing the JAX layouts exactly."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from densepose_tpu import model_zoo as jax_zoo
from densepose_tpu.checkpoint import pkl_loader as jax_pkl
from densepose_tpu.checkpoint.transform import random_torch_state as jax_random_state
from densepose_tpu.config import get_cfg as jax_get_cfg
from densepose_tpu.models.rcnn import build_model as jax_build_model
from densepose_tpu.predictor import load_params as jax_load_params
from densepose_tpu_torch import model_zoo
from densepose_tpu_torch.checkpoint import pkl_loader
from densepose_tpu_torch.checkpoint.transform import (fold_state, params_from_jax,
                                                      random_torch_state)
from densepose_tpu_torch.config import get_cfg as port_get_cfg
from densepose_tpu_torch.models.rcnn import build_model
from densepose_tpu_torch.predictor import load_params
from tests.test_torch_pipeline import tiny_cfg

torch.set_num_threads(2)

FLAGSHIP = "densepose_rcnn_R_50_FPN_s1x"


def test_zoo_copy_matches_jax():
    assert model_zoo.list_models() == jax_zoo.list_models()
    for name in model_zoo.list_models():
        assert model_zoo.get_config(name).dump_dict() == jax_zoo.get_config(name).dump_dict()
    assert port_get_cfg().dump_dict() == jax_get_cfg().dump_dict()


@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_spec_matches_jax(which):
    """Same keys in the same order (the random stream follows it), the same
    torch-layout shapes and kinds."""
    if which == "tiny":
        jcfg, pcfg = tiny_cfg(jax_get_cfg), tiny_cfg(port_get_cfg)
    else:
        jcfg, pcfg = jax_zoo.get_config(FLAGSHIP), model_zoo.get_config(FLAGSHIP)
    want = jax_build_model(jcfg).spec()
    got = build_model(pcfg).spec()
    assert list(got) == list(want)
    for k in want:
        assert (got[k].shape, got[k].kind) == (want[k].shape, want[k].kind), k


def test_random_state_and_fold_match_jax():
    """The port's load_params from a seed == params_from_jax of the JAX
    package's load_params from the same seed, bit for bit."""
    jcfg, pcfg = tiny_cfg(jax_get_cfg), tiny_cfg(port_get_cfg)
    spec = build_model(pcfg).spec()
    a, b = random_torch_state(spec, seed=3), jax_random_state(jax_build_model(jcfg).spec(), 3)
    assert all(np.array_equal(a[k], b[k]) for k in b) and list(a) == list(b)
    want = params_from_jax(jax_load_params(jcfg, seed=3))
    got = load_params(pcfg, seed=3)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the folded dict is exactly the module's state dict
    model = build_model(pcfg)
    assert sorted(model.state_dict()) == sorted(got)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in got.items()})


def test_params_from_jax_layouts():
    """Conv HWIO -> OIHW, flipped deconv -> (Cin, Cout, kh, kw), linear
    (in, out) -> (out, in), vectors (GroupNorm's included) as they are;
    unfolded FrozenBN refused."""
    from densepose_tpu.checkpoint.transform import torch_state_to_jax
    from densepose_tpu.checkpoint.spec import ParamSpec
    rng = np.random.RandomState(0)
    spec = {"a.conv.weight": ParamSpec((5, 3, 3, 2), "conv"),
            "roi_heads.densepose_predictor.u_lowres.weight": ParamSpec((4, 6, 4, 4), "convT"),
            "box.fc1.weight": ParamSpec((7, 9), "linear"),
            "box.fc1.bias": ParamSpec((7,), "vec"),
            "head.body_conv_fcn1.norm.weight": ParamSpec((5,), "vec"),
            "head.body_conv_fcn1.norm.bias": ParamSpec((5,), "vec")}
    state = {k: rng.randn(*p.shape).astype(np.float32) for k, p in spec.items()}
    back = params_from_jax(torch_state_to_jax(state, spec, fold_bn=False))
    for k in state:
        np.testing.assert_array_equal(back[k], state[k], err_msg=k)
    with pytest.raises(ValueError):
        params_from_jax({"x.norm.weight": np.ones(3, np.float32),
                         "x.norm.running_mean": np.ones(3, np.float32)})


def test_c2_renames_match_jax():
    rng = np.random.RandomState(1)
    w = {"conv1_w": rng.randn(4, 3, 7, 7), "res2_0_branch2a_bn_s": rng.randn(4),
         "fpn_inner_res5_sum_w": rng.randn(8, 16, 1, 1), "cls_score_w": rng.randn(3, 8),
         "bbox_pred_w": rng.randn(12, 8), "AnnIndex_lowres_w": rng.randn(8, 15, 4, 4)}
    got, gmap = pkl_loader.convert_c2_names(w)
    want, wmap = jax_pkl.convert_c2_names(w)
    assert gmap == wmap and sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_load_params_from_synthetic_pickle(tmp_path):
    """A zoo-format pkl of the tiny flagship loads into every module slot."""
    pcfg = tiny_cfg(port_get_cfg)
    spec = build_model(pcfg).spec()
    rng = np.random.RandomState(2)
    state = {k: (rng.rand(*p.shape) + 0.5 if k.endswith("running_var")
                 else rng.randn(*p.shape)).astype(np.float32) for k, p in spec.items()}
    path = os.path.join(tmp_path, "model.pkl")
    with open(path, "wb") as f:
        pickle.dump({"model": state, "__author__": "test"}, f)
    got = load_params(pcfg, path)
    want = fold_state(state, spec)
    assert sorted(got) == sorted(want) == sorted(build_model(pcfg).state_dict())
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert "backbone.bottom_up.stem.conv1.norm.weight" not in got
    assert got["roi_heads.densepose_predictor.u_lowres.weight"].shape == (16, 25, 4, 4)


def test_flagship_checkpoint_keys_align():
    """Every key of the published s1x checkpoint (model_final_162be9.pkl, key
    manifest in tests/fixtures) lands in the flagship spec and every spec key
    is covered: zero missing, zero extra; the folded keys are the module's."""
    path = os.path.join(os.path.dirname(__file__), "fixtures", f"manifest_{FLAGSHIP}.json")
    with open(path) as f:
        manifest = json.load(f)
    model = build_model(model_zoo.get_config(FLAGSHIP))
    spec = model.spec()
    ckpt = {k: np.zeros(shape, np.float32) for k, shape in manifest["keys"].items()}
    aligned = pkl_loader.align_state_dicts(list(spec), {k: v.shape for k, v in spec.items()},
                                           ckpt, False)
    assert sorted(aligned) == sorted(spec) and len(ckpt) == len(spec)
    assert sorted(fold_state(aligned, spec)) == sorted(model.state_dict())
