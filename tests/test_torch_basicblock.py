"""BasicBlock ResNets (R18 / R34) under the FPN, and the RetinaNet FPN
(``build_retinanet_resnet_fpn_backbone``: LastLevelP6P7 from res5), held
against the JAX package on the CPU.

Configs: the flagship narrowed as tests/test_torch_variants.py::variant_cfg
narrows it, with ``DEPTH`` 18 or 34 (BasicBlock widths are fixed at 64..512
in the JAX package, so the stem and res2 stay 64 wide: only the heads and
the frames are small), or with the RetinaNet FPN (res3..res5 into the FPN,
the RPN on p3..p7, the ROI heads on p3..p5) on the narrowed R50.

Tolerances (fp32): features within tests/test_torch_pipeline.py's RTOL and
ATOL times the level's largest magnitude (the random-weight BasicBlock maps
reach ~1e3); boxes within 1e-3, scores and maps within ATOL / RTOL; counts,
classes and validity exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from densepose_tpu.config import get_cfg as jax_get_cfg
from densepose_tpu.models.fpn import fpn_forward, retinanet_fpn_forward
from densepose_tpu.models.rcnn import build_model as jax_build_model
from densepose_tpu.parallel.mesh import make_mesh_2d
from densepose_tpu.parallel.mesh import spatial_parallel_forward as jax_spatial_forward
from densepose_tpu.predictor import DensePosePredictor as JaxPredictor
from densepose_tpu_torch.config import get_cfg as port_get_cfg
from densepose_tpu_torch.models.rcnn import build_model
from densepose_tpu_torch.parallel import spatial_parallel_forward
from densepose_tpu_torch.predictor import DensePosePredictor
from tests.test_torch_pipeline import ATOL, RTOL
from tests.test_torch_spatial import holds
from tests.test_torch_variants import build_pair, image, nchw, variant_cfg
from tests.torch_cases import BASIC_BLOCK, RETINANET

torch.set_num_threads(2)

FLAGSHIP = "densepose_rcnn_R_50_FPN_s1x"
DEPTHS = {18: [("MODEL.RESNETS.DEPTH", 18)] + BASIC_BLOCK,
          34: [("MODEL.RESNETS.DEPTH", 34)] + BASIC_BLOCK}
CASES = {"r18_fpn": DEPTHS[18], "r34_fpn": DEPTHS[34], "retinanet": RETINANET,
         "retinanet_r18": RETINANET + DEPTHS[18]}

_PAIRS = {}


def pair(name):
    """(jcfg, pcfg, jmodel, jp, jparams, port) of a case, built once."""
    if name not in _PAIRS:
        _PAIRS[name] = build_pair(FLAGSHIP, CASES[name])
    return _PAIRS[name]


def levels_hold(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        w = w if w.ndim == 4 else w[None]
        g = got[k].permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, atol=ATOL * max(1.0, float(np.abs(w).max())),
                                   rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("name", ["r18_fpn", "r34_fpn", "retinanet", "retinanet_r18"])
def test_spec_keys_and_order(name):
    """The port's spec equals the JAX package's key for key, in order, shape
    for shape: BasicBlock stages have conv1 / conv2 (3x3) and a shortcut
    where the width changes; the RetinaNet FPN adds ``top_block.p6 / p7``."""
    jcfg, pcfg = variant_cfg(jax_get_cfg, FLAGSHIP, CASES[name]), \
        variant_cfg(port_get_cfg, FLAGSHIP, CASES[name])
    want = jax_build_model(jcfg).spec()
    got = build_model(pcfg).spec()
    assert list(got) == list(want)
    assert all(tuple(got[k].shape) == tuple(want[k].shape) for k in want)
    assert ("backbone.top_block.p7.weight" in got) == name.startswith("retinanet")
    assert ("backbone.bottom_up.res2.0.conv3.weight" in got) == (name == "retinanet")


@pytest.mark.parametrize("name", ["r18_fpn", "r34_fpn"])
def test_basicblock_fpn_features_match_jax(name):
    """R18 and R34 ResNet-FPN p2..p6 against JAX ``fpn_forward``."""
    jcfg, pcfg, jmodel, jp, _, port = pair(name)
    x, _, _ = jmodel.preprocess(jnp.asarray(image(11, 96, 128)), (96, 128))
    want = jax.jit(lambda p, x: fpn_forward(p, x, jcfg))(jp, x)
    with torch.no_grad():
        got = port.model.backbone(nchw(x))
    assert sorted(want) == ["p2", "p3", "p4", "p5", "p6"]
    levels_hold(got, want)


@pytest.mark.parametrize("name", ["retinanet", "retinanet_r18"])
def test_retinanet_features_match_jax(name):
    """The RetinaNet FPN's p3..p7 against JAX ``retinanet_fpn_forward``:
    p6 a 3x3/2 conv of res5 (rounding an odd size up), p7 of relu(p6)."""
    jcfg, pcfg, jmodel, jp, _, port = pair(name)
    x, _, _ = jmodel.preprocess(jnp.asarray(image(12, 96, 160)), (96, 160))
    want = jax.jit(lambda p, x: retinanet_fpn_forward(p, x, jcfg))(jp, x)
    with torch.no_grad():
        got = port.model.backbone(nchw(x))
    assert sorted(want) == ["p3", "p4", "p5", "p6", "p7"]
    for lo, hi in (("p5", "p6"), ("p6", "p7")):  # a stride-2 3x3 rounds up
        assert list(got[hi].shape[-2:]) == [-(-s // 2) for s in got[lo].shape[-2:]]
    levels_hold(got, want)


@pytest.mark.parametrize("name,hw", [("r34_fpn", (64, 64)), ("retinanet", (64, 96))],
                         ids=["r34_fpn_densepose", "retinanet_densepose"])
def test_end_to_end_matches_jax(name, hw):
    """R34-FPN DensePose and RetinaNet DensePose (ROI heads on p3..p5)
    against ``jax.jit(model.forward)``: detections and the DensePose maps."""
    jcfg, pcfg, jmodel, jp, _, port = pair(name)
    for seed in (2, 3):
        img = image(seed, *hw)
        want = {k: np.asarray(v) for k, v in jax.jit(jmodel.forward)(jp, jnp.asarray(img))
                .items()}
        with torch.no_grad():
            got = port.model.forward_batch(torch.from_numpy(img)[None])
        holds({k: v[0] for k, v in got.items()}, want)
        # the served request (switched DensePose stage): its valid rows
        served = port(img)
        assert int(served["num_instances"]) == int(want["num_instances"])


def test_retinanet_p6_densepose_refused_as_jax_fails():
    """ROI heads on p3..p6 with DensePose at 60x80: p6 (1x2 of a 2x3 res5)
    upsamples to 16x32 in the decoder against p3's 16x24. The JAX package
    fails in the decoder's add on the shapes; the port raises a ValueError
    naming the level."""
    extra = RETINANET + [("MODEL.ROI_HEADS.IN_FEATURES", ["p3", "p4", "p5", "p6"])]
    jcfg = variant_cfg(jax_get_cfg, FLAGSHIP, extra)
    jpred = JaxPredictor(jcfg, seed=0)
    img = image(4, 60, 80)
    with pytest.raises((TypeError, ValueError), match="16, 24|16, 32"):
        jpred(img)
    port = DensePosePredictor(variant_cfg(port_get_cfg, FLAGSHIP, extra), device="cpu", seed=0)
    with pytest.raises(ValueError, match=r"decoder: level p6 upsamples to \(16, 32\)"):
        port(img)


@pytest.mark.parametrize("name,hw,shards", [("r18_fpn", (128, 160), (8,)),
                                            ("retinanet", (192, 96), (2, 3))])
def test_spatial_matches_jax(name, hw, shards):
    """``spatial_parallel_forward`` of R18-FPN (BasicBlock stages as row
    slabs) and RetinaNet (p6 / p7 stride-2 convs with their halos) against
    JAX ``spatial_parallel_forward`` on the 8 virtual CPU devices and
    ``jax.jit(forward)``."""
    jcfg, pcfg, jmodel, jp, _, port = pair(name)
    frame = image(2, *hw)
    spatial = {k: np.asarray(v) for k, v in jax_spatial_forward(
        jmodel, make_mesh_2d(1, 8))(jp, jnp.asarray(frame)).items()}
    single = {k: np.asarray(v) for k, v in jax.jit(jmodel.forward)(
        jp, jnp.asarray(frame)).items()}
    for n in shards:
        got = spatial_parallel_forward(port.model, ["cpu"] * n)(frame)
        for want in (spatial, single):
            holds(got, want)


def test_int8_backbone_below_depth_50():
    """INT8_BACKBONE on R18-FPN: the bottleneck chain stays fp (JAX
    ``int8_backbone_active``), the FPN output convs still quantize; the
    required scales and the quantized convs are JAX's, and the request runs."""
    extra = DEPTHS[18] + [("TPU.INT8_BACKBONE", True)]
    jpred = JaxPredictor(variant_cfg(jax_get_cfg, FLAGSHIP, extra), seed=0)
    port = DensePosePredictor(variant_cfg(port_get_cfg, FLAGSHIP, extra), device="cpu", seed=0)
    assert port._int8_needed and jpred._int8_needed
    req = port._required_scale_keys()
    assert req == jpred._required_scale_keys(jpred.params)
    assert "backbone.fpn_output2.in_scale" in req and not any(".res2." in k for k in req)
    img = image(5)
    out = port(img)
    assert port._int8_ready and not port.model.backbone.bottom_up.int8_active()
    assert port.model.backbone.int8_active()
    assert sorted(k[:-len(".qweight")] for k in port.int8_state() if k.endswith(".qweight")) \
        == sorted(f"backbone.fpn_output{i}" for i in range(2, 6))
    assert torch.isfinite(out["scores"]).all()
