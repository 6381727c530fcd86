"""The model parts found by name (``benchmark/parts.py``).

* The two configurations read what they read before the backbone and the
  DensePose head became parts: the ordered weight list, each stage's FLOPs
  and the K1 and K2 bounds at the cams8 canvas equal the values below, taken
  from the harness as it was before the split.
* A backbone whose levels are HRFPN's, p1 .. p5 at strides 4 .. 64 with the
  input padded to 64, supplied by the test through the lookup: the anchors,
  the pooler scales, the decoder chains, the canvas, the RPN's problems and
  the FLOP count follow its strides and padding, not its level names.
* A name with no part file raises an error that names the file to add.
"""

import hashlib
import json

import pytest
import torch
import torch.nn.functional as F

from benchmark import frames, manifest, parts, readers, weights
from benchmark.counts import model, shapes
from benchmark.reference import model as reference
from benchmark.reference import ops
from benchmark.tests import tiny

# sha256 of json.dumps([[name, list(shape)], ...]) in state_shapes' order;
# forward_flops and the K1 / K2 bounds (B 8, float16) at the 768 x 1344
# canvas of a 720p frame; all taken before the split
BEFORE = {
    "r50_fpn_s1x_f16": {
        "digest": "4278453cc920be2b3afac19998ad0cfdae22b83696fcd64e46b032364f7fdef8",
        "weights": 176,
        "flops": {"backbone": 275570491392.0, "rpn": 102029469696.0,
                  "box_stage": 27799552000.0, "decoder": 152335024128.0,
                  "densepose_head": 2774532096000.0, "densepose_predictor": 98906931200.0,
                  "total": 3431173564416.0},
        "k1": 4.3197098507462685e-06, "k2": 0.00015583331343283583},
    "r101_fpn_legacy_f16": {
        "digest": "9dca35b69848de2b518ed5dcd648bc216033525010efec13033d226001632790",
        "weights": 262,
        "flops": {"backbone": 428301877248.0, "rpn": 102029469696.0,
                  "box_stage": 27799552000.0, "decoder": 0.0,
                  "densepose_head": 693633024000.0, "densepose_predictor": 28901376000.0,
                  "total": 1280665298944.0},
        "k1": 4.3197098507462685e-06, "k2": 8.393934328358209e-05},
}
BACKBONE_API = ("shapes", "forward", "strides", "out_channels", "size_divisibility", "flops")
HEAD_API = ("shapes", "forward", "out_channels", "flops")


def digest(state_shapes) -> str:
    ordered = [[k, list(v)] for k, v in state_shapes.items()]
    return hashlib.sha256(json.dumps(ordered).encode()).hexdigest()


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_the_cells_read_what_they_read_before(name):
    conf = manifest.config(manifest.load(), name)
    cfg = conf["model"]
    state = reference.state_shapes(cfg)
    assert len(state) == BEFORE[name]["weights"]
    assert digest(state) == BEFORE[name]["digest"]
    hw = shapes.canvas(cfg, (720, 1280))
    assert hw == (768, 1344)
    assert model.forward_flops(cfg, hw) == BEFORE[name]["flops"]
    run = readers.Run(cfg=cfg, traffic=manifest.traffic("cams8"), batch=8,
                      elem_bytes=torch.empty((), dtype=weights.DTYPES[conf["dtype"]]).element_size())
    assert readers.k1_bound_per_batch(run) == BEFORE[name]["k1"]
    assert readers.k2_bound_per_batch(run) == BEFORE[name]["k2"]


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_each_configuration_finds_its_parts(name):
    cfg = manifest.config(manifest.load(), name)["model"]
    backbone, head = parts.backbone(cfg), parts.head(cfg)
    assert all(callable(getattr(backbone, f)) for f in BACKBONE_API)
    assert all(callable(getattr(head, f)) for f in HEAD_API)
    levels = backbone.strides(cfg)
    assert set(cfg["MODEL.RPN.IN_FEATURES"]) | set(cfg["MODEL.ROI_HEADS.IN_FEATURES"]) <= set(levels)


@pytest.mark.parametrize("lookup, key, folder", [
    (parts.backbone, "MODEL.BACKBONE.NAME", "backbones"),
    (parts.head, "MODEL.ROI_DENSEPOSE_HEAD.NAME", "heads"),
])
def test_an_unknown_part_names_the_file_to_add(lookup, key, folder):
    with pytest.raises(LookupError, match=f"benchmark/reference/{folder}/build_nothing.py"):
        lookup({key: "build_nothing"})


HRFPN_STRIDES = {"p1": 4, "p2": 8, "p3": 16, "p4": 32, "p5": 64}


class HRFPNLevels:
    """A stand-in backbone part with HRFPN's levels: p1 .. p5 at strides
    4 .. 64, the input padded to 64; each level a 1x1 conv of the input
    average-pooled to its stride."""

    @staticmethod
    def strides(cfg):
        return dict(HRFPN_STRIDES)

    @staticmethod
    def out_channels(cfg):
        return cfg["MODEL.FPN.OUT_CHANNELS"]

    @staticmethod
    def size_divisibility(cfg):
        return 64

    @staticmethod
    def shapes(cfg):
        c = HRFPNLevels.out_channels(cfg)
        out = {}
        for f in HRFPN_STRIDES:
            out[f"backbone.{f}.weight"] = (c, 3, 1, 1)
            out[f"backbone.{f}.bias"] = (c,)
        return out

    @staticmethod
    def forward(cfg, w, x):
        return {f: ops.conv(F.avg_pool2d(x, s), w, f"backbone.{f}")
                for f, s in HRFPN_STRIDES.items()}

    @staticmethod
    def flops(cfg, hw):
        c = HRFPNLevels.out_channels(cfg)
        return sum(model.conv_flops(3, c, 1, shapes.level_hw(hw, s))
                   for s in HRFPN_STRIDES.values())


@pytest.fixture
def hrfpn(monkeypatch):
    """The lookup, finding the stand-in by its name and every other part as
    before."""
    found = parts.backbone
    monkeypatch.setattr(parts, "backbone", lambda cfg: HRFPNLevels
                        if cfg["MODEL.BACKBONE.NAME"] == "hrfpn_levels" else found(cfg))


def hrfpn_cfg(name):
    """The tiny configuration ``name`` on the stand-in's levels, every
    anchor of a level in its RPN problem."""
    cfg = tiny.conf(name)["model"]
    cfg.update({"MODEL.BACKBONE.NAME": "hrfpn_levels",
                "MODEL.RPN.IN_FEATURES": list(HRFPN_STRIDES),
                "MODEL.ROI_HEADS.IN_FEATURES": list(HRFPN_STRIDES),
                "MODEL.RPN.PRE_NMS_TOPK_TEST": 10 ** 6})
    return cfg


FRAME_HW = (90, 160)   # the tiny mix's frames, kept at 90 x 160; 64 pads them to 128 x 192
CANVAS = (128, 192)


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_counts_follow_the_backbones_strides(hrfpn, name):
    cfg = hrfpn_cfg(name)
    assert shapes.canvas(cfg, FRAME_HW) == CANVAS
    level = {f: shapes.level_hw(CANVAS, s) for f, s in HRFPN_STRIDES.items()}
    a = shapes.anchors_per_cell(cfg)
    assert shapes.rpn_problem_sizes(cfg, CANVAS) == [h * w * a for h, w in level.values()]
    got = model.forward_flops(cfg, CANVAS)
    c = cfg["MODEL.FPN.OUT_CHANNELS"]
    assert got["backbone"] == HRFPNLevels.flops(cfg, CANVAS)
    assert got["rpn"] == sum(model.conv_flops(c, c, 3, hw) + model.conv_flops(c, 5 * a, 1, hw)
                             for hw in level.values())
    dp = "MODEL.ROI_DENSEPOSE_HEAD."
    if cfg[dp + "DECODER_ON"]:
        dims = cfg[dp + "DECODER_CONV_DIMS"]
        # p1 lies at the common stride 4: one conv; p2 .. p5: 1, 2, 3, 4 steps
        # of a conv and a 2x upsample
        chains = {"p1": 1, "p2": 1, "p3": 2, "p4": 3, "p5": 4}
        assert reference.decoder_chains(cfg) == list(chains.items())
        want = sum(model.conv_flops(c if k == 0 else dims, dims, 3,
                                    shapes.level_hw(CANVAS, HRFPN_STRIDES[f] >> k))
                   for f, steps in chains.items() for k in range(steps))
        want += model.conv_flops(dims, cfg[dp + "DECODER_NUM_CLASSES"], 1,
                                 shapes.level_hw(CANVAS, 4))
        assert got["decoder"] == want
        convs = sorted(k[len("roi_heads.decoder."):-len(".weight")]
                       for k in reference.state_shapes(cfg)
                       if k.startswith("roi_heads.decoder.p") and k.endswith(".weight"))
        assert convs == ["p1.0", "p2.0", "p3.0", "p3.2", "p4.0", "p4.2", "p4.4",
                         "p5.0", "p5.2", "p5.4", "p5.6", "predictor"]
    else:
        assert got["decoder"] == 0.0


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_the_reference_follows_the_backbones_strides(hrfpn, monkeypatch, name):
    """One frame through the reference: each RPN level's anchors at its
    stride on a level of the canvas at that stride, each multi-level
    pooler's scales the inverse strides, and the decoder's chains meeting
    at its common stride 4 on p1's level."""
    cfg = hrfpn_cfg(name)
    seen = {"grid_anchors": [], "roi_align_levels": [], "conv": []}

    def spy(fn, pick):
        def wrapped(*args, **kw):
            seen[fn.__name__].append(pick(*args, **kw))
            return fn(*args, **kw)
        monkeypatch.setattr(ops, fn.__name__, wrapped)

    spy(ops.grid_anchors, lambda h, w, stride, *_: (stride, (h, w)))
    spy(ops.roi_align_levels, lambda feats, boxes, scales, *_: (
        list(scales), [tuple(f.shape[-2:]) for f in feats]))
    spy(ops.conv, lambda x, w, name, **_: (name, tuple(x.shape[-2:])))
    conf = tiny.conf(name)
    w = weights.make_weights(reference.state_shapes(cfg), conf["init"], 2 ** 31 + 3, "cpu",
                             "float32")
    image = torch.from_numpy(frames.FramePool(tiny.traffic(), 2 ** 31 + 3).batch(0)[0].copy())
    assert tuple(image.shape[:2]) == FRAME_HW
    assert reference.preprocess(cfg, image)[2] == CANVAS
    found = reference.detect(cfg, w, image)
    maps = reference.maps_at(cfg, w, found, torch.arange(min(4, found["net"].shape[0])))
    level = [shapes.level_hw(CANVAS, s) for s in HRFPN_STRIDES.values()]
    assert seen["grid_anchors"] == list(zip(HRFPN_STRIDES.values(), level))
    pooler = ([1.0 / s for s in HRFPN_STRIDES.values()], level)
    if cfg["MODEL.ROI_DENSEPOSE_HEAD.DECODER_ON"]:
        assert seen["roi_align_levels"] == [pooler]          # the box stage's
        assert ("roi_heads.decoder.predictor", level[0]) in seen["conv"]
    else:
        assert seen["roi_align_levels"] == [pooler, pooler]  # and the DensePose stage's
    assert maps and all(torch.isfinite(v).all() for v in maps.values())
