"""The HRNet-W48 + HRFPN configuration (``configs/hrnet_w48_f16.json``) and
its backbone part (``reference/backbones/build_hrfpn_backbone.py``) on the
CPU:

* the part's weights are the served model's folded module state dict, name
  for name and shape for shape, at narrowed and at published widths;
* a whole run of the harness at narrowed widths in float32: the plain
  reference against the program;
* the FLOP count against a count by hand at narrowed widths;
* at the published widths the file's ``init`` keeps p1 .. p5 finite in
  float16 with an RMS inside [0.1, 10];
* the bytes of HRFPN's 4x and 8x upsamples at the cell's shapes;
* the two readers this configuration adds: nothing to read gives None, and
  a fabricated trace or span record gives the number it should.

The narrowing is this file's own (``tiny.SHRINK`` holds ResNet widths):
branches of 8 .. 64 channels, HRFPN of 16, two modules in stage 3 and two
BasicBlocks a branch in stage 2, so that a chain of modules and of blocks
both run.
"""

import copy

import pytest
import torch

from benchmark import frames, manifest, readers, run, weights
from benchmark.counts import hrfpn, model, peaks, shapes
from benchmark.reference import model as reference
from benchmark.reference.backbones import build_hrfpn_backbone as part
from benchmark.tests import tiny

NAME = "hrnet_w48_f16"
CELL = f"{NAME}.cams8"
NARROW = {
    "MODEL.HRNET.STAGE2.NUM_CHANNELS": [8, 16], "MODEL.HRNET.STAGE3.NUM_CHANNELS": [8, 16, 32],
    "MODEL.HRNET.STAGE4.NUM_CHANNELS": [8, 16, 32, 64],
    "MODEL.HRNET.STAGE2.NUM_MODULES": 1, "MODEL.HRNET.STAGE3.NUM_MODULES": 2,
    "MODEL.HRNET.STAGE4.NUM_MODULES": 1,
    "MODEL.HRNET.STAGE2.NUM_BLOCKS": [2, 2], "MODEL.HRNET.STAGE3.NUM_BLOCKS": [1, 1, 1],
    "MODEL.HRNET.STAGE4.NUM_BLOCKS": [1, 1, 1, 1], "MODEL.HRNET.HRFPN.OUT_CHANNELS": 16,
}
SEED = 2 ** 31 + 11


def narrow_conf() -> dict:
    c = tiny.conf(NAME)
    c["model"].update(NARROW)
    c["opts"].update(NARROW)
    return c


def published_conf() -> dict:
    return copy.deepcopy(manifest.config(manifest.load(), NAME))


@pytest.mark.parametrize("conf", [narrow_conf, published_conf], ids=["narrow", "published"])
def test_weights_are_the_programs_state_dict(conf):
    from densepose_tpu_torch.models.rcnn import build_model
    c = conf()
    state = build_model(run.program_config(c, False)).state_dict()
    want = {k: tuple(v.shape) for k, v in state.items() if k.startswith("backbone.")}
    assert part.shapes(c["model"]) == want
    assert set(reference.state_shapes(c["model"])) == set(state)


def test_reference_matches_the_program():
    m = manifest.load()
    r = run.run_cell(m, manifest.cell(m, CELL), SEED, 1.5, False, device="cpu",
                     conf=narrow_conf(), traffic=tiny.traffic())
    n = {k: v["value"] for k, v in r["compared"].items()}
    assert r["checked_frames"] >= 2 and r["failed"] == 0 and r["diagnostics"]["pairs"] > 0
    assert n["size_err"] == 0 and n["unpaired"] == 0 and n["unpaired_frame"] == 0
    assert n["maps_rel"] < 1e-4
    assert r["correct"]


def test_flops_by_hand():
    cfg = narrow_conf()["model"]
    hw = (128, 192)
    b4, b8, b16, b32 = (h * w for h, w in ((32, 48), (16, 24), (8, 12), (4, 6)))

    def conv(cin, cout, k, area):
        return 2 * cin * cout * k * k * area

    stem = conv(3, 64, 3, 64 * 96) + conv(64, 64, 3, b4)
    layer1 = conv(64, 64, 1, b4) + conv(64, 256, 1, b4)        # block 0's conv1, shortcut
    layer1 += 4 * (conv(64, 64, 3, b4) + conv(64, 256, 1, b4)) + 3 * conv(256, 64, 1, b4)
    transitions = conv(256, 8, 3, b4) + conv(256, 16, 3, b8) + conv(16, 32, 3, b16) \
        + conv(32, 64, 3, b32)
    blocks = 2 * 2 * (conv(8, 8, 3, b4) + conv(16, 16, 3, b8))              # stage 2
    blocks += 2 * 2 * (conv(8, 8, 3, b4) + conv(16, 16, 3, b8) + conv(32, 32, 3, b16))
    blocks += 2 * (conv(8, 8, 3, b4) + conv(16, 16, 3, b8) + conv(32, 32, 3, b16)
                   + conv(64, 64, 3, b32))
    fuse2 = conv(16, 8, 1, b8) + conv(8, 16, 3, b8)
    fuse3 = (conv(16, 8, 1, b8) + conv(32, 8, 1, b16) + conv(8, 16, 3, b8)
             + conv(32, 16, 1, b16) + conv(8, 8, 3, b8) + conv(8, 32, 3, b16)
             + conv(16, 32, 3, b16))
    fuse4 = (conv(16, 8, 1, b8) + conv(32, 8, 1, b16) + conv(64, 8, 1, b32)
             + conv(8, 16, 3, b8) + conv(32, 16, 1, b16) + conv(64, 16, 1, b32)
             + conv(8, 8, 3, b8) + conv(8, 32, 3, b16) + conv(16, 32, 3, b16)
             + conv(64, 32, 1, b32)
             + conv(8, 8, 3, b8) + conv(8, 8, 3, b16) + conv(8, 64, 3, b32)
             + conv(16, 16, 3, b16) + conv(16, 64, 3, b32) + conv(32, 64, 3, b32))
    neck = conv(120, 16, 1, b4) + sum(conv(16, 16, 3, area) for area in
                                      (b4, b8, b16, b32, 2 * 3))
    want = stem + layer1 + transitions + blocks + fuse2 + 2 * fuse3 + fuse4 + neck
    assert part.flops(cfg, hw) == want
    assert model.forward_flops(cfg, hw)["backbone"] == want


def test_published_init_keeps_float16_levels_in_range():
    """At the published widths on a 128x192 canvas, the configuration's
    gains keep every level finite in float16, at an RMS near unit."""
    c = published_conf()
    cfg = c["model"]
    w = weights.make_weights(part.shapes(cfg), c["init"], SEED, "cpu", "float16")
    x = reference.preprocess(dict(cfg, **{"INPUT.MIN_SIZE_TEST": 96,
                                          "INPUT.MAX_SIZE_TEST": 160}),
                             torch.from_numpy(frames.FramePool(tiny.traffic(), SEED)
                                              .batch(0)[0].copy()))[0]
    assert tuple(x.shape[-2:]) == (128, 192)
    with torch.no_grad():
        levels = part.forward(cfg, {k: v.half() for k, v in w.items()}, x.half())
    assert list(levels) == ["p1", "p2", "p3", "p4", "p5"]
    for name, y in levels.items():
        assert y.dtype == torch.float16 and bool(torch.isfinite(y).all()), name
        rms = float(y.float().pow(2).mean().sqrt())
        assert 0.1 <= rms <= 10, (name, rms)


def test_upsample_bytes_at_the_cells_shapes():
    cfg = published_conf()["model"]
    hw = shapes.canvas(cfg, (720, 1280))
    assert hw == (768, 1344)
    nbytes = hrfpn.upsample_bytes(cfg, hw, 8, 2)
    # read: 192 x 48 x 84 + 384 x 24 x 42; written: 576 x 192 x 336; 8 frames, 2 bytes
    assert nbytes == 8 * 2 * (192 * 48 * 84 + 384 * 24 * 42 + 576 * 192 * 336)
    assert round(nbytes / 1e6, 1) == 613.1
    assert hrfpn.upsample_bound_s(cfg, hw, 8, 2) == nbytes / peaks.HBM_BYTES_PER_S
    assert round(hrfpn.upsample_bound_s(cfg, hw, 8, 2) * 1e3, 3) == 0.183


def cell_run(**kw) -> readers.Run:
    return readers.Run(cfg=published_conf()["model"], traffic=manifest.traffic("cams8"),
                       batch=8, elem_bytes=2, **kw)


def test_readers_read_nothing_without_a_trace_or_spans(monkeypatch):
    roofline = manifest.reader("hrfpn_upsample_roofline")
    host = manifest.reader("hrnet_host_ms")
    assert roofline(cell_run()) is None
    assert host(cell_run()) is None
    from densepose_tpu_torch.utils import timing
    monkeypatch.setattr(timing, "spans", lambda: [])
    assert host(cell_run(submit_s=[0.1, 0.1])) is None
    # a tree whose calls hold no hrnet span, as a ResNet model's or the
    # parent program's
    monkeypatch.setattr(timing, "spans", lambda: [
        timing.Span("backbone", "predict_batch", 1, 0, 5),
        timing.Span("predict_batch", None, 1, 0, 9)])
    assert host(cell_run(submit_s=[0.1])) is None
    monkeypatch.delattr(timing, "spans")
    assert host(cell_run(submit_s=[0.1])) is None


def test_roofline_reads_a_fabricated_trace():
    kernel = "void at::native::upsample_bilinear2d_out_frame<c10::Half, float>(...)"
    trace = {"busy_s": 1.0, "window_s": 2.0, "batches": 4, "stage_s": {},
             "op_s": {kernel: 0.004, "upsample2x_kernel": 0.5, "conv": 1.0}}
    r = cell_run(trace=trace)
    bound = hrfpn.upsample_bound_s(r.cfg, (768, 1344), 8, 2)
    got = manifest.reader("hrfpn_upsample_roofline")(r)
    assert got == pytest.approx(100.0 * bound * 4 / 0.004)
    assert manifest.reader("hrfpn_upsample_roofline")(
        cell_run(trace=dict(trace, op_s={"conv": 1.0}))) is None


def test_host_ms_reads_the_batches_submit_ms_reads(monkeypatch):
    """Two older batches and the last two, each with its hrnet span under
    backbone; the reader takes the last len(submit_s) predict_batch roots."""
    from densepose_tpu_torch.utils import timing
    got = []
    for call, ms in ((1, 9.0), (2, 9.0), (3, 2.0), (4, 4.0)):
        ns = int(ms * 1e6)
        got += [timing.Span("hrnet", "backbone", call, 100, 100 + ns),
                timing.Span("hrfpn", "backbone", call, 100 + ns, 200 + ns),
                timing.Span("backbone", "predict_batch", call, 50, 300 + ns),
                timing.Span("predict_batch", None, call, 0, 400 + ns)]
    monkeypatch.setattr(timing, "spans", lambda: got)
    value = manifest.reader("hrnet_host_ms")(cell_run(submit_s=[0.01, 0.01]))
    assert value == pytest.approx(3.0)
