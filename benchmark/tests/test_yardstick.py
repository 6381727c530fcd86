"""The yardstick on the CPU: the manifest's rules, the frames, the
whole-window arithmetic, the operation and FLOP counts, the trace reduction
and the pairing of detections."""

import copy

import numpy as np
import pytest

from benchmark import check, frames, manifest, readers, stats, trace
from benchmark.counts import kernels, model, shapes


@pytest.fixture
def m():
    return manifest.load()


def test_manifest_is_sound(m):
    assert manifest.problems(m) == []


@pytest.mark.parametrize("edit, problem", [
    (lambda m: m["workloads"][0].update(name="a b"), "name"),
    (lambda m: m["end_to_end"][0].update(unit="frames per s"), "unit"),
    (lambda m: m["per_layer"][0].update(moves="nope"), "moves"),
    (lambda m: m["end_to_end"][0].update(workloads=[m["workloads"][1]["name"]]),
     "does not report"),
    (lambda m: m["workloads"].pop(), "no cell"),
    (lambda m: m["end_to_end"][1].update(bound=0.3), "bound"),
    (lambda m: m["per_layer"][0].update(why="x"), "keys"),
])
def test_manifest_problems_found(m, edit, problem):
    bad = copy.deepcopy(m)
    edit(bad)
    assert any(problem in p for p in manifest.problems(bad))


def test_every_metric_has_a_reader(m):
    for e in m["end_to_end"] + m["per_layer"]:
        assert callable(manifest.reader(e["name"]))


def test_cams4_needs_only_data(m, tmp_path):
    """A further cell is a traffic file and a workloads entry."""
    bad = copy.deepcopy(m)
    bad["workloads"].append(dict(bad["workloads"][0], name="r50_fpn_s1x_f16.cams4",
                                 traffic="cams4"))
    assert manifest.problems(bad) == []


TRAFFIC = {"batch": 3, "frame_hw": [40, 80], "base_batches": 2,
           "frame": {"noise": 0.3, "blobs": 2, "blob_sigma": [5, 20], "blob_amp": 180}}


def test_frames_deterministic_and_distinct():
    a = frames.FramePool(TRAFFIC, 2 ** 31 + 5)
    b = frames.FramePool(TRAFFIC, 2 ** 31 + 5)
    c = frames.FramePool(TRAFFIC, 2 ** 31 + 6)
    seen = set()
    for i in range(5):
        x = a.batch(i).copy()
        assert np.array_equal(x, b.batch(i))
        assert not np.array_equal(x, c.batch(i))
        for f in x:
            seen.add(f.tobytes())
    assert len(seen) == 5 * TRAFFIC["batch"]


def test_stamp_holds_the_number():
    f = np.zeros((8, 80, 3), np.uint8)
    frames.stamp(f, 0b1011)
    bits = f[0, 0:2 * frames.STAMP_BITS:2, 0] // 255
    assert list(bits[:5]) == [1, 1, 0, 1, 0]


def test_p95_and_rates_over_the_whole_window():
    lat = list(range(1, 101))  # 1 .. 100 ms
    run = readers.Run(cfg={}, traffic={}, batch=8, elem_bytes=2, frames=800, window_s=10.0,
                      latencies_ms=[float(v) for v in lat], peak_bytes=3 * 2 ** 20)
    assert manifest.reader("latency_p95_ms")(run) == pytest.approx(95.05)
    assert manifest.reader("frames_per_s")(run) == pytest.approx(80.0)
    assert manifest.reader("peak_mem_mib")(run) == pytest.approx(3.0)
    assert stats.p95([3.0] * 19 + [100.0]) == pytest.approx(3.0 + 0.05 * 97.0)


def test_per_layer_readers_silent_without_a_trace(m):
    run = readers.Run(cfg={}, traffic={}, batch=8, elem_bytes=2)
    for e in m["per_layer"]:
        assert manifest.reader(e["name"])(run) is None


def test_v1convx_head_flops(m):
    cfg = manifest.config(m, "r50_fpn_s1x_f16")["model"]
    want = 100 * (2 * 256 * 512 * 9 * 28 * 28 + 7 * 2 * 512 * 512 * 9 * 28 * 28)
    assert model.densepose_head_flops(cfg) == want
    legacy = manifest.config(m, "r101_fpn_legacy_f16")["model"]
    assert model.densepose_head_flops(legacy) == 100 * 8 * 2 * 256 * 512 * 9 * 14 * 14 \
        + 100 * 7 * 2 * 512 * 512 * 9 * 14 * 14 - 100 * 2 * 256 * 512 * 9 * 14 * 14 * 7


def test_forward_flops(m):
    cfg = manifest.config(m, "r50_fpn_s1x_f16")["model"]
    hw = shapes.canvas(cfg, (720, 1280))
    assert hw == (768, 1344)
    f = model.forward_flops(cfg, hw)
    # the stem: 2 * 3 * 64 * 49 at 384 x 672
    assert model.conv_flops(3, 64, 7, (384, 672)) == 2 * 3 * 64 * 49 * 384 * 672
    # the predictor: four 4x4 stride-2 deconvs 512 -> 2 + 25 * 3 on 100 28x28 regions
    assert f["densepose_predictor"] == 2 * 512 * 77 * 16 * 28 * 28 * 100
    assert f["total"] == pytest.approx(sum(v for k, v in f.items() if k != "total"))


def test_kernel_counts(m):
    ops, nbytes = kernels.k1_work([1000, 756])
    assert ops == (1000 * 999 / 2 + 756 * 755 / 2) * 13
    assert nbytes == (1000 + 756) * 18
    ops, nbytes = kernels.k2_work(800, 256, 28, 2, 2)
    assert ops == 800 * 256 * 784 * 33
    assert nbytes == 800 * 256 * 784 * 2 + 800 * 24
    cfg = manifest.config(m, "r50_fpn_s1x_f16")["model"]
    assert shapes.rpn_problem_sizes(cfg, (768, 1344)) == [1000, 1000, 1000, 1000, 756]
    assert kernels.bound_s(67e12, 0) == pytest.approx(1.0)


def test_trace_attribution_and_gaps():
    ms = 1_000_000
    ev = trace.Events(
        ranges=[(trace.BATCH_RANGE, 0, 100 * ms), ("backbone", 1 * ms, 10 * ms),
                ("densepose_head", 10 * ms, 20 * ms), ("bench.fetch", 20 * ms, 100 * ms)],
        launches={1: 2 * ms, 2: 11 * ms, 3: 12 * ms},
        device=[("conv", 5 * ms, 30 * ms, 1, 0), ("gemm", 30 * ms, 50 * ms, 9, 2),
                ("relu", 60 * ms, 70 * ms, 3, 0)])
    s = trace.summarize(ev, ["backbone", "densepose_head"])
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == pytest.approx(0.055)
    assert s["stage_s"]["backbone"] == pytest.approx(0.025)
    assert s["stage_s"]["densepose_head"] == pytest.approx(0.030)
    assert s["attributed"] == pytest.approx(1.0)
    gaps = dict(s["idle_gaps"])
    assert gaps["bench.fetch"] == pytest.approx(0.040)
    assert gaps["backbone"] == pytest.approx(0.005)


RULES = {"MODEL.ROI_HEADS.SCORE_THRESH_TEST": 0.05, "MODEL.ROI_HEADS.NMS_THRESH_TEST": 0.5,
         "TEST.DETECTIONS_PER_IMAGE": 100}


def one_frame(d=6, seed=0):
    """A frame's det_packed and maps, and a reference whose candidates are
    the same detections plus two far-off ones under the score threshold."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 500, (d, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(20, 80, (d, 2))], 1).astype(np.float32)
    scores = np.linspace(0.9, 0.4, d).astype(np.float32)
    det = np.zeros((d + 1, 7), np.float32)
    det[:d, :4], det[:d, 4], det[:d, 6] = boxes, scores, 1
    det[d, :3] = [d, 720, 1280]
    maps = {k: rng.normal(size=(d, 2, 4, 4)).astype(np.float32) for k in check.MAPS}
    extra = np.array([[600, 600, 700, 700], [0, 0, 10, 10]], np.float32)
    ref = {"image_size": np.array([720, 1280]), "boxes": np.concatenate([extra, boxes]),
           "scores": np.concatenate([[0.03, 0.02], scores]).astype(np.float32),
           "classes": np.zeros(d + 2, np.int64), "valid": np.ones(d + 2, bool),
           "keep": np.arange(2, d + 2)}
    ref["net"] = ref["boxes"]

    def ref_maps(rows):
        return {k: v[np.asarray(rows) - 2] for k, v in maps.items()}

    return det, maps, ref, ref_maps


def numbers(det, maps, ref, ref_maps, rules=RULES):
    c = check.Comparison((720, 1280), rules)
    c.frame(det, maps, ref, ref_maps)
    return c.numbers()


def test_pairing_and_numbers():
    det, maps, ref, ref_maps = one_frame()
    assert numbers(det, maps, ref, ref_maps) == {"size_err": 0.0, "unpaired": 0.0,
                                                 "unpaired_frame": 0.0, "maps_rel": 0.0}
    # 6 program detections and 6 reference detections judged: a moved or
    # rescored detection pairs with nothing, and leaves its candidate uncovered
    moved = det.copy()
    moved[0, :4] += 2.0
    assert numbers(moved, maps, ref, ref_maps)["unpaired"] == pytest.approx(2 / 12)
    rescored = det.copy()
    rescored[1, 4] -= 0.05
    assert numbers(rescored, maps, ref, ref_maps)["unpaired"] == pytest.approx(2 / 12)
    dropped = det.copy()
    dropped[2, 6] = 0
    assert numbers(dropped, maps, ref, ref_maps)["unpaired"] == pytest.approx(1 / 11)
    scaled = {k: v * (1.1 if k == "u" else 1.0) for k, v in maps.items()}
    assert numbers(det, scaled, ref, ref_maps)["maps_rel"] == pytest.approx(0.1, rel=1e-5)
    limits = {"size_err": 0, "unpaired": 0.05, "unpaired_frame": 0.05, "maps_rel": 0.05}
    assert check.verdict(numbers(det, maps, ref, ref_maps), limits)
    assert not check.verdict(numbers(moved, maps, ref, ref_maps), limits)
    sized = det.copy()
    sized[-1, 1] = 721
    assert numbers(sized, maps, ref, ref_maps)["size_err"] == 1


def with_candidate(ref, box, score):
    """``ref`` with one more candidate, suppressed by the reference."""
    out = dict(ref)
    out["boxes"] = np.concatenate([ref["boxes"], np.asarray([box], np.float32)])
    out["net"] = out["boxes"]
    out["scores"] = np.concatenate([ref["scores"], [score]]).astype(np.float32)
    out["classes"] = np.concatenate([ref["classes"], [0]])
    out["valid"] = np.concatenate([ref["valid"], [True]])
    return out


def with_detection(det, maps, box, score):
    """``det`` with one more detection, its maps those of detection 0."""
    d = int(det[-1, 0])
    out = np.zeros((d + 2, 7), np.float32)
    out[:d] = det[:d]
    out[d, :4], out[d, 4], out[d, 6] = box, score, 1
    out[d + 1, :3] = [d + 1, 720, 1280]
    return out, {k: np.concatenate([v, v[:1]]) for k, v in maps.items()}


def beside(box, iou):
    """``box`` shifted right so that the two overlap by ``iou``."""
    x1, y1, x2, y2 = (float(v) for v in box)
    w = x2 - x1
    dx = w * (1 - iou) / (1 + iou)
    return [x1 + dx, y1, x2 + dx, y2]


def test_a_detection_that_nms_removes_is_wrong():
    """The program keeps a candidate that overlaps a higher-scored kept one
    by 0.7 (NMS off, or run at too high a threshold): wrong, although it
    pairs."""
    det, maps, ref, ref_maps = one_frame()
    box = beside(det[0, :4], 0.7)
    ref = with_candidate(ref, box, 0.85)
    det, maps = with_detection(det, maps, box, 0.85)
    assert numbers(det, maps, ref, lambda rows: {k: v[:len(rows)] for k, v in maps.items()}
                   )["unpaired"] == pytest.approx(1 / 13)


@pytest.mark.parametrize("iou, score", [(0.7, 0.895), (0.515, 0.85)],
                         ids=["score_tie", "overlap_tie"])
def test_near_ties_of_nms_are_excused(iou, score):
    """Where the reference's NMS decided by a near tie, the program may have
    decided the other way: kept the candidate whose score lies within
    SCORE_TOL of its suppressor's in its place, or kept one overlapping it
    by less than NMS_THRESH_TEST + IOU_TOL beside it."""
    det, maps, ref, ref_maps = one_frame()
    box = beside(det[0, :4], iou)
    ref = with_candidate(ref, box, score)
    if score > 0.89:  # the program keeps the tie instead of detection 0
        det = det.copy()
        det[0, :4], det[0, 4] = box, score
    else:
        det, maps = with_detection(det, maps, box, score)
    got = numbers(det, maps, ref, lambda rows: {k: v[:len(rows)] for k, v in maps.items()})
    assert got["unpaired"] == 0.0


def test_a_full_frame_need_not_reach_below_its_cut():
    """Where the program filled every slot, a candidate scoring under its
    lowest detection is not missed; where it did not, it is."""
    det, maps, ref, ref_maps = one_frame()
    ref = with_candidate(ref, [700, 10, 760, 70], 0.3)
    assert numbers(det, maps, ref, ref_maps)["unpaired"] == pytest.approx(1 / 12)
    full = dict(RULES, **{"TEST.DETECTIONS_PER_IMAGE": 6})
    assert numbers(det, maps, ref, ref_maps, full)["unpaired"] == 0.0


def test_one_frame_of_wrong_answers_reads_one():
    """Two frames, the second with another frame's answers: the share of
    the frames together is a half, the second frame's alone 1."""
    det, maps, ref, ref_maps = one_frame()
    other, _, ref_other, _ = one_frame(seed=1)
    c = check.Comparison((720, 1280), RULES)
    c.frame(det, maps, ref, ref_maps)
    c.frame(det, maps, ref_other, lambda rows: {k: v[:len(rows)] for k, v in maps.items()})
    got = c.numbers()
    assert got["unpaired"] == pytest.approx(0.5) and got["unpaired_frame"] == 1.0


def test_nearest_by_score_among_equal_boxes():
    det, maps, ref, ref_maps = one_frame()
    ref["boxes"][0] = ref["boxes"][2]  # a duplicate box of detection 0, 0.005 lower
    ref["scores"][0] = ref["scores"][2] - 0.005
    b, s, cl, valid, _, _ = check.unpack(det)
    found = check.pairs(b[valid], s[valid], cl[valid], ref["boxes"], ref["scores"],
                        ref["classes"])
    assert found[0] == (0, 2)
