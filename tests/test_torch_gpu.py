"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips where no CUDA device is present.
This file imports only torch and numpy, so it runs on a machine without JAX:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

K1 (NMS) must match exactly, also at its edge cases
(``tests/torch_cases.py::k1_edge_cases``); K2 (ROIAlign) bit for bit at a fixed
ratio (the kernel performs the plain version's roundings in its order) and
within 1e-5 absolute at ratio 0 on unit-scale features. K3 (the skip-flag
ROIAlign) within 1e-5 of its plain version, which contracts the same weights
in another order, and 2e-5 of K2, at ratios 1, 2 and 8, M = 0, 1 and 3000,
and on the edge cases of ``tests/torch_cases.py::k3_edge_cases``; two runs
the same bits, one launch a call, and no stack frame or spills in ptxas.

Q1 (the s8 implicit-GEMM convolution of the int8 serving mode), each of its
two variants at every shape it takes, bit for bit against its plain version
(float64 sums, exact) and two runs the same bits, at ragged shapes: Cin not a
multiple of 64 or of 16 (40, 20, 600, 720), Cout 2 / 15 / 77, M tails,
stride 2, dilation 2, the 4x4 / stride 2 transposed convolution, each
epilogue output (int32 sums, s8, f32, f16, bf16) with and without ReLU; one
launch a call, counted under its variant; a head link routed to the wgmma
variant; shapes that break the wgmma variant's preconditions refused when
forced to it; and a small int8 flagship request with every Q1 launch held
against the plain version, its head on the wgmma variant.

The four kernels as operators (``ops/library.py``): each through
``torch.ops.densepose_tpu_torch`` on CUDA tensors, one launch of its kernel a
call, against its plain version as above, and ``torch.library.opcheck`` on
the card; and a small flagship request exported as a program
(``aot_export_bytes`` / ``aot_load``) against the eager request: detections
exact, maps within SERVED_AGAIN_TOL (cuDNN's transposed convolutions add
with atomics), the program's K1 and K2 launches counted.

Batched frames: K2 and K3 on (N, C, H, W) levels with a frame index per box,
one launch for every frame, against their plain versions as above and
against the kernel on each frame's levels alone (bit for bit: a box's output
does not depend on the other boxes); Q1 at N = 3 images equal to each image
alone; and a small predictor's ``predict_batch`` (one batched forward, 2 K1
and 2 K2 launches) against ``forward_batch`` of each frame alone, with cuDNN
off so that the convolutions compute each frame alone: detections exact,
maps within SERVED_AGAIN_TOL; ``data_parallel_forward`` with two replicas on
the card the same.

Spatial sharding of one frame (``parallel/mesh.py::spatial_parallel_forward``):
small flagship (fp32 and float16), R101 legacy on K3, HRNet and max-serving
int8 predictors with the frame's rows over this card listed 2 and 4 times,
against ``forward_batch`` of the frame unsharded with cuDNN off: the
gathered pyramid within 1e-5 of each level's largest magnitude (at float16,
8 units in its last place: the half GEMMs round a slab apart from the whole
map), detections exact and maps within SERVED_AGAIN_TOL (at float16, on
random weights, whose scores tie, only finite outputs of the right form);
every K1, K2, K3 and Q1 launch of the sharded request held against its
plain version (Q1 on halo-extended slabs with row padding 0).

The C4 detector, BasicBlock R34 and the RetinaNet FPN: K1's per-class route
(80 problems of 1000 boxes, the box stage of an 80-class detector, which one
problem of 80000 boxes with a class row exceeded) with every launch equal to
the plain version, also against the classed route where K1 takes it; K2 at
the C4 pooler's site (res4 at 1/16, 1024 channels, 14x14 ROIAlignV2 at ratio
0, 1000 boxes) against its plain version; small C4 requests (fp32, float16,
INT8_BACKBONE: 42 Q1 links through res2..res4), R34-FPN and RetinaNet
requests with every kernel launch held; and C4, R18-FPN and RetinaNet
sharded over this card twice against their unsharded request.

At a half dtype (float16, bfloat16): K2<T> bit-identical to K2 on the
widened levels rounded to T (only its loads and its store change), and to
its plain version at T; K3<T> within one unit in the last place of T, at the
output's largest magnitude, of its plain version at T (stage-1 rows rounded
to T may round the other way where their fp32 sums differ in order). A half
predictor's outputs: detections in fp32, maps in the dtype, finite; a
bfloat16 map fetched as float32 equal to the device values widened.
"""

import math


import numpy as np
import pytest
import torch

from densepose_tpu_torch.models.rcnn import image_tensor
from densepose_tpu_torch.ops import conv_int8, cuda_build, nms, roi_align, roi_align_sparse
from torch_cases import (  # tests/ is on the path (rootdir insertion)
    BASIC_BLOCK, C4_DETECTION, C4_TAME, RETINANET, batched_pooler_cases, k1_edge_cases,
    k3_edge_cases, op_args, op_cases, per_class_nms_case, set_cfg, tame, unit_variance_)

torch.set_num_threads(2)

K3_IMAGE_HW = (256, 1024)  # input size of K3's pyramid: p2 64x256 .. p5 8x32
K3_SCALES = [1 / 4, 1 / 8, 1 / 16, 1 / 32]


def k3_pyramid(c, device):
    return [torch.randn(c, K3_IMAGE_HW[0] // 4 // 2 ** i, K3_IMAGE_HW[1] // 4 // 2 ** i,
                        generator=torch.Generator().manual_seed(i)).to(device) for i in range(4)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def boxes_np(rng, k, span, size):
    ctr = rng.rand(k, 2).astype(np.float32) * span
    wh = rng.rand(k, 2).astype(np.float32) * size + 1
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], 1)


@pytest.mark.gpu
@pytest.mark.parametrize("classed", [False, True])
def test_k1_matches_plain(cuda, classed):
    rng = np.random.RandomState(11)
    b = torch.from_numpy(np.stack([boxes_np(rng, 1000, 800, 200) for _ in range(5)]))
    v = torch.from_numpy(rng.rand(5, 1000) > 0.1)
    c = torch.from_numpy(rng.randint(0, 3, size=(5, 1000)).astype(np.int32)) if classed else None
    want = nms.nms_keep_plain(b, v, 0.7, c)
    before = nms.nms_keep_cuda.launches
    got = nms.nms_keep(b.to(cuda), v.to(cuda), 0.7, None if c is None else c.to(cuda))
    torch.cuda.synchronize()
    assert nms.nms_keep_cuda.launches == before + 1
    assert 0 < int(want.sum()) < int(v.sum())
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("aligned", [False, True])
def test_k2_matches_plain(cuda, aligned):
    rng = np.random.RandomState(12)
    feats = [torch.randn(64, 64 // 2 ** i, 96 // 2 ** i, generator=torch.Generator().manual_seed(i))
             .to(cuda) for i in range(4)]
    b = boxes_np(rng, 300, 380, 120)
    # no sample in border along one axis or both: nothing to stage
    b[:3] = [[10, 300, 60, 300], [500, 20, 520, 90], [-90, -80, -40, -30]]
    b = torch.from_numpy(b).to(cuda)
    lv = roi_align.assign_boxes_to_levels(b, 2, 5)
    scales = [1 / 4, 1 / 8, 1 / 16, 1 / 32]
    want = roi_align.roi_align_plain(feats, b, lv, scales, (7, 7), 2, aligned)
    before = roi_align.roi_align_cuda.launches
    got = roi_align.roi_align_multilevel(feats, b, lv, scales, (7, 7), 2, aligned)
    torch.cuda.synchronize()
    assert roi_align.roi_align_cuda.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("aligned,out", [(False, 7), (True, 28)])
def test_k2_adaptive_ratio_matches_plain(cuda, aligned, out):
    rng = np.random.RandomState(15)
    feats = [torch.randn(32, 64 // 2 ** i, 96 // 2 ** i, generator=torch.Generator().manual_seed(i))
             .to(cuda) for i in range(4)]
    b = torch.from_numpy(boxes_np(rng, 200, 380, 300)).to(cuda)
    lv = torch.from_numpy(rng.randint(0, 4, size=200).astype(np.int32)).to(cuda)
    scales = [1 / 4, 1 / 8, 1 / 16, 1 / 32]
    want = roi_align.roi_align_plain(feats, b, lv, scales, (out, out), 0, aligned)
    got = roi_align.roi_align_multilevel(feats, b, lv, scales, (out, out), 0, aligned)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", k1_edge_cases(), ids=lambda case: case[0])
def test_k1_edge_cases_match_plain(cuda, case):
    _, b, v, c, thr = case
    args = [torch.from_numpy(b)[None], torch.from_numpy(v)[None], thr,
            None if c is None else torch.from_numpy(c)[None]]
    want = nms.nms_keep_plain(*args)
    before = nms.nms_keep_cuda.launches
    got = nms.nms_keep(*[a.to(cuda) if torch.is_tensor(a) else a for a in args])
    torch.cuda.synchronize()
    assert nms.nms_keep_cuda.launches == before + 1  # two kernels, one counted call
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [3100, 16384])
def test_k1_many_boxes_match_plain(cuda, k):
    """Scan stages of 32 and of 8 rows (the two buffers stay within 48 KB)."""
    rng = np.random.RandomState(16)
    b = torch.from_numpy(boxes_np(rng, k, 2000, 150))[None].to(cuda)
    v = torch.from_numpy(rng.rand(1, k) > 0.1).to(cuda)
    want = nms.nms_keep_plain(b, v, 0.5)
    got = nms.nms_keep_cuda(b, v, 0.5)
    torch.cuda.synchronize()
    assert 0 < int(want.sum()) < int(v.sum())
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_k1_refuses_too_many_boxes(cuda):
    k = 16385  # past the scan's 256 register words of 64 boxes
    with pytest.raises(ValueError, match="at most 16384 boxes"):
        nms.nms_keep_cuda(torch.zeros(1, k, 4, device=cuda),
                          torch.ones(1, k, dtype=torch.bool, device=cuda), 0.5)


HALF = [torch.float16, torch.bfloat16]
EPS = {torch.float16: 2.0 ** -10, torch.bfloat16: 2.0 ** -7}  # a unit in the last place at 1


def ulp(dtype, t):
    """One unit in the last place of ``dtype`` at the largest magnitude of ``t``."""
    return EPS[dtype] * 2.0 ** math.floor(math.log2(max(float(t.abs().max()), 2.0 ** -14)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("ratio,out", [(2, 7), (2, 28), (0, 7)])
def test_k2_half_is_rounded_float(cuda, dtype, ratio, out):
    rng = np.random.RandomState(16)
    feats = [torch.randn(48, 64 // 2 ** i, 96 // 2 ** i, generator=torch.Generator().manual_seed(i))
             .to(cuda).to(dtype) for i in range(4)]
    b = torch.from_numpy(boxes_np(rng, 300, 380, 200)).to(cuda)
    lv = roi_align.assign_boxes_to_levels(b, 2, 5)
    args = (b, lv, [1 / 4, 1 / 8, 1 / 16, 1 / 32], (out, out), ratio, False)
    before = roi_align.roi_align_cuda.launches
    got = roi_align.roi_align_multilevel(feats, *args)
    upcast = roi_align.roi_align_cuda([f.float() for f in feats], *args)
    plain = roi_align.roi_align_plain(feats, *args)
    torch.cuda.synchronize()
    assert roi_align.roi_align_cuda.launches == before + 2
    assert got.dtype == plain.dtype == dtype
    assert torch.equal(got, upcast.to(dtype))
    assert torch.equal(got, plain)
    assert float(got.abs().max()) > 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("m", [0, 1, 3000])
def test_k3_half_within_one_ulp(cuda, dtype, m):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(18)
    feats = [f.to(dtype) for f in k3_pyramid(40, cuda)]
    b = torch.from_numpy(boxes_np(rng, m, np.float32(K3_IMAGE_HW[::-1]), 200)).to(cuda)
    lv = roi_align.assign_boxes_to_levels(b, 2, 5)
    args = (feats, b, lv, K3_SCALES, (7, 7), 2, False)
    before = roi_align_sparse.roi_align_sparse_cuda.launches
    got = roi_align_sparse.roi_align_sparse_cuda(*args)
    again = roi_align_sparse.roi_align_sparse_cuda(*args)
    want = roi_align_sparse.roi_align_sparse_plain(*args)
    torch.cuda.synchronize()
    assert roi_align_sparse.roi_align_sparse_cuda.launches == before + 2 * (m > 0)
    assert got.dtype == want.dtype == dtype and got.shape == (m, 40, 7, 7)
    assert torch.equal(got, again)
    if m:
        err = float((got.float() - want.float()).abs().max())
        assert err <= ulp(dtype, want), (err, ulp(dtype, want))
        assert float(want.abs().max()) > 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("aligned", [False, True])
def test_k3_matches_plain(cuda, aligned, monkeypatch):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(13)
    feats = k3_pyramid(64, cuda)
    b = torch.from_numpy(boxes_np(rng, 300, 900, 200)).to(cuda)
    lv = roi_align.assign_boxes_to_levels(b, 2, 5)
    args = (feats, b, lv, K3_SCALES, (7, 7), 2, aligned)
    want = roi_align_sparse.roi_align_sparse_plain(*args)
    monkeypatch.setenv("DENSEPOSE_TPU_SPARSE_POOLER", "1")
    before = roi_align_sparse.roi_align_sparse_cuda.launches
    got = roi_align.roi_align_multilevel(*args)
    again = roi_align.roi_align_multilevel(*args)
    torch.cuda.synchronize()
    assert roi_align_sparse.roi_align_sparse_cuda.launches == before + 2
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-5, rtol=0)


def check_k3(feats, b, lv, out_hw, ratio, aligned):
    """K3 against its plain version (1e-5) and, on the boxes with a level,
    against K2 (2e-5), one launch a call, two calls the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = (feats, b, lv, K3_SCALES, out_hw, ratio, aligned)
    before = roi_align_sparse.roi_align_sparse_cuda.launches
    got = roi_align_sparse.roi_align_sparse_cuda(*args)
    again = roi_align_sparse.roi_align_sparse_cuda(*args)
    torch.cuda.synchronize()
    assert roi_align_sparse.roi_align_sparse_cuda.launches == before + 2 * (b.shape[0] > 0)
    assert got.shape == (b.shape[0], feats[0].shape[0], *out_hw)
    assert torch.equal(got, again)
    want = roi_align_sparse.roi_align_sparse_plain(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-5, rtol=0)
    ok = (lv >= 0) & (lv < len(feats))
    gather = roi_align.roi_align_cuda(feats, b[ok].contiguous(), lv[ok].contiguous(), K3_SCALES,
                                      out_hw, ratio, aligned)
    np.testing.assert_allclose(got[ok].cpu().numpy(), gather.cpu().numpy(), atol=2e-5, rtol=0)
    assert torch.equal(got[~ok], torch.zeros_like(got[~ok]))
    return want


@pytest.mark.gpu
@pytest.mark.parametrize("ratio", [1, 2, 8])
@pytest.mark.parametrize("m", [0, 1, 3000])
def test_k3_sizes_and_ratios(cuda, m, ratio):
    """M = 0 (no launch), 1 and 3000 boxes, ratios 1, 2 (the compiled grid)
    and 8 (the most K3 takes), a channel count that no slab divides, two
    boxes with no level."""
    rng = np.random.RandomState(17)
    feats = k3_pyramid(37, cuda)
    b = torch.from_numpy(boxes_np(rng, m, np.float32(K3_IMAGE_HW[::-1]), 200)).to(cuda)
    lv = roi_align.assign_boxes_to_levels(b, 2, 5)
    if m > 2:
        lv[:2] = torch.tensor([-1, 4], dtype=torch.int32)
    want = check_k3(feats, b, lv, (7, 7), ratio, False)
    assert m == 0 or float(want.abs().max()) > 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("aligned,out", [(False, 7), (True, 14)])
@pytest.mark.parametrize("case", k3_edge_cases(K3_IMAGE_HW), ids=lambda case: case[0])
def test_k3_edge_cases_match_plain(cuda, case, aligned, out):
    _, b, lv = case
    check_k3(k3_pyramid(24, cuda), torch.from_numpy(b).to(cuda), torch.from_numpy(lv).to(cuda),
             (out, out), 2, aligned)


@pytest.mark.gpu
def test_k3_no_stack_frame(cuda):
    """ptxas keeps K3's tables in shared memory and its sums in registers."""
    report = cuda_build.ptxas_report(cuda_build.build(["roi_align_sparse"])["roi_align_sparse"].log)
    kernels = [k for k in report if k["kernel"].startswith("roi_align_sparse_kernel")]
    assert len(kernels) == 6, report  # float, __half, __nv_bfloat16 x ratio 2, any ratio
    for k in kernels:
        assert (k["stack"], k["spill_stores"], k["spill_loads"]) == (0, 0, 0), k


@pytest.mark.gpu
def test_k3_refuses_cpu_tensors(cuda):
    feats = [torch.zeros(8, 16, 16)]
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_sparse.roi_align_sparse_cuda(feats, torch.zeros(3, 4),
                                               torch.zeros(3, dtype=torch.int32), [0.25],
                                               (7, 7), 2, False)


def small_flagship_predictor(device, dtype="float32", extra=()):
    """The flagship at full width on a small input, with random weights."""
    from densepose_tpu_torch.model_zoo import get_config
    from densepose_tpu_torch.predictor import DensePosePredictor
    cfg = get_config("densepose_rcnn_R_50_FPN_s1x").clone()
    cfg.defrost()
    cfg.merge_from_list(["INPUT.MIN_SIZE_TEST", 128, "INPUT.MAX_SIZE_TEST", 192,
                         "TEST.DETECTIONS_PER_IMAGE", 20, "TPU.COMPUTE_DTYPE", dtype,
                         *extra])
    cfg.freeze()
    return DensePosePredictor(cfg, seed=0, device=device)


# a frame served again: cuDNN's transposed convolutions add with atomics, so
# its maps may differ in the last bits (the bound chip_smoke.py holds the card
# to against the CPU); its detections come before those and are exact
SERVED_AGAIN_TOL = 1e-3


@pytest.mark.gpu
def test_streamed_fetch_matches_synchronous(cuda):
    """A start_fetch read (pinned copies, then an event), taken while later
    frames keep the device busy, equals a blocking read of the same outputs
    bit for bit; and stage_input + __call__ equals __call__ on numpy (the
    detections exact, the maps within SERVED_AGAIN_TOL)."""
    pred = small_flagship_predictor(cuda)
    frames = [(np.random.RandomState(s).rand(96, 128, 3) * 255).astype(np.uint8)
              for s in range(4)]
    keys = {"pred_densepose_coarse_segm", "pred_densepose_fine_segm"}
    outs = []
    for f in frames:
        out = pred(pred.stage_input(f))
        pred.start_fetch(out, keys=keys)
        outs.append(out)
    for f, out in zip(frames, outs):
        streamed = pred.numpy_outputs(out, keys=keys)
        # the same outputs through blocking copies, apart from start_fetch
        blocking = pred.numpy_outputs({k: v.cpu() for k, v in out.items()})
        again = pred.numpy_outputs(pred(f), keys=keys)  # the frame served again
        assert streamed["num_instances"] >= 1
        assert sorted(streamed) == sorted(again)
        for k, v in streamed.items():
            np.testing.assert_array_equal(v, blocking[k], err_msg=k)
            if k.startswith("pred_densepose_"):
                np.testing.assert_allclose(v, again[k], rtol=0, atol=SERVED_AGAIN_TOL,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(v, again[k], err_msg=k)


@pytest.mark.gpu
def test_fetched_maps_do_not_alias_pinned_memory(cuda):
    """numpy_outputs returns arrays of their own, of the valid rows only: none
    keeps start_fetch's padded pinned copy alive. The streaming loop's
    copy=False reads that copy in place where the valid slots are a prefix."""
    from densepose_tpu_torch.predictor import _HOST_COPY
    pred = small_flagship_predictor(cuda)
    frame = (np.random.RandomState(9).rand(96, 128, 3) * 255).astype(np.uint8)
    for copy in (True, False):
        out = pred(frame)
        pred.start_fetch(out)
        pinned = [getattr(v, _HOST_COPY)[0].numpy() for v in out.values()]
        got = pred.numpy_outputs(out, copy=copy)
        n = got["num_instances"]
        assert n >= 1
        maps = {k: v for k, v in got.items() if k.startswith("pred_densepose_")}
        assert maps and all(len(v) == n for v in maps.values())
        aliased = {k for k, v in got.items() if isinstance(v, np.ndarray)
                   and any(np.may_share_memory(v, b) for b in pinned)}
        prefix = bool(out["valid"][:n].all())  # else even copy=False copies
        trimmed = set(got) - {"image_size", "num_instances"}  # the per-detection arrays
        assert aliased == (trimmed if prefix and not copy else set()), aliased


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_half_predictor_on_card(cuda, dtype):
    """A half predictor on the card: the detections and det_packed in fp32,
    the maps in the dtype, all finite, through K1 and K2."""
    pred = small_flagship_predictor(cuda, dtype)
    frame = (np.random.RandomState(10).rand(96, 128, 3) * 255).astype(np.uint8)
    k1, k2 = nms.nms_keep_cuda.launches, roi_align.roi_align_cuda.launches
    out = pred(frame)
    torch.cuda.synchronize()
    assert (nms.nms_keep_cuda.launches - k1, roi_align.roi_align_cuda.launches - k2) == (2, 2)
    half = getattr(torch, dtype)
    assert {p.dtype for p in pred.model.parameters()} == {half}
    for k in ("pred_boxes", "scores", "det_packed"):
        assert out[k].dtype == torch.float32, k
    maps = [k for k in out if k.startswith("pred_densepose_")]
    assert len(maps) == 4
    for k, v in out.items():
        if k in maps:
            assert v.dtype == half, k
        if v.is_floating_point():
            assert bool(torch.isfinite(v).all()), k
    assert int(out["num_instances"]) >= 1


@pytest.mark.gpu
def test_bfloat16_fetch_on_card(cuda):
    """A bfloat16 predictor's maps cross as their 2-byte payload (start_fetch)
    and come back from numpy_outputs as float32 arrays equal to the device
    values widened, arrays of their own."""
    from densepose_tpu_torch.predictor import _HOST_COPY
    pred = small_flagship_predictor(cuda, "bfloat16")
    out = pred((np.random.RandomState(12).rand(96, 128, 3) * 255).astype(np.uint8))
    pred.start_fetch(out)
    pinned = {k: getattr(v, _HOST_COPY)[0] for k, v in out.items()}
    assert pinned["pred_densepose_u"].dtype == torch.int16
    assert pinned["pred_densepose_u"].element_size() == 2
    got = pred.numpy_outputs(out)
    n = got["num_instances"]
    assert n >= 1
    valid = out["valid"].cpu()
    for k in ("pred_densepose_coarse_segm", "pred_densepose_fine_segm", "pred_densepose_u",
              "pred_densepose_v"):
        assert got[k].dtype == np.float32
        want = out[k].cpu()[valid[:len(out[k])]].float().numpy()
        np.testing.assert_array_equal(got[k], want, err_msg=k)
        assert not np.may_share_memory(got[k], pinned[k].numpy()), k


@pytest.mark.gpu
def test_geometry_canvas_on_card_equals_host(cuda):
    """TPU.GEOMETRY_BUCKET_QUANT on the card: the canvas the predictor builds
    from the uploaded frame equals the host's bucketize bit for bit, for
    frames of three buckets; each request launches 2 K1 and 2 K2."""
    pred = small_flagship_predictor(cuda, extra=("TPU.GEOMETRY_BUCKET_QUANT", 64))
    for seed, hw in enumerate([(96, 128), (94, 126), (72, 128), (128, 96)]):
        frame = (np.random.RandomState(30 + seed).rand(*hw, 3) * 255).astype(np.uint8)
        want, sizes = pred.bucketize(frame)
        canvas, dsizes = pred.model.bucket_canvas(image_tensor(frame, cuda), 64)
        np.testing.assert_array_equal(canvas.cpu().numpy(), want)
        assert tuple(dsizes) == tuple(int(v) for v in sizes)
        k1, k2 = nms.nms_keep_cuda.launches, roi_align.roi_align_cuda.launches
        out = pred(frame)
        torch.cuda.synchronize()
        assert (nms.nms_keep_cuda.launches - k1, roi_align.roi_align_cuda.launches - k2) == (2, 2)
        assert int(out["num_instances"]) >= 1
        assert all(bool(torch.isfinite(v).all()) for v in out.values() if v.is_floating_point())


@pytest.mark.gpu
def test_forced_detection_buckets_equal_full_rows(cuda):
    """The switched DensePose stage ({8, D}) and TPU.BUCKETED_DENSEPOSE's stage
    2 ({8, 16, D}) with the count forced: each bucket's rows equal the
    D-slot rows within SERVED_AGAIN_TOL (cuDNN may pick batch-size-dependent
    algorithms)."""
    pred = small_flagship_predictor(cuda, extra=("TPU.BUCKETED_DENSEPOSE", True))
    frame = (np.random.RandomState(13).rand(96, 128, 3) * 255).astype(np.uint8)
    with torch.inference_mode():
        _, feats, boxes = pred.model.forward_stage1(image_tensor(frame, cuda))
        full = pred.model.forward_densepose(feats, boxes)
        d = boxes.shape[0]
        for count, switched_rows, rows in [(5, 8, 8), (12, 20, 16), (20, 20, 20)]:
            switched = pred.model.forward_densepose_switched(feats, boxes, count)
            two_stage = pred.densepose_stage2(feats, boxes, count)
            for k, v in full.items():
                assert switched[k].shape[0] == d and two_stage[k].shape[0] == rows, k
                assert not switched[k][switched_rows:].any(), k
                for got in (switched[k][:count], two_stage[k][:count]):
                    np.testing.assert_allclose(got.float().cpu().numpy(),
                                               v[:count].float().cpu().numpy(),
                                               rtol=0, atol=SERVED_AGAIN_TOL, err_msg=k)


@pytest.mark.gpu
def test_single_view_tta_equals_base_on_card(cuda):
    """A TTA of one view at the config's own resolution, no flip: the base
    request's detections after the merge (its NMS sees the boxes clipped to
    the frame, so it may drop one) exactly, and maps equal to the DensePose
    stage on the merged boxes in the view's coordinates within
    SERVED_AGAIN_TOL."""
    from densepose_tpu_torch.tta import TTAPredictor, merge_detections
    pred = small_flagship_predictor(cuda, extra=(
        "TEST.AUG.ENABLED", True, "TEST.AUG.MIN_SIZES", (128,), "TEST.AUG.MAX_SIZE", 192,
        "TEST.AUG.FLIP", False))
    tta = TTAPredictor(pred)
    frame = (np.random.RandomState(14).rand(96, 128, 3) * 255).astype(np.uint8)
    base = pred(frame)
    keys = ("pred_boxes", "scores", "pred_classes", "valid")
    merged = dict(zip(keys, merge_detections(*(base[k] for k in keys), tta.nms_thresh,
                                             tta.topk)))
    want = pred.numpy_outputs(dict(merged, image_size=base["image_size"],
                                   num_instances=merged["valid"].sum()))
    k1 = nms.nms_keep_cuda.launches
    out = tta(frame)
    torch.cuda.synchronize()
    assert nms.nms_keep_cuda.launches - k1 == 3  # RPN, box stage, merge
    got = tta.numpy_outputs(out)
    assert got["num_instances"] == want["num_instances"] >= 1
    for k in ("pred_boxes", "scores", "pred_classes"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with torch.inference_mode():
        _, feats, _ = pred.model.forward_stage1(image_tensor(frame, cuda))
        _, h1, w1 = pred.model.resized_size(96, 128)
        scale = torch.tensor([w1 / 128, h1 / 96] * 2, dtype=torch.float32, device=cuda)
        ref = pred.model.forward_densepose(feats, out["pred_boxes"] * scale)
    for k, v in ref.items():
        assert out[k].dtype == torch.float32
        np.testing.assert_allclose(out[k].cpu().numpy(), v.float().cpu().numpy(), rtol=0,
                                   atol=SERVED_AGAIN_TOL, err_msg=k)


def small_zoo_predictor(device, name, extra=()):
    """A zoo model at full width on a small input, with random weights from
    seed 0; HRNet's backbone rescaled to unit-variance outputs on a frame in
    fp32 first (``torch_cases.unit_variance_``: the plain random init
    overflows float16 at HRNet's depth)."""
    from densepose_tpu_torch.model_zoo import get_config
    from densepose_tpu_torch.predictor import DensePosePredictor
    cfg = get_config(name).clone()
    cfg.defrost()
    cfg.merge_from_list(["INPUT.MIN_SIZE_TEST", 128, "INPUT.MAX_SIZE_TEST", 192,
                         "TEST.DETECTIONS_PER_IMAGE", 20, *extra])
    if cfg.MODEL.BACKBONE.NAME != "build_hrfpn_backbone":
        cfg.freeze()
        return DensePosePredictor(cfg, seed=0, device=device)
    dtype, cfg.TPU.COMPUTE_DTYPE = cfg.TPU.COMPUTE_DTYPE, "float32"
    fp32 = DensePosePredictor(cfg.clone(), seed=0, device=device)
    frame = (np.random.RandomState(18).rand(96, 136, 3) * 255).astype(np.uint8)
    unit_variance_(fp32.model.backbone, lambda: fp32(frame))
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.freeze()
    return DensePosePredictor(cfg, device=device, params={
        k: v.cpu() for k, v in fp32.model.state_dict().items()})


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_hrnet_request_on_card(cuda, dtype, monkeypatch):
    """HRNet-W32 + HRFPN on the card: 2 K1 and 2 K2 launches a request (the
    box pooler over five levels p1..p5), each held against its plain version
    (K1 exact, K2 bit-identical); the input padded to 64; outputs finite."""
    pred = small_zoo_predictor(cuda, "densepose_rcnn_HRFPN_HRNet_w32_s1x",
                               ("TPU.COMPUTE_DTYPE", dtype))
    k1, k2 = nms.nms_keep_cuda, roi_align.roi_align_cuda
    held = []

    def held_k1(boxes, valid, thr, classes=None):
        keep = k1(boxes, valid, thr, classes)
        assert torch.equal(keep, nms.nms_keep_plain(boxes, valid, thr, classes))
        held.append("K1")
        return keep

    def held_k2(feats, boxes, levels, scales, out_hw, ratio, aligned, frames=None):
        out = k2(feats, boxes, levels, scales, out_hw, ratio, aligned, frames)
        assert torch.equal(out, roi_align.roi_align_plain(feats, boxes, levels, scales, out_hw,
                                                          ratio, aligned, frames))
        held.append(f"K2 x{len(feats)}")
        return out

    # the kernels count through their module's name, which is now the held
    # wrapper's
    held_k1.launches = held_k2.launches = 0
    frame = (np.random.RandomState(16).rand(96, 136, 3) * 255).astype(np.uint8)
    x, _, hw = pred.model.preprocess(image_tensor(frame, cuda))
    assert hw == (128, 192) and x.shape[-2:] == (128, 192)
    before = (k1.launches, k2.launches)
    out = pred(frame)
    torch.cuda.synchronize()
    assert (k1.launches - before[0], k2.launches - before[1]) == (2, 2)
    monkeypatch.setattr(nms, "nms_keep_cuda", held_k1)
    monkeypatch.setattr(roi_align, "roi_align_cuda", held_k2)
    pred(frame)
    torch.cuda.synchronize()
    assert sorted(held) == ["K1", "K1", "K2 x1", "K2 x5"]
    assert int(out["num_instances"]) >= 1
    assert out["pred_densepose_u"].dtype == getattr(torch, dtype)
    assert all(bool(torch.isfinite(v).all()) for v in out.values() if v.is_floating_point())


@pytest.mark.gpu
def test_cse_request_and_lookup_on_card(cuda):
    """R50-CSE on the card: 2 K1 + 2 K2, the embedding and coarse maps and no
    chart maps; the closest-vertex lookup of one instance on the card, in
    chunks, scores every pixel's vertex within 1e-5 (1 + |p|) of the float64
    minimum of the same expression, with every index below the mesh's
    vertex count."""
    from densepose_tpu_torch.models.cse import closest_vertices
    from densepose_tpu_torch.visualizer import CseResultExtractor
    pred = small_zoo_predictor(cuda, "densepose_rcnn_R_50_FPN_s1x_cse")
    frame = (np.random.RandomState(17).rand(96, 128, 3) * 255).astype(np.uint8)
    before = (nms.nms_keep_cuda.launches, roi_align.roi_align_cuda.launches)
    out = pred(frame)
    torch.cuda.synchronize()
    assert (nms.nms_keep_cuda.launches - before[0],
            roi_align.roi_align_cuda.launches - before[1]) == (2, 2)
    assert sorted(k for k in out if k.startswith("pred_densepose_")) == [
        "pred_densepose_coarse_segm", "pred_densepose_embedding"]
    res = pred.numpy_outputs(out)
    assert res["pred_densepose_embedding"].shape[1:] == (16, 112, 112)
    extractor = CseResultExtractor(pred)
    results, _ = extractor(res)
    verts = extractor.vertices("smpl_27554")
    assert verts.is_cuda and verts.shape == (27554, 16)
    assert all(r["closest_vertices"].max() < 27554 for r in results)
    pixels = torch.from_numpy(res["pred_densepose_embedding"][0].reshape(16, -1).T.copy())
    got = closest_vertices(pixels.to(cuda), verts, chunk_elements=1 << 22).cpu().numpy()
    p, v = pixels.double().numpy(), verts.double().cpu().numpy()
    scores = -2.0 * p @ v.T + (v * v).sum(1)
    slack = scores[np.arange(len(p)), got] - scores.min(1)
    assert (slack <= 1e-5 * (1 + np.linalg.norm(p, axis=1))).all(), slack.max()


# (n, h, w, cin, cout, k, stride, padding, dilation, transposed): the int8
# paths' link kinds at small sizes, with ragged channel counts and M tails
Q1_SHAPES = [
    (2, 9, 11, 64, 64, 3, 1, 1, 1, False),     # a head link, M = 198
    (3, 7, 5, 40, 15, 3, 1, 1, 1, False),      # Cin 40 (8-byte copies), Cout 15
    (1, 13, 17, 20, 77, 3, 1, 1, 1, False),    # Cin 20 (4-byte copies), Cout 77
    (2, 15, 16, 96, 130, 1, 2, 0, 1, False),   # stride-2 1x1
    (1, 12, 10, 48, 64, 3, 1, 2, 2, False),    # dilated 3x3 (RES5_DILATION 2)
    (1, 6, 7, 600, 32, 1, 1, 0, 1, False),     # HRFPN reduction width
    (3, 7, 7, 64, 77, 4, 2, 1, 1, True),       # the merged chart deconvolution
    (2, 5, 6, 32, 2, 4, 2, 1, 1, True),        # Cout 2
    (1, 9, 13, 16, 24, 3, 2, 1, 1, False),     # Cin 16, a stride-2 3x3
    (2, 6, 5, 720, 40, 1, 1, 0, 1, False),     # Cin 720: a ragged 128-channel chunk
    (3, 14, 14, 128, 256, 3, 1, 1, 1, False),  # 128 x 256 tiles, an M tail across images
]
# each shape with each variant that takes it (wgmma: conv_int8.wgmma_takes)
Q1_CASES = [(shape, variant) for shape in Q1_SHAPES for variant in ("mma_sync", "wgmma")
            if variant == "mma_sync" or conv_int8.wgmma_takes(
                shape[:4], (shape[4], shape[5], shape[5], shape[3]), stride=shape[6],
                padding=shape[7], dilation=shape[8], transposed=shape[9])]


def q1_inputs(shape, seed=0):
    n, h, w, cin, cout, k, *_ = shape
    g = torch.Generator().manual_seed(seed)
    qx = torch.randint(-127, 128, (n, h, w, cin), generator=g, dtype=torch.int8)
    qw = torch.randint(-127, 128, (cout, k, k, cin), generator=g, dtype=torch.int8)
    qb = torch.randint(-20000, 20000, (cout,), generator=g, dtype=torch.int32)
    vec = torch.rand(cout, generator=g) * 1e-3 + 1e-5
    return qx, qw, qb, vec


@pytest.mark.gpu
@pytest.mark.parametrize("shape,variant", Q1_CASES, ids=lambda c: c if isinstance(c, str) else
                         "x".join(map(str, c[:6])) + ("T" if c[-1] else ""))
@pytest.mark.parametrize("out_kind", ["s32", "s8", torch.float32, torch.float16, torch.bfloat16],
                         ids=["s32", "s8", "f32", "f16", "bf16"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
def test_q1_matches_plain(cuda, shape, variant, out_kind, relu):
    *_, k, stride, padding, dilation, transposed = shape
    qx, qw, qb, vec = q1_inputs(shape)
    kw = dict(stride=stride, padding=padding, dilation=dilation, transposed=transposed,
              relu=relu, out_kind=out_kind)
    want = conv_int8.conv_s8_plain(qx, qw, qb, vec, **kw)
    q1 = conv_int8.conv_s8_cuda
    before, by_variant = q1.launches, dict(q1.variant_launches)
    got = q1(qx.to(cuda), qw.to(cuda), qb.to(cuda), vec.to(cuda), **kw, variant=variant)
    again = q1(qx.to(cuda), qw.to(cuda), qb.to(cuda), vec.to(cuda), **kw, variant=variant)
    torch.cuda.synchronize()
    assert q1.launches == before + 2
    assert q1.variant_launches[variant] == by_variant[variant] + 2
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want) and torch.equal(got, again)
    if out_kind == "s8" and relu:
        assert 0 < int((want.abs() == 127).sum()) < want.numel()  # clamps some, not all


@pytest.mark.gpu
def test_q1_routes_head_links_to_wgmma(cuda):
    """A head link (8 rows of 28x28x512, 3x3 -> 512) through the router:
    one launch of the wgmma variant, bit-identical to the plain version."""
    qx, qw, qb, vec = q1_inputs((8, 28, 28, 512, 512, 3, 1, 1, 1, False), seed=3)
    kw = dict(padding=1, relu=True, out_kind="s8")
    assert conv_int8.q1_variant(qx.shape, qw.shape, padding=1) == "wgmma"
    q1 = conv_int8.conv_s8_cuda
    by_variant = dict(q1.variant_launches)
    got = conv_int8.conv_s8(qx.to(cuda), qw.to(cuda), qb.to(cuda), vec.to(cuda), **kw)
    torch.cuda.synchronize()
    assert q1.variant_launches == dict(by_variant, wgmma=by_variant["wgmma"] + 1)
    assert torch.equal(got.cpu(), conv_int8.conv_s8_plain(qx, qw, qb, vec, **kw))


@pytest.mark.gpu
def test_q1_refuses(cuda):
    qx, qw, qb, vec = q1_inputs((1, 4, 4, 64, 8, 3, 1, 1, 1, False))
    with pytest.raises(ValueError, match="CUDA"):
        conv_int8.conv_s8_cuda(qx, qw.to(cuda), None, None)
    with pytest.raises(ValueError, match="epilogue"):
        conv_int8.conv_s8_cuda(qx.to(cuda), qw.to(cuda), None, None, out_kind="s8")
    with pytest.raises(ValueError, match="variant"):
        conv_int8.conv_s8_cuda(qx.to(cuda), qw.to(cuda), None, None, variant="cudnn")
    odd = torch.zeros((1, 4, 4, 6), dtype=torch.int8, device=cuda)
    with pytest.raises(RuntimeError, match="Q1 launch failed"):
        conv_int8.conv_s8_cuda(odd, torch.zeros((8, 1, 1, 6), dtype=torch.int8, device=cuda),
                               None, None)
    # shapes that break the wgmma variant's preconditions, forced to it: the
    # C side refuses them and nothing runs in their place
    before = dict(conv_int8.conv_s8_cuda.variant_launches)
    s8 = dict(dtype=torch.int8, device=cuda)
    refused = [
        # Cin 40: TMA's global strides must be multiples of 16 bytes
        ((1, 5, 5, 40), (8, 3, 3, 40), dict(padding=1)),
        # a 3x3 / stride 2 transposed conv: an odd output, classes of two sizes
        ((1, 5, 5, 64), (8, 3, 3, 64), dict(stride=2, padding=1, transposed=True)),
        # stride 9: past the im2col box's traversal stride of 8
        ((1, 19, 19, 16), (8, 1, 1, 16), dict(stride=9)),
    ]
    for x_shape, w_shape, geo in refused:
        assert not conv_int8.wgmma_takes(x_shape, w_shape, **geo)
        assert conv_int8.q1_variant(x_shape, w_shape, **geo) == "mma_sync"
        with pytest.raises(RuntimeError, match="Q1 launch failed"):
            conv_int8.conv_s8_cuda(torch.zeros(x_shape, **s8), torch.zeros(w_shape, **s8), None,
                                   None, **geo, variant="wgmma")
    # an input 8 bytes past a 16-byte boundary (a view into a larger buffer)
    buf = torch.zeros(8 + 2 * 5 * 5 * 64, **s8)
    shifted = buf[8:].view(2, 5, 5, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 8
    with pytest.raises(RuntimeError, match="Q1 launch failed"):
        conv_int8.conv_s8_cuda(shifted, torch.zeros((8, 3, 3, 64), **s8), None, None, padding=1,
                               variant="wgmma")
    torch.cuda.synchronize()
    assert conv_int8.conv_s8_cuda.variant_launches == before


@pytest.mark.gpu
def test_int8_request_on_card(cuda, monkeypatch):
    """The flagship at full width with INT8_HEAD + INT8_PREDICTOR, calibrated on
    one frame: detections bit-identical to the fp32 request's, 2 K1 + 2 K2 and
    8 + 1 Q1 launches a request, every Q1 launch equal to its plain version,
    maps finite; then all four int8 groups (70 Q1 launches)."""
    frame = (np.random.RandomState(19).rand(96, 136, 3) * 255).astype(np.uint8)
    fp = small_flagship_predictor(cuda)(frame)
    pred = small_flagship_predictor(cuda, extra=("TPU.INT8_HEAD", True,
                                                 "TPU.INT8_PREDICTOR", True))
    pred.calibrate_int8([frame])
    q1 = conv_int8.conv_s8_cuda
    before = (nms.nms_keep_cuda.launches, roi_align.roi_align_cuda.launches, q1.launches)
    by_variant = dict(q1.variant_launches)
    out = pred(frame)
    torch.cuda.synchronize()
    assert (nms.nms_keep_cuda.launches - before[0], roi_align.roi_align_cuda.launches - before[1],
            q1.launches - before[2]) == (2, 2, 9)
    # the head's 8 links and the merged deconvolution, all on the wgmma variant
    assert q1.variant_launches == dict(by_variant, wgmma=by_variant["wgmma"] + 9)
    for k in ("pred_boxes", "scores", "pred_classes", "valid"):
        assert torch.equal(out[k], fp[k]), k
    held = []

    def held_q1(qx, qw, qb, vec, **kw):
        got = q1(qx, qw, qb, vec, **kw)
        want = conv_int8.conv_s8_plain(qx, qw, qb, vec, **kw)
        assert torch.equal(got, want), kw
        held.append(kw["transposed"])
        return got

    held_q1.launches = 0
    held_q1.variant_launches = dict.fromkeys(conv_int8.Q1_VARIANTS, 0)
    monkeypatch.setattr(conv_int8, "conv_s8_cuda", held_q1)
    pred(frame)
    torch.cuda.synchronize()
    assert sorted(held) == [False] * 8 + [True]
    monkeypatch.undo()
    assert all(bool(torch.isfinite(v).all()) for v in out.values() if v.is_floating_point())
    full = small_flagship_predictor(cuda, extra=(
        "TPU.INT8_HEAD", True, "TPU.INT8_PREDICTOR", True, "TPU.INT8_BACKBONE", True,
        "TPU.INT8_RPN", True))
    full.calibrate_int8([frame])
    before = q1.launches
    out = full(frame)
    torch.cuda.synchronize()
    assert q1.launches - before == 52 + 4 + 5 + 8 + 1
    assert all(bool(torch.isfinite(v).all()) for v in out.values() if v.is_floating_point())


# -- the kernels as operators, and the exported program ------------------------

OP_WRAPPERS = {"nms_keep": (nms, "nms_keep_cuda"), "roi_align": (roi_align, "roi_align_cuda"),
               "roi_align_sparse": (roi_align_sparse, "roi_align_sparse_cuda"),
               "conv_s8": (conv_int8, "conv_s8_cuda")}


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(op_cases())))
def test_operators_on_card(cuda, case):
    """Each operator on CUDA tensors launches its kernel once and agrees with
    the operator on the same CPU tensors (the plain version): K1 and Q1
    exactly, K2 bit for bit at ratio 2 and within 1e-5 at ratio 0, K3 within
    1e-5; then ``opcheck`` on the card."""
    name, args = op_cases()[case]
    op = getattr(torch.ops.densepose_tpu_torch, name)
    module, wrapper = OP_WRAPPERS[name]
    before = getattr(module, wrapper).launches
    got = op(*op_args(args, cuda))
    torch.cuda.synchronize()
    assert getattr(module, wrapper).launches == before + 1
    want = op(*op_args(args, "cpu"))
    assert got.dtype == want.dtype and got.shape == want.shape
    if name == "roi_align_sparse" or (name == "roi_align" and args[5] == 0):
        assert float((got.cpu() - want).abs().max()) <= 1e-5
    else:
        assert torch.equal(got.cpu(), want)
    torch.library.opcheck(op, op_args(args, cuda))


@pytest.mark.gpu
def test_aot_program_on_card(cuda):
    """A small flagship request as an exported program, loaded from its bytes:
    the program launches K1 twice and K2 twice, and agrees with the eager
    request."""
    from densepose_tpu_torch.predictor import DensePosePredictor
    pred = small_flagship_predictor(cuda)
    frame = (np.random.RandomState(20).rand(96, 136, 3) * 255).astype(np.uint8)
    program = DensePosePredictor.aot_load(pred.aot_export_bytes(frame.shape[:2]))
    want = pred(frame)
    before = (nms.nms_keep_cuda.launches, roi_align.roi_align_cuda.launches)
    got = program(frame)
    torch.cuda.synchronize()
    assert (nms.nms_keep_cuda.launches - before[0],
            roi_align.roi_align_cuda.launches - before[1]) == (2, 2)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].device == v.device and got[k].dtype == v.dtype, k
        if k.startswith("pred_densepose_"):
            np.testing.assert_allclose(got[k].cpu().numpy(), v.cpu().numpy(), rtol=0,
                                       atol=SERVED_AGAIN_TOL, err_msg=k)
        else:
            assert torch.equal(got[k], v), k


# -- batched frames ------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("sparse", [False, True], ids=["K2", "K3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_poolers_with_a_frame_index_on_card(cuda, sparse, dtype):
    """K2 and K3 with a frame index: one launch for the boxes of every
    frame, against the plain version (K2 bit for bit, K3 within 1e-5 or one
    unit in the last place of float16) and bit for bit against the kernel on
    each frame alone; a frame index outside [0, N) pools zeros."""
    feats, boxes, levels, index, scales = batched_pooler_cases(channels=64)
    feats = [torch.from_numpy(f).to(cuda, dtype) for f in feats]
    b, lv, fr = (torch.from_numpy(a).to(cuda) for a in (boxes, levels, index))
    kernel = roi_align_sparse.roi_align_sparse_cuda if sparse else roi_align.roi_align_cuda
    plain = roi_align_sparse.roi_align_sparse_plain if sparse else roi_align.roi_align_plain
    before = kernel.launches
    got = kernel(feats, b, lv, scales, (7, 7), 2, True, fr)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(feats, b, lv, scales, (7, 7), 2, True, fr)
    if sparse:
        tol = 1e-5 if dtype == torch.float32 else ulp(dtype, want)
        assert float((got.float() - want.float()).abs().max()) <= tol
    else:
        assert torch.equal(got, want)
    for i in range(feats[0].shape[0]):
        sel = (fr == i).nonzero()[:, 0]
        one = kernel([f[i] for f in feats], b[sel].contiguous(), lv[sel].contiguous(), scales,
                     (7, 7), 2, True)
        assert torch.equal(got[sel], one), i
    outside = torch.full_like(fr, feats[0].shape[0] + 1)
    assert not kernel(feats, b, lv, scales, (7, 7), 2, True, outside).any()
    with pytest.raises(ValueError, match="frame index"):
        kernel(feats, b, lv, scales, (7, 7), 2, True)
    with pytest.raises(ValueError, match="int32"):
        kernel(feats, b, lv, scales, (7, 7), 2, True, fr.long())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 13, 11, 64, 64, 3, 1, 1, 1, False),
                                   (3, 13, 11, 64, 64, 3, 2, 1, 1, False),
                                   (3, 9, 9, 64, 77, 4, 2, 1, 1, True)],
                         ids=["3x3", "3x3s2", "deconv"])
def test_q1_images_of_a_batch_stay_apart(cuda, shape):
    """Q1's wgmma variant at N = 3 images: each image of the batched call
    equals its call alone bit for bit, so neither the im2col box's padding
    nor an M tile that straddles two images reads across an image's edge."""
    *_, k, stride, padding, dilation, transposed = shape
    qx, qw, qb, vec = (t.to(cuda) for t in q1_inputs(shape, seed=4))
    kw = dict(stride=stride, padding=padding, dilation=dilation, transposed=transposed,
              relu=True, out_kind=torch.float32, variant="wgmma")
    got = conv_int8.conv_s8_cuda(qx, qw, qb, vec, **kw)
    for i in range(qx.shape[0]):
        assert torch.equal(got[i:i + 1], conv_int8.conv_s8_cuda(qx[i:i + 1].contiguous(), qw,
                                                                qb, vec, **kw)), i
    kw.pop("variant")
    assert torch.equal(got.cpu(), conv_int8.conv_s8_plain(qx.cpu(), qw.cpu(), qb.cpu(),
                                                          vec.cpu(), **kw))


SERVED_AGAIN_TOL = 1e-3  # chip_smoke.py's: cuDNN's transposed convolutions add with atomics


def assert_served_again(got, want):
    for k, v in want.items():
        if k.startswith("pred_densepose_"):
            err = float((got[k].float() - v.float()).abs().max())
            assert err <= SERVED_AGAIN_TOL * max(1.0, float(v.float().abs().max())), (k, err)
        elif k in ("pred_boxes", "scores", "det_packed"):
            assert torch.allclose(got[k], v, atol=1e-4, rtol=1e-5), k
        else:
            assert torch.equal(got[k], v), k


@pytest.mark.gpu
def test_predict_batch_on_card(cuda, monkeypatch):
    """A small flagship's ``predict_batch`` of 3 frames: one batched forward
    (2 K1 and 2 K2 launches for the batch), every output (3, ...), the raw
    maps of all D slots; each frame against ``forward_batch`` of that frame
    alone; and ``predict_batch``'s route over several cards, with
    ``data_parallel_devices`` listing this card twice: 4 frames in two
    shards (2 K1 and 2 K2 a shard), the outputs on the predictor's device,
    against the same, all with cuDNN off."""
    from densepose_tpu_torch import predictor
    pred = small_zoo_predictor(cuda, "densepose_rcnn_R_50_FPN_s1x")
    frames = np.stack([(np.random.RandomState(s).rand(96, 128, 3) * 255).astype(np.uint8)
                       for s in (30, 31, 32, 33)])
    with torch.backends.cudnn.flags(enabled=False):
        before = (nms.nms_keep_cuda.launches, roi_align.roi_align_cuda.launches)
        batch = pred.predict_batch(frames[:3])
        torch.cuda.synchronize()
        assert (nms.nms_keep_cuda.launches - before[0],
                roi_align.roi_align_cuda.launches - before[1]) == (2, 2)
        with torch.inference_mode():
            singles = [pred.model.forward_batch(torch.from_numpy(f[None]).to(cuda))
                       for f in frames]
        monkeypatch.setattr(predictor, "data_parallel_devices",
                            lambda device: [device, device])
        before = (nms.nms_keep_cuda.launches, roi_align.roi_align_cuda.launches)
        dp = pred.predict_batch(frames)
        torch.cuda.synchronize()
        assert (nms.nms_keep_cuda.launches - before[0],
                roi_align.roi_align_cuda.launches - before[1]) == (4, 4)
    assert len(pred._data_parallel.replicas) == 2
    home = torch.device("cuda", torch.cuda.current_device())  # pred.device is "cuda"
    assert all(v.device == home for v in dp.values())
    assert batch["pred_densepose_u"].shape[:2] == (3, 20)
    assert "pred_densepose_labels" not in batch
    for i, one in enumerate(singles):
        one = {k: v[0] for k, v in one.items()}
        assert_served_again({k: dp[k][i] for k in dp}, one)
        if i < 3:
            assert_served_again({k: batch[k][i] for k in batch}, one)


# -- spatial sharding of one frame ----------------------------------------------

def hold_kernels(monkeypatch):
    """Swaps K1, K2, K3 and Q1 for wrappers that hold every launch against
    the plain version (K1 exact, K2 and Q1 bit for bit, K3 within 1e-5 of
    the output's largest magnitude above 1); returns what each saw."""
    seen = {"k1": [], "k2": [], "k3": [], "q1": []}
    k1, k2 = nms.nms_keep_cuda, roi_align.roi_align_cuda
    k3, q1 = roi_align_sparse.roi_align_sparse_cuda, conv_int8.conv_s8_cuda

    def held_k1(boxes, valid, thr, classes=None):
        got = k1(boxes, valid, thr, classes)
        assert torch.equal(got, nms.nms_keep_plain(boxes, valid, thr, classes))
        seen["k1"].append(tuple(boxes.shape))
        return got

    def held_k2(*args):
        got = k2(*args)
        assert torch.equal(got, roi_align.roi_align_plain(*args))
        seen["k2"].append(tuple(args[0][0].shape))
        return got

    def held_k3(*args):
        got, want = k3(*args), roi_align_sparse.roi_align_sparse_plain(*args)
        top = max(1.0, float(want.float().abs().max())) if want.numel() else 1.0
        assert float((got.float() - want.float()).abs().max()) <= 1e-5 * top
        seen["k3"].append(tuple(args[0][0].shape))
        return got

    def held_q1(qx, qw, qb, vec, **kw):
        got = q1(qx, qw, qb, vec, **kw)
        assert torch.equal(got, conv_int8.conv_s8_plain(qx, qw, qb, vec, **kw)), kw
        seen["q1"].append((tuple(qx.shape), tuple(np.atleast_1d(kw["padding"]))))
        return got

    for fn in (held_k1, held_k2, held_k3, held_q1):
        fn.launches = 0
    held_q1.variant_launches = dict.fromkeys(conv_int8.Q1_VARIANTS, 0)
    monkeypatch.setattr(nms, "nms_keep_cuda", held_k1)
    monkeypatch.setattr(roi_align, "roi_align_cuda", held_k2)
    monkeypatch.setattr(roi_align_sparse, "roi_align_sparse_cuda", held_k3)
    monkeypatch.setattr(conv_int8, "conv_s8_cuda", held_q1)
    return seen


SPATIAL_CASES = [
    ("densepose_rcnn_R_50_FPN_s1x", ()),
    ("densepose_rcnn_R_50_FPN_s1x", ("TPU.COMPUTE_DTYPE", "float16")),
    ("densepose_rcnn_R_101_FPN_s1x_legacy", ()),
    ("densepose_rcnn_HRFPN_HRNet_w32_s1x", ()),
    ("densepose_rcnn_R_50_FPN_s1x", ("TPU.INT8_HEAD", True, "TPU.INT8_PREDICTOR", True,
                                     "TPU.INT8_BACKBONE", True, "TPU.INT8_RPN", True)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name,extra", SPATIAL_CASES,
                         ids=["flagship", "flagship-float16", "legacy-K3", "hrnet", "int8"])
def test_spatial_forward_on_card(cuda, name, extra, n, monkeypatch):
    """One frame's rows over this card listed ``n`` times (one replica, the
    predictor's model) against ``forward_batch`` of the frame unsharded, with
    cuDNN off; every kernel launch of the sharded request held against its
    plain version. HRNet's 128 padded rows are 2 blocks of 64: over 4 shards
    two own no rows. At float16 a slab's convolutions round apart from the
    whole map's by a unit in the last place, and on random weights every
    score ties, so the detections are a draw: the pyramid is held there."""
    from densepose_tpu_torch.parallel import spatial_parallel_forward
    sparse = "legacy" in name
    if sparse:
        monkeypatch.setenv("DENSEPOSE_TPU_SPARSE_POOLER", "1")
    pred = small_zoo_predictor(cuda, name, extra)
    frame = (np.random.RandomState(34).rand(96, 136, 3) * 255).astype(np.uint8)
    int8 = "TPU.INT8_BACKBONE" in extra
    if int8:
        pred.calibrate_int8([frame])
    fwd = spatial_parallel_forward(pred.model, [cuda] * n)
    assert fwd.shards.replicas == [pred.model] * n
    half = "float16" in extra
    with torch.backends.cudnn.flags(enabled=False), torch.inference_mode():
        image = image_tensor(frame, cuda)
        want = {k: v[0] for k, v in pred.model.forward_batch(image[None]).items()}
        levels, _, _ = pred.model.features_rows(image, fwd.shards)
        whole = pred.model.backbone(pred.model.preprocess(image)[0])
        seen = hold_kernels(monkeypatch)
        got = fwd(frame)
        torch.cuda.synchronize()
    for k, w in whole.items():
        top = float(w.float().abs().max())
        err = float((levels[k].float() - w.float()).abs().max())
        assert err <= (8 * 2.0 ** -10 if half else 1e-5) * top, (k, err, top)
    assert len(seen["k1"]) == 2 and len(seen["k3" if sparse else "k2"]) == 2, seen
    assert all(len(b) == n + 1 for b in fwd.stats.levels.values())
    if int8:  # the backbone's 3x3 links on halo-extended slabs
        assert any(pad == (0, 1) for _, pad in seen["q1"])
    assert sorted(got) == sorted(want)
    assert all(v.device == want[k].device and v.dtype == want[k].dtype
               and v.shape == want[k].shape for k, v in got.items())
    if half:
        assert all(bool(torch.isfinite(v).all()) for v in got.values() if v.is_floating_point())
    else:
        assert_served_again(got, want)


# -- the C4 detector, BasicBlock R34 and the RetinaNet FPN ---------------------

def small_c4_predictor(device, extra=()):
    """get_cfg()'s R50-C4 detector (80 classes, 1000 proposals, 14x14
    ROIAlignV2 at ratio 0) on a small input, with C4_TAME weights from seed 0
    (random weights give no box inside the frame)."""
    from densepose_tpu_torch.config import get_cfg
    from densepose_tpu_torch.predictor import DensePosePredictor, load_params
    cfg = set_cfg(get_cfg(), C4_DETECTION + [("INPUT.MIN_SIZE_TEST", 128),
                                             ("INPUT.MAX_SIZE_TEST", 192)] + list(extra))
    cfg.freeze()
    return DensePosePredictor(cfg, device=device, params=tame(load_params(cfg, seed=0), C4_TAME))


def flat(pairs):
    return [x for kv in pairs for x in kv]


@pytest.mark.gpu
def test_k1_per_class_box_stage_80x1000(cuda, monkeypatch):
    """The box stage of an 80-class detector at 1000 proposals sends K1 80
    problems of 1000 boxes, each launch equal to the plain version; one
    problem of 80000 boxes with a class row (the route before) exceeds K1's
    16384 boxes and raised ValueError."""
    from densepose_tpu_torch.model_zoo import get_config
    from densepose_tpu_torch.models.roi_heads import box_stage_decisions
    cfg = get_config("densepose_rcnn_R_50_FPN_s1x").clone()
    cfg.defrost()
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 80
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.01
    cfg.freeze()
    rng = np.random.RandomState(40)
    r = 1000
    logits = torch.from_numpy(rng.randn(r, 81).astype(np.float32) * 2).to(cuda)
    deltas = torch.from_numpy(rng.randn(r, 320).astype(np.float32) * 0.2).to(cuda)
    props = torch.from_numpy(boxes_np(rng, r, 700, 200)[None]).to(cuda)
    pvalid = torch.from_numpy(rng.rand(1, r) > 0.05).to(cuda)
    seen = hold_kernels(monkeypatch)
    boxes, scores, classes, valid = box_stage_decisions(logits, deltas, props, pvalid, cfg)
    torch.cuda.synchronize()
    assert seen["k1"] == [(80, r, 4)]
    assert int(valid.sum()) == 100 and len(set(classes[valid].tolist())) > 10


@pytest.mark.gpu
@pytest.mark.parametrize("r,c", [(1000, 80), (200, 80)])
def test_k1_per_class_route_matches_plain(cuda, r, c):
    """``per_class_nms_mask`` on the card (one K1 launch, c problems of r
    boxes) equals its plain version on the CPU exactly, on tied scores and
    invalid pairs; where one problem of r * c boxes fits K1 (200 x 80 =
    16000), the classed route on the card keeps the same."""
    boxes, scores, valid = per_class_nms_case(7, r, c)
    args = [torch.from_numpy(a) for a in (boxes, scores, valid)]
    want = nms.per_class_nms_mask(*args, 0.5)
    before = nms.nms_keep_cuda.launches
    got = nms.per_class_nms_mask(*[a.to(cuda) for a in args], 0.5)
    torch.cuda.synchronize()
    assert nms.nms_keep_cuda.launches == before + 1
    assert 0 < int(want.sum()) < int(valid.sum())
    assert torch.equal(got.cpu(), want)
    if r * c <= 16384:
        cls = torch.arange(c, dtype=torch.int32).repeat(r)
        classed = nms.batched_nms_mask(args[0].reshape(-1, 4).to(cuda), args[1].reshape(-1).to(
            cuda), cls.to(cuda), args[2].reshape(-1).to(cuda), 0.5)
        assert torch.equal(classed.cpu().reshape(r, c), want)


@pytest.mark.gpu
def test_k2_at_the_c4_pooler(cuda):
    """K2 at the C4 box pooler's site: res4 of an 800x1088 input (50x68 at
    1/16, 1024 channels), 1000 proposals, 14x14, ROIAlignV2, the adaptive
    ratio (0), against its plain version on the same card tensors."""
    rng = np.random.RandomState(41)
    feat = torch.randn(1, 1024, 50, 68, generator=torch.Generator().manual_seed(41)).to(cuda)
    b = torch.from_numpy(boxes_np(rng, 1000, 1000, 500)).to(cuda)
    before = roi_align.roi_align_cuda.launches
    got = roi_align.roi_align_single(feat, b, 1 / 16, (14, 14), 0, True)
    torch.cuda.synchronize()
    assert roi_align.roi_align_cuda.launches == before + 1
    assert got.shape == (1000, 1024, 14, 14)
    levels = torch.zeros(1000, dtype=torch.int32, device=cuda)
    want = roi_align.roi_align_plain([feat], b, levels, [1 / 16], (14, 14), 0, True)
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [(), (("TPU.COMPUTE_DTYPE", "float16"),),
                                   (("TPU.INT8_BACKBONE", True),)],
                         ids=["fp32", "float16", "int8_backbone"])
def test_c4_request_on_card(cuda, extra, monkeypatch):
    """A small R50-C4 request: 2 K1 (the RPN's one level of 15 anchors a
    cell, then 80 class problems of 1000 proposals) and 1 K2 (res4, 1024
    channels, ratio 0) a request, 42 Q1 links under INT8_BACKBONE (res2..res4:
    13 blocks of 3 convs and 3 shortcuts; the unused res5 calibrated but not
    run), every launch held against its plain version; detections of C4's
    form (min(D, R * C) rows) with at least one valid, fp32 and finite."""
    pred = small_c4_predictor(cuda, extra)
    frame = (np.random.RandomState(42).rand(96, 136, 3) * 255).astype(np.uint8)
    int8 = bool(extra) and extra[0][0] == "TPU.INT8_BACKBONE"
    if int8:
        pred.calibrate_int8([frame])
        assert pred.model.backbone.int8_active()
    seen = hold_kernels(monkeypatch)
    out = pred(frame)
    torch.cuda.synchronize()
    assert [s[0] for s in seen["k1"]] == [1, 80] and seen["k1"][1][1] == 1000
    assert len(seen["k2"]) == 1 and seen["k2"][0][1] == 1024
    assert len(seen["q1"]) == (42 if int8 else 0)
    assert out["pred_boxes"].shape == (100, 4) and out["pred_boxes"].dtype == torch.float32
    assert int(out["num_instances"]) >= 1
    assert all(bool(torch.isfinite(v).all()) for v in out.values() if v.is_floating_point())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["r34_fpn", "retinanet"])
def test_basicblock_and_retinanet_requests_on_card(cuda, name, monkeypatch):
    """A small R34-FPN DensePose request and a RetinaNet-FPN one (RPN on
    p3..p7, ROI heads on p3..p5): 2 K1 + 2 K2 a request, every launch held
    against its plain version, outputs finite."""
    extra = [("MODEL.RESNETS.DEPTH", 34)] + BASIC_BLOCK if name == "r34_fpn" else RETINANET
    pred = small_zoo_predictor(cuda, "densepose_rcnn_R_50_FPN_s1x", flat(extra))
    frame = (np.random.RandomState(43).rand(96, 136, 3) * 255).astype(np.uint8)
    seen = hold_kernels(monkeypatch)
    out = pred(frame)
    torch.cuda.synchronize()
    assert len(seen["k1"]) == 2 and len(seen["k2"]) == 2
    assert seen["k1"][0][0] == 5  # one problem a level
    assert int(out["num_instances"]) >= 1
    assert all(bool(torch.isfinite(v).all()) for v in out.values() if v.is_floating_point())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["c4", "r18_fpn", "retinanet"])
def test_new_backbones_sharded_on_card(cuda, name, monkeypatch):
    """C4 (its plain trunk), R18-FPN (BasicBlock stages) and RetinaNet (p6 /
    p7 stride-2 convs) with the frame's rows over this card listed twice,
    against ``forward_batch`` unsharded with cuDNN off: detections exact,
    maps within SERVED_AGAIN_TOL; and C4's ``predict_batch`` of 2 frames
    (K2 with a frame index) against each frame alone."""
    from densepose_tpu_torch.parallel import spatial_parallel_forward
    if name == "c4":
        pred = small_c4_predictor(cuda, [("TEST.DETECTIONS_PER_IMAGE", 20)])
    else:
        extra = [("MODEL.RESNETS.DEPTH", 18)] + BASIC_BLOCK if name == "r18_fpn" else RETINANET
        pred = small_zoo_predictor(cuda, "densepose_rcnn_R_50_FPN_s1x", flat(extra))
    frames = [(np.random.RandomState(s).rand(96, 136, 3) * 255).astype(np.uint8)
              for s in (44, 45)]
    fwd = spatial_parallel_forward(pred.model, [cuda] * 2)
    with torch.backends.cudnn.flags(enabled=False), torch.inference_mode():
        alone = [{k: v[0] for k, v in pred.model.forward_batch(
            image_tensor(f, cuda)[None]).items()} for f in frames]
        got = fwd(frames[0])
        torch.cuda.synchronize()
        assert_served_again(got, alone[0])
        if name == "c4":
            batch = pred.predict_batch(np.stack(frames))
            for i, want in enumerate(alone):
                assert_served_again({k: v[i] for k, v in batch.items()}, want)
    assert int(alone[0]["num_instances"]) >= 1
