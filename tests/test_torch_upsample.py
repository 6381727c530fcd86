"""U1, the 2x bilinear upsample (``csrc/upsample2x.cu``), on the CPU: its
plain version against ``F.interpolate``, the routing of ``resize_bilinear``,
and the operator ``densepose_tpu_torch::upsample2x``.

The plain version (``ops/resize.py::upsample2x_plain``) performs the
kernel's roundings, which are those of PyTorch's CUDA kernel: each
``a * wa + b * wb`` as ``fma(wa, a, wb * b)``, first along the row, then
down the column. At float16 and bfloat16 every product by the weights (1,
0, 0.25, 0.75) is exact and the result is bit-identical to ``F.interpolate``
on the CPU at every shape. At float32 PyTorch's CPU kernel rounds in one of
two orders, chosen by the shape: the one above (which these tests hold bit
for bit, at the shapes where the CPU kernel takes it) or a chain of four
fused products; the two differ only by rounding. The CUDA kernel is held
against ``F.interpolate`` on the card by tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from densepose_tpu_torch.model_zoo import get_config
from densepose_tpu_torch.models.roi_heads import DensePoseChartPredictor
from densepose_tpu_torch.ops import resize

torch.set_num_threads(2)

# (N, C, H, W): 1x1, 1xW, Hx1, odd H and W, W not a multiple of 8, the
# predictors' 28x28 and 56x56
SHAPES = [(64, 64, 1, 1), (2, 3, 1, 400), (2, 3, 400, 1), (2, 5, 41, 37), (3, 4, 33, 57),
          (2, 3, 56, 56), (1, 3, 3, 300)]
# where the CPU's float32 kernel takes its other order (and 28x28)
SMALL = [(1, 1, 1, 1), (1, 1, 1, 9), (1, 1, 9, 1), (4, 7, 13, 11), (2, 3, 28, 28),
         (1, 2, 5, 3)]
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def library(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def sample(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 3).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_equals_interpolate(shape, dtype):
    x = sample(shape, dtype)
    got = resize.upsample2x_plain(x)
    assert got.dtype == dtype and got.shape == (*shape[:2], 2 * shape[2], 2 * shape[3])
    assert torch.equal(got, library(x))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("shape", SMALL, ids=str)
def test_plain_equals_interpolate_half_small(shape, dtype):
    x = sample(shape, dtype, seed=1)
    assert torch.equal(resize.upsample2x_plain(x), library(x))


@pytest.mark.parametrize("shape", SMALL, ids=str)
def test_plain_rounds_apart_from_cpu_float32_only(shape):
    """At these shapes the CPU's float32 kernel sums in its other order: the
    two differ only by rounding, a few units in the last place of the
    largest input (where neighbours of opposite sign cancel, many of the
    small output's)."""
    x = sample(shape, torch.float32, seed=2)
    got, want = resize.upsample2x_plain(x), library(x)
    assert float((got - want).abs().max()) <= 4 * torch.finfo(torch.float32).eps * float(
        x.abs().max())


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plain_takes_a_strided_channel_slice(dtype):
    """The int8 route's channel slices y[:, c:c + n] of (N, 77, H, W) maps."""
    y = sample((2, 77, 50, 48), dtype, seed=3)
    for c0, n in ((0, 2), (2, 25), (27, 25), (52, 25)):
        x = y[:, c0:c0 + n]
        assert not x.is_contiguous()
        assert torch.equal(resize.upsample2x_plain(x), library(x))


def test_taps_are_torchs():
    """The plain version's taps: PyTorch's source index (dst + 0.5) / 2 - 0.5,
    clamped at 0, its floor and fraction, and the second tap clamped to the
    last row (PyTorch keeps the fraction there)."""
    for n in (1, 2, 3, 28):
        i0, i1, w0, w1 = (a.numpy() for a in resize._taps2x(n, "cpu"))
        src = np.maximum((np.arange(2 * n) + 0.5) / 2 - 0.5, 0)
        np.testing.assert_array_equal(i0, np.floor(src).astype(np.int64))
        np.testing.assert_array_equal(i1, np.minimum(i0 + 1, n - 1))
        np.testing.assert_array_equal(w1, src - i0)
        np.testing.assert_array_equal(w0, 1 - w1)


@pytest.mark.parametrize("scale", [(2.0, 2.0), (4.0, 4.0), (2.0, 4.0), None])
def test_resize_bilinear_keeps_interpolate_on_cpu(monkeypatch, scale):
    """CPU tensors never reach U1 or its plain version: a 2x upsample and
    every other scale are ``F.interpolate``'s, bit for bit."""
    def refuse(*a, **k):
        raise AssertionError("U1 reached for a CPU tensor")
    monkeypatch.setattr(resize, "upsample2x_cuda", refuse)
    monkeypatch.setattr(resize, "upsample2x_plain", refuse)
    x = sample((2, 3, 13, 11), torch.float32, seed=4)
    k = scale or (2.0, 2.0)
    out_hw = (int(13 * k[0]), int(11 * k[1]))
    got = resize.resize_bilinear(x, out_hw, scale=scale)
    if scale is None:
        want = F.interpolate(x, size=out_hw, mode="bilinear", align_corners=False)
    else:
        want = F.interpolate(x, scale_factor=scale, mode="bilinear", align_corners=False)
    assert torch.equal(got, want)


def test_upsample2x_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        resize.upsample2x_cuda(torch.zeros(1, 2, 4, 4))


def test_operator_fake_kernel():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        for dtype in DTYPES:
            x = torch.empty((3, 25, 28, 14), dtype=dtype)[:, 2:20]
            y = torch.ops.densepose_tpu_torch.upsample2x(x)
            assert y.shape == (3, 18, 56, 28) and y.dtype == dtype and y.is_contiguous()


def test_operator_cpu_kernel_is_interpolate():
    """The operator on CPU tensors is ``F.interpolate``, the route the eager
    request takes there, also at a shape where U1's plain version rounds
    apart from it."""
    x = sample((2, 3, 28, 28), torch.float32, seed=5)
    assert torch.equal(torch.ops.densepose_tpu_torch.upsample2x(x), library(x))


def test_exported_chart_predictor_holds_one_node_a_head():
    """``torch.export`` of the chart predictor: one ``upsample2x`` node for
    each of its four heads, and no ``upsample_bilinear2d``; the program
    equals the eager module on the CPU."""
    pred = DensePoseChartPredictor(get_config("densepose_rcnn_R_50_FPN_s1x")).eval()
    x = sample((3, 512, 14, 14), torch.float32, seed=6)
    program = torch.export.export(pred, (x,))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert sum("densepose_tpu_torch.upsample2x" in t for t in targets) == 4
    assert not any("upsample_bilinear2d" in t for t in targets)
    with torch.no_grad():
        got, want = program.module()(x), pred(x)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
