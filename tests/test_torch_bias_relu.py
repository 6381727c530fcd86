"""E1, a convolution's bias and ReLU in one pass (``csrc/bias_relu.cu``), on
the CPU: its plain version against ``F.relu(y + b)``, the DensePose head's
routing rule, the operator ``densepose_tpu_torch::bias_relu``, and the CPU
head, which never takes the channels-last route.

The kernel runs only on the card; tests/test_torch_gpu.py holds it there
against its plain version and the head's float path against the conv-by-conv
loop.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from densepose_tpu_torch.model_zoo import get_config
from densepose_tpu_torch.models import roi_heads
from densepose_tpu_torch.ops import bias_relu

torch.set_num_threads(2)

HALF = [torch.float16, torch.bfloat16]


def sample(shape, dtype, seed=0, channels_last=True):
    g = torch.Generator().manual_seed(seed)
    y = (torch.randn(shape, generator=g) * 4).to(dtype)
    b = (torch.randn(shape[1], generator=g) * 2).to(dtype)
    return (y.contiguous(memory_format=torch.channels_last) if channels_last else y), b


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("dtype", HALF + [torch.float32], ids=str)
def test_plain_equals_relu_of_add(dtype, channels_last):
    """The plain version is the head's bias add and ReLU bit for bit, also at
    signed zeros and infinities, and keeps y's layout."""
    y, b = sample((3, 24, 5, 7), dtype, channels_last=channels_last)
    y[0, :4, 0, 0] = torch.tensor([-0.0, 0.0, float("inf"), float("-inf")], dtype=dtype)
    b[:2] = torch.tensor([-0.0, -0.0], dtype=dtype)
    got = bias_relu.bias_relu_plain(y, b)
    want = F.relu(y + b.view(1, -1, 1, 1))
    assert got.dtype == dtype
    assert torch.equal(got, want) and torch.equal(torch.signbit(got), torch.signbit(want))
    assert got.is_contiguous(memory_format=torch.channels_last) == channels_last


def head(name="densepose_rcnn_R_50_FPN_s1x", extra=()):
    cfg = get_config(name).clone()
    cfg.defrost()
    cfg.merge_from_list(["MODEL.ROI_DENSEPOSE_HEAD.CONV_HEAD_DIM", 32,
                         "MODEL.ROI_DENSEPOSE_HEAD.NUM_STACKED_CONVS", 3, *extra])
    cfg.freeze()
    return roi_heads._HEADS[cfg.MODEL.ROI_DENSEPOSE_HEAD.NAME](cfg).eval()


def tensor_like(is_cuda, dtype):
    """What the routing rule reads of a tensor: its device and dtype."""
    return SimpleNamespace(is_cuda=is_cuda, dtype=dtype)


def test_routing_rule():
    """``stacked_bias_relu`` only for CUDA tensors of a half dtype through
    float convs with a bias and no norm: V1ConvX and DeepLab with
    DEEPLAB.NORM "" take it; float32, CPU tensors, int8 heads and DeepLab's
    GN convs do not."""
    v1 = head()
    for dtype in HALF:
        assert v1.takes_bias_relu(tensor_like(True, dtype), False)
        assert not v1.takes_bias_relu(tensor_like(False, dtype), False)
        assert not v1.takes_bias_relu(tensor_like(True, dtype), True)
    assert not v1.takes_bias_relu(tensor_like(True, torch.float32), False)
    assert not head(extra=("TPU.INT8_HEAD", True)).takes_bias_relu(
        tensor_like(True, torch.float16), False)
    dl = "densepose_rcnn_R_50_FPN_DL_s1x"
    gn = head(dl)
    assert gn.gn and not gn.takes_bias_relu(tensor_like(True, torch.float16), gn.gn)
    plain = head(dl, ("MODEL.ROI_DENSEPOSE_HEAD.DEEPLAB.NORM", ""))
    assert not plain.gn and plain.takes_bias_relu(tensor_like(True, torch.float16), plain.gn)
    v1.body_conv_fcn2.bias = None
    assert not v1.takes_bias_relu(tensor_like(True, torch.float16), False)


def _chip_smoke():
    """chip_smoke.py at the repo's root, loaded by path (it imports torch
    only inside its functions)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FP16, BF16 = ("TPU.COMPUTE_DTYPE", "float16"), ("TPU.COMPUTE_DTYPE", "bfloat16")
DL = "densepose_rcnn_R_50_FPN_DL_s1x"


@pytest.mark.parametrize("name, extra", [
    ("densepose_rcnn_R_50_FPN_s1x", ()),
    ("densepose_rcnn_R_50_FPN_s1x", (FP16,)),
    ("densepose_rcnn_R_50_FPN_s1x", (BF16, ("TPU.INT8_HEAD", True))),
    ("densepose_rcnn_R_101_FPN_s1x_legacy", (BF16,)),
    ("densepose_rcnn_HRFPN_HRNet_w32_s1x", (FP16,)),
    (DL, (FP16,)),
    (DL, (("MODEL.ROI_DENSEPOSE_HEAD.DEEPLAB.NORM", "FrozenBN"), BF16)),
], ids=lambda v: v if isinstance(v, str) else ",".join(str(x[1]) for x in v) or "fp32")
def test_chip_smoke_e1_launches_follow_the_routing_rule(name, extra):
    """The E1 launches chip_smoke.py's paths expect of one forward
    (``e1_per_call``, ``with_e1``: the in-place and exit passes and the
    channels-last copy) are what the head's routing rule sends to E1 on the
    card, at the configuration's published width."""
    smoke = _chip_smoke()
    cfg = smoke.path_config(name, extra)
    h = roi_heads._HEADS[cfg.MODEL.ROI_DENSEPOSE_HEAD.NAME](cfg)
    dtype = getattr(torch, cfg.TPU.COMPUTE_DTYPE)
    want = h.n if h.takes_bias_relu(tensor_like(True, dtype), getattr(h, "gn", False)) else 0
    assert smoke.e1_per_call(cfg) == want
    assert smoke.with_e1({"nms_keep_cuda": 2}, cfg, forwards=3) == {
        "nms_keep_cuda": 2, "bias_relu_cuda": 3 * want, "channels_last_cuda": 3 * (want > 0)}


@pytest.mark.parametrize("dtype", HALF, ids=str)
def test_operator_cpu_kernel_is_plain(dtype):
    y, b = sample((2, 16, 3, 5), dtype, seed=1)
    before = y.clone()
    got = torch.ops.densepose_tpu_torch.bias_relu(y, b)
    assert torch.equal(got, bias_relu.bias_relu_plain(y, b))
    assert torch.equal(y, before)  # the operator leaves its input as it is


def test_cuda_wrappers_refuse_cpu_tensors():
    y, b = sample((1, 8, 2, 2), torch.float16)
    with pytest.raises(ValueError):
        bias_relu.bias_relu_cuda(y, b)
    with pytest.raises(ValueError):
        bias_relu.channels_last_cuda(y.contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16], ids=str)
def test_cpu_head_is_the_conv_loop(monkeypatch, dtype):
    """On the CPU the head runs conv by conv, each then ``F.relu``, as before:
    E1's route is never reached, and the output is that loop's bit for bit,
    NCHW-contiguous."""
    def refuse(*a, **k):
        raise AssertionError("E1's route reached for a CPU tensor")
    for name in ("stacked_bias_relu", "bias_relu", "to_channels_last"):
        monkeypatch.setattr(roi_heads, name, refuse)
    h = head().to(dtype)
    x, _ = sample((4, 256, 6, 6), dtype, seed=2, channels_last=False)
    want = x
    for conv in h.convs():
        want = F.relu(conv(want))
    with torch.no_grad():
        got = h(x)
    assert got.is_contiguous() and torch.equal(got, want)


def plain_in_place(y, b, nchw=False):
    """E1 played by its plain version: in place, or into NCHW."""
    out = bias_relu.bias_relu_plain(y, b)
    return out.contiguous() if nchw else y.copy_(out)


@pytest.mark.parametrize("rows", [5, 0])
def test_stacked_bias_relu_layouts(monkeypatch, rows):
    """``stacked_bias_relu`` with E1 played by its plain version on the CPU
    (and PyTorch's copy for the channels-last entry): NCHW-contiguous out,
    the conv loop's values (the CPU's channels-last convolution sums in
    another order: 1e-5 of the output's largest), also with no rows; and the
    exported head holds one ``bias_relu`` node a conv, no ReLU, and computes
    what the eager route does, also traced inside ``torch.cond`` (as the
    predictor's programs trace the DensePose stage)."""
    monkeypatch.setattr(roi_heads, "bias_relu", plain_in_place)
    monkeypatch.setattr(roi_heads, "to_channels_last",
                        lambda x: x.contiguous(memory_format=torch.channels_last))
    h = head()
    x, _ = sample((rows, 256, 6, 6), torch.float32, seed=3, channels_last=False)
    with torch.no_grad():
        got = roi_heads.stacked_bias_relu(h.convs(), x)
        want = x
        for conv in h.convs():
            want = F.relu(conv(want))
    assert got.shape == want.shape and got.is_contiguous()
    if rows:
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
        monkeypatch.setattr(roi_heads, "bias_relu", bias_relu.bias_relu)
        monkeypatch.setattr(roi_heads, "to_channels_last", bias_relu.to_channels_last)
        monkeypatch.setattr(roi_heads.StackedHead, "takes_bias_relu", lambda *a: True)
        program = torch.export.export(h, (x,))
        targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        assert sum("densepose_tpu_torch.bias_relu" in t for t in targets) == len(h.convs())
        assert not any("relu" in t and "bias_relu" not in t for t in targets)
        assert torch.equal(program.module()(x), got)
        switched = torch.export.export(Switched(h), (x,))
        assert torch.equal(switched.module()(x), got)


class Switched(torch.nn.Module):
    def __init__(self, h):
        super().__init__()
        self.h = h

    def forward(self, x):
        return torch.cond(x.abs().sum() >= 0, lambda x: self.h(x), lambda x: -self.h(x), (x,))
