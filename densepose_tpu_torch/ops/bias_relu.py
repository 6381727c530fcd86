"""A convolution's bias and the ReLU after it, in one pass over a
channels-last tensor: kernel E1 (``csrc/bias_relu.cu``).

The DensePose head's float path on the card (``models/roi_heads.py::
stacked_bias_relu``) keeps its activations channels-last through the stacked
convs: cuDNN runs each conv's NHWC kernel with no bias and no layout
transposes, then E1 adds the bias and takes the ReLU in place; the last
link's E1 writes NCHW.

* ``bias_relu_cuda``: E1 on a channels-last float16 or bfloat16 CUDA tensor,
  in place, or into ``out``, channels-last or NCHW (the transposing form),
  one launch a call, counted in ``bias_relu_cuda.launches``, under the span
  ``bias_relu``.
* ``channels_last_cuda``: the transposing form without a bias, a
  channels-last copy of an NCHW tensor (the stack's entry), one launch a
  call, counted in ``channels_last_cuda.launches``, under the span
  ``channels_last``.
* ``bias_relu_plain``: E1's arithmetic in PyTorch, on any device: the sum in
  float, rounded once to the tensor's dtype, then the ReLU. It is
  bit-identical to ``F.relu(y + b.view(1, -1, 1, 1))``, the head's bias add
  and ReLU before, and is the operator's CPU kernel.
* ``bias_relu`` and ``to_channels_last``: the head's calls. While
  ``torch.export`` traces they are the operator
  ``densepose_tpu_torch::bias_relu`` (``ops/library.py``), which returns a
  new channels-last tensor, and PyTorch's layout copies.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..utils.timing import span
from .cuda_build import library
from .roi_align import DTYPE_CODES

DTYPES = (torch.float16, torch.bfloat16)


def bias_relu_plain(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``max(0, dtype(float(y) + float(bias[c])))`` of an (M, C, H, W) tensor
    of any layout, as a new tensor of y's dtype and layout."""
    s = (y.float() + bias.float().view(1, -1, 1, 1)).to(y.dtype)
    return torch.relu(s)


def bias_relu(y: torch.Tensor, bias: torch.Tensor, nchw: bool = False) -> torch.Tensor:
    """E1 on a channels-last CUDA tensor: in place, or with ``nchw`` into a
    new NCHW-contiguous tensor. While ``torch.export`` traces, the operator
    (and with ``nchw`` a layout copy)."""
    if torch.compiler.is_exporting():
        out = torch.ops.densepose_tpu_torch.bias_relu(y, bias)
        return out.contiguous() if nchw else out
    return bias_relu_cuda(y, bias, out=torch.empty(y.shape, dtype=y.dtype, device=y.device)
                          if nchw else None)


def to_channels_last(x: torch.Tensor) -> torch.Tensor:
    """A channels-last copy of an NCHW-contiguous CUDA tensor: E1's
    transposing form; while ``torch.export`` traces, PyTorch's copy."""
    if torch.compiler.is_exporting():
        return x.contiguous(memory_format=torch.channels_last)
    return channels_last_cuda(x)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """E1's library, built on first use, with its C signatures set once."""
    lib = library("bias_relu")
    lib.dp_bias_relu.argtypes = ([ctypes.c_void_p] * 3
                                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p])
    lib.dp_transpose.argtypes = ([ctypes.c_void_p] * 3
                                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p])
    lib.dp_bias_relu.restype = lib.dp_transpose.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, what: str, layout=torch.channels_last) -> None:
    if not t.is_cuda or t.dtype not in DTYPES or t.dim() != 4:
        raise ValueError(f"E1 takes an (M, C, H, W) float16 or bfloat16 CUDA tensor as {what}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous(memory_format=layout):
        kind = "channels-last" if layout == torch.channels_last else "NCHW"
        raise ValueError(f"E1 takes a {kind}-contiguous {what}, got strides {t.stride()} for "
                         f"shape {tuple(t.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def bias_relu_cuda(y: torch.Tensor, bias: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel E1: ``max(0, dtype(float(y) + float(bias[c])))`` of y, an (M, C,
    H, W) float16 or bfloat16 CUDA tensor, channels-last contiguous, and
    bias, C elements of y's dtype on y's card; written into ``out``, a
    tensor of y's shape, dtype and device, channels-last or NCHW-contiguous
    (the transposing form; ``out`` must not overlap y), or, by default, into
    y itself. Returns what it wrote. One launch, none when y is empty.
    Raises if a tensor does not fit or the launch fails."""
    with span("bias_relu"):
        _check(y, "input")
        out = y if out is None else out
        if out.shape != y.shape or out.dtype != y.dtype or out.device != y.device:
            raise ValueError(f"E1: the output is {out.dtype} {tuple(out.shape)} on "
                             f"{out.device}, not {y.dtype} {tuple(y.shape)} on {y.device}")
        transposed = not out.is_contiguous(memory_format=torch.channels_last)
        _check(out, "output", torch.contiguous_format if transposed else torch.channels_last)
        m, c, h, w = y.shape
        if (bias.shape != (c,) or bias.dtype != y.dtype or bias.device != y.device
                or not bias.is_contiguous()):
            raise ValueError(f"E1 takes a contiguous bias of {c} {y.dtype} on {y.device}, got "
                             f"{bias.dtype} {tuple(bias.shape)} on {bias.device}")
        if y.numel() == 0:
            return out
        with torch.cuda.device(y.device):
            if transposed:
                err = _lib().dp_transpose(y.data_ptr(), out.data_ptr(), bias.data_ptr(), m,
                                          h * w, c, DTYPE_CODES[y.dtype], _stream(y))
            else:
                err = _lib().dp_bias_relu(y.data_ptr(), out.data_ptr(), bias.data_ptr(),
                                          m * h * w, c, DTYPE_CODES[y.dtype], _stream(y))
        if err != 0:
            raise RuntimeError(f"bias_relu_cuda launch failed: cudaError {err}")
        bias_relu_cuda.launches += 1
        return out


bias_relu_cuda.launches = 0


def channels_last_cuda(x: torch.Tensor) -> torch.Tensor:
    """E1's transposing form without a bias: a new channels-last copy of x,
    an NCHW-contiguous (M, C, H, W) float16 or bfloat16 CUDA tensor, the
    same values bit for bit. One launch, none when x is empty."""
    with span("channels_last"):
        _check(x, "input", torch.contiguous_format)
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device,
                          memory_format=torch.channels_last)
        if x.numel() == 0:
            return out
        m, c, h, w = x.shape
        with torch.cuda.device(x.device):
            err = _lib().dp_transpose(x.data_ptr(), out.data_ptr(), None, m, c, h * w,
                                      DTYPE_CODES[x.dtype], _stream(x))
        if err != 0:
            raise RuntimeError(f"channels_last_cuda launch failed: cudaError {err}")
        channels_last_cuda.launches += 1
        return out


channels_last_cuda.launches = 0
