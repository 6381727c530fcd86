"""The port's kernels as PyTorch operators: the ``densepose_tpu_torch`` namespace.

    torch.ops.densepose_tpu_torch.nms_keep          K1 (csrc/nms.cu)
    torch.ops.densepose_tpu_torch.roi_align         K2 (csrc/roi_align.cu)
    torch.ops.densepose_tpu_torch.roi_align_sparse  K3 (csrc/roi_align_sparse.cu)
    torch.ops.densepose_tpu_torch.conv_s8           Q1 (csrc/conv_s8.cu)

Each operator has a schema, a CUDA kernel (the op module's ``*_cuda``
wrapper, which launches the hand-written kernel, counts the launch and raises
on inputs it does not take), a CPU kernel (the op module's plain PyTorch
version) and a fake kernel that gives the output's shape and dtype without
touching data. While ``torch.export`` traces, the routers the model calls
(``nms.nms_keep``, ``roi_align.roi_align_multilevel`` / ``roi_align_single``,
``roi_align_sparse.roi_align_sparse``, ``conv_int8.conv_s8``) call these
operators, so each kernel call is one node of the exported program
(``DensePosePredictor.aot_export_bytes``), and the dispatcher picks the
kernel by the tensors' device when the program runs; loading a program needs
this module imported, which importing ``densepose_tpu_torch.ops`` does.
Eager calls go from the routers to the same wrappers directly: on an H100
the dispatcher added more than 5 us of host time to a call of K2, K3 and Q1,
whose arguments hold lists (PERF.md section 6; chip_smoke.py's
``dispatch_costs`` and ``tools/dispatch_cost.py`` measure it).

The kernels are registered with the low-level ``torch.library.Library``
(``define`` + ``impl``), which adds less host time a call than the
``custom_op`` decorator. The wrappers are looked up in their modules at each
call, so a wrapper swapped there (a counting or held stand-in) is the one
the operator runs.

Registration happens once, when this module is first imported; it builds no
kernel (each is built at its first launch).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from . import conv_int8, nms, roi_align, roi_align_sparse

NAMESPACE = "densepose_tpu_torch"

_LIB = torch.library.Library(NAMESPACE, "DEF")

_LIB.define("nms_keep(Tensor boxes, Tensor valid, float iou_threshold, Tensor? classes) "
            "-> Tensor")
_ROI_ALIGN_ARGS = ("(Tensor[] feats, Tensor boxes, Tensor levels, float[] scales, "
                   "int[2] output_size, int sampling_ratio, bool aligned) -> Tensor")
_LIB.define("roi_align" + _ROI_ALIGN_ARGS)
_LIB.define("roi_align_sparse" + _ROI_ALIGN_ARGS)
_LIB.define("conv_s8(Tensor qx, Tensor qw, Tensor? qb, Tensor? vec, int[2] stride, "
            "int[2] padding, int[2] dilation, bool transposed, bool relu, "
            "ScalarType out_dtype) -> Tensor")


def _register(name: str, cpu, cuda, fake) -> None:
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)


# -- K1 ----------------------------------------------------------------------

def _nms_cpu(boxes, valid, iou_threshold, classes):
    return nms.nms_keep_plain(boxes, valid, iou_threshold, classes)


def _nms_cuda(boxes, valid, iou_threshold, classes):
    return nms.nms_keep_cuda(boxes, valid, iou_threshold, classes)


def _nms_fake(boxes, valid, iou_threshold, classes):
    return valid.new_empty(valid.shape, dtype=torch.bool)


_register("nms_keep", _nms_cpu, _nms_cuda, _nms_fake)


# -- K2 and K3 -----------------------------------------------------------------

def _roi_align_cpu(feats, boxes, levels, scales, output_size, sampling_ratio, aligned):
    return roi_align.roi_align_plain(feats, boxes, levels, scales, tuple(output_size),
                                     sampling_ratio, aligned)


def _roi_align_cuda(feats, boxes, levels, scales, output_size, sampling_ratio, aligned):
    return roi_align.roi_align_cuda(feats, boxes, levels, scales, tuple(output_size),
                                    sampling_ratio, aligned)


def _roi_align_sparse_cpu(feats, boxes, levels, scales, output_size, sampling_ratio,
                          aligned):
    return roi_align_sparse.roi_align_sparse_plain(feats, boxes, levels, scales,
                                                   tuple(output_size), sampling_ratio, aligned)


def _roi_align_sparse_cuda(feats, boxes, levels, scales, output_size, sampling_ratio,
                           aligned):
    return roi_align_sparse.roi_align_sparse_cuda(feats, boxes, levels, scales,
                                                  tuple(output_size), sampling_ratio, aligned)


def _roi_align_fake(feats: List[torch.Tensor], boxes, levels, scales, output_size,
                    sampling_ratio, aligned):
    return feats[0].new_empty((boxes.shape[0], feats[0].shape[0], *output_size))


_register("roi_align", _roi_align_cpu, _roi_align_cuda, _roi_align_fake)
_register("roi_align_sparse", _roi_align_sparse_cpu, _roi_align_sparse_cuda, _roi_align_fake)


# -- Q1 ------------------------------------------------------------------------

def _q1_kw(stride, padding, dilation, transposed, relu, out_dtype):
    return dict(stride=tuple(stride), padding=tuple(padding), dilation=tuple(dilation),
                transposed=transposed, relu=relu, out_kind=conv_int8.out_kind_of(out_dtype))


def _conv_s8_cpu(qx, qw, qb, vec, stride, padding, dilation, transposed, relu, out_dtype):
    return conv_int8.conv_s8_plain(qx, qw, qb, vec, **_q1_kw(stride, padding, dilation,
                                                             transposed, relu, out_dtype))


def _conv_s8_cuda(qx, qw, qb, vec, stride, padding, dilation, transposed, relu, out_dtype):
    return conv_int8.conv_s8_cuda(qx, qw, qb, vec, **_q1_kw(stride, padding, dilation,
                                                            transposed, relu, out_dtype))


def _conv_s8_fake(qx, qw, qb: Optional[torch.Tensor], vec: Optional[torch.Tensor], stride,
                  padding, dilation, transposed, relu, out_dtype):
    ho, wo = conv_int8.out_size(qx.shape[1], qx.shape[2], qw, stride, padding, dilation,
                                transposed)
    return qx.new_empty((qx.shape[0], ho, wo, qw.shape[0]), dtype=out_dtype)


_register("conv_s8", _conv_s8_cpu, _conv_s8_cuda, _conv_s8_fake)
