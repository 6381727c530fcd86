"""Tensor ops of the port. The kernels K1 (``nms``), K2 (``roi_align``), K3
(``roi_align_sparse``) and Q1 (``conv_int8``) are PyTorch operators
(``library``): each launches its CUDA kernel for CUDA tensors and runs its
plain PyTorch version for CPU tensors."""

from . import library  # noqa: F401  (registers the operators)
