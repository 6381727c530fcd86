"""Tensor ops of the port. ``nms`` and ``roi_align`` launch the CUDA kernels
K1 and K2 for CUDA tensors and run their plain PyTorch versions for CPU
tensors."""
