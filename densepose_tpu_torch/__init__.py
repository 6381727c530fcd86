"""densepose_tpu_torch — the PyTorch/CUDA port of densepose_tpu.

The same configs, checkpoints, fixed-slot outputs and reference quirks as
the JAX package, run eagerly in PyTorch on one NVIDIA Hopper GPU. NMS and
ROIAlign are hand-written CUDA kernels (``csrc/``); convolutions, deconvs,
FCs and resizes go through PyTorch and cuDNN. The package imports nothing of
``densepose_tpu`` and no ``jax``.
"""

__version__ = "0.1.0"
