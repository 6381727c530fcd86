"""% of the least time of HRFPN's 4x and 8x bilinear upsamples
(counts/hrfpn.py at the cell's shapes, every frame of a batch) in the device
time of PyTorch's ``upsample_bilinear2d`` kernel, traced window. In an HRFPN
cell only those two upsamples launch it: kernel U1 takes every 2x, and the
preprocess resize is the program's own."""

from benchmark.counts.hrfpn import upsample_bound_s
from benchmark.readers import roofline


def _bound(run):
    return upsample_bound_s(run.cfg, run.canvas, run.batch, run.elem_bytes)


def read(run):
    return roofline(run, _bound, "upsample_bilinear2d")
