"""% of K1's least time (counts/kernels.py at the cell's shapes: the RPN's
level problems and the box stage's class problems of every frame) in the
device time of the kernels named nms_* (mask and scan), traced window."""

from benchmark.readers import k1_bound_per_batch, roofline


def read(run):
    return roofline(run, k1_bound_per_batch, "nms_")
