"""% of K2's least time (counts/kernels.py at the cell's shapes: the box and
DensePose poolers of every frame) in the device time of roi_align_kernel
(not the sparse K3), traced window."""

from benchmark.readers import k2_bound_per_batch, roofline


def read(run):
    return roofline(run, k2_bound_per_batch, "roi_align_kernel", "sparse")
