"""% of the card's float16 dense peak: the forward's FLOPs a frame
(counts/model.py at the cell's shapes) times the frames of the traced
window, over that window's seconds."""

from benchmark.counts.peaks import FP16_TENSOR_FLOPS
from benchmark.readers import flops_per_frame, traced


def read(run):
    if not traced(run):
        return None
    flops = flops_per_frame(run) * run.trace_frames
    return 100.0 * flops / (run.trace["window_s"] * FP16_TENSOR_FLOPS)
