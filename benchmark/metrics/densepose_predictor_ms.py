"""Device ms a frame under the program's `densepose_predictor` range (device trace)."""

from benchmark.readers import stage_ms


def read(run):
    return stage_ms(run, "densepose_predictor")
