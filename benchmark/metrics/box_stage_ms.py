"""Device ms a frame under the program's `box_stage` range (device trace)."""

from benchmark.readers import stage_ms


def read(run):
    return stage_ms(run, "box_stage")
