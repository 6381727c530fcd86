"""Frames completed in the window over the window's seconds (host clock)."""

from benchmark.stats import rate


def read(run):
    return rate(run.frames, run.window_s) if run.window_s > 0 else None
