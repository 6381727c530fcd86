"""% of the traced window in which no kernel, copy or set ran on the device."""

from benchmark.readers import traced


def read(run):
    if not traced(run):
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
