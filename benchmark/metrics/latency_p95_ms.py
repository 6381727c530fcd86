"""95th percentile of every batch's time in the window, in ms: from the
call until the batch's det_packed is on the host and the device is
synchronised (host clock). A camera frame waits for its batch."""

from benchmark.stats import p95


def read(run):
    return p95(run.latencies_ms) if run.latencies_ms else None
