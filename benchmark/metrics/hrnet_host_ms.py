"""Host ms a batch in the program's ``hrnet`` span (the HRNet body's
launches, under ``backbone``), the mean over the batches ``submit_ms``
reads: the last ``len(run.submit_s)`` ``predict_batch`` roots the program
kept (program span). None where the program keeps no spans or no ``hrnet``
span among those batches."""


def read(run):
    if not run.submit_s:
        return None
    try:
        from densepose_tpu_torch.utils.timing import spans
    except ImportError:
        return None
    got = spans()
    roots = [s for s in got if s.name == "predict_batch" and s.parent is None]
    roots = roots[-len(run.submit_s):]
    host = {s.call: 0.0 for s in roots}
    found = False
    for s in got:
        if s.name == "hrnet" and s.call in host:
            host[s.call] += 1e-6 * (s.end_ns - s.start_ns)
            found = True
    if not found:
        return None
    return sum(host.values()) / len(host)
