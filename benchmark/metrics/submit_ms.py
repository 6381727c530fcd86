"""Host ms of the predict_batch call (until it returns, before the fetch and
the synchronisation), the mean over the traced run's batches that the
profiler did not record (host clock): the profiler's own cost per call
would otherwise count."""


def read(run):
    if not run.submit_s:
        return None
    return 1e3 * sum(run.submit_s) / len(run.submit_s)
