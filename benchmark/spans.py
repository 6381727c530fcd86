"""The program's own spans (``densepose_tpu_torch/utils/timing.py::spans``)
of the batches that ``submit_ms`` reads: the traced run's unprofiled window
batches, which are the last ``len(run.submit_s)`` ``predict_batch`` roots
the program kept. Host clock, read inside the call."""

from __future__ import annotations

from typing import List, Optional, Tuple


def batch_calls(run) -> Optional[List[Tuple[float, float]]]:
    """(ms of the ``predict_batch`` root, ms of its ``upload`` spans) of each
    such batch; None in a run without ``submit_s`` or where the program
    keeps no spans."""
    if not run.submit_s:
        return None
    try:
        from densepose_tpu_torch.utils.timing import spans
    except ImportError:
        return None
    got = spans()
    roots = [s for s in got if s.name == "predict_batch" and s.parent is None]
    roots = roots[-len(run.submit_s):]
    if not roots:
        return None
    upload = {s.call: 0.0 for s in roots}
    for s in got:
        if s.name == "upload" and s.parent == "predict_batch" and s.call in upload:
            upload[s.call] += 1e-6 * (s.end_ns - s.start_ns)
    return [(1e-6 * (s.end_ns - s.start_ns), upload[s.call]) for s in roots]
