"""A device trace for ``--profile`` (the port's counterpart of
``trace_device`` in densepose_tpu/utils/timing.py, with ``torch.profiler``
in place of ``jax.profiler``)."""

from __future__ import annotations

import contextlib
import os


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace_device(logdir: str):
    """Record a ``torch.profiler`` trace of the enclosed region (host ops, and
    CUDA kernels and copies where a card is present) and write it to
    ``logdir/trace.json``, which chrome://tracing and Perfetto open."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
