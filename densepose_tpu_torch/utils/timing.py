"""The port's spans, and a device trace for ``--profile`` (the port's
counterpart of ``trace_device`` in densepose_tpu/utils/timing.py, with
``torch.profiler`` in place of ``jax.profiler``).

``with span(name):`` times one piece of the program's host work. Every span
is kept, always, in a ring of the last ``RING_SPANS`` spans of the process:
its name, the name of the span it opened under (None for a root), the call
it belongs to, and its start and end in ns. A span opened with no span open
on its thread is a root and starts a new call; the spans under it share its
call number. The predictor's entry points open the roots (``predict``,
``predict_batch``), so each request's spans form one call. ``spans()``
returns the ring's records, oldest first, for a benchmark's readers or an
operator. While a ``torch.profiler`` profile is recording, a span also opens
a ``record_function`` range of its name, so a trace shows every span on its
timeline; otherwise it costs no dispatcher call. While ``torch.export`` or
``torch.compile`` traces, a span does nothing, so a program holds no trace
of it.

Times are on the profiler's host clock (Unix-time ns): a monotonic clock,
``time.perf_counter_ns``, with the offset to ``time.time_ns`` taken once at
import. A span's start is taken once its range has opened and its end once
the range has closed, so each lies within tens of µs of the range's own
stamps (tests/test_torch_spans.py holds them within 50 µs).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import List, NamedTuple, Optional

import torch
from torch.profiler import record_function

TRACE_FILE = "trace.json"
# spans the ring keeps: ~4000 batched calls of ~16 spans, more than a minute
# of any benchmarked cell
RING_SPANS = 1 << 16

_RING: collections.deque = collections.deque(maxlen=RING_SPANS)
_CALLS = itertools.count(1)
_CLOCK_OFFSET_NS = time.time_ns() - time.perf_counter_ns()
_NOTHING = contextlib.nullcontext()
_now = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    parent: Optional[str]  # the enclosing span's name; None for a call's root
    call: int              # shared by a root and every span under it
    start_ns: int          # Unix-time ns, the profiler's host clock
    end_ns: int


class _Open(threading.local):
    def __init__(self):
        self.stack: List[tuple] = []  # (name, call) of each open span, innermost last


_OPEN = _Open()


class _Span:
    __slots__ = ("name", "parent", "call", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _OPEN.stack
        if stack:
            self.parent, self.call = stack[-1]
        else:
            self.parent, self.call = None, next(_CALLS)
        stack.append((self.name, self.call))
        self.range = None
        if _profiling():
            self.range = record_function(self.name)
            self.range.__enter__()
        self.start = _now()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        end = _now()
        _OPEN.stack.pop()
        _RING.append((self.name, self.parent, self.call, self.start, end))
        return False


def span(name: str):
    """A context manager that records the enclosed host work as a span
    ``name`` (and, under a recording profiler, a range of that name)."""
    if torch.compiler.is_compiling():
        return _NOTHING
    return _Span(name)


def spans() -> List[Span]:
    """The ring's spans, oldest end first (a span is kept when it closes, so
    a call's root follows its children)."""
    off = _CLOCK_OFFSET_NS
    return [Span(n, p, c, s + off, e + off) for n, p, c, s, e in list(_RING)]


@contextlib.contextmanager
def trace_device(logdir: str):
    """Record a ``torch.profiler`` trace of the enclosed region (host ops, and
    CUDA kernels and copies where a card is present) and write it to
    ``logdir/trace.json``, which chrome://tracing and Perfetto open."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
