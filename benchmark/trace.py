"""Reading a ``torch.profiler`` trace of a stretch of the window.

The trace is reduced to three lists: host ranges (``record_function``
ranges, the program's stage ranges and the harness's own), host events that
launch device work (CPU ops and CUDA runtime calls, by correlation id), and
device events (kernels, copies, sets; the device-side mirrors of host ranges
are left out). Each device event is attributed to the innermost stage range
whose host interval holds the host event that launched it. The window is
the span of the harness's ``bench.batch`` ranges, each of which ends with a
device synchronisation, so all device work of the stretch lies inside it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

BATCH_RANGE = "bench.batch"
DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}


class Events(NamedTuple):
    ranges: List[Tuple[str, int, int]]          # host ranges: name, start ns, end ns
    launches: Dict[int, int]                    # correlation id -> host start ns
    device: List[Tuple[str, int, int, int, int]]  # name, start, end, correlation, linked


def from_profiler(prof) -> Events:
    """The profiler's kineto events as ``Events``."""
    ranges, launches, device = [], {}, []
    for e in prof.profiler.kineto_results.events():
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        start = e.start_ns()
        end = start + e.duration_ns()
        on_device = str(e.device_type()).endswith("CUDA")
        if on_device:
            if not kind or kind in DEVICE_KINDS:
                device.append((e.name(), start, end, e.correlation_id(),
                               e.linked_correlation_id()))
        elif kind == "user_annotation" or getattr(e, "is_user_annotation", lambda: False)():
            ranges.append((e.name(), start, end))
        else:
            launches.setdefault(e.correlation_id(), start)
    host_names = {n for n, _, _ in ranges}  # device mirrors of host ranges
    return Events(ranges, launches, [d for d in device if d[0] not in host_names])


def union_ns(spans: Iterable[Tuple[int, int]], lo: int, hi: int) -> int:
    """Length of the union of the spans, clipped to [lo, hi]."""
    total, end = 0, lo
    for s, e in sorted(spans):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


class RangeIndex:
    """The innermost host range, among ``names``, that holds a time."""

    def __init__(self, ranges: Sequence[Tuple[str, int, int]], names: Optional[set] = None):
        self.items = sorted((s, e, n) for n, s, e in ranges if names is None or n in names)
        self.starts = [s for s, _, _ in self.items]

    def at(self, t: int) -> Optional[str]:
        best = None
        i = bisect.bisect_right(self.starts, t)
        for s, e, n in reversed(self.items[max(0, i - 64):i]):
            if s <= t <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        return best[2] if best else None


def summarize(ev: Events, stages: Sequence[str], top: int = 10) -> dict:
    """Over the window of the ``bench.batch`` ranges: its length, the
    device's busy time, device time by stage and by device operation name,
    the share of device time attributed to a launch, and the longest idle
    gaps by the host range open at their middle. Times in seconds."""
    batches = [(s, e) for n, s, e in ev.ranges if n == BATCH_RANGE]
    if not batches:
        raise ValueError("the trace holds no bench.batch range")
    lo = min(s for s, _ in batches)
    hi = max(e for _, e in batches)
    inside = [d for d in ev.device if d[2] > lo and d[1] < hi]
    busy = union_ns(((d[1], d[2]) for d in inside), lo, hi)
    stage_index = RangeIndex(ev.ranges, set(stages))
    by_stage: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    attributed = 0
    for name, s, e, corr, linked in inside:
        dur = min(e, hi) - max(s, lo)
        by_name[name] += dur
        t = ev.launches.get(corr)
        if t is None:
            t = ev.launches.get(linked)
        if t is None:
            continue
        attributed += dur
        stage = stage_index.at(t)
        if stage is not None:
            by_stage[stage] += dur
    any_index = RangeIndex(ev.ranges)
    gaps: Dict[str, float] = defaultdict(float)
    end = lo
    for s, e in sorted((d[1], d[2]) for d in inside) + [(hi, hi)]:
        if s > end:
            gaps[any_index.at((end + s) // 2) or "no host range"] += s - end
        end = max(end, e)
    total = sum(by_name.values())
    ns = 1e-9
    return {
        "window_s": (hi - lo) * ns,
        "busy_s": busy * ns,
        "batches": len(batches),
        "stage_s": {k: v * ns for k, v in by_stage.items()},
        "op_s": {k: v * ns for k, v in by_name.items()},
        "attributed": attributed / total if total else 0.0,
        "device_ops": [[k, v * ns] for k, v in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[k, v * ns] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
    }


def kernel_s(summary: dict, include: str, exclude: str = "\0") -> float:
    """Device seconds of the operations whose name holds ``include`` and
    not ``exclude``."""
    return sum(v for k, v in summary["op_s"].items() if include in k and exclude not in k)
