"""``upload_ms`` and ``dispatch_ms`` (``benchmark/spans.py``) on a traced
tiny run on the CPU: they read the program's spans of the batches
``submit_ms`` reads, and they read nothing, without failing the run, from a
program that keeps no spans."""

import pytest

from benchmark import manifest, run
from benchmark.tests import tiny
from densepose_tpu_torch.utils import timing

SPAN_METRICS = ("upload_ms", "dispatch_ms")


def traced_run():
    m = manifest.load()
    traffic = dict(tiny.traffic(), trace_batches=1)
    return run.run_cell(m, manifest.cell(m, "r50_fpn_s1x_f16.cams8"), 2 ** 31 + 77, 6.0, True,
                        device="cpu", conf=tiny.conf("r50_fpn_s1x_f16"), traffic=traffic)


def test_spans_read_the_call():
    got = traced_run()["metrics"]
    upload, dispatch = (got[k]["value"] for k in SPAN_METRICS)
    assert upload > 0 and dispatch > 0
    assert upload + dispatch == pytest.approx(got["submit_ms"]["value"], rel=0.1)


def test_silent_where_the_program_keeps_no_spans(monkeypatch):
    monkeypatch.delattr(timing, "spans")
    r = traced_run()
    assert "submit_ms" in r["metrics"]
    assert not set(SPAN_METRICS) & set(r["metrics"])
