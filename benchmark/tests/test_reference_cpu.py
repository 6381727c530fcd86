"""The plain reference against the program on the CPU, at tiny widths of
each configuration, both in float32, through a whole run of the harness."""

import pytest

from benchmark import manifest, run
from benchmark.tests import tiny


@pytest.mark.parametrize("name", ["r50_fpn_s1x_f16", "r101_fpn_legacy_f16"])
def test_reference_matches_the_program(name):
    m = manifest.load()
    r = run.run_cell(m, manifest.cell(m, f"{name}.cams8"), 2 ** 31 + 11, 1.5, False,
                     device="cpu", conf=tiny.conf(name), traffic=tiny.traffic())
    n = {k: v["value"] for k, v in r["compared"].items()}
    assert r["checked_frames"] >= 2 and r["failed"] == 0
    assert n["size_err"] == 0 and n["unpaired"] == 0 and n["unpaired_frame"] == 0
    assert n["maps_rel"] < 1e-4
    assert r["correct"]
