"""On the card, at the cell's own size: a sound run comes out correct and
the configuration's control (the program's int8 path) does not. Run on the
machine with the card:

    python3 -m pytest benchmark/tests -m gpu
"""

import pytest

from benchmark import manifest, run

CELLS = ["r50_fpn_s1x_f16.cams8", "r101_fpn_legacy_f16.cams8"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("control", [False, True], ids=["sound", "control"])
def test_control_fails_sound_passes(card, cell, control):
    m = manifest.load()
    r = run.run_cell(m, manifest.cell(m, cell), 2 ** 31 + 77, 4.0, False, control=control)
    assert r["checked_frames"] > 0
    assert r["correct"] is (not control)
