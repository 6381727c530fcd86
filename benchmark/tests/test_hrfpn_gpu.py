"""On the card, the HRNet-W48 + HRFPN cell at its own size: a sound run
comes out correct and the configuration's control (the program's int8 path)
does not; and in a batch only HRFPN's 4x and 8x upsamples leave kernel U1
for PyTorch's bilinear kernel, two calls a batch, while the two ResNet cells
make none. Run on the machine with the card:

    python3 -m pytest benchmark/tests -m gpu
"""

import pytest

from benchmark import frames, manifest, run, weights
from benchmark.reference import model as reference

CELL = "hrnet_w48_f16.cams8"
SEED = 2 ** 31 + 77


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("control", [False, True], ids=["sound", "control"])
def test_control_fails_sound_passes(card, control):
    m = manifest.load()
    r = run.run_cell(m, manifest.cell(m, CELL), SEED, 8.0, False, control=control)
    assert r["checked_frames"] > 0
    assert r["correct"] is (not control)


@pytest.mark.gpu
@pytest.mark.parametrize("cell, per_batch", [(CELL, 2), ("r50_fpn_s1x_f16.cams8", 0),
                                             ("r101_fpn_legacy_f16.cams8", 0)])
def test_library_upsamples_a_batch(card, cell, per_batch):
    import torch

    from densepose_tpu_torch.ops import resize
    from densepose_tpu_torch.predictor import DensePosePredictor
    m = manifest.load()
    c = manifest.cell(m, cell)
    conf = manifest.config(m, c["config"])
    w = weights.make_weights(reference.state_shapes(conf["model"]), conf["init"], SEED, "cuda",
                             conf["dtype"])
    pred = DensePosePredictor(run.program_config(conf, False), device="cuda",
                              params=weights.host_params(w))
    pool = frames.FramePool(manifest.traffic(c["traffic"]), SEED)
    pred.predict_batch(pool.batch(0))
    before = resize.resize_bilinear.library_calls
    for i in range(1, 4):
        pred.predict_batch(pool.batch(i))
    torch.cuda.synchronize()
    assert resize.resize_bilinear.library_calls - before == 3 * per_batch
