"""The parts of a model that differ between configurations, each a file
found by the name the configuration file's ``model`` section gives it, as
``manifest.reader`` finds a metric.

A backbone, ``reference/backbones/<MODEL.BACKBONE.NAME>.py``, gives

* ``shapes(cfg)``: its weights, {detectron2 module name: shape}, in order;
* ``forward(cfg, w, x)``: its levels, {name: (1, C, h, w)}, of the padded
  input x (1, 3, Hp, Wp);
* ``strides(cfg)``: {level: stride} of every level it gives;
* ``out_channels(cfg)``: the channels of each level;
* ``size_divisibility(cfg)``: what the input is padded to a multiple of;
* ``flops(cfg, hw)``: FLOPs of one forward on an (Hp, Wp) canvas.

A DensePose head, ``reference/heads/<MODEL.ROI_DENSEPOSE_HEAD.NAME>.py``,
gives

* ``shapes(cfg, cin)``: its weights on pooled regions of ``cin`` channels;
* ``forward(cfg, w, x)``: its output on the pooled regions x (n, cin, r, r);
* ``out_channels(cfg)``: the channels of that output;
* ``flops(cfg, cin, rows)``: FLOPs of a forward on ``rows`` regions.

Everything else the reference and the counts read (the RPN, the box stage,
the decoder, the poolers, the chart predictor) is shared and reads the
levels, their strides, widths and padding only through these functions.
"""

from __future__ import annotations

import functools

from . import manifest


def backbone(cfg: dict):
    """The backbone part the configuration names."""
    return _part("backbones", cfg["MODEL.BACKBONE.NAME"])


def head(cfg: dict):
    """The DensePose head part the configuration names."""
    return _part("heads", cfg["MODEL.ROI_DENSEPOSE_HEAD.NAME"])


def head_in_channels(cfg: dict) -> int:
    """Channels of the regions the DensePose head is fed: the decoder's
    classes where the decoder runs, else the backbone's levels'."""
    dp = "MODEL.ROI_DENSEPOSE_HEAD."
    return cfg[dp + "DECODER_NUM_CLASSES"] if cfg[dp + "DECODER_ON"] \
        else backbone(cfg).out_channels(cfg)


@functools.lru_cache(maxsize=None)
def _part(kind: str, name: str):
    path = manifest.HERE / "reference" / kind / f"{name}.py"
    if not manifest.NAME.match(name) or not path.is_file():
        raise LookupError(f"no {kind[:-1]} part named {name!r}: add the file "
                          f"benchmark/reference/{kind}/{name}.py (benchmark/parts.py "
                          f"says what it gives)")
    return manifest.load_file(path, f"benchmark.reference.{kind}.{name}")
