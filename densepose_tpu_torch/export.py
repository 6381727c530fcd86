"""Export CLI of the PyTorch port, with the contract of the JAX package's
export.py: a config and a detectron2 ``.pkl`` checkpoint -> a self-contained
bundle under ``exported/``.

    python -m densepose_tpu_torch.export <cfg.yaml|zoo-name> [model.pkl] [--min_score S]
        [--nms_thresh T] [--fp16] [--calib IMG ...] [--aot HxW[,HxW...]] [--cpu]
        [--opts KEY VALUE ...]

Writes ``exported/<stem>_fp{32,16}.npz``: the torch-layout weights (the
checkpoint's, aligned to the model; random weights from seed 0 without a
checkpoint), float16 with ``--fp16``, and ``<bundle>.config.json``, the
resolved config (``--fp16`` also sets ``TPU.COMPUTE_DTYPE float16``). The
bundle format is the JAX package's: a bundle from either package loads into
the other (``python -m densepose_tpu_torch.run <bundle>.npz <image>``).

``--calib IMG ...`` calibrates the int8 serving modes on those images and
writes ``<bundle>.calib.json``, which a predictor of the bundle loads when an
int8 mode is on; it calibrates ``TPU.INT8_HEAD`` unless ``--opts`` turned on a
``TPU.INT8_*`` mode. ``--aot HxW,...`` also writes, for each input size, the
request as a ``torch.export`` program, ``<bundle>_<h>x<w>.pt2``
(``DensePosePredictor.aot_export_bytes``; load it with ``aot_load``). Both run
on the CUDA device, or on the CPU with ``--cpu``.

``export_bundle``, ``calibrate_bundle`` and ``export_aot`` are the three
steps without the command line.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .checkpoint.pkl_loader import align_state_dicts, load_checkpoint_file
from .checkpoint.transform import random_torch_state
from .config import get_cfg

INT8_MODES = ("INT8_HEAD", "INT8_BACKBONE", "INT8_RPN", "INT8_PREDICTOR")


def export_bundle(cfg, weights: str, fp16: bool, out_dir: str, stem: str = "model") -> str:
    """Write ``<out_dir>/<stem>_fp{32,16}.npz`` and its ``.config.json``:
    ``cfg`` as it is (with ``MODEL.WEIGHTS`` set to ``weights``), and the
    torch-layout weights of ``weights`` (a ``.pkl``, ``.pth`` or ``.npz``
    checkpoint aligned to the model's names; with no path, random weights
    from seed 0), stored as float16 with ``fp16``, else float32. Returns the
    bundle's path."""
    from .models.rcnn import build_model

    cfg = cfg.clone()
    cfg.defrost()
    cfg.MODEL.WEIGHTS = weights or ""
    cfg.freeze()
    spec = build_model(cfg).spec()
    if weights:
        ckpt, needs_c2 = load_checkpoint_file(weights)
        state = align_state_dicts(list(spec), {k: v.shape for k, v in spec.items()}, ckpt,
                                  needs_c2)
        print(f"matched {len(state)}/{len(spec)} parameters")
    else:
        state = random_torch_state(spec, seed=0)
        print(f"no checkpoint given: exporting {len(spec)} random-init parameters")
    dtype = np.float16 if fp16 else np.float32
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{stem}_fp{'16' if fp16 else '32'}.npz")
    np.savez(path, **{k: v.astype(dtype) for k, v in state.items()})
    with open(path + ".config.json", "w") as f:
        json.dump(cfg.dump_dict(), f, indent=1, default=str)
    print(f"Model saved to {path}")
    return path


def calibrate_bundle(cfg, bundle: str, frames: Sequence[np.ndarray],
                     device: str = "cuda") -> str:
    """Calibrate the int8 modes of ``cfg`` (``TPU.INT8_HEAD`` where it turns
    on none) on ``frames`` with the bundle's weights, and write the scales to
    ``<bundle>.calib.json``. A sidecar already there is removed first: its
    scales would load into the calibrating predictor. Returns the sidecar's
    path."""
    from .predictor import DensePosePredictor

    cfg = cfg.clone()
    cfg.defrost()
    if not any(cfg.TPU[m] for m in INT8_MODES):
        cfg.TPU.INT8_HEAD = True
    cfg.freeze()
    sidecar = bundle + ".calib.json"
    if os.path.exists(sidecar):
        os.remove(sidecar)
    pred = DensePosePredictor(cfg, weights_path=bundle, device=device)
    pred.calibrate_int8(frames)
    pred.save_calibration(sidecar)
    print(f"int8 calibration ({len(frames)} frames) saved to {sidecar}")
    return sidecar


def export_aot(cfg, bundle: str, shapes: Sequence[Tuple[int, int]],
               device: str = "cuda") -> List[str]:
    """For each (H, W) of ``shapes``, the request of a predictor of ``cfg``
    and the bundle as a ``torch.export`` program in
    ``<bundle>_<h>x<w>.pt2``. Returns the paths."""
    from .predictor import DensePosePredictor

    pred = DensePosePredictor(cfg, weights_path=bundle, device=device)
    paths = []
    for h, w in shapes:
        data = pred.aot_export_bytes((h, w))
        path = f"{bundle[:-len('.npz')]}_{h}x{w}.pt2"
        with open(path, "wb") as f:
            f.write(data)
        print(f"AOT program saved to {path} ({len(data) / 1e6:.1f} MB)")
        paths.append(path)
    return paths


def parse_shapes(text: str) -> List[Tuple[int, int]]:
    """``"720x1280,1080x1920"`` -> [(720, 1280), (1080, 1920)]."""
    return [tuple(int(v) for v in s.split("x")) for s in text.lower().split(",")]


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Export a DensePose model to a bundle")
    parser.add_argument("cfg", help="Config YAML or model-zoo name")
    parser.add_argument("model", nargs="?", default="",
                        help="Checkpoint (.pkl); omit to export random-init weights")
    parser.add_argument("--min_score", default=0.3, type=float, help="Minimum detection score")
    parser.add_argument("--nms_thresh", metavar="<threshold>", default=None, type=float,
                        help="NMS threshold")
    parser.add_argument("--fp16", action="store_true",
                        help="Store the weights as float16 and compute in float16")
    parser.add_argument("--aot", metavar="HxW[,HxW...]", default=None,
                        help="Also write the request at these input sizes as torch.export "
                             "programs, <bundle>_<h>x<w>.pt2")
    parser.add_argument("--calib", nargs="+", metavar="IMG", default=None,
                        help="Images to calibrate the int8 modes on; writes "
                             "<bundle>.calib.json. Calibrates TPU.INT8_HEAD unless --opts "
                             "turns on a TPU.INT8_* mode")
    parser.add_argument("--cpu", action="store_true",
                        help="Calibrate and export programs on the CPU")
    parser.add_argument("--opts", nargs="*", default=[], help="Extra dotted-key config overrides")
    args = parser.parse_args(argv)

    if os.path.exists(args.cfg) or args.cfg.endswith((".yaml", ".yml")):
        cfg = get_cfg()
        cfg.merge_from_file(args.cfg)
    else:
        from . import model_zoo
        cfg = model_zoo.get_config(args.cfg).clone()
        cfg.defrost()
    opts = ["MODEL.ROI_HEADS.SCORE_THRESH_TEST", str(args.min_score)]
    if args.nms_thresh is not None:
        opts += ["MODEL.ROI_HEADS.NMS_THRESH_TEST", str(args.nms_thresh)]
    if args.fp16:
        opts += ["TPU.COMPUTE_DTYPE", "float16"]
    cfg.merge_from_list(opts + list(args.opts))
    cfg.freeze()
    stem = os.path.basename(args.cfg).rsplit(".", 1)[0]
    bundle = export_bundle(cfg, args.model, args.fp16, "exported", stem)
    device = "cpu" if args.cpu else "cuda"

    if args.calib:
        import cv2
        frames = []
        for p in args.calib:
            im = cv2.imread(p)
            if im is None:
                raise SystemExit(f"--calib: cannot read image {p}")
            frames.append(im)
        calibrate_bundle(cfg, bundle, frames, device)
    if args.aot:
        export_aot(cfg, bundle, parse_shapes(args.aot), device)


if __name__ == "__main__":
    main()
