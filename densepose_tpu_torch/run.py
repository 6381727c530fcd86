"""Run CLI of the PyTorch port, with the contract of the JAX package's run.py
(the reference's run.py): ``<input>`` becomes ``<input>_pred.<ext>``.

    python -m densepose_tpu_torch.run <zoo-name|config.yaml|bundle.npz> <image|dir|video> [--cpu]

``<model>`` is a model-zoo name (``densepose_rcnn_R_50_FPN_s1x``; its
published checkpoint is used when it is cached, else random weights with a
warning) or a YAML config (``--weights`` for a detectron2 ``.pkl``; random
weights otherwise). It runs on the CUDA device, and on the CPU with
``--cpu``; without ``--cpu`` and without a card it raises. It computes in
the config's ``TPU.COMPUTE_DTYPE`` (float32 by default; ``--opts
TPU.COMPUTE_DTYPE float16`` or ``bfloat16`` for half precision with the
reference's fp32 islands), and in float32 whatever the config says with
``--fp32``. A directory is
walked image by image, skipping its own ``*_pred`` outputs; a video goes
through the streaming pipeline (``parallel/pipeline.py``) and is written as
``<input>_pred.mp4``.

A directory of images of more than one size turns on input-geometry
bucketing (``TPU.GEOMETRY_BUCKET_QUANT 64``, with a note on stderr) unless
``--no-bucket``, an explicit ``--opts TPU.GEOMETRY_BUCKET_QUANT``, or a mode
that manages its own geometry (``TPU.BUCKETED_DENSEPOSE``,
``TEST.AUG.ENABLED``) says otherwise, so that the port gives the JAX CLI's
numbers on the same directory. A config with ``TEST.AUG.ENABLED`` runs
multi-scale + flip test-time augmentation (``tta.py``).

An HRNet config runs like any other. A CSE config
(``DensePoseEmbeddingPredictor``) draws only ``--vis bbox``: the chart
overlays read maps a CSE model does not make, and the CLI refuses them
before it runs (the JAX CLI fails inside its visualizer); the CSE overlay is
``visualizer.CseVisualizer``, from Python.

``<model>`` may also be an exported ``.npz`` bundle (``python -m
densepose_tpu_torch.export``, or the JAX package's export.py): its
``.config.json`` gives the config (``--fp32`` and ``--opts`` apply on top of
it) and its ``.calib.json``, where there is one, the int8 scales.

Batched video frames are not ported: ``--batch`` is accepted and a video runs
frame by frame.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

IMAGE_EXTS = [".jpg", ".png", ".jpeg", ".bmp", ".tif", ".tiff"]


def scan_dir_sizes(dirpath: str, limit: int = 16):
    """The decoded (h, w) of up to ``limit`` images of ``dirpath``, stopping
    at the second size: the probe for a mixed-size directory."""
    import cv2
    sizes = set()
    for name in image_names(dirpath)[:limit]:
        img = cv2.imread(os.path.join(dirpath, name))
        if img is not None:
            sizes.add(img.shape[:2])
        if len(sizes) > 1:
            break
    return sizes


def maybe_auto_bucket(cfg, opts: List[str]) -> None:
    """A mixed-size directory: turn on input-geometry bucketing at quantum 64,
    as the JAX CLI does (run.py:50-72), unless ``--opts`` set
    TPU.GEOMETRY_BUCKET_QUANT or the config already buckets or runs TTA."""
    if opts and "TPU.GEOMETRY_BUCKET_QUANT" in opts:
        return  # the user decided
    if cfg.TPU.GEOMETRY_BUCKET_QUANT or cfg.TPU.BUCKETED_DENSEPOSE or cfg.TEST.AUG.ENABLED:
        return  # already on, or a mode that manages its own geometry
    cfg.TPU.GEOMETRY_BUCKET_QUANT = 64
    print("note: mixed-size directory — enabling input-geometry bucketing "
          "(TPU.GEOMETRY_BUCKET_QUANT 64); pass --no-bucket or --opts "
          "TPU.GEOMETRY_BUCKET_QUANT 0 for one exact graph per size", file=sys.stderr)


def load_predictor(model_path: str, weights: str, opts: List[str], device: str,
                   fp32: bool = False, auto_bucket: bool = False):
    """The CLI's predictor: a ``DensePosePredictor``, wrapped in a
    ``TTAPredictor`` when the config has ``TEST.AUG.ENABLED``.
    ``auto_bucket``: the input is a mixed-size directory
    (``maybe_auto_bucket``)."""
    from .config import CfgNode, get_cfg
    from .predictor import DensePosePredictor

    if model_path.endswith(".npz"):
        # an exported bundle: its config.json, then --fp32, then --opts, as the
        # JAX CLI merges them (run.py:72-81); the weights are the bundle's
        cfg = get_cfg()
        with open(model_path + ".config.json") as f:
            cfg.merge_from_other_cfg(CfgNode(json.load(f)))
        if fp32:
            cfg.TPU.COMPUTE_DTYPE = "float32"
        if opts:
            cfg.merge_from_list(opts)
        if auto_bucket:
            maybe_auto_bucket(cfg, opts)
        cfg.freeze()
        return wrap_tta(DensePosePredictor(cfg, weights_path=model_path, device=device))
    if not os.path.exists(model_path) and not model_path.endswith((".yaml", ".yml")):
        from . import model_zoo
        from .utils.file_io import get_local_path
        cfg = model_zoo.get_config(model_path).clone()
        cfg.defrost()
        if not weights:
            try:
                weights = get_local_path(model_zoo.get_checkpoint_url(model_path))
            except (KeyError, IOError) as e:
                print(f"warning: {e}; using random weights", file=sys.stderr)
    else:
        cfg = get_cfg()
        cfg.merge_from_file(model_path)
    if opts:
        cfg.merge_from_list(opts)
    if fp32:
        cfg.TPU.COMPUTE_DTYPE = "float32"
    if auto_bucket:
        maybe_auto_bucket(cfg, opts)
    cfg.freeze()
    return wrap_tta(DensePosePredictor(cfg, weights_path=weights or None, device=device))


def wrap_tta(pred):
    """``pred`` in a ``TTAPredictor`` when its config has ``TEST.AUG.ENABLED``."""
    if pred.cfg.TEST.AUG.ENABLED:
        from .tta import TTAPredictor
        return TTAPredictor(pred)
    return pred


def check_vis(cfg, vis: str) -> None:
    """A CSE model has no chart maps: only ``--vis bbox`` can draw it."""
    if (cfg.MODEL.ROI_DENSEPOSE_HEAD.PREDICTOR_NAME == "DensePoseEmbeddingPredictor"
            and vis != "bbox"):
        raise ValueError(f"--vis {vis} draws chart maps (fine segmentation, U, V), which a "
                         "CSE model (DensePoseEmbeddingPredictor) does not output; use --vis "
                         "bbox, or visualizer.CseVisualizer from Python for its "
                         "closest-vertex overlay")


def image_names(dirpath: str) -> List[str]:
    """The images of a directory, sorted, without the ``*_pred`` outputs."""
    return sorted(f for f in os.listdir(dirpath)
                  if os.path.splitext(f)[1].lower() in IMAGE_EXTS
                  and not os.path.splitext(f)[0].endswith("_pred"))


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Run DensePose inference on image/video")
    parser.add_argument("model", type=str,
                        help="Model-zoo name, config YAML or exported .npz bundle")
    parser.add_argument("input", type=str, help="Input image, directory of images, or video")
    parser.add_argument("--weights", type=str, default="",
                        help="Checkpoint .pkl (default: the zoo name's, if cached)")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU")
    parser.add_argument("--fp32", action="store_true",
                        help="Force float32 compute, over the config's and --opts' "
                             "TPU.COMPUTE_DTYPE")
    parser.add_argument("--batch", type=int, default=0,
                        help="Video frames per batch (accepted for the JAX CLI's contract; "
                             "the port runs frame by frame on one device)")
    parser.add_argument("--opts", nargs="*", default=[],
                        help="Extra dotted-key config overrides")
    parser.add_argument("--profile", metavar="DIR", default="",
                        help="Write a torch.profiler trace of the run to DIR/trace.json")
    parser.add_argument("--vis", default="fine_segm", choices=["fine_segm", "u", "v", "bbox"],
                        help="Overlay: fine-segm labels (the reference's), U/V channels, "
                             "or scored boxes")
    parser.add_argument("--no-bucket", action="store_true",
                        help="Disable the input-geometry bucketing that a directory of "
                             "mixed-size images turns on (every size then runs exactly)")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    from .visualizer import End2EndVisualizer

    visualizer = End2EndVisualizer(alpha=0.7, keep_bg=False, mode=args.vis)
    auto_bucket = (not args.no_bucket and os.path.isdir(args.input)
                   and len(scan_dir_sizes(args.input)) > 1)
    predictor = load_predictor(args.model, args.weights, args.opts,
                               device="cpu" if args.cpu else "cuda", fp32=args.fp32,
                               auto_bucket=auto_bucket)
    check_vis(predictor.cfg, args.vis)
    if args.profile:
        from .utils.timing import TRACE_FILE, trace_device
        with trace_device(args.profile):
            _dispatch(args, predictor, visualizer)
        print(f"trace written to {os.path.join(args.profile, TRACE_FILE)}", file=sys.stderr)
    else:
        _dispatch(args, predictor, visualizer)


def _dispatch(args, predictor, visualizer) -> None:
    import cv2

    fetch = visualizer.fetch_keys()  # only the maps the overlay reads cross to the host

    if os.path.isdir(args.input):
        names = image_names(args.input)
        if not names:
            sys.exit(f"error: no images in {args.input!r}")
        for i, name in enumerate(names):
            path = os.path.join(args.input, name)
            img = cv2.imread(path)
            if img is None:
                print(f"warning: skipping unreadable {path}", file=sys.stderr)
                continue
            outputs = predictor.numpy_outputs(predictor(img), keys=fetch)
            out_path = "_pred".join(os.path.splitext(path))
            cv2.imwrite(out_path, visualizer.visualize(img, outputs))
            print(f"Image {i + 1}/{len(names)} saved to {out_path}")
        return

    save_path = "_pred".join(os.path.splitext(args.input))
    if os.path.splitext(args.input)[1].lower() in IMAGE_EXTS:
        img = cv2.imread(args.input)
        if img is None:
            sys.exit(f"error: could not read image {args.input!r}")
        outputs = predictor.numpy_outputs(predictor(img), keys=fetch)
        cv2.imwrite(save_path, visualizer.visualize(img, outputs))
        print(f"Image saved to {save_path}")
        return

    from .parallel.pipeline import run_video
    save_path = os.path.splitext(save_path)[0] + ".mp4"
    if args.batch > 1:
        print(f"note: --batch {args.batch}: the port runs frame by frame on one device; "
              "batched video is not ported yet (ROADMAP.md queue 1)", file=sys.stderr)
    run_video(predictor, visualizer, args.input, save_path)


if __name__ == "__main__":
    main()
