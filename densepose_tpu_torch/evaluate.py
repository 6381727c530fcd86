"""Evaluation CLI of the PyTorch port, with the contract of the JAX package's
evaluate.py: run a model over a COCO-format DensePose dataset and report box
AP and DensePose GPS / GPSm AP, checked against the config's
``TEST.EXPECTED_RESULTS`` when it has any.

    python -m densepose_tpu_torch.evaluate <model> <annotations.json> <image_dir> \\
        [--weights model.pkl] [--geodesics file.py::fn] [--max-images N] [--cpu]

``<model>`` is what ``python -m densepose_tpu_torch.run`` takes: a model-zoo
name, a YAML config or an exported ``.npz`` bundle. It runs on the CUDA
device, and on the CPU with ``--cpu``.

annotations.json: COCO format with DensePose fields per annotation (``bbox``
xywh, ``dp_x``/``dp_y`` in 0..255 box-relative coordinates,
``dp_I``/``dp_U``/``dp_V``). Without ``--geodesics`` the GPS point distance
is the planar-UV stand-in (``evaluation.planar_uv_distance``), not the
official SMPL geodesic metric, and the CLI says so on stderr. A config with
``TEST.AUG.ENABLED`` reports under the ``*_TTA`` task names. A miss of
``TEST.EXPECTED_RESULTS`` exits 1.

``evaluate(predictor, coco, read_image, geodist, max_images)`` is the loop
without the files: it takes the annotations as a dict and reads each image
through ``read_image(image_entry)``, so frames held in memory can be
evaluated too.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
from typing import Callable, Dict, List, Optional

import numpy as np

from .evaluation import check_expected_results, coco_box_ap, densepose_ap, planar_uv_distance

PLANAR_UV_WARNING = (
    "=" * 78 + "\n"
    "WARNING: GPS/GPSm below use the PLANAR-UV STAND-IN distance, not\n"
    "the official SMPL geodesic metric (the geodesic tables are external\n"
    "data upstream DensePose downloads; neither this repo nor the\n"
    "reference ships them). Numbers are NOT comparable to the published\n"
    "dp. AP GPS/GPSm figures. Pass --geodesics file.py::build with a\n"
    "builder wrapping your copy of the SMPL tables for the real metric.\n"
    + "=" * 78)


def load_geodesics(spec: str):
    """``file.py::fn`` -> ``fn()``, a geodist callable ``(i1, u1, v1, i2, u2,
    v2) -> distances`` (``fn`` defaults to ``build``)."""
    import importlib.util
    path, _, name = spec.partition("::")
    mod_spec = importlib.util.spec_from_file_location("user_geodesics", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return getattr(module, name or "build")()


def evaluate(predictor, coco: Dict, read_image: Callable[[Dict], Optional[np.ndarray]],
             geodist=planar_uv_distance, max_images: int = 0) -> Dict[str, Dict]:
    """Run ``predictor`` over ``coco["images"]`` (the first ``max_images``
    where given) and score it against ``coco["annotations"]``. ``read_image``
    returns an image entry's (H, W, 3) uint8 BGR frame, or None to skip it
    with a warning. Returns ``{"bbox": ..., "densepose_gps": ...,
    "densepose_gpsm": ...}``, each task name with ``_TTA`` appended under
    ``TEST.AUG.ENABLED``."""
    from .visualizer import DensePoseResultExtractor

    extractor = DensePoseResultExtractor()
    anns_by_image: Dict[int, List[Dict]] = collections.defaultdict(list)
    for ann in coco["annotations"]:
        anns_by_image[ann["image_id"]].append(ann)
    images = coco["images"][:max_images] if max_images else coco["images"]

    box_preds, box_gt, dp_preds, dp_gt = [], [], [], []
    for idx, im in enumerate(images):
        img = read_image(im)
        if img is None:
            print(f"warning: unreadable image {im['file_name']}", file=sys.stderr)
            continue
        out = predictor.predict_numpy(img)
        results, boxes_xywh = extractor(out)
        anns = anns_by_image.get(im["id"], [])
        gt_xyxy = np.array([[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
                             a["bbox"][1] + a["bbox"][3]] for a in anns],
                           dtype=np.float64).reshape(-1, 4)
        box_preds.append({"pred_boxes": out["pred_boxes"], "scores": out["scores"]})
        box_gt.append(gt_xyxy)
        dp_preds.append({"pred_boxes_xywh": boxes_xywh,
                         "scores": out["scores"][:len(boxes_xywh)],
                         "labels": [r["labels"] for r in results],
                         "uv": [r["uv"] for r in results]})
        dp_gt.append(anns)
        print(f"image {idx + 1}/{len(images)}", end="\r", file=sys.stderr)

    # TTA runs report under *_TTA task names (the reference's TTA
    # quick_schedule expects ["bbox_TTA", "densepose_gps_TTA", ...])
    sfx = "_TTA" if predictor.cfg.TEST.AUG.ENABLED else ""
    return {f"bbox{sfx}": coco_box_ap(box_preds, box_gt),
            f"densepose_gps{sfx}": densepose_ap(dp_preds, dp_gt, "gps", geodist),
            f"densepose_gpsm{sfx}": densepose_ap(dp_preds, dp_gt, "gpsm", geodist)}


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("model", help="Model-zoo name, config YAML or exported .npz bundle")
    parser.add_argument("annotations", help="COCO-format DensePose annotations (.json)")
    parser.add_argument("image_dir", help="Directory the annotations' file names are in")
    parser.add_argument("--weights", default="", help="Checkpoint .pkl (with a YAML or zoo name)")
    parser.add_argument("--geodesics", default="",
                        help="file.py::fn building the surface distance (default: the "
                             "planar-UV stand-in)")
    parser.add_argument("--max-images", type=int, default=0)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU")
    parser.add_argument("--opts", nargs="*", default=[], help="Extra dotted-key config overrides")
    args = parser.parse_args(argv)

    import cv2

    from .run import load_predictor

    predictor = load_predictor(args.model, args.weights, args.opts,
                               device="cpu" if args.cpu else "cuda")
    with open(args.annotations) as f:
        coco = json.load(f)
    if args.geodesics:
        geodist = load_geodesics(args.geodesics)
    else:
        geodist = planar_uv_distance
        print("\n" + PLANAR_UV_WARNING, file=sys.stderr)
    results = evaluate(predictor, coco,
                       lambda im: cv2.imread(os.path.join(args.image_dir, im["file_name"])),
                       geodist, args.max_images)
    print(json.dumps(results, indent=1))
    expected = list(predictor.cfg.TEST.EXPECTED_RESULTS)
    if expected:
        failures = check_expected_results(results, expected)
        if failures:
            print("EXPECTED_RESULTS check FAILED:", *failures, sep="\n  ")
            sys.exit(1)
        print("EXPECTED_RESULTS check passed")


if __name__ == "__main__":
    main()
