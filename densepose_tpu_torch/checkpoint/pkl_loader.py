"""Checkpoint loading: detectron2-zoo / Caffe2 ``.pkl`` files and exported
``.npz`` bundles -> flat name->ndarray state dicts, byte-compatible with the
reference loader.

The PyTorch port's copy of densepose_tpu/checkpoint/pkl_loader.py.
Reproduces the full load stack of the reference's
detectron2/checkpoint/{detection_checkpoint.py, c2_model_loading.py}:

* pickle with latin1 encoding; zoo format ``{"model":..., "__author__":...}``
  vs raw Caffe2 blob dicts (detection_checkpoint.py:49-63),
* the Caffe2 regex rename tables incl. the DensePose-specific names
  (c2_model_loading.py:10-63),
* background-class weight surgery on ``bbox_pred``/``cls_score``
  (c2_model_loading.py:184-200),
* suffix-matching alignment, longest match wins, shape-mismatch skip
  (align_and_update_state_dicts, c2_model_loading.py:209-329).

Everything here is host-side numpy (torch only to read ``.pt`` files).
"""

from __future__ import annotations

import logging
import pickle
import re
from typing import Dict, Tuple

import numpy as np

logger = logging.getLogger(__name__)

StateDict = Dict[str, np.ndarray]


def load_checkpoint_file(filename: str) -> Tuple[StateDict, bool]:
    """Returns (state_dict, needs_c2_conversion)."""
    if filename.endswith(".pkl"):
        with open(filename, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        if "model" in data and "__author__" in data:
            logger.info("Reading a file from '%s'", data["__author__"])
            model = data["model"]
            return ({k: np.asarray(v) for k, v in model.items()}, False)
        if "blobs" in data:
            data = data["blobs"]
        data = {k: np.asarray(v) for k, v in data.items() if not k.endswith("_momentum")}
        return data, True
    if filename.endswith(".npz"):
        # an exported bundle (``python -m densepose_tpu_torch.export``, or the
        # JAX package's export.py): torch-layout names, float32 or float16
        with np.load(filename, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}, False
    if filename.endswith((".pt", ".pth", ".pyth")):
        # torch-format checkpoints (detection_checkpoint.py:64-90)
        import torch
        data = torch.load(filename, map_location="cpu", weights_only=False)
        if isinstance(data, dict) and "model" in data:
            data = data["model"]
        elif isinstance(data, dict) and "model_state" in data:  # pycls .pyth
            data = {k: v for k, v in data["model_state"].items()
                    if not k.endswith("num_batches_tracked")}
        return ({k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
                 for k, v in data.items()}, False)
    raise ValueError(f"Unsupported checkpoint format: {filename}")


def _convert_basic_c2_names(original_keys):
    """c2_model_loading.py:10-63 rename pipeline."""
    keys = list(original_keys)
    keys = [{"pred_b": "linear_b", "pred_w": "linear_w"}.get(k, k) for k in keys]
    keys = [k.replace("_", ".") for k in keys]
    keys = [re.sub(r"\.b$", ".bias", k) for k in keys]
    keys = [re.sub(r"\.w$", ".weight", k) for k in keys]
    keys = [re.sub(r"bn\.s$", "norm.weight", k) for k in keys]
    keys = [re.sub(r"bn\.bias$", "norm.bias", k) for k in keys]
    keys = [re.sub(r"bn\.rm", "norm.running_mean", k) for k in keys]
    keys = [re.sub(r"bn\.running.mean$", "norm.running_mean", k) for k in keys]
    keys = [re.sub(r"bn\.riv$", "norm.running_var", k) for k in keys]
    keys = [re.sub(r"bn\.running.var$", "norm.running_var", k) for k in keys]
    keys = [re.sub(r"bn\.gamma$", "norm.weight", k) for k in keys]
    keys = [re.sub(r"bn\.beta$", "norm.bias", k) for k in keys]
    keys = [re.sub(r"gn\.s$", "norm.weight", k) for k in keys]
    keys = [re.sub(r"gn\.bias$", "norm.bias", k) for k in keys]
    keys = [re.sub(r"^res\.conv1\.norm\.", "conv1.norm.", k) for k in keys]
    keys = [re.sub(r"^conv1\.", "stem.conv1.", k) for k in keys]
    keys = [k.replace(".branch1.", ".shortcut.") for k in keys]
    keys = [k.replace(".branch2a.", ".conv1.") for k in keys]
    keys = [k.replace(".branch2b.", ".conv2.") for k in keys]
    keys = [k.replace(".branch2c.", ".conv3.") for k in keys]
    # DensePose-specific names (c2_model_loading.py:57-62)
    keys = [re.sub(r"^body.conv.fcn", "body_conv_fcn", k) for k in keys]
    keys = [k.replace("AnnIndex.lowres", "ann_index_lowres") for k in keys]
    keys = [k.replace("Index.UV.lowres", "index_uv_lowres") for k in keys]
    keys = [k.replace("U.lowres", "u_lowres") for k in keys]
    keys = [k.replace("V.lowres", "v_lowres") for k in keys]
    return keys


def _fpn_map(name: str) -> str:
    splits = name.split(".")
    norm = ".norm" if "norm" in splits else ""
    if name.startswith("fpn.inner."):
        stage = int(splits[2][len("res"):])
        return f"fpn_lateral{stage}{norm}.{splits[-1]}"
    if name.startswith("fpn.res"):
        stage = int(splits[1][len("res"):])
        return f"fpn_output{stage}{norm}.{splits[-1]}"
    return name


def convert_c2_names(weights: StateDict) -> Tuple[StateDict, Dict[str, str]]:
    """Caffe2 Detectron -> detectron2 names (c2_model_loading.py:66-206)."""
    original_keys = sorted(weights.keys())
    keys = _convert_basic_c2_names(original_keys)

    keys = [k.replace("conv.rpn.fpn2", "proposal_generator.rpn_head.conv") for k in keys]
    keys = [k.replace("conv.rpn", "proposal_generator.rpn_head.conv") for k in keys]
    keys = [k.replace("rpn.bbox.pred.fpn2", "proposal_generator.rpn_head.anchor_deltas") for k in keys]
    keys = [k.replace("rpn.cls.logits.fpn2", "proposal_generator.rpn_head.objectness_logits") for k in keys]
    keys = [k.replace("rpn.bbox.pred", "proposal_generator.rpn_head.anchor_deltas") for k in keys]
    keys = [k.replace("rpn.cls.logits", "proposal_generator.rpn_head.objectness_logits") for k in keys]

    keys = [re.sub(r"^bbox\.pred", "bbox_pred", k) for k in keys]
    keys = [re.sub(r"^cls\.score", "cls_score", k) for k in keys]
    keys = [re.sub(r"^fc6\.", "box_head.fc1.", k) for k in keys]
    keys = [re.sub(r"^fc7\.", "box_head.fc2.", k) for k in keys]
    keys = [re.sub(r"^head\.conv", "box_head.conv", k) for k in keys]

    keys = [_fpn_map(k) for k in keys]

    keys = [k.replace(".[mask].fcn", "mask_head.mask_fcn") for k in keys]
    keys = [re.sub(r"^\.mask\.fcn", "mask_head.mask_fcn", k) for k in keys]
    keys = [k.replace("mask.fcn.logits", "mask_head.predictor") for k in keys]
    keys = [k.replace("conv5.mask", "mask_head.deconv") for k in keys]

    keys = [k.replace("conv.fcn", "roi_heads.keypoint_head.conv_fcn") for k in keys]
    keys = [k.replace("kps.score.lowres", "roi_heads.keypoint_head.score_lowres") for k in keys]
    keys = [k.replace("kps.score.", "roi_heads.keypoint_head.score.") for k in keys]

    assert len(set(keys)) == len(keys), "c2 rename produced duplicate keys"

    new_weights: StateDict = {}
    new_to_orig: Dict[str, str] = {}
    for orig, renamed in zip(original_keys, keys):
        new_to_orig[renamed] = orig
        if renamed.startswith("bbox_pred.") or renamed.startswith("mask_head.predictor."):
            # drop the background-class prediction (c2_model_loading.py:184-193)
            start = 4 if renamed.startswith("bbox_pred.") else 1
            new_weights[renamed] = weights[orig][start:]
        elif renamed.startswith("cls_score."):
            # move bg class weights from index 0 to the last index (:194-200)
            w = weights[orig]
            new_weights[renamed] = np.concatenate([w[1:], w[:1]], axis=0)
        else:
            new_weights[renamed] = weights[orig]
    return new_weights, new_to_orig


def align_state_dicts(
    model_keys,
    model_shapes: Dict[str, Tuple[int, ...]],
    ckpt: StateDict,
    c2_conversion: bool,
) -> StateDict:
    """Suffix-match checkpoint keys onto model keys
    (align_and_update_state_dicts, c2_model_loading.py:209-329).

    A ckpt key matches a model key when equal or when the model key ends with
    "." + ckpt key; among multiple matches the longest ckpt key wins.
    Shape mismatches are skipped with a warning (that is how WC-variant
    confidence weights are tolerated by non-WC models and vice versa).
    """
    if c2_conversion:
        ckpt, _ = convert_c2_names(ckpt)
    model_keys = sorted(model_keys)
    ckpt_keys = sorted(ckpt.keys())

    result: StateDict = {}
    matched_ckpt = {}
    for mk in model_keys:
        best = None
        for ck in ckpt_keys:
            if mk == ck or mk.endswith("." + ck):
                if best is None or len(ck) > len(best):
                    best = ck
        if best is None:
            continue
        value = ckpt[best]
        if tuple(model_shapes[mk]) != tuple(value.shape):
            logger.warning(
                "Shape of %s in checkpoint is %s, while shape of %s in model is %s; skipped.",
                best, value.shape, mk, model_shapes[mk])
            continue
        if best in matched_ckpt:
            raise ValueError(
                f"Cannot match one checkpoint key to multiple keys in the model: "
                f"{best} -> {matched_ckpt[best]}, {mk}")
        matched_ckpt[best] = mk
        result[mk] = value
    if not result:
        logger.warning("No weights in checkpoint matched with model.")
    return result
