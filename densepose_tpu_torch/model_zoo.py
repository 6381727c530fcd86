"""Standalone model zoo: every model variant the reference's ``configs/``
tree describes, expressed as config deltas in code (the PyTorch port's own
copy of densepose_tpu/model_zoo.py).

This makes the framework self-contained — no YAML files needed — while
``cfg.merge_from_file`` still accepts the reference's own YAMLs unchanged.
The matrix mirrors SURVEY.md section 5 (config system): 23 chart top-levels
(R50/R101 x {legacy, s1x, DL} x {plain, WC1, WC2, WC1M, WC2M}), 3 HRNet,
CSE human/animal variants.

Checkpoint URLs are the detectron2 DensePose model-zoo files the reference's
README links; with network egress they download through utils.file_io.
"""

from __future__ import annotations

from typing import Dict, List

from .config import CfgNode, get_cfg

_ZOO: Dict[str, List] = {}


def _base_fpn(cfg: CfgNode) -> None:
    """The shared DensePose R-CNN FPN trunk (Base-DensePose-RCNN-FPN)."""
    m = cfg.MODEL
    m.BACKBONE.NAME = "build_resnet_fpn_backbone"
    m.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    m.ANCHOR_GENERATOR.SIZES = [[32], [64], [128], [256], [512]]
    m.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]
    m.RPN.IN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
    m.RPN.PRE_NMS_TOPK_TEST = 1000
    m.RPN.POST_NMS_TOPK_TEST = 1000
    m.DENSEPOSE_ON = True
    m.ROI_HEADS.NAME = "DensePoseROIHeads"
    m.ROI_HEADS.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    m.ROI_HEADS.NUM_CLASSES = 1
    m.ROI_BOX_HEAD.NAME = "FastRCNNConvFCHead"
    m.ROI_BOX_HEAD.NUM_FC = 2
    m.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    m.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 2
    m.ROI_BOX_HEAD.POOLER_TYPE = "ROIAlign"
    m.ROI_DENSEPOSE_HEAD.NAME = "DensePoseV1ConvXHead"
    m.ROI_DENSEPOSE_HEAD.POOLER_TYPE = "ROIAlign"
    m.ROI_DENSEPOSE_HEAD.NUM_COARSE_SEGM_CHANNELS = 2


def _register_chart_variants() -> None:
    zoo_url = "https://dl.fbaipublicfiles.com/densepose"
    # (suffix, deltas) — WC = UV confidence, M = +segm confidence
    conf = {
        "": [],
        "_WC1": ["MODEL.ROI_DENSEPOSE_HEAD.UV_CONFIDENCE.ENABLED", True,
                 "MODEL.ROI_DENSEPOSE_HEAD.UV_CONFIDENCE.TYPE", "iid_iso"],
        "_WC2": ["MODEL.ROI_DENSEPOSE_HEAD.UV_CONFIDENCE.ENABLED", True,
                 "MODEL.ROI_DENSEPOSE_HEAD.UV_CONFIDENCE.TYPE", "indep_aniso"],
        "_WC1M": ["MODEL.ROI_DENSEPOSE_HEAD.UV_CONFIDENCE.ENABLED", True,
                  "MODEL.ROI_DENSEPOSE_HEAD.UV_CONFIDENCE.TYPE", "iid_iso",
                  "MODEL.ROI_DENSEPOSE_HEAD.SEGM_CONFIDENCE.ENABLED", True],
        "_WC2M": ["MODEL.ROI_DENSEPOSE_HEAD.UV_CONFIDENCE.ENABLED", True,
                  "MODEL.ROI_DENSEPOSE_HEAD.UV_CONFIDENCE.TYPE", "indep_aniso",
                  "MODEL.ROI_DENSEPOSE_HEAD.SEGM_CONFIDENCE.ENABLED", True],
    }
    for depth in (50, 101):
        base = ["MODEL.RESNETS.DEPTH", depth]
        for dl in ("", "_DL"):
            head = (["MODEL.ROI_DENSEPOSE_HEAD.NAME", "DensePoseDeepLabHead"]
                    if dl else [])
            for c, cdelta in conf.items():
                name = f"densepose_rcnn_R_{depth}_FPN{dl}{c}_s1x"
                _ZOO[name] = base + head + cdelta
        # legacy: no decoder, 14x14 pooler, 56 heatmap, 15 coarse channels
        _ZOO[f"densepose_rcnn_R_{depth}_FPN_s1x_legacy"] = base + [
            "MODEL.ROI_DENSEPOSE_HEAD.NUM_COARSE_SEGM_CHANNELS", 15,
            "MODEL.ROI_DENSEPOSE_HEAD.POOLER_RESOLUTION", 14,
            "MODEL.ROI_DENSEPOSE_HEAD.HEATMAP_SIZE", 56,
            "MODEL.ROI_DENSEPOSE_HEAD.DECODER_ON", False,
        ]
    del zoo_url  # checkpoint URLs resolved by the caller when downloading


def _register_hrnet_variants() -> None:
    widths = {32: [32, 64, 128, 256], 40: [40, 80, 160, 320], 48: [48, 96, 192, 384]}
    for w, chans in widths.items():
        _ZOO[f"densepose_rcnn_HRFPN_HRNet_w{w}_s1x"] = [
            "MODEL.BACKBONE.NAME", "build_hrfpn_backbone",
            "MODEL.RPN.IN_FEATURES", ["p1", "p2", "p3", "p4", "p5"],
            "MODEL.ROI_HEADS.IN_FEATURES", ["p1", "p2", "p3", "p4", "p5"],
            "MODEL.HRNET.STAGE2.NUM_CHANNELS", chans[:2],
            "MODEL.HRNET.STAGE3.NUM_CHANNELS", chans[:3],
            "MODEL.HRNET.STAGE4.NUM_CHANNELS", chans,
        ]


def _register_cse_variants() -> None:
    cse_base = [
        "MODEL.ROI_DENSEPOSE_HEAD.PREDICTOR_NAME", "DensePoseEmbeddingPredictor",
        "MODEL.ROI_DENSEPOSE_HEAD.LOSS_NAME", "DensePoseCseLoss",
    ]
    human_embedder = [
        "MODEL.ROI_DENSEPOSE_HEAD.CSE.EMBEDDERS",
        {"smpl_27554": {"TYPE": "vertex_feature", "NUM_VERTICES": 27554,
                        "FEATURE_DIM": 256, "FEATURES_TRAINABLE": False,
                        "IS_TRAINABLE": True}},
        "DATASETS.CLASS_TO_MESH_NAME_MAPPING", {"0": "smpl_27554"},
    ]
    for depth in (50, 101):
        for dl in ("", "_DL"):
            head = (["MODEL.ROI_DENSEPOSE_HEAD.NAME", "DensePoseDeepLabHead"]
                    if dl else ["MODEL.ROI_DENSEPOSE_HEAD.NAME", "DensePoseV1ConvXHead"])
            for soft in ("", "_soft"):
                name = f"densepose_rcnn_R_{depth}_FPN{dl}{soft}_s1x_cse"
                _ZOO[name] = (["MODEL.RESNETS.DEPTH", depth] + head + cse_base
                              + human_embedder)


_register_chart_variants()
_register_hrnet_variants()
_register_cse_variants()


# Trained checkpoints the reference's README publishes (README.md zoo
# tables; detectron2 DensePose model zoo). Resolved through
# utils.file_io.get_local_path (cached download) when egress exists.
_CHECKPOINTS = {
    "densepose_rcnn_R_50_FPN_s1x":
        "https://dl.fbaipublicfiles.com/densepose/densepose_rcnn_R_50_FPN_s1x/165712039/model_final_162be9.pkl",
    "densepose_rcnn_R_101_FPN_s1x":
        "https://dl.fbaipublicfiles.com/densepose/densepose_rcnn_R_101_FPN_s1x/165712084/model_final_c6ab63.pkl",
    "densepose_rcnn_R_50_FPN_DL_s1x":
        "https://dl.fbaipublicfiles.com/densepose/densepose_rcnn_R_50_FPN_DL_s1x/165712097/model_final_0ed407.pkl",
    "densepose_rcnn_R_101_FPN_DL_s1x":
        "https://dl.fbaipublicfiles.com/densepose/densepose_rcnn_R_101_FPN_DL_s1x/165712116/model_final_844d15.pkl",
    "densepose_rcnn_R_50_FPN_s1x_legacy":
        "https://dl.fbaipublicfiles.com/densepose/densepose_rcnn_R_50_FPN_s1x_legacy/164832157/model_final_d366fa.pkl",
    "densepose_rcnn_R_101_FPN_s1x_legacy":
        "https://dl.fbaipublicfiles.com/densepose/densepose_rcnn_R_101_FPN_s1x_legacy/164832182/model_final_10af0e.pkl",
}


def get_checkpoint_url(name: str) -> str:
    """Zoo name -> trained checkpoint URL (the reference README's zoo
    links). KeyError for variants whose weights the reference does not
    publish (WC*, HRNet, CSE)."""
    if name not in _CHECKPOINTS:
        raise KeyError(
            f"no published checkpoint for {name!r}; available: "
            f"{', '.join(sorted(_CHECKPOINTS))}")
    return _CHECKPOINTS[name]


def list_models() -> List[str]:
    return sorted(_ZOO)


def get_config(name: str) -> CfgNode:
    """Zoo name -> frozen config. Raises KeyError with suggestions."""
    if name not in _ZOO:
        raise KeyError(f"unknown model {name!r}; available: {', '.join(list_models())}")
    cfg = get_cfg()
    _base_fpn(cfg)
    deltas = _ZOO[name]
    for key, value in zip(deltas[0::2], deltas[1::2]):
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node[p]
        if isinstance(value, dict):
            node[parts[-1]] = CfgNode(value, new_allowed=True)
        else:
            node[parts[-1]] = value
    cfg.freeze()
    return cfg
