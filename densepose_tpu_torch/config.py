"""Config system: a yacs-compatible YAML config tree (the PyTorch port's own
copy of densepose_tpu/config.py, so the port imports nothing of the JAX
package).

Re-implements the subset of fvcore/yacs ``CfgNode`` semantics the reference
uses (the reference's detectron2/config.py and densepose/config.py):

* ``_BASE_`` file inheritance with recursive merge (config.py:39-84),
* ``merge_from_list`` dotted-key overrides (used by export.py:23-31),
* type coercion str -> tuple/list via literal_eval (yacs behaviour, needed
  because the YAMLs write tuples like ``("a", "b")`` as plain strings),
* freeze/clone,
* the full default key tree for the model components we implement, plus the
  densepose add-ons (densepose/config.py:158-277) so every file under the
  reference's ``configs/`` parses unchanged.

The reference's broken ``compat.guess_version`` import path
(config.py:60-71) is intentionally NOT replicated; all shipped configs are
VERSION 2 and a versionless config is simply accepted as current.
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, List

BASE_KEY = "_BASE_"


class CfgNode(dict):
    """A dict with attribute access, freezing, and recursive merge."""

    IMMUTABLE = "__immutable__"
    NEW_ALLOWED = "__new_allowed__"

    def __init__(self, init_dict: Dict | None = None, new_allowed: bool = False):
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        object.__setattr__(self, CfgNode.NEW_ALLOWED, new_allowed)
        if init_dict:
            for k, v in init_dict.items():
                if isinstance(v, dict) and not isinstance(v, CfgNode):
                    v = CfgNode(v, new_allowed=new_allowed)
                dict.__setitem__(self, k, v)

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config has no key '{name}'")

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"Config is frozen; cannot set '{name}'")
        dict.__setitem__(self, name, value)

    # -- freezing -----------------------------------------------------------
    def freeze(self) -> "CfgNode":
        object.__setattr__(self, CfgNode.IMMUTABLE, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def is_new_allowed(self) -> bool:
        return object.__getattribute__(self, CfgNode.NEW_ALLOWED)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        cls = self.__class__
        result = cls(new_allowed=self.is_new_allowed())
        memo[id(self)] = result
        for k, v in self.items():
            dict.__setitem__(result, k, copy.deepcopy(v, memo))
        return result

    def __reduce__(self):
        # Support pickling (deepcopy of frozen nodes goes through __deepcopy__).
        return (CfgNode, (dict(self), self.is_new_allowed()))

    # -- merging ------------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge_into(other, self, [])

    def merge_from_file(self, filename: str, allow_unsafe: bool = True) -> None:
        loaded = load_yaml_with_base(filename)
        loaded.pop(BASE_KEY, None)
        _merge_into(CfgNode(loaded), self, [])

    def merge_from_list(self, opts: List[str]) -> None:
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node and not node.is_new_allowed():
                raise KeyError(f"Non-existent config key: {key}")
            old = node.get(leaf, None)
            node[leaf] = _coerce_value(_decode_value(value), old, key)

    def dump_dict(self) -> Dict:
        out: Dict = {}
        for k, v in self.items():
            out[k] = v.dump_dict() if isinstance(v, CfgNode) else v
        return out


def _decode_value(v: Any) -> Any:
    """Decode a string override into a python literal when possible."""
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _coerce_value(value: Any, old: Any, full_key: str) -> Any:
    """yacs-style type coercion of ``value`` to the type of ``old``.

    The allowed casts are explicit (mirroring yacs'
    ``_check_and_coerce_cfg_value_type``, plus the numeric widenings the
    reference YAMLs rely on): list<->tuple, int->float, int->bool (0/1),
    and a string containing a literal tuple/list. Anything else is a config
    error and raises — permissive fall-through would silently accept typos.
    """
    if old is None or value is None:
        return value
    if type(value) is type(old):
        return value
    # str containing a literal tuple/list (how YAML sees "(a, b)")
    if isinstance(old, (tuple, list)) and isinstance(value, str):
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
        if type(value) is type(old):
            return value
    if isinstance(old, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(old, list) and isinstance(value, tuple):
        return list(value)
    if isinstance(value, bool):
        raise ValueError(
            f"Type mismatch for config key {full_key}: got bool {value!r}, "
            f"expected {type(old).__name__}")
    if isinstance(old, bool) and isinstance(value, int) and value in (0, 1):
        return bool(value)
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    raise ValueError(
        f"Type mismatch for config key {full_key}: cannot coerce "
        f"{type(value).__name__} {value!r} to {type(old).__name__}")


def _merge_into(src: CfgNode, dst: CfgNode, key_path: List[str]) -> None:
    for k, v in src.items():
        full_key = ".".join(key_path + [k])
        if k not in dst:
            if dst.is_new_allowed():
                dst[k] = copy.deepcopy(v)
                continue
            raise KeyError(f"Non-existent config key: {full_key}")
        old = dst[k]
        if isinstance(v, (dict, CfgNode)) and isinstance(old, CfgNode):
            _merge_into(CfgNode(v) if not isinstance(v, CfgNode) else v, old, key_path + [k])
        else:
            dst[k] = _coerce_value(v, old, full_key)


def load_yaml_with_base(filename: str) -> Dict:
    """Load a YAML file, recursively resolving ``_BASE_`` inheritance.

    Mirrors fvcore's ``CfgNode.load_yaml_with_base`` used by the reference
    (detectron2/config.py:39-84): the base file is loaded first and the child
    is merged on top of it. ``yaml`` is imported here, not at module import:
    the zoo path (model_zoo.get_config) needs no YAML parser.
    """
    import yaml

    with open(filename, "r") as f:
        cfg = yaml.safe_load(f)
    if cfg is None:
        cfg = {}

    if BASE_KEY in cfg:
        base_filename = cfg.pop(BASE_KEY)
        if not os.path.isabs(base_filename):
            base_filename = os.path.join(os.path.dirname(filename), base_filename)
        base_cfg = load_yaml_with_base(base_filename)
        _merge_dicts(cfg, base_cfg)
        return base_cfg
    return cfg


def _merge_dicts(src: Dict, dst: Dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and k in dst and isinstance(dst[k], dict):
            _merge_dicts(v, dst[k])
        else:
            dst[k] = v


# ---------------------------------------------------------------------------
# Default config tree
# ---------------------------------------------------------------------------

def _detectron2_defaults() -> CfgNode:
    """Default keys (subset of detectron2/config.py:96-714 actually consumed
    at inference, plus train-time keys present in the shipped YAMLs so they
    parse)."""
    _C = CfgNode()
    _C.VERSION = 2
    _C.OUTPUT_DIR = "./output"
    _C.SEED = -1
    _C.CUDNN_BENCHMARK = False
    _C.VIS_PERIOD = 0
    _C.GLOBAL = CfgNode()
    _C.GLOBAL.HACK = 1.0

    _C.MODEL = CfgNode()
    _C.MODEL.LOAD_PROPOSALS = False
    _C.MODEL.MASK_ON = False
    _C.MODEL.KEYPOINT_ON = False
    _C.MODEL.DEVICE = "tpu"
    _C.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
    _C.MODEL.WEIGHTS = ""
    # BGR order; detectron2/config.py:116-120
    _C.MODEL.PIXEL_MEAN = [103.530, 116.280, 123.675]
    _C.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]

    _C.INPUT = CfgNode()
    _C.INPUT.MIN_SIZE_TRAIN = (800,)
    _C.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
    _C.INPUT.MAX_SIZE_TRAIN = 1333
    _C.INPUT.MIN_SIZE_TEST = 800
    _C.INPUT.MAX_SIZE_TEST = 1333
    _C.INPUT.RANDOM_FLIP = "horizontal"
    _C.INPUT.CROP = CfgNode({"ENABLED": False, "TYPE": "relative_range", "SIZE": [0.9, 0.9]})
    _C.INPUT.FORMAT = "BGR"
    _C.INPUT.MASK_FORMAT = "polygon"

    _C.DATASETS = CfgNode()
    _C.DATASETS.TRAIN = ()
    _C.DATASETS.PROPOSAL_FILES_TRAIN = ()
    _C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = 2000
    _C.DATASETS.TEST = ()
    _C.DATASETS.PROPOSAL_FILES_TEST = ()
    _C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST = 1000

    _C.DATALOADER = CfgNode()
    _C.DATALOADER.NUM_WORKERS = 4
    _C.DATALOADER.ASPECT_RATIO_GROUPING = True
    _C.DATALOADER.SAMPLER_TRAIN = "TrainingSampler"
    _C.DATALOADER.REPEAT_THRESHOLD = 0.0
    _C.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True

    _C.MODEL.BACKBONE = CfgNode()
    _C.MODEL.BACKBONE.NAME = "build_resnet_backbone"
    _C.MODEL.BACKBONE.FREEZE_AT = 2

    _C.MODEL.FPN = CfgNode()
    _C.MODEL.FPN.IN_FEATURES = []
    _C.MODEL.FPN.OUT_CHANNELS = 256
    _C.MODEL.FPN.NORM = ""
    _C.MODEL.FPN.FUSE_TYPE = "sum"

    _C.MODEL.PROPOSAL_GENERATOR = CfgNode()
    _C.MODEL.PROPOSAL_GENERATOR.NAME = "RPN"
    _C.MODEL.PROPOSAL_GENERATOR.MIN_SIZE = 0

    _C.MODEL.ANCHOR_GENERATOR = CfgNode()
    _C.MODEL.ANCHOR_GENERATOR.NAME = "DefaultAnchorGenerator"
    _C.MODEL.ANCHOR_GENERATOR.SIZES = [[32, 64, 128, 256, 512]]
    _C.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]
    _C.MODEL.ANCHOR_GENERATOR.ANGLES = [[-90, 0, 90]]
    _C.MODEL.ANCHOR_GENERATOR.OFFSET = 0.0

    _C.MODEL.RPN = CfgNode()
    _C.MODEL.RPN.HEAD_NAME = "StandardRPNHead"
    _C.MODEL.RPN.IN_FEATURES = ["res4"]
    _C.MODEL.RPN.BOUNDARY_THRESH = -1
    _C.MODEL.RPN.IOU_THRESHOLDS = [0.3, 0.7]
    _C.MODEL.RPN.IOU_LABELS = [0, -1, 1]
    _C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
    _C.MODEL.RPN.POSITIVE_FRACTION = 0.5
    _C.MODEL.RPN.BBOX_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.RPN.BBOX_REG_LOSS_WEIGHT = 1.0
    _C.MODEL.RPN.BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
    _C.MODEL.RPN.SMOOTH_L1_BETA = 0.0
    _C.MODEL.RPN.LOSS_WEIGHT = 1.0
    _C.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 12000
    _C.MODEL.RPN.PRE_NMS_TOPK_TEST = 6000
    _C.MODEL.RPN.POST_NMS_TOPK_TRAIN = 2000
    _C.MODEL.RPN.POST_NMS_TOPK_TEST = 1000
    _C.MODEL.RPN.NMS_THRESH = 0.7
    _C.MODEL.RPN.CONV_DIMS = [-1]

    _C.MODEL.ROI_HEADS = CfgNode()
    _C.MODEL.ROI_HEADS.NAME = "Res5ROIHeads"
    _C.MODEL.ROI_HEADS.NUM_CLASSES = 80
    _C.MODEL.ROI_HEADS.IN_FEATURES = ["res4"]
    _C.MODEL.ROI_HEADS.IOU_THRESHOLDS = [0.5]
    _C.MODEL.ROI_HEADS.IOU_LABELS = [0, 1]
    _C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
    _C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
    _C.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
    _C.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.5
    _C.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT = True

    _C.MODEL.ROI_BOX_HEAD = CfgNode()
    _C.MODEL.ROI_BOX_HEAD.NAME = ""
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT = 1.0
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
    _C.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA = 0.0
    _C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 14
    _C.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 0
    _C.MODEL.ROI_BOX_HEAD.POOLER_TYPE = "ROIAlignV2"
    _C.MODEL.ROI_BOX_HEAD.NUM_FC = 0
    _C.MODEL.ROI_BOX_HEAD.FC_DIM = 1024
    _C.MODEL.ROI_BOX_HEAD.NUM_CONV = 0
    _C.MODEL.ROI_BOX_HEAD.CONV_DIM = 256
    _C.MODEL.ROI_BOX_HEAD.NORM = ""
    _C.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = False
    _C.MODEL.ROI_BOX_HEAD.TRAIN_ON_PRED_BOXES = False
    _C.MODEL.ROI_BOX_HEAD.USE_FED_LOSS = False
    _C.MODEL.ROI_BOX_HEAD.USE_SIGMOID_CE = False
    _C.MODEL.ROI_BOX_HEAD.FED_LOSS_FREQ_WEIGHT_POWER = 0.5
    _C.MODEL.ROI_BOX_HEAD.FED_LOSS_NUM_CLASSES = 50

    _C.MODEL.ROI_MASK_HEAD = CfgNode()
    _C.MODEL.ROI_MASK_HEAD.NAME = "MaskRCNNConvUpsampleHead"
    _C.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
    _C.MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO = 0
    _C.MODEL.ROI_MASK_HEAD.NUM_CONV = 0
    _C.MODEL.ROI_MASK_HEAD.CONV_DIM = 256
    _C.MODEL.ROI_MASK_HEAD.NORM = ""
    _C.MODEL.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK = False
    _C.MODEL.ROI_MASK_HEAD.POOLER_TYPE = "ROIAlignV2"

    _C.MODEL.ROI_KEYPOINT_HEAD = CfgNode()
    _C.MODEL.ROI_KEYPOINT_HEAD.NAME = "KRCNNConvDeconvUpsampleHead"
    _C.MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION = 14
    _C.MODEL.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO = 0
    _C.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS = tuple(512 for _ in range(8))
    _C.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS = 17
    _C.MODEL.ROI_KEYPOINT_HEAD.MIN_KEYPOINTS_PER_IMAGE = 1
    _C.MODEL.ROI_KEYPOINT_HEAD.NORMALIZE_LOSS_BY_VISIBLE_KEYPOINTS = True
    _C.MODEL.ROI_KEYPOINT_HEAD.LOSS_WEIGHT = 1.0
    _C.MODEL.ROI_KEYPOINT_HEAD.POOLER_TYPE = "ROIAlignV2"

    _C.MODEL.SEM_SEG_HEAD = CfgNode()
    _C.MODEL.SEM_SEG_HEAD.NAME = "SemSegFPNHead"
    _C.MODEL.SEM_SEG_HEAD.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    _C.MODEL.SEM_SEG_HEAD.IGNORE_VALUE = 255
    _C.MODEL.SEM_SEG_HEAD.NUM_CLASSES = 54
    _C.MODEL.SEM_SEG_HEAD.CONVS_DIM = 128
    _C.MODEL.SEM_SEG_HEAD.COMMON_STRIDE = 4
    _C.MODEL.SEM_SEG_HEAD.NORM = "GN"
    _C.MODEL.SEM_SEG_HEAD.LOSS_WEIGHT = 1.0

    _C.MODEL.PANOPTIC_FPN = CfgNode()
    _C.MODEL.PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT = 1.0
    _C.MODEL.PANOPTIC_FPN.COMBINE = CfgNode(
        {"ENABLED": True, "OVERLAP_THRESH": 0.5, "STUFF_AREA_LIMIT": 4096,
         "INSTANCES_CONFIDENCE_THRESH": 0.5})

    _C.MODEL.RETINANET = CfgNode()
    _C.MODEL.RETINANET.NUM_CLASSES = 80
    _C.MODEL.RETINANET.IN_FEATURES = ["p3", "p4", "p5", "p6", "p7"]
    _C.MODEL.RETINANET.NUM_CONVS = 4
    _C.MODEL.RETINANET.IOU_THRESHOLDS = [0.4, 0.5]
    _C.MODEL.RETINANET.IOU_LABELS = [0, -1, 1]
    _C.MODEL.RETINANET.PRIOR_PROB = 0.01
    _C.MODEL.RETINANET.SCORE_THRESH_TEST = 0.05
    _C.MODEL.RETINANET.TOPK_CANDIDATES_TEST = 1000
    _C.MODEL.RETINANET.NMS_THRESH_TEST = 0.5
    _C.MODEL.RETINANET.BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
    _C.MODEL.RETINANET.FOCAL_LOSS_GAMMA = 2.0
    _C.MODEL.RETINANET.FOCAL_LOSS_ALPHA = 0.25
    _C.MODEL.RETINANET.SMOOTH_L1_LOSS_BETA = 0.1
    _C.MODEL.RETINANET.BBOX_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.RETINANET.NORM = ""

    _C.MODEL.RESNETS = CfgNode()
    _C.MODEL.RESNETS.DEPTH = 50
    _C.MODEL.RESNETS.OUT_FEATURES = ["res4"]
    _C.MODEL.RESNETS.NUM_GROUPS = 1
    _C.MODEL.RESNETS.NORM = "FrozenBN"
    _C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
    _C.MODEL.RESNETS.STRIDE_IN_1X1 = True
    _C.MODEL.RESNETS.RES5_DILATION = 1
    _C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
    _C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
    _C.MODEL.RESNETS.DEFORM_ON_PER_STAGE = [False, False, False, False]
    _C.MODEL.RESNETS.DEFORM_MODULATED = False
    _C.MODEL.RESNETS.DEFORM_NUM_GROUPS = 1

    _C.SOLVER = CfgNode()
    _C.SOLVER.LR_SCHEDULER_NAME = "WarmupMultiStepLR"
    _C.SOLVER.MAX_ITER = 40000
    _C.SOLVER.BASE_LR = 0.001
    _C.SOLVER.BASE_LR_END = 0.0
    _C.SOLVER.MOMENTUM = 0.9
    _C.SOLVER.NESTEROV = False
    _C.SOLVER.WEIGHT_DECAY = 0.0001
    _C.SOLVER.WEIGHT_DECAY_NORM = 0.0
    _C.SOLVER.GAMMA = 0.1
    _C.SOLVER.STEPS = (30000,)
    _C.SOLVER.NUM_DECAYS = 3
    _C.SOLVER.WARMUP_FACTOR = 1.0 / 1000
    _C.SOLVER.WARMUP_ITERS = 1000
    _C.SOLVER.WARMUP_METHOD = "linear"
    _C.SOLVER.RESCALE_INTERVAL = False
    _C.SOLVER.CHECKPOINT_PERIOD = 5000
    _C.SOLVER.IMS_PER_BATCH = 16
    _C.SOLVER.REFERENCE_WORLD_SIZE = 0
    _C.SOLVER.BIAS_LR_FACTOR = 1.0
    _C.SOLVER.WEIGHT_DECAY_BIAS = None
    _C.SOLVER.CLIP_GRADIENTS = CfgNode(
        {"ENABLED": False, "CLIP_TYPE": "value", "CLIP_VALUE": 1.0, "NORM_TYPE": 2.0})
    _C.SOLVER.AMP = CfgNode({"ENABLED": False})

    _C.TEST = CfgNode()
    _C.TEST.EXPECTED_RESULTS = []
    _C.TEST.EVAL_PERIOD = 0
    _C.TEST.KEYPOINT_OKS_SIGMAS = []
    _C.TEST.DETECTIONS_PER_IMAGE = 100
    _C.TEST.AUG = CfgNode(
        {"ENABLED": False, "MIN_SIZES": (400, 500, 600, 700, 800, 900, 1000, 1100, 1200),
         "MAX_SIZE": 4000, "FLIP": True})
    _C.TEST.PRECISE_BN = CfgNode({"ENABLED": False, "NUM_ITER": 200})

    # --- TPU-rebuild-only knobs (no reference equivalent) ------------------
    _C.TPU = CfgNode()
    # Max proposals after RPN NMS kept as a static shape (== POST_NMS_TOPK_TEST).
    # Max final detections is TEST.DETECTIONS_PER_IMAGE.
    # Compute dtype policy: "float32" | "bfloat16" | "float16"
    _C.TPU.COMPUTE_DTYPE = "float32"
    # Fold FrozenBN affine transforms into the preceding conv at load time.
    _C.TPU.FOLD_FROZEN_BN = True
    # Two-stage dispatch: run the DensePose stage on a detection-count bucket
    # (8/16/32/64/...) instead of all TEST.DETECTIONS_PER_IMAGE slots. Saves
    # most of the worst-case DensePose FLOPs on sparse frames but costs one
    # device->host sync per frame — a win on locally-attached TPUs, a loss
    # over high-latency device tunnels. Default off (the monolithic graph is
    # already past the throughput target at worst-case shapes).
    _C.TPU.BUCKETED_DENSEPOSE = False
    # Input-GEOMETRY bucketing (0 = off): resize on the host (bit-identical
    # numpy mirror of the in-graph resize) and pad the resized image up to a
    # multiple of this quantum per axis, so one compiled graph per padded
    # bucket serves every input size — a directory of mixed-size photos
    # compiles a handful of graphs instead of one multi-minute compile per
    # distinct (H0, W0). Must be a multiple of the backbone size
    # divisibility (32; HRFPN 64). Detections match the per-shape graph
    # within a tested envelope (the wider zero border is the same padding
    # the reference's own batching applies); pad-region anchors are masked.
    _C.TPU.GEOMETRY_BUCKET_QUANT = 0
    # HRNet: run the 32/64-channel branch convs width-packed to full MXU
    # lane width ((H,W,C)->(H,W/f,fC) is a free NHWC reshape; kernels are
    # prepacked on the host at load). Reassociation-level numerics change
    # only; requires TPU.FOLD_FROZEN_BN (the unfolded exact-parity mode
    # ignores it). No effect on non-HRNet backbones.
    _C.TPU.HRNET_PACKED_BRANCHES = True
    # In-graph detection-count bucketing via lax.switch: XLA:TPU executes
    # only the taken branch, so sparse frames skip most of the per-instance
    # DensePose head FLOPs with no host sync. Identical outputs on the valid
    # prefix. Costs extra compile time (one DensePose stage per bucket).
    _C.TPU.SWITCHED_DENSEPOSE = True
    # Fuse the per-instance DensePose extraction (coarse/fine argmax + UV
    # gather) into the device graph — ~20x less device->host traffic for
    # video streaming. Labels are argmaxed at grid resolution instead of
    # after box-resize (<=1px boundary shift); set False for the reference's
    # exact resize-then-argmax host path.
    _C.TPU.DEVICE_POSTPROCESS = False
    # Run the WC predictors' confidence deconvs and emit the raw maps
    # (pred_densepose_{sigma_2,kappa_u,kappa_v,*_segm_confidence}). The
    # reference loads these weights but never runs them (README:9).
    _C.TPU.EMIT_CONFIDENCES = False
    # int8 quantized serving mode for the DensePose head's stacked convs
    # (per-tensor dynamic activation + per-channel weight scales; ~1.5x
    # faster head on v5e). Post-training quantization — approximate; OFF by
    # default to keep the reference's bf16/fp32 numerics.
    _C.TPU.INT8_HEAD = False
    # int8 serving mode for the ResNet bottleneck stages (R50+) and the 3x3
    # FPN output convs: statically calibrated s8 chains with s32 bias+ReLU,
    # s8 activations between backbone blocks
    # (models/resnet.py::_resnet_int8_stages, models/fpn.py::_fpn_levels).
    # Approximate AND detection-affecting (the box stage consumes int8
    # features), so OFF by default and separate from INT8_HEAD, which keeps
    # detections exact.
    _C.TPU.INT8_BACKBONE = False
    # int8 serving mode for the shared 3x3 RPN head conv (per-level
    # calibrated input scales; FPN backbones only). Same caveats as
    # INT8_BACKBONE.
    _C.TPU.INT8_RPN = False
    # int8 serving mode for the chart predictor's four deconv heads (the
    # largest fp block left after INT8_HEAD: one merged conv_transpose,
    # ~100+ GFLOP/frame at the worst case). Statically calibrated input
    # scale + per-output-channel weight scales, s8 x s8 -> s32, single
    # dequant. Like INT8_HEAD it is post-detection (detections stay exact)
    # but it changes the SIUV logits; chart predictors only. Requires
    # INT8_HEAD's calibration pass, so enable both together.
    _C.TPU.INT8_PREDICTOR = False
    # Path to the external continuous U/V left-right symmetry tables
    # (densepose_UV_symmetry_transforms.mat of the DensePose tooling, or an
    # .npz with dense (24, 256, 256) U_transforms/V_transforms). When set,
    # TTA's flipped views contribute U/V evidence too (tta.py::
    # unflip_chart_uv); empty (default) = flipped views contribute
    # segmentation evidence only. Neither this repo nor the reference ships
    # the data.
    _C.TPU.UV_SYMMETRY_PATH = ""
    return _C


def _add_densepose_config(cfg: CfgNode) -> None:
    """DensePose add-ons; mirrors densepose/config.py:158-277."""
    _C = cfg
    _C.DATASETS.CATEGORY_MAPS = CfgNode(new_allowed=True)
    _C.DATASETS.WHITELISTED_CATEGORIES = CfgNode(new_allowed=True)
    _C.DATASETS.CLASS_TO_MESH_NAME_MAPPING = CfgNode(new_allowed=True)

    _C.DENSEPOSE_EVALUATION = CfgNode()
    _C.DENSEPOSE_EVALUATION.TYPE = "iou"
    _C.DENSEPOSE_EVALUATION.STORAGE = "none"
    _C.DENSEPOSE_EVALUATION.MIN_IOU_THRESHOLD = 0.5
    _C.DENSEPOSE_EVALUATION.DISTRIBUTED_INFERENCE = True
    _C.DENSEPOSE_EVALUATION.EVALUATE_MESH_ALIGNMENT = False
    _C.DENSEPOSE_EVALUATION.MESH_ALIGNMENT_MESH_NAMES = []

    _C.BOOTSTRAP_DATASETS = []
    _C.BOOTSTRAP_MODEL = CfgNode()
    _C.BOOTSTRAP_MODEL.WEIGHTS = ""
    _C.BOOTSTRAP_MODEL.DEVICE = "cuda"

    _C.MODEL.DENSEPOSE_ON = True
    _C.MODEL.ROI_DENSEPOSE_HEAD = CfgNode()
    _C.MODEL.ROI_DENSEPOSE_HEAD.NAME = ""
    _C.MODEL.ROI_DENSEPOSE_HEAD.NUM_STACKED_CONVS = 8
    _C.MODEL.ROI_DENSEPOSE_HEAD.NUM_PATCHES = 24
    _C.MODEL.ROI_DENSEPOSE_HEAD.DECONV_KERNEL = 4
    _C.MODEL.ROI_DENSEPOSE_HEAD.CONV_HEAD_DIM = 512
    _C.MODEL.ROI_DENSEPOSE_HEAD.CONV_HEAD_KERNEL = 3
    _C.MODEL.ROI_DENSEPOSE_HEAD.UP_SCALE = 2
    _C.MODEL.ROI_DENSEPOSE_HEAD.HEATMAP_SIZE = 112
    _C.MODEL.ROI_DENSEPOSE_HEAD.POOLER_TYPE = "ROIAlignV2"
    _C.MODEL.ROI_DENSEPOSE_HEAD.POOLER_RESOLUTION = 28
    _C.MODEL.ROI_DENSEPOSE_HEAD.POOLER_SAMPLING_RATIO = 2
    _C.MODEL.ROI_DENSEPOSE_HEAD.NUM_COARSE_SEGM_CHANNELS = 2
    _C.MODEL.ROI_DENSEPOSE_HEAD.FG_IOU_THRESHOLD = 0.7
    _C.MODEL.ROI_DENSEPOSE_HEAD.INDEX_WEIGHTS = 5.0
    _C.MODEL.ROI_DENSEPOSE_HEAD.PART_WEIGHTS = 1.0
    _C.MODEL.ROI_DENSEPOSE_HEAD.POINT_REGRESSION_WEIGHTS = 0.01
    _C.MODEL.ROI_DENSEPOSE_HEAD.COARSE_SEGM_TRAINED_BY_MASKS = False
    _C.MODEL.ROI_DENSEPOSE_HEAD.DECODER_ON = True
    _C.MODEL.ROI_DENSEPOSE_HEAD.DECODER_NUM_CLASSES = 256
    _C.MODEL.ROI_DENSEPOSE_HEAD.DECODER_CONV_DIMS = 256
    _C.MODEL.ROI_DENSEPOSE_HEAD.DECODER_NORM = ""
    _C.MODEL.ROI_DENSEPOSE_HEAD.DECODER_COMMON_STRIDE = 4
    _C.MODEL.ROI_DENSEPOSE_HEAD.DEEPLAB = CfgNode()
    _C.MODEL.ROI_DENSEPOSE_HEAD.DEEPLAB.NORM = "GN"
    _C.MODEL.ROI_DENSEPOSE_HEAD.DEEPLAB.NONLOCAL_ON = 0
    _C.MODEL.ROI_DENSEPOSE_HEAD.PREDICTOR_NAME = "DensePoseChartWithConfidencePredictor"
    _C.MODEL.ROI_DENSEPOSE_HEAD.LOSS_NAME = "DensePoseChartWithConfidenceLoss"
    _C.MODEL.ROI_DENSEPOSE_HEAD.UV_CONFIDENCE = CfgNode({"ENABLED": False, "EPSILON": 0.01, "TYPE": "iid_iso"})
    _C.MODEL.ROI_DENSEPOSE_HEAD.SEGM_CONFIDENCE = CfgNode({"ENABLED": False, "EPSILON": 0.01})
    _C.INPUT.ROTATION_ANGLES = [0]
    _C.TEST.AUG.ROTATION_ANGLES = ()

    # CSE (densepose/config.py:105-155)
    cse = CfgNode()
    cse.EMBED_SIZE = 16
    cse.EMBEDDERS = CfgNode(new_allowed=True)
    cse.EMBEDDING_DIST_GAUSS_SIGMA = 0.01
    cse.GEODESIC_DIST_GAUSS_SIGMA = 0.01
    cse.EMBED_LOSS_WEIGHT = 0.6
    cse.EMBED_LOSS_NAME = "EmbeddingLoss"
    cse.FEATURES_LR_FACTOR = 1.0
    cse.EMBEDDING_LR_FACTOR = 1.0
    cse.SHAPE_TO_SHAPE_CYCLE_LOSS = CfgNode(
        {"ENABLED": False, "WEIGHT": 0.025, "NORM_P": 2, "TEMPERATURE": 0.05,
         "MAX_NUM_VERTICES": 4936})
    cse.PIX_TO_SHAPE_CYCLE_LOSS = CfgNode(
        {"ENABLED": False, "WEIGHT": 0.0001, "NORM_P": 2,
         "USE_ALL_MESHES_NOT_GT_ONLY": False, "NUM_PIXELS_TO_SAMPLE": 100,
         "PIXEL_SIGMA": 5.0, "TEMPERATURE_PIXEL_TO_VERTEX": 0.05,
         "TEMPERATURE_VERTEX_TO_PIXEL": 0.05})
    _C.MODEL.ROI_DENSEPOSE_HEAD.CSE = cse


def _add_hrnet_config(cfg: CfgNode) -> None:
    """HRNet backbone keys; mirrors densepose/config.py:237-269. Unlike the
    reference (which defines the keys but ships no HRNet implementation —
    SURVEY.md section 2.4), this build implements the backbone."""
    _C = cfg
    _C.MODEL.HRNET = CfgNode()
    _C.MODEL.HRNET.STEM_INPLANES = 64
    for stage, (n_mod, n_br, blocks, chans) in {
        "STAGE2": (1, 2, [4, 4], [32, 64]),
        "STAGE3": (4, 3, [4, 4, 4], [32, 64, 128]),
        "STAGE4": (3, 4, [4, 4, 4, 4], [32, 64, 128, 256]),
    }.items():
        node = CfgNode()
        node.NUM_MODULES = n_mod
        node.NUM_BRANCHES = n_br
        node.BLOCK = "BASIC"
        node.NUM_BLOCKS = blocks
        node.NUM_CHANNELS = chans
        node.FUSE_METHOD = "SUM"
        _C.MODEL.HRNET[stage] = node
    _C.MODEL.HRNET.HRFPN = CfgNode()
    _C.MODEL.HRNET.HRFPN.OUT_CHANNELS = 256


def get_cfg() -> CfgNode:
    """Default config with the densepose add-ons applied (the reference splits
    this into get_cfg() + add_densepose_config(); we always include both since
    this framework only builds DensePose models)."""
    cfg = _detectron2_defaults()
    _add_densepose_config(cfg)
    _add_hrnet_config(cfg)
    return cfg


def load_config(filename: str, opts: List[str] | None = None) -> CfgNode:
    """Convenience: defaults + YAML file + dotted-key overrides, frozen."""
    cfg = get_cfg()
    cfg.merge_from_file(filename)
    if opts:
        cfg.merge_from_list(list(opts))
    cfg.freeze()
    return cfg
