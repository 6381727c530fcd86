"""DensePosePredictor for the PyTorch port (port of densepose_tpu/predictor.py).

``DensePosePredictor(cfg)`` builds the model, loads a detectron2 ``.pkl``
(or random weights from a seed), and serves ``predictor(image_bgr_u8) ->
outputs`` on one CUDA device; ``device="cpu"`` runs the same path on the CPU
with the kernels' plain versions (the tests do). A requested CUDA device that
is absent raises. Outputs are fixed-size slots + ``num_instances``;
``numpy_outputs`` trims them to the valid detections.

fp32 parity: TF32 is turned off for cuDNN convolutions and matmuls, which
otherwise run float32 convolutions at about three decimal digits.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from .checkpoint.pkl_loader import align_state_dicts, load_checkpoint_file
from .checkpoint.transform import fold_state, random_torch_state
from .models.rcnn import GeneralizedRCNN, build_model, image_tensor

logger = logging.getLogger(__name__)


def load_params(cfg, weights_path: Optional[str] = None, seed: int = 0,
                model: Optional[GeneralizedRCNN] = None) -> Dict[str, np.ndarray]:
    """cfg + checkpoint -> the port's module state dict (host numpy).

    The reference load stack: pkl -> (optional Caffe2 rename) -> suffix
    alignment against the model's spec -> FrozenBN folding. Without a
    checkpoint, random weights drawn from ``seed`` (the JAX package's stream:
    the same seed gives the same weights in both packages)."""
    spec = (model or build_model(cfg)).spec()
    if weights_path:
        ckpt, needs_c2 = load_checkpoint_file(weights_path)
        state = align_state_dicts(list(spec), {k: v.shape for k, v in spec.items()},
                                  ckpt, needs_c2)
        logger.info("checkpoint: matched %d/%d params", len(state), len(spec))
    else:
        state = random_torch_state(spec, seed=seed)
    return fold_state(state, spec)


class DensePosePredictor:
    def __init__(self, cfg, weights_path: Optional[str] = None, seed: int = 0,
                 device: str = "cuda", params: Optional[Dict] = None):
        """``params``: a ready module state dict (e.g. from
        ``checkpoint.transform.params_from_jax``) in place of loading."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but none is available; pass "
                               "device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.model = build_model(cfg)
        if params is None:
            params = load_params(cfg, weights_path, seed=seed, model=self.model)
        self.model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in
                                    params.items()})
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def __call__(self, image_bgr_u8: np.ndarray) -> Dict[str, torch.Tensor]:
        """image: (H, W, 3) uint8 BGR (the run.py contract). Returns tensors
        on the device: fixed-size slots + num_instances."""
        return self.model(image_tensor(image_bgr_u8, self.device))

    def predict_numpy(self, image_bgr_u8: np.ndarray) -> Dict[str, np.ndarray]:
        return self.numpy_outputs(self(image_bgr_u8))

    @staticmethod
    def numpy_outputs(outputs: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """Trim padded slots to the valid detections (postprocessing.py:52-61
        key set). DensePose maps are already NCHW; the device postprocess's
        UV map (D, H, W, 2) goes to (n, 2, H, W), as the JAX package's
        ``numpy_outputs`` returns it."""
        out = {k: v.cpu().numpy() for k, v in outputs.items()}
        idx = np.nonzero(out.pop("valid"))[0]
        result = {"image_size": out["image_size"],
                  "num_instances": int(out.pop("num_instances"))}
        for k in ("pred_boxes", "scores", "pred_classes"):
            result[k] = out[k][idx]
        for k, v in out.items():
            if k.startswith("pred_densepose_"):
                sel = v[idx[idx < len(v)]]
                result[k] = sel.transpose(0, 3, 1, 2) if k == "pred_densepose_uv" else sel
        return result
