"""Continuous Surface Embeddings (port of densepose_tpu/models/cse.py), NCHW.

The reference ships the CSE embedders (densepose/modeling/cse/) but never
registers the ``DensePoseEmbeddingPredictor`` its configs ask for; the JAX
package supplies the inference path, and this module ports it:

* ``DensePoseEmbeddingPredictor``: two ConvTranspose2d heads, the embedding
  (D = CSE.EMBED_SIZE channels) and the coarse segmentation, each with the
  chart predictor's 2x bilinear upsample (predictors/chart.py:45-90);
* ``Embedder``: one sub-embedder per mesh of CSE.EMBEDDERS, a
  ``vertex_direct`` (N x D table) or ``vertex_feature`` (N x K features, K x
  D projection) embedder, under ``roi_heads.embedder.embedder_<mesh>.*`` so
  the zoo's CSE checkpoints align. The tables are parameters: the predictor
  rounds them to the compute dtype with every other float32 parameter, as
  the JAX package does (``_cast_param``);
* ``vertex_embeddings`` (L2-normalized in fp32, cse/utils.py:25-36) and
  ``closest_vertices``, the nearest-vertex lookup (cse/utils.py:38-81): the
  JAX package's argmin over -2 p.v + |v|^2 (no |p|^2, which is the same for
  every vertex of a pixel), in fp32, over chunks of pixel rows.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ..checkpoint.spec import ParamSpec, Spec, conv_transpose_spec
from ..ops.resize import resize_bilinear

# pixel rows a closest_vertices chunk takes: its (rows, N) fp32 score block
# holds about LOOKUP_CHUNK_ELEMENTS values (256 MiB); a whole-frame box
# (~3e5 pixels) against the 27554 SMPL vertices would take 34 GB at once
LOOKUP_CHUNK_ELEMENTS = 1 << 26


def embedding_predictor_spec(cfg, prefix: str = "roi_heads.densepose_predictor") -> Spec:
    h = cfg.MODEL.ROI_DENSEPOSE_HEAD
    spec: Spec = {}
    conv_transpose_spec(spec, f"{prefix}.coarse_segm_lowres", h.CONV_HEAD_DIM,
                        h.NUM_COARSE_SEGM_CHANNELS, h.DECONV_KERNEL)
    conv_transpose_spec(spec, f"{prefix}.embed_lowres", h.CONV_HEAD_DIM, h.CSE.EMBED_SIZE,
                        h.DECONV_KERNEL)
    return spec


def _embedders(cfg):
    """(mesh name, type, vertices, feature dim) of each CSE.EMBEDDERS entry
    (cse/embedder.py:66-100)."""
    out = []
    for mesh, es in cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.EMBEDDERS.items():
        if es["TYPE"] not in ("vertex_direct", "vertex_feature"):
            raise ValueError(f"unknown embedder type {es['TYPE']!r} for mesh {mesh}")
        out.append((mesh, es["TYPE"], es["NUM_VERTICES"], es.get("FEATURE_DIM")))
    return out


def embedder_spec(cfg, prefix: str = "roi_heads.embedder") -> Spec:
    d = cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.EMBED_SIZE
    spec: Spec = {}
    for mesh, kind, n, k in _embedders(cfg):
        base = f"{prefix}.embedder_{mesh}"
        if kind == "vertex_direct":
            spec[f"{base}.embeddings"] = ParamSpec((n, d), "vec")
        else:
            spec[f"{base}.features"] = ParamSpec((n, k), "vec")
            spec[f"{base}.embeddings"] = ParamSpec((k, d), "vec")
    return spec


class DensePoseEmbeddingPredictor(nn.Module):
    """(B, CONV_HEAD_DIM, h, w) -> {"embedding": (B, D, H, W), "coarse_segm":
    (B, K, H, W)}, H = 2 h UP_SCALE (JAX cse.py::embedding_predictor_forward)."""

    def __init__(self, cfg):
        super().__init__()
        h = cfg.MODEL.ROI_DENSEPOSE_HEAD
        k = h.DECONV_KERNEL
        self.up = float(h.UP_SCALE)
        for name, cout in (("coarse_segm_lowres", h.NUM_COARSE_SEGM_CHANNELS),
                           ("embed_lowres", h.CSE.EMBED_SIZE)):
            self.add_module(name, nn.ConvTranspose2d(h.CONV_HEAD_DIM, cout, k, stride=2,
                                                     padding=int(k / 2 - 1)))

    def head(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = getattr(self, name)(x)
        out_hw = (int(y.shape[-2] * self.up), int(y.shape[-1] * self.up))
        return resize_bilinear(y, out_hw, scale=(self.up, self.up))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"embedding": self.head("embed_lowres", x),
                "coarse_segm": self.head("coarse_segm_lowres", x)}


class Embedder(nn.Module):
    """The vertex tables of every mesh: ``embedder_<mesh>.embeddings`` and, for
    a ``vertex_feature`` embedder, ``embedder_<mesh>.features``."""

    def __init__(self, cfg):
        super().__init__()
        d = cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.EMBED_SIZE
        for mesh, kind, n, k in _embedders(cfg):
            m = nn.Module()
            if kind == "vertex_direct":
                m.embeddings = nn.Parameter(torch.zeros(n, d), requires_grad=False)
            else:
                m.features = nn.Parameter(torch.zeros(n, k), requires_grad=False)
                m.embeddings = nn.Parameter(torch.zeros(k, d), requires_grad=False)
            self.add_module(f"embedder_{mesh}", m)


def normalize_embeddings(e: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    """Rows L2-normalized (cse/utils.py:25-36)."""
    return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True).clamp_min(epsilon)


def vertex_embeddings(embedder: Embedder, mesh: str) -> torch.Tensor:
    """A mesh's normalized (N, D) vertex embeddings in fp32, on the tables'
    device: ``features @ embeddings`` for a ``vertex_feature`` embedder, the
    table itself for a ``vertex_direct`` one. Tables held at a half compute
    dtype are widened first, so the product and the norm run in fp32 (JAX
    cse.py:91-101)."""
    m = getattr(embedder, f"embedder_{mesh}")
    e = m.embeddings.float()
    if hasattr(m, "features"):
        e = m.features.float() @ e
    return normalize_embeddings(e)


def closest_vertices(pixel_embeddings: torch.Tensor, mesh_embeddings: torch.Tensor,
                     chunk_elements: int = LOOKUP_CHUNK_ELEMENTS) -> torch.Tensor:
    """(P, D) pixel embeddings, (N, D) mesh embeddings -> (P,) int64 index of
    each pixel's nearest vertex: the JAX package's argmin over -2 p.v + |v|^2
    in fp32 (ties to the lower index), not torch.cdist, so both packages
    decide alike. Rows go ``chunk_elements // N`` at a time, which bounds the
    score block; each row's scores are its own dot products whatever the
    chunk. TF32 must be off for fp32 products on the card (the predictor
    turns it off)."""
    me = mesh_embeddings.float()
    pe = pixel_embeddings.to(me.device, torch.float32)
    sq = (me * me).sum(dim=1)
    rows = max(1, chunk_elements // me.shape[0])
    out = torch.empty(pe.shape[0], dtype=torch.int64, device=me.device)
    for s in range(0, pe.shape[0], rows):
        scores = pe[s:s + rows] @ me.T
        out[s:s + rows] = scores.mul_(-2.0).add_(sq).argmin(dim=1)
    return out
