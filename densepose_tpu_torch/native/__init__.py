"""Native (C) host-side overlay pieces, loaded with ctypes (the port's copy of
densepose_tpu/native).

``fastvis.c`` fuses, per detected instance, the bilinear resample of the SIUV
maps to the box, the argmax, the U/V gather and the colormap + alpha blend
into one pass over the box's pixels. It is a byte-for-byte copy of the JAX
package's source, compiled with the same flags, so both packages' overlays
are the same bytes.

The shared object is built with the system C compiler at first use, never at
import, into ``densepose_tpu_torch/_build/``; its name hashes the source, the
flags and the host, so an edited source or another machine rebuilds. When no
compiler is available every entry point returns None / False and the callers
run their numpy versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().with_name("fastvis.c")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CFLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
CFLAGS_PORTABLE = ("-O3", "-shared", "-fPIC")  # compilers without -march=native

_lib = None
_tried = False
_build_lock = threading.Lock()  # extractor threads race the first build

_u8p = ctypes.POINTER(ctypes.c_uint8)
_fp = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_int = ctypes.c_int
_SIGNATURES = {
    "resample_instance": [_fp, _int, _fp, _int, _fp, _fp, _int, _int, _int, _int,
                          _i32p, _fp],
    "resample_instance_chw": [_fp, _int, _fp, _int, _fp, _fp, _int, _int, _int, _int,
                              _int, _i32p, _fp],
    "blend_overlay": [_u8p, _int, _u8p, _u8p, _u8p, _u8p, _int, _int],
    "blend_labels_grid": [_u8p, _int, _u8p, _int, _int, _u8p, _u8p, _int, _int],
    "resample_blend_chw": [_fp, _int, _fp, _int, _int, _int, _u8p, _int, _int, _int,
                           _u8p, _u8p],
    "resample_blend_uv_chw": [_fp, _int, _fp, _int, _fp, _int, _int, _u8p, _int, _int,
                              _int, _u8p, _u8p],
}


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CFLAGS).encode())
    h.update(" ".join(os.uname()).encode())  # -march=native code runs only where built
    return BUILD_DIR / f"fastvis-{h.hexdigest()[:16]}.so"


def _build() -> Optional[ctypes.CDLL]:
    so_path = library_path()
    try:
        if not so_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            cc = os.environ.get("CC", "cc")
            # per-pid tmp name: concurrent processes never write the same file
            tmp = f"{so_path}.{os.getpid()}.tmp"
            try:
                subprocess.run([cc, *CFLAGS, "-o", tmp, str(_SRC), "-lm"],
                               check=True, capture_output=True)
            except subprocess.CalledProcessError:
                subprocess.run([cc, *CFLAGS_PORTABLE, "-o", tmp, str(_SRC), "-lm"],
                               check=True, capture_output=True)
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(str(so_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = argtypes
        return lib
    except (OSError, subprocess.CalledProcessError) as e:  # no compiler: numpy fallback
        logger.info("native fastvis unavailable (%s); using numpy fallback", e)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None when it cannot be built."""
    global _lib, _tried
    if not _tried:
        with _build_lock:
            if not _tried:
                _lib = _build()
                _tried = True
    return _lib


def _f32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _roi_ok(roi: np.ndarray) -> bool:
    """A (h, w, 3) uint8 view with contiguous pixels (any row stride)."""
    return (roi.ndim == 3 and roi.shape[2] == 3 and roi.dtype == np.uint8
            and roi.strides[2] == 1 and roi.strides[1] == 3)


def resample_instance_native(
    coarse: np.ndarray, fine: np.ndarray, u: np.ndarray, v: np.ndarray,
    out_h: int, out_w: int,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """All inputs (H, W, C) float32 for one instance. Returns
    (labels (h, w) int64, uv (2, h, w) float32), or None if the native lib is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    coarse, fine, u, v = _f32(coarse), _f32(fine), _f32(u), _f32(v)
    in_h, in_w, kc = coarse.shape
    labels = np.empty((out_h, out_w), dtype=np.int32)
    uv = np.empty((2, out_h, out_w), dtype=np.float32)
    lib.resample_instance(coarse.ctypes.data_as(_fp), kc, fine.ctypes.data_as(_fp),
                          fine.shape[2], u.ctypes.data_as(_fp), v.ctypes.data_as(_fp),
                          in_h, in_w, out_h, out_w, labels.ctypes.data_as(_i32p),
                          uv.ctypes.data_as(_fp))
    return labels.astype(np.int64), uv


def resample_instance_native_chw(
    coarse: np.ndarray, fine: np.ndarray,
    u: Optional[np.ndarray], v: Optional[np.ndarray],
    out_h: int, out_w: int, need_uv: bool = True,
) -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """CHW edition: all inputs (C, H, W) float32 — the predictor's NCHW
    output sliced per instance, so no transpose/copy is needed. With
    ``need_uv=False`` the U/V gather is skipped and uv comes back None.
    Returns None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    coarse, fine = _f32(coarse), _f32(fine)
    kc, in_h, in_w = coarse.shape
    labels = np.empty((out_h, out_w), dtype=np.int32)
    if need_uv:
        u, v = _f32(u), _f32(v)
        uv = np.empty((2, out_h, out_w), dtype=np.float32)
        u_p, v_p, uv_p = u.ctypes.data_as(_fp), v.ctypes.data_as(_fp), uv.ctypes.data_as(_fp)
    else:
        uv = None
        u_p = v_p = uv_p = None
    lib.resample_instance_chw(coarse.ctypes.data_as(_fp), kc, fine.ctypes.data_as(_fp),
                              fine.shape[0], u_p, v_p, in_h, in_w, out_h, out_w,
                              int(need_uv), labels.ctypes.data_as(_i32p), uv_p)
    return labels.astype(np.int64), uv


def blend_labels_grid_native(roi: np.ndarray, grid: np.ndarray,
                             cmap_bgr: np.ndarray, blend_lut: np.ndarray) -> bool:
    """Fused device-postprocess fine-segm overlay for one instance:
    nearest-resample the (gh, gw) uint8 label grid to the ROI size,
    colormap, and alpha-blend, in place — byte-identical to the unfused
    grid-paste + ``blend_overlay`` chain. ``roi`` is a (h, w, 3) uint8 VIEW
    into the full image. Returns False (caller falls back) when the native
    lib is unavailable or the layout is unsupported."""
    lib = get_lib()
    if lib is None or not _roi_ok(roi) or roi.shape[1] > 4096:
        return False
    grid = np.ascontiguousarray(grid, dtype=np.uint8)
    gh, gw = grid.shape
    lib.blend_labels_grid(roi.ctypes.data_as(_u8p), roi.strides[0], grid.ctypes.data_as(_u8p),
                          gh, gw, cmap_bgr.ctypes.data_as(_u8p), blend_lut.ctypes.data_as(_u8p),
                          roi.shape[0], roi.shape[1])
    return True


def resample_blend_chw_native(coarse: np.ndarray, fine: np.ndarray, roi: np.ndarray,
                              cmap_bgr: np.ndarray, blend_lut: np.ndarray) -> bool:
    """Fused raw-maps fine-segm overlay for one instance: bilinear-resample
    + argmax the (C, H, W) coarse/fine logit planes to the ROI size and
    alpha-blend the colormapped label in place — byte-identical to
    ``resample_instance_chw`` + ``blend_overlay``. Returns False when the
    native lib is unavailable or the ROI layout is unsupported."""
    lib = get_lib()
    if lib is None or not _roi_ok(roi):
        return False
    coarse, fine = _f32(coarse), _f32(fine)
    kc, in_h, in_w = coarse.shape
    lib.resample_blend_chw(coarse.ctypes.data_as(_fp), kc, fine.ctypes.data_as(_fp),
                           fine.shape[0], in_h, in_w, roi.ctypes.data_as(_u8p), roi.strides[0],
                           roi.shape[0], roi.shape[1], cmap_bgr.ctypes.data_as(_u8p),
                           blend_lut.ctypes.data_as(_u8p))
    return True


def resample_blend_uv_chw_native(coarse: np.ndarray, fine: np.ndarray, uv_plane: np.ndarray,
                                 roi: np.ndarray, cmap_bgr: np.ndarray,
                                 blend_lut: np.ndarray) -> bool:
    """Fused raw-maps U/V overlay for one instance: the label argmax of
    ``resample_blend_chw``, then only the requested (kf, H, W) U-or-V plane
    sampled at the winning label, mapped through clip(val*255) truncation,
    and blended in place. Byte-identical to the unfused chain."""
    lib = get_lib()
    if lib is None or not _roi_ok(roi):
        return False
    coarse, fine, uv_plane = _f32(coarse), _f32(fine), _f32(uv_plane)
    kc, in_h, in_w = coarse.shape
    lib.resample_blend_uv_chw(coarse.ctypes.data_as(_fp), kc, fine.ctypes.data_as(_fp),
                              fine.shape[0], uv_plane.ctypes.data_as(_fp), in_h, in_w,
                              roi.ctypes.data_as(_u8p), roi.strides[0], roi.shape[0],
                              roi.shape[1], cmap_bgr.ctypes.data_as(_u8p),
                              blend_lut.ctypes.data_as(_u8p))
    return True


def blend_overlay_native(roi: np.ndarray, matrix: np.ndarray, mask: np.ndarray,
                         cmap_bgr: np.ndarray, blend_lut: np.ndarray) -> bool:
    """In-place colormap + mask + alpha-blend of one box. ``roi`` is a
    (h, w, 3) uint8 VIEW into the full image (any row stride, pixels
    contiguous); matrix/mask are (h, w) uint8; cmap_bgr (256, 3); blend_lut
    (256, 256) with blend_lut[r, v] = blended byte. Returns False (caller
    falls back) when the native lib is unavailable or the view layout is
    unsupported."""
    lib = get_lib()
    if lib is None:
        return False
    h, w = matrix.shape
    if roi.shape != (h, w, 3) or not _roi_ok(roi):
        return False
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    lib.blend_overlay(roi.ctypes.data_as(_u8p), roi.strides[0], matrix.ctypes.data_as(_u8p),
                      mask.ctypes.data_as(_u8p), cmap_bgr.ctypes.data_as(_u8p),
                      blend_lut.ctypes.data_as(_u8p), h, w)
    return True
