"""Camera frames made from a seed: a pool of base frames, each use stamped.

A traffic mix gives the batch B, the frame size, the number of base batches
in the pool and the look of a frame (uniform noise under a few smooth
Gaussian blobs, as the program's own latency tool draws them). Batch i
reuses base batch i mod pool and stamps each frame's sequence number
(i * B + j) into a strip of 32 two-pixel bits at its top-left corner, so no
two frames of a run are equal and stamping costs the host a few small
writes. ``batch(i)`` returns the pool's buffer itself, stamped in place: the
caller hands it over before asking for the next.
"""

from __future__ import annotations

import numpy as np

STAMP_ROWS = 4
STAMP_BITS = 32


def base_frames(traffic: dict, seed: int, n: int) -> np.ndarray:
    """(n, H, W, 3) uint8 frames from ``seed``."""
    h, w = traffic["frame_hw"]
    look = traffic["frame"]
    rng = np.random.default_rng([int(seed) % 2 ** 64, 0x66726D])
    out = np.empty((n, h, w, 3), np.uint8)
    ys = np.arange(h, dtype=np.float32)
    xs = np.arange(w, dtype=np.float32)
    for i in range(n):
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8).astype(np.float32)
        img *= look["noise"]
        for _ in range(look["blobs"]):
            cy, cx = rng.random(2) * (h, w)
            sigma = rng.uniform(*look["blob_sigma"])
            colour = rng.uniform(0.5, 1.0, size=3).astype(np.float32) * look["blob_amp"]
            gy = np.exp(-(ys - cy) ** 2 / (2 * sigma ** 2))
            gx = np.exp(-(xs - cx) ** 2 / (2 * sigma ** 2))
            img += np.outer(gy, gx)[..., None] * colour
        np.clip(img, 0, 255, out=img)
        out[i] = img.astype(np.uint8)
    return out


def stamp(frame: np.ndarray, number: int) -> None:
    """Write ``number``'s 32 bits into the frame's top-left strip."""
    bits = (int(number) >> np.arange(STAMP_BITS)) & 1
    strip = np.repeat(bits.astype(np.uint8) * 255, 2)
    frame[:STAMP_ROWS, :2 * STAMP_BITS] = strip[None, :, None]


class FramePool:
    def __init__(self, traffic: dict, seed: int):
        self.b = int(traffic["batch"])
        self.pool = int(traffic["base_batches"])
        frames = base_frames(traffic, seed, self.b * self.pool)
        self.buffers = [frames[i * self.b:(i + 1) * self.b] for i in range(self.pool)]

    def batch(self, index: int) -> np.ndarray:
        """Batch ``index``: (B, H, W, 3) uint8, frames index * B ... + B - 1."""
        buf = self.buffers[index % self.pool]
        for j in range(self.b):
            stamp(buf[j], index * self.b + j)
        return buf
