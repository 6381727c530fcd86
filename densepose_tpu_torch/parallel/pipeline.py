"""Streaming video inference: decode-ahead -> device -> overlay -> write (the
port's copy of densepose_tpu/parallel/pipeline.py).

Replaces the reference's strictly serial frame loop (run.py:42-64) with a
pipelined one:

* a reader thread takes frames ahead into a bounded queue and, one frame at a
  time, uploads each through pinned memory (``predictor.stage_input``), so
  decode and upload overlap the device's work on earlier frames;
* the device-to-host copy of one dispatch (``predictor.start_fetch``, only the
  maps the overlay reads: ``visualizer.fetch_keys()``) overlaps the next
  one's compute, and its overlay is drawn one frame behind;
* KeyboardInterrupt stops the loop and keeps what was written, matching
  run.py:58-62.

``stream`` is the loop itself: it reads frames from any iterable and hands
each overlay to a callback. ``run_video`` wraps it between
``cv2.VideoCapture`` and ``cv2.VideoWriter``. The port serves one frame at
a time on one device, so it has no batched mode: the JAX package's groups of
frames pay off only across devices (ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Tuple

import numpy as np


def stream(predictor, visualizer, frames: Iterable[np.ndarray],
           write: Callable[[np.ndarray], None]) -> Tuple[int, float]:
    """Run every frame of ``frames`` through ``predictor`` and
    ``visualizer.visualize`` and pass each overlay, in order, to ``write``.
    Returns the steady-state frame count and its seconds: every frame after
    the first dispatch, whose time holds the warm-up."""
    frame_q: "queue.Queue" = queue.Queue(maxsize=4)
    # the reader thread also uploads each frame
    stage = getattr(predictor, "stage_input", None)

    def reader():
        try:
            for frame in frames:
                frame_q.put((frame, stage(frame) if stage is not None else frame))
        except Exception as e:  # raised again by the consumer
            frame_q.put(e)
            return
        frame_q.put(None)

    def next_item():
        item = frame_q.get()
        if isinstance(item, Exception):
            raise item
        return item

    threading.Thread(target=reader, daemon=True).start()

    # fetch only the maps the overlay consumes (End2EndVisualizer.fetch_keys)
    fetch = getattr(visualizer, "fetch_keys", lambda: None)()
    start_fetch = getattr(predictor, "start_fetch", lambda o, keys=None: None)

    def flush(frame, outputs):
        # views of the fetched buffers: the overlay is drawn now and they go
        write(visualizer.visualize(frame, predictor.numpy_outputs(outputs, keys=fetch,
                                                                  copy=False)))

    t_start = None
    t_frames = 0  # frames counted toward the steady-state figure
    pending = []  # (frame, outputs): drain one behind to overlap the fetch
    try:
        while True:
            item = next_item()
            if item is None:
                break
            frame, staged = item
            if t_start is None:
                flush(frame, predictor(staged))
                t_start = time.perf_counter()
                continue
            outs = predictor(staged)
            start_fetch(outs, keys=fetch)
            pending.append((frame, outs))
            if len(pending) > 1:
                flush(*pending.pop(0))
                t_frames += 1
        while pending:
            flush(*pending.pop(0))
            t_frames += 1
    except KeyboardInterrupt:
        pass
    return t_frames, (time.perf_counter() - t_start if t_start is not None else 0.0)


def run_video(predictor, visualizer, input_path: str, save_path: str) -> None:
    """``input_path`` (any video cv2 decodes) -> ``save_path``, an mp4 of the
    overlays at the input's frame rate."""
    import cv2

    cap = cv2.VideoCapture(input_path)
    n_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    fps = cap.get(cv2.CAP_PROP_FPS) or 30

    def decoded():
        while True:
            ret, frame = cap.read()
            if not ret:
                return
            yield frame

    writer = None
    processed = 0

    def write(image_vis):
        nonlocal writer, processed
        if writer is None:
            writer = cv2.VideoWriter(save_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                     (image_vis.shape[1], image_vis.shape[0]))
        writer.write(image_vis)
        processed += 1
        print(f"Frame {processed}/{n_frames} processed", end="\r")

    try:
        t_frames, seconds = stream(predictor, visualizer, decoded(), write)
    finally:
        cap.release()
        if writer is not None:
            writer.release()
    if writer is None:
        print("No frames processed")
        return
    msg = f"\nVideo saved to {save_path}"
    if t_frames > 0 and seconds > 0:
        msg += f" ({t_frames / seconds:.1f} fps steady-state)"
    print(msg)
