"""Streaming video inference: decode-ahead -> device -> overlay -> write (the
port's copy of densepose_tpu/parallel/pipeline.py).

Replaces the reference's strictly serial frame loop (run.py:42-64) with a
pipelined one:

* a reader thread takes frames ahead into a bounded queue and, one frame at a
  time, uploads each through pinned memory (``predictor.stage_input``), so
  decode and upload overlap the device's work on earlier frames;
* with ``batch`` > 1 (``run_video``'s default: the number of CUDA devices of a
  CUDA predictor) groups of ``batch`` raw frames are stacked and dispatched
  through ``predictor.predict_batch``, one batched forward (or one shard a
  card, ``parallel/mesh.py``); the tail group is padded with its last frame
  and the padded rows are dropped on the host. A predictor without
  ``predict_batch`` (the TTA wrapper) runs frame by frame;
* the device-to-host copy of one dispatch (``predictor.start_fetch``, only the
  maps the overlay reads: ``visualizer.fetch_keys()``; one copy a key for a
  whole group) overlaps the next one's compute, and its overlays are drawn
  one dispatch behind;
* KeyboardInterrupt stops the loop and keeps what was written, matching
  run.py:58-62.

A batched frame's maps are those of ``predict_batch`` (every detection slot
through the monolithic DensePose stage, raw maps, as in the JAX package);
on the valid detections they equal the frame-by-frame loop's within the
card's batch-size-dependent convolution algorithms.

``stream`` is the loop itself: it reads frames from any iterable and hands
each overlay to a callback. ``run_video`` wraps it between
``cv2.VideoCapture`` and ``cv2.VideoWriter``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Tuple

import numpy as np


def dispatch_batch(predictor, batch: int = 0) -> int:
    """The frames a dispatch of ``stream`` takes: ``batch``, or for 0 the JAX
    package's ``_default_batch`` (the device count of a CUDA predictor, else
    1); always 1 for a predictor without ``predict_batch`` (the TTA wrapper
    runs frame by frame)."""
    if not hasattr(predictor, "predict_batch"):
        return 1
    if batch > 0:
        return batch
    device = getattr(predictor, "device", None)
    if device is None or device.type != "cuda":
        return 1
    import torch
    return max(1, torch.cuda.device_count())


def stream(predictor, visualizer, frames: Iterable[np.ndarray],
           write: Callable[[np.ndarray], None], batch: int = 1) -> Tuple[int, float]:
    """Run every frame of ``frames`` through ``predictor`` and
    ``visualizer.visualize`` and pass each overlay, in order, to ``write``;
    ``batch`` > 1 dispatches groups of that many frames through
    ``predictor.predict_batch`` (0: ``dispatch_batch``'s default). Returns
    the steady-state frame count and its seconds: every frame after the
    first dispatch, whose time holds the warm-up."""
    batch = dispatch_batch(predictor, batch)
    frame_q: "queue.Queue" = queue.Queue(maxsize=4 * batch)
    # frame by frame, the reader thread also uploads each frame; a batch is
    # stacked from raw frames on the host
    stage = getattr(predictor, "stage_input", None) if batch == 1 else None

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

    def flush(group, outputs):
        # views of the fetched buffers: each overlay is drawn now and they go
        if batch == 1:
            hosts = [predictor.numpy_outputs(outputs, keys=fetch, copy=False)]
        else:  # one fetch a key for the group; the padded tail's rows dropped
            hosts = predictor.numpy_outputs_batch(outputs, keys=fetch, count=len(group),
                                                  copy=False)
        for frame, host in zip(group, hosts):
            write(visualizer.visualize(frame, host))

    def dispatch(staged):
        if batch == 1:
            return predictor(staged[0])
        padded = staged + [staged[-1]] * (batch - len(staged))
        return predictor.predict_batch(np.stack(padded))

    t_start = None
    t_frames = 0  # frames counted toward the steady-state figure
    pending = []  # (frames, outputs): drain one dispatch behind to overlap the fetch
    try:
        eof = False
        while not eof:
            group, staged = [], []
            while len(group) < batch:
                item = next_item()
                if item is None:
                    eof = True
                    break
                group.append(item[0])
                staged.append(item[1])
            if not group:
                break
            outs = dispatch(staged)
            if t_start is None:
                flush(group, outs)
                t_start = time.perf_counter()
                continue
            start_fetch(outs, keys=fetch)
            pending.append((group, outs))
            if len(pending) > 1:
                done, outs_done = pending.pop(0)
                flush(done, outs_done)
                t_frames += len(done)
        while pending:
            done, outs_done = pending.pop(0)
            flush(done, outs_done)
            t_frames += len(done)
    except KeyboardInterrupt:
        pass
    return t_frames, (time.perf_counter() - t_start if t_start is not None else 0.0)


def run_video(predictor, visualizer, input_path: str, save_path: str, batch: int = 0) -> None:
    """``input_path`` (any video cv2 decodes) -> ``save_path``, an mp4 of the
    overlays at the input's frame rate; ``batch`` frames a dispatch, as
    ``dispatch_batch`` decides."""
    import cv2

    batch = dispatch_batch(predictor, batch)

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
        t_frames, seconds = stream(predictor, visualizer, decoded(), write, batch)
    finally:
        cap.release()
        if writer is not None:
            writer.release()
    if writer is None:
        print("No frames processed")
        return
    msg = f"\nVideo saved to {save_path}"
    if t_frames > 0 and seconds > 0:
        msg += f" ({t_frames / seconds:.1f} fps steady-state, batch={batch})"
    print(msg)
