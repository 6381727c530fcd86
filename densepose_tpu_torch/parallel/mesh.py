"""Data-parallel frames over several devices (port of
densepose_tpu/parallel/mesh.py::data_parallel_forward).

The scale axis of this workload is frames: a batch of same-shaped frames is
split into equal contiguous shards, one a device, each device holding a
replica of the model; no collective is needed in the forward, so the shards
run independently. The JAX package shards a vmapped forward over a ``data``
mesh axis; here each shard is one ``GeneralizedRCNN.forward_batch`` on its
own device and CUDA stream, dispatched one after another from the host with
no host sync between them, and the outputs come back to the first device in
frame order.

``data_parallel_forward`` takes the device list explicitly: a device listed
twice gets a replica of its own, so two replicas on one card (``cuda:0``
twice) or on the CPU check the sharding where there is a single device. It
is checked for correctness only; its speed across cards has not been
measured, as the JAX package's commit 643a311 says of the TPU mesh.

Spatial sharding of one frame (the JAX package's
``spatial_parallel_forward``) is not ported: its halo exchanges, which GSPMD
wrote for JAX, have to be written by hand here (ROADMAP.md queue 1).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Sequence

import torch


def data_parallel_forward(model, devices: Sequence) -> Callable[[torch.Tensor],
                                                               Dict[str, torch.Tensor]]:
    """A function of frames (B, H, W, 3) uint8 that runs ``B / len(devices)``
    contiguous frames on each device's replica of ``model`` (a
    ``GeneralizedRCNN``; the model itself serves the first device when it
    lies there) and returns ``forward_batch``'s outputs for all B frames, in
    frame order, on the first device. B not a multiple of the device count
    raises ``ValueError``. The replicas are copies of the model as it is now:
    make a new function after the model's state changes (an int8
    calibration)."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("data_parallel_forward needs at least one device")
    home = next(iter(model.parameters())).device
    replicas = []
    for i, d in enumerate(devices):
        if i == 0 and _same_device(home, d):
            replicas.append(model)
        else:
            replicas.append(copy.deepcopy(model).to(d).eval())
    streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in devices]

    @torch.inference_mode()
    def forward(images_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        b = images_u8.shape[0]
        if b % len(devices):
            raise ValueError(f"a batch of {b} frames does not split over {len(devices)} "
                             "devices; pad it to a multiple of the device count")
        per = b // len(devices)
        first = devices[0]
        outs = []
        for i, (d, replica, stream) in enumerate(zip(devices, replicas, streams)):
            shard = images_u8[i * per:(i + 1) * per]
            if stream is None:
                outs.append(replica.forward_batch(shard.to(d)))
                continue
            # the shard's stream starts after the work queued so far on its
            # device (the frames' upload)
            stream.wait_stream(torch.cuda.current_stream(d))
            with torch.cuda.device(d), torch.cuda.stream(stream):
                outs.append(replica.forward_batch(shard.to(d, non_blocking=True)))
        for d, stream, out in zip(devices, streams, outs):
            if stream is not None:
                # each device's current stream takes its shard's outputs over
                # (the copies to the first device and the concatenation)
                here = torch.cuda.current_stream(d)
                here.wait_stream(stream)
                for v in out.values():
                    v.record_stream(here)
        return {k: torch.cat([out[k].to(first, non_blocking=True) for out in outs])
                for k in outs[0]}

    forward.devices = devices
    forward.replicas = replicas
    return forward


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one ("cuda" is the current card)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == \
        (b.index if b.index is not None else current)
