"""Data-parallel frames and spatial sharding of one frame over several
devices (port of densepose_tpu/parallel/mesh.py::data_parallel_forward and
``spatial_parallel_forward``).

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

``spatial_parallel_forward`` shards one frame's rows instead: the JAX
package jits ``forward`` with the image's rows sharded over a mesh axis and
the parameters replicated, and GSPMD partitions the resize and every
convolution by rows, writing their halo exchanges. Here one process runs the
preprocess, the backbone and the FPN / HRFPN as row slabs, one a listed
device, with a hand-written halo exchange before every convolution, pool and
upsample that reads a neighbour's rows (``parallel/halo.py``), gathers the
pyramid onto the first device and runs the detection stages and the
monolithic DensePose stage there. A device list is the port's mesh: JAX's
``spatial_parallel_forward`` shards only its ``axis``, so no counterpart of
``make_mesh_2d`` is needed. Its speed across cards has not been measured.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Sequence

import torch

from .halo import Shards, device_key


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


def spatial_parallel_forward(model, devices: Optional[Sequence] = None) -> Callable[
        [torch.Tensor], Dict[str, torch.Tensor]]:
    """A function of one frame (H0, W0, 3) uint8 (numpy, or a tensor on any
    device) that runs ``model`` (a ``GeneralizedRCNN``) with the frame's rows
    sharded over ``devices``, one shard a listed device
    (``GeneralizedRCNN.forward_rows``): the JAX ``forward`` form, all D
    slots and raw maps with no batch dimension, on the first device. The
    padded input's rows are cut into blocks of the size divisibility (32, or
    64 for HRFPN), dealt as evenly as possible; a shard may get none.

    ``devices``: None is every visible card (RuntimeError where there is
    none; the CPU runs only when listed, ``"cpu"``). Each distinct device
    holds one replica of the model as it is now (the model itself where it
    lies): ``cuda:0`` listed four times is four shards on one replica. A
    frame whose rows do not divide by the number of shards raises
    ``ValueError``, as the JAX mesh does. Calibrate an int8 model unsharded
    (through the predictor) first, then make this function; make it again
    after the model's state changes. The returned function's ``shards``
    holds the devices and replicas, ``stats`` the halo and gather copies."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("spatial_parallel_forward: no CUDA device is visible; list the "
                               "devices (\"cpu\" for the CPU)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    from ..models.rcnn import image_tensor  # the models import this package
    shards = Shards(model, devices)

    @torch.inference_mode()
    def forward(image_u8) -> Dict[str, torch.Tensor]:
        image = image_tensor(image_u8, image_u8.device if isinstance(image_u8, torch.Tensor)
                             else "cpu")
        if image.shape[0] % len(shards):
            raise ValueError(f"a frame of {image.shape[0]} rows does not split over "
                             f"{len(shards)} shards")
        return model.forward_rows(image, shards)

    forward.shards = shards
    forward.stats = shards.stats
    return forward


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one ("cuda" is the current card)."""
    return device_key(a) == device_key(b)
