"""The device mesh and its sharding rules (counterpart of
sam_road_tpu/parallel/mesh.py).

JAX's mesh is one controller over several devices. Here the same holds for
inference: one process launches each shard's work on that shard's device,
and CUDA's asynchronous launches let the shards overlap. Training runs one
process per rank instead (torch.distributed, training/harness.py), and
shard_batch cuts a global batch into this rank's rows.

A Mesh is an ordered tuple of torch devices under the axis name "dp". Its
devices may repeat: torch has one CPU device, so the CPU tests shard over
["cpu"] * n, and a one-card machine can drive n shards on cuda:0.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses

import numpy as np
import torch

AXIS = "dp"


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: tuple
    axis_names: tuple = (AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_dp: int = 0, devices=None) -> Mesh:
    """1-D "dp" mesh over `devices` (default: every visible CUDA device);
    n_dp > 0 takes the first n_dp of them and raises where fewer exist."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh needs CUDA devices, and torch sees none; "
                               "pass devices= to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if n_dp and n_dp > 0:
        if n_dp > len(devices):
            raise ValueError(f"a mesh of {n_dp} devices was asked for, but only "
                             f"{len(devices)} are available")
        devices = devices[:n_dp]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices))


def on_device(device: torch.device):
    """Context in which kernels launch on `device` (torch.cuda.device for a
    card; nothing for the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def batch_sharding(mesh: Mesh):
    """split(x) -> the leading axis of x cut into mesh.size equal slices,
    slice d on mesh.devices[d]."""

    def split(x):
        x = torch.as_tensor(x)
        if x.shape[0] % mesh.size:
            raise ValueError(f"leading axis {x.shape[0]} does not divide over "
                             f"{mesh.size} devices")
        return [c.to(d) for c, d in zip(x.chunk(mesh.size), mesh.devices)]

    return split


def replicated_sharding(mesh: Mesh):
    """copy(x) -> x on every device of the mesh (one copy per distinct
    device; a repeated device shares it)."""

    def copy(x):
        x = torch.as_tensor(x)
        copies = {d: x.to(d) for d in dict.fromkeys(mesh.devices)}
        return [copies[d] for d in mesh.devices]

    return copy


def shard_batch(batch: dict, process_index: int, process_count: int) -> dict:
    """This rank's rows of a global batch: rows [i * b, (i + 1) * b) of
    every array, b = global rows / process_count (the rows a rank's loader
    would produce, cli/train.py)."""
    out = {}
    for key, val in batch.items():
        val = np.asarray(val)
        rows, rem = divmod(val.shape[0], process_count)
        if rem:
            raise ValueError(f"batch of {val.shape[0]} rows does not divide across "
                             f"{process_count} processes")
        out[key] = val[process_index * rows:(process_index + 1) * rows]
    return out


def replicate(module: torch.nn.Module, mesh: Mesh) -> list:
    """`module` on every device of the mesh, in mesh order: the module
    itself where it already lives, one copy per other distinct device."""
    copies = {next(module.parameters()).device: module}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = copy.deepcopy(module).to(d)
    return [copies[d] for d in mesh.devices]
