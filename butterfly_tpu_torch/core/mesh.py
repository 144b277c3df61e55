"""Device mesh, single-controller.

The counterpart of butterfly_tpu/core/mesh.py (make_mesh, local_mesh,
mesh_for). As in the JAX package, ONE Python process drives every device
of the mesh: a mesh maps coordinates over the canonical axes
(data, stage, expert, seq, tensor) to `torch.device`s, and the
seq-parallel code runs each shard's work in shard order on its shard's
device (parallel/sequence.py), moving tensors between shards with
`.to(device, non_blocking=True)`, a no-op when both shards share a card.

A mesh built with an explicit device list may name one device more than
once — the counterpart of the JAX tests' fake CPU devices: the CPU tests
run seq=4 on `cpu`, and one card runs seq=2 with both shards on cuda:0.
Nothing places shards implicitly: with no list, the mesh takes the
visible cards cuda:0..n-1 and their count must match.

Only the `seq` axis is ported. A mesh with another axis larger than 1
(tensor, data, stage, expert) raises NotImplementedError naming its
ROADMAP item.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from butterfly_tpu_torch.core.config import MESH_AXES, MeshConfig

#: where each unported mesh axis waits (ROADMAP.md, PyTorch/CUDA port)
_UNPORTED_AXES = {
    "tensor": "tensor parallelism",
    "data": "data parallelism",
    "stage": "pipeline parallelism",
    "expert": "Mixtral / expert parallelism",
}


class Mesh:
    """Named device grid: `shape` maps each axis of MESH_AXES to its size;
    `devices` is an object array of torch.device in that shape."""

    def __init__(self, devices: np.ndarray, axis_names=MESH_AXES):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))

    def seq_devices(self) -> List[torch.device]:
        """The devices along the seq axis (every other axis is 1), shard
        order."""
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.seq_devices()})"


def _refuse_unported_axes(cfg: MeshConfig) -> None:
    for axis, item in _UNPORTED_AXES.items():
        if getattr(cfg, axis) > 1:
            raise NotImplementedError(
                f"a mesh with {axis}={getattr(cfg, axis)} is not ported yet "
                f"(ROADMAP.md, PyTorch/CUDA port queue: {item}); only the "
                "seq axis runs")


def make_mesh(cfg: MeshConfig,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh over the canonical axes (data, stage, expert, seq,
    tensor); axis sizes of 1 are kept.

    devices: torch.devices (or names) in mesh order; None takes every
    visible card, cuda:0..n-1. Its length must equal cfg.num_devices."""
    _refuse_unported_axes(cfg)
    if devices is None:
        devices = [torch.device(f"cuda:{i}")
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    for d in devs:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but torch.cuda.is_available() is False; "
                "build the mesh over cpu devices to run on the CPU")
    n = len(devs)
    if cfg.num_devices != n:
        raise ValueError(
            f"MeshConfig wants {cfg.num_devices} devices "
            f"({dict(zip(MESH_AXES, cfg.axis_sizes))}) but {n} are available")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(cfg.axis_sizes), MESH_AXES)


def local_mesh(device=None) -> Mesh:
    """Single-device mesh (all axes size 1) on `device` (None = cuda:0)."""
    return make_mesh(MeshConfig(),
                     devices=[device if device is not None else "cuda:0"])


def mesh_for(n_devices: int, tensor: int = 0, stage: int = 1,
             expert: int = 1, seq: int = 1, devices=None) -> Mesh:
    """Convenience: fill `tensor` (or `data`) to consume n_devices, over
    the first n_devices of `devices` (None = the visible cards)."""
    if tensor == 0:
        tensor = n_devices // (stage * expert * seq)
    data = n_devices // (stage * expert * seq * tensor)
    cfg = MeshConfig(data=data, stage=stage, expert=expert, seq=seq,
                     tensor=tensor)
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return make_mesh(cfg, devices=list(devices)[:n_devices])


def require_seq_mesh(mesh: Mesh) -> None:
    """Raise NotImplementedError unless every axis but `seq` is 1."""
    sizes = {a: mesh.shape.get(a, 1) for a in _UNPORTED_AXES}
    _refuse_unported_axes(MeshConfig(**sizes))


def seq_degree(mesh: Optional[Mesh]) -> int:
    """The mesh's seq size (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape.get("seq", 1)
