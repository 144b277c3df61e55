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

Every axis is ported, alone and in every combination the JAX package
builds. A shard's devices are found by its coordinates (`along`): the
tensor shards of seq shard i of data group d are
`along("tensor", data=d, seq=i)`. Pipeline stage s runs its layers on
its own mesh, `stage_mesh(s)`: the devices at stage coordinate s, the
stage axis of size 1, every other axis whole (parallel/pipeline.py).
Seq shard i runs its expert dispatch on `seq_mesh(i)`, the devices at
seq coordinate i (parallel/sequence.py), as the JAX seq body, manual
over `seq`, leaves the expert axis automatic inside. Under `stage` the
seq axis is a replica: the pipeline runs at seq coordinate 0, and
seq-parallel generation refuses a stage axis as the JAX engine does.

The engines make their mesh the ACTIVE mesh (`mesh_ctx`, the counterpart
of the JAX package's ambient mesh, core/compat.py:mesh_ctx) around every
forward they dispatch; the expert-parallel FFN (parallel/expert.py) reads
it with `active_mesh()` as the JAX one reads the abstract mesh, so the
layer functions keep their signatures.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from butterfly_tpu_torch.core.config import MESH_AXES, MeshConfig

class Mesh:
    """Named device grid: `shape` maps each axis of MESH_AXES to its size;
    `devices` is an object array of torch.device in that shape."""

    def __init__(self, devices: np.ndarray, axis_names=MESH_AXES):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))

    def along(self, axis: str, **coords: int) -> List[torch.device]:
        """The devices along `axis`, in shard order, at the coordinates
        `coords` of the other axes (0 for an axis not named)."""
        for a in coords:
            if a not in self.axis_names or a == axis:
                raise ValueError(f"no coordinate {a!r} beside axis {axis!r}")
        idx = tuple(slice(None) if a == axis else coords.get(a, 0)
                    for a in self.axis_names)
        return list(self.devices[idx])

    def group_devices(self, data_index: int = 0) -> List[torch.device]:
        """Every device of data group `data_index`, in mesh order."""
        return list(self.devices[data_index].reshape(-1))

    def seq_devices(self, data_index: int = 0,
                    tensor_index: int = 0) -> List[torch.device]:
        """The seq ring of data group `data_index` at tensor shard
        `tensor_index`, shard order."""
        return self.along("seq", data=data_index, tensor=tensor_index)

    def expert_devices(self, data_index: int = 0, tensor_index: int = 0,
                       seq_index: int = 0,
                       stage_index: int = 0) -> List[torch.device]:
        """The expert shards of data group `data_index` at tensor shard
        `tensor_index`, seq shard `seq_index` and stage `stage_index`,
        shard order: shard i holds experts [i*E/N, (i+1)*E/N)."""
        return self.along("expert", data=data_index, tensor=tensor_index,
                          seq=seq_index, stage=stage_index)

    def tensor_devices(self, data_index: int = 0, seq_index: int = 0,
                       expert_index: int = 0) -> List[torch.device]:
        """The tensor shards of data group `data_index` at seq shard
        `seq_index` and expert shard `expert_index`, shard order: shard i
        holds the i-th slice of every split head, hidden and vocab dim."""
        return self.along("tensor", data=data_index, seq=seq_index,
                          expert=expert_index)

    def sub_mesh(self, axis: str, i: int) -> "Mesh":
        """The devices at coordinate i of `axis`, every other axis as it
        is, `axis` of size 1."""
        return Mesh(np.take(self.devices, [i],
                            axis=self.axis_names.index(axis)),
                    self.axis_names)

    def stage_mesh(self, s: int) -> "Mesh":
        """Pipeline stage s's own mesh (the seq and expert axes whole)."""
        return self.sub_mesh("stage", s)

    def seq_mesh(self, i: int) -> "Mesh":
        """Seq shard i's own mesh: where its expert dispatch runs."""
        return self.sub_mesh("seq", i)

    def data_devices(self) -> List[torch.device]:
        """The first device of each data group, group order: group d
        serves rows [d*B/N, (d+1)*B/N) of every batch and slot dim."""
        return self.along("data")

    @property
    def first_device(self) -> torch.device:
        """The device every program that is not sharded runs on."""
        return self.devices.reshape(-1)[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={list(self.devices.reshape(-1))})"


def make_mesh(cfg: MeshConfig,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh over the canonical axes (data, stage, expert, seq,
    tensor); axis sizes of 1 are kept.

    devices: torch.devices (or names) in mesh order; None takes every
    visible card, cuda:0..n-1. Its length must equal cfg.num_devices."""
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


def seq_degree(mesh: Optional[Mesh]) -> int:
    """The mesh's seq size (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape.get("seq", 1)


def expert_degree(mesh: Optional[Mesh]) -> int:
    """The mesh's expert size (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape.get("expert", 1)


def tensor_degree(mesh: Optional[Mesh]) -> int:
    """The mesh's tensor size (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape.get("tensor", 1)


def data_degree(mesh: Optional[Mesh]) -> int:
    """The mesh's data size (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape.get("data", 1)


def stage_degree(mesh: Optional[Mesh]) -> int:
    """The mesh's stage size (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape.get("stage", 1)


def stage_devices(mesh: Mesh) -> List[torch.device]:
    """The first device of each pipeline stage, stage order: where a
    stage's activations arrive and leave."""
    return [mesh.stage_mesh(s).first_device
            for s in range(stage_degree(mesh))]


_ACTIVE: contextvars.ContextVar[Optional[Mesh]] = \
    contextvars.ContextVar("butterfly_active_mesh", default=None)


def active_mesh() -> Optional[Mesh]:
    """The mesh of the innermost `mesh_ctx` in this thread, else None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def mesh_ctx(mesh: Optional[Mesh]):
    """Make `mesh` the active mesh for the block (None = leave the
    active mesh as it is, as the JAX mesh_ctx does)."""
    if mesh is None:
        yield
        return
    token = _ACTIVE.set(mesh)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def under_mesh(method):
    """Decorator for an engine method that dispatches forwards: run it
    with the engine's `self.mesh` active."""
    @functools.wraps(method)
    def wrapped(self, *args, **kw):
        with mesh_ctx(self.mesh):
            return method(self, *args, **kw)
    return wrapped
