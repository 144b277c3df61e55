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

The `seq`, `expert`, `tensor` and `data` axes are ported: `seq` and
`expert` one at a time, `tensor` and `data` alone or with each other (the
JAX tests' tensor x data meshes). A mesh with `stage` larger than 1, or
one that combines `seq` or `expert` with another axis larger than 1,
raises NotImplementedError naming its ROADMAP item.

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

#: where each unported mesh axis waits (ROADMAP.md, PyTorch/CUDA port)
_UNPORTED_AXES = {"stage": "item 6, pipeline parallelism"}

#: what each ported axis computes (named in the refusals)
_AXIS_KIND = {"tensor": "tensor parallelism", "data": "data parallelism",
              "seq": "sequence parallelism", "expert": "expert parallelism"}

#: where a mesh that combines two ported axes waits
_COMBINED_AXES = "item 6, meshes that combine axes"


class Mesh:
    """Named device grid: `shape` maps each axis of MESH_AXES to its size;
    `devices` is an object array of torch.device in that shape."""

    def __init__(self, devices: np.ndarray, axis_names=MESH_AXES):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))

    def _along(self, axis: str) -> List[torch.device]:
        """The devices along `axis`, every other coordinate 0."""
        idx = tuple(slice(None) if a == axis else 0 for a in self.axis_names)
        return list(self.devices[idx])

    def seq_devices(self) -> List[torch.device]:
        """The devices along the seq axis, shard order."""
        return self._along("seq")

    def expert_devices(self) -> List[torch.device]:
        """The devices along the expert axis, shard order: shard i holds
        experts [i*E/N, (i+1)*E/N)."""
        return self._along("expert")

    def tensor_devices(self, data_index: int = 0) -> List[torch.device]:
        """The devices along the tensor axis of data group `data_index`,
        shard order: shard i holds the i-th slice of every split head,
        hidden and vocab dim."""
        idx = tuple(slice(None) if a == "tensor" else
                    (data_index if a == "data" else 0)
                    for a in self.axis_names)
        return list(self.devices[idx])

    def data_devices(self) -> List[torch.device]:
        """The first device of each data group, group order: group d
        serves rows [d*B/N, (d+1)*B/N) of every batch and slot dim."""
        return self._along("data")

    @property
    def first_device(self) -> torch.device:
        """The device every program that is not sharded runs on."""
        return self.devices.reshape(-1)[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={list(self.devices.reshape(-1))})"


def _refuse_unported_axes(cfg: MeshConfig) -> None:
    for axis, item in _UNPORTED_AXES.items():
        if getattr(cfg, axis) > 1:
            raise NotImplementedError(
                f"a mesh with {axis}={getattr(cfg, axis)} is not ported yet "
                f"(ROADMAP.md, PyTorch/CUDA port queue: {item}); the seq, "
                "expert, tensor and data axes run")
    on = [a for a in ("tensor", "data", "expert", "seq")
          if getattr(cfg, a) > 1]
    # seq and expert combine with nothing; tensor and data with each other
    for a in ("expert", "seq"):
        others = [b for b in on if b != a]
        if a in on and others:
            b = others[0]
            raise NotImplementedError(
                f"a mesh with {a}={getattr(cfg, a)} and "
                f"{b}={getattr(cfg, b)} is not ported yet (ROADMAP.md, "
                f"PyTorch/CUDA port queue: {_COMBINED_AXES} ({a} x {b})); "
                f"{_AXIS_KIND[a]} runs alone, {_AXIS_KIND[b]} "
                + ("alone" if b in ("expert", "seq") else
                   "alone or with the other of tensor and data"))


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


def require_ported_mesh(mesh: Mesh) -> None:
    """Raise NotImplementedError unless the mesh is a seq-only, an
    expert-only, or a tensor x data mesh (every other axis 1)."""
    _refuse_unported_axes(MeshConfig(**{a: mesh.shape.get(a, 1)
                                        for a in MESH_AXES}))


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
