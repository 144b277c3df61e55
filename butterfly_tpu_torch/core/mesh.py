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

Several processes (the JAX package's multi-host control plane): each
process calls `init_distributed` (a torch.distributed rendezvous, gloo),
then builds its mesh over `global_devices()`, every process's devices in
process order, with `make_hybrid_mesh`. Such a mesh keeps, beside its
torch.device array, the process index of every device (`processes`),
and every process runs the same program on its own devices (SPMD, as
the JAX processes do): it places only its own shards, and the moves
between shards of different processes are collectives
(parallel/tensor.py). One axis of tensor, stage, expert and seq may
cross the processes, with a data axis inside them or none
(`check_process_mesh` refuses every other mesh over several): the tensor
axis's reductions and gathers, the stage axis's activation hand-offs
(parallel/pipeline.py), the expert axis's all-to-all
(parallel/expert.py) and the seq axis's ring pass, all-to-alls and
merges (parallel/sequence.py) are then collectives over the job, every
process running every data group in group order; `owner` names the
process of a stage, an expert shard or a seq shard. Where data lies
inside, each data group holds devices of every process
(`local_group_devices`, `data_devices`: this process's own).
"""
from __future__ import annotations

import atexit
import contextlib
import contextvars
import functools
import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from butterfly_tpu_torch.core.config import MESH_AXES, MeshConfig

class Mesh:
    """Named device grid: `shape` maps each axis of MESH_AXES to its size;
    `devices` is an object array of torch.device in that shape, each
    named as its own process names it; `processes` the process index of
    each (None = every device this process's); `ids` the global device
    ids where the mesh was built over `global_devices()`, else None."""

    def __init__(self, devices: np.ndarray, axis_names=MESH_AXES,
                 processes: Optional[np.ndarray] = None,
                 ids: Optional[np.ndarray] = None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))
        self.processes = (np.full(devices.shape, process_index())
                          if processes is None else processes)
        self.ids = ids

    @property
    def spans_processes(self) -> bool:
        """Whether the mesh's devices belong to more than one process."""
        return len(np.unique(self.processes)) > 1

    @property
    def local_devices(self) -> List[torch.device]:
        """This process's devices, mesh order (JAX Mesh.local_devices)."""
        me = process_index()
        return [d for d, p in zip(self.devices.reshape(-1),
                                  self.processes.reshape(-1)) if p == me]

    def local_range(self, axis: str, **coords: int) -> Tuple[int, int]:
        """[lo, hi): the shard indices along `axis`, at the coordinates
        `coords` of the other axes, whose devices are this process's
        (the whole axis on a mesh of one process). check_process_mesh
        makes them one run."""
        for a in coords:
            if a not in self.axis_names or a == axis:
                raise ValueError(f"no coordinate {a!r} beside axis {axis!r}")
        idx = tuple(slice(None) if a == axis else coords.get(a, 0)
                    for a in self.axis_names)
        mine = np.flatnonzero(self.processes[idx] == process_index())
        if len(mine) == 0:
            return 0, 0
        return int(mine[0]), int(mine[-1]) + 1

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

    def local_group_devices(self, data_index: int = 0
                            ) -> List[torch.device]:
        """This process's devices of data group `data_index`, mesh order
        (every device of the group on a mesh of one process). On a mesh
        whose data axis lies inside the processes each process holds
        some of every group's devices."""
        return self.sub_mesh("data", data_index).local_devices

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
        dim = self.axis_names.index(axis)
        return Mesh(np.take(self.devices, [i], axis=dim), self.axis_names,
                    np.take(self.processes, [i], axis=dim),
                    None if self.ids is None
                    else np.take(self.ids, [i], axis=dim))

    def stage_mesh(self, s: int) -> "Mesh":
        """Pipeline stage s's own mesh (the seq and expert axes whole)."""
        return self.sub_mesh("stage", s)

    def seq_mesh(self, i: int) -> "Mesh":
        """Seq shard i's own mesh: where its expert dispatch runs."""
        return self.sub_mesh("seq", i)

    def data_devices(self) -> List[torch.device]:
        """The first of this process's devices of each data group, group
        order: group d serves rows [d*B/N, (d+1)*B/N) of every batch and
        slot dim (on a mesh of one process, each group's first device)."""
        out = []
        for d in range(self.shape["data"]):
            local = self.local_group_devices(d)
            if not local:
                raise ValueError(f"data group {d} of {self!r} holds no "
                                 f"device of process {process_index()}")
            out.append(local[0])
        return out

    @property
    def first_device(self) -> torch.device:
        """The device every program that is not sharded runs on: the
        first of this process's devices (each process of a mesh over
        several runs those programs on its own)."""
        local = self.local_devices
        if not local:
            raise ValueError(f"{self!r} holds no device of process "
                             f"{process_index()}")
        return local[0]

    def __repr__(self) -> str:
        devs = list(self.devices.reshape(-1))
        if self.spans_processes:
            devs = [f"{d}@process{p}" for d, p in
                    zip(devs, self.processes.reshape(-1))]
        return f"Mesh({self.shape}, devices={devs})"


def make_mesh(cfg: MeshConfig,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh over the canonical axes (data, stage, expert, seq,
    tensor); axis sizes of 1 are kept.

    devices: torch.devices (or names) in mesh order, or GlobalDevices
    (`global_devices()`: a mesh over several processes); None takes every
    visible card, cuda:0..n-1. Its length must equal cfg.num_devices."""
    if devices is None:
        devices = [torch.device(f"cuda:{i}")
                   for i in range(torch.cuda.device_count())]
    n = len(devices)
    if cfg.num_devices != n:
        raise ValueError(
            f"MeshConfig wants {cfg.num_devices} devices "
            f"({dict(zip(MESH_AXES, cfg.axis_sizes))}) but {n} are available")
    return _mesh_of(_object_array(devices).reshape(cfg.axis_sizes))


def _object_array(items: Sequence) -> np.ndarray:
    arr = np.empty(len(items), dtype=object)
    arr[:] = list(items)
    return arr


def _mesh_of(arr: np.ndarray) -> Mesh:
    """A Mesh over an object array of torch.devices (or names), or of
    GlobalDevices; a local CUDA device without a card raises."""
    flat = list(arr.reshape(-1))
    me = process_index()
    if flat and isinstance(flat[0], GlobalDevice):
        devs = [d.device for d in flat]
        procs = np.asarray([d.process_index for d in flat]).reshape(arr.shape)
        ids = np.asarray([d.id for d in flat]).reshape(arr.shape)
    else:
        devs = [torch.device(d) for d in flat]
        procs, ids = np.full(arr.shape, me), None
    for d, p in zip(devs, procs.reshape(-1)):
        if p == me and d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but torch.cuda.is_available() is False; "
                "build the mesh over cpu devices to run on the CPU")
    return Mesh(_object_array(devs).reshape(arr.shape), MESH_AXES, procs,
                ids)


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


# ---------------------------------------------------------------------------
# Several processes (butterfly_tpu/core/mesh.py: init_distributed,
# slice_groups, make_hybrid_mesh)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GlobalDevice:
    """One device of the job, as every process sees it: the counterpart
    of a jax.Device after jax.distributed.initialize. `device` is its name
    inside its own process; `slice_index` its host (on the card, a host
    is the NVLink island, the counterpart of a TPU slice)."""
    id: int
    device: torch.device
    process_index: int
    slice_index: int


def _dist():
    dist = torch.distributed
    return dist if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    """This process's index in the job (0 without torch.distributed)."""
    dist = _dist()
    return 0 if dist is None else dist.get_rank()


def process_count() -> int:
    """How many processes the job has (1 without torch.distributed)."""
    dist = _dist()
    return 1 if dist is None else dist.get_world_size()


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout_s: Optional[float] = None) -> None:
    """Multi-host control-plane bringup: every process calls this before
    it builds a mesh. A no-op when single-process.

    num_processes defaults to BUTTERFLY_NUM_PROCESSES (as in the JAX
    package); the coordinator ("host:port") to torchrun's MASTER_ADDR and
    MASTER_PORT, the process id to RANK. The rendezvous is
    torch.distributed's TCP store at the coordinator, the backend gloo on
    the CPU and on the card alike (NCCL refuses two ranks on one card).
    `timeout_s` bounds every collective (None = torch's default), so a
    desynchronised job fails instead of hanging."""
    if num_processes is None:
        num_processes = int(os.environ.get("BUTTERFLY_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    if _dist() is not None:
        raise RuntimeError("distributed.initialize should only be called "
                           "once.")
    if coordinator is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if not addr or not port:
            raise ValueError("coordinator_address should be defined.")
        coordinator = f"{addr}:{port}"
    if process_id is None:
        if "RANK" not in os.environ:
            raise ValueError("The process id of the current process must be "
                             "defined.")
        process_id = int(os.environ["RANK"])
    if not 0 <= process_id < num_processes:
        raise ValueError("process_id and num_processes must be nonnegative, "
                         "with process_id < num_processes. Got process_id="
                         f"{process_id}, num_processes={num_processes}.")
    kw = {} if timeout_s is None else {"timeout": timedelta(
        seconds=timeout_s)}
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id, **kw)
    # a gloo group left for the interpreter's teardown aborts the process
    atexit.register(_shutdown)


def _shutdown() -> None:
    if _dist() is not None:
        torch.distributed.destroy_process_group()


def _local_devices(device: str, per_process: int = 1
                   ) -> List[torch.device]:
    """This process's devices of `device`'s type: `per_process` CPU
    devices (one CPU, named as often as the mesh wants shards of it), or
    its visible cards (none without a card: a mesh over them then
    reports too few devices)."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * per_process
    return [torch.device(f"cuda:{i}")
            for i in range(torch.cuda.device_count())]


def global_devices(device: str = "cuda", per_process: int = 1
                   ) -> List[GlobalDevice]:
    """Every process's devices in process order, ids counted through
    them (jax.devices() after initialize): each process's visible cards,
    or `per_process` CPU devices a process with device="cpu" (one, as
    each JAX CPU process has one; two, as a JAX process run with
    --xla_force_host_platform_device_count=2). A collective the first
    time for each device type and count when the job has several
    processes: every process calls it at the same point."""
    key = (torch.device(device).type, per_process, process_count(),
           process_index())
    if key not in _GLOBAL:
        _GLOBAL[key] = _gather_devices(device, per_process)
    return list(_GLOBAL[key])


_GLOBAL: Dict[tuple, List[GlobalDevice]] = {}


def _gather_devices(device: str, per_process: int) -> List[GlobalDevice]:
    me = (socket.gethostname(), _local_devices(device, per_process))
    everyone = [me]
    dist = _dist()
    if dist is not None:
        everyone = [None] * dist.get_world_size()
        dist.all_gather_object(everyone, me)
    hosts: List[str] = []
    out: List[GlobalDevice] = []
    for p, (host, devs) in enumerate(everyone):
        if host not in hosts:
            hosts.append(host)
        out += [GlobalDevice(len(out), d, p, hosts.index(host))
                for d in devs]
    return out


def slice_groups(devices: Sequence) -> dict:
    """Group devices by slice (host). Devices without a slice_index (a
    plain torch.device) all land in slice 0."""
    groups: dict = {}
    for d in devices:
        groups.setdefault(getattr(d, "slice_index", 0), []).append(d)
    return groups


def make_hybrid_mesh(cfg: MeshConfig, devices: Optional[Sequence] = None,
                     dcn_axes: Sequence[str] = ("data",)) -> Mesh:
    """Mesh for jobs over several slices (hosts): `dcn_axes` span slices,
    every other axis stays inside one slice, so the collectives that run
    every layer ride the links inside a host. One slice (every process on
    one host, or plain devices) falls back to the plain mesh, so callers
    can use this unconditionally. Otherwise the arrangement of
    jax.experimental.mesh_utils.create_hybrid_device_mesh: along each
    axis the slice's (dcn) index outer and the index inside the slice
    inner, each slice's block in make_mesh order. devices: None =
    global_devices()."""
    if devices is None:
        devices = global_devices()
    groups = slice_groups(devices)
    if len(groups) == 1:
        return make_mesh(cfg, devices)

    sizes = dict(zip(MESH_AXES, cfg.axis_sizes))
    bad = [a for a in dcn_axes if a not in MESH_AXES]
    if bad:
        raise ValueError(f"unknown mesh axes {bad}")
    dcn_shape = [sizes[a] if a in dcn_axes else 1 for a in MESH_AXES]
    ici_shape = [1 if a in dcn_axes else sizes[a] for a in MESH_AXES]
    n_dcn = int(np.prod(dcn_shape))
    per_slice = int(np.prod(ici_shape))
    if n_dcn != len(groups):
        raise ValueError(
            f"dcn axes {tuple(dcn_axes)} have total size {n_dcn} but the "
            f"job spans {len(groups)} slices")
    if any(len(g) != per_slice for g in groups.values()):
        raise ValueError(
            f"each slice must contribute {per_slice} devices "
            f"(got {[len(g) for g in groups.values()]})")
    blocks = np.stack([_object_array(groups[k]).reshape(ici_shape)
                       for k in sorted(groups)]).reshape(dcn_shape
                                                         + ici_shape)
    k = len(MESH_AXES)
    inter = [j for a in range(k) for j in (a, k + a)]   # (dcn_a, ici_a)
    arr = blocks.transpose(inter).reshape(
        [d * i for d, i in zip(dcn_shape, ici_shape)])
    return _mesh_of(arr)


# where the meshes over several processes still refused wait for their
# port (ROADMAP.md, PyTorch/CUDA port Queue 1)
_TWO_AXES_ITEM = "ROADMAP.md Queue 1: two axes across processes at once"


def axes_across_processes(mesh: Mesh) -> List[str]:
    """The axes along which the process index changes."""
    return [a for i, a in enumerate(mesh.axis_names)
            if mesh.shape[a] > 1
            and (np.diff(mesh.processes, axis=i) != 0).any()]


def check_process_mesh(mesh: Optional[Mesh]) -> None:
    """Refuse what a mesh over several processes cannot run yet (a mesh
    of one process passes). One axis of tensor, stage, expert and seq
    may cross the processes, beside it at most a data axis inside them:
    within each data group the crossing axis must hold every process,
    each an equal run of consecutive shards in process order (its
    collectives go over the whole job, every process running every data
    group in group order: parallel/tensor.py's reductions,
    parallel/pipeline.py's hand-offs, parallel/expert.py's all-to-all,
    parallel/sequence.py's ring pass, all-to-alls and merges).

    A data axis across processes raises RuntimeError: the JAX package
    fails there at its first read-back (engine/engine.py:259,
    sched/scheduler.py:2041, "Fetching value for jax.Array that spans
    non-addressable devices"). Two axes crossing at once, or another
    axis than data inside the processes beside the one that crosses,
    raise NotImplementedError naming their ROADMAP item."""
    if mesh is None or not mesh.spans_processes:
        return
    across = axes_across_processes(mesh)
    if "data" in across:
        raise RuntimeError(
            "a data axis across processes is refused: the JAX package "
            "fails there at its first read-back (engine/engine.py:259, "
            "sched/scheduler.py:2041: 'Fetching value for jax.Array that "
            "spans non-addressable devices'), so the port does not run it")
    big = [a for a in mesh.axis_names if a != "data" and mesh.shape[a] > 1]
    if len(big) > 1:
        raise NotImplementedError(
            f"a mesh over several processes runs one axis across them, "
            f"with at most a data axis inside; "
            f"{' x '.join(f'{a}={mesh.shape[a]}' for a in big)} (across "
            f"them: {', '.join(across)}) is not ported there yet "
            f"({_TWO_AXES_ITEM})")
    axis = big[0]          # tensor, stage, expert or seq
    n = process_count()
    for d in range(mesh.shape["data"]):
        procs = mesh.processes[d].reshape(-1)
        if len(procs) % n or not np.array_equal(
                procs, np.repeat(np.arange(n), len(procs) // n)):
            raise ValueError(
                f"the {axis} axis must hold every one of the {n} processes, "
                f"each an equal run of shards in process order (got process "
                f"indices {procs.tolist()}"
                + (f" in data group {d})" if mesh.shape["data"] > 1
                   else ")"))


def owner(mesh: Mesh, axis: str, i: int) -> int:
    """The process that holds shard i along `axis` (stage s, expert
    shard j, seq shard i): on a mesh whose one axis crosses processes,
    every device of that shard in every data group is that process's."""
    return int(mesh.sub_mesh(axis, i).processes.reshape(-1)[0])


def owners(mesh: Mesh, axis: str) -> List[int]:
    """The process of each shard along `axis`, shard order."""
    return [owner(mesh, axis, i) for i in range(mesh.shape[axis])]


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


def stage_devices(mesh: Mesh) -> List[Optional[torch.device]]:
    """The first device of each pipeline stage, stage order: where a
    stage's activations arrive and leave (None for a stage another
    process holds)."""
    me = process_index()
    return [sub.first_device if (sub.processes == me).any() else None
            for sub in map(mesh.stage_mesh, range(stage_degree(mesh)))]


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
