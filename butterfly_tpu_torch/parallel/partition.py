"""Weight placement over the mesh, single-controller: the expert axis.

The counterpart of butterfly_tpu/parallel/partition.py's `shard_params`
for the one mesh axis whose weights the port shards today. The JAX
package attaches a PartitionSpec to every leaf and lets GSPMD place it;
here ONE process drives every device, so a sharded leaf is an explicit
list of per-shard tensors (`ExpertShards`): the MoE expert leaves
`layers.moe.w_gate` / `w_up` [L, E, D, F] and `w_down` [L, E, F, D], int8
`{"q8", "s"}` leaves alike, are split over the expert axis, experts
[i*ne, (i+1)*ne) on shard i's device (ne = E / N). Where a shard's device
is the tree's device the part is a VIEW of the stacked tensor, so one
card with N shards still holds one tree, not N. The router and every
other leaf stay on the mesh's first device.

The expert FFN (models/common.py:moe_block, parallel/expert.py) runs each
shard's experts where their part lives (`expert_parts`).

Not ported yet (ROADMAP.md, PyTorch/CUDA port queue, item 6): the
tensor-parallel specs (column/row-parallel attention and MLP, the
vocab-sharded embedding), the stage specs of pipeline parallelism, the
data axis, and `shard_cache`; `shard_params` refuses a mesh with those
axes through core/mesh.py.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from butterfly_tpu_torch.core.config import ModelConfig
from butterfly_tpu_torch.core.mesh import (Mesh, expert_degree,
                                           require_ported_mesh)

Params = Dict[str, Any]

_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


class ExpertShards:
    """One expert leaf split over the expert axis: `parts[i]` holds shard
    i's experts on shard i's device. Indexing takes the same index of
    every part (the leading layer axes, as `layer_params` and the draft's
    layer slice do), so a layer's slice is again an ExpertShards; the
    expert axis is the axis right after the indexed ones."""

    __slots__ = ("parts",)

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts = tuple(parts)

    def __getitem__(self, idx) -> "ExpertShards":
        return ExpertShards([p[idx] for p in self.parts])

    def to(self, *args, **kw) -> "ExpertShards":
        """Each part converted alike (a dtype cast keeps the placement)."""
        return ExpertShards([p.to(*args, **kw) for p in self.parts])

    def is_floating_point(self) -> bool:
        return self.parts[0].is_floating_point()

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.parts)

    def numel(self) -> int:
        return sum(p.numel() for p in self.parts)

    def __repr__(self) -> str:
        return ("ExpertShards(" + ", ".join(
            f"{tuple(p.shape)}@{p.device}" for p in self.parts) + ")")


def expert_parts(w: Any, n: Optional[int] = None) -> List[Any]:
    """One layer's expert leaf ([E, ...], float or {"q8", "s"}) as its
    per-shard parts: an ExpertShards' own parts; a plain tensor as `n`
    views along the expert axis (one part when n is None)."""
    if isinstance(w, dict):
        keys = list(w)
        cols = [expert_parts(w[k], n) for k in keys]
        return [dict(zip(keys, vals)) for vals in zip(*cols)]
    if isinstance(w, ExpertShards):
        if n is not None and n != len(w.parts):
            raise ValueError(f"the expert leaves are split over "
                             f"{len(w.parts)} shards, not {n}")
        return list(w.parts)
    n = n or 1
    if w.shape[0] % n:
        raise ValueError(f"{w.shape[0]} experts do not split over {n} "
                         "shards")
    return list(w.chunk(n, dim=0))


def shard_count(p_moe: Params) -> int:
    """How many shards one layer's MoE leaves are split over (1 when
    they are plain tensors)."""
    w = p_moe["w_gate"]
    w = w["q8"] if isinstance(w, dict) else w
    return len(w.parts) if isinstance(w, ExpertShards) else 1


def part_device(w: Any) -> torch.device:
    """The device of a (possibly int8) per-shard expert leaf."""
    return (w["q8"] if isinstance(w, dict) else w).device


def _place(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """`t` on `dev`: the tensor itself (a view stays a view) when it is
    there already."""
    dev = torch.device(dev)
    same = t.device.type == dev.type and \
        (dev.index is None or t.device.index == dev.index)
    return t if same else t.to(dev)


def _to_first(node: Any, dev: torch.device) -> Any:
    if isinstance(node, dict):
        return {k: _to_first(v, dev) for k, v in node.items()}
    if isinstance(node, ExpertShards):
        return node
    return _place(node, dev)


def shard_params(params: Params, cfg: ModelConfig, mesh: Mesh) -> Params:
    """The tree placed over `mesh`: with an expert axis N > 1, each
    `layers.moe.w_*` leaf (int8 codes and scales alike) becomes an
    ExpertShards of N parts, experts [i*ne, (i+1)*ne) on
    `mesh.expert_devices()[i]`, a view where that is the leaf's device.
    Every other leaf goes to the mesh's first device (no copy when it is
    there). Leaves already sharded stay as they are. The input tree is
    not modified."""
    require_ported_mesh(mesh)
    out = _to_first(params, mesh.first_device)
    N = expert_degree(mesh)
    moe = out.get("layers", {}).get("moe")
    if N <= 1 or moe is None:
        return out
    E = cfg.num_experts
    if E % N:
        raise ValueError(f"{E} experts do not split over an expert axis "
                         f"of {N}")
    ne = E // N
    devs = mesh.expert_devices()

    def split(node):
        if isinstance(node, dict):
            return {k: split(v) for k, v in node.items()}
        if isinstance(node, ExpertShards):
            return node
        return ExpertShards([_place(node.narrow(1, i * ne, ne), devs[i])
                             for i in range(N)])
    out["layers"] = dict(out["layers"])
    out["layers"]["moe"] = {k: split(v) if k in _EXPERT_LEAVES else v
                            for k, v in moe.items()}
    return out
