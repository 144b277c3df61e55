"""Weight and KV placement over the mesh, single-controller.

The counterpart of butterfly_tpu/parallel/partition.py. The JAX package
attaches a PartitionSpec to every leaf and lets GSPMD place it; here ONE
process drives every device, so the specs are the same tuples of axis
names (`param_specs`, `cache_specs`, `paged_cache_specs`,
`kv_window_specs`, `warm_prefix_specs`: one entry per dim, an axis name
or None, JAX's rule `_div` included: a dim is split only where it divides
by its axis, else replicated) and a split leaf becomes an explicit
container of per-shard tensors, `Shards`:

* tensor (Megatron): wq/wk/wv (and GPT-2's bq/bk/bv) column-parallel over
  the heads, wo row-parallel; w_gate/w_up (and b_up) column-parallel over
  F, w_down row-parallel; the MoE expert leaves split on F too; embed.tok
  and lm_head split over the vocab. The reductions the row-parallel
  leaves need run in parallel/tensor.py;
* expert: the MoE expert leaves split over E (parallel/expert.py); under
  expert x tensor each expert part is again split over F, over the
  tensor devices of its expert shard (a Shards of Shards);
* seq: the weights replicate (parallel/sequence.py places one tree per
  seq shard, its tensor and expert parts on the shard's devices, views
  where the shards share a card); under `stage` the seq axis is a
  replica no program runs on, and the tree is placed at seq coordinate
  0 alone;
* data: weights and the page pool are replicated, batch rows and slots
  split (the forwards run each data group on its rows; see
  parallel/tensor.py:data_groups);
* stage: the layer-stacked leaves, the page pools and the contiguous
  caches split their leading L dim, stage s holding layers
  [s*L/S, (s+1)*L/S) placed over its own mesh (`Mesh.stage_mesh(s)`,
  expert, tensor and data as above: the MoE leaves of a stage's slice
  split over that stage's expert devices, JAX's P('stage', 'expert',
  ...)); the embedding, the final norm and the LM head are placed over
  stage 0's mesh (parallel/pipeline.py runs them there), or, on a mesh
  whose stage axis crosses processes, over each process's first stage's
  mesh: every process holds its own replica, as JAX's P() replicates
  them.

Where a shard shares its device with the tree, a weight part is a VIEW of
the stacked leaf, so one card with N shards still holds one tree, not N
(`copy=True` places real copies, the branch shards on distinct devices
take). The KV pools, windows and caches split over `tensor` are separate
tensors per shard, as the kernels need each shard's operands contiguous.
A data replica of a weight or of the pool is the same tensor where the
data groups share a device; elsewhere (or with `copy=True`) each group
holds its own copy, and every pool write reaches every replica
(cache/paged.py, engine/serving.py).

On a mesh over several processes (core/mesh.py) each process places only
the shards of the crossing axis that lie on its own devices (tensor
shards, its stages' layer slices, its expert shards) and its own copy
of every other leaf: a Shards there holds a run of the shards
(`Shards.distributed`, `offset` the first), and nothing is allocated
for another process's.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from butterfly_tpu_torch.core.config import ModelConfig
from butterfly_tpu_torch.core.mesh import (Mesh, check_process_mesh,
                                           data_degree, stage_degree)
from butterfly_tpu_torch.quant.int8 import is_quantized_leaf, quant_specs_like

Params = Dict[str, Any]
Spec = Tuple[Optional[str], ...]


class Shards:
    """One leaf split over the mesh axis `axis` ("tensor", "expert",
    "data" or "stage"): `parts[i]` is shard i's part, on shard i's
    device. `split` is the dim of the whole leaf the parts partition, in
    order; None when every part is the whole leaf (the data replicas of
    a replicated leaf). A part may itself be a Shards (a tensor-split
    leaf replicated over data groups, a stage's slice split over
    `tensor`).

    Indexing takes the same index of every part (the leading layer axes,
    as `layer_params` and the draft's layer slice do), so a layer's slice
    is again a Shards, its split dim shifted past the integer indices.

    On a mesh over several processes (core/mesh.py) a process holds only
    its own shards: `parts` are shards [offset, offset + len(parts)) of
    `count`; the others are another process's, hold no tensor here and
    allocate nothing (`distributed`). Every derived Shards keeps the
    pair (`like`)."""

    __slots__ = ("parts", "axis", "split", "offset", "count")

    def __init__(self, parts: Sequence[Any], axis: str,
                 split: Optional[int], offset: int = 0,
                 count: Optional[int] = None):
        self.parts = tuple(parts)
        self.axis = axis
        self.split = split
        self.offset = offset
        self.count = len(self.parts) if count is None else count

    def like(self, parts: Sequence[Any], split: Optional[int] = None
             ) -> "Shards":
        """A Shards of `parts` over the same shards (split `split`, None =
        this one's)."""
        return Shards(parts, self.axis,
                      self.split if split is None else split, self.offset,
                      self.count)

    @property
    def distributed(self) -> bool:
        """Whether other processes hold some of the shards."""
        return len(self.parts) < self.count

    def __getitem__(self, idx) -> "Shards":
        split = self.split
        if split is not None:
            lead = idx if isinstance(idx, tuple) else (idx,)
            if len(lead) > split and isinstance(lead[split], int):
                raise IndexError(f"an integer index on the split dim "
                                 f"{split} of {self!r}")
            split -= sum(isinstance(i, int) for i in lead[:split])
        return Shards([p[idx] for p in self.parts], self.axis, split,
                      self.offset, self.count)

    def to(self, *args, **kw) -> "Shards":
        """Each part converted alike (a dtype cast keeps the placement)."""
        return self.like([p.to(*args, **kw) for p in self.parts])

    def is_floating_point(self) -> bool:
        return self.parts[0].is_floating_point()

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    @property
    def shape(self) -> torch.Size:
        """The whole leaf's shape (the shards of a distributed leaf are
        even)."""
        s = list(self.parts[0].shape)
        if self.split is not None:
            s[self.split] = (s[self.split] * self.count if self.distributed
                             else sum(p.shape[self.split]
                                      for p in self.parts))
        return torch.Size(s)

    @property
    def nbytes(self) -> int:
        """The bytes of the parts this process holds."""
        return sum(p.nbytes for p in self.parts)

    def numel(self) -> int:
        return sum(p.numel() for p in self.parts)

    def __repr__(self) -> str:
        held = (f" shards {self.offset}..{self.offset + len(self.parts)} "
                f"of {self.count}" if self.distributed else "")
        return (f"Shards({self.axis}, split={self.split}{held}: "
                + ", ".join(f"{tuple(p.shape)}@{p.device}"
                            for p in self.parts) + ")")


def axis_parts(x: Any, axis: str) -> Optional[List[Any]]:
    """The parts of `x` along `axis`, or None when x is not split there."""
    if isinstance(x, Shards) and x.axis == axis:
        return list(x.parts)
    return None


def held_part(x: Shards, i: int) -> Any:
    """Shard i of `x`, which this process must hold (a ValueError names
    the shard when another process holds it)."""
    j = i - x.offset
    if not 0 <= j < len(x.parts):
        raise ValueError(f"{x.axis} shard {i} of {x!r} is another "
                         "process's")
    return x.parts[j]


def stage_part(tree: Any, i: int) -> Any:
    """Part i of every stage Shards in a tree or leaf (a pipeline stage's
    layers, pools or cache; with virtual stages, chunk i), anything else
    as it is. None stays None."""
    if isinstance(tree, dict):
        return {k: stage_part(v, i) for k, v in tree.items()}
    if isinstance(tree, Shards) and tree.axis == "stage":
        return held_part(tree, i)
    return tree


def stage_count(tree: Any) -> int:
    """How many parts the stage Shards of a tree or leaf have, every
    process's (1 when it is not split over stages)."""
    if isinstance(tree, dict):
        return max([stage_count(v) for v in tree.values()] or [1])
    return tree.count if isinstance(tree, Shards) and tree.axis == "stage" \
        else 1


def stack_stages(parts: Sequence[Any], offset: int = 0,
                 count: Optional[int] = None) -> Any:
    """Per-stage trees as one tree of stage Shards split on the layer
    dim (dicts element-wise, None stays None): stages [offset, offset +
    len(parts)) of `count` (None = these alone)."""
    p0 = parts[0]
    if isinstance(p0, dict):
        return {k: stack_stages([p[k] for p in parts], offset, count)
                for k in p0}
    if p0 is None:
        return None
    return Shards(parts, "stage", 0, offset, count)


def local_stages(mesh: Mesh) -> range:
    """The stages whose devices are this process's, in stage order (every
    stage on a mesh of one process)."""
    return range(*mesh.local_range("stage"))


def layer_slice(tree: Any, lo: int, hi: int) -> Any:
    """Layers [lo, hi) of every layer-stacked leaf (views)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, lo, hi) for k, v in tree.items()}
    return None if tree is None else tree[lo:hi]


def leading_layers(layers: Any, n: int, Ls: int) -> Any:
    """The first `n` layers of a stage-split layer stack (each leaf a
    stage Shards of [Ls, ...] slices) as one stack on stage 0's devices,
    split inside a stage as stage 0's slice is. Where the stages' slices
    sit back to back in one storage (every stage on one device) the
    result is a view over them; otherwise the later slices are copied to
    stage 0's devices."""
    k = -(-n // Ls)
    if isinstance(layers, dict):
        return {key: leading_layers(v, n, Ls) for key, v in layers.items()}
    if layers.distributed:
        raise ValueError(f"{layers!r} is split over processes")
    return _join_rows(list(layers.parts[:k]), n)


def _join_rows(parts: List[Any], n: int) -> Any:
    """The first n rows along dim 0 of the stage slices `parts`, laid end
    to end, shaped like parts[0] (a Shards by its parts)."""
    p0 = parts[0]
    if isinstance(p0, dict):
        return {key: _join_rows([p[key] for p in parts], n) for key in p0}
    if isinstance(p0, Shards):
        return Shards([_join_rows([p.parts[i] for p in parts], n)
                       for i in range(len(p0.parts))], p0.axis, p0.split)
    rows = p0.shape[0]
    if all(p.untyped_storage().data_ptr() == p0.untyped_storage().data_ptr()
           and p.stride() == p0.stride() and p.shape == p0.shape
           and p.storage_offset() == p0.storage_offset()
           + i * rows * p0.stride(0) for i, p in enumerate(parts)):
        return p0.as_strided((n,) + tuple(p0.shape[1:]), p0.stride(),
                             p0.storage_offset())
    return torch.cat([p.to(p0.device) for p in parts])[:n]


def layers_per_stage(cfg: ModelConfig, mesh: Mesh) -> int:
    """L / S, the layers each pipeline stage holds; indivisible layers
    raise ValueError."""
    S = stage_degree(mesh)
    if cfg.num_layers % S:
        raise ValueError(f"{cfg.num_layers} layers not divisible by {S} "
                         "stages")
    return cfg.num_layers // S


# ---------------------------------------------------------------------------
# The expert axis
# ---------------------------------------------------------------------------

def expert_parts(w: Any, n: Optional[int] = None) -> List[Any]:
    """One layer's expert leaf ([E, ...], float or {"q8", "s"}) as its
    per-shard parts: an expert Shards' own parts (on a mesh across
    processes, this process's run of them, from shard `offset`);
    anything else (a plain tensor, a tensor-split leaf) as `n` views
    along the expert axis (one part, the leaf itself, when n is None)."""
    if isinstance(w, dict):
        keys = list(w)
        cols = [expert_parts(w[k], n) for k in keys]
        return [dict(zip(keys, vals)) for vals in zip(*cols)]
    parts = axis_parts(w, "expert")
    if parts is not None:
        if n is not None and n != w.count:
            raise ValueError(f"the expert leaves are split over "
                             f"{w.count} shards, not {n}")
        return parts
    if not n or n == 1:
        return [w]
    if w.shape[0] % n:
        raise ValueError(f"{w.shape[0]} experts do not split over {n} "
                         "shards")
    return list(w.chunk(n, dim=0))


def held_expert_range(cfg: ModelConfig, mesh: Optional[Mesh]
                      ) -> Optional[Tuple[int, int]]:
    """[lo, hi): the experts this process holds on a mesh whose expert
    axis crosses processes (None elsewhere: every process holds them
    all)."""
    if mesh is None or not cfg.is_moe or not mesh.spans_processes \
            or mesh.shape["expert"] <= 1:
        return None
    lo, hi = mesh.local_range("expert")
    ne = cfg.num_experts // mesh.shape["expert"]
    return lo * ne, hi * ne


def place_held_experts(params: Params, cfg: ModelConfig, mesh: Mesh
                       ) -> Params:
    """A tree whose MoE expert leaves hold only this process's experts
    (`experts=held_expert_range(...)` to init_params,
    init_params_quantized or load_checkpoint) with those leaves placed as
    the expert Shards shard_params makes of the whole leaves (an int8
    leaf's codes and scales alike): this process's shards on their
    devices; shard_params keeps them."""
    lo, hi = mesh.local_range("expert")
    devs = mesh.expert_devices()

    def split(w):
        ne = w.shape[1] // (hi - lo)
        return Shards([_place(w.narrow(1, (e - lo) * ne, ne), devs[e])
                       for e in range(lo, hi)], "expert", 1, lo,
                      mesh.shape["expert"])
    moe = dict(params["layers"]["moe"])
    for k in ("w_gate", "w_up", "w_down"):
        w = moe[k]
        moe[k] = {q: split(v) for q, v in w.items()} \
            if is_quantized_leaf(w) else split(w)
    return {**params, "layers": {**params["layers"], "moe": moe}}


def shard_count(p_moe: Params) -> int:
    """How many expert shards one layer's MoE leaves are split over, every
    process's (1 when they are not split over experts)."""
    w = _expert_leaf(p_moe)
    return 1 if w is None else w.count


def held_experts(p_moe: Params) -> Tuple[int, int]:
    """(first, count) of the expert shards of one layer's MoE leaves
    this process holds ((0, 1) when they are not split over experts)."""
    w = _expert_leaf(p_moe)
    return (0, 1) if w is None else (w.offset, len(w.parts))


def _expert_leaf(p_moe: Params) -> Optional[Shards]:
    w = p_moe["w_gate"]
    w = w["q8"] if isinstance(w, dict) else w
    return w if isinstance(w, Shards) and w.axis == "expert" else None


def part_device(w: Any) -> torch.device:
    """The device of a (possibly int8) per-shard expert leaf."""
    return (w["q8"] if isinstance(w, dict) else w).device


# ---------------------------------------------------------------------------
# Specs (the JAX package's PartitionSpec entries, as tuples)
# ---------------------------------------------------------------------------

def _div(n: int, mesh: Mesh, axis: str) -> Optional[str]:
    """`axis` if a dim of size n shards evenly over it (and it is > 1),
    else None."""
    size = mesh.shape.get(axis, 1)
    return axis if size > 1 and n % size == 0 else None


def _div_multi(n: int, mesh: Mesh, *axes: str):
    """Largest prefix-combination of the active `axes` that divides n
    (JAX `_div_multi`): an axis tuple, a name, or None."""
    for i in range(len(axes)):
        active = [a for a in axes[i:] if mesh.shape.get(a, 1) > 1]
        size = 1
        for a in active:
            size *= mesh.shape[a]
        if active and n % size == 0:
            return tuple(active) if len(active) > 1 else active[0]
    return None


def param_specs(cfg: ModelConfig, mesh: Mesh) -> Params:
    """The spec tree mirroring models.common.init_params exactly (JAX
    `param_specs`): Megatron column/row-parallel attention and MLP, the
    MoE experts over `expert` (and F over `tensor`), the vocab-split
    embedding and head. Stacked leaves lead with the layer dim, split over
    `stage` (shard_params places each stage's slice over its own mesh)."""
    D, Nq, Kv, F, V = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                       cfg.intermediate_size, cfg.vocab_size)

    def tp(n):
        return _div(n, mesh, "tensor")
    L = _div(cfg.num_layers, mesh, "stage")
    layers: Params = {
        "ln1": {"scale": (L, None)},
        "ln2": {"scale": (L, None)},
        "attn": {
            "wq": (L, None, tp(Nq), None),    # column-parallel (heads)
            "wk": (L, None, tp(Kv), None),
            "wv": (L, None, tp(Kv), None),
            "wo": (L, tp(Nq), None, None),    # row-parallel -> a reduction
        },
    }
    if cfg.use_bias:
        layers["ln1"]["bias"] = (L, None)
        layers["ln2"]["bias"] = (L, None)
        layers["attn"].update(bq=(L, tp(Nq), None), bk=(L, tp(Kv), None),
                              bv=(L, tp(Kv), None), bo=(L, None))
    if cfg.is_moe:
        ep = _div(cfg.num_experts, mesh, "expert")
        layers["moe"] = {"router": (L, None, None),
                         "w_gate": (L, ep, None, tp(F)),
                         "w_up": (L, ep, None, tp(F)),
                         "w_down": (L, ep, tp(F), None)}
    elif cfg.arch == "gpt2":
        layers["mlp"] = {"w_up": (L, None, tp(F)), "b_up": (L, tp(F)),
                         "w_down": (L, tp(F), None), "b_down": (L, None)}
    else:
        layers["mlp"] = {"w_gate": (L, None, tp(F)),
                         "w_up": (L, None, tp(F)),
                         "w_down": (L, tp(F), None)}
    specs: Params = {"embed": {"tok": (tp(V), None)}, "layers": layers,
                     "final_norm": {"scale": (None,)}}
    if cfg.pos_embedding == "learned":
        specs["embed"]["pos"] = (None, None)
    if cfg.arch == "gpt2":
        specs["final_norm"]["bias"] = (None,)
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, _div_multi(V, mesh, "stage", "tensor"))
    return specs


def cache_specs(cfg: ModelConfig, mesh: Mesh, quant: bool = False) -> dict:
    """Specs of the contiguous KVCache's leaves: batch over `data`,
    kv-heads over `tensor`. Float caches are [L, B, S, Kv, H]; int8 ones
    [L, B, Kv, S, H] + scales [L, B, Kv, S]."""
    lspec = _div(cfg.num_layers, mesh, "stage")
    dspec = "data" if mesh.shape.get("data", 1) > 1 else None
    tspec = _div(cfg.num_kv_heads, mesh, "tensor")
    if quant:
        kv = (lspec, dspec, tspec, None, None)
        sc = (lspec, dspec, tspec, None)
    else:
        kv = (lspec, dspec, None, tspec, None)
        sc = None
    return {"k": kv, "v": kv, "length": (dspec,), "k_scale": sc,
            "v_scale": sc}


def paged_cache_specs(cfg: ModelConfig, mesh: Mesh, num_slots: int,
                      quant: bool = False) -> dict:
    """Specs of the PagedKVCache's leaves: pools [L, P, Kv, page, H]
    kv-heads over `tensor`, the page dim replicated (any slot may read
    any page: prefix caching shares them); the block table and lengths
    slots over `data` when the slots divide. int8 scale pools
    [L, P, Kv*page] split their flat dim with the codes: a tensor chunk
    of the kv-major flat dim is one kv group's scales."""
    dslots = _div(num_slots, mesh, "data")
    lspec = _div(cfg.num_layers, mesh, "stage")
    tspec = _div(cfg.num_kv_heads, mesh, "tensor")
    kv = (lspec, None, tspec, None, None)
    sc = (lspec, None, tspec) if quant else None
    return {"k_pages": kv, "v_pages": kv, "page_table": (dslots, None),
            "lengths": (dslots,), "k_scale_pages": sc, "v_scale_pages": sc}


def kv_window_specs(cfg: ModelConfig, mesh: Mesh, num_slots: int,
                    quant: bool = False) -> dict:
    """Specs of the write-combined window [L, S, Kv, W, H]: slots over
    `data` with the block table, kv-heads over `tensor` with the pools."""
    dslots = _div(num_slots, mesh, "data")
    tspec = _div(cfg.num_kv_heads, mesh, "tensor")
    kv = (None, dslots, tspec, None, None)
    sc = (None, dslots, tspec, None) if quant else None
    return {"k": kv, "v": kv, "k_scale": sc, "v_scale": sc}


def warm_prefix_specs(d: Optional[str], t: Optional[str],
                      quant: bool) -> Tuple[Spec, ...]:
    """Specs of the warm flash kernel's cached-context operands, in call
    order (prefix_k, prefix_v, prefix_len[, k_scale, v_scale]): batch
    over `data` with the q rows, kv heads over `tensor` with the pools.
    A float prefix is [B, S, Kv, H]; int8 codes [B, Kv, S, H] with
    scales [B, Kv, S]."""
    if quant:
        code = (d, t, None, None)
        return (code, code, (d,), (d, t, None), (d, t, None))
    view = (d, None, t, None)
    return (view, view, (d,))


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (an unindexed device matches any
    index of its type)."""
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def _place(t: torch.Tensor, dev, copy: bool = False) -> torch.Tensor:
    """`t` on `dev`: the tensor itself (a view stays a view) when it is
    there already and `copy` is False; else a contiguous copy there."""
    if same_device(t.device, dev) and not copy:
        return t
    return t.to(torch.device(dev), copy=True,
                memory_format=torch.contiguous_format)


def group_device(mesh: Mesh, data_index: int = 0) -> torch.device:
    """Where data group `data_index` keeps what is not split over the
    tensor axis: the first of its devices this process holds (on a mesh
    over several processes each keeps its own replica)."""
    return mesh.data_devices()[data_index]


def held_tensor_shards(mesh: Mesh, data_index: int, T: int
                       ) -> Tuple[List[torch.device], int]:
    """(devices, index of the first) of data group `data_index`'s tensor
    shards that this process holds, of T (T = 1: the group's one replica,
    on `group_device`)."""
    if T == 1:
        return [group_device(mesh, data_index)], 0
    lo, hi = mesh.local_range("tensor", data=data_index)
    return mesh.tensor_devices(data_index)[lo:hi], lo


def _split_leaf(leaf: torch.Tensor, axis: str, dim: int,
                devs: Sequence, copy: bool,
                local: Optional[Tuple[int, int]] = None) -> Shards:
    """`leaf` split evenly on `dim` over `devs`; with `local` = [lo, hi)
    (Mesh.local_range) only those shards are placed, the rest being
    another process's."""
    n = len(devs)
    size = leaf.shape[dim] // n
    lo, hi = (0, n) if local is None else local
    return Shards([_place(leaf.narrow(dim, i * size, size), devs[i], copy)
                   for i in range(lo, hi)], axis, dim, lo, n)


def _place_tree(node: Any, spec: Any, mesh: Mesh, data_index: int,
                copy: bool) -> Any:
    """One data group's copy of a (sub)tree by its specs: an expert dim
    split over the group's expert shards, then (an MoE leaf under
    expert x tensor) each expert part's tensor dim over that expert
    shard's tensor devices; a tensor dim over the group's tensor
    devices; every other leaf on the group's first device."""
    if isinstance(node, dict):
        if is_quantized_leaf(node) and not isinstance(spec, dict):
            spec = quant_specs_like(node, spec)
        return {k: _place_tree(v, spec[k], mesh, data_index, copy)
                for k, v in node.items()}
    if isinstance(node, Shards):
        return node
    dims = {ax: dim for dim, ax in enumerate(spec)
            if ax in ("tensor", "expert")}
    tdevs = mesh.tensor_devices(data_index)
    if "expert" in dims:
        edim, N = dims["expert"], mesh.shape["expert"]
        size = node.shape[edim] // N
        lo, hi = mesh.local_range("expert", data=data_index)
        parts = []
        for e in range(lo, hi):
            part = node.narrow(edim, e * size, size)
            if "tensor" in dims:
                parts.append(_split_leaf(
                    part, "tensor", dims["tensor"],
                    mesh.tensor_devices(data_index, expert_index=e), copy))
            else:
                parts.append(_place(part, mesh.expert_devices(
                    data_index)[e], copy))
        return Shards(parts, "expert", edim, lo, N)
    if "tensor" in dims:
        return _split_leaf(node, "tensor", dims["tensor"], tdevs, copy,
                           mesh.local_range("tensor", data=data_index))
    return _place(node, group_device(mesh, data_index),
                  copy and data_index > 0)


def _over_data(place_group, mesh: Mesh, copy: bool):
    """`place_group(d)` for every data group d: group 0's placement alone
    where every group shares its devices and `copy` is False, else a
    Shards over "data" of each group's own placement (replicas)."""
    D = data_degree(mesh)
    first = place_group(0)
    if D == 1 or (not copy and all(
            same_device(a, b) for d in range(1, D)
            for a, b in zip(mesh.group_devices(0), mesh.group_devices(d)))):
        return first
    return [first] + [place_group(d) for d in range(1, D)]


def _zip_data(groups: list) -> Any:
    """A list of per-group trees as one tree of data Shards."""
    g0 = groups[0]
    if isinstance(g0, dict):
        return {k: _zip_data([g[k] for g in groups]) for k in g0}
    if g0 is None:
        return None
    return Shards(groups, "data", None)


def shard_params(params: Params, cfg: ModelConfig, mesh: Mesh,
                 copy: bool = False) -> Params:
    """The tree placed over `mesh` by `param_specs`: each leaf with a
    tensor (or expert) dim becomes a Shards over that axis (an expert
    axis that does not divide the experts raises), views of the
    leaf where a shard shares its device (`copy` places contiguous
    copies); every other leaf goes to the mesh's first device (no copy
    when it is there). Data groups on other devices (or `copy`) get
    their own replica: every leaf is then a Shards over "data". Leaves
    already sharded stay as they are; the input tree is not modified.

    Under `stage` each layer-stacked leaf becomes a Shards over "stage"
    of its [L/S, ...] slices, slice s placed as above over stage s's
    mesh (views where it shares the tree's device); the other leaves are
    placed over the mesh of this process's first stage (stage 0 on a
    mesh of one process).

    On a mesh over several processes each process places only its own
    shards (the counterpart of device_put onto a global sharding, which
    fills only the addressable ones: its tensor shards, its stages'
    slices, its expert shards) and its own replica of the rest; what
    core/mesh.py:check_process_mesh refuses raises."""
    check_process_mesh(mesh)
    if stage_degree(mesh) > 1:
        Ls = layers_per_stage(cfg, mesh)
        mine = local_stages(mesh)
        top = {k: v for k, v in params.items() if k != "layers"}
        out = shard_params(top, cfg, mesh.stage_mesh(mine[0]), copy)
        if "layers" in params:
            if stage_count(params["layers"]) > 1:
                out["layers"] = params["layers"]   # placed already
            else:
                scfg = cfg.replace(num_layers=Ls)
                out["layers"] = stack_stages([shard_params(
                    {"layers": layer_slice(params["layers"], s * Ls,
                                           (s + 1) * Ls)},
                    scfg, mesh.stage_mesh(s), copy)["layers"]
                    for s in mine], mine[0], stage_degree(mesh))
        return out
    N = mesh.shape.get("expert", 1)
    if cfg.is_moe and N > 1 and cfg.num_experts % N:
        # the expert dispatch needs every shard to own whole experts
        raise ValueError(f"{cfg.num_experts} experts do not split over an "
                         f"expert axis of {N}")
    specs = param_specs(cfg, mesh)
    out = _over_data(lambda d: _place_tree(params, specs, mesh, d, copy),
                     mesh, copy)
    return _zip_data(out) if isinstance(out, list) else out


def _shard_pool(t: torch.Tensor, axis: Optional[str], mesh: Mesh,
                data_index: int, split: int, copy: bool):
    """A KV tensor split on `split` over the tensor axis (`axis` is its
    spec entry there) as separate contiguous per-shard tensors (the
    kernels' operands), or placed whole on the group's first device."""
    tdevs = mesh.tensor_devices(data_index)
    if axis == "tensor":
        return _split_leaf(t, "tensor", split, tdevs, True,
                           mesh.local_range("tensor", data=data_index))
    return _place(t, group_device(mesh, data_index), copy or data_index > 0)


def shard_paged_cache(cache, cfg: ModelConfig, mesh: Mesh,
                      copy: bool = False):
    """The PagedKVCache placed by `paged_cache_specs`: the pools (and
    int8 scale pools) split over `tensor` into one contiguous pool per
    shard; replicated over data groups (each group its own copy on other
    devices, or with `copy`). The block table and lengths, rewritten by
    the host every dispatch, stay on the mesh's first device: each data
    group reads its slots' rows from there. Under `stage` each pool is a
    Shards over "stage" of its [L/S, ...] slices, each placed so over
    its stage's mesh."""
    if stage_degree(mesh) > 1:
        Ls = layers_per_stage(cfg, mesh)
        scfg = cfg.replace(num_layers=Ls)
        mine = local_stages(mesh)
        names = ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages")
        per = [shard_paged_cache(cache._replace(**{
            n: layer_slice(getattr(cache, n), s * Ls, (s + 1) * Ls)
            for n in names}), scfg, mesh.stage_mesh(s), copy)
            for s in mine]
        return per[0]._replace(**{n: stack_stages(
            [getattr(c, n) for c in per], mine[0], stage_degree(mesh))
            for n in names})
    specs = paged_cache_specs(cfg, mesh, cache.num_slots, cache.quantized)

    def group(d):
        out = {}
        for name in ("k_pages", "v_pages", "k_scale_pages",
                     "v_scale_pages"):
            t = getattr(cache, name)
            out[name] = None if t is None else _shard_pool(
                t, specs[name][2], mesh, d, 2, copy)
        return out
    pools = _over_data(group, mesh, copy)
    if isinstance(pools, list):
        pools = _zip_data(pools)
    first = mesh.first_device
    return cache._replace(page_table=_place(cache.page_table, first),
                          lengths=_place(cache.lengths, first), **pools)


def _split_rows(t: torch.Tensor, mesh: Mesh, dim: int, tsplit: Optional[int],
                copy: bool):
    """A slot- or batch-indexed KV tensor split over data groups on
    `dim` (each group's rows on its devices) and, when `tsplit` is set,
    each group's rows over the tensor axis on `tsplit`."""
    D = data_degree(mesh)
    rows = t.shape[dim] // D
    groups = []
    for d in range(D):
        part = t.narrow(dim, d * rows, rows)
        if tsplit is not None:
            groups.append(_split_leaf(part, "tensor", tsplit,
                                      mesh.tensor_devices(d), True,
                                      mesh.local_range("tensor", data=d)))
        else:
            groups.append(_place(part, group_device(mesh, d), copy))
    return groups[0] if D == 1 else Shards(groups, "data", dim)


def shard_kv_window(window, cfg: ModelConfig, mesh: Mesh,
                    copy: bool = False):
    """The KVWindow placed by `kv_window_specs`: slots split over data
    groups, kv-heads over `tensor` (separate contiguous tensors per
    shard)."""
    specs = kv_window_specs(cfg, mesh, window.k.shape[1], window.quantized)
    return window._replace(**{
        name: None if t is None else _split_rows(
            t, mesh, 1, 2 if specs[name][2] == "tensor" else None, copy)
        for name, t in zip(window._fields, window)})


def shard_cache(cache, cfg: ModelConfig, mesh: Mesh, copy: bool = False):
    """The contiguous KVCache placed by `cache_specs`: batch split over
    data groups, kv-heads over `tensor` (separate tensors per shard); the
    lengths stay on the mesh's first device. Under `stage` each cache
    tensor is a Shards over "stage" of its [L/S, ...] slices, each placed
    so over its stage's mesh."""
    if stage_degree(mesh) > 1:
        Ls = layers_per_stage(cfg, mesh)
        scfg = cfg.replace(num_layers=Ls)
        mine = local_stages(mesh)
        names = ("k", "v", "k_scale", "v_scale")
        per = [shard_cache(cache._replace(**{
            n: layer_slice(getattr(cache, n), s * Ls, (s + 1) * Ls)
            for n in names}), scfg, mesh.stage_mesh(s), copy)
            for s in mine]
        return per[0]._replace(
            length=_place(cache.length, mesh.first_device),
            **{n: stack_stages([getattr(c, n) for c in per], mine[0],
                               stage_degree(mesh))
               for n in names})
    specs = cache_specs(cfg, mesh, cache.quantized)
    kv_dim = 2 if cache.quantized else 3
    out = {}
    for name in ("k", "v", "k_scale", "v_scale"):
        t = getattr(cache, name)
        out[name] = None if t is None else _split_rows(
            t, mesh, 1, kv_dim if specs[name][kv_dim] == "tensor" else None,
            copy)
    return cache._replace(length=_place(cache.length, mesh.first_device),
                          **out)
