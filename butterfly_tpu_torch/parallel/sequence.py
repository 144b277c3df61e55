"""Sequence parallelism for long context: ring attention and Ulysses, on a
single-controller mesh.

The counterpart of butterfly_tpu/parallel/sequence.py. The JAX package
runs each function body once per device under `shard_map`, with the
collectives (the ring's `ppermute` inside the layer scan, `pmax`/`psum`
inside the decode layer) in the middle of the layer loop. The port keeps
ONE layer loop and holds every seq-sharded value as a list with one
tensor per shard, on that shard's device; inside a layer it runs each
shard's work in shard order. The collectives become:

* `ppermute(i -> i+1)`: the list rotates, each tensor moving with
  `.to(device, non_blocking=True)` (a no-op when both shards share a
  card);
* `pmax` / `psum`: reductions on the first shard's device, in shard
  order;
* `axis_index`: the loop index;
* `all_to_all` / `all_gather` (Ulysses): concatenations and splits.

Weights are replicated over `seq` as under the JAX mesh, once per seq
shard's devices (`replicate_params`): shards that share a card share its
tensors (views, no second copy). Replicated values (the decode step's
activations, the suffix cache, the serving lane's gathered prefix) live
on the first shard's device, which is where every program that is not
seq-parallel runs.

The other axes compose as the JAX body leaves them automatic inside its
shard_map (manual over {"seq"} only):

* data: each data group runs its own ring over its rows, on its own seq
  shards (`mesh.seq_devices(d)`); the rows' math is independent, and the
  results concatenate in group order (the cache as a data Shards);
* tensor: each seq shard's tree holds tensor Shards on its tensor
  devices (`mesh.tensor_devices(d, seq_index=i)`), so its projections
  and FFN run per tensor shard (parallel/tensor.py); the ring runs once
  per tensor shard on that shard's heads across the seq shards
  (`ring_heads`), and `attn_output` sums the row-parallel partials.
  Where Kv does not divide the tensor axis the K/V stay replicated and
  each tensor shard reads the kv heads its q heads need (`_kv_for`).
  Ulysses reshards whole heads, so it gathers each seq shard's heads and
  splits its output back;
* expert: each seq shard's tree holds the expert parts on its own expert
  devices (`mesh.expert_devices(d, seq_index=i)`), and its FFN runs with
  its own mesh active (`Mesh.seq_mesh(i)`), so an MoE takes the a2a path
  over those devices on the shard's chunk, its capacity pooled over the
  chunk (and, under data, the whole batch: the data groups run as one
  GroupRun), as the JAX body does with `expert` automatic inside; the
  decode steps take the einsum path.

Where the seq axis crosses processes (core/mesh.py: each process a run
of consecutive seq shards, in every data group alike) every process runs
the same layer loop on its own shards, the others' entries None in every
per-shard list (`seq_owners`, `_mine`); the weights are every process's
whole tree, as the JAX specs put nothing on `seq`. The collectives become
those of parallel/tensor.py: a ring rotation across processes is a send
and a receive of the block (K, V, key positions, the int8 scales; a
step's posted together: `_rotate`), Ulysses' reshards all-to-alls
and its positions an all-gather (`_all_to_all_shards`, `gather_local`),
the decode merges an all-gather of each shard's [B, Nq, 1(, H)] partials
combined in shard order (an all-reduce would reorder the sums), and a
logits row the broadcast of its shard's holder (`shard_row`). The bytes
that move are exact, so every process computes the one-process bits.

Masking follows ops/ring_attention.py: the one predicate is
k_pos <= q_pos, invalid keys carry INVALID_POS.

Under kv_quant="int8" each shard quantises its chunk ONCE (kv-major
layout, the pool's representation) and every ring read goes through
codes + scales, dequantised in the kernel.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from butterfly_tpu_torch.core.config import ModelConfig
from butterfly_tpu_torch.core.mesh import mesh_ctx, owners, process_index
from butterfly_tpu_torch.models.common import (
    KVCache, Params, _cast_layer, _group_cache, _stack, attend, attn_output,
    embed_tokens, ffn_block, final_logits, layer_params, pre_norm, qkv_proj,
    quantize_kv, torch_dtype, update_cache_layer, update_cache_layer_q)
from butterfly_tpu_torch.ops.ring_attention import (
    INVALID_POS, block_stats, finalize_stats, merge_stats, zero_stats)
from butterfly_tpu_torch.parallel.partition import Shards as TShards
from butterfly_tpu_torch.parallel.tensor import (
    DataGroup, all_gather_cat, all_to_all_blocks, broadcast_from,
    cat_groups, data_groups, exchange, gather, group_part, group_rows,
    run_groups, tmap)

Shards = List[Any]


class Replicated:
    """The weight tree of every seq shard: `trees[d][i]` is seq shard i
    of data group d's tree, its leaves on that shard's devices (a tensor
    split leaf's part t on the shard's tensor device t); None for a
    shard another process holds. Shards whose devices are the same share
    one tree."""

    def __init__(self, trees: List[List[Params]]):
        self.trees = trees


def _place_on(node: Any, devs: Sequence[torch.device],
              edevs: Optional[Sequence[Sequence[torch.device]]] = None
              ) -> Any:
    """A (sub)tree on one seq shard's devices: part t of a tensor split
    leaf on devs[t]; part e of an expert split leaf on the shard's expert
    device e (its tensor part t on edevs[e][t]); any other leaf on
    devs[0]. A leaf that is there already is itself (a view stays a
    view)."""
    if isinstance(node, dict):
        return {k: _place_on(v, devs, edevs) for k, v in node.items()}
    if isinstance(node, tuple):
        return tuple(_place_on(v, devs, edevs) for v in node)
    if node is None:
        return None
    if isinstance(node, TShards):
        if node.axis == "expert" and edevs is not None:
            return TShards([_place_on(p, edevs[e])
                            for e, p in enumerate(node.parts)], "expert",
                           node.split)
        if node.axis != "tensor":
            raise ValueError(f"{node!r} on a seq shard: only tensor and "
                             "expert splits ride a seq mesh")
        return TShards([p.to(d, non_blocking=True)
                        for p, d in zip(node.parts, devs)], "tensor",
                       node.split)
    return node.to(devs[0], non_blocking=True)


def replicate_params(params: Params, mesh) -> Replicated:
    """The weight tree on every seq shard of `mesh` (each data group's
    replica, each tensor part on its shard's tensor device, each expert
    part on its shard's expert device; no copy where it already lives
    there, as on one card). Where the seq axis crosses processes only
    this process's shards get a tree (None for another's)."""
    D = mesh.shape.get("data", 1)
    N = mesh.shape.get("seq", 1)
    E = mesh.shape.get("expert", 1)
    mine = _mine(seq_owners(mesh), N)
    by_devs: Dict[tuple, Params] = {}
    trees = []
    for d in range(D):
        src = group_part(params, d)
        row = []
        for i in range(N):
            if not mine[i]:
                row.append(None)
                continue
            devs = tuple(mesh.tensor_devices(d, seq_index=i))
            edevs = tuple(tuple(mesh.tensor_devices(d, seq_index=i,
                                                    expert_index=e))
                          for e in range(E))
            key = (id(src), devs, edevs)
            if key not in by_devs:
                by_devs[key] = _place_on(src, devs, edevs)
            row.append(by_devs[key])
        trees.append(row)
    return Replicated(trees)


def seq_owners(mesh) -> Optional[List[int]]:
    """The process of each seq shard where the seq axis crosses
    processes (core/mesh.py:check_process_mesh: then in every data group
    alike), else None (every shard this process's)."""
    if mesh is None or mesh.shape.get("seq", 1) <= 1 \
            or not mesh.spans_processes:
        return None
    return owners(mesh, "seq")


def _mine(own: Optional[Sequence[int]], N: int) -> List[bool]:
    """Whether each of N seq shards is this process's."""
    if own is None:
        return [True] * N
    me = process_index()
    return [p == me for p in own]


def _each(fn, *lists) -> list:
    """fn over the shards of per-shard lists, None where the first list's
    entry is None (another process's shard)."""
    return [None if xs[0] is None else fn(*xs) for xs in zip(*lists)]


def _first(xs: Sequence[Any]) -> Any:
    """The first entry of a per-shard list this process holds."""
    return next(x for x in xs if x is not None)


def _replicas(params, mesh) -> Replicated:
    return params if isinstance(params, Replicated) \
        else replicate_params(params, mesh)


def _layer_params(trees: Sequence[Params], i: int, dtype) -> list:
    """Layer i's weights in the compute dtype, per seq shard (cast once
    per distinct tree)."""
    done: Dict[int, Dict] = {}
    out = []
    for t in trees:
        if t is None:
            out.append(None)
            continue
        if id(t) not in done:
            done[id(t)] = _cast_layer(layer_params(t, i), dtype)
        out.append(done[id(t)])
    return out


def _groups(mesh, batch: int) -> List[DataGroup]:
    """The mesh's data groups over `batch` rows (one group without a
    data axis)."""
    return data_groups(batch, mesh) or [
        DataGroup(0, slice(0, batch), mesh.first_device)]


def _rows(x: Any, g: DataGroup, dim: int = 1) -> Any:
    """Group g's rows of a per-seq-shard value, where it lives: its part
    of a data Shards, else a view of its rows."""
    if x is None:
        return None
    if isinstance(x, TShards) and x.axis == "data":
        return x.parts[g.index]
    return x[(slice(None),) * dim + (g.rows,)]


def _join(parts: list, dim: int = 1) -> Any:
    """Per-group values as one: a data Shards on `dim` (the value itself
    for one group)."""
    return parts[0] if len(parts) == 1 else TShards(parts, "data", dim)


def _whole(x: Any, kv_dim: int, device=None) -> torch.Tensor:
    """A per-seq-shard cache value as one tensor on `device`: its data
    groups concatenated on the batch dim (1), its tensor shards on
    `kv_dim`."""
    if isinstance(x, TShards) and x.axis == "data":
        return torch.cat([_whole(p, kv_dim, device) for p in x.parts], dim=1)
    if isinstance(x, TShards):
        return torch.cat([_whole(p, kv_dim, device) for p in x.parts],
                         dim=kv_dim)
    return x if device is None else x.to(device)


def _rotate(cur: list, devs: Sequence[Optional[torch.device]],
            own: Optional[Sequence[int]]) -> list:
    """One ring step's ppermute i -> i+1 of every component list in `cur`
    (K, V, key positions, the int8 scales; a component that is absent is
    a list of None): shard i receives shard i-1's block, moved to its
    device. Where the seq axis crosses processes (`own`, the process of
    each shard) a block whose next shard is another process's is sent
    there and the block of a shard whose previous one is another
    process's received, the step's sends and receives posted together
    (parallel/tensor.py:exchange): the bytes are exact."""
    N = len(devs)
    me = process_index()
    own = own or [me] * N
    sends, recvs, keys = [], [], []
    for c, xs in enumerate(cur):
        for i in range(N):
            j = (i + 1) % N
            if own[i] == own[j]:
                continue
            tag = i * len(cur) + c
            if own[i] == me and xs[i] is not None:
                sends.append((xs[i], own[j], tag))
            elif own[j] == me and xs[j] is not None:
                recvs.append((xs[j].shape, xs[j].dtype, devs[j], own[i], tag))
                keys.append((c, j))
    got = dict(zip(keys, exchange(sends, recvs)))
    out = []
    for c, xs in enumerate(cur):
        row = []
        for j in range(N):
            i = (j - 1) % N
            if own[j] != me or xs[j] is None:
                row.append(None)
            elif own[i] == me:
                row.append(xs[i].to(devs[j], non_blocking=True))
            else:
                row.append(got[(c, j)])
        out.append(row)
    return out


def _split(x: torch.Tensor, devs: Sequence[torch.device], dim: int = 1,
           mine: Optional[Sequence[bool]] = None) -> Shards:
    """x split into len(devs) equal chunks along `dim`, chunk i on devs[i]
    (None for a shard another process holds: `mine[i]` False)."""
    mine = mine or [True] * len(devs)
    return [c.to(d, non_blocking=True) if m else None
            for c, d, m in zip(x.chunk(len(devs), dim=dim), devs, mine)]


def shard_row(logits: Shards, mesh, shard: int, row: int,
              device: torch.device) -> torch.Tensor:
    """Row `row` of seq shard `shard`'s logits [B, T/N, V] as [B, V] on
    `device`, in every process: where the seq axis crosses processes the
    process holding that shard broadcasts it (parallel/tensor.py:
    broadcast_from), so every process samples the same token."""
    own = seq_owners(mesh)
    x = logits[shard]
    t = None if x is None else x[:, row, :].to(device)
    if own is None:
        return t
    ref = _first(logits)
    return broadcast_from(t, own[shard], (ref.shape[0], ref.shape[2]),
                          ref.dtype, device)


def gather_local(xs: list) -> list:
    """Every shard's tensor in every process, shard order: this process's
    run of shards (the non-None entries, equal shapes) all-gathered over
    the job. A list with no None is itself."""
    if all(x is not None for x in xs):
        return list(xs)
    local = [x for x in xs if x is not None]
    dev = local[0].device
    got = all_gather_cat(torch.stack([x.to(dev) for x in local]), 0)
    return list(got.unbind(0))


def gather_shards(xs: Shards, dim: int = 1, device=None) -> torch.Tensor:
    """The seq-sharded list concatenated along `dim` on `device` (None =
    the first shard's)."""
    dev = xs[0].device if device is None else device
    return torch.cat([x.to(dev) for x in xs], dim=dim)


class ShardedKVCache(NamedTuple):
    """sp_forward's cache: each shard keeps the K/V it computed.

    k/v[i]: shard i's [L, B, Tl, Kv, H] (float) or codes [L, B, Kv, Tl, H]
    with k_scale/v_scale[i] [L, B, Kv, Tl] (int8), on shard i's devices:
    under a tensor axis a tensor Shards over the kv heads (or one
    replicated tensor where Kv does not divide it), under a data axis a
    data Shards over the batch rows (each group's part on its devices);
    `length` [B] on the first shard's device. Where the seq axis crosses
    processes each process keeps its own shards' K/V, None for
    another's."""

    k: Shards
    v: Shards
    length: torch.Tensor
    k_scale: Optional[Shards] = None
    v_scale: Optional[Shards] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def local_len(self) -> int:
        k = _first(self.k)
        return k.shape[3] if self.quantized else k.shape[2]

    def gather(self, device=None) -> KVCache:
        """The whole cache as one contiguous KVCache (the JAX global
        array's layout) on `device` (None = the first shard's); across
        processes an all-gather every process joins."""
        q = self.quantized
        sd = 3 if q else 2

        def whole(xs, kv_dim):
            parts = gather_local([None if x is None else
                                   _whole(x, kv_dim, device) for x in xs])
            return gather_shards(parts, sd, device)
        k = whole(self.k, 2 if q else 3)
        v = whole(self.v, 2 if q else 3)
        length = self.length.to(k.device)
        if not q:
            return KVCache(k=k, v=v, length=length)
        return KVCache(k=k, v=v, length=length,
                       k_scale=whole(self.k_scale, 2),
                       v_scale=whole(self.v_scale, 2))


# ---------------------------------------------------------------------------
# The tensor axis inside a seq shard
# ---------------------------------------------------------------------------

def _kv_for(k: Any, q: TShards, t: int, dim: int) -> Any:
    """Tensor shard t's K/V operand (kv heads on `dim`) for its q heads:
    its own part of a split K/V; of a replicated one (Kv does not divide
    the tensor axis), the kv heads its q heads read, each q head's kv
    head repeated when the shard's heads do not cover whole GQA groups,
    so the kernel's head grouping stays that of the whole model."""
    if k is None or isinstance(k, TShards):
        return None if k is None else k.parts[t]
    sizes = [p.shape[2] for p in q.parts]
    lo = sum(sizes[:t])
    hi = lo + sizes[t]
    G = sum(sizes) // k.shape[dim]
    if lo // G == (hi - 1) // G:
        return k.narrow(dim, lo // G, 1)
    if lo % G == 0 and hi % G == 0:
        return k.narrow(dim, lo // G, (hi - lo) // G)
    idx = torch.arange(lo, hi, device=k.device) // G
    return k.index_select(dim, idx)


def _stats_shards(per: list) -> tuple:
    """Per-tensor-shard (m, l, acc) as one tuple of tensor Shards over
    the heads (dim 1)."""
    return tuple(TShards([p[j] for p in per], "tensor", 1) for j in range(3))


def _block_heads(q, k, v, q_pos, k_pos, k_scale=None, v_scale=None,
                 quant: bool = False, kernel: Optional[bool] = None):
    """block_stats of one K/V block, per tensor shard on its heads where
    q is split (each shard's call on its K/V's device), else one call.
    Float K/V [B, S, Kv, H]; int8 codes [B, Kv, S, H], scales
    [B, Kv, S]."""
    if not isinstance(q, TShards):
        return block_stats(q, k, v, q_pos, k_pos, k_scale, v_scale,
                           kernel=kernel)
    kd = 1 if quant else 2
    per = []
    for t, qt in enumerate(q.parts):
        kt = _kv_for(k, q, t, kd)
        d = kt.device
        per.append(block_stats(
            qt.to(d, non_blocking=True), kt, _kv_for(v, q, t, kd).to(d),
            q_pos.to(d, non_blocking=True), k_pos.to(d, non_blocking=True),
            None if k_scale is None else _kv_for(k_scale, q, t, 1).to(d),
            None if v_scale is None else _kv_for(v_scale, q, t, 1).to(d),
            kernel=kernel))
    return _stats_shards(per)


def _merge(a: tuple, b: tuple) -> tuple:
    """merge_stats, per tensor shard when the stats are split."""
    if isinstance(a[0], TShards):
        return tmap(lambda *x: merge_stats(x[:3], x[3:]), *a, *b,
                    out_split=1)
    return merge_stats(a, b)


def _finalize(stats: tuple, dtype) -> Any:
    """finalize_stats ([B, T, Nq, H]), per tensor shard when split."""
    if isinstance(stats[0], TShards):
        return tmap(lambda m, l, a: finalize_stats((m, l, a), dtype),
                    *stats, out_split=2)
    return finalize_stats(stats, dtype)


def _quantize(k: Any) -> Tuple[Any, Any]:
    """A [B, T, Kv, H] chunk as int8 (codes [B, Kv, T, H], scales
    [B, Kv, T]), per tensor shard when split."""
    return tmap(lambda x: quantize_kv(x.movedim(2, 1)), k, out_split=1)


def _split_heads(x: torch.Tensor, like: TShards, dim: int) -> TShards:
    """A whole-head value as a tensor Shards split on `dim` like `like`'s
    heads (dim 2 of [B, T, Nq, H]), part t on like's part t device."""
    sizes = [p.shape[2] for p in like.parts]
    return TShards([c.to(p.device, non_blocking=True) for c, p in
                    zip(torch.split(x, sizes, dim=dim), like.parts)],
                   "tensor", dim)


# ---------------------------------------------------------------------------
# Ring and Ulysses attention over shard lists
# ---------------------------------------------------------------------------

def ring_stats(q: Shards, k: Shards, v: Shards, q_pos: Shards,
               k_pos: Shards, k_scale: Optional[Shards] = None,
               v_scale: Optional[Shards] = None,
               kernel: Optional[bool] = None,
               own: Optional[Sequence[int]] = None) -> list:
    """Merged (unfinalised) flash stats of every shard over all N ring
    blocks, one (m, l, acc) per shard on its device.

    At ring step s shard i holds the K/V (+ positions, + int8 scales) of
    shard (i - s) mod N and folds its block's stats into its running
    stats with merge_stats, seeded from zero_stats: the JAX scan's order.
    Where the seq axis crosses processes (`own`: the process of each
    shard) each process holds and folds its own shards (None entries for
    the others') and a rotation across processes is a send and a receive
    (`_rotate`)."""
    N = len(q)
    devs = [None if x is None else x.device for x in q]
    B, T, Nq, H = _first(q).shape
    ks = list(k_scale) if k_scale is not None else [None] * N
    vs = list(v_scale) if v_scale is not None else [None] * N
    cur = [list(k), list(v), list(k_pos), ks, vs]
    stats = [None if d is None else zero_stats(B, Nq, T, H, device=d)
             for d in devs]
    for step in range(N):
        ck, cv, ckp, cks, cvs = cur
        for i in range(N):
            if q[i] is None:
                continue
            blk = block_stats(q[i], ck[i], cv[i], q_pos[i], ckp[i], cks[i],
                              cvs[i], kernel=kernel)
            stats[i] = merge_stats(stats[i], blk)
        if step < N - 1:  # the last rotation would be discarded
            cur = _rotate(cur, devs, own)
    return stats


def ring_attention(q: Shards, k: Shards, v: Shards, q_pos: Shards,
                   k_pos: Shards, k_scale: Optional[Shards] = None,
                   v_scale: Optional[Shards] = None,
                   kernel: Optional[bool] = None,
                   own: Optional[Sequence[int]] = None) -> Shards:
    """Causal GQA over the sequence ring. Per shard: q [B, Tq, Nq, H];
    float k/v [B, Tk, Kv, H]; int8 k/v codes [B, Kv, Tk, H] with
    k_scale/v_scale [B, Kv, Tk]; q_pos/k_pos [B, T*] absolute positions,
    invalid keys sanitised to INVALID_POS. Returns [B, Tq, Nq, H] per
    shard (None for another process's, `own` as in ring_stats)."""
    return _each(lambda s, x: finalize_stats(s, x.dtype),
                 ring_stats(q, k, v, q_pos, k_pos, k_scale, v_scale,
                            kernel=kernel, own=own), q)


def _all_to_all_shards(xs: Shards, split: int, cat: int, N: int) -> Shards:
    """all_to_all(split_axis=split, concat_axis=cat) over seq shards that
    cross processes: local shard a's chunk b of N along `split` goes to
    shard b, which concatenates what every shard sent it along `cat` in
    shard order. One all-to-all over the job (each process's run of
    shards in process order)."""
    local = [i for i, x in enumerate(xs) if x is not None]
    n = len(local)
    P = N // n
    dev = xs[local[0]].device
    chunks = [xs[i].to(dev).chunk(N, dim=split) for i in local]
    send = torch.stack([torch.stack([torch.stack(
        [chunks[a][p * n + b] for b in range(n)]) for a in range(n)])
        for p in range(P)])                      # [P, n(src), n(dst), ...]
    got = all_to_all_blocks(send)                # [P, n(src), n(mine), ...]
    out: list = [None] * N
    for b, i in enumerate(local):
        out[i] = torch.cat([got[p, a, b] for p in range(P)
                            for a in range(n)], dim=cat).to(xs[i].device)
    return out


def ulysses_attention(q: Shards, k: Shards, v: Shards,
                      q_pos: Shards,
                      own: Optional[Sequence[int]] = None) -> Shards:
    """All-to-all head <-> sequence reshard, then full causal attention on
    the whole sequence for each shard's head group, and back.

    Per shard q [B, T/N, Nq, H], k/v [B, T/N, Kv, H]. Needs Kv % N == 0,
    or N % Kv == 0 and Nq % N == 0: then each kv head is REPLICATED
    r = N / Kv times first, so shard d receives the kv head (d // r) its
    q-head block contracts with. Returns [B, T/N, Nq, H] per shard.
    Where the seq axis crosses processes (`own`: the process of each
    shard; None entries for another's shards) the reshards are
    all-to-alls over the job and the positions an all-gather."""
    N = len(q)
    devs = [None if x is None else x.device for x in q]
    B, Tl, Nq, H = _first(q).shape
    Kv = _first(k).shape[2]
    if Kv % N != 0:
        if N % Kv != 0 or Nq % N != 0:
            raise ValueError(
                f"ulysses needs Kv % N == 0 or (N % Kv == 0 and "
                f"Nq % N == 0); got Nq={Nq}, Kv={Kv}, N={N}")
        r = N // Kv
        k = _each(lambda x: x.repeat_interleave(r, dim=2), k)
        v = _each(lambda x: x.repeat_interleave(r, dim=2), v)

    def heads_to_seq(xs):  # all_to_all(split_axis=2, concat_axis=1)
        if own is not None:
            return _all_to_all_shards(xs, 2, 1, N)
        w = xs[0].shape[2] // N
        return [torch.cat([x[:, :, d * w:(d + 1) * w].to(devs[d])
                           for x in xs], dim=1) for d in range(N)]

    qq, kk, vv = heads_to_seq(q), heads_to_seq(k), heads_to_seq(v)
    if own is not None:                                          # all_gather
        q_pos = gather_local(q_pos)
    outs: list = [None] * N
    for d in range(N):
        if devs[d] is None:
            continue
        pos = torch.cat([p.to(devs[d]) for p in q_pos], dim=1)
        mask = pos[:, None, :] <= pos[:, :, None]                # [B,T,T]
        outs[d] = attend(qq[d], kk[d], vv[d], mask, None)
    # back: all_to_all(split_axis=1, concat_axis=2)
    if own is not None:
        return _all_to_all_shards(outs, 1, 2, N)
    return [torch.cat([o[:, i * Tl:(i + 1) * Tl].to(devs[i]) for o in outs],
                      dim=2) for i in range(N)]


def ring_heads(q: Shards, k: Shards, v: Shards, q_pos: Shards,
               k_pos: Shards, k_scale: Optional[Shards] = None,
               v_scale: Optional[Shards] = None, quant: bool = False,
               kernel: Optional[bool] = None,
               own: Optional[Sequence[int]] = None) -> list:
    """ring_stats over the seq shards, once per tensor shard on its heads
    where the shards' q are tensor Shards (the ring of tensor shard t
    runs over the seq shards' devices at tensor coordinate t); else one
    ring (across processes where `own` names the shards' processes: the
    seq axis then crosses them alone). Returns per seq shard (m, l,
    acc), tensor Shards over the heads when split."""
    if not isinstance(_first(q), TShards):
        return ring_stats(q, k, v, q_pos, k_pos, k_scale, v_scale,
                          kernel=kernel, own=own)
    kd = 1 if quant else 2
    per = []
    for t in range(len(q[0].parts)):
        qt = [x.parts[t] for x in q]
        devs = [x.device for x in qt]

        def pick(xs, dim):
            if xs is None:
                return None
            return [_kv_for(x, qi, t, dim).to(d, non_blocking=True)
                    for x, qi, d in zip(xs, q, devs)]
        per.append(ring_stats(
            qt, pick(k, kd), pick(v, kd),
            [p.to(d, non_blocking=True) for p, d in zip(q_pos, devs)],
            [p.to(d, non_blocking=True) for p, d in zip(k_pos, devs)],
            pick(k_scale, 1), pick(v_scale, 1), kernel=kernel))
    return [_stats_shards([p[i] for p in per]) for i in range(len(q))]


def _gathered(xs: Shards, dim: int) -> list:
    """Each seq shard's value with its tensor shards concatenated on
    `dim` (a replicated value as it is; None stays None)."""
    return [None if x is None else gather(x, dim) for x in xs]


# ---------------------------------------------------------------------------
# Whole-model sequence-parallel prefill
# ---------------------------------------------------------------------------

def _attend_chunk(q, k, v, pos, impl: str, quant: bool, compute,
                  kernel: Optional[bool], own=None):
    """One layer's attention over the shards' fresh chunks (sp_forward).
    Returns (out per shard, the chunk's K/V per shard in the cache's
    representation; None for another process's shard, `own` the
    process of each where the seq axis crosses them). Under a tensor
    axis the ring runs per tensor shard on its heads; Ulysses reshards
    whole heads, so it gathers each seq shard's heads first and splits
    its output back (the JAX body sees every head: the tensor axis is
    automatic inside it)."""
    split = isinstance(_first(q), TShards)
    if quant:
        qk = _each(_quantize, k)                            # [B,Kv,Tl,H]
        qv = _each(_quantize, v)
        kq, ksc = _each(lambda x: x[0], qk), _each(lambda x: x[1], qk)
        vq, vsc = _each(lambda x: x[0], qv), _each(lambda x: x[1], qv)
        kv_out = _each(lambda *x: x, kq, vq, ksc, vsc)
        if impl == "ring":
            stats = ring_heads(q, kq, vq, pos, pos, ksc, vsc, quant=True,
                               kernel=kernel, own=own)
            return _each(lambda x, s: _finalize(s, x.dtype), q,
                         stats), kv_out
        # Ulysses gathers whole sequences for a dense attend: it reads
        # the dequantised values (same operands, no scale plumbing)

        def deq(a, s):
            return (a.float() * s[..., None]).movedim(1, 2).to(compute)
        kf = _each(deq, _gathered(kq, 1), _gathered(ksc, 1))
        vf = _each(deq, _gathered(vq, 1), _gathered(vsc, 1))
    else:
        kv_out = _each(lambda a, b: (tmap(lambda x: x.to(compute), a),
                                     tmap(lambda x: x.to(compute), b)), k, v)
        if impl == "ring":
            stats = ring_heads(q, k, v, pos, pos, kernel=kernel, own=own)
            return _each(lambda x, s: _finalize(s, x.dtype), q,
                         stats), kv_out
        kf, vf = _gathered(k, 2), _gathered(v, 2)
    out = ulysses_attention(_gathered(q, 2), kf, vf, pos, own=own)
    if split:
        out = [_split_heads(o, x, 2) for o, x in zip(out, q)]
    return out, kv_out


def _shard_ffn(x, lp: Params, cfg: ModelConfig, sub) -> Any:
    """One seq shard's FFN on its chunk, with the shard's own mesh active:
    an MoE under an expert axis dispatches over the shard's expert
    devices (parallel/expert.py), the a2a path on a chunk the expert
    axis divides, its capacity pooled over the chunk, as the JAX seq
    body (manual over `seq` alone) runs it."""
    with mesh_ctx(sub):
        return ffn_block(pre_norm(x, lp["ln2"], cfg), lp, cfg)


def _check_seq_args(T: int, N: int, kv_quant: str, impl: str) -> None:
    if T % N != 0:
        raise ValueError(f"seq len {T} not divisible by seq axis {N}")
    if kv_quant not in ("none", "int8"):
        raise ValueError(f"unknown kv quant {kv_quant!r}")
    if impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown seq impl {impl!r}")


def sp_forward(params, cfg: ModelConfig, tokens: torch.Tensor, mesh,
               impl: str = "ring", kv_quant: str = "none",
               kernel: Optional[bool] = None
               ) -> Tuple[Shards, ShardedKVCache]:
    """Long-context prefill with activations sharded over `seq`.

    tokens: [B, T], T divisible by the seq size. `params` is one weight
    tree (placed over the mesh's tensor and data axes or not) or
    `replicate_params`' result. Each data group runs its own ring over
    its rows; under a tensor axis each seq shard's layer math runs per
    tensor shard and the ring once per tensor shard. Returns (logits per
    shard [B, T/N, V] f32 on the shard's first device of data group 0,
    ShardedKVCache with S = T: int8 codes + scales when
    kv_quant="int8").

    Where the seq axis crosses processes each process runs its own
    shards (the ring's blocks pass between processes, Ulysses' reshards
    are all-to-alls): its logits and K/V entries are None for another
    process's shard (`shard_row` reads a row in every process)."""
    N = mesh.shape.get("seq", 1)
    B, T = tokens.shape
    _check_seq_args(T, N, kv_quant, impl)
    quant = kv_quant == "int8"
    reps = _replicas(params, mesh)
    own = seq_owners(mesh)
    subs = [mesh.seq_mesh(i) for i in range(N)]
    outs = run_groups(_groups(mesh, B), lambda g: _sp_forward_group(
        reps.trees[g.index], cfg, tokens[g.rows], mesh.seq_devices(g.index),
        subs, impl, quant, kernel, own), B)
    logits = [cat_groups([o[0][i] for o in outs]) for i in range(N)]
    width = len(_first(outs[0][1]))
    parts = [None if outs[0][1][i] is None else
             [_join([o[1][i][j] for o in outs]) for j in range(width)]
             for i in range(N)]
    length = torch.full((B,), T, dtype=torch.int32,
                        device=mesh.first_device)
    cols = [[None if p is None else p[j] for p in parts]
            for j in range(width)]
    if quant:
        cache = ShardedKVCache(k=cols[0], v=cols[1], length=length,
                               k_scale=cols[2], v_scale=cols[3])
    else:
        cache = ShardedKVCache(k=cols[0], v=cols[1], length=length)
    return logits, cache


def _shard_inputs(trees, cfg: ModelConfig, tokens: torch.Tensor, start: int,
                  devs, mine) -> tuple:
    """Each of this process's seq shards' tokens' positions (its chunk of
    `tokens` [B, T] starting at absolute position `start`) and embedding
    with the rotary tables: (pos, xs, cos, sin) per shard, None for
    another process's."""
    N = len(devs)
    B, T = tokens.shape
    Tl = T // N
    toks = _split(tokens, devs, mine=mine)
    pos = [(start + i * Tl + torch.arange(Tl, device=d))[None, :]
           .expand(B, Tl).to(torch.int32) if m else None
           for i, (d, m) in enumerate(zip(devs, mine))]
    emb = _each(lambda t, tk, p: embed_tokens(t, cfg, tk, p), trees, toks,
                pos)
    return (pos,) + tuple(_each(lambda e: e[j], emb) for j in range(3))


def _sp_forward_group(trees, cfg: ModelConfig, tokens: torch.Tensor,
                      devs, subs, impl: str, quant: bool,
                      kernel: Optional[bool], own=None):
    """sp_forward on one data group's rows over its ring `devs`, seq
    shard i's FFN on its own mesh subs[i]: (logits per shard, per shard
    its K/V components stacked over the layers; None for another
    process's shard, `own` the process of each)."""
    N = len(devs)
    mine = _mine(own, N)
    compute = torch_dtype(cfg.dtype)
    pos, xs, cs, ss = _shard_inputs(trees, cfg, tokens, 0, devs, mine)
    kv_layers = []
    for li in range(cfg.num_layers):
        lp = _layer_params(trees, li, compute)
        qkv = _each(lambda x, p, c, s_: qkv_proj(pre_norm(x, p["ln1"], cfg),
                                                p["attn"], cfg, c, s_),
                    xs, lp, cs, ss)
        qs, ks, vs = (_each(lambda t: t[j], qkv) for j in range(3))
        out, kv_out = _attend_chunk(qs, ks, vs, pos, impl, quant, compute,
                                    kernel, own)
        for i in range(N):
            if not mine[i]:
                continue
            x = xs[i] + attn_output(out[i], lp[i]["attn"], cfg)
            xs[i] = x + _shard_ffn(x, lp[i], cfg, subs[i])
        kv_layers.append(kv_out)
    logits = _each(lambda t, x: final_logits(t, cfg, x), trees, xs)
    # per shard: stack its layers' K/V ([L, ...] like the JAX cache)
    width = len(_first(kv_layers[0]))
    parts = [[_stack([kv_layers[li][i][j] for li in range(cfg.num_layers)])
              for j in range(width)] if mine[i] else None for i in range(N)]
    return logits, parts


# ---------------------------------------------------------------------------
# Decode over the sharded prefix
# ---------------------------------------------------------------------------

def _combine(parts: list, dev) -> tuple:
    """The seq shards' partial stats of one block, combined on `dev` in
    shard order: pmax of m, then psum of the rescaled l and acc."""
    parts = [[t.to(dev, non_blocking=True) for t in p] for p in parts]
    m_g = parts[0][0]
    for p in parts[1:]:
        m_g = torch.maximum(m_g, p[0])
    l_g = acc_g = None
    for m_i, l_i, acc_i in parts:
        corr = torch.exp(m_i - m_g)
        l_c, acc_c = l_i * corr, acc_i * corr[..., None]
        l_g = l_c if l_g is None else l_g + l_c
        acc_g = acc_c if acc_g is None else acc_g + acc_c
    return m_g, l_g, acc_g


def _combine_heads(parts: list, q: Any, own=None) -> tuple:
    """_combine per tensor shard (on q's part device) where the stats are
    tensor Shards, else once on q's device. Where the seq axis crosses
    processes (`own`; `parts` None for another process's shard) every
    shard's partials, [B, Nq, 1(, H)] each, are all-gathered first and
    combined in shard order in every process: the one-process sums'
    bits (an all-reduce would reorder them)."""
    if own is not None:
        parts = list(zip(*(gather_local([None if p is None else p[j]
                                          for p in parts])
                           for j in range(3))))
    if not isinstance(q, TShards):
        return _combine(parts, q.device)
    return _stats_shards([
        _combine([tuple(s.parts[t] for s in p) for p in parts], qt.device)
        for t, qt in enumerate(q.parts)])


def sp_decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                   positions: torch.Tensor, prefix: ShardedKVCache,
                   suffix: KVCache, mesh,
                   prefix_len: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, KVCache]:
    """One decode step over sp_forward's sharded cache.

    The long prefix stays sharded where prefill left it; generated tokens
    live in a small replicated contiguous `suffix` cache (on the first
    shard's device, written IN PLACE; init_cache(mesh=...) splits it over
    the mesh's tensor and data axes as it splits any cache). Each shard
    attends its prefix chunk into partial (m, l, acc); the partials
    combine on the first device in shard order (the JAX pmax/psum), then
    the suffix block folds in with merge_stats before one finalize. Per
    layer that is N prefix launches plus ONE suffix launch (JAX runs the
    replicated suffix block once per device), per tensor shard under a
    tensor axis; each data group runs its rows. Where the seq axis
    crosses processes each process attends its own shards' prefix and
    the partials are all-gathered (`_combine_heads`): every process then
    holds the same logits and the same suffix.

    tokens/positions: [B, 1] on the first device (positions = prefix
    length + step). prefix_len [B]: real prefix tokens per row (slots at
    or past it are masked out: generate_long's divisibility pad);
    defaults to prefix.length. int8: prefix and suffix must agree.
    Returns (last-token logits [B, V], suffix with length + 1).

    Capacity contract: the caller sizes the suffix for the whole run (a
    step past its end would clamp onto the last slot). Checked eagerly
    when the lengths live on the CPU; on a card the check would cost a
    host sync per step, so it is skipped there, as the JAX package skips
    it under jit."""
    if suffix.length.device.type == "cpu":
        if int(suffix.length.max()) >= suffix.max_seq:
            raise ValueError(
                f"suffix cache full ({suffix.max_seq} slots): size "
                "init_cache(max_seq=...) for the whole decode run")
    if prefix_len is None:
        prefix_len = prefix.length
    if prefix.quantized != suffix.quantized:
        raise ValueError("prefix and suffix caches must agree on kv_quant")
    reps = _replicas(params, mesh)
    own = seq_owners(mesh)
    B = tokens.shape[0]
    groups = data_groups(B, mesh)
    if groups is None:
        logits = _sp_decode_group(reps.trees[0], cfg, tokens, positions,
                                  prefix, suffix, prefix_len,
                                  mesh.seq_devices(0), own)
    else:
        logits = cat_groups([_sp_decode_group(
            reps.trees[g.index], cfg, group_rows(tokens, g),
            group_rows(positions, g),
            prefix._replace(**{n: None if getattr(prefix, n) is None else
                               [_rows(x, g) for x in getattr(prefix, n)]
                               for n in ("k", "v", "k_scale", "v_scale")}),
            _group_cache(suffix, g), group_rows(prefix_len, g),
            mesh.seq_devices(g.index), own) for g in groups])
    return logits, suffix._replace(
        length=(suffix.length + 1).to(torch.int32))


def _sp_decode_group(trees, cfg: ModelConfig, tokens, positions,
                     prefix: ShardedKVCache, suffix: KVCache, prefix_len,
                     devs, own=None) -> torch.Tensor:
    """sp_decode_step on one data group's rows over its ring `devs` (this
    process's shards of it where `own` names each shard's process)."""
    quant = prefix.quantized
    mine = _mine(own, len(devs))
    dev0 = devs[mine.index(True)]
    top = _first(trees)
    compute = torch_dtype(cfg.dtype)
    B = tokens.shape[0]
    Smax = suffix.max_seq
    Tl = prefix.local_len
    slen = suffix.length.to(dev0)
    plen = prefix_len.to(dev0)
    tokens, positions = tokens.to(dev0), positions.to(dev0)
    x, cos, sin = embed_tokens(top, cfg, tokens, positions)
    # sanitised key positions, built ONCE outside the layer loop: suffix
    # slot j holds the token at position plen + j, visible up to this
    # step's own write (j <= slen); prefix slots at or past plen (the
    # divisibility pad) are INVALID_POS
    j = torch.arange(Smax, device=dev0)
    suf_pos = torch.where(j[None, :] <= slen[:, None],
                          plen[:, None] + j[None, :],
                          torch.full((B, Smax), INVALID_POS, device=dev0,
                                     dtype=torch.int64)).to(torch.int32)
    pre_pos, q_pos = [], []
    for i, d in enumerate(devs):
        if not mine[i]:
            pre_pos.append(None)
            q_pos.append(None)
            continue
        gpos = i * Tl + torch.arange(Tl, device=d)
        pl = plen.to(d)
        pre_pos.append(torch.where(gpos[None, :] < pl[:, None], gpos[None, :],
                                   torch.full((B, Tl), INVALID_POS, device=d,
                                              dtype=torch.int64))
                       .to(torch.int32))
        q_pos.append(positions.to(d).to(torch.int32))
    suf_qpos = positions.to(torch.int32)
    for li in range(cfg.num_layers):
        lp = _cast_layer(layer_params(top, li), compute)
        h = pre_norm(x, lp["ln1"], cfg)
        q, k, v = qkv_proj(h, lp["attn"], cfg, cos, sin)
        if quant:
            ck, cv, cks, cvs = tmap(update_cache_layer_q, suffix.k[li],
                                    suffix.v[li], suffix.k_scale[li],
                                    suffix.v_scale[li], k, v, slen)
        else:
            ck, cv = tmap(update_cache_layer, suffix.k[li], suffix.v[li], k,
                          v, slen)
            cks = cvs = None
        parts = []
        for i, d in enumerate(devs):
            if not mine[i]:
                parts.append(None)
                continue
            qi = q if isinstance(q, TShards) else q.to(d, non_blocking=True)
            parts.append(_block_heads(
                qi, prefix.k[i][li], prefix.v[i][li], q_pos[i], pre_pos[i],
                prefix.k_scale[i][li] if quant else None,
                prefix.v_scale[i][li] if quant else None, quant=quant))
        suf = _block_heads(q, ck, cv, suf_qpos, suf_pos, cks, cvs,
                           quant=quant)
        out = _finalize(_merge(_combine_heads(parts, q, own), suf), x.dtype)
        x = x + attn_output(out, lp["attn"], cfg)
        x = x + ffn_block(pre_norm(x, lp["ln2"], cfg), lp, cfg)
    logits = final_logits(top, cfg, x)
    return logits[:, -1, :]


# ---------------------------------------------------------------------------
# One chunk of the serving lane's long-prompt prefill
# ---------------------------------------------------------------------------

def sp_chunk_body(params, cfg: ModelConfig, tokens: torch.Tensor,
                  start: int, prefix: tuple, mesh, data_index: int = 0):
    """One paged long-prompt prefill chunk, sharded over `seq` — the
    serving sibling of sp_forward (the JAX body runs inside shard_map).

    tokens: [B=1, C] chunk buffer (C divisible by the seq size) whose
    first token sits at absolute position `start`, also the count of
    flushed pool-prefix tokens; it runs on the ring of data group
    `data_index` (the slot's group). `prefix` is the slot's gathered
    pool prefix for every layer, replicated over seq: (pk, pv)
    [L, B, S, Kv, H] when float, (pk, pv, pks, pvs) codes
    [L, B, Kv, S, H] + scales [L, B, Kv, S] when the pool is int8, each a
    tensor Shards over the kv heads where the pool is split; it is
    copied once to each other distinct shard device. Each query attends
    that prefix (positions < start live) and the fresh chunk via the
    ring; the two partials share one finalize. Chunk padding needs no
    sanitising: pad positions exceed every real query's, and the caller
    routes pad K/V to the null page.

    Returns (logits per shard [B, C/N, V], per shard the chunk's K/V for
    every layer in the pool's representation: (k, v) [L, B, C/N, Kv, H]
    in the compute dtype, or codes [L, B, Kv, C/N, H] + scales; tensor
    Shards where the pool is split). Where the seq axis crosses
    processes each process runs its own shards, None for another's."""
    devs = mesh.seq_devices(data_index)
    N = len(devs)
    own = seq_owners(mesh)
    mine = _mine(own, N)
    subs = [mesh.seq_mesh(i) for i in range(N)]
    trees = _replicas(params, mesh).trees[data_index]
    compute = torch_dtype(cfg.dtype)
    quant = len(prefix) == 4
    S = prefix[0].shape[3] if quant else prefix[0].shape[2]
    pre, pre_pos = [], []
    placed: Dict[tuple, tuple] = {}
    B = tokens.shape[0]
    for i, d in enumerate(devs):
        if not mine[i]:
            pre.append(None)
            pre_pos.append(None)
            continue
        key = tuple(mesh.tensor_devices(data_index, seq_index=i))
        if key not in placed:
            # exactly the flushed tokens (< start) are attendable
            g = torch.arange(S, device=d)
            placed[key] = (_place_on(tuple(prefix), key), torch.where(
                g < start, g, torch.full_like(g, INVALID_POS))[None]
                .expand(B, S).to(torch.int32))
        pre.append(placed[key][0])
        pre_pos.append(placed[key][1])
    pos, xs, cs, ss = _shard_inputs(trees, cfg, tokens, start, devs, mine)
    kv_layers = []
    for li in range(cfg.num_layers):
        lp = _layer_params(trees, li, compute)
        qkv = _each(lambda x, p, c, s_: qkv_proj(pre_norm(x, p["ln1"], cfg),
                                                p["attn"], cfg, c, s_),
                    xs, lp, cs, ss)
        qs, ks, vs = (_each(lambda t: t[j], qkv) for j in range(3))
        pres = _each(lambda q, p, qp, pp: _block_heads(
            q, p[0][li], p[1][li], qp, pp, p[2][li] if quant else None,
            p[3][li] if quant else None, quant=quant), qs, pre, pos, pre_pos)
        if quant:
            qk = _each(_quantize, ks)                       # [B,Kv,Cl,H]
            qv = _each(_quantize, vs)
            fresh = ring_heads(qs, _each(lambda x: x[0], qk),
                               _each(lambda x: x[0], qv), pos, pos,
                               _each(lambda x: x[1], qk),
                               _each(lambda x: x[1], qv), quant=True,
                               own=own)
            kv_out = _each(lambda a, b: (a[0], b[0], a[1], b[1]), qk, qv)
        else:
            fresh = ring_heads(qs, ks, vs, pos, pos, own=own)
            kv_out = _each(lambda a, b: (tmap(lambda x: x.to(compute), a),
                                         tmap(lambda x: x.to(compute), b)),
                           ks, vs)
        for i in range(N):
            if not mine[i]:
                continue
            out = _finalize(_merge(pres[i], fresh[i]), xs[i].dtype)
            x = xs[i] + attn_output(out, lp[i]["attn"], cfg)
            xs[i] = x + _shard_ffn(x, lp[i], cfg, subs[i])
        kv_layers.append(kv_out)
    logits = _each(lambda t, x: final_logits(t, cfg, x), trees, xs)
    width = len(_first(kv_layers[0]))
    kv = [tuple(_stack([kv_layers[li][i][j] for li in range(cfg.num_layers)])
                for j in range(width)) if mine[i] else None
          for i in range(N)]
    return logits, kv
