"""Pipeline parallelism, single-controller: the GPipe microbatch schedule
over the `stage` mesh axis.

The counterpart of butterfly_tpu/parallel/pipeline.py. The JAX package
runs the whole pipeline as ONE SPMD program: a lax.scan over M + S - 1
ticks inside a shard_map manual over `stage`, the handoff a ppermute,
bubble ticks computing on garbage with every write masked. Here ONE
process drives every stage, so the schedule is a host loop:

* the layer-stacked weights, the page pools and the contiguous caches
  are split over `stage` (parallel/partition.py: a Shards over "stage"
  of [L/S, ...] slices, each placed over its stage's own mesh,
  core/mesh.py:Mesh.stage_mesh, whose expert, tensor and data axes run
  inside the stage as they do without a pipeline: each stage body runs
  with its stage's mesh active, so an MoE takes the a2a path over the
  stage's expert devices on a prefill microbatch and the einsum path at
  decode, as the JAX stage body, manual over `stage` alone, does; a seq
  axis is a replica, not a ring: the stages run at this process's seq
  coordinate, 0 on a mesh of one process);
* tick t has stage s working on microbatch m = t - s (`_gpipe_schedule`,
  one host loop for the JAX `_gpipe_schedule` and `_interleaved_body`
  scans). Bubble ticks are skipped: only the valid (stage, microbatch)
  pairs run, which gives the JAX schedule's results with its masked work
  left out;
* an activation moves to the next stage's device only where that device
  differs (`non_blocking`; on one card nothing moves), with no host sync
  inside the schedule; only the last stage's output moves, once, to the
  mesh's first device, where the LM head runs (the JAX `_run_gpipe`
  slices the last stage's block rather than all-reducing S copies);
* the embedding and the head run outside the stage loop on stage 0's
  mesh (the JAX package replicates them over stage);
* int8 caches thread their scale leaves through every body, split over
  stage like the codes.

`virtual_stages` V > 1 is the interleaved schedule: stage s owns the V
round-robin chunks v*S + s, and an activation leaving the last stage's
chunk v wraps to stage 0 for chunk v+1, waiting there in a holding
buffer until its tick. A stage's chunks are views of its slice (the
stack in interleaved order, `interleave_layers`) or the parts of a
Shards over "stage" of S*V chunks in that order
(engine/engine.py places one so, views of the stack, no copy).

Bubble fraction (S-1)/(M+S-1), or (S-1)/(V*M+S-1) interleaved: on several
cards it is idle time; on one card, where every stage shares the device,
the schedule only orders the work.

On a mesh whose stage axis crosses processes (core/mesh.py: each process
a run of consecutive stages at its coordinates of the other axes) every
process runs the same tick loop and computes only the pairs of its own
stages. Where stage s and the stage after it (stage s + 1, or stage 0
for the interleaved wrap) are different processes' the hand-off is a
send and a matching receive, each tick's posted together
(parallel/tensor.py:exchange), the counterpart of the JAX `ppermute`;
the peer is the process of that stage at this process's coordinates of
the other axes (`_stage_owners`: under stage x expert the same expert
shard's process, under stage x seq the same seq replica's). The last
stage's process then broadcasts its output (only the `last_index` rows
where those are taken) over the stage axis's process group, where each
process runs the LM head on its own replica of the top and samples the
same tokens. An axis that crosses beside stage (expert, seq) runs in
each stage body as it runs without a pipeline; where stage lies inside
the processes beside one that crosses, every stage is this process's.
With a data axis inside the processes a stage's process is the same in
every data group, and each stage body runs every group's rows on this
process's devices of it (`Mesh.data_devices`).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from butterfly_tpu_torch.core.config import ModelConfig
from butterfly_tpu_torch.core.mesh import (Mesh, crossing_owners, mesh_ctx,
                                           process_index, stage_degree,
                                           stage_devices)
from butterfly_tpu_torch.models.common import (
    KVCache, _take_rows, embed_tokens, final_logits, forward, make_mask,
    scan_layers)
from butterfly_tpu_torch.parallel.partition import (Shards, axis_parts,
                                                    held_part, local_stages,
                                                    stack_stages)
from butterfly_tpu_torch.parallel.tensor import (broadcast_from, cat_groups,
                                                 exchange, group_part,
                                                 run_groups)


def pipeline_forward(params, cfg: ModelConfig, tokens, cache: KVCache,
                     mesh: Mesh, num_microbatches: Optional[int] = None,
                     positions=None, fresh: bool = False,
                     virtual_stages: int = 1,
                     last_index=None) -> Tuple[Any, KVCache]:
    """Full forward with the layer stack pipelined over `stage`.

    Requires cfg.num_layers % S == 0 and batch % num_microbatches == 0;
    with virtual_stages V > 1 also cfg.num_layers % (S*V) == 0 and
    M >= S (a wrapped activation must reach stage 0 before its tick),
    the weights and the cache in interleaved layer order. S == 1 is the
    plain forward. `last_index` [B] runs the LM head on that row only
    ([B,1,V]), as forward does. Returns (logits [B,T,V] float32, cache
    with length + T); the cache is written in place."""
    S = stage_degree(mesh)
    B, T = tokens.shape
    if positions is None:
        positions = cache.length.long()[:, None] \
            + torch.arange(T, device=tokens.device)[None, :]
    if S == 1:
        with mesh_ctx(mesh):
            return forward(params, cfg, tokens, cache, positions,
                           fresh=fresh, last_index=last_index)
    M = num_microbatches or _default_microbatches(B, S)
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    if cfg.num_layers % S != 0:
        raise ValueError(f"{cfg.num_layers} layers not divisible by {S} stages")
    V = virtual_stages
    if V > 1:
        if cfg.num_layers % (S * V) != 0:
            raise ValueError(f"{cfg.num_layers} layers not divisible by "
                             f"{S} stages x {V} virtual chunks")
        if M < S:
            raise ValueError(
                f"interleaved schedule needs microbatches >= stages "
                f"({M} < {S}): a wrapped activation produced at tick "
                f"t reaches stage 0 at t+1 but is consumed at t+M-S+1")
    top = _top(params)
    x, cos, sin = embed_tokens(top, cfg, tokens, positions)
    mask = make_mask(positions, cache.max_seq)
    y = _pipeline_body(params["layers"], (cache.k, cache.v, cache.k_scale,
                                          cache.v_scale), x, positions,
                       mask, cos, sin, cfg=cfg, mesh=mesh, M=M, V=V,
                       fresh=fresh)
    y = _last_output(y, x, mesh, tokens.device, last_index)
    logits = final_logits(top, cfg, y)
    return logits, cache._replace(length=(cache.length + T).to(torch.int32))


def interleave_layers(tree, num_layers: int, S: int, V: int,
                      inverse: bool = False):
    """Permute stacked-L leaves into (or back out of) interleaved order:
    stage s's contiguous [L/S] block holds the round-robin chunks v*S + s
    for v in 0..V-1, so a stage split of the permuted stack gives each
    stage exactly its chunks. Leaves whose leading dim != num_layers are
    passed through. A copy (index_select); engine/engine.py places the
    chunks as views instead."""
    order = _interleaved_order(num_layers, S, V)
    if inverse:
        inv = np.empty_like(order)
        inv[order] = np.arange(num_layers)
        order = inv

    def perm(a):
        if isinstance(a, dict):
            return {k: perm(v) for k, v in a.items()}
        if isinstance(a, torch.Tensor) and a.dim() >= 1 \
                and a.shape[0] == num_layers:
            return a.index_select(0, torch.as_tensor(order, device=a.device))
        return a
    return perm(tree)


def _interleaved_order(num_layers: int, S: int, V: int) -> np.ndarray:
    Lc = num_layers // (S * V)
    return np.asarray([(v * S + s) * Lc + i
                       for s in range(S) for v in range(V)
                       for i in range(Lc)])


def paged_pipeline_forward(params, cfg: ModelConfig, tokens, cache,
                           positions=None, active=None,
                           use_kernel: bool = False, fresh: bool = False,
                           last_index=None, *, mesh: Mesh,
                           num_microbatches: Optional[int] = None):
    """paged_forward pipelined over `stage`: [B,T] tokens against the
    page pool, the layer stack and the pools' L dim split over the
    stages, microbatches of slots flowing through the GPipe schedule. The
    block table and lengths are read by every stage (page ownership is a
    host concept); each stage scatters and gathers only its own layers'
    pages, through the paged kernel on decode steps (use_kernel) and the
    flash kernels on prefill chunks, as paged_forward does. `last_index`
    [B] runs the LM head on that row only ([B,1,V]), as paged_forward
    does. No attn_mask: the tree verify does not run under stage.
    Returns (logits [B,T,V] float32, cache with advanced lengths)."""
    from butterfly_tpu_torch.cache.paged import paged_forward
    S = stage_degree(mesh)
    if S == 1:
        with mesh_ctx(mesh):
            return paged_forward(params, cfg, tokens, cache, positions,
                                 active, use_kernel, fresh, last_index)
    B, T = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = cache.lengths.long()[:, None] \
            + torch.arange(T, device=dev)[None, :]
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    M = num_microbatches or _default_microbatches(B, S)
    if B % M != 0:
        raise ValueError(f"slots {B} not divisible by microbatches {M}")
    if cfg.num_layers % S != 0:
        raise ValueError(f"{cfg.num_layers} layers not divisible by {S} stages")
    top = _top(params)
    x, cos, sin = embed_tokens(top, cfg, tokens, positions)
    mask = make_mask(positions, cache.max_seq) & active[:, None, None]
    y = _paged_pipeline_body(params["layers"], cache, x, positions, mask,
                             cos, sin, active, cfg=cfg, mesh=mesh, M=M,
                             use_kernel=use_kernel, fresh=fresh)
    y = _last_output(y, x, mesh, dev, last_index)
    logits = final_logits(top, cfg, y)
    new_len = torch.where(active, cache.lengths + T, cache.lengths)
    return logits, cache._replace(lengths=new_len.to(torch.int32))


def _top(params):
    """The weights outside the layer stack (embedding, final norm, head)
    as this process holds them (parallel/partition.py:shard_params places
    them over the mesh of its first stage: stage 0's on a mesh of one
    process): the first data group's replica."""
    return group_part({k: v for k, v in params.items() if k != "layers"}, 0)


def _last_output(y, x, mesh: Mesh, dev, last_index):
    """The last stage's output [B,T,D] (its `last_index` rows [B,1,D]
    where those are taken) on `dev` in this process: moved from the last
    stage's device, or, where the stage axis crosses processes,
    broadcast over the stage group by the last stage's process (`y` None
    in the others; `x`, the embedding output, gives the shape and
    dtype)."""
    owners = _stage_owners(mesh)
    if y is not None:
        y = y.to(dev, non_blocking=True)
        if last_index is not None:
            y = _take_rows(y, last_index)
    if owners is None:
        return y
    B, T, D = x.shape
    return broadcast_from(y, owners[-1], (B, 1 if last_index is not None
                                          else T, D), x.dtype, dev,
                          mesh.axis_group("stage"))


def _stage_owners(mesh: Mesh) -> Optional[List[int]]:
    """The process of each stage at this process's coordinates of the
    other axes (the same in every data group: core/mesh.py:
    check_process_mesh) where the stage axis crosses processes, else
    None (every stage this process's)."""
    return crossing_owners(mesh, "stage")


def _chunk(tree, s: int, v: int, S: int, V: int, L: int):
    """Stage s's virtual chunk v (its whole slice when V == 1) of a
    layer-stacked tree: part s*V + v of a Shards over "stage" of S*V
    chunks; rows [v*Lc, (v+1)*Lc) of part s of one of S stage slices;
    rows [(s*V + v)*Lc, ...) of a leaf not split over stages. Views."""
    if isinstance(tree, dict):
        return {k: _chunk(a, s, v, S, V, L) for k, a in tree.items()}
    if tree is None:
        return None
    Lc = L // (S * V)
    if axis_parts(tree, "stage") is None:
        lo = (s * V + v) * Lc
        return tree[lo:lo + Lc]
    if tree.count == S * V:
        return held_part(tree, s * V + v)
    if tree.count != S:
        raise ValueError(f"{tree!r} is split over {tree.count} stages, "
                         f"not {S} (or {S * V} chunks)")
    part = held_part(tree, s)
    return part if V == 1 else part[v * Lc:(v + 1) * Lc]


def _gpipe_schedule(S: int, M: int, xs: Sequence[Any],
                    step_fn: Callable, devices: Sequence[torch.device],
                    V: int = 1, owners: Optional[Sequence[int]] = None
                    ) -> List[Any]:
    """The tick loop shared by every body: V*M + S - 1 ticks, stage s at
    tick t on work w = t - s (chunk w // M of microbatch w % M), bubble
    pairs skipped. `step_fn(s, v, m, inp) -> y` runs stage s's chunk v
    on microbatch m. Stage 0 takes xs[m] for chunk 0; with V > 1 the
    ring wraps: the last stage's chunk-v output waits in stage 0's
    holding buffer for chunk v + 1. An output moves to the next stage's
    device only where it differs. Returns the last stage's final outputs
    [M] on its device.

    `owners` (the process of each stage; None = every stage this
    process's): only this process's stages compute, and a hand-off
    between two processes' stages is a send and a receive, a tick's all
    posted together (`exchange`), tagged with the sending stage, shaped
    and typed like xs[m]. The final outputs are then the last stage's
    process's alone (None in the others)."""
    me = process_index()

    def mine(s):
        return owners is None or owners[s] == me
    outs: List[Any] = [None] * M
    held = {}          # stage 0's holding buffer: microbatch -> state
    prev = {}          # stage -> its output at the previous tick
    for t in range(V * M + S - 1):
        cur = {}
        sends, recvs, keys = [], [], []
        for s in range(S):
            w = t - s
            if not 0 <= w < V * M:
                continue          # a bubble: nothing to compute
            v, m = divmod(w, M)
            y = None
            if mine(s):
                if s > 0:
                    inp = prev.pop(s - 1)
                else:
                    inp = xs[m] if v == 0 else held.pop(m)
                y = step_fn(s, v, m, inp.to(devices[s], non_blocking=True))
            if s == S - 1 and v == V - 1:
                outs[m] = y
                continue
            dst = s + 1 if s < S - 1 else 0       # 0: the interleaved wrap
            if mine(s) and mine(dst):
                if s < S - 1:
                    cur[s] = y
                else:
                    held[m] = y
            elif mine(s):
                if y.shape != xs[m].shape or y.dtype != xs[m].dtype:
                    raise ValueError(
                        f"stage {s} gave {tuple(y.shape)} {y.dtype}; its "
                        f"receiver expects {tuple(xs[m].shape)} "
                        f"{xs[m].dtype}")
                sends.append((y, owners[dst], s))
            elif mine(dst):
                recvs.append((xs[m].shape, xs[m].dtype, devices[dst],
                              owners[s], s))
                keys.append((s, m))
        for (s, m), got in zip(keys, exchange(sends, recvs)):
            if s < S - 1:
                cur[s] = got
            else:
                held[m] = got
        prev = cur
    return outs


def _microbatch_ops(M: int, *ops):
    """Each [B, ...] op as M views of mb rows."""
    return [[None if a is None else a[m * (a.shape[0] // M):
                                      (m + 1) * (a.shape[0] // M)]
             for a in ops] for m in range(M)]


def _cat_out(outs: Sequence[Any]):
    """The microbatches' final outputs as one batch (None where another
    process holds the last stage)."""
    if outs[0] is None:
        return None
    return outs[0] if len(outs) == 1 else torch.cat(list(outs), dim=0)


def _pipeline_body(layers, cache_ops, x, positions, mask, cos, sin, *,
                   cfg: ModelConfig, mesh: Mesh, M: int, V: int = 1,
                   fresh: bool = False):
    """GPipe over the contiguous cache: stage s runs its layers
    (scan_layers, the cache written in place) on microbatch m's rows;
    with V > 1 the interleaved schedule, stage s's chunk v on work unit
    v*M + m, its cache slice split into V chunk views like its layers.
    `cache_ops` is (k, v, k_scale, v_scale), the scales None unless
    int8. Returns the last stage's output [B,T,D] on its device."""
    S = stage_degree(mesh)
    L = cfg.num_layers
    Lc = L // (S * V)
    ccfg = cfg.replace(num_layers=Lc)
    subs = [mesh.stage_mesh(s) for s in range(S)]
    mb = x.shape[0] // M
    per_mb = _microbatch_ops(M, x, positions, mask, cos, sin)

    def step(s, v, m, inp):
        lyr = _chunk(layers, s, v, S, V, L)
        kv = [_chunk(a, s, v, S, V, L) for a in cache_ops]
        _, pos, msk, c, sn = per_mb[m]
        with mesh_ctx(subs[s]):
            return _stage_layers(lyr, kv, ccfg, inp, m * mb, pos, msk, c,
                                 sn, fresh, subs[s])
    return _cat_out(_gpipe_schedule(S, M, [o[0] for o in per_mb], step,
                                    stage_devices(mesh), V,
                                    _stage_owners(mesh)))


def _row_segments(leaf, lo: int, hi: int) -> List[Tuple[int, int, int]]:
    """(data group d, first row, end row) of the batch rows [lo, hi) each
    data group of a cache leaf holds (one group, 0, when the leaf is not
    split over data)."""
    parts = axis_parts(leaf, "data")
    if parts is None:
        return [(0, lo, hi)]
    n = parts[0].shape[1]
    return [(d, max(lo, d * n), min(hi, (d + 1) * n))
            for d in range(len(parts)) if max(lo, d * n) < min(hi, (d + 1) * n)]


def _rows(leaf, d: int, a: int, b: int):
    """Batch rows [a, b) of a cache leaf [L, B, ...] (views), from data
    group d's part when it is split over data."""
    if leaf is None:
        return None
    parts = axis_parts(leaf, "data")
    if parts is None:
        return leaf[:, a:b]
    n = parts[0].shape[1]
    return parts[d][:, a - d * n:b - d * n]


def _stage_layers(layers, kv, cfg: ModelConfig, x, row0: int, positions,
                  mask, cos, sin, fresh: bool, mesh: Mesh):
    """One stage's layers (`cfg.num_layers` of them) on the microbatch
    whose first batch row is `row0`, against its rows of the stage's
    cache slice `kv` (k, v, k_scale, v_scale), written in place. Under a
    data axis each data group runs the rows it holds on its own devices,
    one GroupRun over the microbatch (an expert a2a inside pools its
    capacity over the microbatch's rows, as the JAX stage body, manual
    over `stage` alone, does). Returns the output on the mesh's first
    device."""
    devs = mesh.data_devices()

    def group(seg):
        d, a, b = seg
        dev = devs[d]
        sl = slice(a - row0, b - row0)

        def at(t):
            return t[sl].to(dev, non_blocking=True)
        k, v, ks, vs = (_rows(t, d, a, b) for t in kv)
        return scan_layers({"layers": group_part(layers, d)}, cfg, at(x), k,
                           v, at(positions), at(mask), at(cos), at(sin),
                           fresh, ks, vs)[0]
    return cat_groups(run_groups(
        _row_segments(kv[0], row0, row0 + x.shape[0]), group, x.shape[0]))


def _paged_pipeline_body(layers, cache, x, positions, mask, cos, sin,
                         active, *, cfg: ModelConfig, mesh: Mesh, M: int,
                         use_kernel: bool, fresh: bool):
    """GPipe over the paged pool: stage s runs its layers against its
    slice of the pools (cache/paged.py:paged_stage_layers, data groups
    over the stage's own mesh) on microbatch m's slots, their block-table
    rows and lengths. Returns the last stage's output [B,T,D] on its
    device."""
    from butterfly_tpu_torch.cache.paged import paged_stage_layers
    S = stage_degree(mesh)
    L = cfg.num_layers
    subs = [mesh.stage_mesh(s) for s in range(S)]
    pools = (cache.k_pages, cache.v_pages, cache.k_scale_pages,
             cache.v_scale_pages)
    per_mb = _microbatch_ops(M, x, cache.page_table, cache.lengths,
                             positions, mask, cos, sin, active)

    def step(s, v, m, inp):
        _, table, lens, pos, msk, c, sn, act = per_mb[m]
        kp, vp, ksp, vsp = (_chunk(a, s, 0, S, 1, L) for a in pools)
        with mesh_ctx(subs[s]):
            return paged_stage_layers(
                _chunk(layers, s, 0, S, 1, L), cfg, inp,
                cache._replace(k_pages=kp, v_pages=vp, k_scale_pages=ksp,
                               v_scale_pages=vsp, page_table=table,
                               lengths=lens),
                pos, msk, c, sn, act, use_kernel, fresh, subs[s])
    return _cat_out(_gpipe_schedule(S, M, [o[0] for o in per_mb], step,
                                    stage_devices(mesh),
                                    owners=_stage_owners(mesh)))


def _default_microbatches(B: int, S: int) -> int:
    """Largest divisor of B that is <= 2*S (keeps the bubble small without
    violating B % M == 0 for any batch size)."""
    best = 1
    for m in range(1, min(B, 2 * S) + 1):
        if B % m == 0:
            best = m
    return best


def stage_layer_views(layers, cfg: ModelConfig, mesh: Mesh, V: int):
    """The layer stack placed for the interleaved schedule: a Shards over
    "stage" of S*V chunks in interleaved order, chunk v of stage s the
    stack's layers [(v*S + s)*Lc, ...) placed over stage s's mesh. From
    the stack in natural order (plain leaves, or the S stage slices of
    parallel/partition.py:shard_params): views where a chunk already
    sits on its stage's devices, else moved there. Where the stage axis
    crosses processes each places its own stages' chunks, from plain
    leaves or from natural slices it holds itself (another process's
    slice raises ValueError: pass the plain tree)."""
    from butterfly_tpu_torch.parallel.partition import shard_params
    S = stage_degree(mesh)
    L = cfg.num_layers
    Lc = L // (S * V)
    ccfg = cfg.replace(num_layers=Lc)
    subs = [mesh.stage_mesh(s) for s in range(S)]
    mine = local_stages(mesh)
    chunks = []
    for s in mine:
        for v in range(V):
            g = v * S + s                     # the chunk in natural order
            natural = _chunk(layers, g // V, g % V, S, V, L)
            if _any_placed(natural):
                src = subs[g // V].devices.reshape(-1)
                moved = dict(zip(map(str, src),
                                 subs[s].devices.reshape(-1)))
                chunks.append(_move(natural, moved))
            else:
                chunks.append(shard_params({"layers": natural}, ccfg,
                                           subs[s])["layers"])
    return stack_stages(chunks, mine[0] * V, S * V)


def _any_placed(tree) -> bool:
    if isinstance(tree, dict):
        return any(_any_placed(v) for v in tree.values())
    return isinstance(tree, Shards)


def _move(tree, moved: dict):
    """Every tensor of a (placed) tree on the device `moved` maps its
    device to (the tensor itself where that is its device)."""
    if isinstance(tree, dict):
        return {k: _move(v, moved) for k, v in tree.items()}
    if isinstance(tree, Shards):
        return Shards([_move(p, moved) for p in tree.parts], tree.axis,
                      tree.split)
    if tree is None:
        return None
    return tree.to(moved.get(str(tree.device), tree.device))
