"""Expert parallelism: GShard-style capacity-based MoE dispatch and
combine, in PyTorch, on the single-controller mesh.

The counterpart of butterfly_tpu/parallel/expert.py, with its two
dispatch paths and its routing rule (`moe_block_ep`):

* **Counting sort + all_to_all** (`_moe_ep_a2a`, prefill): the tokens are
  split over the `expert` axis along the sequence; each source shard i,
  in shard order and on its device, routes its chunk and counting-sorts
  its (token, k) assignments into a send buffer [N, ne, C, D]. The
  all_to_all is the block transpose `recv_j[i] = send_i[j]`, each block
  moved with `.to(device_j, non_blocking=True)` (a no-op when the shards
  share a card). Shard j runs its ne experts over [ne, N*C, D], the
  reverse exchange brings each block home, and each source gathers its
  assignments' outputs and sums them over k with their gates.
* **One-hot einsum dispatch** (`_moe_ep_einsum`): decode steps and the
  shapes the sequence split does not divide. Dispatch and combine are
  einsums with one-hot slot tensors; the experts run where each shard's
  weights live (models/common.py:expert_swiglu).

Under expert x data each data group runs its rows (models/common.py,
cache/paged.py), but the a2a path's capacity and counting sort are the
whole batch's, as in the JAX body, which is manual over `expert` alone:
a group's slots continue the per-expert counts the groups before it
left (parallel/tensor.py:GroupRun), so the same assignments drop. Under
expert x tensor each expert shard's weights are split over F
(parallel/partition.py): its SwiGLU runs column-parallel on gate/up and
row-parallel on down (models/common.py:expert_swiglu).

The mesh comes from the active mesh (core/mesh.py:mesh_ctx), which the
engines enter around their forwards, as the JAX function reads the
abstract mesh; the dispatch runs over the devices the expert parts lie
on. Inside a seq shard (parallel/sequence.py) the active mesh is the
shard's own, `Mesh.seq_mesh(i)`, and the a2a splits the shard's chunk
over its expert shards; inside a pipeline stage (parallel/pipeline.py)
it is the stage's, `Mesh.stage_mesh(s)`, and the a2a splits the stage's
prefill microbatch. Either way the capacity is pooled per source chunk
of the tokens the dispatch sees, as JAX's body, manual over `expert`
inside a body manual over `seq` or `stage`, pools it. The expert
weights may be split over the shards (parallel/partition.py:
shard_params) or plain tensors (each shard then takes a view of its
experts).

On a mesh whose expert axis crosses processes (core/mesh.py: each
process a run of consecutive expert shards) the router and every leaf
outside the experts are replicated in every process, and each process
holds only its own shards' experts. The a2a path then routes the
chunks of its own source shards, the exchange and its return are one
all-to-all each way over the job (parallel/tensor.py:all_to_all_blocks,
blocks in shard order), its experts run between them, and the output
chunks are all-gathered in shard order (the layout JAX's `out_specs`
gives back). The einsum path runs its dispatch whole in every process,
each process its own experts, and all-gathers their outputs in expert
order (models/common.py:expert_swiglu), so its combine has the
one-process run's bits. With a data axis inside the processes each data
group's expert shards lie on the processes alike, and every process runs
every group's exchanges in group order.

Capacity: each expert takes at most C assignments per sequence (einsum
path) or per source shard (a2a path, pooled over the shard's B
sequences); overflow assignments are dropped (their FFN contribution is
zero and the residual passes through). With a capacity large enough that
nothing drops, both paths equal the dense reference
models/common.py:moe_block. Under a dropping capacity each path drops
exactly the assignments its JAX counterpart drops. Inference only: no
load-balancing loss.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from butterfly_tpu_torch.core.config import ModelConfig
from butterfly_tpu_torch.core.mesh import active_mesh, expert_degree
from butterfly_tpu_torch.models.common import (Params, expert_swiglu,
                                               route_tokens)
from butterfly_tpu_torch.parallel.partition import (expert_parts,
                                                    held_experts,
                                                    part_device)
from butterfly_tpu_torch.parallel.tensor import (all_gather_cat,
                                                 all_to_all_blocks,
                                                 group_run)


def expert_capacity(cfg: ModelConfig, tokens_per_seq: int) -> int:
    """Per-sequence per-expert token slots."""
    c = math.ceil(cfg.moe_capacity_factor * cfg.num_experts_per_tok
                  * tokens_per_seq / cfg.num_experts)
    return max(1, min(c, cfg.num_experts_per_tok * tokens_per_seq))


def a2a_capacity(cfg: ModelConfig, batch: int, local_tokens: int,
                 capacity: Optional[int] = None) -> int:
    """The a2a path's pooled per-shard capacity C: the caller's
    per-sequence `capacity` over the shard's `batch` sequences, at most
    every assignment of its chunk (min(capacity*B, k*B*Tl)), else
    expert_capacity over the B*Tl local tokens."""
    if capacity is not None:
        return min(capacity * batch,
                   cfg.num_experts_per_tok * batch * local_tokens)
    return expert_capacity(cfg, batch * local_tokens)


def takes_a2a(x: torch.Tensor, cfg: ModelConfig) -> bool:
    """The routing rule: the a2a path iff the active mesh has an expert
    axis N > 1 that divides both T (> 1) and the expert count."""
    N = expert_degree(active_mesh())
    T = x.shape[1]
    return N > 1 and T > 1 and T % N == 0 and cfg.num_experts % N == 0


def moe_block_ep(x: torch.Tensor, p: Params, cfg: ModelConfig,
                 capacity: Optional[int] = None) -> torch.Tensor:
    """Expert-parallel MoE FFN: dispatch -> expert SwiGLU -> combine.

    x: [B, T, D]; p: one layer's `moe` leaves (router [D, E], w_gate /
    w_up [E, D, F], w_down [E, F, D], plain or split over the shards).
    `capacity` is per-sequence per-expert slots on both paths (the a2a
    path pools it per shard, a2a_capacity). Returns [B, T, D]."""
    if takes_a2a(x, cfg):
        return _moe_ep_a2a(x, p, cfg, expert_degree(active_mesh()),
                           capacity)
    return _moe_ep_einsum(x, p, cfg, capacity)


def _moe_ep_einsum(x: torch.Tensor, p: Params, cfg: ModelConfig,
                   capacity: Optional[int] = None) -> torch.Tensor:
    """One-hot einsum dispatch: expert e takes its assignments in
    (t, k)-priority order per sequence, up to C."""
    B, T, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = capacity or expert_capacity(cfg, T)
    gates, idx = route_tokens(x, p["router"], k)              # [B,T,k]
    emask = F.one_hot(idx, E).to(torch.int32)                  # [B,T,k,E]
    pos = (torch.cumsum(emask.reshape(B, T * k, E), dim=1) - 1) \
        .reshape(B, T, k, E)                                   # slot in expert
    keep = (pos < C) & (emask > 0)                             # overflow drops
    sel = keep.float() * emask.float()
    # slot[b,t,k,e,c] = 1 iff pos == c (no slot for pos -1 or >= C)
    slot = (pos[..., None] == torch.arange(C, device=x.device)).float()
    dispatch = torch.einsum("btke,btkec->btec", sel, slot)
    combine = torch.einsum("btk,btke,btkec->btec", gates, sel, slot)
    xin = torch.einsum("btec,btd->ebcd", dispatch.to(x.dtype), x)
    y = expert_swiglu(xin, p, cfg, "ebcd,edf->ebcf", "ebcf,efd->ebcd")
    return torch.einsum("btec,ebcd->btd", combine.to(y.dtype), y)


def a2a_slots(idx: torch.Tensor, E: int, C: int,
              base: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counting sort of a shard's A = B*Tl*k assignments (expert ids
    `idx` [B, Tl, k], in (b, t, k) order) by expert: (dest [A], keep [A]).
    An assignment's slot is its rank among the earlier assignments to its
    expert, counted from `base[e]` (the assignments to expert e of the
    rows before these: the data groups run before this one) or 0; it is
    kept iff the slot is < C, and then lands at row `expert*C + slot` of
    the [E*C, D] send buffer; a dropped one points one past the end."""
    g = idx.reshape(-1)
    onehot = F.one_hot(g, E).to(torch.int32)                  # [A,E]
    ranks = torch.cumsum(onehot, dim=0) - 1
    if base is not None:
        ranks = ranks + base.to(ranks.dtype)[None, :]
    pos = ranks.gather(1, g[:, None])[:, 0]
    keep = pos < C
    dest = torch.where(keep, g * C + pos, torch.full_like(g, E * C))
    return dest, keep


def dropped_assignments(x: torch.Tensor, router_w: torch.Tensor,
                        cfg: ModelConfig, n_shards: int,
                        capacity: Optional[int] = None) -> torch.Tensor:
    """How many (token, k) assignments of x [B, T, D] the a2a path over
    `n_shards` drops at this capacity (a device scalar): each source
    chunk of T/n_shards tokens over the B rows pooled, as JAX's budget.
    Under seq x expert the chunks are the seq shards' chunks split again
    over the expert shards: n_shards = seq * expert."""
    B, T, _ = x.shape
    Tl = T // n_shards
    C = a2a_capacity(cfg, B, Tl, capacity)
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(n_shards):
        _, idx = route_tokens(x[:, i * Tl:(i + 1) * Tl], router_w,
                              cfg.num_experts_per_tok)
        total = total + (~a2a_slots(idx, cfg.num_experts, C)[1]).sum()
    return total


def _moe_ep_a2a(x: torch.Tensor, p: Params, cfg: ModelConfig, N: int,
                capacity: Optional[int] = None) -> torch.Tensor:
    """Counting sort + all_to_all dispatch over N expert shards."""
    B, T, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    ne, Tl = E // N, T // N
    # a data group's rows are part of the whole batch: its capacity and
    # its counting sort are the whole batch's (JAX's body is manual over
    # `expert` alone, so it sees every row), continued from the counts
    # the groups before it left
    run = group_run()
    C = a2a_capacity(cfg, B if run is None else run.batch, Tl, capacity)
    prior = None
    if run is not None:
        call = run.next_call()
        if call == len(run.carry):
            run.carry.append(None)
        prior = run.carry[call]
    shards = [dict(zip(("w_gate", "w_up", "w_down"), parts)) for parts in
              zip(*(expert_parts(p[w], N)
                    for w in ("w_gate", "w_up", "w_down")))]
    devs = [part_device(s["w_gate"]) for s in shards]
    # this process's shards [first, first + held): every one of the N
    # unless the expert axis crosses processes
    first, held = held_experts(p) if len(shards) < N else (0, N)

    # each source shard routes its chunk and fills its send buffer
    sends: List[torch.Tensor] = []
    metas, counts = [], []
    for i in range(first, first + held):
        dev = devs[i - first]
        xi = x[:, i * Tl:(i + 1) * Tl].to(dev, non_blocking=True)
        gates, idx = route_tokens(
            xi, p["router"].to(dev, non_blocking=True), k)
        base = None if prior is None else prior[i - first].to(dev)
        dest, keep = a2a_slots(idx, E, C, base)
        if run is not None:
            seen = torch.bincount(idx.reshape(-1), minlength=E)
            counts.append(seen if base is None else seen + base)
        x_rep = xi.reshape(B * Tl, D).repeat_interleave(k, dim=0)   # [A,D]
        # one spare row takes the dropped assignments, then goes
        send = torch.zeros((E * C + 1, D), dtype=x.dtype, device=dev)
        send.index_copy_(0, dest, x_rep)
        sends.append(send[:-1].reshape(N, ne, C, D))
        metas.append((dest, keep, gates))

    if run is not None:
        run.carry[call] = counts

    # the all_to_all, then each shard's ne experts over [ne, N*C, D]
    recvs = _exchange_blocks(sends, devs) if held < N else [
        torch.stack([sends[i][j].to(devs[j], non_blocking=True)
                     for i in range(N)]) for j in range(N)]  # [N,ne,C,D]
    ys = []
    for j, recv in enumerate(recvs):
        xin = recv.transpose(0, 1).reshape(ne, N * C, D)
        y = expert_swiglu(xin, shards[j], cfg, "ecd,edf->ecf",
                          "ecf,efd->ecd")
        ys.append(y.reshape(ne, N, C, D).transpose(0, 1))   # block i -> i

    # the reverse all_to_all; gather, gate and sum over k at each source
    backs = _exchange_blocks(ys, devs) if held < N else [
        torch.stack([ys[j][i].to(devs[i], non_blocking=True)
                     for j in range(N)]) for i in range(N)]  # [N,ne,C,D]
    outs = []
    for il, y_back in enumerate(backs):
        y_back = y_back.reshape(E * C, D)
        dest, keep, gates = metas[il]
        y_flat = y_back.index_select(0, dest.clamp(max=E * C - 1))
        y_flat = torch.where(keep[:, None], y_flat,
                             torch.zeros_like(y_flat)).to(x.dtype)
        out = y_flat.reshape(B, Tl, k, D) * gates[..., None].to(x.dtype)
        outs.append(out.sum(dim=2).to(x.device, non_blocking=True))
    out = torch.cat(outs, dim=1)
    # every process's chunks, in shard order
    return all_gather_cat(out, 1) if held < N else out


def _exchange_blocks(blocks: List[torch.Tensor], devs) -> List[torch.Tensor]:
    """The all_to_all across processes: blocks[a][b] ([N, ...] for each
    of this process's `held` shards a) is shard a's block for shard b, of
    N in all; returns, for each of this process's shards b, the [N, ...]
    blocks every shard a sent it, in shard order, on b's device. One
    all-to-all over the job, each process's run of shards in order."""
    held, N = len(blocks), blocks[0].shape[0]
    P = N // held
    rest = tuple(blocks[0].shape[1:])
    mine = torch.stack([b.to(devs[0], non_blocking=True) for b in blocks])
    send = mine.reshape((held, P, held) + rest).transpose(0, 1)
    got = all_to_all_blocks(send.contiguous())      # [P, held(a), held(b)]
    return [got[:, :, b].reshape((N,) + rest).to(devs[b],
                                                 non_blocking=True)
            for b in range(held)]
