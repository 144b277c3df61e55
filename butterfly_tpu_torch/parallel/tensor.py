"""Tensor and data parallelism, single-controller: the per-shard math.

What GSPMD derives from the specs of parallel/partition.py in the JAX
package, written out. ONE process runs every shard's work in shard
order, each on the device its operands live on (a no-op move where the
shards share a card):

* `tmap` runs an unsharded function once per tensor shard on each
  shard's parts (the K/V writes, the pool gathers, the window staging);
* `sharded_einsum` is the Megatron matmul: a weight split on an output
  dim (column-parallel) gives per-shard outputs that stay split; a
  weight split on a contracted dim (row-parallel) contracts each shard's
  slice of the input and the partials are summed by `all_reduce`;
* `over_heads` runs an attention function per shard on its q heads and
  its own K/V, or, where the K/V is one replicated tensor (Kv does not
  divide the tensor axis), once over every head, each shard then taking
  its heads' rows;
* `embed_lookup` / `gather` are the vocab-split embedding (each shard
  looks up its vocab range, zeros elsewhere, summed) and the vocab-split
  logits (concatenated in shard order).

The reduction: `all_reduce` sums the partials in shard order, in float32,
and rounds once to the partials' dtype (bf16 on the card, so two bf16
partials are summed as a GEMM accumulates, not in bf16). A relaunch gives
the same bits. The sum lands on shard 0's device, which is every shard's
device on one card; each shard reads it from there.

On a mesh over several processes (core/mesh.py) a tensor Shards holds
only this process's shards (`Shards.distributed`) and every process runs
the same calls in the same order (SPMD): `tmap` and the matmuls run the
local shards; `all_reduce` sums the local partials in float32, then
all-reduces that sum over the job (torch.distributed, in float32), then
rounds once, so two shards give the single-process sum's bits in every
process; `gather` all-gathers the local blocks in shard order. Results
land on the process's first device. Every process then holds the same
activations and logits, and samples the same tokens.

The collectives of the other axes that may cross processes live here
too, beside `all_reduce`: `exchange` (the pipeline's activation
hand-offs, point-to-point sends and receives posted together),
`broadcast_from` (the last stage's output to every process),
`all_to_all_blocks` (the expert dispatch) and `all_gather_cat` (the
expert outputs in expert order). Gloo's send and receive take host
memory only (on an H100 a card tensor fails them: "writev ... Bad
address"), so `exchange` stages a card tensor through a pinned host
buffer (`_to_host`), in this one place; gloo's all-reduce, all-gather,
broadcast and all-to-all take card tensors as they are.
A collective that fails, or a process out of step, raises (the group's
timeout bounds every wait): nothing falls back.

The data axis splits batch rows and slots into `data_groups`; the
forwards (models/common.py, cache/paged.py) run each group's rows
against its parts (`group_part`, `group_rows`) and concatenate the
results in group order.
"""
from __future__ import annotations

import contextvars
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import torch

from butterfly_tpu_torch.core.mesh import active_mesh, data_degree
from butterfly_tpu_torch.parallel.partition import Shards, axis_parts
from butterfly_tpu_torch.quant.int8 import is_quantized_leaf, qeinsum


def _shards_in(args) -> Optional[Shards]:
    for a in args:
        if isinstance(a, Shards) and a.axis == "tensor":
            return a
    return None


def _restack(outs: list, like: Shards, split: Optional[int]):
    o = outs[0]
    if isinstance(o, tuple):
        return tuple(_restack([x[j] for x in outs], like, split)
                     for j in range(len(o)))
    if o is None or not isinstance(o, torch.Tensor):
        return o
    return like.like(outs, split)


def _across(x: Any):
    """The process group a tensor Shards' reduction crosses (the whole
    job) when other processes hold some of its shards, else None."""
    if isinstance(x, Shards) and x.distributed:
        return torch.distributed.group.WORLD
    return None


def tmap(fn: Callable, *args, out_split: Optional[int] = None, **kw):
    """fn(*args, **kw) once per tensor shard: a tensor Shards argument
    gives its part i, any other tensor is read on part i's device. With no
    Shards argument, one plain call. Tensor results come back as Shards
    (split `out_split`, default the first Shards argument's); tuples of
    results as tuples of Shards."""
    first = _shards_in(list(args) + list(kw.values()))
    if first is None:
        return fn(*args, **kw)
    n = len(first.parts)
    outs = []
    for i in range(n):
        dev = first.parts[i].device

        def pick(a):
            if isinstance(a, Shards):
                if a.axis != "tensor" or len(a.parts) != n:
                    raise ValueError(f"{a!r} is not split like {first!r}")
                return a.parts[i]
            if isinstance(a, torch.Tensor):
                return a.to(dev, non_blocking=True)
            return a
        outs.append(fn(*map(pick, args),
                       **{k: pick(v) for k, v in kw.items()}))
    return _restack(outs, first, first.split if out_split is None
                    else out_split)


def all_reduce(parts: Sequence[torch.Tensor], across=None) -> torch.Tensor:
    """The sum of per-shard partials, in shard order, in float32, rounded
    once to the partials' dtype, on shard 0's device. With `across` (a
    process group: the partials are this process's, other processes hold
    the rest) the local float32 sum is all-reduced over it before the
    rounding."""
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.to(acc.device, non_blocking=True).float()
    if across is not None:
        torch.distributed.all_reduce(acc, group=across)
    return acc.to(parts[0].dtype)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """`t` in host memory, contiguous: a card tensor through a pinned
    buffer (the copy waits for the card), a host tensor as it is."""
    t = t.contiguous()
    if t.device.type == "cpu":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _host_buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    """An empty host buffer a receive lands in (pinned when the data goes
    on to a card)."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=torch.device(device).type == "cuda")


def exchange(sends: Sequence[tuple], recvs: Sequence[tuple]
             ) -> List[torch.Tensor]:
    """One round of point-to-point transfers between processes, every
    send and receive posted at once (torch.distributed.batch_isend_irecv)
    and waited for: two processes that send each other in the same round
    do not deadlock, as blocking sends would. `sends` are (tensor, dst
    process, tag); `recvs` (shape, dtype, device, src process, tag), each
    matched by the peer's send of the same tag. Returns the received
    tensors on their devices, in `recvs` order."""
    dist = torch.distributed
    ops, bufs = [], []
    for t, dst, tag in sends:
        ops.append(dist.P2POp(dist.isend, _to_host(t), dst, tag=tag))
    for shape, dtype, dev, src, tag in recvs:
        buf = _host_buffer(shape, dtype, dev)
        bufs.append((buf, dev))
        ops.append(dist.P2POp(dist.irecv, buf, src, tag=tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(dev, non_blocking=True) for b, dev in bufs]


def broadcast_from(t: Optional[torch.Tensor], src: int, shape, dtype,
                   device: torch.device) -> torch.Tensor:
    """Process `src`'s tensor `t` in every process (`t` None elsewhere:
    a buffer of `shape` and `dtype` on `device` takes it)."""
    if t is None:
        t = torch.empty(shape, dtype=dtype, device=device)
    else:
        t = t.contiguous()
    torch.distributed.broadcast(t, src=src)
    return t


def all_to_all_blocks(send: torch.Tensor) -> torch.Tensor:
    """The all-to-all over the job: `send` [P, ...] holds block p for
    process p; the result [P, ...] holds process p's block for this
    one, in process order."""
    send = send.contiguous()
    out = torch.empty_like(send)
    torch.distributed.all_to_all_single(out, send)
    return out


def all_gather_cat(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Every process's `t` (equal shapes) concatenated along `dim` in
    process order, in every process."""
    t = t.contiguous()
    blocks = [torch.empty_like(t)
              for _ in range(torch.distributed.get_world_size())]
    torch.distributed.all_gather(blocks, t)
    return torch.cat(blocks, dim=dim)


def gather(x: Any, dim: int) -> torch.Tensor:
    """A tensor Shards concatenated along `dim` in shard order on shard
    0's device (a plain tensor as it is); a distributed one's local block
    all-gathered over the job, in shard order, on this process's
    device."""
    parts = axis_parts(x, "tensor")
    if parts is None:
        return x
    dev = parts[0].device
    out = torch.cat([p.to(dev, non_blocking=True) for p in parts], dim=dim)
    if _across(x) is None:
        return out
    return all_gather_cat(out, dim)


def _weight_part(w: Any, i: int):
    if is_quantized_leaf(w):
        s = w["s"]
        return {"q8": w["q8"].parts[i],
                "s": s.parts[i] if isinstance(s, Shards) else s}
    return w.parts[i]


def _part_einsum(spec: str, x: torch.Tensor, w: Any, dtype) -> torch.Tensor:
    """qeinsum(spec, x, w) for one shard's part. A spec that contracts
    x's trailing letters against w's leading ones ("btd,dnh->btnh",
    "btnh,nhd->btd", ...) runs as one matmul over 2-D views: a column
    slice of a weight ([D, n, H] of [D, Nq, H]) is a row-strided matrix
    the GEMM reads in place, where torch.einsum would copy it into a
    contiguous batch operand at every call. Other specs (the MoE
    experts') go to qeinsum."""
    ins, out = spec.split("->")
    xs, ws = ins.split(",")
    n = (len(xs) + len(ws) - len(out)) // 2       # contracted letters
    if n < 1 or xs[-n:] != ws[:n] or out != xs[:-n] + ws[n:]:
        return qeinsum(spec, x, w, dtype)
    dtype = dtype or x.dtype
    quant = is_quantized_leaf(w)
    wt = w["q8"].to(dtype) if quant else w.to(dtype)
    k = 1
    for d in wt.shape[:n]:
        k *= d
    y = x.reshape(-1, k) @ wt.reshape(k, -1)
    if quant:
        y = y * w["s"].to(dtype).reshape(1, -1)
    return y.reshape(*x.shape[:-n], *wt.shape[n:])


def sharded_einsum(spec: str, x: Any, w: Any, dtype=None):
    """einsum(spec, x, W) (quant/int8.py:qeinsum, int8 leaves included)
    for a W split over the tensor axis. Split on an output letter
    (column-parallel): each shard's output, a Shards split there. Split on
    a contracted letter (row-parallel): each shard contracts its slice of
    x (x's own parts when x is split) and `all_reduce` sums the partials.
    A W that is not split is one plain call."""
    wq = w["q8"] if is_quantized_leaf(w) else w
    if axis_parts(wq, "tensor") is None:
        if isinstance(x, Shards):
            raise ValueError(f"{spec}: a split input needs a split weight")
        return qeinsum(spec, x, w, dtype)
    ins, out = spec.split("->")
    xs, ws = ins.split(",")
    letter = ws[wq.split]
    n = len(wq.parts)
    devs = [p.device for p in wq.parts]
    if letter in out:
        if isinstance(x, Shards):
            raise ValueError(f"{spec}: a column-parallel input must be "
                             "replicated")
        return wq.like([_part_einsum(spec, x.to(devs[i], non_blocking=True),
                                     _weight_part(w, i), dtype)
                        for i in range(n)], out.index(letter))
    if isinstance(x, Shards):
        xparts = x.parts
    else:
        sizes = [p.shape[wq.split] for p in wq.parts]
        xdim = xs.index(letter)
        if wq.distributed:     # this process's columns of x
            x = x.narrow(xdim, wq.offset * sizes[0], sum(sizes))
        xparts = torch.split(x, sizes, dim=xdim)
    return all_reduce([_part_einsum(spec, xparts[i].to(devs[i],
                                                        non_blocking=True),
                                    _weight_part(w, i), dtype)
                       for i in range(n)], _across(wq))


def over_heads(fn: Callable, q: Any, *rest, **kw):
    """An attention function fn(q, *rest, **kw) -> out (or a tuple led by
    out), out laid out like q, over the tensor shards of q's heads: with
    split K/V operands each shard calls fn on its q heads and its own
    K/V; with replicated K/V (Kv does not divide the tensor axis) fn runs
    once over every head and each shard takes its heads' rows. A plain q
    is one plain call."""
    if not isinstance(q, Shards):
        return fn(q, *rest, **kw)
    if _shards_in(list(rest) + list(kw.values())) is not None:
        return tmap(fn, q, *rest, **kw)
    dim = q.split
    res = fn(gather(q, dim), *rest, **kw)
    out = res[0] if isinstance(res, tuple) else res
    sizes = [p.shape[dim] for p in q.parts]
    if q.distributed:          # this process's heads
        out = out.narrow(dim, q.offset * sizes[0], sum(sizes))
    split = q.like([o.to(p.device, non_blocking=True) for o, p in
                    zip(torch.split(out, sizes, dim=dim), q.parts)])
    return (split,) + tuple(res[1:]) if isinstance(res, tuple) else split


def embed_lookup(tok: Any, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows `tokens` of the [V, D] embedding in `dtype`. Split over the
    vocab, each shard looks up the ids in its range and gives zeros
    elsewhere; `all_reduce` sums the shards."""
    parts = axis_parts(tok, "tensor")
    if parts is None:
        return tok.to(dtype)[tokens]
    outs, lo = [], tok.offset * parts[0].shape[0]
    for w in parts:
        n = w.shape[0]
        ids = tokens.to(w.device, non_blocking=True) - lo
        hit = (ids >= 0) & (ids < n)
        e = w.to(dtype)[ids.clamp(0, n - 1)]
        outs.append(torch.where(hit[..., None], e, torch.zeros(
            (), dtype=e.dtype, device=e.device)))
        lo += n
    return all_reduce(outs, _across(tok))


# ---------------------------------------------------------------------------
# The data axis
# ---------------------------------------------------------------------------

class DataGroup(NamedTuple):
    index: int              # the data coordinate
    rows: slice             # its rows of the batch / slot dim
    device: torch.device    # its first device


def data_groups(batch: int, mesh=None) -> Optional[List[DataGroup]]:
    """The data groups of `mesh` (None = the active mesh) over a
    `batch`-row dim, or None without a data axis. Rows that do not
    divide by the data size run as one group, group 0 (the JAX rule
    `_div`: the dim stays replicated)."""
    mesh = active_mesh() if mesh is None else mesh
    D = data_degree(mesh)
    if D <= 1:
        return None
    devs = mesh.data_devices()
    if batch % D:
        return [DataGroup(0, slice(0, batch), devs[0])]
    n = batch // D
    return [DataGroup(d, slice(d * n, (d + 1) * n), devs[d])
            for d in range(D)]


class GroupRun:
    """One forward's data groups, run one after another over a batch of
    `batch` rows. What the JAX package computes over the whole batch
    inside a body manual over another axis (the expert a2a's capacity and
    counting sort, parallel/expert.py) reads it: `carry[c]` is what the
    groups run so far left for the c-th such call of the layer stack,
    `call` the running group's next call index."""

    def __init__(self, batch: int):
        self.batch = batch
        self.carry: List[Any] = []
        self.call = 0

    def next_call(self) -> int:
        c = self.call
        self.call += 1
        return c


_RUN: contextvars.ContextVar[Optional[GroupRun]] = \
    contextvars.ContextVar("butterfly_group_run", default=None)


def group_run() -> Optional[GroupRun]:
    """The GroupRun of the data-group loop running now, else None."""
    return _RUN.get()


def run_groups(groups: Sequence[DataGroup], fn: Callable, batch: int
               ) -> list:
    """[fn(g) for g in groups], in group order, as one GroupRun over the
    whole `batch`."""
    run = GroupRun(batch)
    token = _RUN.set(run)
    try:
        outs = []
        for g in groups:
            run.call = 0
            outs.append(fn(g))
        return outs
    finally:
        _RUN.reset(token)


def group_part(x: Any, d: int) -> Any:
    """Data group d's replica of a tree or leaf: part d of every data
    Shards, anything else (shared by every group) as it is."""
    if isinstance(x, dict):
        return {k: group_part(v, d) for k, v in x.items()}
    if isinstance(x, Shards) and x.axis == "data":
        return x.parts[d]
    return x


def group_rows(x: Any, g: DataGroup, dim: int = 0,
               inplace: bool = False) -> Any:
    """Group g's rows along `dim` of a batch- or slot-indexed value: its
    part of a data Shards; rows of a tensor Shards as views of each part;
    rows of a tensor as a view, read on the group's device. `inplace`
    (state the group writes): a value that is not split over data must
    already be on the group's device, so the view is the state itself.
    None stays None."""
    if x is None:
        return None
    idx = (slice(None),) * dim + (g.rows,)
    if isinstance(x, Shards) and x.axis == "data":
        part = x.parts[g.index]
        if part.shape[dim] != g.rows.stop - g.rows.start:
            raise ValueError(f"{x!r}: rows {g.rows} do not split over the "
                             "data groups")
        return part
    if inplace and x.device != g.device:
        raise ValueError(f"state on {x.device} written by the data group "
                         f"on {g.device}: split it over the data axis "
                         "(parallel/partition.py)")
    if isinstance(x, Shards):
        return x[idx]
    return x[idx].to(g.device, non_blocking=True)


def cat_groups(outs: Sequence[Any], dim: int = 0) -> Any:
    """Per-group results concatenated along `dim` on group 0's device
    (tuples element-wise, None stays None)."""
    o = outs[0]
    if isinstance(o, tuple):
        return tuple(cat_groups([x[j] for x in outs], dim)
                     for j in range(len(o)))
    if o is None:
        return None
    if len(outs) == 1:
        return o
    if isinstance(o, Shards):
        return o.like([cat_groups([x.parts[i] for x in outs], dim)
                       for i in range(len(o.parts))])
    dev = o.device
    return torch.cat([x.to(dev, non_blocking=True) for x in outs], dim=dim)
