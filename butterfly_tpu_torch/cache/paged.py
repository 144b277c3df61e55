"""Paged KV cache: block-table layout for continuous batching, in PyTorch.

The counterpart of butterfly_tpu/cache/paged.py, with the same layouts:

* one page pool per layer stack, k/v_pages [L, P, Kv, page, H]; slots own
  pages through a block table [slots, max_pages] of page ids; page P-1
  is the reserved null page (tables start on it; writes that must not
  land anywhere go there);
* int8 pools (RuntimeConfig.kv_quant="int8") hold codes plus one f32
  scale per stored vector in k/v_scale_pages [L, P, Kv*page], flattened
  kv-major (column kv*page + offset);
* the write-combined decode window (kv_write_combine) stages fresh K/V
  per slot in [L, S, Kv, W, H] (the pool's representation) and flushes
  it into the pool with one scatter per pool tensor at a drain.

Where the JAX package rebuilds an array (.at[].set), the port updates
the pool and the window IN PLACE (write_paged_layer, stage_window_layer,
flush_paged_window each say so): device work is ordered on one stream,
so an in-place write lands after every earlier dispatch that reads it.
Decode steps (T == 1) with use_kernel attend through the paged-attention
kernel (ops/paged_attention.py). Multi-token prefill chunks under
cfg.attn_impl == "flash" attend through the flash kernels
(ops/flash_attention.py): a fresh chunk over its own K/V, a warm chunk
over the gathered pool view as its cached prefix. Everything else gathers
the pool into a dense view and runs models.common.attend.

Under a tensor mesh each pool, scale pool and window is one contiguous
tensor per shard (parallel/partition.py:Shards over the kv heads): the
writes, gathers and flushes run per shard (parallel/tensor.py:tmap) and
the kernels through their sharded wrappers, each shard on its q heads
and its own pool. Under a data mesh the forwards run each data group's
slots against its rows of the block table and its part of the window;
the pool is replicated (any slot may read a page another group wrote:
prefix caching shares pages), shared where the groups share a device,
else one copy per group, and every write reaches every copy.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from butterfly_tpu_torch.core.config import ModelConfig, RuntimeConfig
from butterfly_tpu_torch.core.device import resolve_device
from butterfly_tpu_torch.core.mesh import (active_mesh, data_degree,
                                           stage_degree, tensor_degree)
from butterfly_tpu_torch.models.common import (
    _cast_layer, _dequant_mirror, _take_rows, attend, attn_output,
    embed_tokens, ffn_block, final_logits, layer_params, make_mask, pre_norm,
    qkv_proj, quantize_kv, torch_dtype)
from butterfly_tpu_torch.ops.flash_attention import flash_attention_sharded
from butterfly_tpu_torch.ops.paged_attention import paged_attention_sharded
from butterfly_tpu_torch.parallel.partition import (
    Shards, axis_parts, held_tensor_shards, layers_per_stage, local_stages,
    same_device, stack_stages)
from butterfly_tpu_torch.parallel.tensor import (
    cat_groups, data_groups, group_part, group_rows, over_heads, run_groups,
    tmap)


#: the pool tensors of a PagedKVCache (the scale pools None unless int8)
_POOLS = ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages")


class PagedKVCache(NamedTuple):
    k_pages: torch.Tensor     # [L, P, Kv, page, H] (int8 codes when quantized)
    v_pages: torch.Tensor     # [L, P, Kv, page, H]
    page_table: torch.Tensor  # [slots, max_pages] int32, null = P-1
    lengths: torch.Tensor     # [slots] int32 tokens written per slot
    k_scale_pages: Optional[torch.Tensor] = None  # [L, P, Kv*page] f32 iff int8
    v_scale_pages: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[1]

    @property
    def null_page(self) -> int:
        return self.k_pages.shape[1] - 1

    @property
    def max_seq(self) -> int:
        return self.page_table.shape[1] * self.page_size

    @property
    def num_slots(self) -> int:
        return self.page_table.shape[0]

    @property
    def quantized(self) -> bool:
        return self.k_scale_pages is not None


def init_paged_cache(cfg: ModelConfig, runtime: RuntimeConfig,
                     dtype=None, device=None, mesh=None) -> PagedKVCache:
    """Pool sized from the runtime config (+1 reserved null page), on
    `device` (None = CUDA). kv_quant="int8" allocates int8 code pools +
    f32 scale pools. Under a tensor or data `mesh` the pools are placed
    as parallel/partition.py:shard_paged_cache places them, allocated per
    shard: one contiguous pool per tensor shard (kv heads Kv/t when the
    tensor axis divides Kv), one replica per data group on its own
    devices (shared where the groups share them). Under a stage mesh
    each stage's pools hold its [L/S, ...] layers over its own mesh (a
    Shards over "stage"; on a mesh whose stage axis crosses processes,
    this process's stages alone); the block table and lengths sit on the
    mesh's first device (this process's), host state every process
    keeps alike."""
    if stage_degree(mesh) > 1:
        Ls = layers_per_stage(cfg, mesh)
        mine = local_stages(mesh)     # a process allocates its own stages
        per = [init_paged_cache(cfg.replace(num_layers=Ls), runtime, dtype,
                                sub.first_device, sub)
               for sub in map(mesh.stage_mesh, mine)]
        return per[0]._replace(**{n: stack_stages(
            [getattr(c, n) for c in per], mine[0], stage_degree(mesh))
            for n in _POOLS})
    if tensor_degree(mesh) > 1 or data_degree(mesh) > 1:
        return _init_paged_sharded(cfg, runtime, dtype, mesh)
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    page = runtime.page_size
    max_pages = -(-runtime.max_seq_len // page)
    P = runtime.num_pages or runtime.max_batch_size * max_pages
    P += 1  # null page
    shape = (cfg.num_layers, P, cfg.num_kv_heads, page, cfg.head_dim)
    table = torch.full((runtime.max_batch_size, max_pages), P - 1,
                       dtype=torch.int32, device=dev)
    lengths = torch.zeros((runtime.max_batch_size,), dtype=torch.int32,
                          device=dev)
    if runtime.kv_quant == "int8":
        sshape = (cfg.num_layers, P, cfg.num_kv_heads * page)
        return PagedKVCache(
            k_pages=torch.zeros(shape, dtype=torch.int8, device=dev),
            v_pages=torch.zeros(shape, dtype=torch.int8, device=dev),
            page_table=table, lengths=lengths,
            k_scale_pages=torch.zeros(sshape, dtype=torch.float32,
                                      device=dev),
            v_scale_pages=torch.zeros(sshape, dtype=torch.float32,
                                      device=dev))
    if runtime.kv_quant != "none":
        raise ValueError(f"unknown kv quant {runtime.kv_quant!r}")
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=dev),
        v_pages=torch.zeros(shape, dtype=dtype, device=dev),
        page_table=table, lengths=lengths)


def _init_paged_sharded(cfg: ModelConfig, runtime: RuntimeConfig, dtype,
                        mesh) -> PagedKVCache:
    T = tensor_degree(mesh)
    T = T if cfg.num_kv_heads % T == 0 else 1
    shard_cfg = cfg.replace(num_kv_heads=cfg.num_kv_heads // T)

    def replica(d):
        devs, lo = held_tensor_shards(mesh, d, T)
        return [init_paged_cache(shard_cfg, runtime, dtype, dev)
                for dev in devs], lo
    reps = [replica(0)]
    for d in range(1, data_degree(mesh)):
        if not all(same_device(a, b) for a, b in
                   zip(mesh.tensor_devices(0), mesh.tensor_devices(d))):
            reps.append(replica(d))
    first = reps[0][0][0]
    pools = {}
    for name in ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages"):
        if getattr(first, name) is None:
            pools[name] = None
            continue
        per = [Shards([getattr(c, name) for c in r], "tensor", 2, lo, T)
               if T > 1 else getattr(r[0], name) for r, lo in reps]
        pools[name] = Shards(per, "data", None) if len(per) > 1 else per[0]
    return first._replace(**pools)


def pool_replicas(cache: PagedKVCache) -> list:
    """The cache once per data replica of its pools (one entry where the
    data groups share them): each pool a tensor or a tensor Shards."""
    parts = axis_parts(cache.k_pages, "data")
    if parts is None:
        return [cache]
    return [cache._replace(**{n: group_part(getattr(cache, n), r) for n in
                              ("k_pages", "v_pages", "k_scale_pages",
                               "v_scale_pages")})
            for r in range(len(parts))]


def _page_slots(page_table, pos, page: int, null_page: int, keep=None):
    """(page id, offset) of absolute positions pos [B, T] through the
    block table; positions past the table row, or where `keep` [B, T] is
    False, route to the null page."""
    mp = page_table.shape[1]
    idx = torch.div(pos, page, rounding_mode="floor").clamp(0, mp - 1)
    pid = torch.gather(page_table.long(), 1, idx)
    ok = pos < mp * page
    if keep is not None:
        ok = ok & keep
    pid = torch.where(ok, pid, torch.full_like(pid, null_page))
    return pid.reshape(-1), torch.remainder(pos, page).reshape(-1)


def write_paged_layer(k_pages, v_pages, page_table, k, v, start,
                      active=None, k_scale_pages=None, v_scale_pages=None):
    """Scatter new tokens into one layer's page pool, IN PLACE.

    k_pages/v_pages: [P, Kv, page, H]; k/v: [B, T, Kv, H]; start: [B]
    first absolute position of each slot's new tokens. Inactive slots'
    writes, and positions past the table row, go to the null page.
    Quantized pools quantize per vector on the way in. Returns
    (k_pages, v_pages, k_scale_pages, v_scale_pages) — the same tensors,
    updated; scales None when the pool is float."""
    Pp, Kv, page, H = k_pages.shape
    B, T = k.shape[0], k.shape[1]
    pos = start.long()[:, None] + torch.arange(T, device=k.device)[None, :]
    keep = None if active is None else active[:, None].expand(B, T)
    flat_pages, flat_off = _page_slots(page_table, pos, page, Pp - 1, keep)
    if k_scale_pages is not None:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        k_pages[flat_pages, :, flat_off] = kq.reshape(B * T, Kv, H)
        v_pages[flat_pages, :, flat_off] = vq.reshape(B * T, Kv, H)
        cols = torch.arange(Kv, device=k.device)[None, :] * page \
            + flat_off[:, None]                          # [BT, Kv]
        k_scale_pages[flat_pages[:, None], cols] = ks.reshape(B * T, Kv)
        v_scale_pages[flat_pages[:, None], cols] = vs.reshape(B * T, Kv)
        return k_pages, v_pages, k_scale_pages, v_scale_pages
    k_pages[flat_pages, :, flat_off] = k.reshape(B * T, Kv, H).to(
        k_pages.dtype)
    v_pages[flat_pages, :, flat_off] = v.reshape(B * T, Kv, H).to(
        v_pages.dtype)
    return k_pages, v_pages, None, None


def gather_paged_layer(pages, page_table):
    """One layer's pages -> contiguous [B, S_max, Kv, H] view."""
    Pp, Kv, page, H = pages.shape
    B, mp = page_table.shape
    out = pages[page_table.long()]          # [B, mp, Kv, page, H]
    return out.permute(0, 1, 3, 2, 4).reshape(B, mp * page, Kv, H)


def gather_paged_layer_q(pages, scale_pages, page_table):
    """Quantized gather: codes [B, Kv, S, H] + scales [B, Kv, S] — the
    kv-major order models.common.attend expects for int8 caches."""
    Pp, Kv, page, H = pages.shape
    B, mp = page_table.shape
    tbl = page_table.long()
    codes = pages[tbl].permute(0, 2, 1, 3, 4).reshape(B, Kv, mp * page, H)
    sc = scale_pages[tbl].reshape(B, mp, Kv, page).permute(0, 2, 1, 3)
    return codes, sc.reshape(B, Kv, mp * page)


def _set_run(dst, rows, idx, vals, limit: int, axis: int) -> None:
    """dst[rows, idx] = vals (axis 1) or dst[rows, :, idx] = vals (axis 2),
    IN PLACE, dropping entries whose index is >= limit — jnp's
    mode="drop" without a host sync. rows/idx are [B, N] with each idx
    row a consecutive run; vals is [B, N, ...] in dst's indexed shape.
    A dropped entry is redirected to column limit-1 carrying exactly the
    value that column ends up with (the run's in-range entry there, or
    its current contents), so duplicate indices always agree."""
    B, N = idx.shape
    ar = torch.arange(N, device=idx.device)
    good = (limit - 1 - idx[:, 0]).clamp(0, N - 1)
    src = torch.where(idx < limit, ar[None, :], good[:, None])
    bshape = (B, N) + (1,) * (vals.dim() - 2)
    sel = torch.gather(vals, 1, src.reshape(bshape).expand_as(vals))
    last = torch.full_like(idx[:, :1], limit - 1)
    old = dst[rows[:, :1], last] if axis == 1 else dst[rows[:, :1], :, last]
    full = (idx[:, 0] >= limit).reshape((B, 1) + (1,) * (vals.dim() - 2))
    sel = torch.where(full, old, sel)
    ic = idx.clamp(max=limit - 1)
    if axis == 1:
        dst[rows, ic] = sel
    else:
        dst[rows, :, ic] = sel


# ---------------------------------------------------------------------------
# Write-combined decode window (serving hot path)
#
# The pool is READ-ONLY inside a fused block: fresh K/V stages into a
# small per-slot window [L, S, Kv, W, H], attention reads pool + window,
# and the window flushes into the pool with ONE scatter per pool tensor
# per drain. The window stores the pool's EXACT representation, so the
# flushed pool is byte-identical to the per-token write path's, and the
# dense read path inserts the window entries into the gathered view at
# their absolute positions (element-wise the written view).
# ---------------------------------------------------------------------------


class KVWindow(NamedTuple):
    """Staged-but-unflushed K/V for every slot, all layers: k/v
    [L, S, Kv, W, H] in the pool's representation, k/v_scale [L, S, Kv, W]
    f32 iff quantized. Entry w of slot s sits at absolute position
    lengths[s] + w; a separate win_len [S] counts the valid entries.
    Contents past win_len are stale: masking, never zeroing, keeps them
    out."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def width(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_kv_window(cache: PagedKVCache, width: int, mesh=None) -> KVWindow:
    """Allocate a window of `width` staged tokens per slot, in the pool's
    representation, on the pool's device. Under a tensor or data `mesh`
    it is placed as parallel/partition.py:shard_kv_window places it,
    allocated per shard: each data group's slots, each tensor shard's kv
    heads (the pools' split), one contiguous tensor per (group, shard)."""
    if tensor_degree(mesh) > 1 or data_degree(mesh) > 1:
        return _init_window_sharded(cache, width, mesh)
    L, _, Kv, _, H = cache.k_pages.shape
    return _alloc_window((L, cache.num_slots, Kv, width, H),
                         cache.k_pages.dtype, cache.quantized,
                         cache.k_pages.device)


def _alloc_window(shape, dtype, quant: bool, dev) -> KVWindow:
    if quant:
        return KVWindow(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev))
    return KVWindow(k=torch.zeros(shape, dtype=dtype, device=dev),
                    v=torch.zeros(shape, dtype=dtype, device=dev))


def _init_window_sharded(cache: PagedKVCache, width: int,
                         mesh) -> KVWindow:
    pool = group_part(cache.k_pages, 0)
    parts = axis_parts(pool, "tensor") or [pool]
    T = pool.count if isinstance(pool, Shards) else 1
    S = cache.num_slots
    D = data_degree(mesh)
    D = D if S % D == 0 else 1
    held = [held_tensor_shards(mesh, d, T) for d in range(D)]
    groups = [[_alloc_window((p.shape[0], S // D, p.shape[2], width,
                              p.shape[4]), p.dtype, cache.quantized, dev)
               for p, dev in zip(parts, devs)]
              for devs, _ in held]

    def leaf(j):
        per = [[w[j] for w in g] for g in groups]
        if per[0][0] is None:
            return None
        per = [Shards(p, "tensor", 2, lo, T) if T > 1 else p[0]
               for p, (_, lo) in zip(per, held)]
        return Shards(per, "data", 1) if D > 1 else per[0]
    return KVWindow(*(leaf(j) for j in range(4)))


def stage_window_layer(wk, wv, k, v, win_len, wks=None, wvs=None):
    """Stage one layer's fresh K/V into its window slice, IN PLACE.

    wk/wv: [S, Kv, W, H]; k/v: [B, T, Kv, H] floats (B == S); win_len [S]
    valid entries BEFORE this call — token t of slot b lands at window
    index win_len[b] + t (indices >= W drop), quantized on the way in
    when scale slices wks/wvs [S, Kv, W] are given. Returns the updated
    (wk, wv, wks, wvs)."""
    B, T = k.shape[0], k.shape[1]
    W = wk.shape[2]
    ar = torch.arange(T, device=k.device)
    idx = win_len.long()[:, None] + ar[None, :]         # [B, T]
    rows = torch.arange(B, device=k.device)[:, None].expand(B, T)
    if wks is not None:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        _set_run(wk, rows, idx, kq, W, 2)
        _set_run(wv, rows, idx, vq, W, 2)
        _set_run(wks, rows, idx, ks, W, 2)
        _set_run(wvs, rows, idx, vs, W, 2)
        return wk, wv, wks, wvs
    _set_run(wk, rows, idx, k.to(wk.dtype), W, 2)
    _set_run(wv, rows, idx, v.to(wv.dtype), W, 2)
    return wk, wv, None, None


def insert_window_view(view, wl, base):
    """Insert a layer's window entries into the gathered float view at
    their absolute positions: view [B, S_max, Kv, H] (a fresh gather,
    written in place), wl [S, Kv, W, H], base [S] flushed length.
    Positions past S_max drop."""
    B, S_max = view.shape[0], view.shape[1]
    W = wl.shape[2]
    pos = base.long()[:, None] + torch.arange(W, device=view.device)[None, :]
    rows = torch.arange(B, device=view.device)[:, None].expand(B, W)
    _set_run(view, rows, pos, wl.permute(0, 2, 1, 3).to(view.dtype), S_max, 1)
    return view


def insert_window_view_q(codes, scales, wl, wsl, base):
    """Quantized twin: codes [B, Kv, S_max, H] + scales [B, Kv, S_max]
    gain the window's codes wl [S, Kv, W, H] + scales wsl [S, Kv, W] at
    absolute positions."""
    B, S_max = codes.shape[0], codes.shape[2]
    W = wl.shape[2]
    pos = base.long()[:, None] + torch.arange(W, device=codes.device)[None, :]
    rows = torch.arange(B, device=codes.device)[:, None].expand(B, W)
    _set_run(codes, rows, pos, wl.permute(0, 2, 1, 3), S_max, 2)
    _set_run(scales, rows, pos, wsl.permute(0, 2, 1), S_max, 2)
    return codes, scales


def flush_paged_window(cache: PagedKVCache, window: KVWindow, win_len):
    """Flush every slot's staged window entries into the page pool, IN
    PLACE: ONE scatter per pool tensor covering ALL layers (per tensor
    shard, per data group's slots, into every pool replica). Entries
    past win_len route to the null page, so the flushed pool never holds
    them. Returns (cache with lengths advanced by win_len, zeroed
    win_len, flushed token count [scalar tensor])."""
    for g in data_groups(win_len.shape[0]) or [None]:
        def rows(x, dim=0):
            return x if g is None else group_rows(x, g, dim, inplace=dim > 0)
        win = tuple(rows(t, 1) for t in window)
        for rep in pool_replicas(cache):
            tmap(_flush_layers, rep.k_pages, rep.v_pages, rep.k_scale_pages,
                 rep.v_scale_pages, *win, rows(cache.page_table),
                 rows(cache.lengths), rows(win_len))
    cache = cache._replace(lengths=(cache.lengths + win_len).to(torch.int32))
    return cache, torch.zeros_like(win_len), win_len.sum()


def _flush_layers(kp, vp, ksp, vsp, wk, wv, wks, wvs, page_table, lengths,
                  win_len) -> None:
    """flush_paged_window on one pool's tensors (every layer) from one
    window's slots, read on the pool's device."""
    L, Pp, Kv, page, H = kp.shape
    S, W = wk.shape[1], wk.shape[3]
    dev = kp.device
    wk, wv, wks, wvs, page_table, lengths, win_len = (
        None if t is None else t.to(dev, non_blocking=True)
        for t in (wk, wv, wks, wvs, page_table, lengths, win_len))
    ar = torch.arange(W, device=dev)[None, :]
    pos = lengths.long()[:, None] + ar                        # [S, W]
    valid = ar < win_len.long()[:, None]
    flat_pages, flat_off = _page_slots(page_table, pos, page, Pp - 1, valid)
    # advanced indices at dims 1 and 3 (a slice between) put the index
    # dim FIRST: values arrive [S*W, L, Kv, H]
    kp[:, flat_pages, :, flat_off] = \
        wk.permute(1, 3, 0, 2, 4).reshape(S * W, L, Kv, H)
    vp[:, flat_pages, :, flat_off] = \
        wv.permute(1, 3, 0, 2, 4).reshape(S * W, L, Kv, H)
    if wks is not None:
        # kv-major flat scale dim: col = kv*page + offset; adjacent
        # advanced dims (1, 2) stay in place: values arrive [L, S*W, Kv]
        cols = torch.arange(Kv, device=dev)[None, :] * page \
            + flat_off[:, None]
        ksp[:, flat_pages[:, None], cols] = \
            wks.permute(0, 1, 3, 2).reshape(L, S * W, Kv)
        vsp[:, flat_pages[:, None], cols] = \
            wvs.permute(0, 1, 3, 2).reshape(L, S * W, Kv)


def permute_window_tail(window: KVWindow, win_len, perm) -> KVWindow:
    """Compact a tree round's accepted path inside the window, IN PLACE:
    the round staged its N chunk entries at window indices win_len ..
    win_len+N-1 (chunk order); `perm` [S, C] names, for each of the C
    kept positions, the chunk index whose K/V belongs there. Afterwards
    window index win_len+i holds the i-th kept node's K/V, so the
    caller's win_len += m keeps exactly the accepted path. A gather along
    the W axis (identity outside the staged run) that materialises before
    the write, so overlapping source and destination are safe. Per data
    group's slots and per tensor shard."""
    for g in data_groups(win_len.shape[0]) or [None]:
        if g is None:
            tmap(_permute_window, *window, win_len, perm)
        else:
            tmap(_permute_window,
                 *(group_rows(t, g, 1, inplace=True) for t in window),
                 group_rows(win_len, g), group_rows(perm, g))
    return window


def _permute_window(wk, wv, wks, wvs, win_len, perm) -> None:
    window = KVWindow(wk, wv, wks, wvs)
    W = window.width
    C = perm.shape[1]
    dev = win_len.device
    ar = torch.arange(W, device=dev)[None, :]
    rel = ar - win_len.long()[:, None]                        # [S, W]
    tail = torch.gather(perm.long(), 1, rel.clamp(0, C - 1))
    idx = torch.where((rel >= 0) & (rel < C), win_len.long()[:, None] + tail,
                      ar.expand_as(rel))                      # [S, W]
    L, S, Kv, _, H = window.k.shape
    gi = idx[None, :, None, :, None].expand(L, S, Kv, W, H)
    for t in (window.k, window.v):
        t.copy_(torch.gather(t, 3, gi))
    if window.quantized:
        gs = idx[None, :, None, :].expand(L, S, Kv, W)
        for t in (window.k_scale, window.v_scale):
            t.copy_(torch.gather(t, 3, gs))


def permute_paged_tail(cache: PagedKVCache, perm,
                       active=None) -> PagedKVCache:
    """Window-off twin of permute_window_tail, IN PLACE: the tree round's
    N chunk entries sit in the pool at positions lengths .. lengths+N-1;
    gather the C kept nodes' entries (positions lengths + perm[:, i]) and
    write them to lengths .. lengths+C-1 across all layers. Positions
    past the table row, and inactive slots, route to the null page (the
    gather reads it, the write lands there). Per tensor shard, in every
    pool replica."""
    for rep in pool_replicas(cache):
        tmap(_permute_pages, rep.k_pages, rep.v_pages, rep.k_scale_pages,
             rep.v_scale_pages, cache.page_table, cache.lengths, perm,
             active)
    return cache


def _permute_pages(kp, vp, ksp, vsp, page_table, lengths, perm,
                   active) -> None:
    cache = PagedKVCache(kp, vp, page_table, lengths, ksp, vsp)
    L, Pp, Kv, page, H = cache.k_pages.shape
    S, C = perm.shape
    dev = perm.device
    base = cache.lengths.long()[:, None]                      # [S, 1]
    keep = None if active is None else active[:, None].expand(S, C)
    src_pages, src_off = _page_slots(cache.page_table, base + perm.long(),
                                     page, Pp - 1, keep)
    dst_pages, dst_off = _page_slots(
        cache.page_table, base + torch.arange(C, device=dev)[None, :], page,
        Pp - 1, keep)
    # advanced indices at dims 1 and 3 (a slice between) put the index
    # dim first: values move as [S*C, L, Kv, H]; the gather materialises
    # before the write
    for t in (cache.k_pages, cache.v_pages):
        t[:, dst_pages, :, dst_off] = t[:, src_pages, :, src_off]
    if cache.quantized:
        # kv-major flat scale dim: col = kv*page + offset
        kv = torch.arange(Kv, device=dev)[None, :] * page
        src_cols = kv + src_off[:, None]
        dst_cols = kv + dst_off[:, None]
        for t in (cache.k_scale_pages, cache.v_scale_pages):
            t[:, dst_pages[:, None], dst_cols] = \
                t[:, src_pages[:, None], src_cols]


# ---------------------------------------------------------------------------
# Paged forward pass
# ---------------------------------------------------------------------------

def paged_layer_body(x, lp, kp, vp, *, cfg: ModelConfig, page_table,
                     positions, mask, cos, sin, active, use_kernel: bool,
                     fresh: bool = False, ksp=None, vsp=None, win=None,
                     force_dense: bool = False):
    """One transformer layer against one layer's page pool slice.

    x: [B,T,D]; kp/vp: [P,Kv,page,H]; ksp/vsp: [P,Kv*page] iff int8.
    Window-off, fresh K/V is written into the pool slice in place and
    (x, kp, vp[, ksp, vsp]) returns. With win = (wk, wv, wks, wvs,
    win_len) the pool is READ-ONLY: fresh K/V stages into this layer's
    window slices and (x, wk, wv[, wks, wvs]) returns.

    use_kernel and T == 1 (a decode step): attention runs the paged
    kernel (window segment folded in when windowed). cfg.attn_impl ==
    "flash" and T > 1: a `fresh` chunk (every start 0, nothing live
    before) runs the fresh flash kernel over its own K/V (identical for
    int8 pools: the chunk is attended as projected); a warm chunk, window
    off, runs the warm kernel with the gathered pool view as its prefix,
    count-masked at prefix_len = start (0 for inactive rows), so the
    chunk's own just-written copy, null-page garbage and padding rows
    never contribute — int8 pools hand the chunk in quantized and back
    (the values the dense path reads from the pool). Otherwise the pool
    is gathered into a dense view (window inserted) for attend().
    `force_dense` (an explicit, non-causal mask: the tree verify) keeps
    the warm chunk off the flash kernel too.

    Tensor-split weights (parallel/partition.py) give per-shard q/k/v;
    the pools and window are then per-shard Shards too (or one replicated
    pool where Kv does not divide the tensor axis), and every write,
    gather and kernel call runs per shard.
    """
    T = x.shape[1]
    quant = ksp is not None
    compute = torch_dtype(cfg.dtype)
    lp = _cast_layer(lp, compute)
    start = positions[:, 0]

    h = pre_norm(x, lp["ln1"], cfg)
    q, k, v = qkv_proj(h, lp["attn"], cfg, cos, sin)
    if win is not None:
        wk, wv, wks, wvs, win_len = win
        base = start - win_len  # flushed pool length per slot
        wk, wv, wks, wvs = tmap(stage_window_layer, wk, wv, k, v, win_len,
                                wks, wvs)
    else:
        kp, vp, ksp, vsp = tmap(write_paged_layer, kp, vp, page_table, k, v,
                                start, active, ksp, vsp)
    zero = torch.zeros_like(start)
    if use_kernel and T == 1:
        q1 = tmap(lambda t: t[:, 0].contiguous(), q, out_split=1)
        if win is not None:
            # pool-valid lengths are the FLUSHED base; the staged run
            # (prior entries + the token just staged) is the window
            lens = torch.where(active, base, zero).to(torch.int32)
            wcnt = torch.where(active, win_len + T, zero).to(torch.int32)
            out = paged_attention_sharded(
                q1, kp, vp, page_table, lens, ksp, vsp, win_k=wk, win_v=wv,
                win_count=wcnt, win_k_scale=wks, win_v_scale=wvs)
        else:
            # lengths INCLUDING the token just written (inactive: 0)
            lens = torch.where(active, start + 1, zero).to(torch.int32)
            out = paged_attention_sharded(q1, kp, vp, page_table, lens, ksp,
                                          vsp)
        out = tmap(lambda t: t[:, None], out, out_split=2)
    elif cfg.attn_impl == "flash" and T > 1 and fresh:
        out = flash_attention_sharded(q, k, v, causal=True)
    elif cfg.attn_impl == "flash" and T > 1 and win is None \
            and not force_dense:
        plen = torch.where(active, start, zero).to(torch.int32)
        if quant:
            ck, k_s = tmap(gather_paged_layer_q, kp, ksp, page_table)
            cv, v_s = tmap(gather_paged_layer_q, vp, vsp, page_table)
            out = flash_attention_sharded(
                q, tmap(_dequant_mirror, k), tmap(_dequant_mirror, v),
                causal=True, prefix_k=ck, prefix_v=cv, prefix_len=plen,
                prefix_k_scale=k_s, prefix_v_scale=v_s)
        else:
            out = flash_attention_sharded(
                q, k, v, causal=True,
                prefix_k=tmap(gather_paged_layer, kp, page_table),
                prefix_v=tmap(gather_paged_layer, vp, page_table),
                prefix_len=plen)
    elif quant:
        ck, k_s = tmap(gather_paged_layer_q, kp, ksp, page_table)
        cv, v_s = tmap(gather_paged_layer_q, vp, vsp, page_table)
        if win is not None:
            ck, k_s = tmap(insert_window_view_q, ck, k_s, wk, wks, base)
            cv, v_s = tmap(insert_window_view_q, cv, v_s, wv, wvs, base)
        out = over_heads(attend, q, ck, cv, mask, cfg, k_s, v_s)
    else:
        ck = tmap(gather_paged_layer, kp, page_table)
        cv = tmap(gather_paged_layer, vp, page_table)
        if win is not None:
            ck = tmap(insert_window_view, ck, wk, base)
            cv = tmap(insert_window_view, cv, wv, base)
        out = over_heads(attend, q, ck, cv, mask, cfg)
    x = x + attn_output(out, lp["attn"], cfg)
    x = x + ffn_block(pre_norm(x, lp["ln2"], cfg), lp, cfg)
    if win is not None:
        return (x, wk, wv, wks, wvs) if quant else (x, wk, wv)
    return (x, kp, vp, ksp, vsp) if quant else (x, kp, vp)


def paged_forward(params, cfg: ModelConfig, tokens, cache: PagedKVCache,
                  positions=None, active=None, use_kernel: bool = False,
                  fresh: bool = False, last_index=None, attn_mask=None):
    """Forward over [B,T] tokens against the paged cache (one row per
    table row), writing K/V into the pool in place. `active` [B] bool
    masks rows with no live request (their lengths stay, their writes go
    to the null page). `fresh`: every row starts at position 0 with
    nothing live before (paged_layer_body's fresh flash branch).
    last_index [B] runs the LM head on that row only ([B,1,V]).
    attn_mask [B,T,S_max] replaces the causal mask (the tree verify: each
    node attends committed history + its ancestor chunk positions) and
    forces the dense path; K/V still land at start + chunk index while
    RoPE follows `positions`. Returns (logits [B,T,V] f32, cache with
    advanced lengths). Data groups run their rows against their replica
    of the pool; each group's writes are copied into the other replicas.
    With a stage mesh active the forward is the GPipe pipeline's
    (parallel/pipeline.py:paged_pipeline_forward; no attn_mask)."""
    mesh = active_mesh()
    if stage_degree(mesh) > 1:
        if attn_mask is not None:
            raise ValueError("the tree verify's attn_mask has no slot in "
                             "the stage pipeline (stage > 1)")
        from butterfly_tpu_torch.parallel.pipeline import (
            paged_pipeline_forward)
        return paged_pipeline_forward(params, cfg, tokens, cache, positions,
                                      active, use_kernel, fresh, last_index,
                                      mesh=mesh)
    B, T = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = cache.lengths.long()[:, None] \
            + torch.arange(T, device=dev)[None, :]
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    groups = data_groups(B)
    if groups is None:
        return _paged_forward(params, cfg, tokens, cache, positions, active,
                              use_kernel, fresh, last_index, attn_mask)
    reps = pool_replicas(cache)

    def group(g):
        r = g.index if len(reps) > 1 else 0
        table = group_rows(cache.page_table, g)
        pos_g, act_g = group_rows(positions, g), group_rows(active, g)
        logits, c = _paged_forward(
            group_part(params, g.index), cfg, group_rows(tokens, g),
            reps[r]._replace(page_table=table,
                             lengths=group_rows(cache.lengths, g)),
            pos_g, act_g, use_kernel, fresh, group_rows(last_index, g),
            group_rows(attn_mask, g))
        for other in reps[:r] + reps[r + 1:]:
            _copy_written(reps[r], other, table, pos_g[:, 0], T, act_g)
        return logits, c.lengths
    outs = run_groups(groups, group, B)
    return (cat_groups([o[0] for o in outs]),
            cache._replace(lengths=cat_groups([o[1] for o in outs])))


def _copy_written(src: PagedKVCache, dst: PagedKVCache, page_table, start,
                  T: int, active) -> None:
    """Copy the pool cells a window-off forward wrote (T tokens from
    `start` of each active row, every layer) from replica `src` into
    replica `dst`, per tensor shard."""
    pos = start.long()[:, None] + torch.arange(T, device=start.device)
    keep = active[:, None].expand_as(pos)

    def copy(sk, sv, sks, svs, dk, dv, dks, dvs):
        page = sk.shape[3]
        pages, off = _page_slots(page_table.to(sk.device), pos.to(sk.device),
                                 page, sk.shape[1] - 1, keep.to(sk.device))
        for a, b in ((sk, dk), (sv, dv)):
            b[:, pages.to(b.device), :, off.to(b.device)] = \
                a[:, pages, :, off].to(b.device)
        if sks is not None:
            cols = torch.arange(sk.shape[2], device=sk.device)[None, :] \
                * page + off[:, None]
            for a, b in ((sks, dks), (svs, dvs)):
                b[:, pages[:, None].to(b.device), cols.to(b.device)] = \
                    a[:, pages[:, None], cols].to(b.device)
    tmap(copy, src.k_pages, src.v_pages, src.k_scale_pages,
         src.v_scale_pages, dst.k_pages, dst.v_pages, dst.k_scale_pages,
         dst.v_scale_pages)


def _paged_forward(params, cfg: ModelConfig, tokens, cache: PagedKVCache,
                   positions, active, use_kernel: bool, fresh: bool,
                   last_index, attn_mask):
    T = tokens.shape[1]
    quant = cache.quantized
    x, cos, sin = embed_tokens(params, cfg, tokens, positions)
    mask = attn_mask if attn_mask is not None \
        else make_mask(positions, cache.max_seq)
    mask = mask & active[:, None, None]
    x = paged_layers(params["layers"], cfg, x, cache, positions, mask, cos,
                     sin, active, use_kernel, fresh,
                     force_dense=attn_mask is not None)
    if last_index is not None:
        x = _take_rows(x, last_index)
    logits = final_logits(params, cfg, x)
    new_len = torch.where(active, cache.lengths + T, cache.lengths)
    return logits, cache._replace(lengths=new_len.to(torch.int32))


def paged_layers(layers, cfg: ModelConfig, x, cache: PagedKVCache,
                 positions, mask, cos, sin, active, use_kernel: bool,
                 fresh: bool = False, force_dense: bool = False):
    """paged_layer_body over every layer of the stacked `layers` against
    the pools' layers alike (both lead with the same n: the whole stack,
    or one pipeline stage's slice of it), window off. Returns x."""
    quant = cache.quantized
    for i in range(cache.k_pages.shape[0]):
        x = paged_layer_body(
            x, layer_params({"layers": layers}, i), cache.k_pages[i],
            cache.v_pages[i], cfg=cfg, page_table=cache.page_table,
            positions=positions, mask=mask, cos=cos, sin=sin, active=active,
            use_kernel=use_kernel, fresh=fresh,
            ksp=cache.k_scale_pages[i] if quant else None,
            vsp=cache.v_scale_pages[i] if quant else None,
            force_dense=force_dense)[0]
    return x


def paged_stage_layers(layers, cfg: ModelConfig, x, cache: PagedKVCache,
                       positions, mask, cos, sin, active, use_kernel: bool,
                       fresh: bool, mesh):
    """`paged_layers` for one pipeline stage over its own `mesh`
    (core/mesh.py:Mesh.stage_mesh): data groups run their rows of x
    against their replica of the stage's pools and weights, each group's
    writes copied into the other replicas, as paged_forward does for the
    whole stack. Returns x on the mesh's first device."""
    B, T = x.shape[:2]
    groups = data_groups(B, mesh)
    if groups is None:
        dev = mesh.first_device
        return paged_layers(layers, cfg, x.to(dev, non_blocking=True),
                            cache, positions.to(dev, non_blocking=True),
                            mask.to(dev, non_blocking=True),
                            cos.to(dev, non_blocking=True),
                            sin.to(dev, non_blocking=True),
                            active.to(dev, non_blocking=True), use_kernel,
                            fresh)
    reps = pool_replicas(cache)

    def group(g):
        r = g.index if len(reps) > 1 else 0
        table = group_rows(cache.page_table, g)
        pos_g, act_g = group_rows(positions, g), group_rows(active, g)
        y = paged_layers(group_part(layers, g.index), cfg,
                         group_rows(x, g), reps[r]._replace(
                             page_table=table), pos_g, group_rows(mask, g),
                         group_rows(cos, g), group_rows(sin, g), act_g,
                         use_kernel, fresh)
        for other in reps[:r] + reps[r + 1:]:
            _copy_written(reps[r], other, table, pos_g[:, 0], T, act_g)
        return y
    return cat_groups(run_groups(groups, group, B))


def paged_forward_window(params, cfg: ModelConfig, tokens,
                         cache: PagedKVCache, window: KVWindow, win_len,
                         active=None, use_kernel: bool = False,
                         positions=None, attn_mask=None):
    """Windowed (kv_write_combine) forward over [B,T] tokens: the pool is
    READ-ONLY, fresh K/V stages into `window` (in place) at per-slot
    offset win_len, and attention reads pool + window. The true length
    per slot is cache.lengths (flushed) + win_len (staged); neither
    advances here. `positions` / `attn_mask` override the causal
    defaults for the tree verify (paged_forward's attn_mask). Returns
    (logits [B,T,V] f32, window). Data groups run their slots against
    their part of the window and their replica of the pool."""
    B, T = tokens.shape
    dev = tokens.device
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    if positions is None:
        positions = (cache.lengths + win_len).long()[:, None] \
            + torch.arange(T, device=dev)[None, :]
    groups = data_groups(B)
    if groups is None:
        return _paged_forward_window(params, cfg, tokens, cache, window,
                                     win_len, active, use_kernel, positions,
                                     attn_mask), window
    reps = pool_replicas(cache)
    logits = run_groups(groups, lambda g: _paged_forward_window(
        group_part(params, g.index), cfg, group_rows(tokens, g),
        reps[g.index if len(reps) > 1 else 0]._replace(
            page_table=group_rows(cache.page_table, g),
            lengths=group_rows(cache.lengths, g)),
        KVWindow(*(group_rows(t, g, 1, inplace=True) for t in window)),
        group_rows(win_len, g), group_rows(active, g), use_kernel,
        group_rows(positions, g), group_rows(attn_mask, g)), B)
    return cat_groups(logits), window


def _paged_forward_window(params, cfg: ModelConfig, tokens,
                          cache: PagedKVCache, window: KVWindow, win_len,
                          active, use_kernel: bool, positions, attn_mask):
    quant = cache.quantized
    x, cos, sin = embed_tokens(params, cfg, tokens, positions)
    mask = attn_mask if attn_mask is not None \
        else make_mask(positions, cache.max_seq)
    mask = mask & active[:, None, None]
    wl = win_len.long()
    for i in range(cfg.num_layers):
        out = paged_layer_body(
            x, layer_params(params, i), cache.k_pages[i], cache.v_pages[i],
            cfg=cfg, page_table=cache.page_table, positions=positions,
            mask=mask, cos=cos, sin=sin, active=active,
            use_kernel=use_kernel,
            ksp=cache.k_scale_pages[i] if quant else None,
            vsp=cache.v_scale_pages[i] if quant else None,
            win=(window.k[i], window.v[i],
                 window.k_scale[i] if quant else None,
                 window.v_scale[i] if quant else None, wl))
        x = out[0]
    return final_logits(params, cfg, x)
