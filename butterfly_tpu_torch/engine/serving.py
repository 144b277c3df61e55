"""Slot-based serving engine over the paged KV cache, in PyTorch.

The device half of the serving stack (host half: sched/scheduler.py), the
counterpart of butterfly_tpu/engine/serving.py. Two dispatch paths:

* mixed dispatch (the default): each scheduler tick dispatches ONE mixed
  block (`mixed_block_async`): k chained steps in which decode-phase
  slots advance one token while prefill-phase slots chew a C-token chunk
  of their prompt, phase being a pure function of the per-slot chunk
  cursor (`cursor < plen`);
* the alternating path (mixed_dispatch=False, scheduler="static"):
  gang prefills (`prefill_batch`, one [B, Tbucket] dispatch per bucket)
  between fused decode blocks (`decode_block_async`).

The JAX package's jitted `lax.scan` over a block's steps becomes a Python
loop over eagerly launched device work; nothing in a block synchronizes
with the host, so the scheduler can dispatch block t+1 before it drains
block t.

Under a seq-only mesh (core/mesh.py) a third dispatch serves the
scheduler's long-prompt lane (`sp_prefill_chunk`): one chunk of a long
prompt sharded over `seq`, its fresh K/V attended through the ring
kernel, landing in the ordinary page pool; the slot then decodes like any
other. Every other program, and the pool, live on the mesh's first
device.

Decode steps (C == 1) attend through the hand-written paged-attention
kernel on CUDA (`use_kernels`, on by default there). With kernels on, the
alternating path's prefills attend through the flash kernels: a fresh
gang through the fresh kernel, a chunk continuation through the warm
kernel (prefill_flash_warm, the default). Mixed blocks' prefill lanes take
the dense gather + attend path, as on the TPU.

Configurations whose device half is not ported yet raise
NotImplementedError at construction, naming the ROADMAP.md item, so no
request runs silently on a path the JAX package would run differently.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from butterfly_tpu_torch.cache.paged import (
    KVWindow, PagedKVCache, flush_paged_window, init_kv_window,
    init_paged_cache, paged_forward, paged_forward_window)
from butterfly_tpu_torch.core.config import ModelConfig, RuntimeConfig
from butterfly_tpu_torch.core.mesh import seq_degree
from butterfly_tpu_torch.engine.engine import (
    cast_params, is_quantized_tree, mesh_device, not_ported, to_device)
from butterfly_tpu_torch.engine.sampling import _filter_logits, gumbel_argmax
from butterfly_tpu_torch.models.common import Model
from butterfly_tpu_torch.parallel.sequence import (
    replicate_params, sp_chunk_body)


def bucket_len(n: int, lo: int = 16, hi: Optional[int] = None) -> int:
    """Next power-of-two bucket >= n (floor lo), clamped to hi; n > hi
    is a caller bug and raises."""
    if hi is not None and n > hi:
        raise ValueError(f"{n} tokens exceed the cache's {hi}-token "
                         f"capacity")
    b = lo
    while b < n:
        b *= 2
    if hi is not None and b > hi:
        b = hi
    return b


def bucket_batch(n: int, hi: int) -> int:
    """Next power-of-two batch bucket >= n, clamped to hi (n > hi
    returns n exactly)."""
    if n >= hi:
        return n
    b = 1
    while b < n:
        b *= 2
    return min(b, hi)


def sample_batched(logits: torch.Tensor, generator: Optional[torch.Generator],
                   temps: torch.Tensor, top_k: int,
                   top_p: float) -> torch.Tensor:
    """Per-slot-temperature sampling: temp 0 rows are greedy. [S,V]->[S].

    Sampled rows draw by Gumbel-max over the filtered, temperature-scaled
    logits (the categorical jax.random.categorical draws) with uniforms
    from `generator`, which must live on the logits' device. No host
    sync."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    temps = temps.to(logits.device, torch.float32)
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))[:, None]
    drawn = gumbel_argmax(_filter_logits(logits / safe_t, top_k, top_p),
                          generator)
    return torch.where(temps > 0, drawn, greedy)


def _refuse_unported(cfg: ModelConfig, rt: RuntimeConfig,
                     params) -> None:
    """Raise for every configuration whose device half is not ported (a
    mesh with an axis other than seq raises in mesh_device)."""
    def no(what: str, item: str) -> None:
        raise not_ported(what, item)
    if rt.speculative_gamma > 0:
        no("speculative serving (speculative_gamma > 0)", "speculation")
    if cfg.is_moe:
        no("MoE models", "Mixtral / expert parallelism")
    if is_quantized_tree(params):
        no("int8 weights (--quant int8)", "int8 weights")


class ServingEngine:
    """Device-side half of the serving stack (host half: sched/)."""

    def __init__(self, model: Model, params,
                 runtime: Optional[RuntimeConfig] = None, mesh=None,
                 use_kernels: Optional[bool] = None, device=None):
        self.model = model
        self.cfg = model.cfg
        self.runtime = runtime or RuntimeConfig()
        _refuse_unported(self.cfg, self.runtime, params)
        self.device = mesh_device(mesh, device, model)
        # Optional obs.trace.Tracer (the scheduler shares its own)
        self.tracer = None
        self.mesh = mesh
        self.params = to_device(cast_params(params, self.cfg), self.device)
        # the weights on every other distinct mesh device, for the
        # seq-parallel lane (shards that share a card share its tensors)
        self._replicas = None if mesh is None else \
            replicate_params(self.params, mesh.seq_devices())
        if use_kernels is None:
            # the hand-written kernels need the card; the CPU runs the
            # plain versions (ops/*: the wrapper picks by tensor device)
            use_kernels = self.device.type == "cuda"
        self._use_kernels = bool(use_kernels)
        # Two prefill programs: fresh (every start 0: flash over the chunk
        # alone) and warm (chunk continuation). With prefill_flash_warm
        # the warm one takes the flash kernel too (cached prefix + fresh
        # chunk), else the dense gather (the parity reference).
        self._prefill_cfg = self.cfg.replace(attn_impl="flash") \
            if self._use_kernels else self.cfg
        self._warm_cfg = self._prefill_cfg \
            if self.runtime.prefill_flash_warm else self.cfg
        self.cache = init_paged_cache(self.cfg, self.runtime,
                                      device=self.device)
        # Host-side block-table mirror (the host is the only writer): the
        # whole int32 table transfers ONCE per dispatch that needs it.
        self._host_table = np.full(tuple(self.cache.page_table.shape),
                                   self.cache.null_page, np.int32)
        self._table_dirty = False
        # Write-combined KV window (kv_write_combine): mixed blocks stage
        # fresh K/V in an engine-held window, the pool stays read-only
        # inside a block, and a drain flushes the window into the pool.
        self._window_mode = bool(self.runtime.kv_write_combine)
        self._kv_window: Optional[KVWindow] = None
        self._win_len = None       # [S] staged count; None = seed zeros
        self._win_dirty = False    # staged entries not yet flushed
        self._win_hwm = 0          # host upper bound on staged entries

    # -- host <-> device ----------------------------------------------------

    def _h2d(self, a, dtype: torch.dtype) -> torch.Tensor:
        """A host array (or a tensor) as a tensor on the engine's device.
        Host data is copied (the caller may reuse its buffer); on CUDA it
        goes through pinned memory with a non-blocking copy, so a
        dispatch never waits for the device to drain."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device, dtype)
        t = torch.as_tensor(np.asarray(a)).to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def record_event(self):
        """A CUDA event recorded after everything dispatched so far (the
        scheduler's non-blocking completion probe); None on the CPU,
        where device work has already completed when it returns."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    # -- properties the scheduler reads ------------------------------------

    @property
    def num_slots(self) -> int:
        return self.runtime.max_batch_size

    @property
    def warm_prefill_flash(self) -> bool:
        """True when the warm prefill attends through the flash kernel
        (cached prefix + fresh chunk) rather than the dense gather —
        kernels on AND runtime.prefill_flash_warm."""
        return self._use_kernels and bool(self.runtime.prefill_flash_warm)

    @property
    def prefill_gang_split_fresh(self) -> bool:
        return not bool(self.runtime.prefill_flash_warm)

    @property
    def supports_seq_parallel(self) -> bool:
        """Can long prompts route through the seq-parallel prefill lane?
        Needs a mesh with a seq axis > 1 (every other axis is 1)."""
        return self.sp_degree > 1

    @property
    def sp_degree(self) -> int:
        """Size of the seq mesh axis (1 without a mesh)."""
        return seq_degree(self.mesh)

    @property
    def spec_tree_mode(self) -> bool:
        return False

    @property
    def spec_tree_geometry(self) -> Tuple[int, int]:
        return 0, 0

    @property
    def spec_emit_width(self) -> int:
        return self.runtime.speculative_gamma + 1

    @property
    def mixed_dispatch_ready(self) -> bool:
        return bool(self.runtime.mixed_dispatch)

    @property
    def mixed_fallback_reason(self) -> Optional[str]:
        return None

    @property
    def runtime_top_k(self) -> int:
        return self.runtime.top_k

    @property
    def runtime_top_p(self) -> float:
        return self.runtime.top_p

    # -- block table --------------------------------------------------------

    def set_table_row(self, slot: int, pages) -> None:
        """Host allocator -> block table (host mirror; synced lazily)."""
        row = np.full((self._host_table.shape[1],), self.cache.null_page,
                      np.int32)
        row[:len(pages)] = pages
        self._host_table[slot] = row
        self._table_dirty = True

    def reset_slot(self, slot: int) -> None:
        self._host_table[slot] = self.cache.null_page
        self._table_dirty = True
        lengths = self.cache.lengths.clone()
        lengths[slot] = 0
        self.cache = self.cache._replace(lengths=lengths)

    def _sync_table(self) -> None:
        """Push pending host-side block-table edits to the device."""
        if not self._table_dirty:
            return
        self.cache = self.cache._replace(
            page_table=self._h2d(self._host_table, torch.int32))
        self._table_dirty = False
        if self.tracer is not None:
            self.tracer.event(None, "engine.table_sync")

    # -- write-combined KV window (kv_write_combine) -------------------------

    def _ensure_window(self, need: int) -> None:
        """Make the window able to accept `need` more staged tokens per
        slot: flush when the worst-case staged count would overflow,
        (re)allocate when the capacity itself is short. Sized to
        inflight_blocks x need."""
        width = self._kv_window.width if self._kv_window is not None else 0
        if self._win_hwm + need > width:
            if self._win_dirty:
                self.flush_kv_window()
            if width < need:
                width = max(1, self.runtime.inflight_blocks) * need
                self._kv_window = init_kv_window(self.cache, width)
                self._win_len = None
        if self._win_len is None:
            self._win_len = torch.zeros((self.num_slots,), dtype=torch.int32,
                                        device=self.device)

    def flush_kv_window(self):
        """Flush every staged window entry into the page pool (one scatter
        per pool tensor, in place, ordered after every staging block).
        Returns the device-resident flushed-token count, or None if
        nothing was staged."""
        if not self._win_dirty:
            return None
        cache, wlen, flushed = flush_paged_window(self.cache, self._kv_window,
                                                  self._win_len)
        self.cache, self._win_len = cache, wlen
        self._win_dirty = False
        self._win_hwm = 0
        return flushed

    def drop_kv_window(self) -> None:
        """Discard staged-but-unflushed window state without touching the
        device (the scheduler's wedge path)."""
        self._win_dirty = False
        self._win_hwm = 0
        self._win_len = None

    # -- the alternating path: gang prefills ---------------------------------

    def prefill_slot(self, slot: int, prompt: list) -> torch.Tensor:
        """Run one request's whole prompt; returns last-token logits [V]."""
        return self.prefill_chunk(slot, prompt, 0)

    def prefill_chunk(self, slot: int, tokens: list,
                      start: int) -> torch.Tensor:
        """Run one chunk of one request's prompt; returns the chunk's
        last-token logits [V] (prefill_batch with B = 1)."""
        return self.prefill_batch([slot], [tokens], [start])[0]

    def prefill_batch(self, slots: list, chunks: list,
                      starts: list) -> torch.Tensor:
        """Run one prompt chunk for EACH of B requests as ONE [B, Tbucket]
        dispatch; returns last-position logits [B, V] on the device (row
        i is member i's next-token distribution).

        Member i's chunk occupies absolute positions starts[i] ..
        starts[i] + len(chunks[i]) - 1 of its slot's pages; rows are
        length-masked individually, so members with different chunk
        lengths share a dispatch. B pads to the next power-of-two bucket
        (clamped at runtime.prefill_max_batch); padding rows carry one
        token (last_index 0) and a null-page table row, so their writes
        land on the null page and their logits are dropped. An all-fresh
        gang (every start 0) runs the fresh program; any warm member
        routes the gang through the warm program, where fresh members
        ride with prefix_len 0."""
        B = len(slots)
        T = bucket_len(max(len(c) for c in chunks), hi=self.cache.max_seq)
        Bb = bucket_batch(B, max(1, min(self.runtime.prefill_max_batch,
                                        self.num_slots)))
        buf = np.zeros((Bb, T), np.int32)
        lens = np.ones((Bb,), np.int32)
        sts = np.zeros((Bb,), np.int32)
        rows = np.full((Bb, self.cache.page_table.shape[1]),
                       self.cache.null_page, np.int32)
        for i, (slot, toks, start) in enumerate(zip(slots, chunks, starts)):
            buf[i, :len(toks)] = toks
            lens[i] = len(toks)
            sts[i] = start
            # the host mirror is authoritative (the host is the only
            # writer): no device gather of the slot's table row
            rows[i] = self._host_table[slot]
        # a prefill writes the pool at each slot's FLUSHED length, so
        # staged window entries must land first
        if self._win_dirty:
            self.flush_kv_window()
        fresh = all(s == 0 for s in starts)
        if self.tracer is not None:
            self.tracer.event(None, "engine.prefill_dispatch",
                              slots=list(slots), batch=B, batch_bucket=Bb,
                              tokens=int(sum(len(c) for c in chunks)),
                              bucket=T, fresh=fresh)
        self._sync_table()
        logits = _prefill_slot(
            self._prefill_cfg if fresh else self._warm_cfg, fresh,
            self.params, self._h2d(buf, torch.int32), self.cache,
            self._h2d(rows, torch.int32), self._h2d(lens, torch.int32),
            self._h2d(sts, torch.int32))
        lengths = self.cache.lengths.clone()
        lengths[torch.as_tensor(slots, dtype=torch.long,
                                device=self.device)] = \
            self._h2d(sts[:B] + lens[:B], torch.int32)
        self.cache = self.cache._replace(lengths=lengths)
        return logits[:B]

    # -- the seq-parallel long-prompt lane ------------------------------------

    def sp_prefill_chunk(self, slot: int, tokens: list,
                         start: int) -> torch.Tensor:
        """Run one seq-parallel chunk of one LONG prompt; returns the
        chunk's last-token logits [V] on the device.

        The scheduler's long-prompt lane (seq_parallel_threshold) calls
        this instead of prefill_chunk: the chunk is sharded over the seq
        axis (each shard computes C/N tokens of qkv + ring attention),
        the slot's flushed pool prefix is attended through the same
        flash-stats merge, and the chunk's K/V lands in the slot's pages
        (one all-layer scatter per pool tensor), so decode proceeds as
        for any paged slot."""
        N = self.sp_degree
        C = bucket_len(len(tokens), hi=self.cache.max_seq)
        C = -(-C // N) * N                  # the seq size must divide C
        buf = np.zeros((1, C), np.int32)
        buf[0, :len(tokens)] = tokens
        # the chunk reads the pool at the slot's FLUSHED length, so staged
        # window entries land first
        if self._win_dirty:
            self.flush_kv_window()
        self._sync_table()
        if self.tracer is not None:
            self.tracer.event(None, "engine.sp_prefill_dispatch",
                              slot=slot, tokens=len(tokens), bucket=C,
                              start=start, degree=N)
        logits = _sp_chunk(self.cfg, self._replicas, self.mesh,
                           self._h2d(buf, torch.int32), self.cache,
                           self._host_table[slot], self._h2d, start,
                           len(tokens))
        lengths = self.cache.lengths.clone()
        lengths[slot] = start + len(tokens)
        self.cache = self.cache._replace(lengths=lengths)
        return logits

    # -- the alternating path: decode ------------------------------------------

    def _block_generator(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return gen

    def decode_active(self, tokens, active: np.ndarray, temps: np.ndarray,
                      seed: int) -> Tuple[np.ndarray, torch.Tensor]:
        """One decode step for every slot; returns (next tokens [S] on
        the host, logits [S, V])."""
        nxt, logits = self.decode_active_async(tokens, active, temps, seed)
        return nxt.cpu().numpy(), logits

    def decode_active_async(self, tokens, active: np.ndarray,
                            temps: np.ndarray, seed: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dispatch one decode step WITHOUT a host sync; returns the
        device next-token vector [S] (feed it back as `tokens` to chain
        steps on the device) and the logits [S, V]. `seed` seeds the
        step's generator."""
        # the single-step path writes the pool per token: staged window
        # entries land first so lengths and pool state line up
        if self._win_dirty:
            self.flush_kv_window()
        self._sync_table()
        nxt, logits, self.cache = _decode_all(
            self.cfg, self.params, self._h2d(tokens, torch.int32),
            self.cache, self._h2d(active, torch.bool),
            self._h2d(temps, torch.float32), self.runtime_top_k,
            self.runtime_top_p, self._block_generator(seed),
            use_kernel=self._use_kernels)
        return nxt, logits

    def decode_block_async(self, tokens, active: np.ndarray,
                           temps: np.ndarray, stops: np.ndarray,
                           budgets: np.ndarray, seed: int,
                           k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dispatch ONE fused k-step decode block, no host sync.

        `stops` [S] holds each slot's stop id (-1 = none) and `budgets`
        [S] its remaining-token allowance; a slot that emits its stop or
        spends its budget mid-block goes dead ON THE DEVICE (lengths stop
        advancing, writes land on the null page). `seed` seeds the
        block's generator. Returns (block [k, S], final [S]) on the
        device: the stacked step tokens for the scheduler's drain and the
        final token vector to chain the next dispatch.

        kv_write_combine: the block stages its K/V into the engine-held
        window (the pool stays read-only) and the scheduler's next drain
        flushes it. Token outputs are identical either way."""
        self._sync_table()
        args = (self._h2d(active, torch.bool),
                self._h2d(temps, torch.float32),
                self._h2d(stops, torch.int32),
                self._h2d(budgets, torch.int32),
                self.runtime_top_k, self.runtime_top_p,
                self._block_generator(seed))
        tok = self._h2d(tokens, torch.int32)
        if self._window_mode:
            self._ensure_window(k)
            block, final, window, wlen = _decode_scan_win(
                self.cfg, k, self.params, tok, self.cache, self._kv_window,
                self._win_len, *args, use_kernel=self._use_kernels)
            self._kv_window, self._win_len = window, wlen
            self._win_dirty = True
            self._win_hwm += k
            return block, final
        block, final, self.cache = _decode_scan(
            self.cfg, k, self.params, tok, self.cache, *args,
            use_kernel=self._use_kernels)
        return block, final

    # -- the mixed block ------------------------------------------------------

    def mixed_block_async(self, tokens, cursor, pbuf, plen,
                          active: np.ndarray, temps: np.ndarray,
                          stops: np.ndarray, budgets, seed: int,
                          k: int, C: int):
        """Dispatch ONE k-step MIXED block, no host sync: decode slots
        advance a token per step while prefill-phase slots chew a C-token
        chunk of their `pbuf` row per step (_mixed_scan[_win]).

        `cursor` [S] is the device chunk-cursor carry (rebind from the
        result); `pbuf` [S, Hb] the prompt rows; `plen` [S] each slot's
        prompt length (prefill phase while cursor < plen). `seed` seeds
        this block's generator (the counterpart of the JAX block key).
        Returns (block [k, S], valid [k, S], final [S], cursor)."""
        self._sync_table()
        gen = self._block_generator(seed)
        args = (self._h2d(tokens, torch.int32), self._h2d(cursor, torch.int32))
        rest = (self._h2d(pbuf, torch.int32), self._h2d(plen, torch.int32),
                self._h2d(active, torch.bool),
                self._h2d(temps, torch.float32),
                self._h2d(stops, torch.int32),
                self._h2d(budgets, torch.int32),
                self.runtime_top_k, self.runtime_top_p, gen)
        if self._window_mode:
            self._ensure_window(k * C)
            block, valid, final, cursor, cache, window, wlen = \
                _mixed_scan_win(self.cfg, k, C, self.params, *args,
                                self.cache, self._kv_window, self._win_len,
                                *rest, use_kernel=self._use_kernels)
            self.cache, self._kv_window, self._win_len = cache, window, wlen
            self._win_dirty = True
            self._win_hwm += k * C
            return block, valid, final, cursor
        block, valid, final, cursor, cache = _mixed_scan(
            self.cfg, k, C, self.params, *args, self.cache, *rest,
            use_kernel=self._use_kernels)
        self.cache = cache
        return block, valid, final, cursor

    # -- page import / export ------------------------------------------------

    def read_pages(self, pids):
        """Page contents on the host: (k [L, n, Kv, page, H], v, k_scales,
        v_scales) as CPU tensors — scales [L, n, Kv*page] iff the pool is
        int8, else None. Synchronous."""
        if self._win_dirty:
            self.flush_kv_window()
        idx = torch.as_tensor(list(pids), dtype=torch.long,
                              device=self.device)
        c = self.cache
        k, v = c.k_pages[:, idx].cpu(), c.v_pages[:, idx].cpu()
        ks = vs = None
        if c.quantized:
            ks, vs = c.k_scale_pages[:, idx].cpu(), \
                c.v_scale_pages[:, idx].cpu()
        return k, v, ks, vs

    def write_pages(self, pids, k, v, k_scales=None, v_scales=None) -> None:
        """Land page contents (the read_pages layout) at page ids pids."""
        idx = torch.as_tensor(list(pids), dtype=torch.long,
                              device=self.device)
        c = self.cache
        c.k_pages[:, idx] = torch.as_tensor(k).to(self.device, c.k_pages.dtype)
        c.v_pages[:, idx] = torch.as_tensor(v).to(self.device, c.v_pages.dtype)
        if c.quantized:
            c.k_scale_pages[:, idx] = torch.as_tensor(k_scales).to(
                self.device, torch.float32)
            c.v_scale_pages[:, idx] = torch.as_tensor(v_scales).to(
                self.device, torch.float32)

    def draft_prefill(self, slots, rows, lens) -> None:
        """No draft model without speculation (refused at construction)."""


def _prefill_slot(cfg: ModelConfig, fresh: bool, params, tokens,
                  cache: PagedKVCache, table_rows, true_len, start):
    """[B,T] prompt chunks against B slots' table rows, the pool written
    in place. `start` [B] is each chunk's first absolute position;
    `fresh` means every start is 0 and the members' pages hold nothing
    live (the fresh flash branch). Returns last-token logits [B, V]."""
    B, T = tokens.shape
    cache1 = cache._replace(
        page_table=table_rows,
        lengths=torch.zeros((B,), dtype=torch.int32, device=tokens.device))
    positions = start.long()[:, None] \
        + torch.arange(T, device=tokens.device)[None, :]
    logits, _ = paged_forward(params, cfg, tokens, cache1, positions,
                              fresh=fresh, last_index=true_len - 1)
    return logits[:, 0, :]


def _sp_chunk(cfg: ModelConfig, replicas, mesh, tokens,
              cache: PagedKVCache, row: np.ndarray, h2d, start: int,
              clen: int) -> torch.Tensor:
    """One seq-parallel chunk against one slot's table row (host array):
    gather the slot's flushed prefix for every layer (the pages holding
    positions < start; one page when there are none), run the chunk
    through sp_chunk_body, then scatter its K/V into the pool IN PLACE
    with one all-layer write per pool tensor, pad rows (>= clen) routed to
    the null page. Returns the chunk's last real token's logits [V]."""
    L, Pp, Kv, pg, H = cache.k_pages.shape
    mp = row.shape[0]
    S_full = mp * pg
    n_live = max(1, -(-start // pg))
    live = h2d(row[:n_live], torch.long)
    S = n_live * pg
    if cache.quantized:   # codes [L, 1, Kv, S, H], scales [L, 1, Kv, S]
        prefix = tuple(p[:, live].transpose(1, 2).reshape(L, 1, Kv, S, H)
                       for p in (cache.k_pages, cache.v_pages)) + tuple(
            sc[:, live].reshape(L, n_live, Kv, pg).transpose(1, 2)
            .reshape(L, 1, Kv, S)
            for sc in (cache.k_scale_pages, cache.v_scale_pages))
    else:                 # [L, 1, S, Kv, H]
        prefix = tuple(p[:, live].transpose(2, 3).reshape(L, 1, S, Kv, H)
                       for p in (cache.k_pages, cache.v_pages))
    logits, kv = sp_chunk_body(replicas, cfg, tokens, start, prefix, mesh)
    del prefix
    dev = cache.k_pages.device
    C = tokens.shape[1]
    Cl = C // len(logits)
    ar = torch.arange(C, device=dev)
    pos = start + ar
    row_t = h2d(row, torch.long)
    page_idx = row_t[(pos // pg).clamp(0, mp - 1)]
    page_idx = torch.where((ar < clen) & (pos < S_full), page_idx,
                           torch.full_like(page_idx, cache.null_page))
    off = pos % pg
    # advanced indices at dims 1 and 3 (a slice between) put the index
    # dim first: the indexed view is [C, L, Kv, H]
    if cache.quantized:
        ck, cv, cks, cvs = (torch.cat([p[j].to(dev) for p in kv], dim=3)
                            for j in range(4))      # [L,1,Kv,C(,H)]
        cache.k_pages[:, page_idx, :, off] = ck[:, 0].permute(2, 0, 1, 3)
        cache.v_pages[:, page_idx, :, off] = cv[:, 0].permute(2, 0, 1, 3)
        # the flat scale dim is kv-major: col = kv * page + offset
        cols = torch.arange(Kv, device=dev)[None, :] * pg + off[:, None]
        cache.k_scale_pages[:, page_idx[:, None], cols] = \
            cks[:, 0].permute(0, 2, 1)                  # [L, C, Kv]
        cache.v_scale_pages[:, page_idx[:, None], cols] = \
            cvs[:, 0].permute(0, 2, 1)
    else:
        ck, cv = (torch.cat([p[j].to(dev) for p in kv], dim=2)
                  for j in range(2))                  # [L,1,C,Kv,H]
        cache.k_pages[:, page_idx, :, off] = \
            ck[:, 0].transpose(0, 1).to(cache.k_pages.dtype)
        cache.v_pages[:, page_idx, :, off] = \
            cv[:, 0].transpose(0, 1).to(cache.v_pages.dtype)
    shard, r = divmod(clen - 1, Cl)
    return logits[shard][0, r].to(dev)


def _decode_all(cfg: ModelConfig, params, tokens, cache: PagedKVCache,
                active, temps, top_k: int, top_p: float, gen,
                use_kernel: bool = False):
    logits, cache = paged_forward(params, cfg, tokens[:, None], cache,
                                  active=active, use_kernel=use_kernel)
    last = logits[:, -1, :]
    return sample_batched(last, gen, temps, top_k, top_p), last, cache


def _decode_live0(tokens, active, stops, budgets):
    """Liveness at block start: inactive, out of budget, or holding the
    stop id as its chain token (an undrained first token can be EOS)
    starts dead."""
    has_stop = stops >= 0
    live = active & (budgets > 0) & torch.where(
        has_stop, tokens != stops, torch.ones_like(has_stop))
    return has_stop, live


def _decode_tail(nxt, cur, live, rem, stops, has_stop):
    """A decode step's liveness algebra: dead slots freeze their token,
    live ones spend budget and die on their stop id or an empty budget."""
    nxt = torch.where(live, nxt, cur)
    rem = torch.where(live, rem - 1, rem)
    live = live & (rem > 0) & torch.where(has_stop, nxt != stops,
                                          torch.ones_like(has_stop))
    return nxt, live, rem


def _decode_scan(cfg: ModelConfig, k: int, params, tokens,
                 cache: PagedKVCache, active, temps, stops, budgets,
                 top_k: int, top_p: float, gen, use_kernel: bool = False):
    """k chained decode steps for every slot, window off: each live
    step writes its K/V into the pool and advances its length; dead
    steps write to the null page and advance nothing. Returns (block
    [k, S], final [S], cache)."""
    has_stop, live = _decode_live0(tokens, active, stops, budgets)
    cur, rem, out = tokens, budgets, []
    for _ in range(k):
        logits, cache = paged_forward(params, cfg, cur[:, None], cache,
                                      active=live, use_kernel=use_kernel)
        nxt = sample_batched(logits[:, -1, :], gen, temps, top_k, top_p)
        cur, live, rem = _decode_tail(nxt, cur, live, rem, stops, has_stop)
        out.append(cur)
    return torch.stack(out), cur, cache


def _decode_scan_win(cfg: ModelConfig, k: int, params, tokens,
                     cache: PagedKVCache, window: KVWindow, win_len, active,
                     temps, stops, budgets, top_k: int, top_p: float, gen,
                     use_kernel: bool = False):
    """Write-combined twin of _decode_scan: the pool is read-only, each
    live step stages its K/V into the window at win_len, which advances
    with the slot's liveness exactly as lengths do window-off. Returns
    (block [k, S], final [S], window, win_len)."""
    has_stop, live = _decode_live0(tokens, active, stops, budgets)
    cur, rem, wlen, out = tokens, budgets, win_len, []
    for _ in range(k):
        logits, window = paged_forward_window(params, cfg, cur[:, None],
                                              cache, window, wlen,
                                              active=live,
                                              use_kernel=use_kernel)
        nxt = sample_batched(logits[:, -1, :], gen, temps, top_k, top_p)
        wlen = torch.where(live, wlen + 1, wlen).to(torch.int32)
        cur, live, rem = _decode_tail(nxt, cur, live, rem, stops, has_stop)
        out.append(cur)
    return torch.stack(out), cur, window, wlen


def _mixed_step_io(is_pf, cur, cursor, pbuf, C: int):
    """The [S, C] token chunk of one mixed step: a prefill lane's next C
    prompt tokens, a decode lane's chain token broadcast across C."""
    S, Hb = pbuf.shape
    ccol = torch.arange(C, device=pbuf.device)[None, :]
    idx = (cursor.long()[:, None] + ccol).clamp(0, Hb - 1)
    pchunk = torch.gather(pbuf, 1, idx)
    return torch.where(is_pf[:, None], pchunk, cur[:, None].expand(S, C))


def _mixed_emit(logits, is_pf, count, cursor, plen, live, cur, rem, stops,
                has_stop, gen, temps, top_k: int, top_p: float, C: int):
    """Sampling + emission + liveness algebra shared by both mixed scans
    (the JAX scans' step tail, token for token)."""
    completing = is_pf & (cursor + count >= plen)
    sidx = torch.where(is_pf, (count - 1).clamp(0, C - 1),
                       torch.zeros_like(count))
    V = logits.shape[-1]
    lg = torch.gather(logits, 1, sidx.long()[:, None, None].expand(
        -1, 1, V))[:, 0, :]
    nxt = sample_batched(lg, gen, temps, top_k, top_p)
    emit = live & (completing | ~is_pf)
    nxt = torch.where(emit, nxt, cur)
    one = torch.ones_like(count)
    adv = torch.where(live, torch.where(is_pf, count, one),
                      torch.zeros_like(count))
    cursor = torch.where(live & is_pf, cursor + count, cursor)
    rem = torch.where(emit, rem - 1, rem)
    ok = (rem > 0) & torch.where(has_stop, nxt != stops,
                                 torch.ones_like(has_stop))
    live = live & torch.where(emit, ok, torch.ones_like(ok))
    return nxt, emit, adv, cursor, rem, live


def _mixed_live0(tokens, cursor, plen, active, stops, budgets):
    has_stop = stops >= 0
    is_pf0 = cursor < plen
    # prefill-phase slots skip the chain-token stop check: their incoming
    # token is prompt filler, not an emission
    live = active & (budgets > 0) & torch.where(
        has_stop & ~is_pf0, tokens != stops, torch.ones_like(has_stop))
    return has_stop, live


def _mixed_scan(cfg: ModelConfig, k: int, C: int, params, tokens, cursor,
                cache: PagedKVCache, pbuf, plen, active, temps, stops,
                budgets, top_k: int, top_p: float, gen,
                use_kernel: bool = False):
    """k chained MIXED steps, window off: K/V writes go straight into the
    pool (write-then-attend) and lengths advance by each lane's real
    count (a prefill chunk's length, 1 for a decode step, 0 dead), which
    rolls back the filler past it. With no prefill lane and C == 1 this
    is exactly a decode block. Returns (block [k, S], valid [k, S],
    final [S], cursor, cache)."""
    has_stop, live = _mixed_live0(tokens, cursor, plen, active, stops,
                                  budgets)
    cur, rem = tokens, budgets
    toks_out, emits = [], []
    for _ in range(k):
        is_pf = cursor < plen
        count = torch.where(is_pf, (plen - cursor).clamp(0, C),
                            torch.zeros_like(cursor))
        toks = _mixed_step_io(is_pf, cur, cursor, pbuf, C)
        base_len = cache.lengths
        logits, cache = paged_forward(params, cfg, toks, cache, active=live,
                                      use_kernel=use_kernel)
        cur, emit, adv, cursor, rem, live = _mixed_emit(
            logits, is_pf, count, cursor, plen, live, cur, rem, stops,
            has_stop, gen, temps, top_k, top_p, C)
        cache = cache._replace(lengths=(base_len + adv).to(torch.int32))
        toks_out.append(cur)
        emits.append(emit)
    return (torch.stack(toks_out), torch.stack(emits), cur, cursor, cache)


def _mixed_scan_win(cfg: ModelConfig, k: int, C: int, params, tokens,
                    cursor, cache: PagedKVCache, window: KVWindow, win_len,
                    pbuf, plen, active, temps, stops, budgets, top_k: int,
                    top_p: float, gen, use_kernel: bool = False):
    """Write-combined twin of _mixed_scan: each step stages its C-wide
    chunk at the slot's win_len (the pool stays read-only) and win_len
    advances by the REAL count only, so filler and dead-step repeats sit
    past it, never attended or flushed. Returns (block [k, S], valid
    [k, S], final [S], cursor, cache, window, win_len)."""
    has_stop, live = _mixed_live0(tokens, cursor, plen, active, stops,
                                  budgets)
    cur, rem, wlen = tokens, budgets, win_len
    toks_out, emits = [], []
    for _ in range(k):
        is_pf = cursor < plen
        count = torch.where(is_pf, (plen - cursor).clamp(0, C),
                            torch.zeros_like(cursor))
        toks = _mixed_step_io(is_pf, cur, cursor, pbuf, C)
        logits, window = paged_forward_window(params, cfg, toks, cache,
                                              window, wlen, active=live,
                                              use_kernel=use_kernel)
        cur, emit, adv, cursor, rem, live = _mixed_emit(
            logits, is_pf, count, cursor, plen, live, cur, rem, stops,
            has_stop, gen, temps, top_k, top_p, C)
        wlen = (wlen + adv).to(torch.int32)
        toks_out.append(cur)
        emits.append(emit)
    return (torch.stack(toks_out), torch.stack(emits), cur, cursor, cache,
            window, wlen)
