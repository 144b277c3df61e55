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

Under a seq mesh (core/mesh.py) a third dispatch serves the scheduler's
long-prompt lane (`sp_prefill_chunk`): one chunk of a long prompt
sharded over `seq` on the ring of the slot's data group (per tensor
shard under a tensor axis), its fresh K/V attended through the ring
kernel, landing in the ordinary page pool, in every data replica of it;
the slot then decodes like any other. Where the seq axis crosses
processes each process runs its own shards of the chunk and every
process lands every shard's K/V in its own whole pool. Under an expert mesh the MoE
expert leaves are split over its shards (parallel/partition.py:
shard_params) and every dispatch runs with the mesh active, so the
expert-parallel FFN (cfg.moe_impl="ep", parallel/expert.py) dispatches
over it in every path. Under a tensor or
data axis the weights split over `tensor` (views on one card), the pool
and the window hold one contiguous tensor per tensor shard, the slots
split over `data` groups and the pool is replicated over them (shared on
one device); every path runs each shard's kernels on its heads and each
group's on its slots (cache/paged.py), while the block table stays on
the host. Pages read back (`read_pages`, the host KV tier, /kv/pages)
come out in the unsharded layout, so any two engines exchange KV. Under
a stage axis each stage holds its layers' weights and its slice of the
pools, and every program (decode, decode blocks, mixed and linear spec
blocks, prefills) runs the GPipe schedule over microbatches of slots
(cache/paged.py:paged_forward hands it to parallel/pipeline.py:
paged_pipeline_forward while the stage mesh is active); as in the JAX
engine the write-combined window is off there, the seq lane does not
run and tree speculation raises. Every other program lives on the
mesh's first device.

Decode steps (C == 1) attend through the hand-written paged-attention
kernel on CUDA (`use_kernels`, on by default there). With kernels on, the
alternating path's prefills attend through the flash kernels: a fresh
gang through the fresh kernel, a chunk continuation through the warm
kernel (prefill_flash_warm, the default). Mixed blocks' prefill lanes take
the dense gather + attend path, as on the TPU.

Speculation (runtime.speculative_gamma > 0) dispatches spec blocks
instead of decode blocks: `spec_block_async` (draft -> one batched
(gamma+1)-token verify -> accept on the device, per round; token trees
under spec_tree_width) and, under mixed dispatch, `mixed_spec_block_async`
with prefill lanes. Drafts come from DRAFT_SOURCES: prompt lookup
("ngram") or the on-device draft model ("model", models/draft.py). A
verify is a multi-token warm step: it takes the dense gather, as on the
TPU. Weights may be int8 ({"q8", "s"} leaves, quant/int8.py).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from butterfly_tpu_torch.cache.paged import (
    KVWindow, PagedKVCache, flush_paged_window, init_kv_window,
    init_paged_cache, paged_forward, paged_forward_window,
    permute_paged_tail, permute_window_tail, pool_replicas)
from butterfly_tpu_torch.core.config import ModelConfig, RuntimeConfig
from butterfly_tpu_torch.core.mesh import (axis_group, seq_degree,
                                           stage_degree, under_mesh)
from butterfly_tpu_torch.engine.engine import (
    mesh_device, place_params, seq_replicas)
from butterfly_tpu_torch.engine.sampling import (
    _filter_logits, gumbel_argmax, speculative_accept,
    speculative_tree_accept, tree_ancestor_matrix, tree_depth,
    tree_node_index)
from butterfly_tpu_torch.models.common import Model
from butterfly_tpu_torch.parallel.partition import Shards, axis_parts
from butterfly_tpu_torch.parallel.sequence import (gather_local, shard_row,
                                                   sp_chunk_body)
from butterfly_tpu_torch.parallel.tensor import (all_gather_cat,
                                                 data_groups, gather,
                                                 group_part, tmap)


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


class ServingEngine:
    """Device-side half of the serving stack (host half: sched/)."""

    def __init__(self, model: Model, params,
                 runtime: Optional[RuntimeConfig] = None, mesh=None,
                 use_kernels: Optional[bool] = None, device=None):
        self.model = model
        self.cfg = model.cfg
        self.runtime = runtime or RuntimeConfig()
        self.device = mesh_device(mesh, device, model)
        stage = stage_degree(mesh)
        if stage > 1 and self.cfg.num_layers % stage != 0:
            raise ValueError(
                f"{self.cfg.num_layers} layers not divisible by "
                f"{stage} pipeline stages")
        # Optional obs.trace.Tracer (the scheduler shares its own)
        self.tracer = None
        self.mesh = mesh
        self.params = place_params(params, self.cfg, self.device, mesh)
        # the weights on every distinct seq device, for the lane
        self._replicas = seq_replicas(self.params, mesh)
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
                                      device=self.device, mesh=mesh)
        # Host-side block-table mirror (the host is the only writer): the
        # whole int32 table transfers ONCE per dispatch that needs it.
        self._host_table = np.full(tuple(self.cache.page_table.shape),
                                   self.cache.null_page, np.int32)
        self._table_dirty = False
        # Write-combined KV window (kv_write_combine): mixed blocks stage
        # fresh K/V in an engine-held window, the pool stays read-only
        # inside a block, and a drain flushes the window into the pool.
        # The pipeline (stage > 1) writes its stage slices per token.
        self._window_mode = bool(self.runtime.kv_write_combine) \
            and stage == 1
        self._kv_window: Optional[KVWindow] = None
        self._win_len = None       # [S] staged count; None = seed zeros
        self._win_dirty = False    # staged entries not yet flushed
        self._win_hwm = 0          # host upper bound on staged entries
        # Speculation (speculative_gamma > 0): the draft source resolves
        # from runtime.draft_model NOW, so a typo fails at engine build;
        # the "model" source also builds its draft weights and allocates
        # its KV carry here. Tree speculation validates its geometry.
        self._tree_width = 0
        self._tree_nodes = 0
        self._draft_src = None
        self._draft_stateful = False
        self._draft_state = None
        if self.runtime.speculative_gamma > 0:
            self._init_speculation()

    def _init_speculation(self) -> None:
        rt = self.runtime
        name = rt.draft_model
        if name not in DRAFT_SOURCES:
            raise ValueError(
                f"unknown draft source {name!r}: expected one of "
                f"{sorted(DRAFT_SOURCES)} (register_draft_source)")
        entry = DRAFT_SOURCES[name]
        if getattr(entry, "draft_source_factory", False):
            self._draft_src = entry(self)
        elif hasattr(entry, "draft"):
            self._draft_src = entry        # a pre-built source object
        else:
            self._draft_src = _FnDraftSource(entry)
        self._draft_stateful = bool(getattr(self._draft_src, "stateful",
                                            False))
        if self._draft_stateful:
            self._draft_state = self._draft_src.init_state()
        if rt.spec_tree_width >= 2:
            w = rt.spec_tree_width
            # default node budget gamma+1: tree and linear verify the
            # same number of positions
            n = rt.spec_tree_nodes or (rt.speculative_gamma + 1)
            if n < w + 1 or (n - 1) % w != 0:
                raise ValueError(
                    f"spec_tree_nodes={n} invalid for width {w}: need n >= "
                    f"width+1 and (n-1) divisible by width (full sibling "
                    f"fans only)")
            if not hasattr(self._draft_src, "tree_draft"):
                raise ValueError(
                    f"spec_tree_width requires a draft source with "
                    f"tree_draft (the 'model' source); {rt.draft_model!r} "
                    f"has none")
            if stage_degree(self.mesh) > 1:
                raise ValueError(
                    "tree speculation does not compose with "
                    "pipeline (stage > 1) serving: the tree-mask "
                    "verify rides paged_forward's attn_mask, which "
                    "the stage-local pipeline scan has no slot for")
            self._tree_width, self._tree_nodes = w, n

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
        Needs a mesh with a seq axis > 1 (with tensor and data axes or
        not) and no pipeline stages (the ring body runs the whole layer
        stack on every seq shard)."""
        return self.sp_degree > 1 and stage_degree(self.mesh) == 1

    @property
    def sp_degree(self) -> int:
        """Size of the seq mesh axis (1 without a mesh)."""
        return seq_degree(self.mesh)

    @property
    def spec_tree_mode(self) -> bool:
        """Token-tree speculation on: a spec round drafts a width-w node
        tree and verifies it in one tree-masked forward."""
        return self._tree_nodes > 0

    @property
    def spec_tree_geometry(self) -> Tuple[int, int]:
        """(width, nodes) of the validated tree; (0, 0) off."""
        return self._tree_width, self._tree_nodes

    @property
    def spec_emit_width(self) -> int:
        """Max tokens a spec round emits per slot (the C of the (toks,
        valid) stack): gamma + 1 linear; the tree's depth + 1."""
        if self.spec_tree_mode:
            return tree_depth(self._tree_width, self._tree_nodes) + 1
        return self.runtime.speculative_gamma + 1

    @property
    def mixed_dispatch_ready(self) -> bool:
        """Can the scheduler route this engine through mixed blocks?
        mixed_dispatch on AND a stateless draft source (a stateful
        source's admission hook, draft_prefill, needs the drain barrier
        mixed dispatch deletes) AND no tree speculation (no fused mixed
        tree program)."""
        return bool(self.runtime.mixed_dispatch) \
            and not self._draft_stateful and not self.spec_tree_mode

    @property
    def mixed_fallback_reason(self) -> Optional[str]:
        """Why mixed_dispatch_ready is False although the config asks for
        mixed dispatch (the scheduler reports it in metrics()); None when
        mixed is off by config or on."""
        if not self.runtime.mixed_dispatch or self.mixed_dispatch_ready:
            return None
        if self._draft_stateful:
            return ("stateful draft source "
                    f"({self.runtime.draft_model!r}) needs the "
                    "admission drain barrier for draft_prefill")
        return "tree speculation has no fused mixed program"

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
                self._kv_window = init_kv_window(self.cache, width,
                                                 self.mesh)
                self._win_len = None
        if self._win_len is None:
            self._win_len = torch.zeros((self.num_slots,), dtype=torch.int32,
                                        device=self.device)

    @under_mesh
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

    @under_mesh
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

    @under_mesh
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
        groups = data_groups(self.cache.num_slots, self.mesh)
        d = 0 if groups is None else next(
            g.index for g in groups if g.rows.start <= slot < g.rows.stop)
        logits = _sp_chunk(self.cfg, self._replicas, self.mesh,
                           self._h2d(buf, torch.int32), self.cache,
                           self._host_table[slot], self._h2d, start,
                           len(tokens), d)
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

    @under_mesh
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

    @under_mesh
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

    @under_mesh
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

    @under_mesh
    def read_pages(self, pids):
        """Page contents on the host: (k [L, n, Kv, page, H], v, k_scales,
        v_scales) as CPU tensors — scales [L, n, Kv*page] iff the pool is
        int8, else None. A pool split over `tensor` reads each shard's
        pages and concatenates the kv heads (and the kv-major scale
        columns) in shard order, one split over `stage` each stage's
        layers in stage order: the unsharded engine's bytes. Where the
        stage (or tensor) axis crosses processes the other processes'
        layers (or heads) come through an all-gather: every process
        calls it at the same point. Synchronous."""
        if self._win_dirty:
            self.flush_kv_window()
        c = pool_replicas(self.cache)[0]
        idx = torch.as_tensor(list(pids), dtype=torch.long)

        def read(pool):
            if pool is None:
                return None
            if axis_parts(pool, "stage") is not None:
                out = torch.cat([read(group_part(p, 0)) for p in
                                 axis_parts(pool, "stage")], dim=0)
                # the other processes' stages, in stage order
                return all_gather_cat(out, 0, axis_group("stage")) \
                    if pool.distributed else out
            parts = axis_parts(pool, "tensor")
            if parts is None:
                return pool[:, idx.to(pool.device)].cpu()
            # every shard's heads, in shard order (across processes, an
            # all-gather every process joins)
            return gather(pool.like([p[:, idx.to(p.device)] for p in parts]),
                          2).cpu()
        return (read(c.k_pages), read(c.v_pages), read(c.k_scale_pages),
                read(c.v_scale_pages))

    @under_mesh
    def write_pages(self, pids, k, v, k_scales=None, v_scales=None) -> None:
        """Land page contents (the read_pages layout) at page ids pids:
        split over the layers into each stage's pools and over the kv
        heads into each tensor shard's pool, in every data replica of the
        pool."""
        def write(pool, val, dtype):
            stages = axis_parts(pool, "stage")
            if stages is not None:
                val = torch.as_tensor(val)
                lo = pool.offset * stages[0].shape[0]   # this process's
                for p in stages:
                    n = p.shape[0]
                    for rep in axis_parts(p, "data") or [p]:
                        write(rep, val[lo:lo + n], dtype)
                    lo += n
                return
            parts = axis_parts(pool, "tensor") or [pool]
            val = torch.as_tensor(val)
            sizes = [p.shape[2] for p in parts]
            if isinstance(pool, Shards) and pool.distributed:
                val = val.narrow(2, pool.offset * sizes[0], sum(sizes))
            for p, vp in zip(parts, torch.split(val, sizes, dim=2)):
                idx = torch.as_tensor(list(pids), dtype=torch.long,
                                      device=p.device)
                p[:, idx] = vp.to(p.device, dtype)
        for c in pool_replicas(self.cache):
            write(c.k_pages, k, c.k_pages.dtype)
            write(c.v_pages, v, c.v_pages.dtype)
            if c.quantized:
                write(c.k_scale_pages, k_scales, torch.float32)
                write(c.v_scale_pages, v_scales, torch.float32)

    # -- speculation ------------------------------------------------------

    @under_mesh
    def draft_prefill(self, slots, rows, lens) -> None:
        """Reseed newly admitted slots' draft-model KV from host truth
        (the scheduler's admission, with the same prompt rows it seeds
        the history with, the first sampled token excluded: the
        draft_len == hist_len - 1 invariant). Stateful sources only;
        admission runs behind a full drain barrier."""
        if not self._draft_stateful:
            return
        self._draft_state = self._draft_src.prefill(
            self._draft_state, slots, rows, lens)

    def _spec_generators(self, seed: int, n: int):
        """`n` device generators for one block's independent random
        streams (accept, draft, prefill-lane first tokens), seeded from
        the block seed: the port's counterpart of the JAX block key's
        three fold_in ranges."""
        host = torch.Generator(device="cpu")
        host.manual_seed(int(seed))
        seeds = torch.randint(0, 2**62, (n,), generator=host).tolist()
        return tuple(self._block_generator(s) for s in seeds)

    @under_mesh
    def spec_block_async(self, hist, hist_len, active: np.ndarray,
                         temps: np.ndarray, stops: np.ndarray, budgets,
                         spec_mask: np.ndarray, seed: int, rounds: int):
        """Dispatch ONE fused speculative block, no host sync: `rounds`
        chained draft -> batched verify -> on-device accept rounds for
        every active slot (_spec_scan, or _spec_tree_scan in tree mode,
        with their _win twins under kv_write_combine). Drafts read the
        device token history (`hist` [S, H], `hist_len` [S]); per-slot
        stop ids and budgets kill finished slots on the device; `budgets`
        is a host array or the previous block's device remainder;
        `spec_mask` [S] False opts a slot out of draft acceptance. `seed`
        seeds the block's generators. A stateful draft source's KV rides
        the same carry. Returns (toks [rounds, S, C], valid [rounds, S,
        C], hist, hist_len, rem), all on the device, C =
        spec_emit_width."""
        self._sync_table()
        tree = self.spec_tree_mode
        rt = self.runtime
        # the history advances in place inside the block: a copy keeps
        # the caller's binding (an earlier block's result) intact
        hist = self._h2d(hist, torch.int32).clone()
        args = (self._h2d(hist_len, torch.int32), self.cache,
                self._draft_state)
        rest = (self._h2d(active, torch.bool), self._h2d(temps, torch.float32),
                self._h2d(stops, torch.int32), self._h2d(budgets, torch.int32),
                self.runtime_top_k, self.runtime_top_p,
                self._spec_generators(seed, 2),
                self._h2d(spec_mask, torch.bool))
        geo = (rounds, self._tree_width, self._tree_nodes) if tree \
            else (rounds, rt.speculative_gamma, rt.speculative_ngram)
        if self._window_mode:
            # per-round window demand is the VERIFY width: N staged tree
            # nodes, or the linear chunk gamma+1
            C = self._tree_nodes if tree else rt.speculative_gamma + 1
            self._ensure_window(rounds * C)
            fn = _spec_tree_scan_win if tree else _spec_scan_win
            (toks, valid, hist, hlen, rem, cache, window, wlen,
             dstate) = fn(self.cfg, *geo, self._draft_src, self.params, hist,
                          *args, self._kv_window, self._win_len, *rest,
                          use_kernel=self._use_kernels)
            self.cache, self._kv_window, self._win_len = cache, window, wlen
            self._draft_state = dstate
            self._win_dirty = True
            self._win_hwm += rounds * C
            return toks, valid, hist, hlen, rem
        fn = _spec_tree_scan if tree else _spec_scan
        toks, valid, hist, hlen, rem, self.cache, self._draft_state = fn(
            self.cfg, *geo, self._draft_src, self.params, hist, *args, *rest,
            use_kernel=self._use_kernels)
        return toks, valid, hist, hlen, rem

    @under_mesh
    def mixed_spec_block_async(self, hist, hist_len, cursor, plen,
                               active: np.ndarray, temps: np.ndarray,
                               stops: np.ndarray, budgets,
                               spec_mask: np.ndarray, seed: int,
                               rounds: int):
        """Dispatch ONE fused speculative MIXED block: spec_block_async
        with prefill lanes (_mixed_spec_scan[_win]). The history carry
        doubles as the prompt buffer; `cursor` [S] is the device chunk
        cursor and `plen` [S] the prompt lengths. A completing prefill
        slot's first token arrives as one valid entry at column 0 of its
        completion round. Stateless draft sources only. Returns (toks,
        valid, hist, hist_len, rem, cursor)."""
        self._sync_table()
        rt = self.runtime
        hist = self._h2d(hist, torch.int32).clone()
        args = (self._h2d(hist_len, torch.int32),
                self._h2d(cursor, torch.int32), self._h2d(plen, torch.int32),
                self.cache)
        rest = (self._h2d(active, torch.bool), self._h2d(temps, torch.float32),
                self._h2d(stops, torch.int32), self._h2d(budgets, torch.int32),
                self.runtime_top_k, self.runtime_top_p,
                self._spec_generators(seed, 3),
                self._h2d(spec_mask, torch.bool))
        geo = (rounds, rt.speculative_gamma, rt.speculative_ngram,
               self._draft_src, self.params)
        if self._window_mode:
            C = rt.speculative_gamma + 1
            self._ensure_window(rounds * C)
            (toks, valid, hist, hlen, rem, cursor, cache, window,
             wlen) = _mixed_spec_scan_win(
                self.cfg, *geo, hist, *args, self._kv_window, self._win_len,
                *rest, use_kernel=self._use_kernels)
            self.cache, self._kv_window, self._win_len = cache, window, wlen
            self._win_dirty = True
            self._win_hwm += rounds * C
            return toks, valid, hist, hlen, rem, cursor
        toks, valid, hist, hlen, rem, cursor, self.cache = _mixed_spec_scan(
            self.cfg, *geo, hist, *args, *rest, use_kernel=self._use_kernels)
        return toks, valid, hist, hlen, rem, cursor


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
              clen: int, data_index: int = 0) -> torch.Tensor:
    """One seq-parallel chunk against one slot's table row (host array),
    on the ring of the slot's data group `data_index`: gather the slot's
    flushed prefix for every layer (the pages holding positions < start;
    one page when there are none) from the group's pool replica, per
    tensor shard of a split pool, run the chunk through sp_chunk_body,
    then scatter its K/V IN PLACE into EVERY pool replica (a slot may
    later decode in any replica's reads), with one all-layer write per
    pool tensor and tensor shard, pad rows (>= clen) routed to the null
    page. Returns the chunk's last real token's logits [V]. Where the seq
    axis crosses processes every process of a seq group holds the whole
    pool (its tensor shards of it), so each shard's K/V is all-gathered
    over the seq group before the scatter, and the holder of the last
    real token broadcasts its logits."""
    reps = pool_replicas(cache)
    src = reps[data_index if len(reps) > 1 else 0]
    first = (axis_parts(src.k_pages, "tensor") or [src.k_pages])[0]
    L, Pp, _, pg, H = first.shape
    mp = row.shape[0]
    S_full = mp * pg
    n_live = max(1, -(-start // pg))
    live = h2d(row[:n_live], torch.long)
    S = n_live * pg

    def codes(p):     # [L, 1, Kv, S, H]
        return p[:, live.to(p.device)].transpose(1, 2).reshape(
            L, 1, p.shape[2], S, H)

    def scales(sc):   # [L, 1, Kv, S] from the kv-major flat dim
        kv = sc.shape[2] // pg
        return sc[:, live.to(sc.device)].reshape(L, n_live, kv, pg) \
            .transpose(1, 2).reshape(L, 1, kv, S)

    def floats(p):    # [L, 1, S, Kv, H]
        return p[:, live.to(p.device)].transpose(2, 3).reshape(
            L, 1, S, p.shape[2], H)
    if cache.quantized:
        prefix = (tmap(codes, src.k_pages, out_split=2),
                  tmap(codes, src.v_pages, out_split=2),
                  tmap(scales, src.k_scale_pages, out_split=2),
                  tmap(scales, src.v_scale_pages, out_split=2))
    else:
        prefix = (tmap(floats, src.k_pages, out_split=3),
                  tmap(floats, src.v_pages, out_split=3))
    logits, kv = sp_chunk_body(replicas, cfg, tokens, start, prefix, mesh,
                               data_index)
    del prefix
    C = tokens.shape[1]
    Cl = C // len(logits)
    if any(c is None for c in kv):      # other processes' shards
        kv = list(zip(*(gather_local([None if c is None else c[j]
                                      for c in kv], mesh.axis_group("seq"))
                        for j in range(len(next(c for c in kv if c))))))

    def part(x, t):
        return x.parts[t] if isinstance(x, Shards) else x
    for rep in reps:
        n = len(axis_parts(rep.k_pages, "tensor") or [rep.k_pages])
        pools = [axis_parts(getattr(rep, name), "tensor")
                 or [getattr(rep, name)] * n for name in
                 ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages")]
        for t, (kp, vp, ksp, vsp) in enumerate(zip(*pools)):
            dev = kp.device
            ar = torch.arange(C, device=dev)
            pos = start + ar
            row_t = h2d(row, torch.long).to(dev)
            page_idx = row_t[(pos // pg).clamp(0, mp - 1)]
            page_idx = torch.where((ar < clen) & (pos < S_full), page_idx,
                                   torch.full_like(page_idx, kp.shape[1] - 1))
            off = pos % pg

            def chunk(j, dim):
                return torch.cat([part(c[j], t).to(dev) for c in kv],
                                 dim=dim)
            # advanced indices at dims 1 and 3 (a slice between) put the
            # index dim first: the indexed view is [C, L, Kv, H]
            if cache.quantized:
                ck, cv = chunk(0, 3), chunk(1, 3)      # [L,1,Kv,C,H]
                cks, cvs = chunk(2, 3), chunk(3, 3)    # [L,1,Kv,C]
                kp[:, page_idx, :, off] = ck[:, 0].permute(2, 0, 1, 3)
                vp[:, page_idx, :, off] = cv[:, 0].permute(2, 0, 1, 3)
                # the flat scale dim is kv-major: col = kv * page + offset
                cols = torch.arange(kp.shape[2], device=dev)[None, :] * pg \
                    + off[:, None]
                ksp[:, page_idx[:, None], cols] = cks[:, 0].permute(0, 2, 1)
                vsp[:, page_idx[:, None], cols] = cvs[:, 0].permute(0, 2, 1)
            else:
                ck, cv = chunk(0, 2), chunk(1, 2)      # [L,1,C,Kv,H]
                kp[:, page_idx, :, off] = \
                    ck[:, 0].transpose(0, 1).to(kp.dtype)
                vp[:, page_idx, :, off] = \
                    cv[:, 0].transpose(0, 1).to(vp.dtype)
    shard, r = divmod(clen - 1, Cl)
    return shard_row(logits, mesh, shard, r, tokens.device)[0]


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


# ---------------------------------------------------------------------------
# Speculative blocks
# ---------------------------------------------------------------------------

def _ngram_drafts(hist, hist_len, gamma: int, ngram: int) -> torch.Tensor:
    """Prompt-lookup drafts for every slot, on the device (the batched
    twin of engine._ngram_draft): the most recent STRICTLY-EARLIER
    occurrence of each slot's trailing `ngram` tokens in its history
    hist [S, H] (live length hist_len [S]) and the `gamma` tokens that
    followed it, zero-padded where the continuation runs out or no match
    exists."""
    S, H = hist.shape
    dev = hist.device
    pos = torch.arange(H, device=dev)
    hl = hist_len.long()
    nr = torch.arange(ngram, device=dev)
    tail = torch.gather(hist, 1, (hl[:, None] - ngram + nr[None, :])
                        .clamp(0, H - 1))                        # [S, n]
    wins = hist[:, (pos[:, None] + nr[None, :]).clamp(0, H - 1)]  # [S,H,n]
    ok = (wins == tail[:, None, :]).all(-1)                      # [S, H]
    # the window must END before the tail starts, and a history no
    # longer than the ngram has nothing to look up
    ok = ok & ((pos[None, :] + ngram) <= (hl[:, None] - 1)) \
        & (hl > ngram)[:, None]
    i_star = torch.where(ok, pos[None, :], torch.full_like(ok, -1,
                                                            dtype=torch.long)
                         ).amax(dim=1)                           # [S]
    src = i_star[:, None] + ngram + torch.arange(gamma, device=dev)[None, :]
    valid = (i_star >= 0)[:, None] & (src < hl[:, None])
    cont = torch.gather(hist, 1, src.clamp(0, H - 1))
    return torch.where(valid, cont, torch.zeros_like(cont)).to(torch.int32)


class _FnDraftSource:
    """A plain draft FUNCTION ((hist [S, H], hist_len [S], gamma, ngram)
    -> drafts [S, gamma] int32, torch ops on the device) as a draft
    source: stateless, no proposal distribution (q one-hot at the
    draft)."""

    stateful = False

    def __init__(self, fn):
        self.fn = fn

    def init_state(self):
        return None

    def draft(self, hist, hlen, gamma, ngram, live, state, generator, temps,
              top_k, top_p):
        return self.fn(hist, hlen, gamma, ngram), None, None


def _build_model_draft_source(engine: "ServingEngine"):
    """DRAFT_SOURCES["model"] factory: a real on-device draft model
    (models/draft.py): an independent narrow checkpoint when
    RuntimeConfig.draft_ckpt is set (loaded on the engine's device, then
    cast as the reference casts it; on a mesh it is placed like the
    target's tree), else the truncated-layer derivation of the engine's
    own params (the first draft_layers layers, embed/unembed shared:
    already cast or quantized like the target, since the leaves ARE the
    target's). Under a stage mesh the draft runs whole on stage 0's mesh
    (the JAX package replicates it over the stages), its layers taken
    from the first stages' slices (views where every stage shares one
    device, parallel/partition.py:leading_layers). On a mesh over several
    processes it runs where only the seq axis (and a data axis inside)
    crosses them, each process drafting on its own whole tree; a tensor,
    stage or expert axis across them raises RuntimeError at engine build,
    where the JAX package fails at its first spec block."""
    from butterfly_tpu_torch.models.draft import (ModelDraftSource,
                                                  derive_draft_params,
                                                  resolve_draft_layers)
    from butterfly_tpu_torch.parallel.partition import (layers_per_stage,
                                                        leading_layers,
                                                        stage_part)
    rt = engine.runtime
    mesh, params = engine.mesh, engine.params
    crossing = [] if mesh is None else [
        a for a in ("tensor", "stage", "expert")
        if mesh.axis_group(a) is not None]
    if crossing:
        raise RuntimeError(
            f"the draft-model source on a mesh whose {crossing[0]} axis "
            "crosses processes is refused: the JAX package fails there at "
            "its first spec block (sched/scheduler.py:1818 spec_block_async "
            "-> engine/serving.py:1183/1201: 'Closing over jax.Array that "
            "spans non-addressable devices', the draft closing over the "
            "target's leaves), so the port does not run it; the n-gram "
            "source runs there, and the draft model runs where only the "
            "seq axis crosses processes")
    if stage_degree(mesh) > 1:
        staged = params
        mesh, params = mesh.stage_mesh(0), stage_part(params, 0)
        if not rt.draft_ckpt:
            n = resolve_draft_layers(engine.cfg, rt.draft_layers)
            params = {**params, "layers": leading_layers(
                staged["layers"], n, layers_per_stage(engine.cfg,
                                                      engine.mesh))}
    if rt.draft_ckpt:
        from butterfly_tpu_torch.ckpt.load import load_draft_checkpoint
        from butterfly_tpu_torch.engine.engine import cast_params
        dcfg, dparams = load_draft_checkpoint(rt.draft_ckpt, engine.cfg,
                                              engine.device)
        dparams = cast_params(dparams, dcfg)
        if mesh is not None:
            from butterfly_tpu_torch.parallel.partition import shard_params
            dparams = shard_params(dparams, dcfg, mesh)
    else:
        dcfg, dparams = derive_draft_params(params, engine.cfg,
                                            rt.draft_layers)
    # width = serving max_seq + γ+1 slack: micro-step writes at the
    # sequence cap clamp into slack, never onto a live entry
    return ModelDraftSource(
        dcfg, dparams, num_slots=engine.num_slots,
        width=engine.cache.max_seq + rt.speculative_gamma + 1,
        kv_quant=rt.kv_quant, mesh=mesh)


_build_model_draft_source.draft_source_factory = True


#: Draft sources for the spec block (RuntimeConfig.draft_model selects by
#: name). An entry is a plain draft function (hist [S, H], hist_len [S],
#: gamma, ngram) -> drafts [S, gamma] int32 ("ngram", prompt lookup), or
#: a FACTORY (attribute draft_source_factory=True) called with the engine
#: at build time and returning a source with `.stateful`, `.init_state()`,
#: `.draft(hist, hlen, gamma, ngram, live, state, generator, temps, top_k,
#: top_p) -> (drafts, q_logits, state)` and, when stateful, `.prefill(
#: state, slots, rows, lens)` ("model", the on-device draft model).
DRAFT_SOURCES: Dict[str, object] = {
    "ngram": _ngram_drafts,
    "model": _build_model_draft_source,
}


def register_draft_source(name: str, fn) -> None:
    """Register a custom draft source (the DRAFT_SOURCES contract)."""
    DRAFT_SOURCES[name] = fn


def _draft_rollback(dstate, dlen0, live, m):
    """Roll the draft-model KV length back to the ACCEPTED count: the
    micro-steps advanced a live slot to dlen0 + γ+1; only the m accepted
    emissions stay, the rejected drafts' K/V sit past the length and
    the next round overwrites them from dlen0 + m. None for stateless
    sources."""
    if dstate is None:
        return None
    return dstate._replace(
        length=torch.where(live, dlen0 + m, dlen0).to(torch.int32))


def _last_token(hist, hlen):
    """Each slot's newest history token [S]."""
    H = hist.shape[1]
    return torch.gather(hist, 1,
                        (hlen.long() - 1).clamp(0, H - 1)[:, None])[:, 0]


def _spec_live0(hist, hist_len, active, stops, budgets, is_pf0=None):
    """Liveness at block start: inactive, out of budget, or whose last
    history token is its stop id starts dead (prefill-phase slots skip
    the stop check: their history tail is prompt)."""
    has_stop = stops >= 0
    check = has_stop if is_pf0 is None else has_stop & ~is_pf0
    live = active & (budgets > 0) & torch.where(
        check, _last_token(hist, hist_len) != stops,
        torch.ones_like(has_stop))
    return has_stop, live


def _spec_valid(emitted, n_acc, rem, live, stops, has_stop, C: int,
                lanes=None):
    """A round's valid emissions [S, C]: the accepted prefix n_acc + 1,
    clipped at the remaining budget and cut at the first stop id
    INCLUSIVE (the stop token itself emits); `lanes` [S] limits them to
    decode-phase slots."""
    col = torch.arange(C, device=emitted.device)[None, :]
    cand = (col <= n_acc[:, None]) & (col < rem[:, None])
    if lanes is not None:
        cand = cand & lanes[:, None]
    stop_at = cand & has_stop[:, None] & (emitted == stops[:, None])
    si = stop_at.to(torch.int32)
    prior = torch.cumsum(si, dim=1) - si
    return cand & (prior == 0) & live[:, None]


def _spec_commit(hist, hlen, rem, live, emitted, valid, stops, has_stop):
    """Append a round's valid emissions to the history carry (IN PLACE,
    at hlen ..), spend the budget, and kill slots whose emission hit
    their stop id or that ran out. Returns (hlen, rem, live, m)."""
    S, H = hist.shape
    C = emitted.shape[1]
    m = valid.sum(dim=1).to(torch.int32)
    col = torch.arange(C, device=hist.device)[None, :]
    wpos = (hlen.long()[:, None] + col).clamp(0, H - 1)
    rows = torch.arange(S, device=hist.device)[:, None].expand(S, C)
    cur = torch.gather(hist, 1, wpos)
    hist[rows, wpos] = torch.where(valid, emitted, cur)
    hlen = torch.where(live, hlen + m, hlen).to(torch.int32)
    rem = torch.where(live, rem - m, rem)
    died = (valid & has_stop[:, None] & (emitted == stops[:, None])).any(1)
    live = live & ~died & (rem > 0)
    return hlen, rem, live, m


def _spec_scan(cfg: ModelConfig, rounds: int, gamma: int, ngram: int,
               draft_src, params, hist, hist_len, cache: PagedKVCache,
               dstate, active, temps, stops, budgets, top_k: int,
               top_p: float, gens, spec_mask, use_kernel: bool = False):
    """`rounds` chained speculative rounds (the JAX lax.scan as a Python
    loop of device work), window off. Each round, for every live slot:
    draft gamma tokens (draft_src.draft: prompt lookup over the history,
    or the draft model over its KV carry `dstate`, with its proposal
    logits), ONE batched (gamma+1)-token verify forward over [S, C]
    writing every position's K/V (the dense warm path), accept on the
    device (speculative_accept), truncate at the stop id / budget, roll
    the cache length back to W + m (the old chain token + the accepted
    drafts; the last emission is never written, decode-style) and the
    draft length likewise, and append the survivors to the history.
    Rejected positions hold stale K/V past the length; the next round's
    C-wide chunk starts there and rewrites them before any query can
    attend that far. `gens` = (accept, draft) generators.

    Returns (toks [rounds, S, C], valid [rounds, S, C], hist, hist_len,
    rem, cache, dstate)."""
    g_acc, g_draft = gens[0], gens[1]
    C = gamma + 1
    has_stop, live = _spec_live0(hist, hist_len, active, stops, budgets)
    hlen, rem, dst = hist_len, budgets, dstate
    toks_out, valid_out = [], []
    for _ in range(rounds):
        dlen0 = dst.length if dst is not None else None
        drafts, qlog, dst = draft_src.draft(
            hist, hlen, gamma, ngram, live, dst, g_draft, temps, top_k,
            top_p)
        toks = torch.cat([_last_token(hist, hlen)[:, None], drafts], dim=1)
        W = cache.lengths
        logits, cache = paged_forward(params, cfg, toks, cache, active=live,
                                      use_kernel=use_kernel)
        emitted, n_acc = speculative_accept(logits, drafts, g_acc, temps,
                                            top_k, top_p, spec_mask, qlog)
        valid = _spec_valid(emitted, n_acc, rem, live, stops, has_stop, C)
        hlen, rem, live2, m = _spec_commit(hist, hlen, rem, live, emitted,
                                           valid, stops, has_stop)
        cache = cache._replace(
            lengths=torch.where(live, W + m, W).to(torch.int32))
        dst = _draft_rollback(dst, dlen0, live, m)
        live = live2
        toks_out.append(emitted)
        valid_out.append(valid)
    return (torch.stack(toks_out), torch.stack(valid_out), hist, hlen, rem,
            cache, dst)


def _spec_scan_win(cfg: ModelConfig, rounds: int, gamma: int, ngram: int,
                   draft_src, params, hist, hist_len, cache: PagedKVCache,
                   dstate, window: KVWindow, win_len, active, temps, stops,
                   budgets, top_k: int, top_p: float, gens, spec_mask,
                   use_kernel: bool = False):
    """Write-combined twin of _spec_scan with IDENTICAL draft / verify /
    accept semantics: each verify stages all C = gamma+1 positions into
    the window at win_len, and win_len advances by the ACCEPTED count m
    only, so a rejected draft's K/V sits past win_len, is never attended
    and never flushed (the pool never holds speculative state). The
    draft carry rolls back by the same count.

    Returns (toks, valid, hist, hist_len, rem, cache, window, win_len,
    dstate)."""
    g_acc, g_draft = gens[0], gens[1]
    C = gamma + 1
    has_stop, live = _spec_live0(hist, hist_len, active, stops, budgets)
    hlen, rem, dst, wlen = hist_len, budgets, dstate, win_len
    toks_out, valid_out = [], []
    for _ in range(rounds):
        dlen0 = dst.length if dst is not None else None
        drafts, qlog, dst = draft_src.draft(
            hist, hlen, gamma, ngram, live, dst, g_draft, temps, top_k,
            top_p)
        toks = torch.cat([_last_token(hist, hlen)[:, None], drafts], dim=1)
        logits, window = paged_forward_window(params, cfg, toks, cache,
                                              window, wlen, active=live,
                                              use_kernel=use_kernel)
        emitted, n_acc = speculative_accept(logits, drafts, g_acc, temps,
                                            top_k, top_p, spec_mask, qlog)
        valid = _spec_valid(emitted, n_acc, rem, live, stops, has_stop, C)
        hlen, rem, live2, m = _spec_commit(hist, hlen, rem, live, emitted,
                                           valid, stops, has_stop)
        wlen = torch.where(live, wlen + m, wlen).to(torch.int32)
        dst = _draft_rollback(dst, dlen0, live, m)
        live = live2
        toks_out.append(emitted)
        valid_out.append(valid)
    return (torch.stack(toks_out), torch.stack(valid_out), hist, hlen, rem,
            cache, window, wlen, dst)


def _tree_tables(width: int, nodes: int, device):
    """(depth [N], ancestor matrix [N, N]) of the token tree on `device`,
    copied once per block through pinned memory without blocking."""
    depth = np.zeros((nodes,), np.int64)
    for d in range(1, tree_depth(width, nodes) + 1):
        for j in range(width):
            depth[tree_node_index(d, j, width)] = d
    out = []
    for a in (depth, tree_ancestor_matrix(width, nodes)):
        t = torch.from_numpy(a)
        if torch.device(device).type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return tuple(out)


def _tree_chunk_operands(tables, base, s_max: int):
    """RoPE positions [S, N] and the tree-attention mask [S, N, s_max] of
    one tree-verify chunk whose node 0 sits at absolute position `base`
    [S]; `tables` = _tree_tables(width, nodes). positions = base +
    depth(n) (siblings share a RoPE position but occupy distinct storage
    at base + chunk index); node n attends committed history (j < base)
    and its own root->n ancestor path (self included), never a sibling
    branch."""
    depth, anc = tables
    nodes = depth.shape[0]
    b = base.long()
    positions = b[:, None] + depth[None, :]
    j_abs = torch.arange(s_max, device=b.device)[None, :]
    rel = j_abs - b[:, None]                                  # [S, Smax]
    tree_bits = anc[:, rel.clamp(0, nodes - 1)]               # [N,S,Smax]
    mask = (j_abs < b[:, None])[:, None, :] \
        | (((rel >= 0) & (rel < nodes))[:, None, :]
           & tree_bits.permute(1, 0, 2))
    return positions, mask


def _spec_tree_scan(cfg: ModelConfig, rounds: int, width: int, nodes: int,
                    draft_src, params, hist, hist_len, cache: PagedKVCache,
                    dstate, active, temps, stops, budgets, top_k: int,
                    top_p: float, gens, spec_mask,
                    use_kernel: bool = False):
    """Token-TREE twin of _spec_scan: each round drafts a width-w, N-node
    tree (draft_src.tree_draft), verifies all N nodes in ONE forward
    under the tree mask (_tree_chunk_operands), walks the
    recursive-residual accept (speculative_tree_accept), then compacts
    the accepted path's K/V to base..base+m-1 (permute_paged_tail) and
    rolls the length back to base + m; rejected branches sit past it and
    the next round's N-wide chunk rewrites them. The emission width is
    D+1, narrower than the verify width N. The draft cache rolls back to
    base + m too.

    Returns _spec_scan's tuple with C = D+1."""
    g_acc, g_draft = gens[0], gens[1]
    D = tree_depth(width, nodes)
    C = D + 1
    S = hist.shape[0]
    tables = _tree_tables(width, nodes, hist.device)
    has_stop, live = _spec_live0(hist, hist_len, active, stops, budgets)
    hlen, rem, dst = hist_len, budgets, dstate
    toks_out, valid_out = [], []
    for _ in range(rounds):
        dlen0 = dst.length if dst is not None else None
        drafts, qlog, dst = draft_src.tree_draft(
            hist, hlen, width, D, live, dst, g_draft, temps, top_k, top_p)
        toks = torch.cat([_last_token(hist, hlen)[:, None],
                          drafts.reshape(S, D * width)], dim=1)
        W = cache.lengths
        positions, mask = _tree_chunk_operands(tables, W, cache.max_seq)
        logits, cache = paged_forward(params, cfg, toks, cache, active=live,
                                      use_kernel=use_kernel,
                                      positions=positions, attn_mask=mask)
        emitted, n_acc, perm = speculative_tree_accept(
            logits, drafts, g_acc, temps, top_k, top_p, spec_mask, qlog,
            width=width, nodes=nodes)
        valid = _spec_valid(emitted, n_acc, rem, live, stops, has_stop, C)
        hlen, rem, live2, m = _spec_commit(hist, hlen, rem, live, emitted,
                                           valid, stops, has_stop)
        cache = permute_paged_tail(cache._replace(lengths=W), perm,
                                   active=live)
        cache = cache._replace(
            lengths=torch.where(live, W + m, W).to(torch.int32))
        dst = _draft_rollback(dst, dlen0, live, m)
        live = live2
        toks_out.append(emitted)
        valid_out.append(valid)
    return (torch.stack(toks_out), torch.stack(valid_out), hist, hlen, rem,
            cache, dst)


def _spec_tree_scan_win(cfg: ModelConfig, rounds: int, width: int,
                        nodes: int, draft_src, params, hist, hist_len,
                        cache: PagedKVCache, dstate, window: KVWindow,
                        win_len, active, temps, stops, budgets, top_k: int,
                        top_p: float, gens, spec_mask,
                        use_kernel: bool = False):
    """Write-combined twin of _spec_tree_scan: the verify stages all N
    nodes at win_len (chunk order), permute_window_tail compacts the
    accepted path to win_len..win_len+m-1, and win_len advances by m, so
    rejected branches are never attended or flushed. Node 0 sits at
    cache.lengths + win_len (flushed + staged), which the mask's
    `j < base` covers.

    Returns _spec_scan_win's tuple with C = D+1."""
    g_acc, g_draft = gens[0], gens[1]
    D = tree_depth(width, nodes)
    C = D + 1
    S = hist.shape[0]
    tables = _tree_tables(width, nodes, hist.device)
    has_stop, live = _spec_live0(hist, hist_len, active, stops, budgets)
    hlen, rem, dst, wlen = hist_len, budgets, dstate, win_len
    toks_out, valid_out = [], []
    for _ in range(rounds):
        dlen0 = dst.length if dst is not None else None
        drafts, qlog, dst = draft_src.tree_draft(
            hist, hlen, width, D, live, dst, g_draft, temps, top_k, top_p)
        toks = torch.cat([_last_token(hist, hlen)[:, None],
                          drafts.reshape(S, D * width)], dim=1)
        positions, mask = _tree_chunk_operands(
            tables, cache.lengths + wlen, cache.max_seq)
        logits, window = paged_forward_window(
            params, cfg, toks, cache, window, wlen, active=live,
            use_kernel=use_kernel, positions=positions, attn_mask=mask)
        emitted, n_acc, perm = speculative_tree_accept(
            logits, drafts, g_acc, temps, top_k, top_p, spec_mask, qlog,
            width=width, nodes=nodes)
        valid = _spec_valid(emitted, n_acc, rem, live, stops, has_stop, C)
        hlen, rem, live2, m = _spec_commit(hist, hlen, rem, live, emitted,
                                           valid, stops, has_stop)
        window = permute_window_tail(window, wlen, perm)
        wlen = torch.where(live, wlen + m, wlen).to(torch.int32)
        dst = _draft_rollback(dst, dlen0, live, m)
        live = live2
        toks_out.append(emitted)
        valid_out.append(valid)
    return (torch.stack(toks_out), torch.stack(valid_out), hist, hlen, rem,
            cache, window, wlen, dst)


def _mixed_spec_round(logits, drafts, qlog, is_pf, count, cursor, plen,
                      live, rem, stops, has_stop, temps, top_k: int,
                      top_p: float, g_acc, g_pf, spec_mask, C: int):
    """Accept + emission of one mixed spec round: decode lanes take
    _spec_scan's accept and truncation; a prefill lane whose chunk
    completes the prompt samples its FIRST token from the chunk's last
    real column (the third generator) and emits it as one valid entry at
    column 0. Returns (emitted, valid, adv): adv is each lane's real
    K/V advance (a prefill chunk's length, a decode round's m)."""
    emitted, n_acc = speculative_accept(logits, drafts, g_acc, temps, top_k,
                                        top_p, spec_mask, qlog)
    valid = _spec_valid(emitted, n_acc, rem, live, stops, has_stop, C,
                        lanes=~is_pf)
    completing = is_pf & (cursor + count >= plen)
    V = logits.shape[-1]
    sidx = (count - 1).clamp(0, C - 1).long()
    lg = torch.gather(logits, 1, sidx[:, None, None].expand(-1, 1, V))[:, 0]
    first = sample_batched(lg, g_pf, temps, top_k, top_p)
    col0 = torch.arange(C, device=logits.device)[None, :] == 0
    emitted = torch.where(is_pf[:, None] & col0, first[:, None], emitted)
    valid = valid | ((completing & live)[:, None] & col0)
    m = valid.sum(dim=1).to(torch.int32)
    return emitted, valid, torch.where(is_pf, count, m)


def _mixed_spec_io(hist, hlen, cursor, plen, drafts, C: int):
    """A mixed spec round's [S, C] tokens: a prefill lane's next C prompt
    tokens from its history row (the prompt buffer under spec), a decode
    lane's chain token + drafts. Also returns (is_pf, count)."""
    H = hist.shape[1]
    is_pf = cursor < plen
    count = torch.where(is_pf, (plen - cursor).clamp(0, C),
                        torch.zeros_like(cursor))
    col = torch.arange(C, device=hist.device)[None, :]
    pchunk = torch.gather(hist, 1, (cursor.long()[:, None] + col)
                          .clamp(0, H - 1))
    dec = torch.cat([_last_token(hist, hlen)[:, None], drafts], dim=1)
    return torch.where(is_pf[:, None], pchunk, dec), is_pf, count


def _mixed_spec_scan(cfg: ModelConfig, rounds: int, gamma: int, ngram: int,
                     draft_src, params, hist, hist_len, cursor, plen,
                     cache: PagedKVCache, active, temps, stops, budgets,
                     top_k: int, top_p: float, gens, spec_mask,
                     use_kernel: bool = False):
    """Speculative mixed block, window off: _spec_scan with prefill
    lanes. Decode-phase slots run the draft -> verify -> accept round
    token for token as _spec_scan; prefill-phase slots (cursor < plen)
    spend the round's [S, C = gamma+1] forward on a C-token chunk of
    their history row (the full prompt at admission, hist_len == prompt
    length). Each lane's cache length advances by its real count, which
    rolls the verify's +C back. `gens` = (accept, draft, prefill-lane)
    generators. Stateless draft sources only (mixed_dispatch_ready).

    Returns (toks [rounds, S, C], valid, hist, hist_len, rem, cursor,
    cache)."""
    g_acc, g_draft, g_pf = gens
    C = gamma + 1
    has_stop, live = _spec_live0(hist, hist_len, active, stops, budgets,
                                 is_pf0=cursor < plen)
    hlen, rem = hist_len, budgets
    toks_out, valid_out = [], []
    for _ in range(rounds):
        is_pf = cursor < plen
        drafts, qlog, _ = draft_src.draft(
            hist, hlen, gamma, ngram, live & ~is_pf, None, g_draft, temps,
            top_k, top_p)
        toks, is_pf, count = _mixed_spec_io(hist, hlen, cursor, plen, drafts,
                                            C)
        W = cache.lengths
        logits, cache = paged_forward(params, cfg, toks, cache, active=live,
                                      use_kernel=use_kernel)
        emitted, valid, adv = _mixed_spec_round(
            logits, drafts, qlog, is_pf, count, cursor, plen, live, rem,
            stops, has_stop, temps, top_k, top_p, g_acc, g_pf, spec_mask, C)
        cache = cache._replace(
            lengths=torch.where(live, W + adv, W).to(torch.int32))
        cursor = torch.where(live & is_pf, cursor + count, cursor)
        hlen, rem, live, _ = _spec_commit(hist, hlen, rem, live, emitted,
                                          valid, stops, has_stop)
        toks_out.append(emitted)
        valid_out.append(valid)
    return (torch.stack(toks_out), torch.stack(valid_out), hist, hlen, rem,
            cursor, cache)


def _mixed_spec_scan_win(cfg: ModelConfig, rounds: int, gamma: int,
                         ngram: int, draft_src, params, hist, hist_len,
                         cursor, plen, cache: PagedKVCache, window: KVWindow,
                         win_len, active, temps, stops, budgets, top_k: int,
                         top_p: float, gens, spec_mask,
                         use_kernel: bool = False):
    """Write-combined twin of _mixed_spec_scan with identical lane
    semantics: each round's forward stages into the window and win_len
    advances by each lane's real count, so filler, rejected drafts and
    dead-round repeats sit past win_len, never attended or flushed.

    Returns (toks, valid, hist, hist_len, rem, cursor, cache, window,
    win_len)."""
    g_acc, g_draft, g_pf = gens
    C = gamma + 1
    has_stop, live = _spec_live0(hist, hist_len, active, stops, budgets,
                                 is_pf0=cursor < plen)
    hlen, rem, wlen = hist_len, budgets, win_len
    toks_out, valid_out = [], []
    for _ in range(rounds):
        is_pf = cursor < plen
        drafts, qlog, _ = draft_src.draft(
            hist, hlen, gamma, ngram, live & ~is_pf, None, g_draft, temps,
            top_k, top_p)
        toks, is_pf, count = _mixed_spec_io(hist, hlen, cursor, plen, drafts,
                                            C)
        logits, window = paged_forward_window(params, cfg, toks, cache,
                                              window, wlen, active=live,
                                              use_kernel=use_kernel)
        emitted, valid, adv = _mixed_spec_round(
            logits, drafts, qlog, is_pf, count, cursor, plen, live, rem,
            stops, has_stop, temps, top_k, top_p, g_acc, g_pf, spec_mask, C)
        wlen = torch.where(live, wlen + adv, wlen).to(torch.int32)
        cursor = torch.where(live & is_pf, cursor + count, cursor)
        hlen, rem, live, _ = _spec_commit(hist, hlen, rem, live, emitted,
                                          valid, stops, has_stop)
        toks_out.append(emitted)
        valid_out.append(valid)
    return (torch.stack(toks_out), torch.stack(valid_out), hist, hlen, rem,
            cursor, cache, window, wlen)
