"""Continuous-batching scheduler: admission, decode interleave, preemption.

The port of butterfly_tpu/sched/scheduler.py: host logic carried over
whole, with the device carries as torch tensors on the engine's device.

Host-side policy over the static-shape device programs in
engine/serving.py:

* tick() = [lazy drain — the OLDEST in-flight decode block only, and
  only when the in-flight queue is full] then [≤ prefill_chunk tokens
  of GROUP prefill work — waiting requests are gang-admitted, up to
  prefill_max_batch of them, and their next chunks run as batched
  [B, Tbucket] dispatches (engine.prefill_batch), bucketed by chunk
  length] then [ONE fused decode block of decode_steps_per_tick
  iterations for all active slots — a single jitted scan,
  engine._decode_scan — CHAINED on the previous block's
  device-resident carry]. Up to RuntimeConfig.inflight_blocks decode
  blocks stay in flight (dispatch-ahead): block t+1 is dispatched
  before block t is drained, so the tick's host section — admission,
  operand assembly, the stacked fetch itself — overlaps the device
  computing earlier blocks instead of idling it. A membership change
  (admission work, a finish surfacing at drain, preemption, cancel)
  forces a FULL drain barrier so host and device bookkeeping reconcile
  before the next dispatch. Speculative mode dispatches fused SPEC
  blocks through the same pipeline: drafts come from a device-resident
  token history, acceptance (with the rejection-sampling correction at
  temperature > 0) is computed inside the scan, and blocks chain on
  the (history, budgets) carry — no per-round barrier. Long prompts are
  split into prefill_chunk-sized pieces that continue the warm cache
  across ticks (partially-prefilled gang members carry over), so a
  max-length admission can never head-of-line-block decoding requests
  for more than one chunk, and a burst of arrivals prefills as a
  group instead of one prompt per tick.
* scheduler="static" disables interleaving: a whole batch is admitted
  (full prompts at once) only when the previous batch has fully drained —
  the classic throughput-oriented static-batching mode.
* Admission allocates pages for prompt+1; each decode step grows a slot's
  pages just-in-time. If the pool is exhausted, the youngest running
  request is PREEMPTED (pages freed, request requeued; its prompt +
  generated-so-far become the new prompt and are recomputed on
  readmission — vLLM-style recompute preemption).
* Per-request sampling: temperature is a per-slot device array;
  stop-token/max-tokens checks are host-side (the host sees every token
  anyway when streaming).
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from butterfly_tpu_torch.cache.allocator import make_page_allocator
from butterfly_tpu_torch.engine.serving import (
    ServingEngine, bucket_len, sample_batched)
from butterfly_tpu_torch.obs.registry import (
    BATCH_BUCKETS, LATENCY_BUCKETS, TOKEN_BUCKETS, MetricsRegistry)
from butterfly_tpu_torch.obs.ticklog import TICK_PHASES, TickLog

#: spec_accept_rate histogram buckets: acceptance fractions in [0, 1]
#: (upper bounds; the 1.0 bucket is the all-drafts-accepted round)
SPEC_ACCEPT_BUCKETS = (0.01, 0.125, 0.25, 0.375, 0.5,
                       0.625, 0.75, 0.875, 1.0)


def _device_ready(ev) -> bool:
    """Non-blocking completion probe for a dispatched block: `ev` is the
    torch.cuda.Event the engine recorded after the block (true once the
    device has run past it), or None on the CPU, where device work has
    completed by the time the dispatch returns."""
    if ev is None:
        return True
    return bool(ev.query())


def _host_to(t: torch.Tensor, val) -> torch.Tensor:
    """`val` (host array or scalar) as a tensor on t's device and dtype;
    a host array crosses through pinned memory without blocking."""
    if isinstance(val, torch.Tensor):
        return val.to(t.device, t.dtype)
    v = torch.as_tensor(np.asarray(val)).to(t.dtype)
    if t.device.type == "cuda":
        return v.pin_memory().to(t.device, non_blocking=True)
    return v


def _at_set(t: torch.Tensor, idx, val) -> torch.Tensor:
    """The JAX `t.at[idx].set(val)`: a NEW tensor with idx replaced, so
    an in-flight block's reference to the old carry is never mutated."""
    out = t.clone()
    out[idx] = _host_to(t, val)
    return out


@dataclass
class Request:
    id: int
    prompt: List[int]
    max_new_tokens: int = 128
    temperature: float = 0.0
    stop_token: int = -1
    # client-supplied passthrough id (X-Request-Id / body "request_id"):
    # appears verbatim in traces so client logs join server timelines
    client_id: Optional[str] = None
    # priority class: "interactive" sheds last and is preempted last;
    # "batch" is the first shed under predicted-TTFT pressure and the
    # preferred preemption victim under page pressure
    priority: str = "interactive"
    # absolute time.monotonic() deadline (None = none declared). The
    # scheduler scrubs expired waiters every tick and cancels expired
    # runners at the next drain barrier — an expired request never
    # occupies a decode slot past its budget.
    deadline_s: Optional[float] = None
    # per-request speculation opt-out (only meaningful when the server
    # runs with speculative_gamma > 0): False rides the spec block but
    # ignores its drafts — the slot emits one exact plain-decode sample
    # per verify round (speculative_accept spec_mask semantics)
    speculative: bool = True
    # where the deadline fired ("waiting" | "running"), for the 504 body
    expired_where: Optional[str] = None
    # runtime state
    output: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    state: str = "waiting"  # waiting | prefilling | running | finished | cancelled
    prefilled: int = 0      # prompt tokens already in the KV cache
    preemptions: int = 0
    t_arrive: float = field(default_factory=time.monotonic)
    # last time the request entered the waiting queue (submit or
    # preemption): the queue_wait_seconds histogram measures from here
    t_enqueued: float = field(default_factory=time.monotonic)
    # prefix-cache hit length at the LAST admission: prefill_tokens
    # histogram observes len(prompt) - this (only tokens actually run)
    cached_at_admit: int = 0
    t_first_token: Optional[float] = None
    t_last_token: Optional[float] = None
    t_finish: Optional[float] = None
    on_token: Optional[Callable[["Request", int], None]] = None
    on_finish: Optional[Callable[["Request"], None]] = None

    @property
    def done(self) -> bool:
        return self.state in ("finished", "cancelled", "expired")

    @property
    def all_tokens(self) -> List[int]:
        """Prompt + generated-so-far: what a (re)prefill must cover."""
        return self.prompt + self.output

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_arrive


class Scheduler:
    """Continuous batching over a ServingEngine."""

    def __init__(self, engine: ServingEngine, seed: int = 0,
                 tracer=None, registry: Optional[MetricsRegistry] = None,
                 slo_ttft_s: Optional[float] = None,
                 slo_itl_s: Optional[float] = None,
                 flightrec=None, timeseries=None):
        self.engine = engine
        # Anomaly flight recorder (obs/ticklog.py FlightRecorder),
        # opt-in like the tracer: None keeps every call site a single
        # attribute-is-None check. When on, the scheduler notes
        # admission/preempt/shed/expiry/barrier/flush events into its
        # bounded ring and polls the trigger predicates once per tick.
        self.flightrec = flightrec
        # Periodic signal-history recorder (obs/timeseries.py
        # SignalRecorder), opt-in with the same None contract: when
        # off, the per-tick cost is one attribute-is-None check; when
        # on, _record_tick asks due() (one monotonic compare) and
        # samples the gauge/rate signal set at the recorder's interval.
        # It lives on the scheduler — not the server — so bench runs
        # record trajectories without an HTTP surface.
        self.timeseries = timeseries
        # Tracing is opt-in: trace=None keeps every hot-path call site a
        # single None check (obs/trace.py overhead contract). When on,
        # the engine shares the tracer for dispatch-level events.
        self.trace = tracer
        if tracer is not None and hasattr(engine, "tracer"):
            engine.tracer = tracer
        rt = engine.runtime
        if rt.scheduler not in ("continuous", "static"):
            raise ValueError(f"unknown scheduler {rt.scheduler!r}: "
                             "expected 'continuous' or 'static'")
        max_pages = engine.cache.page_table.shape[1]
        if rt.prefix_caching:
            from butterfly_tpu_torch.cache.prefix import PrefixCachingAllocator
            self.alloc = PrefixCachingAllocator(
                engine.cache.num_pages - 1, engine.cache.page_size, max_pages)
        else:
            self.alloc = make_page_allocator(engine.cache.num_pages - 1,
                                             engine.cache.page_size, max_pages,
                                             num_slots=engine.num_slots)
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []
        # Mixed dispatch: prefill chunks and decode/spec
        # tokens ride ONE fused block per tick (engine._mixed_scan and
        # twins) — admission becomes a host-side carry edit between
        # dispatches (_seed_mixed_slot) instead of a drain barrier +
        # separate prefill dispatch, retiring the admission barrier
        # cause as a class. Continuous scheduler only; stateful draft
        # sources fall back to the alternating path (their admission
        # reseed hook needs the barrier this mode deletes).
        self._mixed_mode = (rt.scheduler == "continuous"
                            and engine.mixed_dispatch_ready)
        # visibility: mixed dispatch was ASKED
        # for but the engine gated it back to the alternating path
        # (stateful draft source, or tree speculation — neither has a
        # fused mixed program). That fallback used to be silent; the
        # reason string rides metrics() and the counter below makes
        # the gating countable in any scrape.
        self._mixed_fallback_reason = engine.mixed_fallback_reason \
            if rt.scheduler == "continuous" else None
        # per-step chunk width C: under spec the verify shape pins it
        # to gamma+1; otherwise the inline budget (clamped by the tick
        # chunk budget) IS the width — one prefilling slot chews C
        # tokens per scan step
        self._mixed_chunk = (rt.speculative_gamma + 1) if rt.speculative_gamma > 0 \
            else max(1, min(rt.prefill_inline_budget, rt.prefill_chunk))
        # concurrent-prefill cap — THE ITL-tail knob: at most this many
        # slots may be in prefill phase at once, so a scan step never
        # chews more than ~prefill_inline_budget prompt tokens while
        # decode slots wait on it
        self._mixed_max_pf = max(1, rt.prefill_inline_budget // self._mixed_chunk)
        # mixed-dispatch device carries: the per-slot chunk cursor
        # (DONATED to every mixed block, rebound from its result —
        # BTF002 contract) and, non-spec, the prompt-buffer rows the
        # prefill lanes read (under spec the token-history carry
        # doubles as the buffer). _plen_host is the per-slot prompt
        # length operand (host-owned; 0 marks a slot decode-phase).
        self._cursor_dev = None
        self._pbuf_dev = None
        self._plen_host = np.zeros((engine.num_slots,), np.int32)
        # prompt tokens advanced INSIDE fused mixed blocks (the work
        # the retired admission barrier used to serialize) — the bench
        # key mixed_dispatch_prefill_tokens_inline
        self._inline_pf_tokens = 0
        # The prefill GROUP: requests admitted to slots whose prompts are
        # not yet fully in the KV cache. Each tick their next chunks are
        # packed under the prefill_chunk token budget and dispatched as
        # batched [B, Tbucket] prefills (engine.prefill_batch);
        # partially-prefilled members carry over to the next tick. This
        # replaces the old single `_prefilling` request — a burst of
        # arrivals no longer serializes one [1, Tbucket] dispatch per
        # prompt while decode slots sit idle.
        self._prefill_group: List[Request] = []
        # Long-prompt seq-parallel lane: prompts longer than
        # RuntimeConfig.seq_parallel_threshold prefill through chunked
        # seq-parallel dispatches (engine.sp_prefill_chunk — ring
        # attention over the mesh's seq axis, K/V landing in the
        # ordinary page pool) and then decode as normal paged slots. At
        # most ONE request occupies the lane: each chunk dispatch
        # already spans every seq-axis device, so a second concurrent
        # long prefill would only queue behind the first's dispatches.
        self._sp_group: List[Request] = []
        self._sp_enabled = (rt.seq_parallel_threshold > 0
                            and engine.supports_seq_parallel)
        if rt.seq_parallel_threshold > 0 and not self._sp_enabled:
            import warnings
            warnings.warn(
                "seq_parallel_threshold set but the engine cannot "
                "seq-parallel (needs a mesh with seq > 1 and stage == "
                "1); long prompts take the single-device chunk path",
                RuntimeWarning, stacklevel=2)
        # tokens per seq-parallel dispatch: each shard chews about a
        # prefill_chunk worth of work, so one lane dispatch costs a
        # tick roughly what a dense prefill round does
        N = engine.sp_degree
        spc = rt.seq_parallel_chunk or N * max(1, rt.prefill_chunk)
        self._sp_chunk = -(-spc // max(1, N)) * max(1, N)
        self.slots: List[Optional[Request]] = [None] * engine.num_slots
        self._ids = itertools.count()
        # one host generator hands every dispatched block (and every
        # admission-time first-token draw) its own seed — the port's
        # counterpart of splitting a jax.random key per block
        self._rng = torch.Generator(device="cpu")
        self._rng.manual_seed(seed)
        self._next_tokens = np.zeros((engine.num_slots,), np.int32)
        # In-flight fused blocks, tagged tuples in dispatch order:
        #   ("decode", completion event, block [k, S], k, snapshot, t)
        #   ("spec",   completion event, (toks [R, S, C], valid
        #              [R, S, C]), R rounds, snapshot, t)
        #   ("mixed",  final [S], (block [k, S], valid [k, S]), k,
        #              snapshot, t, pf_done slots, emit_vec [S])
        #   ("mixed_spec", completion event, (toks, valid) [R, S, C], R,
        #              snapshot, t, pf_done slots, None)
        # where snapshot maps slot -> (request, generation); mixed
        # entries additionally carry the slots whose prefill completed
        # inside the block (drain-time state transitions) and, plain
        # mixed, the host-simulated per-slot emission counts the next
        # dispatch's budget look-ahead subtracts. Each tick
        # dispatches ONE jitted scan (engine.decode_block_async or
        # engine.spec_block_async) chained on the previous block's
        # device-resident carry, and up to
        # RuntimeConfig.inflight_blocks of them stay undrained
        # (dispatch-ahead): the host fetches only the OLDEST block when
        # the queue fills, so its drain + the next tick's scheduling
        # run while the device computes the newer blocks. This is what
        # closes the serving loop toward the isolated-decode ceiling
        # and what makes it survive high host<->device latency.
        self._inflight: List[tuple] = []
        # Batch-membership epoch: bumped whenever the running set, the
        # pending-first set, or any runner's drained output changes
        # (admission completing, finish, preemption, any drain).
        # _decode_block caches its host operand assembly — the
        # active/temps/stops/base-budget arrays and the slot snapshot —
        # keyed on it, so back-to-back blocks over an unchanged batch
        # skip the per-slot Python rebuild and the np.asarray churn.
        self._epoch = 0
        self._operands_epoch = -1
        self._operands: Optional[tuple] = None
        # device_bubble_seconds observation points, set at tick start:
        # host-section start time and whether the device was ALREADY
        # idle then (the newest in-flight block's carry ready before
        # any host work ran — exactly the gap dispatch-ahead exists to
        # close). _decode_block observes the gap at dispatch.
        self._t_host0 = 0.0
        self._idle_at_host0 = False
        self._had_inflight_at_host0 = False
        # First tokens sampled on-device at admission, not yet fetched:
        # [(req, generation=req.preemptions, slot, device scalar)].
        # Fetched with the same stacked drain (a per-admission host
        # fetch would pay the full dispatch+fetch RTT per request).
        self._pending_first: List[tuple] = []
        # Membership index over _pending_first, keyed (request id,
        # preemptions) and refreshed at drain time: _decode_block's
        # budget computation and _written ask "does req have an
        # undrained first token?" per runner — a set lookup instead of
        # the old O(running x pending) linear scan.
        self._pending_first_keys: set = set()
        # Device twin of _next_tokens: the decode chain's input vector.
        # Admissions write their first token into it with a device-side
        # .at[].set, so dispatching never needs the host values.
        self._next_dev = None
        # Speculative-mode device carries (allocated only with
        # speculative_gamma > 0): the per-slot token history
        # [S, cache.max_seq] + live lengths the on-device drafter reads
        # (admissions write their prompt + first token in; spec blocks
        # append their own emissions in-scan), and the remaining-budget
        # vector the chained dispatches thread through
        # (None = rebuild from host state at the next dispatch — set at
        # every full drain barrier, when the host again knows every
        # emitted token).
        self._spec_mode = rt.speculative_gamma > 0
        self._hist_dev = None
        self._hist_len_dev = None
        self._spec_rem = None
        if self._spec_mode:
            H = engine.cache.max_seq
            self._hist_dev = torch.zeros((engine.num_slots, H),
                                         dtype=torch.int32,
                                         device=engine.device)
            self._hist_len_dev = torch.zeros((engine.num_slots,),
                                             dtype=torch.int32,
                                             device=engine.device)
        # Typed instruments (obs/registry.py) replace the old ad-hoc
        # Dict[str, float]: counters for the monotonic totals, fixed-
        # bucket histograms for the latency/size distributions /metrics
        # exposes as real _bucket/_sum/_count series. metrics() still
        # returns the legacy flat dict, assembled from the registry.
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        reg = self.registry
        self._c_requests = reg.counter(
            "requests_total", "Requests submitted")
        self._c_finished = reg.counter(
            "requests_finished", "Requests completed")
        self._c_tokens = reg.counter(
            "tokens_generated_total",
            "Tokens generated across all requests")
        self._c_preempt = reg.counter(
            "preemptions_total",
            "Recompute preemptions under page pressure")
        self._c_spec_fwd = reg.counter(
            "spec_forwards_total",
            "Speculative verify forwards that did work (spec-block "
            "rounds with at least one live slot)")
        self._c_spec_acc = reg.counter(
            "spec_drafts_accepted_total",
            "Draft tokens accepted by speculative verify")
        self._c_spec_tok = reg.counter(
            "spec_block_tokens_total",
            "Tokens emitted from speculative verify blocks (accepted "
            "drafts + corrections/bonus samples); divided by "
            "spec_forwards_total this is tokens/forward — the number "
            "speculation exists to push past 1")
        self._c_spec_mixed_fb = reg.counter(
            "spec_mixed_fallback_total",
            "Mixed dispatch requested but gated back to the "
            "alternating path at engine construction (stateful draft "
            "source needs the admission barrier; tree speculation has "
            "no fused mixed program) — nonzero means the "
            "mixed_dispatch flag is silently not in effect")
        if self._mixed_fallback_reason is not None:
            self._c_spec_mixed_fb.inc()
        self._h_accept = reg.histogram(
            "spec_accept_rate",
            "Per-slot-round draft acceptance fraction (accepted / "
            "gamma) over emitted rounds of speculating requests — 0 "
            "means every round paid a full verify for one token",
            SPEC_ACCEPT_BUCKETS)
        # Barrier-cause accounting: the single counter grew
        # a {cause} label so the bench can say WHICH membership-change
        # class costs the pipeline. The unlabeled sum survives as the
        # metrics()["drain_barriers_total"] compat key (and as the sum
        # of the labeled children in the exposition).
        self._c_barriers = reg.counter_family(
            "drain_barriers_total",
            "FULL drain barriers (every in-flight block fetched, "
            "pipeline restarts cold), by membership-change cause "
            "(admission, finish, page_pressure, cancel, spec, idle, "
            "expired, flush). Compare the sum with spec_forwards_total "
            "/ tick count: a healthy pipeline drains lazily and "
            "barriers only on membership changes, never once per "
            "decode or spec round", ("cause",))
        self._h_ttft = reg.histogram(
            "ttft_seconds",
            "Time to first token (submit -> first token drained)",
            LATENCY_BUCKETS)
        self._h_itl_mean = reg.histogram(
            "itl_req_mean_seconds",
            "Per-finished-request MEAN inter-token gap — the effective "
            "streaming rate a client experiences", LATENCY_BUCKETS)
        self._h_queue_wait = reg.histogram(
            "queue_wait_seconds",
            "Wait from submit (or preemption) to slot admission",
            LATENCY_BUCKETS)
        self._h_batch = reg.histogram(
            "batch_size", "Decoding slots active per scheduler tick",
            BATCH_BUCKETS)
        self._h_prefill_tokens = reg.histogram(
            "prefill_tokens",
            "Prompt tokens prefilled per admission (prefix-cache hits "
            "excluded)", TOKEN_BUCKETS)
        self._c_sp_tokens = reg.counter(
            "seq_parallel_prefill_tokens_total",
            "Prompt tokens prefilled through the long-prompt "
            "seq-parallel lane (chunked ring-attention dispatches; "
            "zero when seq_parallel_threshold is off or no prompt "
            "exceeded it)")
        self._h_prefill_batch = reg.histogram(
            "prefill_batch_size",
            "Requests packed into one batched [B, Tbucket] prefill "
            "dispatch (group admission; 1 = a lone member in its "
            "chunk-length bucket)", BATCH_BUCKETS)
        self._h_decode_block = reg.histogram(
            "decode_block_seconds",
            "Fused decode block in-flight residency: dispatch to "
            "stacked drain (covers decode_steps_per_tick device steps "
            "plus, under dispatch-ahead, the ticks the block waited "
            "undrained while newer blocks ran)", LATENCY_BUCKETS)
        self._h_bubble = reg.histogram(
            "device_bubble_seconds",
            "Device idle gap per dispatched decode block: 0 when the "
            "newest in-flight block was still running as the tick's "
            "host section began; otherwise the (lower-bound) time the "
            "idle device waited for the next dispatch",
            LATENCY_BUCKETS)
        self._g_inflight = reg.gauge(
            "inflight_depth",
            "Decode blocks in flight (dispatched, not yet drained) at "
            "the end of the last scheduler tick")
        # Write-combined KV window (RuntimeConfig.kv_write_combine):
        # every drain flushes the staged window into the page pool with
        # one scatter per pool tensor, BEFORE any finish registers or
        # reclaims pages. The histogram times the host-side flush
        # dispatch section (on an async backend the device cost shows
        # up in decode_block_seconds instead); the counter rides the
        # drain's stacked fetch, so it costs no extra sync.
        self._h_kv_flush = reg.histogram(
            "kv_flush_seconds",
            "Host wall time of the write-combined KV window flush "
            "dispatch at a drain (kv_write_combine; one pool scatter "
            "per drain instead of one per token per layer)",
            LATENCY_BUCKETS)
        self._c_kv_flushed = reg.counter(
            "kv_window_tokens_flushed_total",
            "Staged K/V tokens flushed from the write-combined decode "
            "window into the page pool (kv_write_combine); tokens "
            "whose requests died before a flush are dropped, not "
            "counted")
        self._kv_flushes: Deque[float] = deque(maxlen=4096)
        # Host-RAM KV tier (cache/hosttier.py): prefix-cache
        # eviction demotes page bytes to host DRAM (optionally spilling
        # to disk) instead of dropping them, and admission's prefix
        # walk revives them on a hit — the evict/revive hooks installed
        # on the allocator here are the only device-touching halves
        # (read_pages on evict, write_pages on revive); the tier itself
        # is pure host state. Off (None) unless prefix caching is on
        # AND a tier budget is declared.
        self.host_tier = None
        self._g_tier_hit = None
        self._tier_restores: Deque[float] = deque(maxlen=4096)
        if rt.prefix_caching and (rt.host_kv_tier_mb or 0) > 0:
            from butterfly_tpu_torch.cache.hosttier import HostKVTier
            self.host_tier = HostKVTier(
                int(rt.host_kv_tier_mb * 1024 * 1024),
                spill_dir=rt.host_kv_tier_dir)
            self.alloc.on_evict = self._tier_save
            self.alloc.reviver = self._tier_revive
            self._c_tier_saved = reg.counter(
                "kv_tier_pages_saved_total",
                "KV pages demoted to the host tier at prefix-cache "
                "eviction (read_pages -> host DRAM) instead of dropped")
            self._c_tier_restored = reg.counter(
                "kv_tier_pages_restored_total",
                "KV pages revived from the host tier on a prefix hit "
                "(import_page + write_pages) — prefill work the tier "
                "saved")
            self._c_tier_miss = reg.counter(
                "kv_tier_misses_total",
                "Prefix-walk registry misses the host tier could not "
                "serve either (the chain was never demoted, or aged "
                "out of the tier's budget)")
            self._h_tier_restore = reg.histogram(
                "kv_tier_restore_seconds",
                "Host wall time to revive one page from the host tier "
                "(tier lookup + import_page + the device scatter)",
                LATENCY_BUCKETS)
            self._g_tier_hit = reg.gauge(
                "kv_tier_hit_rate",
                "Fraction of host-tier lookups served (restores / "
                "(restores + misses), all paths including export) — "
                "the tier-effectiveness signal dashboards sparkline")
        # SLO attainment: declared objectives make latency a
        # pass/fail measurement per request instead of a percentile to
        # eyeball. None = no objective declared: zero accounting runs
        # (the counters exist but never increment).
        self.slo_ttft_s = slo_ttft_s
        self.slo_itl_s = slo_itl_s
        self._c_slo_ttft_ok = reg.counter(
            "slo_ttft_ok_total",
            "First tokens delivered within the declared TTFT objective "
            "(--slo-ttft-ms)")
        self._c_slo_itl_ok = reg.counter(
            "slo_itl_ok_total",
            "Finished requests whose mean inter-token gap met the "
            "declared ITL objective (--slo-itl-ms)")
        self._c_slo_viol = reg.counter_family(
            "slo_violations_total",
            "Requests that missed a declared latency objective, by "
            "objective kind", ("kind",))
        self._g_slo_burn = reg.gauge(
            "slo_burn_rate",
            "Fraction of the last 256 finished requests that violated "
            "ANY declared objective (0 = meeting SLO, 1 = burning the "
            "whole error budget) — the rolling signal SLO-aware "
            "admission and autoscaling read")
        # Overload protection: deadline expiry + SLO-aware
        # admission shedding. Shedding activates only with a declared
        # TTFT objective AND observed latency evidence — a cold server
        # never sheds blind.
        self._c_deadline = reg.counter_family(
            "deadline_expired_total",
            "Requests that blew their declared deadline (deadline_ms / "
            "X-Deadline-Ms), by where they died: scrubbed from the "
            "waiting queue, or cancelled out of a decode slot",
            ("where",))
        self._c_shed = reg.counter_family(
            "shed_total",
            "Requests shed at admission (429) because predicted TTFT "
            "busts the declared --slo-ttft-ms, by priority class "
            "(batch sheds at the objective, interactive at "
            "interactive_slack x it)", ("priority",))
        # interactive requests tolerate this multiple of the TTFT
        # objective before shedding — batch is always shed first
        self.interactive_slack = 2.0
        # rolling attainment window backing the burn-rate gauge
        self._slo_window: Deque[float] = deque(maxlen=256)
        # latency reservoirs: both bounded to the same recent window so
        # the two adjacent metrics share time-horizon semantics (and a
        # long-lived server doesn't leak one float per request forever)
        self._ttfts: Deque[float] = deque(maxlen=4096)
        # inter-token gaps (seconds), bounded reservoir of the most
        # recent gaps across all requests — the latency a decoding
        # request experiences when admissions interleave (the quantity
        # chunked prefill exists to bound). With pipelined dispatch,
        # tokens surface in per-tick bursts, so raw gap percentiles
        # bimodalize (p50 ~ 0, p95 ~ tick); _itl_means tracks each
        # finished request's MEAN gap (t_last - t_first)/(n - 1) — the
        # effective per-token rate a streaming client experiences.
        self._itls: Deque[float] = deque(maxlen=4096)
        self._itl_means: Deque[float] = deque(maxlen=4096)
        # per-dispatch device-bubble samples (seconds; 0 = the pipeline
        # kept the device busy through the host section) for the
        # metrics() percentile keys bench.py reports
        self._bubbles: Deque[float] = deque(maxlen=4096)
        # -- tick anatomy -----------------------------------------
        # Per-tick phase attribution: tick() zeroes the accumulator,
        # the structural sections add their exclusive time.monotonic()
        # deltas (host->host arithmetic only — the timers themselves
        # must never sync, BTF003 covers these paths), and the record
        # lands in the bounded timeline ring GET /debug/ticks serves.
        self.ticklog = TickLog(capacity=512)
        self._tick_phases: Dict[str, float] = {p: 0.0 for p in TICK_PHASES}
        self._tick_causes: List[str] = []
        # stacked-fetch device wait within this tick's drains: feeds
        # the host/device split (tick_host_frac / tick_device_frac) —
        # the fetch is the one tick section that blocks on the device
        self._tick_fetch = 0.0
        self._t_host_total = 0.0
        self._t_device_total = 0.0
        # per-phase histograms in the registry: real _bucket series per
        # structural phase, so dashboards see distributions, not means
        self._h_phase = {
            p: reg.histogram(
                f"tick_phase_{p}_seconds",
                f"Host wall time of the '{p}' tick phase per tick "
                "(docs/serving.md tick-pipeline vocabulary)",
                LATENCY_BUCKETS)
            for p in TICK_PHASES}

    def _block_seed(self) -> int:
        """The next seed from the scheduler's generator: one per
        dispatched block (the engine seeds that block's device generator
        with it) and one per admission-time first-token draw."""
        return int(torch.randint(0, 2 ** 62, (1,), generator=self._rng))

    def _phase_add(self, name: str, dt: float) -> None:
        """Accumulate one phase section's exclusive wall time into the
        current tick's record (plain dict arithmetic — never a sync)."""
        self._tick_phases[name] += dt

    # -- public API ---------------------------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int = 128,
               temperature: float = 0.0, stop_token: int = -1,
               on_token=None, on_finish=None,
               request_id: Optional[str] = None,
               priority: str = "interactive",
               deadline_s: Optional[float] = None,
               speculative: bool = True) -> Request:
        # Reject what can never fit: a request that exceeds the per-seq
        # page limit or the whole pool would self-preempt forever.
        worst = -(-(len(prompt) + max_new_tokens) // self.alloc.page_size)
        if worst > self.alloc.max_pages_per_seq or worst > self.alloc.num_pages:
            raise ValueError(
                f"request needs {worst} KV pages (prompt {len(prompt)} + "
                f"max_new {max_new_tokens}) but the limit is "
                f"{min(self.alloc.max_pages_per_seq, self.alloc.num_pages)}")
        if priority not in ("interactive", "batch"):
            raise ValueError(f"unknown priority {priority!r}: expected "
                             "'interactive' or 'batch'")
        req = Request(id=next(self._ids), prompt=list(prompt),
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      stop_token=stop_token, client_id=request_id,
                      priority=priority, deadline_s=deadline_s,
                      speculative=bool(speculative),
                      on_token=on_token, on_finish=on_finish)
        self.waiting.append(req)
        self._c_requests.inc()
        if self.trace is not None:
            self.trace.begin_request(req.id, request_id=request_id,
                                     prompt_len=len(prompt),
                                     max_new_tokens=max_new_tokens)
        return req

    # -- overload protection --------------------------------------

    def predict_ttft(self, prompt_len: int) -> Optional[float]:
        """Admission-time TTFT prediction for a hypothetical new
        arrival: the prefill backlog ahead of it (waiting prompts +
        unfinished prefill-group work + its own prompt) in
        prefill_chunk-budget rounds, plus one round per waiter ahead
        (slot contention), each round costed at the rolling
        per-request mean ITL — every chunk round shares a tick with a
        decode block, so the recent inter-token gap IS the tick cost a
        queued request pays. Returns None without latency evidence
        (cold server: never predict, never shed blind). Deliberately
        cheap — a misprediction costs one early 429 or one late
        admission, never correctness."""
        window = self._itl_means or self._itls
        if not window:
            return None
        tick_s = sum(window) / len(window)
        chunk = max(1, self.engine.runtime.prefill_chunk)
        backlog = prompt_len
        backlog += sum(len(r.all_tokens) - r.prefilled
                       for r in self._prefill_group)
        # seq-parallel lane work is shared N ways across the mesh
        backlog += sum(len(r.all_tokens) - r.prefilled
                       for r in self._sp_group) \
            // max(1, self.engine.sp_degree)
        backlog += sum(len(r.all_tokens) for r in self.waiting)
        rounds = -(-backlog // chunk) + len(self.waiting)
        return rounds * tick_s

    def shed_decision(self, prompt_len: int,
                      priority: str = "interactive") -> Optional[float]:
        """SLO-aware admission: seconds to advertise as Retry-After
        when the request should be SHED (predicted TTFT busts the
        declared objective), or None to admit. Batch sheds at the
        objective; interactive tolerates interactive_slack x it, so
        under rising load batch traffic is always turned away first.
        No declared --slo-ttft-ms = no shedding, ever."""
        if self.slo_ttft_s is None:
            return None
        pred = self.predict_ttft(prompt_len)
        if pred is None:
            return None
        limit = self.slo_ttft_s * (self.interactive_slack
                                   if priority == "interactive" else 1.0)
        if pred <= limit:
            return None
        self._c_shed.labels(priority).inc()
        if self.flightrec is not None:
            self.flightrec.note("shed", priority=priority,
                                predicted_ttft_s=pred, limit_s=limit)
        # how long until enough backlog drains that the prediction
        # would pass — the honest Retry-After, not a constant
        return max(1.0, pred - limit)

    def _expire_due(self) -> None:
        """Deadline scrub, run at every tick start. Expired waiters
        drop straight out of the queue (they never cost a prefill);
        expired runners force a FULL drain barrier first — their pages
        must not be reclaimed under an in-flight block's writes — then
        leave their decode slot. Either way the request finishes
        state="expired" and its waiter is answered (the server turns
        that into the 504)."""
        now = time.monotonic()
        for req in [r for r in self.waiting
                    if r.deadline_s is not None and now >= r.deadline_s]:
            self.waiting.remove(req)
            self._expire(req, "waiting")
        live = [r for r in self._all_live
                if r.deadline_s is not None and now >= r.deadline_s]
        if live:
            self._drain_inflight("expired")
            for req in live:
                if not req.done:  # the drain may have finished it
                    self._expire(req, "running")

    def _expire(self, req: Request, where: str) -> None:
        req.expired_where = where
        self._c_deadline.labels(where).inc()
        if self.flightrec is not None:
            self.flightrec.note("deadline_504", id=req.id, where=where,
                                tokens=len(req.output))
        self._finish(req, state="expired")

    def cancel(self, req: Request) -> None:
        """Abort a request (e.g. client disconnect): frees slot + pages.

        With decode blocks in flight a FULL drain barrier runs first:
        the blocks were dispatched with this request's slot live, and
        its pages must not be reclaimed (and possibly handed to a later
        admission) while device writes to them are still outstanding."""
        if req.done:
            return
        if req.slot is not None and (self._inflight or self._pending_first):
            self._drain_inflight("cancel")
            if req.done:
                return  # the drain surfaced a natural finish
        if req in self.waiting:
            self.waiting.remove(req)
        self._finish(req, state="cancelled")

    @property
    def _all_live(self) -> List[Request]:
        return (list(self.running) + list(self._prefill_group)
                + list(self._sp_group))

    def unfinished_requests(self) -> List[Request]:
        """Every request that would be lost in a crash: running,
        mid-chunked-prefill, and waiting — the set a serving snapshot
        (ckpt.sharded.save_serving_snapshot) must persist."""
        return self._all_live + list(self.waiting)

    def abort_all(self) -> None:
        """Wedge-path drain: host-only bookkeeping, NO device calls (the
        device may be the thing that's broken). Every waiter's on_finish
        fires; slots/pages are reclaimed in host state only."""
        # never block on a possibly-wedged device
        self._inflight = []
        self._pending_first = []
        self._pending_first_keys.clear()
        self._spec_rem = None
        # staged-but-unflushed window K/V is DROPPED, not flushed (no
        # device calls here): every owning request is being cancelled,
        # and dropping resets the staged count so a later flush can
        # never scatter stale entries into reclaimed pages
        self.engine.drop_kv_window()
        self._plen_host[:] = 0  # mixed carries: every slot decode-phase
        self._epoch += 1  # cached decode operands are now stale
        for req in self.unfinished_requests():
            req.state = "cancelled"
            req.t_finish = time.monotonic()
            if self.trace is not None:
                self.trace.event(req.id, "finish", state="cancelled",
                                 reason="abort_all",
                                 tokens=len(req.output))
            if req.slot is not None:
                self.alloc.release(req.slot)
                self.slots[req.slot] = None
                req.slot = None
            if req.on_finish is not None:
                try:
                    req.on_finish(req)
                except Exception:
                    pass
        self.running.clear()
        self.waiting.clear()
        self._prefill_group.clear()
        self._sp_group.clear()

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self._prefill_group
                    or self._sp_group)

    def run_until_done(self, max_ticks: int = 100000) -> None:
        for _ in range(max_ticks):
            if not self.has_work:
                return
            self.tick()
        raise RuntimeError("scheduler did not drain")

    def tick(self) -> int:
        """One scheduling round: lazy drain, bounded prefill work, then
        a dispatch-ahead decode block.

        Continuous mode keeps up to `RuntimeConfig.inflight_blocks`
        fused decode blocks in flight: block t+1 chains on block t's
        device-resident carry BEFORE t is drained, so this tick's host
        section — drain bookkeeping, admission, operand assembly —
        overlaps the device computing earlier blocks instead of idling
        it. Draining is lazy: only the
        oldest block is fetched, and only once the in-flight queue is
        full; a FULL barrier (everything drained) runs only when host
        and device state must reconcile:

        * admission can make progress (a mid-prefill group, or a waiter
          with a free slot) — prefill bookkeeping and budget assembly
          need every in-flight token on the host;
        * a finish surfaced at a lazy drain — the freed slot/pages and
          the shrunken batch must be visible before the next dispatch;
        * page pressure (_ensure_or_preempt) — preemption must never
          reclaim pages a dispatched block still writes;
        * cancel() — same hazard, external trigger.

        Speculative mode (speculative_gamma > 0) runs the SAME pipeline
        with _spec_block in place of _decode_block: drafts come from
        the device-resident token history, acceptance is computed
        inside the scan, and the chained carry is (history, lengths,
        remaining budgets) instead of the final-token vector — no
        barrier per round (the pre-block-machinery implementation
        drained every round to draft on the host).

        Returns the number of tokens generated this round (throughput
        accounting for the serve loop)."""
        before = self._c_tokens.value
        rt = self.engine.runtime
        spec = self._spec_mode
        k = max(1, rt.decode_steps_per_tick)
        depth = max(1, rt.inflight_blocks)
        # tick-anatomy reset: zero the phase accumulator (sections add
        # their exclusive monotonic deltas below; drains self-accrue),
        # clear the barrier-cause list, zero the fetch wait
        t_tick0 = time.monotonic()
        tp = self._tick_phases
        for p in TICK_PHASES:
            tp[p] = 0.0
        self._tick_causes = []
        self._tick_fetch = 0.0
        # deadline scrub first: an expired request must not survive
        # into this tick's admission or decode dispatch (a drain it
        # forces accrues to drain_barrier, not to expire)
        d0 = self._drain_accrued()
        self._expire_due()
        self._phase_add("expire", max(0.0, time.monotonic() - t_tick0
                                      - (self._drain_accrued() - d0)))
        self._t_host0 = time.monotonic()
        self._had_inflight_at_host0 = bool(self._inflight)
        self._idle_at_host0 = self._had_inflight_at_host0 and \
            _device_ready(self._inflight[-1][1])
        # lazy drain: consume the oldest block once the queue is full
        # (depth=1 degenerates to the old drain-every-tick loop). A
        # finish surfacing there is a membership change -> full barrier.
        while len(self._inflight) >= depth:
            if self._drain_oldest():
                self._drain_inflight("finish")
        mixed = self._mixed_mode
        # seq-parallel long-prompt lane: at most one chunk
        # per tick — the lane's dispatch donates the pool binding, so
        # _sp_prefill_step drains in-flight blocks itself. The chunk's
        # per-device share counts against this tick's prefill budget
        # below (decode-ITL interference stays bounded by the declared
        # prefill_inline_budget just like ordinary chunked prefill).
        sp_used = 0
        if self._sp_enabled:
            t_sp = time.monotonic()
            self._sp_admit()
            sp_used = self._sp_prefill_step()
            self._phase_add("admit", time.monotonic() - t_sp)
        # admission barrier — retired as a class under mixed dispatch,
        # where admission is a host-side carry edit between dispatches
        # (_admit_inline) and the prompt rides the next fused block.
        # The alternating path still barriers whenever admission can
        # actually make progress, so a standing queue behind full
        # slots doesn't serialize the pipeline.
        if not mixed and (self._prefill_group
                          or (self.waiting
                              and self._free_slot() is not None)):
            self._drain_inflight("admission")
        t_admit = time.monotonic()
        if mixed:
            self._admit_inline()
        else:
            self._admit(sp_used // max(1, self.engine.sp_degree))
        self._phase_add("admit", time.monotonic() - t_admit)
        if self.running:
            self._h_batch.observe(len(self.running))
        # Preallocate pages for every step still in flight PLUS this
        # block up front: device lengths run ahead of the host mirror
        # by up to `step` tokens per undrained block (k samples for a
        # decode block, k rounds x (gamma+1) emissions for a spec
        # block), so the horizon is (inflight+1)*step + 1 (chain token
        # + the new samples) — and the block table dirties (syncs to
        # the device) at most once per TICK
        # (docs/decode_profile_r5.md capacity section). Any more would
        # add spurious page pressure in a tight pool; under pressure
        # _ensure_or_preempt falls back to a drain barrier before it
        # ever preempts. A spec verify's trailing writes past the
        # lifetime clamp land on the null page via the table default.
        step = k * self.engine.spec_emit_width if spec else k
        # tree mode: a round verifies N nodes but commits at
        # most D+1 = spec_emit_width tokens, and the accepted path is
        # COMPACTED from chunk positions as deep as base + N - 1 — the
        # accepted sources must sit on real pages (only the rejected
        # remainder may land on the null page), so both the horizon
        # and the lifetime clamp carry the N - (D+1) overhang
        tree_slack = 0
        if spec and self.engine.spec_tree_mode:
            tree_slack = (self.engine.spec_tree_geometry[1]
                          - self.engine.spec_emit_width)
        horizon = (len(self._inflight) + 1) * step + tree_slack + 1
        for req in list(self.running):
            if req in self.running:
                need = min(len(req.all_tokens) + horizon,
                           len(req.prompt) + req.max_new_tokens
                           + tree_slack)
                self._ensure_or_preempt(req, need)
        if mixed and self._prefill_group:
            # prefill lanes advance up to C tokens per scan step, so
            # their device write horizon is k*C per undrained block
            pf_h = (len(self._inflight) + 1) * k * self._mixed_chunk + 1
            for req in list(self._prefill_group):
                if req in self._prefill_group:
                    need = min(len(req.all_tokens) + pf_h,
                               len(req.prompt) + req.max_new_tokens)
                    self._ensure_or_preempt(req, need)
        t_disp = time.monotonic()
        a0 = tp["assemble"]
        if mixed:
            # the fused block covers both phases: its dispatch section
            # gets its own phase label so tick anatomy stays honest
            # about where admission+prefill time went
            dispatched = self._mixed_block(k)
            self._phase_add("mixed", max(0.0, time.monotonic() - t_disp
                                         - (tp["assemble"] - a0)))
        else:
            dispatched = self._spec_block(k) if spec \
                else self._decode_block(k)
            self._phase_add("dispatch",
                            max(0.0, time.monotonic() - t_disp
                                - (tp["assemble"] - a0)))
        if not dispatched and (self._inflight or self._pending_first):
            # nothing dispatchable (every budget is spent on device):
            # the remaining tokens exist only in flight — fetch them
            # now or the loop would spin forever. In spec mode this is
            # the budget-carry reconciliation (only the device knows
            # the remainders), hence the distinct cause label.
            self._drain_inflight("spec" if spec else "idle")
        self._g_inflight.set(len(self._inflight))
        made = int(self._c_tokens.value - before)
        if self.trace is not None:
            # one global event per tick: the decode batch this round —
            # slot composition plus what the stacked drain surfaced
            self.trace.event(None, "decode_tick",
                             batch=len(self.running),
                             waiting=len(self.waiting),
                             steps=k, block_steps=k, spec=spec,
                             inflight=len(self._inflight),
                             generated=made)
        self._record_tick(time.monotonic() - t_tick0, made, spec)
        return made

    def _drain_accrued(self) -> float:
        """Drain-owned phase time accrued so far this tick (plain dict
        reads): lets an enclosing section subtract the drains it
        triggered, keeping the phase sections non-overlapping."""
        tp = self._tick_phases
        return (tp["drain_barrier"] + tp["drain_oldest"]
                + tp["flush"] + tp["spec_emit"])

    def _record_tick(self, wall: float, made: int, spec: bool) -> None:
        """Close the tick's anatomy record: compute the residual
        ("other" = untimed host work — page prealloc, trace appends),
        feed the per-phase histograms, the host/device split, the
        timeline ring, and the flight-recorder trigger poll. Host
        arithmetic only — no device value is ever touched here."""
        tp = self._tick_phases
        known = sum(tp[p] for p in TICK_PHASES if p != "other")
        tp["other"] = max(0.0, wall - known)
        for name, h in self._h_phase.items():
            h.observe(tp[name])
        fetch = min(self._tick_fetch, wall)
        self._t_device_total += fetch
        self._t_host_total += max(0.0, wall - fetch)
        self.ticklog.record(wall, tp, fetch_s=fetch,
                            inflight=len(self._inflight),
                            barrier_causes=self._tick_causes,
                            batch=len(self.running),
                            waiting=len(self.waiting),
                            pages_free=self.alloc.free_pages,
                            generated=made, spec=spec)
        if self.flightrec is not None:
            self.flightrec.poll({
                "slo_burn_rate": self._g_slo_burn.value,
                "preemptions_total": self._c_preempt.value,
                "deadline_expired_total": sum(
                    c.value for c in self._c_deadline._children.values()),
                "queue_depth": float(len(self.waiting)),
                "kv_pages_free": float(self.alloc.free_pages)})
        ts = self.timeseries
        if ts is not None and ts.due():
            gauges, rates = self._timeseries_signals()
            ts.sample(gauges, rates=rates, t_wall=time.time())

    def _timeseries_signals(self):
        """The SignalRecorder's per-interval snapshot (gauges, rates):
        cheap host reads off the registry + tick anatomy. `rates` maps
        OUTPUT signal name -> CUMULATIVE counter value — the recorder
        turns them into per-second deltas (Counter.rate, clamped at 0
        across resets). Runs only when the recorder is due, never per
        tick."""
        snap = self.registry.snapshot()
        gauges = {
            "queue_depth": float(len(self.waiting)),
            "active_requests": float(len(self._all_live)),
            "inflight_depth": float(len(self._inflight)),
            "kv_pages_free": float(self.alloc.free_pages),
            "slo_burn_rate": self._g_slo_burn.value,
        }
        if self.host_tier is not None:
            gauges["kv_tier_hit_rate"] = self._tier_hit_rate()
        total = self._t_host_total + self._t_device_total
        if total > 0.0:
            gauges["tick_host_frac"] = self._t_host_total / total
        pp = self.ticklog.phase_percentiles()
        if pp:
            gauges["tick_phase_dominant_p95"] = max(
                v["p95"] for k, v in pp.items() if k != "other")
        rates = {
            "tokens_per_sec": snap.get("tokens_generated_total", 0.0),
            "preemptions_per_sec": snap.get("preemptions_total", 0.0),
            "shed_per_sec": snap.get("shed_total", 0.0),
            "deadline_expired_per_sec":
                snap.get("deadline_expired_total", 0.0),
        }
        for cause, v in self.barrier_causes().items():
            rates[f"barrier_{cause}_per_sec"] = v
        return gauges, rates

    def metrics(self) -> Dict[str, float]:
        """Legacy flat-dict view, assembled from the typed registry.

        NB: the raw-gap ITL percentiles carry PER-TICK-BURST semantics
        under pipelined dispatch — gaps are stamped at the stacked
        drain, so they bimodalize (p50 ~ 0, p95 ~ tick) — and are
        therefore exposed ONLY under itl_p50/p95/max_tick_burst
        (the degenerate bare itl_p50/itl_p95 keys
        are gone). The ITL metrics of record are itl_req_mean_* and
        the registry's real histograms (ttft_seconds,
        itl_req_mean_seconds); see obs/metrics.py HELP.
        """
        m: Dict[str, float] = {
            "requests_total": self._c_requests.value,
            "requests_finished": self._c_finished.value,
            "tokens_generated_total": self._c_tokens.value,
            "preemptions_total": self._c_preempt.value,
            "spec_forwards_total": self._c_spec_fwd.value,
            "spec_drafts_accepted_total": self._c_spec_acc.value,
            # compat: the unlabeled sum over the {cause} family — the
            # key every older consumer (spec bench, tests) reads
            "drain_barriers_total": sum(self.barrier_causes().values()),
        }
        if self._spec_mode:
            fwd = self._c_spec_fwd.value
            m["spec_block_tokens_total"] = self._c_spec_tok.value
            # the speculation headline: tokens each verify forward paid
            # for (1.0 = speculation is earning nothing over plain
            # decode; > 1 = drafts are landing)
            m["spec_tokens_per_forward"] = \
                self._c_spec_tok.value / fwd if fwd else 0.0
            h = self._h_accept
            m["spec_accept_rate"] = \
                h._sum / h._count if h._count else 0.0
        m["spec_mixed_fallback_total"] = self._c_spec_mixed_fb.value
        if self._mixed_fallback_reason is not None:
            # the one-line why: which engine gate
            # sent a requested mixed_dispatch back to the alternating
            # path — the only non-float value in this dict
            m["spec_mixed_fallback_reason"] = self._mixed_fallback_reason
        m["queue_depth"] = len(self.waiting)
        m["active_requests"] = len(self._all_live)
        m["kv_pages_free"] = self.alloc.free_pages
        m["kv_pages_total"] = self.alloc.num_pages
        if hasattr(self.alloc, "hit_tokens"):
            m["prefix_cache_hit_tokens"] = self.alloc.hit_tokens
            m["prefix_cache_lookup_tokens"] = self.alloc.lookup_tokens
        if self.host_tier is not None:
            st = self.host_tier.stats()
            m["kv_tier_pages"] = st["entries"] + st["spilled_entries"]
            m["kv_tier_bytes"] = st["bytes"]
            m["kv_tier_pages_saved_total"] = st["saves"]
            m["kv_tier_pages_restored_total"] = st["restores"]
            m["kv_tier_misses_total"] = st["misses"]
            m["kv_tier_spills_total"] = st["spills"]
            m["kv_tier_hit_rate"] = self._tier_hit_rate()
            if self._tier_restores:
                a = np.asarray(self._tier_restores)
                m["kv_tier_restore_seconds_p50"] = \
                    float(np.percentile(a, 50))
                m["kv_tier_restore_seconds_p95"] = \
                    float(np.percentile(a, 95))
        if self._ttfts:
            a = np.asarray(self._ttfts)
            m["ttft_p50"] = float(np.percentile(a, 50))
            m["ttft_p95"] = float(np.percentile(a, 95))
        if self._itls:
            # raw-gap percentiles carry per-tick-burst semantics under
            # pipelined dispatch (p50 is identically 0.0 between
            # burst-mates at decode_steps_per_tick > 1 — the r05
            # headline artifact), so they are ONLY exposed under the
            # explicit _tick_burst suffix; itl_req_mean_* is the ITL
            # metric of record
            a = np.asarray(self._itls)
            m["itl_p50_tick_burst"] = float(np.percentile(a, 50))
            m["itl_p95_tick_burst"] = float(np.percentile(a, 95))
            m["itl_max_tick_burst"] = float(a.max())
        if self._itl_means:
            a = np.asarray(self._itl_means)
            m["itl_req_mean_p50"] = float(np.percentile(a, 50))
            m["itl_req_mean_p95"] = float(np.percentile(a, 95))
        m["inflight_depth"] = float(self._g_inflight.value)
        m["deadline_expired_total"] = sum(
            c.value for c in self._c_deadline._children.values())
        m["shed_total"] = sum(
            c.value for c in self._c_shed._children.values())
        if self.slo_ttft_s is not None or self.slo_itl_s is not None:
            viol = sum(c.value for c in
                       self._c_slo_viol._children.values())
            ok = self._c_slo_ttft_ok.value + self._c_slo_itl_ok.value
            m["slo_ttft_ok_total"] = self._c_slo_ttft_ok.value
            m["slo_itl_ok_total"] = self._c_slo_itl_ok.value
            m["slo_violations_total"] = viol
            m["slo_burn_rate"] = self._g_slo_burn.value
            m["slo_attainment"] = ok / (ok + viol) if ok + viol else 1.0
        if self._bubbles:
            # device idle per dispatched block (0 = pipeline kept the
            # device busy through the tick's host section): the number
            # dispatch-ahead exists to drive to ~0
            a = np.asarray(self._bubbles)
            m["device_bubble_p50"] = float(np.percentile(a, 50))
            m["device_bubble_p95"] = float(np.percentile(a, 95))
        if self._kv_flushes:
            # write-combined KV window flush (kv_write_combine): host
            # wall per drain-time flush dispatch + tokens landed per
            # flush — the two numbers that say what one pool scatter
            # per drain costs and how much write combining it bought
            a = np.asarray(self._kv_flushes)
            m["kv_flush_p50"] = float(np.percentile(a, 50))
            m["kv_flush_p95"] = float(np.percentile(a, 95))
            m["kv_window_tokens_flushed_total"] = \
                self._c_kv_flushed.value
        # tick anatomy: per-phase p50/p95 over the timeline
        # ring window ("drain" = lazy + barrier drains combined — the
        # bench headline set), the host/device wall split, and the
        # dominant phase's p95 (the autoscale gauge: a host-bound
        # replica shows a fat admit/dispatch/drain phase, a
        # device-bound one a fat fetch share)
        pp = self.ticklog.phase_percentiles()
        for name in ("drain", "admit", "assemble", "dispatch",
                     "mixed", "expire", "spec_emit", "flush"):
            if name in pp:
                m[f"tick_phase_{name}_p50"] = pp[name]["p50"]
                m[f"tick_phase_{name}_p95"] = pp[name]["p95"]
        if pp:
            m["tick_phase_dominant_p95"] = max(
                v["p95"] for k, v in pp.items() if k != "other")
        total = self._t_host_total + self._t_device_total
        if total > 0:
            m["tick_host_frac"] = self._t_host_total / total
            m["tick_device_frac"] = self._t_device_total / total
        if self._mixed_mode:
            # prompt tokens that rode fused mixed blocks —
            # under mixed dispatch ALL prefill work is inline, so this
            # pairs with drain_barriers admission == 0 as the evidence
            # that the admission barrier class is retired
            m["mixed_dispatch_prefill_tokens_inline"] = \
                float(self._inline_pf_tokens)
        if self._sp_enabled:
            m["seq_parallel_prefill_tokens_total"] = \
                self._c_sp_tokens.value
        return m

    def barrier_causes(self) -> Dict[str, float]:
        """Per-cause FULL-barrier counts: the drain_barriers_total
        {cause=} family as a plain dict (bench.py's breakdown key —
        which membership-change class is costing the pipeline)."""
        fam = self._c_barriers
        with fam._lock:
            items = list(fam._children.items())
        return {vals[0]: child.value for vals, child in items}

    # -- host KV tier hooks (cache/hosttier.py) ------------------------------

    def _tier_hit_rate(self) -> float:
        st = self.host_tier
        lookups = st.restores + st.misses
        return st.restores / lookups if lookups else 0.0

    def _tier_save(self, h: bytes, pid: int) -> None:
        """Allocator on_evict hook: demote the recycled page's bytes to
        the host tier. The page is registered (content-immutable) until
        this very moment, so the gather reads stable bytes; read_pages
        flushes the write-combined window itself if it is dirty. The
        allocator swallows exceptions — a failed demotion costs a
        future prefill, never correctness."""
        k, v, ks, vs = self.engine.read_pages([pid])
        self.host_tier.save(h, k[:, 0], v[:, 0],
                            None if ks is None else ks[:, 0],
                            None if vs is None else vs[:, 0])
        self._c_tier_saved.inc()

    def _tier_revive(self, h: bytes) -> Optional[int]:
        """Allocator reviver hook: on a registry miss during admission's
        prefix walk, pull the chain's next page back from the host tier
        into a freshly claimed page. Returns the page id (the walk
        continues as a normal prefix hit) or None on a tier miss /
        page exhaustion (the admission prefills the tail itself)."""
        t0 = time.monotonic()
        data = self.host_tier.load(h)
        if data is None:
            self._c_tier_miss.inc()
            self._g_tier_hit.set(self._tier_hit_rate())
            return None
        try:
            pid = self.alloc.import_page(h)
        except MemoryError:
            return None  # every page held by a live slot: no revive
        if pid is None:
            # digest already registered (idempotent re-import shape):
            # serve the walk from the live entry
            return self.alloc.lookup(h)
        k, v, ks, vs = data
        self.engine.write_pages(
            [pid], k[:, None], v[:, None],
            None if ks is None else ks[:, None],
            None if vs is None else vs[:, None])
        dt = time.monotonic() - t0
        self._h_tier_restore.observe(dt)
        self._tier_restores.append(dt)
        self._c_tier_restored.inc()
        self._g_tier_hit.set(self._tier_hit_rate())
        return pid

    # -- internals ----------------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def _sp_qualifies(self, req: Request) -> bool:
        """Does this prompt belong to the seq-parallel long-prompt
        lane? (The normal admission loops break on a qualifying head
        so the lane keeps FCFS order — a long prompt waits for the
        lane, it never falls back to a single-device prefill.)"""
        return (self._sp_enabled and len(req.all_tokens)
                > self.engine.runtime.seq_parallel_threshold)

    def _sp_admit(self) -> None:
        """Admit the head-of-queue request into the seq-parallel lane
        when it qualifies and the lane is empty: pages for the WHOLE
        prompt (+1 for the first decode token) are allocated up front —
        every chunk scatters straight into the pool, so there is no
        later growth point mid-prefill."""
        if not self._sp_enabled or self._sp_group or not self.waiting:
            return
        req = self.waiting[0]
        if not self._sp_qualifies(req):
            return
        slot = self._free_slot()
        if slot is None:
            return
        if self._shares_inflight_prefix(req):
            return  # defer: a gang member is writing req's prefix
        cached = self.alloc.admit(slot, req.all_tokens,
                                  len(req.all_tokens) + 1)
        if cached is None:
            return  # pool exhausted; decode will free/preempt
        self.waiting.popleft()
        req.slot, req.state = slot, "prefilling"
        req.prefilled = req.cached_at_admit = cached
        self.slots[slot] = req
        self._sp_group.append(req)
        self.engine.set_table_row(slot, self.alloc.pages_of(slot))
        self._epoch += 1  # membership changed: operands rebuild
        wait = time.monotonic() - req.t_enqueued
        self._h_queue_wait.observe(wait)
        if self.flightrec is not None:
            self.flightrec.note("admit", id=req.id, slot=slot,
                                queue_wait_s=wait, cached=cached,
                                seq_parallel=True)
        if self.trace is not None:
            self.trace.event(req.id, "admit", slot=slot,
                             queue_wait_s=wait,
                             prefix_cache_hit_tokens=cached,
                             resumed=req.preemptions > 0,
                             seq_parallel=True)

    def _sp_prefill_step(self) -> int:
        """Dispatch ONE seq-parallel prefill chunk for the lane's
        request (engine.sp_prefill_chunk). Returns the prompt tokens
        dispatched (0 = lane empty or blocked).

        The chunk program donates the newest pool binding, so any
        in-flight decode blocks drain first — the established donation
        barrier (same hazard as admission prefills on the alternating
        path). On completion the request leaves through
        _finish_prefill like any gang member: pages publish to the
        prefix registry and the first token samples from the chunk's
        last-position logits."""
        if not self._sp_group:
            return 0
        req = self._sp_group[0]
        if self._inflight or self._pending_first:
            self._drain_inflight("sp_prefill")
            if req.done or req.slot is None:
                return 0  # the drain finished or preempted it
        toks = req.all_tokens
        chunk = toks[req.prefilled:req.prefilled + self._sp_chunk]
        if not chunk:
            return 0
        if self.trace is not None:
            self.trace.event(req.id, "sp_prefill_chunk",
                             start=req.prefilled, tokens=len(chunk),
                             degree=self.engine.sp_degree)
        logits = self.engine.sp_prefill_chunk(req.slot, chunk,
                                              req.prefilled)
        req.prefilled += len(chunk)
        self._c_sp_tokens.inc(len(chunk))
        if req.prefilled >= len(toks):
            # logits is [V] — _finish_prefill samples from [M, V] rows
            self._finish_prefill([req], logits[None, :])
            # mixed carries: the slot enters decode phase (plen 0); its
            # pool length was set by the chunk dispatches themselves
            self._plen_host[req.slot] = 0
        return len(chunk)

    def _admit(self, sp_spent: int = 0) -> None:
        """Group admission: gang-admit waiting requests and run the
        prefill group's next chunks as batched dispatches, repeating
        while budget remains and progress is possible (a round whose
        members all complete cheaply leaves budget for another gang).

        `sp_spent`: per-shard prompt tokens the seq-parallel lane
        already dispatched this tick — it counts against the tick's
        prefill budget so a tick never chews more than ~prefill_chunk
        tokens per device."""
        rt = self.engine.runtime
        if rt.scheduler == "static":
            # Static batching: no interleave — admit (and fully prefill)
            # whole batches only once the previous batch has drained;
            # budget None = whole prompts at once.
            if self.running or self._prefill_group:
                return
            budget = None
        else:
            budget = max(1, rt.prefill_chunk) - sp_spent
            if budget <= 0:
                return
        while True:
            used = self._admit_round(budget)
            if used is None:
                return
            if budget is not None:
                budget -= used
                if budget <= 0:
                    return

    def _admit_inline(self) -> None:
        """Mixed-dispatch admission: pull waiting requests
        into free slots WITHOUT a drain barrier or a separate prefill
        dispatch — the prompt rides the next fused block's prefill
        lanes. Admission here is pure host bookkeeping plus per-slot
        device carry edits between dispatches (_seed_mixed_slot, the
        established reset_slot pattern: ``.at[slot].set`` on arrays
        in-flight blocks never touch for a free slot).

        The concurrent-prefill cap (_mixed_max_pf, derived from
        RuntimeConfig.prefill_inline_budget) bounds how many slots may
        be in prefill phase at once — with chunk width C per slot per
        scan step, at most ~prefill_inline_budget prompt tokens are
        chewed per step while decode slots wait on that step's
        forward. That bound IS the ITL-tail knob."""
        admitted = False
        while (self.waiting
               and len(self._prefill_group) < self._mixed_max_pf):
            slot = self._free_slot()
            if slot is None:
                break
            req = self.waiting[0]
            if self._sp_qualifies(req):
                break  # long prompt: waits for the seq-parallel lane
            if self._shares_inflight_prefix(req):
                break  # defer: a gang member is writing req's prefix
            cached = self.alloc.admit(slot, req.all_tokens,
                                      len(req.all_tokens) + 1)
            if cached is None:
                break  # pool exhausted; decode will free/preempt
            self.waiting.popleft()
            req.slot, req.state = slot, "prefilling"
            req.prefilled = req.cached_at_admit = cached
            self.slots[slot] = req
            self._prefill_group.append(req)
            self.engine.set_table_row(slot, self.alloc.pages_of(slot))
            self._seed_mixed_slot(req)
            admitted = True
            wait = time.monotonic() - req.t_enqueued
            self._h_queue_wait.observe(wait)
            if self.flightrec is not None:
                self.flightrec.note("admit", id=req.id, slot=slot,
                                    queue_wait_s=wait, cached=cached)
            if self.trace is not None:
                self.trace.event(req.id, "admit", slot=slot,
                                 queue_wait_s=wait,
                                 prefix_cache_hit_tokens=cached,
                                 resumed=req.preemptions > 0)
        if admitted:
            self._epoch += 1  # membership changed: operands rebuild

    def _seed_mixed_slot(self, req: Request) -> None:
        """Device-carry seeding for one mixed-dispatch admission. Every
        write is an ``.at[slot].set`` on the CURRENT carry binding —
        i.e. on the result of the newest in-flight block — so it lands
        after that block in device program order. The slot is free in
        every in-flight block's snapshot (inactive lanes advance
        nothing and their writes land on the null page), so nothing
        here races a dispatched program.

        The port writes out of place (_at_set) for the same reason.

        Seeds: pool lengths at the cached prefix (the warm-prefix
        contract), window count at zero, the chunk cursor at the
        cached prefix, and the prompt tokens — into the prompt-buffer
        row (plain mixed) or the token-history row (spec mixed, where
        history doubles as the prompt buffer and the budget injects
        into the device remainder carry when one is live)."""
        eng = self.engine
        slot, toks = req.slot, req.all_tokens
        cached = req.cached_at_admit
        eng.cache = eng.cache._replace(
            lengths=_at_set(eng.cache.lengths, slot, cached))
        if eng._win_len is not None:
            eng._win_len = _at_set(eng._win_len, slot, 0)
        cur = self._cursor_dev if self._cursor_dev is not None \
            else torch.zeros((eng.num_slots,), dtype=torch.int32,
                             device=eng.device)
        self._cursor_dev = _at_set(cur, slot, cached)
        self._plen_host[slot] = len(toks)
        if self._spec_mode:
            row = np.zeros((self._hist_dev.shape[1],), np.int32)
            row[:len(toks)] = toks
            self._hist_dev = _at_set(self._hist_dev, slot, row)
            self._hist_len_dev = _at_set(self._hist_len_dev, slot,
                                         len(toks))
            if self._spec_rem is not None:
                self._spec_rem = _at_set(
                    self._spec_rem, slot,
                    req.max_new_tokens - len(req.output))
        else:
            if self._pbuf_dev is None:
                self._pbuf_dev = torch.zeros(
                    (eng.num_slots, eng.cache.max_seq), dtype=torch.int32,
                    device=eng.device)
            row = np.zeros((self._pbuf_dev.shape[1],), np.int32)
            row[:len(toks)] = toks
            self._pbuf_dev = _at_set(self._pbuf_dev, slot, row)

    def _admit_round(self, budget: Optional[int]) -> Optional[int]:
        """One gang-admission round: pull waiting requests into the
        prefill group (bounded by free slots, pages, prefill_max_batch,
        and the remaining token budget), pack every member's next chunk
        under the budget FCFS, and dispatch the chunks as batched
        [B, Tbucket] prefills bucketed by chunk length (plus freshness
        only when engine.prefill_gang_split_fresh — the seed rule,
        kept for prefill_flash_warm=False).

        Returns the number of prompt tokens dispatched, or None if no
        progress was possible (nothing admissible and nothing to
        prefill)."""
        rt = self.engine.runtime
        cap = max(1, min(rt.prefill_max_batch, self.engine.num_slots))
        demand = sum(len(r.all_tokens) - r.prefilled
                     for r in self._prefill_group)
        while (self.waiting and len(self._prefill_group) < cap
               and (budget is None or demand < budget)):
            slot = self._free_slot()
            if slot is None:
                break
            req = self.waiting[0]
            if self._sp_qualifies(req):
                break  # long prompt: waits for the seq-parallel lane
            if self._shares_inflight_prefix(req):
                break  # defer: a gang member is writing req's prefix
            # all_tokens includes output if preempted earlier; admit
            # may attach already-cached prefix pages (prefix caching),
            # whose tokens skip prefill entirely via the warm path.
            cached = self.alloc.admit(slot, req.all_tokens,
                                      len(req.all_tokens) + 1)
            if cached is None:
                break  # pool exhausted; decode will free/preempt
            self.waiting.popleft()
            req.slot, req.state = slot, "prefilling"
            req.prefilled = req.cached_at_admit = cached
            self.slots[slot] = req
            self._prefill_group.append(req)
            self.engine.set_table_row(slot, self.alloc.pages_of(slot))
            demand += len(req.all_tokens) - cached
            wait = time.monotonic() - req.t_enqueued
            self._h_queue_wait.observe(wait)
            if self.flightrec is not None:
                self.flightrec.note("admit", id=req.id, slot=slot,
                                    queue_wait_s=wait, cached=cached)
            if self.trace is not None:
                self.trace.event(req.id, "admit", slot=slot,
                                 queue_wait_s=wait,
                                 prefix_cache_hit_tokens=cached,
                                 resumed=req.preemptions > 0)
            # (no length bookkeeping for `cached` needed: the member's
            # first warm chunk sets lengths[slot] = cached + len(chunk))
        if not self._prefill_group:
            return None

        # pack each member's next chunk under the budget, FCFS — members
        # admitted earlier win budget, exactly like the old serialized
        # admission, so carried members can't starve behind new arrivals
        plan: List[tuple] = []  # (req, chunk, start)
        used = 0
        for req in self._prefill_group:
            room = None if budget is None else budget - used
            if room is not None and room <= 0:
                break
            prefix = req.all_tokens
            end = len(prefix) if room is None \
                else min(len(prefix), req.prefilled + room)
            chunk = prefix[req.prefilled:end]
            if not chunk:
                continue
            plan.append((req, chunk, req.prefilled))
            used += len(chunk)
        if not plan:
            return None

        # bucket by (freshness, padded chunk length): members sharing a
        # bucket ride ONE [B, Tbucket] dispatch. Freshness splits the
        # gang ONLY when the engine's fresh program is kernelized but
        # its warm one is dense (prefill_gang_split_fresh) — there a
        # warm prefix-cache or carried member would drag cold members
        # off the flash path. With warm-prefix flash (the
        # default where kernels run) the warm program takes the kernel
        # too, so mixed gangs ride one dispatch and the all-or-nothing
        # freshness downgrade is gone.
        split_fresh = self.engine.prefill_gang_split_fresh
        hi = self.engine.cache.max_seq
        dispatches: Dict[tuple, List[tuple]] = {}
        for req, chunk, start in plan:
            key = (start == 0 if split_fresh else True,
                   bucket_len(len(chunk), hi=hi))
            dispatches.setdefault(key, []).append((req, chunk, start))
        for (_, bucket), members in dispatches.items():
            self._h_prefill_batch.observe(len(members))
            if self.trace is not None:
                self.trace.event(None, "prefill_batch",
                                 members=len(members),
                                 slots=[m[0].slot for m in members],
                                 bucket=bucket,
                                 tokens=sum(len(m[1]) for m in members),
                                 fresh=all(m[2] == 0 for m in members))
                for req, chunk, start in members:
                    self.trace.event(req.id, "prefill_chunk",
                                     start=start, tokens=len(chunk))
            logits = self.engine.prefill_batch(
                [m[0].slot for m in members], [m[1] for m in members],
                [m[2] for m in members])
            done_rows, done_reqs = [], []
            for i, (req, chunk, start) in enumerate(members):
                req.prefilled = start + len(chunk)
                if req.prefilled >= len(req.all_tokens):
                    done_rows.append(i)
                    done_reqs.append(req)
            if done_reqs:
                # device-side row gather: completing members' first
                # tokens sample from THIS dispatch, no host sync
                self._finish_prefill(done_reqs,
                                     logits[torch.as_tensor(
                                         done_rows, device=logits.device)])
        return used

    def _shares_inflight_prefix(self, req: Request) -> bool:
        """Prefix caching only: would `req` hit KV pages a current gang
        member is still writing? Serialized admission accidentally
        guaranteed that a request arriving behind a same-prefix request
        admitted AFTER the first registered its pages — and so shared
        them. Gang admission would put both in one group and pay the
        shared prefix's prefill twice. Keep the guarantee deliberately:
        if req's leading full block chain-matches an in-flight member's,
        defer its admission one round — the member registers at
        prefill_done and req then admits with a cache hit. FIFO order is
        preserved (admission simply stops for the round), matching the
        old behavior where such a request blocked behind the serialized
        prefill anyway."""
        if not self.engine.runtime.prefix_caching or not self._prefill_group:
            return False
        from butterfly_tpu_torch.cache.prefix import chain_block_hashes
        ps = self.alloc.page_size
        head = chain_block_hashes(req.all_tokens, ps, 1)
        if not head:  # shorter than one block: nothing cacheable
            return False
        return any(chain_block_hashes(m.all_tokens, ps, 1) == head
                   for m in self._prefill_group)

    def _finish_prefill(self, reqs: List[Request], logits) -> None:
        """Members whose prompt is now fully in cache: publish pages for
        prefix reuse (no-op without prefix caching), sample every
        member's first token ON DEVICE from the shared dispatch's logits
        [M, V] in one vectorized draw, start decoding. Tokens are
        fetched at the next stacked drain; even a max_new==1 request
        keeps its slot until then (its extra decode steps are discarded
        like any post-finish in-flight work)."""
        for req in reqs:
            self.alloc.register(req.slot, req.all_tokens)
            if req in self._prefill_group:
                self._prefill_group.remove(req)
            else:  # the seq-parallel lane finishes through here too
                self._sp_group.remove(req)
            req.state = "running"
            self.running.append(req)
            ran = len(req.all_tokens) - req.cached_at_admit
            self._h_prefill_tokens.observe(ran)
            if self.trace is not None:
                self.trace.event(req.id, "prefill_done", tokens=ran,
                                 total=len(req.all_tokens))
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(self._block_seed())
        firsts = sample_batched(
            logits, gen,
            torch.as_tensor([r.temperature for r in reqs],
                            dtype=torch.float32),
            self.engine.runtime_top_k, self.engine.runtime_top_p)
        base = self._next_dev if self._next_dev is not None \
            else _host_to(firsts, self._next_tokens)
        slots_arr = torch.as_tensor([r.slot for r in reqs],
                                    dtype=torch.long, device=firsts.device)
        self._next_dev = _at_set(base, slots_arr, firsts)
        if self._spec_mode:
            # seed the device-side token history the on-device drafter
            # reads: the full prompt (+ prior output on readmission)
            # from the host, plus the device-resident first token —
            # no host sync, the spec block chains on this carry
            H = self._hist_dev.shape[1]
            rows = np.zeros((len(reqs), H), np.int32)
            lens = np.zeros((len(reqs),), np.int32)
            for i, req in enumerate(reqs):
                toks = req.all_tokens
                rows[i, :len(toks)] = toks
                lens[i] = len(toks)
            # a model draft source reseeds the members' draft KV from
            # the SAME rows (first token excluded — the draft_len ==
            # hist_len - 1 invariant); no-op for stateless sources.
            # Admission runs behind a full drain barrier, so no spec
            # block is in flight against the donated draft state.
            self.engine.draft_prefill(slots_arr, rows, lens)
            hist = _at_set(self._hist_dev, slots_arr, rows)
            hist[slots_arr, torch.as_tensor(lens, dtype=torch.long,
                                            device=hist.device)] = firsts
            self._hist_dev = hist
            self._hist_len_dev = _at_set(self._hist_len_dev, slots_arr,
                                         lens + 1)
        for i, req in enumerate(reqs):
            self._pending_first.append(
                (req, req.preemptions, req.slot, firsts[i]))
            self._pending_first_keys.add((req.id, req.preemptions))
        self._epoch += 1  # running set + pending-first set changed

    def _decode_block(self, k: int) -> bool:
        """Dispatch ONE fused k-step decode block for the running set
        (engine.decode_block_async), chained on the previous block's
        device-resident carry — the previous block need NOT be drained
        first (dispatch-ahead). Host work — operand assembly, the
        host-to-device conversions, the block seed, the dispatch itself —
        is paid once per BLOCK instead of once per token, and the
        operand assembly itself is cached on the batch-membership
        epoch: back-to-back blocks over an unchanged batch reuse the
        active/temps/stops arrays and the slot snapshot, refreshing
        only the budget vector (base minus the steps already in
        flight — the device decrements its own copy inside each scan,
        so the host estimate must run ahead the same way). Page growth
        happened at tick start (the len + (inflight+1)*k + 1
        preallocation covers every step of every undrained scan).

        Per-slot stop ids and remaining-token budgets ride into the
        scan so a slot that finishes mid-block is masked ON DEVICE
        (lengths freeze, writes land on the null page) rather than
        generating garbage the drain discards; a finished slot's chain
        token stays frozen at its stop id, so every later in-flight
        block starts it dead too.

        Returns True iff a block was dispatched.
        """
        if not self.running:
            return False
        active, temps, stops, base, specm, snapshot = self._assemble()
        # steps dispatched but undrained: the device consumed (at most)
        # this much of each live slot's budget already. A slot that
        # went dead early consumed less, but its chain token is frozen
        # at its stop id (or its budget is genuinely spent), so
        # under-budgeting it cannot drop real tokens.
        ahead = sum(e[3] for e in self._inflight)
        budgets = np.maximum(base - ahead, 0) if ahead else base
        if not (active & (budgets > 0)).any():
            return False  # every runner is out of budget on device
        sub = self._block_seed()
        # chain on the device token vector admissions write into (which
        # the previous block's final vector seeded); the host vector
        # only on the cold first dispatch
        cur = self._next_dev if self._next_dev is not None \
            else self._next_tokens
        block, final = self.engine.decode_block_async(
            cur, active, temps, stops, budgets, sub, k)
        self._next_dev = final
        # slot 1: the completion event _device_ready probes (the chain
        # carry lives in _next_dev)
        self._inflight.append(("decode", self.engine.record_event(), block,
                               k, snapshot, time.monotonic()))
        self._note_bubble()
        return True

    def _assemble(self) -> tuple:
        """Per-block host operands — the active/temps/stops/base-budget
        /spec-mask arrays and the slot snapshot — cached on the batch-
        membership epoch: back-to-back blocks over an unchanged batch
        skip the per-slot Python rebuild and the np.asarray churn.

        Mixed dispatch extends the batch to prefill-group members too:
        their lanes ride the same block (phase decided on device by
        cursor < plen), and their budget is the full remaining
        emission allowance (output is empty unless resumed from a
        preemption)."""
        if self._operands_epoch != self._epoch:
            t0 = time.monotonic()
            S = self.engine.num_slots
            active = np.zeros((S,), bool)
            temps = np.zeros((S,), np.float32)
            stops = np.full((S,), -1, np.int32)
            base = np.zeros((S,), np.int32)
            specm = np.zeros((S,), bool)
            # seq-parallel-lane members never ride a block: their
            # prefill happens in dedicated sp_prefill_chunk dispatches
            # and they enter `running` only via _finish_prefill.
            batch = (list(self.running) + list(self._prefill_group)
                     if self._mixed_mode else self.running)
            for req in batch:
                active[req.slot] = True
                temps[req.slot] = req.temperature
                stops[req.slot] = req.stop_token
                specm[req.slot] = req.speculative
                # tokens the request may still emit: max_new minus what
                # the host has drained, minus an undrained
                # admission-time first token (queued in _pending_first;
                # set lookup — the old per-runner linear scan over the
                # pending list was O(running x pending) every block)
                pending = (req.id,
                           req.preemptions) in self._pending_first_keys
                base[req.slot] = (req.max_new_tokens - len(req.output)
                                  - int(pending))
            self._operands = (active, temps, stops, base, specm,
                              {req.slot: (req, req.preemptions)
                               for req in batch})
            self._operands_epoch = self._epoch
            self._phase_add("assemble", time.monotonic() - t0)
        return self._operands

    def _note_bubble(self) -> None:
        if self._idle_at_host0:
            # the newest in-flight carry was already materialized when
            # this tick's host section began: the device sat idle
            # through all of it — the bubble dispatch-ahead closes
            bubble = time.monotonic() - self._t_host0
            self._h_bubble.observe(bubble)
            self._bubbles.append(bubble)
        elif self._had_inflight_at_host0:
            self._h_bubble.observe(0.0)
            self._bubbles.append(0.0)
        self._idle_at_host0 = self._had_inflight_at_host0 = False

    def _spec_block(self, rounds: int) -> bool:
        """Dispatch ONE fused speculative block (engine.spec_block_async)
        — `rounds` chained draft → batched-multi-slot-verify →
        on-device-accept rounds — chained on the device-resident
        history/budget carry exactly like _decode_block chains on the
        final-token vector, so `inflight_blocks >= 2` pipelines spec
        rounds with host scheduling (no full drain barrier per round:
        the old host accept loop drained EVERY round).

        Budgets: the first dispatch after a full barrier seeds the
        device budget vector from exact host state (base, minus
        nothing — the barrier drained every in-flight token); chained
        dispatches thread the previous block's device-resident
        remainder through, because a spec block's consumption is
        variable (1..gamma+1 tokens per live slot per round) and only
        the device knows it before the drain. Membership changes force
        a barrier anyway, so the carry is always exact.

        Returns True iff a block was dispatched."""
        if not self.running:
            return False
        active, temps, stops, base, specm, snapshot = self._assemble()
        if self._spec_rem is None:
            if not (active & (base > 0)).any():
                return False  # everything already emitted (undrained)
            budgets = base
        else:
            # device carry: exact remainder after every in-flight
            # round. The host cannot cheaply inspect it; dispatching a
            # potentially-empty block is safe — each tick still drains
            # the oldest block, so finishes keep surfacing and the
            # barrier-on-finish resets the carry to host truth.
            budgets = self._spec_rem
        sub = self._block_seed()
        toks, valid, hist, hlen, rem = self.engine.spec_block_async(
            self._hist_dev, self._hist_len_dev, active, temps, stops,
            budgets, specm, sub, rounds)
        self._hist_dev, self._hist_len_dev, self._spec_rem = hist, hlen, rem
        # slot 1: the completion event _device_ready probes (the JAX
        # entry holds hist_len, whose is_ready() a torch tensor lacks)
        self._inflight.append(("spec", self.engine.record_event(),
                               (toks, valid), rounds,
                               snapshot, time.monotonic()))
        self._note_bubble()
        return True

    def _mixed_block(self, k: int) -> bool:
        """Dispatch ONE fused MIXED block: decode (or spec)
        lanes and prefill lanes ride the same k-step jitted program
        (engine.mixed_block_async / mixed_spec_block_async), chained
        on the device carries exactly like _decode_block/_spec_block —
        one dispatch per tick covering both phases.

        The host runs a cheap lockstep simulation of each prefill
        lane's cursor: chunk progress is deterministic while a lane is
        live (a prefilling lane cannot die mid-prompt — its first
        possible emission is the completion-sampled first token), so
        ``req.prefilled`` advances to the block's post-state at
        DISPATCH time and the completion set rides the in-flight entry
        for drain-time state transitions (_mixed_transitions). For
        plain mixed the same simulation also yields per-slot emission
        counts, the budget look-ahead chained dispatches subtract
        (stop-deaths make it an over-estimate, which is safe for the
        same frozen-chain-token reason as _decode_block). Spec mixed
        instead threads the device-resident remainder carry through,
        exactly like _spec_block.

        Returns True iff a block was dispatched."""
        if not (self.running or self._prefill_group):
            return False
        active, temps, stops, base, specm, snapshot = self._assemble()
        S = self.engine.num_slots
        sub = self._block_seed()
        plen = self._plen_host
        cursor = self._cursor_dev if self._cursor_dev is not None \
            else torch.zeros((S,), dtype=torch.int32,
                             device=self.engine.device)
        if self._spec_mode:
            C = self._mixed_chunk  # gamma + 1: the verify shape
            if self._spec_rem is None:
                if not (active & (base > 0)).any():
                    return False  # everything already emitted (undrained)
                budgets = base
            else:
                budgets = self._spec_rem
            # deterministic cursor advance: C prompt tokens per round
            # while mid-prefill (emissions can't kill the lane first)
            pf_done = []
            for req in list(self._prefill_group):
                p = int(plen[req.slot])
                if req.prefilled < p:
                    adv = min(p, req.prefilled + k * C)
                    self._inline_pf_tokens += adv - req.prefilled
                    req.prefilled = adv
                if req.prefilled >= p:
                    pf_done.append(req.slot)
            toks, valid, hist, hlen, rem, cursor = \
                self.engine.mixed_spec_block_async(
                    self._hist_dev, self._hist_len_dev, cursor, plen,
                    active, temps, stops, budgets, specm, sub, k)
            self._hist_dev, self._hist_len_dev = hist, hlen
            self._spec_rem, self._cursor_dev = rem, cursor
            self._inflight.append(("mixed_spec", self.engine.record_event(),
                                   (toks, valid), k,
                                   snapshot, time.monotonic(), pf_done,
                                   None))
            self._note_bubble()
            return True
        # plain mixed: chunk width C only while a prompt is actually in
        # flight — with no prefill lane the program collapses to C=1,
        # the exact _decode_scan shape (and its RNG stream)
        C = self._mixed_chunk if self._prefill_group else 1
        ahead = np.zeros((S,), np.int64)
        for ent in self._inflight:
            ahead = ahead + ent[7]  # per-slot emission estimates
        budgets = np.maximum(base - ahead, 0).astype(np.int32)
        if not (active & (budgets > 0)).any():
            return False  # every lane is out of budget on device
        # lockstep host sim per lane: cursor end-state, emission count,
        # completion membership. Mirrors the device scan exactly up to
        # stop-deaths, which only shrink emissions after the fact.
        emit_vec = np.zeros((S,), np.int32)
        pf_done = []
        for slot, (req, _gen) in snapshot.items():
            b = int(budgets[slot])
            if not active[slot] or b <= 0:
                continue
            c, p, e = req.prefilled, int(plen[slot]), 0
            for _ in range(k):
                if c < p:
                    c = min(p, c + C)
                    if c < p:
                        continue
                e += 1  # completion first token, or a decode step
                if e >= b:
                    break
            if c != req.prefilled:
                self._inline_pf_tokens += c - req.prefilled
                req.prefilled = c
            emit_vec[slot] = e
            if req.state == "prefilling" and c >= p:
                pf_done.append(slot)
        cur = self._next_dev if self._next_dev is not None \
            else self._next_tokens
        if self._pbuf_dev is None:
            self._pbuf_dev = torch.zeros((S, self.engine.cache.max_seq),
                                         dtype=torch.int32,
                                         device=self.engine.device)
        block, valid, final, cursor = self.engine.mixed_block_async(
            cur, cursor, self._pbuf_dev, plen, active, temps, stops,
            budgets, sub, k, C)
        self._next_dev, self._cursor_dev = final, cursor
        # slot 1 of a mixed entry: the completion event _device_ready
        # probes (the chain carry itself lives in _next_dev)
        self._inflight.append(("mixed", self.engine.record_event(),
                               (block, valid), k,
                               snapshot, time.monotonic(), pf_done,
                               emit_vec))
        self._note_bubble()
        return True

    def _drain_inflight(self, cause: str = "finish") -> bool:
        """FULL drain barrier: fetch every pending first token and
        in-flight block in ONE stacked device read. Returns True if any
        request finished. In spec mode the device budget carry resets
        to None — the host again knows every emitted token, so the
        next dispatch reseeds it from exact host state.

        `cause` labels the barrier in drain_barriers_total{cause=}
        (the membership-change class that forced it: admission, finish,
        page_pressure, cancel, spec, idle, expired, flush) and rides
        the tick's timeline record + the flight-recorder ring."""
        t0 = time.monotonic()
        if self._inflight or self._pending_first:
            self._c_barriers.labels(cause).inc()
            self._tick_causes.append(cause)
            if self.flightrec is not None:
                self.flightrec.note("barrier", cause=cause,
                                    inflight=len(self._inflight))
        blocks, self._inflight = self._inflight, []
        self._spec_rem = None
        tp = self._tick_phases
        sub0 = tp["flush"] + tp["spec_emit"]
        out = self._drain_blocks(blocks)
        self._phase_add("drain_barrier",
                        max(0.0, time.monotonic() - t0
                            - (tp["flush"] + tp["spec_emit"] - sub0)))
        return out

    def _drain_oldest(self) -> bool:
        """Lazy-drain step: fetch the pending firsts and ONLY the
        oldest in-flight block, leaving newer blocks running on the
        device (the dispatch-ahead overlap — the device computes block
        t+1 while the host emits block t). Returns True if any request
        finished (the caller escalates that to a full barrier)."""
        t0 = time.monotonic()
        tp = self._tick_phases
        sub0 = tp["flush"] + tp["spec_emit"]
        out = self._drain_blocks([self._inflight.pop(0)]
                                 if self._inflight else [])
        self._phase_add("drain_oldest",
                        max(0.0, time.monotonic() - t0
                            - (tp["flush"] + tp["spec_emit"] - sub0)))
        return out

    def _drain_blocks(self, blocks: List[tuple]) -> bool:
        """Fetch + emit the given decode blocks (ONE stacked device
        fetch) and do their host bookkeeping in chronological order.
        Pending first tokens always ride along: they are queued at an
        admission barrier, when nothing is in flight, so they predate
        every dispatched block; each block's [k, S] rows are then
        emitted in step order per live slot, truncated per request at
        its stop token / max_new by _emit.

        Requests that finished, were cancelled, or were preempted
        between dispatch and drain have their tokens discarded — the
        generation check catches even a preemption readmitted into the
        SAME slot. Slots that went dead mid-block carry frozen repeats
        of their last token, which the done-break below skips (the
        device stopped their writes and length growth inside the scan).
        """
        # Flush the write-combined KV window FIRST (kv_write_combine):
        # the flush dispatch lands after every staged block in device
        # order, so by the time an emission below finishes a request —
        # registering its pages for prefix reuse and releasing them for
        # reclaim — every staged K/V byte is in the pool. No-op (None)
        # when nothing is staged; the flushed-token count is a device
        # scalar that rides this drain's one stacked fetch.
        t_flush = time.monotonic()
        flushed = self.engine.flush_kv_window()
        if flushed is not None:
            dt = time.monotonic() - t_flush
            self._h_kv_flush.observe(dt)
            self._kv_flushes.append(dt)
            self._phase_add("flush", dt)
            if self.flightrec is not None:
                self.flightrec.note("flush", dispatch_s=dt)
        firsts, self._pending_first = self._pending_first, []
        self._pending_first_keys.clear()  # refreshed: all entries drain
        if not blocks and not firsts:
            if flushed is not None:
                self._c_kv_flushed.inc(int(flushed))
            return False
        finished_before = self._c_finished.value
        C = self.engine.spec_emit_width
        i64 = torch.int64
        parts = [f[3].reshape(1).to(i64) for f in firsts]
        for ent in blocks:
            if ent[0] == "decode":
                parts.append(ent[2].reshape(-1).to(i64))
            else:  # spec/mixed: stacked emissions + validity mask ride
                # the same single fetch (bool widened to the int dtype)
                toks3, valid3 = ent[2]
                parts.append(toks3.reshape(-1).to(i64))
                parts.append(valid3.to(i64).reshape(-1))
        if flushed is not None:
            parts.append(flushed.reshape(1).to(i64))  # trailing
        # the ONE stacked device fetch: the only tick section that
        # blocks on the device — timed for the tick_host_frac /
        # tick_device_frac split (everything else in a tick is host).
        # The parts concatenate ON the device and cross in ONE copy, so
        # the drain pays one host sync however many blocks it holds.
        t_fetch = time.monotonic()
        vals = torch.cat(parts).cpu().numpy()
        self._tick_fetch += time.monotonic() - t_fetch
        if flushed is not None:
            self._c_kv_flushed.inc(int(vals[-1]))
        now = time.monotonic()
        nf = len(firsts)
        S = self.engine.num_slots
        for (req, gen, slot, _), tok in zip(firsts, vals[:nf]):
            # stale if the request was cancelled or preempted (a
            # readmission queues a fresh entry with a new generation)
            if req.done or req.slot != slot or req.preemptions != gen:
                continue
            self._next_tokens[slot] = int(tok)
            self._emit(req, int(tok))
        off = nf
        for ent in blocks:
            kind, _, _, k, snapshot, t_dispatch = ent[:6]
            self._h_decode_block.observe(now - t_dispatch)
            if kind in ("mixed", "mixed_spec"):
                # prefill lanes that completed inside this block leave
                # the prefill group BEFORE their first token (riding
                # the block's emission arrays) is emitted below
                self._mixed_transitions(ent[6], snapshot)
            if kind in ("spec", "mixed_spec"):
                toks3 = vals[off:off + k * S * C].reshape(k, S, C)
                off += k * S * C
                valid3 = vals[off:off + k * S * C].reshape(k, S, C) != 0
                off += k * S * C
                t_se = time.monotonic()
                self._emit_spec(toks3, valid3, snapshot)
                self._phase_add("spec_emit", time.monotonic() - t_se)
                continue
            if kind == "mixed":
                # [k, S] tokens + validity: a lane emits at most one
                # token per step, valid only on decode steps and the
                # completion step's first token
                rows = vals[off:off + k * S].reshape(k, S)
                off += k * S
                ok = vals[off:off + k * S].reshape(k, S) != 0
                off += k * S
                for slot, (req, gen) in snapshot.items():
                    if req.done or req.slot != slot \
                            or req.preemptions != gen:
                        continue
                    for tok, good in zip(rows[:, slot].tolist(),
                                         ok[:, slot].tolist()):
                        if not good:
                            continue
                        self._next_tokens[slot] = tok
                        self._emit(req, tok)
                        if req.done:
                            break
                continue
            rows = vals[off:off + k * S].reshape(k, S)
            off += k * S
            for slot, (req, gen) in snapshot.items():
                if req.done or req.slot != slot or req.preemptions != gen:
                    continue
                # ONE vectorized column slice + bulk int conversion per
                # live slot instead of k per-element int(row[slot])
                # casts over the whole [k, S] block (O(k*S) Python work
                # per drain at S=32, k=16)
                for tok in rows[:, slot].tolist():
                    self._next_tokens[slot] = tok
                    self._emit(req, tok)
                    if req.done:
                        break
        self._epoch += 1  # outputs / pending-first changed
        return self._c_finished.value > finished_before

    def _mixed_transitions(self, pf_slots, snapshot: Dict) -> None:
        """Drain-time completion transitions for a mixed block's
        prefill lanes: members whose prompt finished inside the block
        (the dispatch-time host simulation recorded the set) leave the
        prefill group and start decoding. Pages publish for prefix
        reuse exactly where the alternating path's _finish_prefill did
        it — after a point where every staged K/V byte is flushed
        (this drain flushed the window first). The generation check
        skips members cancelled or preempted since dispatch."""
        for slot in pf_slots:
            entry = snapshot.get(slot)
            if entry is None:
                continue
            req, gen = entry
            if req.done or req.slot != slot or req.preemptions != gen:
                continue
            if req.state != "prefilling":
                continue  # an earlier drained block already transitioned
            self.alloc.register(slot, req.all_tokens)
            self._prefill_group.remove(req)
            req.state = "running"
            self.running.append(req)
            ran = len(req.all_tokens) - req.cached_at_admit
            self._h_prefill_tokens.observe(ran)
            if self.trace is not None:
                self.trace.event(req.id, "prefill_done", tokens=ran,
                                 total=len(req.all_tokens))
            self._epoch += 1

    def _emit_spec(self, toks3: np.ndarray, valid3: np.ndarray,
                   snapshot: Dict) -> None:
        """Emit one drained spec block: toks3/valid3 [R, S, C] hold
        each round's emissions per slot (valid marks the real ones —
        device-truncated at stop/budget). Host emission walks rounds in
        dispatch order per live slot, re-truncating via _emit's done
        check as a backstop; per-round acceptance feeds the spec
        instruments (a round's emissions are 1 correction/bonus plus
        `count-1` accepted drafts)."""
        R = toks3.shape[0]
        # per-round acceptance ceiling: gamma accepted drafts for the
        # linear chain, tree depth D = emit_width - 1 for tree mode
        # (the root->leaf walk accepts at most one node per depth)
        denom = self.engine.spec_emit_width - 1
        # verify forwards that did work: rounds with ANY valid emission
        # (trailing all-dead rounds in a block ran but verified nothing)
        self._c_spec_fwd.inc(int(np.any(valid3, axis=(1, 2)).sum()))
        for slot, (req, gen) in snapshot.items():
            if req.done or req.slot != slot or req.preemptions != gen:
                continue
            t_rows = toks3[:, slot, :].tolist()
            v_rows = valid3[:, slot, :].tolist()
            for r in range(R):
                # mixed dispatch: a round that emits the request's very
                # first token is the prefill-completion round, not a
                # verify round — it must not count as a zero-acceptance
                # observation (the alternating path's first token never
                # passes through here either)
                first_round = req.t_first_token is None
                cnt = 0
                for tok, ok in zip(t_rows[r], v_rows[r]):
                    if not ok:
                        continue
                    cnt += 1
                    self._next_tokens[slot] = tok
                    self._emit(req, tok)
                    if req.done:
                        break
                if cnt and not first_round:
                    self._c_spec_tok.inc(cnt)
                    self._c_spec_acc.inc(max(0, cnt - 1))
                    if req.speculative and denom > 0:
                        self._h_accept.observe((cnt - 1) / denom)
                if req.done:
                    break

    def _emit(self, req: Request, token: int) -> None:
        """Record one generated token; finish/stop bookkeeping."""
        now = time.monotonic()
        if req.t_first_token is None:
            req.t_first_token = now
            self._ttfts.append(req.ttft)
            self._h_ttft.observe(req.ttft)
            if self.slo_ttft_s is not None:
                if req.ttft <= self.slo_ttft_s:
                    self._c_slo_ttft_ok.inc()
                else:
                    self._c_slo_viol.labels("ttft").inc()
            if self.trace is not None:
                self.trace.event(req.id, "first_token", ttft_s=req.ttft)
        else:
            self._itls.append(now - req.t_last_token)
        req.t_last_token = now
        req.output.append(token)
        self._c_tokens.inc()
        if req.on_token is not None:
            req.on_token(req, token)
        hit_stop = req.stop_token >= 0 and token == req.stop_token
        if hit_stop or len(req.output) >= req.max_new_tokens:
            self._finish(req)

    def _finish(self, req: Request, state: str = "finished") -> None:
        self._epoch += 1  # batch membership changes below
        mean_gap = None
        if state == "finished" and len(req.output) > 1 and \
                req.t_first_token is not None:
            mean_gap = ((req.t_last_token - req.t_first_token)
                        / (len(req.output) - 1))
            self._itl_means.append(mean_gap)
            self._h_itl_mean.observe(mean_gap)
        slo_ok = None
        if state == "finished" and (self.slo_ttft_s is not None
                                    or self.slo_itl_s is not None):
            # per-request attainment: a request violates when ANY
            # declared objective is missed (an undelivered first token
            # counts against TTFT — the client never saw one in time)
            viol = False
            if self.slo_ttft_s is not None:
                viol |= req.ttft is None or req.ttft > self.slo_ttft_s
            if self.slo_itl_s is not None and mean_gap is not None:
                if mean_gap <= self.slo_itl_s:
                    self._c_slo_itl_ok.inc()
                else:
                    self._c_slo_viol.labels("itl").inc()
                    viol = True
            slo_ok = not viol
            self._slo_window.append(0.0 if slo_ok else 1.0)
            self._g_slo_burn.set(sum(self._slo_window)
                                 / len(self._slo_window))
        if req.slot is not None:
            # publish the written tokens' full pages before releasing
            # (the latest sampled token's K/V is never written — it
            # would have landed on the NEXT decode step)
            self.alloc.register(req.slot, req.all_tokens[:self._written(req)])
        req.state = state
        req.t_finish = time.monotonic()
        if req in self._prefill_group:  # cancelled mid-chunked-prefill
            self._prefill_group.remove(req)
        if req in self._sp_group:  # cancelled mid-seq-parallel-prefill
            self._sp_group.remove(req)
        if req.slot is not None:
            self.alloc.release(req.slot)
            self.engine.reset_slot(req.slot)
            # mixed carries: plen 0 marks the freed slot decode-phase
            # (a stale cursor then compares >= 0 and never re-enters
            # prefill); readmission reseeds both
            self._plen_host[req.slot] = 0
            self.slots[req.slot] = None
            req.slot = None
        if req in self.running:
            self.running.remove(req)
        if state == "finished":
            self._c_finished.inc()
        if self.trace is not None:
            attrs = {}
            if slo_ok is not None:
                attrs["slo_ok"] = slo_ok
            if mean_gap is not None:
                attrs["itl_mean_s"] = mean_gap
            self.trace.event(req.id, "finish", state=state,
                             tokens=len(req.output),
                             preemptions=req.preemptions,
                             ttft_s=req.ttft, **attrs)
        if req.on_finish is not None:
            req.on_finish(req)

    def _ensure_or_preempt(self, req: Request, need_len: int) -> None:
        """Grow req's pages; under pressure with work in flight, fall
        back to a FULL drain barrier (finishes surfaced there may free
        enough pages — and a victim's pages must never be reclaimed
        while a dispatched block still writes them); only then preempt
        the youngest live request (possibly req itself) until it fits —
        older requests always win page pressure. The victim pool
        includes partially-prefilled gang members: a young mid-prefill
        admission is the cheapest eviction (no generated tokens to
        recompute) and must not be able to starve an older decoding
        request of pages."""
        while True:
            if req.done or req.slot is None:
                return  # a drain barrier below finished/preempted req
            fresh = self.alloc.grow(req.slot, need_len)
            if fresh is not None:
                if fresh:  # push the grown block table to the device
                    self.engine.set_table_row(req.slot,
                                              self.alloc.pages_of(req.slot))
                return
            if self._inflight or self._pending_first:
                self._drain_inflight("page_pressure")
                continue
            # batch-class requests are preferred victims (shed-first
            # priority semantics); within a class the youngest loses —
            # so an old batch job still yields to a young interactive
            # one, but interactive never pays for batch's pages
            victim = max(self.running + self._prefill_group
                         + self._sp_group,
                         key=lambda r: (r.priority == "batch", r.t_arrive))
            self._preempt(victim)
            if victim is req:
                return

    def _written(self, req: Request) -> int:
        """Tokens whose K/V the device has actually written for req's
        slot: everything prefilled, plus decoded tokens except the last
        sampled one (written on the next step, which never ran).

        A running request whose device-sampled FIRST token has not yet
        drained (output still empty, entry in _pending_first) has every
        one of its all_tokens (= the whole prompt) written by prefill —
        the undrained first token is not in all_tokens, so there is no
        trailing unwritten sample to subtract (ADVICE.md r5: the old
        blanket -1 under-registered a full page at page boundaries)."""
        if req.state == "prefilling":
            return req.prefilled
        if not req.output and \
                (req.id, req.preemptions) in self._pending_first_keys:
            return len(req.all_tokens)
        return len(req.all_tokens) - 1

    def _preempt(self, req: Request) -> None:
        """Recompute-style preemption: free pages, requeue at the front.
        With prefix caching the pages stay warm in the registry, so
        readmission's "recompute" is usually a cache hit. The victim may
        be a partially-prefilled gang member (state "prefilling"): its
        prefilled-so-far pages register for reuse like any other and it
        restarts its prompt on readmission."""
        self._epoch += 1  # batch membership changes below
        self._c_preempt.inc()
        if self.flightrec is not None:
            self.flightrec.note("preempt", id=req.id, slot=req.slot,
                                priority=req.priority,
                                generated=len(req.output))
        if self.trace is not None:
            self.trace.event(req.id, "preempt", slot=req.slot,
                             state=req.state,
                             preemptions=req.preemptions + 1,
                             prefilled=req.prefilled,
                             generated=len(req.output))
        # register BEFORE bumping the generation: _written's pending-
        # first-token check matches entries queued under the current one
        self.alloc.register(req.slot, req.all_tokens[:self._written(req)])
        req.preemptions += 1
        self.alloc.release(req.slot)
        self.engine.reset_slot(req.slot)
        self._plen_host[req.slot] = 0  # mixed carries: decode-phase
        self.slots[req.slot] = None
        req.slot = None
        if req in self.running:
            self.running.remove(req)
        elif req in self._prefill_group:
            self._prefill_group.remove(req)
        else:
            self._sp_group.remove(req)
        # all_tokens (prompt + output) are recomputed on readmission
        req.state = "waiting"
        req.prefilled = 0
        req.t_enqueued = time.monotonic()
        self.waiting.appendleft(req)
