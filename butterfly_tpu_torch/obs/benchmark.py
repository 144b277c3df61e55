"""Shared benchmark legs (used by `butterfly bench` and chip_smoke.py).

The port of butterfly_tpu/obs/benchmark.py: the same legs, signatures,
defaults and output keys, run by the port's engines on the card (or on
the CPU when the model was built there).

The decode leg reports raw tokens/sec, tokens/sec/card and a roofline
utilization estimate: decode is memory-bandwidth bound (every step
streams all weights + the KV cache), so

    hbm_util = bytes_streamed_per_step * decode_steps_per_sec / HBM_BW

is the fraction of the cards' memory bandwidth the decode loop sustains,
and mfu the fraction of their dense bf16 peak its matmuls use. Both come
from the datasheet row of the card (`card_figures`); on a card not in the
table, and on the CPU, they are None. Decode time is isolated by
subtracting a max_new=1 run (prefill + first sample) from the full run.

The speculation leg (`run_spec_benchmark`) compares spec on and off and
the draft sources. Weight bytes count what the tree holds: an int8 tree
streams one byte per code plus its scales.

The fleet, autoscale and chaos legs (`run_fleet_benchmark`,
`run_autoscale_benchmark`, `run_chaos_benchmark`) drive an in-process
fleet (fleet/harness.py) of tiny-model replicas on `device` through the
port's loadgen (workload/loadgen.py): they measure the control plane,
not the model.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

#: datasheet figures by card (NVIDIA H100 data sheet, dense rates):
#: (name substring, memory bandwidth bytes/s, peak op/s by type). The
#: first match wins, so the SXM part, named "NVIDIA H100 80GB HBM3",
#: comes last.
CARDS = (
    ("H100 PCIe", 2.0e12, {"bfloat16": 756e12, "float16": 756e12,
                           "float32": 51e12, "int8": 1513e12}),
    ("H100 NVL", 3.9e12, {"bfloat16": 835e12, "float16": 835e12,
                          "float32": 60e12, "int8": 1671e12}),
    ("H100", 3.35e12, {"bfloat16": 989e12, "float16": 989e12,
                       "float32": 67e12, "int8": 1979e12}),
)


def card_figures(name: Optional[str]) -> Optional[Tuple[float, Dict]]:
    """(memory bandwidth, peaks by type) of the card called `name`
    (torch.cuda.get_device_name), or None for a card not in CARDS."""
    for part, bw, peaks in CARDS:
        if name and part in name:
            return bw, peaks
    return None


def _figures(device) -> Optional[Tuple[float, Dict]]:
    """The datasheet row of `device`'s card; None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return card_figures(torch.cuda.get_device_name(device))


def _sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU, where the
    ops have run when they return)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def run_decode_benchmark(model, params, batch: int, prompt_len: int,
                         max_new: int, seed: int = 0,
                         mesh=None, kv_quant: str = "none") -> Dict:
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.models.common import torch_dtype

    engine = InferenceEngine(
        model, params, RuntimeConfig(max_seq_len=prompt_len + max_new,
                                     kv_quant=kv_quant),
        mesh=mesh)
    rng = np.random.RandomState(seed)
    prompts = rng.randint(1, model.cfg.vocab_size,
                          (batch, prompt_len)).tolist()
    sp = SamplingParams(max_new_tokens=max_new)
    sp1 = SamplingParams(max_new_tokens=1)
    dev = engine.device

    engine.generate(prompts, sp1)   # first use: kernel builds, buffers
    engine.generate(prompts, sp)
    _sync(dev)

    t0 = time.perf_counter()
    engine.generate(prompts, sp1)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    engine.generate(prompts, sp)
    _sync(dev)
    dt = time.perf_counter() - t0

    decode_steps = max_new - 1      # steps taken by the fused loop
    decode_dt = max(dt - t_prefill, 1e-9)
    steps_per_sec = decode_steps / decode_dt

    # Roofline accounting: every decode step streams the full weight tree
    # and reads the whole KV cache buffer (k + v). An unmeshed engine runs
    # on exactly one card; a meshed engine uses every mesh device and
    # streams one weight copy per data-parallel replica.
    cfg = model.cfg
    leaves = list(_leaves(engine.params))
    # the tree as it streams: int8 codes at 1 byte each plus their scales
    param_bytes = sum(x.nbytes for x in leaves)
    param_count = sum(x.numel() for x in leaves)
    S = prompt_len + max_new
    # bytes per stored K/V vector: head_dim * itemsize, +4 for the f32
    # per-vector scale in int8 mode
    vec_bytes = cfg.head_dim * (1 if kv_quant == "int8"
                                else torch_dtype(cfg.dtype).itemsize) \
        + (4 if kv_quant == "int8" else 0)
    kv_bytes = 2 * cfg.num_layers * batch * S * cfg.num_kv_heads * vec_bytes
    n_chips = mesh.devices.size if mesh is not None else 1
    dp = mesh.shape.get("data", 1) if mesh is not None else 1
    bytes_per_step = param_bytes * dp + kv_bytes
    fig = _figures(dev)
    hbm_util = mfu = None
    if fig is not None:
        bw, peaks = fig
        hbm_util = bytes_per_step * steps_per_sec / (bw * n_chips)
        # Decode matmul FLOPs ~= 2 * weight params * batch per step.
        mfu = (2 * param_count * batch * steps_per_sec
               / (peaks["bfloat16"] * n_chips))

    total = batch * max_new
    return {
        "tokens_per_sec": total / dt,
        "tokens_per_sec_per_chip": total / dt / n_chips,
        "decode_tokens_per_sec": batch * steps_per_sec,
        "decode_tokens_per_sec_per_chip": batch * steps_per_sec / n_chips,
        "hbm_util": hbm_util,
        "mfu": mfu,
        "decode_seconds": decode_dt,
        "prefill_seconds": t_prefill,
        "batch": batch,
        "prompt_len": prompt_len,
        "new_tokens": max_new,
        "n_chips": n_chips,
    }


def run_serving_benchmark(model, params, *, n_requests: int = 64,
                          prompt_len: int = 128, max_new: int = 128,
                          max_batch: int = 32, utilization: float = 0.75,
                          kv_quant: str = "int8",
                          decode_steps_per_tick: int = 1,
                          prefill_max_batch: Optional[int] = None,
                          inflight_blocks: int = 2,
                          kv_write_combine: bool = True,
                          prefill_flash_warm: bool = True,
                          mixed_dispatch: bool = True,
                          isolated_decode_tok_s_chip: Optional[float] = None,
                          seed: int = 0) -> Dict:
    """Benchmark the PRODUCT serving path: Scheduler + ServingEngine with
    the paged pool (int8 codes by default) and the paged-attention
    kernel, under staggered arrivals.

    Two phases: (1) a saturated all-at-once backlog measures peak
    sustained serving throughput; (2) staggered arrivals at
    `utilization` x that measured capacity give TTFT/ITL percentiles
    under a stable queue. When the caller supplies the isolated-decode
    number, `serving_gap` = serving / isolated tok/s/card rides the
    JSON. `inflight_blocks` sets the dispatch-ahead depth;
    device_bubble_p50/p95 ride along when observed. With mixed_dispatch
    the same phase-2 trace also runs on the alternating path (`_alt`
    keys).
    """
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.obs.timeseries import (SignalRecorder,
                                                    series_summary)
    from butterfly_tpu_torch.sched.scheduler import Scheduler

    rt = RuntimeConfig(max_batch_size=max_batch,
                       max_seq_len=prompt_len + max_new + 16,
                       kv_quant=kv_quant,
                       decode_steps_per_tick=decode_steps_per_tick,
                       inflight_blocks=inflight_blocks,
                       kv_write_combine=kv_write_combine,
                       prefill_flash_warm=prefill_flash_warm,
                       mixed_dispatch=mixed_dispatch)
    if prefill_max_batch is not None:
        rt = rt.replace(prefill_max_batch=prefill_max_batch)
    engine = ServingEngine(model, params, rt)
    rng = np.random.RandomState(seed)
    V = model.cfg.vocab_size

    def prompt():
        return rng.randint(1, V, (prompt_len,)).tolist()

    # warmup: first-use costs (kernel builds, pool and buffer growth) off
    # the clock. One burst per power-of-two gang width up to
    # prefill_max_batch, so every batched-prefill shape the measured
    # phases can hit has run once before them
    warm = Scheduler(engine)
    cap = max(1, min(rt.prefill_max_batch, max_batch))
    widths, w = [], 1
    while w < cap:
        widths.append(w)
        w *= 2
    widths.append(cap)
    for w in widths:
        for _ in range(w):
            warm.submit(prompt(), max_new_tokens=4)
        warm.run_until_done()
    # Phase 1 — MEASURED saturated capacity: submit a standing backlog
    # all at once and time the drain; median of three drains. The
    # whole-run average includes the admission ramp and drain tail, so
    # it slightly understates peak throughput, which keeps phase 2's
    # offered rate below capacity.
    caps = []
    for _ in range(3):
        sat = Scheduler(engine)
        sat_reqs = [sat.submit(prompt(), max_new_tokens=max_new)
                    for _ in range(int(1.5 * max_batch))]
        t_start = time.monotonic()
        sat.run_until_done(max_ticks=10 ** 6)
        caps.append(sat.metrics()["tokens_generated_total"]
                    / (time.monotonic() - t_start))
        # explicit raise, not assert: under `python -O` a stripped assert
        # would let a silently-incomplete run report bogus throughput
        unfinished = [r.id for r in sat_reqs if r.state != "finished"]
        if unfinished:
            raise RuntimeError(
                f"serving benchmark phase 1 left requests unfinished "
                f"(ids {unfinished[:8]}): throughput would be bogus")
    capacity = float(np.median(caps))

    # Phase 2 — staggered arrivals at utilization * measured capacity.
    # One pre-generated prompt list drives BOTH legs (this run and the
    # alternating `_alt` reference at the end).
    interarrival = max_new / (utilization * capacity)
    p2_prompts = [prompt() for _ in range(n_requests)]

    def _drive_staggered(sched_):
        reqs_ = []
        t0 = time.monotonic()
        nxt = t0
        j = 0
        while j < n_requests or sched_.has_work:
            while j < n_requests and time.monotonic() >= nxt:
                reqs_.append(sched_.submit(p2_prompts[j],
                                           max_new_tokens=max_new))
                nxt += interarrival
                j += 1
            if sched_.has_work:
                sched_.tick()
            elif j < n_requests:
                time.sleep(min(0.002, max(0.0, nxt - time.monotonic())))
        return reqs_, time.monotonic() - t0

    # fast cadence: bench phases last seconds, not minutes
    rec = SignalRecorder(interval_s=0.05, capacity=4096)
    sched = Scheduler(engine, timeseries=rec)
    reqs, wall = _drive_staggered(sched)

    m = sched.metrics()
    unfinished = [r.id for r in reqs if r.state != "finished"]
    if unfinished:
        raise RuntimeError(
            f"serving benchmark phase 2 left requests unfinished "
            f"(ids {unfinished[:8]}): TTFT/ITL percentiles would be bogus")
    out = {
        "serving_tokens_per_sec_per_chip": m["tokens_generated_total"] / wall,
        # MEASURED saturated throughput (phase-1 standing backlog)
        "serving_capacity_tokens_per_sec": capacity,
        "serving_requests": n_requests,
        "serving_prompt_len": prompt_len,
        "serving_max_new": max_new,
        "serving_max_batch": max_batch,
        "serving_prefill_max_batch": rt.prefill_max_batch,
        "serving_inflight_blocks": rt.inflight_blocks,
        "serving_offered_utilization": utilization,
        "serving_kv_quant": kv_quant,
        "serving_kv_write_combine": kv_write_combine,
        "serving_mixed_dispatch": mixed_dispatch,
        "serving_preemptions": m["preemptions_total"],
    }
    # the admission barrier count (~0 under mixed dispatch, one per
    # mid-flight arrival on the alternating path) and the prompt tokens
    # that rode fused blocks
    out["serving_admission_barriers"] = \
        sched.barrier_causes().get("admission", 0.0)
    if "mixed_dispatch_prefill_tokens_inline" in m:
        out["mixed_dispatch_prefill_tokens_inline"] = \
            m["mixed_dispatch_prefill_tokens_inline"]
    # write-combined window flush cost + volume (absent window-off)
    for k in ("kv_flush_p50", "kv_flush_p95",
              "kv_window_tokens_flushed_total"):
        if k in m:
            out[k] = m[k]
    # device idle per dispatched decode block (phase-2 window)
    for k in ("device_bubble_p50", "device_bubble_p95"):
        if k in m:
            out[k] = m[k]
    # prompt-token throughput of the admission path (phase-2 wall);
    # prefix-cache hits excluded, the histogram only sees tokens run
    h_prefill = sched.registry.get("prefill_tokens")
    if h_prefill is not None:
        out["prefill_tokens_per_sec"] = h_prefill.sum / wall
    # tick anatomy over the phase-2 window, the host/device wall split
    # and the per-cause barrier breakdown
    for k in ("tick_phase_drain_p50", "tick_phase_drain_p95",
              "tick_phase_admit_p50", "tick_phase_admit_p95",
              "tick_phase_assemble_p50", "tick_phase_assemble_p95",
              "tick_phase_dispatch_p50", "tick_phase_dispatch_p95",
              "tick_phase_mixed_p50", "tick_phase_mixed_p95",
              "tick_host_frac", "tick_device_frac"):
        if k in m:
            out[k] = m[k]
    out["drain_barriers_by_cause"] = {
        c: v for c, v in sched.barrier_causes().items() if v}
    if isolated_decode_tok_s_chip:
        # serving / isolated-decode tok/s/card: 1.0 = the serving stack
        # adds zero overhead over a bare fused decode loop
        out["serving_gap"] = (out["serving_tokens_per_sec_per_chip"]
                              / isolated_decode_tok_s_chip)
    # itl_req_mean_* are the primary ITL keys (per-finished-request mean
    # gap); the raw-gap percentiles ride along under _tick_burst
    for k in ("ttft_p50", "ttft_p95",
              "itl_req_mean_p50", "itl_req_mean_p95",
              "itl_p50_tick_burst", "itl_p95_tick_burst"):
        if k in m:
            out[k] = m[k]
    # downsampled signal-history summary over the phase-2 window
    out["serving_series_summary"] = series_summary(rec.dump())
    # Alternating-path reference (`_alt` suffix): the SAME phase-2
    # prompts and offered rate with mixed_dispatch off, i.e. dedicated
    # prefill dispatches (the flash kernels) plus the admission drain
    # barrier per mid-flight arrival
    if mixed_dispatch:
        alt_engine = ServingEngine(model, params,
                                   rt.replace(mixed_dispatch=False))
        warm_alt = Scheduler(alt_engine)
        for w in widths:
            for _ in range(w):
                warm_alt.submit(prompt(), max_new_tokens=4)
            warm_alt.run_until_done()
        alt = Scheduler(alt_engine)
        alt_reqs, alt_wall = _drive_staggered(alt)
        am = alt.metrics()
        if not [r for r in alt_reqs if r.state != "finished"]:
            out["serving_tokens_per_sec_per_chip_alt"] = \
                am["tokens_generated_total"] / alt_wall
            for k in ("ttft_p50", "ttft_p95",
                      "itl_req_mean_p50", "itl_req_mean_p95"):
                if k in am:
                    out[k + "_alt"] = am[k]
            out["serving_admission_barriers_alt"] = \
                alt.barrier_causes().get("admission", 0.0)
    return out


def run_warm_prefill_benchmark(model, params, *, n_requests: int = 6,
                               prompt_len: int = 640,
                               prefill_chunk: int = 256,
                               max_new: int = 2, max_batch: int = 4,
                               page_size: int = 16, kv_quant: str = "none",
                               use_kernels: Optional[bool] = None,
                               repeats: int = 5, seed: int = 0) -> Dict:
    """Warm chunked-prefill phase: long prompts whose prefill spans
    several `prefill_chunk`-sized chunks, so every chunk after the first
    runs the WARM path and admission rounds mix warm continuations with
    fresh arrivals. Two legs at the same operating point:

    * ON (`prefill_flash_warm`, the default): with kernels on (the card)
      the warm program attends through the warm flash kernel (cached
      prefix + fresh chunk), and mixed gangs ride one dispatch.
    * OFF (`_dense` suffix): dense warm attention over the gathered pool
      view, and gangs split by freshness.

    `warm_prefill_kernelized` says whether the on leg took the kernel
    (False on the CPU, where the plain versions run). TTFT medians are
    over `repeats` backlog drains after one warmup drain.
    """
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.sched.scheduler import Scheduler

    rng = np.random.RandomState(seed)
    V = model.cfg.vocab_size
    prompts = [rng.randint(1, V, (prompt_len,)).tolist()
               for _ in range(n_requests)]
    out: Dict = {
        "warm_prefill_prompt_len": prompt_len,
        "warm_prefill_chunk": prefill_chunk,
        "warm_prefill_requests": n_requests,
        "warm_prefill_kv_quant": kv_quant,
    }
    for flag, suffix in ((True, ""), (False, "_dense")):
        rt = RuntimeConfig(max_batch_size=max_batch,
                           max_seq_len=prompt_len + max_new + 16,
                           page_size=page_size, kv_quant=kv_quant,
                           prefill_chunk=prefill_chunk,
                           prefill_max_batch=max_batch,
                           prefill_flash_warm=flag)
        engine = ServingEngine(model, params, rt, use_kernels=use_kernels)
        if flag:
            out["warm_prefill_kernelized"] = engine.warm_prefill_flash
        ttft50, ttft95, walls = [], [], []
        for rep in range(repeats + 1):
            sched = Scheduler(engine)
            reqs = [sched.submit(p, max_new_tokens=max_new)
                    for p in prompts]
            t0 = time.monotonic()
            sched.run_until_done(max_ticks=10 ** 6)
            dt = time.monotonic() - t0
            unfinished = [r.id for r in reqs if r.state != "finished"]
            if unfinished:
                raise RuntimeError(
                    f"warm-prefill benchmark left requests unfinished "
                    f"(ids {unfinished[:8]})")
            if rep == 0:
                continue  # warmup drain, off the clock
            m = sched.metrics()
            ttft50.append(m["ttft_p50"])
            ttft95.append(m["ttft_p95"])
            walls.append(dt)
        total_prompt_tokens = n_requests * prompt_len
        out["warm_prefill_ttft_p50" + suffix] = float(np.median(ttft50))
        out["warm_prefill_ttft_p95" + suffix] = float(np.median(ttft95))
        out["warm_prefill_tokens_per_sec" + suffix] = \
            total_prompt_tokens / float(np.median(walls))
    return out


def run_longctx_benchmark(model, params, *, prompt_len: int = 256,
                          prefill_chunk: int = 16, max_new: int = 8,
                          n_decoders: int = 3, decode_prompt_len: int = 16,
                          decode_new: int = 24, page_size: int = 16,
                          kv_quant: str = "none", repeats: int = 3,
                          seed: int = 0) -> Dict:
    """Long-context serving phase: one prompt spanning many
    `prefill_chunk`s (>= 8x) admitted through the scheduler's
    seq-parallel lane, measured two ways:

    * **alone vs mixed ITL**: `n_decoders` short decode requests drained
      with and without the long prefill running beside them; the
      declared bound is mixed ITL p95 <= alone p95 + 1.5x one SP chunk's
      wall time (`longctx_itl_budget_s`, `longctx_itl_within_budget`).
    * **ring microbench pair**: the block-stats leg production runs (the
      ring kernel on the card, the plain version on the CPU) against the
      plain PyTorch version `ring_block_stats_ref`, same f32 shape: one
      chunk's worth of queries against the whole prompt's keys at the
      model's heads. The keys keep the JAX package's names:
      `longctx_ring_block_ms` and `longctx_ring_block_ms_jnp` (here the
      plain PyTorch version); `longctx_ring_kernelized` is true iff the
      kernel ran (the model lives on a card).

    The serving lane needs a seq axis: it builds seq = 4 x data =
    (cards / 4) when the card count allows, else reports
    `longctx_supported: false` and returns only the microbench pair.
    """
    from butterfly_tpu_torch.core.config import MeshConfig, RuntimeConfig
    from butterfly_tpu_torch.core.mesh import make_mesh
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.ops.ring_attention import (block_stats,
                                                        ring_block_stats_ref)
    from butterfly_tpu_torch.sched.scheduler import Scheduler

    cfg = model.cfg
    dev = model.device
    out: Dict = {
        "longctx_prompt_len": prompt_len,
        "longctx_prefill_chunk": prefill_chunk,
        "longctx_kv_quant": kv_quant,
    }

    # -- ring microbench pair (mesh-free): one chunk's worth of queries
    # against the full prompt's keys, the ring block's production shape
    kernelized = dev.type == "cuda"
    out["longctx_ring_kernelized"] = kernelized
    rng = np.random.RandomState(seed)
    Nq, Kv, H = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    T, S = max(8, prefill_chunk), prompt_len

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32, device=dev)

    q, k, v = randn(1, T, Nq, H), randn(1, S, Kv, H), randn(1, S, Kv, H)
    q_pos = torch.arange(S - T, S, dtype=torch.int32, device=dev)[None]
    k_pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
    for fn, suffix in ((block_stats, ""), (ring_block_stats_ref, "_jnp")):
        fn(q, k, v, q_pos, k_pos)   # first use (the kernel's build)
        _sync(dev)
        ts = []
        for _ in range(max(3, repeats)):
            t0 = time.perf_counter()
            fn(q, k, v, q_pos, k_pos)
            _sync(dev)
            ts.append(time.perf_counter() - t0)
        out["longctx_ring_block_ms" + suffix] = float(np.median(ts)) * 1e3

    # -- the serving lane needs a seq axis
    n_dev = torch.cuda.device_count() if kernelized else 0
    if n_dev < 4 or n_dev % 4:
        out["longctx_supported"] = False
        return out
    mesh = make_mesh(MeshConfig(seq=4, data=n_dev // 4),
                     [f"cuda:{i}" for i in range(n_dev)])
    rt = RuntimeConfig(max_batch_size=1 + n_decoders,
                       max_seq_len=prompt_len + max_new + 16,
                       page_size=page_size, kv_quant=kv_quant,
                       prefill_chunk=prefill_chunk,
                       seq_parallel_threshold=prompt_len // 2)
    engine = ServingEngine(model, params, rt, mesh=mesh)
    if not engine.supports_seq_parallel:
        out["longctx_supported"] = False
        return out
    out["longctx_supported"] = True
    V = cfg.vocab_size
    long_prompt = rng.randint(1, V, (prompt_len,)).tolist()
    dec_prompts = [rng.randint(1, V, (decode_prompt_len,)).tolist()
                   for _ in range(n_decoders)]

    def drain(with_long):
        sched = Scheduler(engine)
        lr = sched.submit(list(long_prompt), max_new_tokens=max_new,
                          temperature=0.0) if with_long else None
        drs = [sched.submit(list(p), max_new_tokens=decode_new)
               for p in dec_prompts]
        sched.run_until_done(max_ticks=10 ** 6)
        bad = [r.id for r in drs + ([lr] if lr else [])
               if r.state != "finished"]
        if bad:
            raise RuntimeError(
                f"longctx benchmark left requests unfinished ({bad[:8]})")
        return sched, lr

    drain(False)                       # first use: decoder-only widths
    warm, _ = drain(True)              # first use: SP chunk + mixed widths
    sp_chunk = warm._sp_chunk
    out["longctx_sp_chunk"] = sp_chunk

    itl_alone, itl_mixed, ttfts, sp_toks = [], [], [], 0
    for _ in range(repeats):
        s, _ = drain(False)
        itl_alone.append(s.metrics().get("itl_req_mean_p95", 0.0))
        s, lr = drain(True)
        itl_mixed.append(s.metrics().get("itl_req_mean_p95", 0.0))
        ttfts.append(lr.ttft)
        sp_toks += s._c_sp_tokens.value
    out["longctx_sp_prefill_tokens"] = sp_toks
    ttft50 = float(np.percentile(ttfts, 50))
    out["longctx_ttft_p50"] = ttft50
    out["longctx_ttft_p95"] = float(np.percentile(ttfts, 95))
    out["longctx_prefill_tokens_per_sec"] = prompt_len / max(ttft50, 1e-9)
    alone = float(np.median(itl_alone))
    mixed = float(np.median(itl_mixed))
    out["longctx_itl_p95_alone"] = alone
    out["longctx_mixed_itl_p95"] = mixed
    # declared bound: one SP chunk dispatch rides each tick's admit
    # phase, so a decode gap may grow by at most ~one chunk's wall time
    sp_chunk_s = ttft50 / max(1, -(-prompt_len // sp_chunk))
    budget = alone + 1.5 * sp_chunk_s
    out["longctx_itl_budget_s"] = budget
    out["longctx_itl_within_budget"] = bool(mixed <= budget)
    return out


def run_mixed_benchmark(model, params, *, n_requests: int = 32,
                        max_batch: int = 8,
                        prompt_lo: int = 32, prompt_hi: int = 256,
                        max_new_lo: int = 8, max_new_hi: int = 64,
                        page_size: int = 16,
                        pool_fraction: float = 0.4,
                        decode_steps_per_tick: int = 4,
                        inflight_blocks: int = 2,
                        grid=None, kv_quant: str = "none",
                        prefill_max_batch: Optional[int] = None,
                        prefill_flash_warm: bool = True,
                        slo_ttft_ms: Optional[float] = 1000.0,
                        deadline_ms: Optional[float] = 30000.0,
                        arrival: Optional[str] = None,
                        host_kv_tier_mb: float = 0.0,
                        mixed_dispatch: bool = True,
                        seed: int = 0,
                        max_seconds: float = 900.0) -> Dict:
    """Mixed-workload serving phase: the canned `mixed_chat` population
    (heterogeneous prompt/decode lengths, shared-prefix cohorts,
    priority/deadline mix) fired OPEN-LOOP in bursts sized to overrun a
    deliberately under-provisioned page pool — the regime where chunked
    prefill, preemption, the prefix cache (on here), the host KV tier
    (with `host_kv_tier_mb`) and the admission machinery actually run.

    Two sub-phases on ONE engine:

    1. **Mixed phase** at the round's operating point
       (`decode_steps_per_tick` x `inflight_blocks`): open-loop burst
       arrivals through the admission surface (shed_decision + deadline
       budgets), with the pool at `pool_fraction` of worst-case demand
       so bursts force `serving_preemptions > 0`.
    2. **Operating-point sweep**: the SAME trace across a
       `decode_steps_per_tick x inflight_blocks` grid (>= 2x2),
       emitting the latency/throughput table + knee (workload/sweep.py).

    With mixed_dispatch the same trace also runs on the alternating path
    (`_alt` keys: the flash kernels' prefills, warm on prefix hits).
    """
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.obs.timeseries import (SignalRecorder,
                                                    series_summary)
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    from butterfly_tpu_torch.workload.arrivals import (assign_arrivals,
                                                       parse_arrival)
    from butterfly_tpu_torch.workload.models import mixed_chat
    from butterfly_tpu_torch.workload.sweep import (drive_open_loop,
                                                    sweep_operating_points)

    wl = mixed_chat(page_size=page_size, vocab=model.cfg.vocab_size,
                    prompt_lo=prompt_lo, prompt_hi=prompt_hi,
                    max_new_lo=max_new_lo, max_new_hi=max_new_hi,
                    deadline_ms=deadline_ms)
    max_seq = wl.max_prompt_len + wl.max_new_hi + 16
    pages_per_seq = -(-max_seq // page_size)
    # pool sized BELOW worst-case concurrent demand: bursts must be
    # able to overrun it (preemption is the property under
    # measurement), while any single request still fits
    num_pages = max(pages_per_seq + 2,
                    int(pool_fraction * max_batch * pages_per_seq))
    if arrival is None:
        # bursts at an offered rate far above any service rate
        # (n_requests*2/s for ~0.25s ON phases): instantaneous queue
        # growth + page-pool overrun on every platform
        arrival = f"burst:{max(8, 2 * n_requests)}:0.25:0.75"
    specs = wl.sample(n_requests, seed)
    assign_arrivals(specs, parse_arrival(arrival), seed)
    base_rt = RuntimeConfig(max_batch_size=max_batch, max_seq_len=max_seq,
                            page_size=page_size, num_pages=num_pages,
                            kv_quant=kv_quant,
                            decode_steps_per_tick=decode_steps_per_tick,
                            inflight_blocks=inflight_blocks,
                            prefix_caching=True,
                            host_kv_tier_mb=host_kv_tier_mb,
                            prefill_flash_warm=prefill_flash_warm,
                            mixed_dispatch=mixed_dispatch)
    if prefill_max_batch is not None:
        base_rt = base_rt.replace(prefill_max_batch=prefill_max_batch)
    engine = ServingEngine(model, params, base_rt)

    # warm the round's operating point off the clock (the sweep warms
    # its own grid points per distinct block width)
    warm = Scheduler(engine)
    for s in specs:
        if len(s.tokens) + 1 <= engine.cache.max_seq:
            warm.submit(s.tokens, max_new_tokens=2)
    warm.run_until_done(max_ticks=10 ** 6)

    slo_ttft_s = slo_ttft_ms / 1e3 if slo_ttft_ms else None
    rec = SignalRecorder(interval_s=0.05, capacity=4096)
    sched = Scheduler(engine, slo_ttft_s=slo_ttft_s, timeseries=rec)
    res = drive_open_loop(sched, specs, max_seconds=max_seconds)

    sweep_grid = grid
    if sweep_grid is None:
        ks = sorted({1, decode_steps_per_tick})
        if len(ks) == 1:
            ks = [decode_steps_per_tick, 2 * decode_steps_per_tick]
        sweep_grid = [(k, i) for k in ks[:2] for i in (1, 2)]
    sw = sweep_operating_points(engine, base_rt, specs, sweep_grid,
                                slo_ttft_s=slo_ttft_s,
                                max_seconds=max_seconds)

    def r(v):
        return round(v, 4) if isinstance(v, float) else v

    out = {
        "mixed_workload": wl.name,
        "mixed_arrival": arrival,
        "mixed_requests": n_requests,
        "mixed_max_batch": max_batch,
        "mixed_kv_quant": kv_quant,
        "mixed_num_pages": num_pages,
        "mixed_pool_fraction": r(pool_fraction),
        "mixed_prompt_range": [prompt_lo, prompt_hi],
        "mixed_max_new_range": [max_new_lo, max_new_hi],
        "mixed_slo_ttft_ms": slo_ttft_ms,
        "mixed_ok": res["ok"],
        "mixed_admitted": res["admitted"],
        "mixed_serving_tokens_per_sec": r(res["tokens_per_sec"]),
        # > 0 means the page pool was actually contested
        "mixed_serving_preemptions": res["preemptions"],
        "mixed_shed_total": res["shed_total"],
        "mixed_deadline_expired_total": res["deadline_expired_total"],
    }
    for k in ("ttft_p50", "ttft_p95", "itl_req_mean_p50",
              "itl_req_mean_p95", "prefix_cache_hit_tokens"):
        if k in res:
            out["mixed_" + k] = r(res[k])
    # tick anatomy under the contested workload
    mm = sched.metrics()
    for k in ("tick_phase_drain_p50", "tick_phase_drain_p95",
              "tick_phase_admit_p50", "tick_phase_admit_p95",
              "tick_phase_assemble_p50", "tick_phase_assemble_p95",
              "tick_phase_dispatch_p50", "tick_phase_dispatch_p95",
              "tick_phase_mixed_p50", "tick_phase_mixed_p95",
              "tick_host_frac", "tick_device_frac"):
        if k in mm:
            out["mixed_" + k] = r(mm[k])
    out["mixed_drain_barriers_by_cause"] = {
        c: v for c, v in sched.barrier_causes().items() if v}
    out["mixed_admission_barriers"] = \
        sched.barrier_causes().get("admission", 0.0)
    if "mixed_dispatch_prefill_tokens_inline" in mm:
        out["mixed_dispatch_prefill_tokens_inline"] = \
            r(mm["mixed_dispatch_prefill_tokens_inline"])
    # host KV tier: under the starved pool, evictions demote to host RAM
    # and prefix hits revive
    if host_kv_tier_mb > 0:
        out["mixed_host_kv_tier_mb"] = host_kv_tier_mb
        for k in ("kv_tier_hit_rate", "kv_tier_pages_saved_total",
                  "kv_tier_pages_restored_total", "kv_tier_misses_total",
                  "kv_tier_spills_total", "kv_tier_restore_seconds_p50",
                  "kv_tier_restore_seconds_p95"):
            if k in mm:
                out[k] = r(mm[k])
    out["mixed_series_summary"] = series_summary(rec.dump())
    # Alternating-path reference (`_alt` suffix): the SAME trace and
    # operating point with mixed_dispatch off
    if mixed_dispatch:
        alt_engine = ServingEngine(model, params,
                                   base_rt.replace(mixed_dispatch=False))
        warm_a = Scheduler(alt_engine)
        for s in specs:
            if len(s.tokens) + 1 <= alt_engine.cache.max_seq:
                warm_a.submit(s.tokens, max_new_tokens=2)
        warm_a.run_until_done(max_ticks=10 ** 6)
        alt = Scheduler(alt_engine, slo_ttft_s=slo_ttft_s)
        res_a = drive_open_loop(alt, specs, max_seconds=max_seconds)
        out["mixed_serving_tokens_per_sec_alt"] = r(res_a["tokens_per_sec"])
        for k in ("ttft_p50", "ttft_p95",
                  "itl_req_mean_p50", "itl_req_mean_p95"):
            if k in res_a:
                out["mixed_" + k + "_alt"] = r(res_a[k])
        out["mixed_admission_barriers_alt"] = \
            alt.barrier_causes().get("admission", 0.0)
    out["operating_points"] = sw["points"]
    out["operating_point_knee"] = (
        {k: r(v) for k, v in sw["knee"].items()} if sw["knee"] else None)
    return out


def draft_friendly_prompts(sched, n_requests: int, prompt_len: int,
                           seed: int = 0):
    """The spec leg's prompts: max(4, prompt_len // 4) random tokens each
    (from `seed`), followed by the model's OWN greedy continuation up to
    prompt_len, harvested with `sched` (a spec-off scheduler), so the
    prompts carry the looping structure prompt lookup mines."""
    rng = np.random.RandomState(seed)
    V = sched.engine.cfg.vocab_size
    seed_len = max(4, prompt_len // 4)
    bases = [rng.randint(1, V, (seed_len,)).tolist()
             for _ in range(n_requests)]
    cont = [sched.submit(b, max_new_tokens=prompt_len - seed_len)
            for b in bases]
    sched.run_until_done(max_ticks=10 ** 6)
    return [b + r.output for b, r in zip(bases, cont)]


def run_spec_benchmark(model, params, *, n_requests: int = 8,
                       prompt_len: int = 32, max_new: int = 64,
                       max_batch: int = 4, gamma: int = 4, ngram: int = 2,
                       decode_steps_per_tick: int = 4,
                       inflight_blocks: int = 2,
                       kv_quant: str = "none", seed: int = 0,
                       draft_layers: int = 1) -> Dict:
    """Speculation leg of the serving bench: spec-on against spec-off
    tokens/sec at the SAME operating point, with the speculation
    instruments (spec_tokens_per_forward, spec_accept_rate) and the
    drain barriers per verify round.

    The on/off prompts are draft-friendly: each is seeded with the
    model's OWN greedy continuation (measured once up front), so prompt
    lookup has something to find; greedy, at `max_batch` slots. A second
    part drafts with "ngram" and with the on-device draft model ("model",
    the first `draft_layers` layers) on mixed_chat prompts, recording
    spec_accept_rate_{src}, spec_tokens_per_forward_{src} and
    serving_spec_{src}_tokens_per_sec; a third row ("tree") reruns the
    model draft as a width-2 token tree at the same node budget
    (spec_tree_nodes = gamma + 1), when gamma is even."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    from butterfly_tpu_torch.workload.models import mixed_chat

    V = model.cfg.vocab_size
    max_seq = prompt_len + 2 * max_new + 16

    def build(rt):
        return Scheduler(ServingEngine(model, params, rt))

    def drive(rt, prompts, label):
        sched = build(rt)
        # warm off the clock (first kernel use, buffers)
        for p in prompts[:min(len(prompts), max_batch)]:
            sched.submit(p, max_new_tokens=4)
        sched.run_until_done(max_ticks=10 ** 6)
        reqs = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
        t0 = time.monotonic()
        sched.run_until_done(max_ticks=10 ** 6)
        wall = time.monotonic() - t0
        unfinished = [r.id for r in reqs if r.state != "finished"]
        if unfinished:
            raise RuntimeError(
                f"spec benchmark ({label}) left requests unfinished "
                f"(ids {unfinished[:8]})")
        return sched.metrics(), wall

    rt_off = RuntimeConfig(max_batch_size=max_batch, max_seq_len=max_seq,
                           kv_quant=kv_quant,
                           decode_steps_per_tick=decode_steps_per_tick,
                           inflight_blocks=inflight_blocks)
    rt_on = rt_off.replace(speculative_gamma=gamma, speculative_ngram=ngram)

    prompts = draft_friendly_prompts(build(rt_off), n_requests, prompt_len,
                                     seed)
    m_off, wall_off = drive(rt_off, prompts, "off")
    m_on, wall_on = drive(rt_on, prompts, "on")
    out = {
        "serving_spec_gamma": gamma,
        "serving_spec_tokens_per_sec": m_on["tokens_generated_total"]
        / wall_on,
        "serving_spec_off_tokens_per_sec": m_off["tokens_generated_total"]
        / wall_off,
        "spec_tokens_per_forward": m_on.get("spec_tokens_per_forward", 0.0),
        "spec_accept_rate": m_on.get("spec_accept_rate", 0.0),
        "spec_forwards_total": m_on["spec_forwards_total"],
        "spec_drafts_accepted_total": m_on["spec_drafts_accepted_total"],
        "spec_drain_barriers_per_forward":
            m_on["drain_barriers_total"]
            / max(1.0, m_on["spec_forwards_total"]),
    }
    out["serving_spec_speedup"] = (out["serving_spec_tokens_per_sec"]
                                   / out["serving_spec_off_tokens_per_sec"]
                                   if out["serving_spec_off_tokens_per_sec"]
                                   else 0.0)

    # draft sources on mixed_chat prompts (template + fresh tails: the
    # shape where prompt lookup earns little), same operating point
    p_hi = max(16, prompt_len)
    wl = mixed_chat(page_size=rt_off.page_size, vocab=V,
                    prompt_lo=max(8, p_hi // 4), prompt_hi=p_hi,
                    max_new_lo=max(8, max_new // 4), max_new_hi=max_new)
    mixed_prompts = [s.tokens for s in wl.sample(n_requests, seed)]
    out["serving_spec_draft_layers"] = draft_layers
    rows = [("ngram", {}),
            ("model", {"draft_model": "model",
                       "draft_layers": draft_layers})]
    if gamma % 2 == 0:  # width 2 needs (N - 1) = gamma divisible by 2
        rows.append(("tree", {"draft_model": "model",
                              "draft_layers": draft_layers,
                              "spec_tree_width": 2,
                              "spec_tree_nodes": gamma + 1}))
    for src, extra in rows:
        m, wall = drive(rt_on.replace(**extra), mixed_prompts, src)
        out[f"spec_accept_rate_{src}"] = m.get("spec_accept_rate", 0.0)
        out[f"spec_tokens_per_forward_{src}"] = \
            m.get("spec_tokens_per_forward", 0.0)
        out[f"serving_spec_{src}_tokens_per_sec"] = \
            m["tokens_generated_total"] / wall
    return out


def run_fleet_benchmark(topology: str = "2p2d", *, clients: int = 3,
                        requests_per_client: int = 4,
                        prompt_len: int = 48, max_tokens: int = 8,
                        page_size: int = 8, max_batch: int = 2,
                        disagg_threshold: int = 16,
                        prefix_share: float = 0.5,
                        slo_ttft_ms: float = 2000.0,
                        slo_itl_ms: float = 500.0,
                        arrival: Optional[str] = None,
                        host_kv_tier_mb: float = 0.0,
                        seed: int = 0, device=None) -> Dict:
    """Fleet soak benchmark: an in-process disaggregated topology
    (fleet/harness.py — tiny model always: the fleet numbers measure
    the CONTROL PLANE, not the model) on `device` (None = CUDA) driven
    by the loadgen soak through a full rolling drain/restart cycle.

    Two phases at the same workload: a DIRECT phase (disaggregation
    off — every request dispatches straight to the decode tier) for
    the before-TTFT, then the disaggregated soak with rolling
    drain/restart for the after-TTFT, the transfer counters, and the
    zero-drop property. Emits the fleet_* keys the bench JSON carries:
    fleet_ttft_p50/p95 (+ the direct-phase _direct twins),
    kv_transfer_bytes, kv_transfer_hit_rate, drop counts, and — against
    the declared CPU-smoke objectives — the soak's client-measured
    fleet_slo_attainment (loadgen judges every response against
    slo_ttft_ms/slo_itl_ms)."""
    from butterfly_tpu_torch.fleet.harness import start_fleet
    from butterfly_tpu_torch.workload import loadgen as lg

    shared_len = max(page_size * 4, disagg_threshold)
    tail = page_size // 2
    fleet = start_fleet(topology, page_size=page_size,
                        max_batch=max_batch,
                        max_seq=shared_len + tail + max_tokens + 16,
                        disagg_threshold=disagg_threshold,
                        slo_ttft_s=slo_ttft_ms / 1e3,
                        slo_itl_s=slo_itl_ms / 1e3,
                        host_kv_tier_mb=host_kv_tier_mb,
                        # warm at the workload's prompt length so phase
                        # 1 (the before-TTFT) doesn't pay the first
                        # launches of the workload's prefill shape
                        warm_len=shared_len + tail, device=device)
    try:
        # phase 1 — direct (the "before"): threshold above any prompt
        fleet.state.disagg_threshold = 10 ** 9
        direct = lg.run_load(fleet.url, clients=clients,
                             requests_per_client=requests_per_client,
                             prefix_share=prefix_share,
                             shared_len=shared_len, tail_len=tail,
                             max_tokens=max_tokens, seed=seed)
        # phase 2 — disaggregated soak with rolling drain/restart
        fleet.state.disagg_threshold = disagg_threshold
        soak = lg.run_fleet_soak(
            fleet.url, clients=clients,
            requests_per_client=requests_per_client,
            prefix_share=prefix_share, shared_len=shared_len,
            tail_len=tail, max_tokens=max_tokens, seed=seed + 1,
            replicas=fleet.rids,
            restart_hook=lambda rid: fleet.by_rid[rid].restart(),
            slo_ttft_ms=slo_ttft_ms, slo_itl_ms=slo_itl_ms,
            arrival=arrival)
        tier = {}
        if host_kv_tier_mb > 0:
            for r in fleet.replicas:
                for k, v in r.sched.metrics().items():
                    if k.startswith("kv_tier_"):
                        tier[k] = tier.get(k, 0.0) + v
            # hit rate and restore percentiles don't sum across
            # replicas: re-derive the rate, keep the worst percentiles
            lookups = tier.get("kv_tier_pages_restored_total", 0.0) \
                + tier.get("kv_tier_misses_total", 0.0)
            tier["kv_tier_hit_rate"] = round(
                tier.get("kv_tier_pages_restored_total", 0.0) / lookups
                if lookups else 0.0, 4)
            for pk in ("kv_tier_restore_seconds_p50",
                       "kv_tier_restore_seconds_p95"):
                vals = [r.sched.metrics().get(pk) for r in fleet.replicas]
                vals = [v for v in vals if v is not None]
                if vals:
                    tier[pk] = round(max(vals), 6)
    finally:
        fleet.stop()
    fm = soak.get("fleet_metrics", {})
    return {
        "fleet_topology": topology,
        "fleet_arrival": arrival,
        **tier,
        "fleet_requests": soak["sent"],
        "fleet_dropped": soak["failed"],
        "fleet_outcomes": soak.get("outcomes", {}),
        "fleet_disaggregated": soak["disaggregated"],
        "fleet_ttft_p50": soak["ttft_p50_s"],
        "fleet_ttft_p95": soak["ttft_p95_s"],
        "fleet_ttft_direct_p50": direct["ttft_p50_s"],
        "fleet_ttft_direct_p95": direct["ttft_p95_s"],
        "fleet_rps": soak["rps"],
        "kv_transfer_bytes": fm.get("kv_transfer_bytes", 0.0),
        "kv_transfer_pages": fm.get("kv_transfer_pages", 0.0),
        "kv_transfer_hit_rate": fm.get("kv_transfer_hit_rate", 0.0),
        "fleet_rolling_cycles": len(soak.get("rolling_cycles", ())),
        # client-measured SLO attainment during the soak, against the
        # declared objectives (also in the JSON so regressions show)
        "fleet_slo_ttft_ms": slo_ttft_ms,
        "fleet_slo_itl_ms": slo_itl_ms,
        "fleet_slo_attainment": soak.get("slo_attainment"),
    }


def run_autoscale_benchmark(topology: str = "1p1d", *, clients: int = 4,
                            requests_per_client: int = 6,
                            max_tokens: int = 8, page_size: int = 8,
                            max_batch: int = 2,
                            arrival: str = "ramp:2:16:4",
                            slo_ttft_ms: float = 10000.0,
                            slo_itl_ms: float = 2000.0,
                            max_decode: int = 3,
                            signal_high: float = 0.5,
                            signal_low: float = 0.05,
                            cooldown_down_s: float = 1.0,
                            settle_s: float = 6.0,
                            seed: int = 0, device=None) -> Dict:
    """Elastic-fleet acceptance soak: a ramp-arrival open loop against
    a small in-process fleet on `device` (None = CUDA) WITH the
    closed-loop autoscaler live on the decode tier. The claim under test: the
    autoscaler holds the soak's client-measured slo_attainment while
    spending FEWER replica-seconds than a fleet statically provisioned
    at the peak shape it reached — elasticity pays for itself.

    The ramp (``ramp:2:16:4`` — 2 -> 16 req/s over 4s, then hold) is
    the canonical shape: the fleet starts small and correct for the
    head of the ramp, the scraped queue-depth rings rise with the
    offered rate, and the loop must grow the decode tier mid-soak.
    After the load ends a settle window lets the hysteresis-guarded
    scale-down fire, demonstrating both directions in one run. Every
    decision lands in the control plane's flight recorder, fetched
    over HTTP from /debug/flightrecorder as the audit evidence."""
    import json as _json
    import urllib.request as _rq

    from butterfly_tpu_torch.fleet.autoscale import Autoscaler, TierPolicy
    from butterfly_tpu_torch.fleet.harness import start_fleet
    from butterfly_tpu_torch.workload import loadgen as lg

    shared_len = page_size * 4
    tail = page_size // 2
    fleet = start_fleet(topology, page_size=page_size,
                        max_batch=max_batch,
                        max_seq=shared_len + tail + max_tokens + 16,
                        probe_interval=0.1,
                        slo_ttft_s=slo_ttft_ms / 1e3,
                        slo_itl_s=slo_itl_ms / 1e3,
                        warm_len=shared_len + tail, device=device)
    try:
        n0 = len(fleet.replicas)
        pol = TierPolicy("decode", min_replicas=1,
                         max_replicas=max_decode, signal="queue_depth",
                         high=signal_high, low=signal_low, window=2,
                         cooldown_up_s=0.5,
                         cooldown_down_s=cooldown_down_s)
        scaler = Autoscaler(fleet.state, fleet.spawn, fleet.retire,
                            [pol], interval_s=0.2)
        scaler.start()
        t0 = time.monotonic()
        load = lg.run_load(fleet.url, clients=clients,
                           requests_per_client=requests_per_client,
                           prefix_share=0.5, shared_len=shared_len,
                           tail_len=tail, max_tokens=max_tokens,
                           seed=seed, slo_ttft_ms=slo_ttft_ms,
                           slo_itl_ms=slo_itl_ms, arrival=arrival)
        # settle: idle rings drain below the low band and the
        # hysteresis window elapses — the scale-down half of the claim
        deadline = time.monotonic() + settle_s
        while time.monotonic() < deadline:
            if scaler.stats()["scale_downs"] > 0:
                break
            time.sleep(0.2)
        wall = time.monotonic() - t0
        scaler.stop()
        st = scaler.stats()
        # replay the event log to find the peak shape the fleet reached
        ns, n = [n0], n0
        for e in st["events"]:
            n += 1 if e["direction"] == "up" else -1
            ns.append(n)
        peak = max(ns)
        with _rq.urlopen(fleet.url + "/debug/flightrecorder",
                         timeout=10.0) as resp:
            rec = _json.loads(resp.read())
        scale_events = [e for e in rec.get("events", ())
                        if e.get("kind") == "scale"]
    finally:
        fleet.stop()
    static_peak = peak * wall
    return {
        "autoscale_topology": topology,
        "autoscale_arrival": arrival,
        "autoscale_requests": load["sent"],
        "autoscale_dropped": load["failed"],
        "autoscale_slo_ttft_ms": slo_ttft_ms,
        "autoscale_slo_itl_ms": slo_itl_ms,
        "autoscale_slo_attainment": load.get("slo_attainment"),
        "autoscale_ttft_p95_s": load.get("ttft_p95_s"),
        # the cost side: integral of live replicas over the soak vs a
        # static fleet provisioned at the peak shape the whole time
        "autoscale_replica_seconds": round(st["replica_seconds"], 3),
        "autoscale_static_peak_replica_seconds": round(static_peak, 3),
        "autoscale_replica_seconds_saved_frac": round(
            1.0 - st["replica_seconds"] / static_peak, 4)
        if static_peak > 0 else 0.0,
        "autoscale_peak_replicas": peak,
        "autoscale_scale_ups": st["scale_ups"],
        "autoscale_scale_downs": st["scale_downs"],
        # audit evidence: the decisions as served by the control
        # plane's /debug/flightrecorder
        "autoscale_flightrec_scale_events": len(scale_events),
    }


def run_chaos_benchmark(topology: str = "2p2d", *, clients: int = 3,
                        requests_per_client: int = 4,
                        max_tokens: int = 8, page_size: int = 8,
                        max_batch: int = 2, disagg_threshold: int = 16,
                        prefix_share: float = 0.5,
                        seed: int = 0, device=None) -> Dict:
    """Chaos soak benchmark: the in-process fleet on `device` (None =
    CUDA) under the SEEDED stock fault plan (fleet/chaos.py default_plan —
    delayed prefill, 500s and a breaker-tripping wedge burst on the
    decode tier, dropped and truncated connections) driven by loadgen,
    plus a burst of already-expired deadline requests.

    The pass property is system-level: every submitted request reaches
    a TERMINAL outcome (tokens, 429, or 504) — zero un-started drops,
    zero client hangs — while the faults actually fire. The JSON keys
    carry the overload-protection counters: serving_shed_total (summed
    over replica schedulers), deadline_expired_total (replicas +
    control plane), breaker_open_total (pool-wide open transitions),
    and the classified leg-failure count."""
    from butterfly_tpu_torch.fleet.chaos import default_plan
    from butterfly_tpu_torch.fleet.harness import start_fleet
    from butterfly_tpu_torch.workload import loadgen as lg

    plan = default_plan(seed=seed)
    shared_len = max(page_size * 4, disagg_threshold)
    tail = page_size // 2
    # generous declared objectives: the SLO/shed machinery is ACTIVE
    # (counters live, shed path armed) without turning CPU-smoke
    # latency noise into nondeterministic shedding
    fleet = start_fleet(topology, page_size=page_size,
                        max_batch=max_batch,
                        max_seq=shared_len + tail + max_tokens + 16,
                        disagg_threshold=disagg_threshold,
                        chaos=plan, slo_ttft_s=120.0, slo_itl_s=120.0,
                        warm_len=shared_len + tail, device=device)
    try:
        # arm the control plane's flight recorder for the spent-budget
        # burst below: 3 expiries inside the window is a deadline-
        # expiry-burst anomaly at this soak's scale, so the soak also
        # proves the post-mortem path end-to-end
        fleet.state.flightrec.expiry_burst = 3
        # phase 1 — the chaos load: faults fire across both tiers while
        # closed-loop clients demand terminal outcomes
        load = lg.run_load(fleet.url, clients=clients,
                           requests_per_client=requests_per_client,
                           prefix_share=prefix_share,
                           shared_len=shared_len, tail_len=tail,
                           max_tokens=max_tokens, seed=seed)
        # phase 2 — a spent-budget burst: every request arrives with a
        # dead deadline and must 504 at the control plane, never
        # touching a queue or a decode slot
        expired = lg.run_load(fleet.url, clients=1,
                              requests_per_client=3,
                              prefix_share=0.0, shared_len=shared_len,
                              tail_len=tail, max_tokens=max_tokens,
                              seed=seed + 1, deadline_ms=0.0)
        # the fleet-wide flight-recorder rollup: control-plane +
        # per-replica rings merged on the probe-offset clock, with the
        # expiry-burst trigger's post-mortem artifact(s) attached
        import json as _json
        import urllib.request as _rq
        with _rq.urlopen(fleet.url + "/fleet/flightrecorder",
                         timeout=10.0) as resp:
            flightrec = _json.loads(resp.read())
        shed = sum(r.sched.metrics().get("shed_total", 0.0)
                   for r in fleet.replicas)
        deadline = sum(
            r.sched.metrics().get("deadline_expired_total", 0.0)
            for r in fleet.replicas)
        cp = fleet.state.fleet_counters()
        deadline += cp["deadline_expired"]
        breaker_opens = fleet.state.pool.breaker_opens_total()
    finally:
        fleet.stop()
    o1, o2 = load["outcomes"], expired["outcomes"]
    sent = load["sent"] + expired["sent"]
    terminal = load["terminal"] + expired["terminal"]
    return {
        "chaos_topology": topology,
        "chaos_seed": seed,
        "chaos_requests": sent,
        "chaos_terminal": terminal,
        "chaos_unterminal": sent - terminal,
        "chaos_errors": o1["error"] + o2["error"],
        "chaos_shed_429": o1["shed_429"] + o2["shed_429"],
        "chaos_deadline_504": o1["deadline_504"] + o2["deadline_504"],
        "chaos_injected": plan.total_injected,
        "chaos_fallbacks": cp["disagg_fallbacks"],
        "chaos_leg_failures": cp["leg_failures"],
        # the overload-protection counter families (acceptance keys in
        # the bench JSON)
        "serving_shed_total": shed,
        "deadline_expired_total": deadline,
        "breaker_open_total": breaker_opens,
        # flight-recorder evidence: the expiry burst must
        # have produced at least one schema-valid post-mortem artifact
        "chaos_flightrec_dumps": len(flightrec.get("dumps", ())),
        "chaos_flightrec_reasons": sorted(
            {d.get("reason") for d in flightrec.get("dumps", ())}),
        "chaos_flightrec_sources": len(flightrec.get("sources", {})),
        "chaos_flightrec_events": len(flightrec.get("events", ())),
    }
