"""Operating-point sweeps: one workload, a grid of scheduler knobs.

The port of butterfly_tpu/workload/sweep.py (the scheduler and engine it
drives are the port's).

The serving stack's two throughput/latency levers are
`decode_steps_per_tick` (fused block width — amortizes host overhead,
adds per-token burst latency) and `inflight_blocks` (dispatch-ahead
depth — overlaps host scheduling with device compute, adds one block of
drain latency per level). Neither has a universally right value; the
honest number is the CURVE. `sweep_operating_points` runs the SAME
sampled trace (same requests, same arrival schedule) at every grid
point and emits per-point throughput + latency percentiles plus a knee
point, so a bench round documents *where* it operates, not just one
cherry-picked coordinate.

`drive_open_loop` is the shared in-process driver: it submits a trace's
requests into a Scheduler on their absolute arrival schedule (open
loop), routing each arrival through the admission surface
(`shed_decision` -> counted 429, `deadline_ms` -> scheduler deadline
scrub) — the same calls ServerState.submit makes, without the HTTP
layer. obs/benchmark.py's mixed phase uses it too.

All grid points share ONE ServingEngine (`decode_steps_per_tick` and
`inflight_blocks` are read from its runtime at dispatch, and
`inflight_blocks` is purely scheduler-side), so a 2x2 sweep builds one
engine, not four. torch is only touched by the engine
the caller built; this module itself stays import-light.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

from butterfly_tpu_torch.workload.arrivals import (assign_arrivals,
                                                   parse_arrival)
from butterfly_tpu_torch.workload.models import RequestSpec, Workload


def parse_grid(spec: str) -> List[Tuple[int, int]]:
    """'1,4x1,2' -> [(1,1), (1,2), (4,1), (4,2)] — the
    decode_steps_per_tick x inflight_blocks grid for the CLI."""
    try:
        ds_s, infl_s = spec.split("x")
        ds = [int(v) for v in ds_s.split(",") if v]
        infl = [int(v) for v in infl_s.split(",") if v]
        if not ds or not infl or min(ds + infl) < 1:
            raise ValueError("empty axis or value < 1")
    except ValueError as e:
        raise ValueError(
            f"bad grid spec {spec!r} (expected 'k1,k2x d1,d2' e.g. "
            f"'1,4x1,2'): {e}") from None
    return [(d, i) for d in ds for i in infl]


def drive_open_loop(sched, specs: Sequence[RequestSpec], *,
                    max_seconds: float = 600.0) -> Dict:
    """Submit `specs` into `sched` on their absolute arrival schedule
    and tick until drained. Open loop: arrivals never wait for service.

    Each arrival goes through the admission decisions exactly like
    ServerState.submit: `shed_decision(prompt_len, priority)` first
    (counted as a shed_429 outcome — needs the scheduler built with
    slo_ttft_s), then `submit(..., deadline_s=...)` when the spec
    carries a deadline budget (expiries surface as state="expired", the
    504 outcome). A request whose prompt+max_new exceeds the engine's
    max_seq has its budget clamped (and is skipped entirely if the
    prompt alone doesn't fit — counted, never silently dropped).
    """
    order = sorted(specs, key=lambda s: (s.arrival_s, s.index))
    max_seq = sched.engine.cache.max_seq
    reqs, i = [], 0
    shed = skipped = 0
    t0 = time.monotonic()
    while i < len(order) or sched.has_work:
        if time.monotonic() - t0 > max_seconds:
            raise RuntimeError(
                f"open-loop drive exceeded {max_seconds}s with "
                f"{len(order) - i} arrivals pending")
        now = time.monotonic() - t0
        while i < len(order) and order[i].arrival_s <= now:
            s = order[i]
            i += 1
            if len(s.tokens) + 1 > max_seq:
                skipped += 1
                continue
            retry_after = sched.shed_decision(len(s.tokens), s.priority)
            if retry_after is not None:
                shed += 1
                continue
            deadline_s = (time.monotonic() + s.deadline_ms / 1e3
                          if s.deadline_ms is not None else None)
            reqs.append(sched.submit(
                s.tokens,
                max_new_tokens=min(s.max_new, max_seq - len(s.tokens)),
                temperature=s.temperature, priority=s.priority,
                deadline_s=deadline_s, speculative=s.speculative))
        if sched.has_work:
            sched.tick()
        elif i < len(order):
            time.sleep(min(0.002, max(
                0.0, order[i].arrival_s - (time.monotonic() - t0))))
    wall = time.monotonic() - t0
    m = sched.metrics()
    finished = sum(1 for r in reqs if r.state == "finished")
    expired = sum(1 for r in reqs if r.state == "expired")
    stuck = [r.id for r in reqs if not r.done]
    if stuck:
        raise RuntimeError(f"open-loop drive left requests undrained "
                           f"(ids {stuck[:8]})")
    out = {
        "requests": len(order),
        "admitted": len(reqs),
        "ok": finished,
        "shed_429": shed,
        "expired_504": expired,
        "skipped_too_long": skipped,
        "wall_s": wall,
        "tokens": m["tokens_generated_total"],
        "tokens_per_sec": m["tokens_generated_total"] / max(wall, 1e-9),
        "preemptions": m["preemptions_total"],
        "deadline_expired_total": m["deadline_expired_total"],
        "shed_total": m["shed_total"],
    }
    for k in ("ttft_p50", "ttft_p95", "itl_req_mean_p50",
              "itl_req_mean_p95", "prefix_cache_hit_tokens"):
        if k in m:
            out[k] = m[k]
    return out


def find_knee(points: List[Dict], ttft_slack: float = 2.0) -> Optional[Dict]:
    """The operating point to run at: max throughput among points whose
    ttft_p95 stays within `ttft_slack` x the grid's best ttft_p95 (the
    classic latency/throughput knee — past it you buy tokens/sec with
    tail latency). Falls back to plain max throughput when every point
    busts the slack. Deterministic and documented so bench rounds can
    compare knees across rounds."""
    usable = [p for p in points if p.get("ttft_p95") is not None]
    if not usable:
        return None
    floor = min(p["ttft_p95"] for p in usable)
    eligible = [p for p in usable
                if p["ttft_p95"] <= ttft_slack * floor] or usable
    best = max(eligible, key=lambda p: p["tokens_per_sec"])
    return {"decode_steps_per_tick": best["decode_steps_per_tick"],
            "inflight_blocks": best["inflight_blocks"],
            "tokens_per_sec": best["tokens_per_sec"],
            "ttft_p95": best["ttft_p95"],
            "rule": f"max tokens/sec with ttft_p95 <= {ttft_slack:g}x "
                    f"grid minimum ({floor:.4g}s)"}


def sweep_operating_points(engine, base_rt, specs: Sequence[RequestSpec],
                           grid: Sequence[Tuple[int, int]], *,
                           slo_ttft_s: Optional[float] = None,
                           warm_max_new: int = 2,
                           max_seconds: float = 600.0,
                           ttft_slack: float = 2.0) -> Dict:
    """Run `specs` at every (decode_steps_per_tick, inflight_blocks)
    grid point on ONE shared engine; returns {"points", "knee"}.

    Per distinct k a warmup scheduler replays the trace's prompts with
    a tiny budget first, so the measured pass doesn't eat the first-use
    costs of that block width (kernel builds, allocator growth; inflight
    depth adds none — its warm ride-along is free). Each measured pass
    gets a FRESH Scheduler so counters and latency reservoirs start at
    zero.
    """
    from butterfly_tpu_torch.sched.scheduler import Scheduler

    points: List[Dict] = []
    warmed: set = set()
    for d, infl in grid:
        engine.runtime = base_rt.replace(decode_steps_per_tick=d,
                                         inflight_blocks=infl)
        if d not in warmed:
            warm = Scheduler(engine)
            for s in specs:
                if len(s.tokens) + 1 <= engine.cache.max_seq:
                    warm.submit(s.tokens, max_new_tokens=warm_max_new,
                                temperature=s.temperature)
            warm.run_until_done(max_ticks=10 ** 6)
            warmed.add(d)
        sched = Scheduler(engine, slo_ttft_s=slo_ttft_s)
        res = drive_open_loop(sched, specs, max_seconds=max_seconds)
        points.append({"decode_steps_per_tick": d,
                       "inflight_blocks": infl,
                       **{k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in res.items()}})
    return {"points": points, "knee": find_knee(points, ttft_slack)}


def run_operating_point_sweep(model, params, *, workload: Workload,
                              arrival: str, n_requests: int,
                              grid: Sequence[Tuple[int, int]],
                              max_batch: int = 8,
                              num_pages: int = 0,
                              kv_quant: str = "none",
                              prefill_max_batch: int = 8,
                              prefix_caching: bool = True,
                              slo_ttft_ms: Optional[float] = None,
                              seed: int = 0,
                              max_seconds: float = 600.0) -> Dict:
    """CLI/bench convenience: build the engine, sample + schedule the
    workload once, sweep the grid. max_seq is sized to the workload's
    own worst case so no request is clamped."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.serving import ServingEngine

    specs = workload.sample(n_requests, seed)
    assign_arrivals(specs, parse_arrival(arrival), seed)
    max_seq = workload.max_prompt_len + workload.max_new_hi + 16
    base_rt = RuntimeConfig(max_batch_size=max_batch, max_seq_len=max_seq,
                            page_size=workload.page_size,
                            num_pages=num_pages, kv_quant=kv_quant,
                            prefill_max_batch=prefill_max_batch,
                            prefix_caching=prefix_caching)
    engine = ServingEngine(model, params, base_rt)
    out = sweep_operating_points(
        engine, base_rt, specs, grid,
        slo_ttft_s=slo_ttft_ms / 1e3 if slo_ttft_ms else None,
        max_seconds=max_seconds)
    out.update({"workload": workload.name, "arrival": arrival,
                "requests": n_requests, "seed": seed,
                "max_batch": max_batch, "kv_quant": kv_quant,
                "grid": [list(g) for g in grid]})
    return out
