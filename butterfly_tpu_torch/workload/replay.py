"""Trace serialization (JSONL) + absolute-time open-loop replay.

A trace is one JSONL file: a header line (trace kind/version, the
workload spec that generated it, the arrival spec, the seed), then one
line per request (`RequestSpec.to_json`, sorted keys). Serialization is
deterministic: the same workload spec + seed writes byte-identical
files, and load -> save round-trips byte-identically — the property
that makes a saved trace a *citable benchmark input* instead of a
one-off (pinned in tests/test_torch_workload.py).

`replay_trace` fires a trace at a live server/router/control-plane URL
with **absolute-time fidelity**: request i is sent at
`t0 + arrival_s/speed` regardless of how earlier requests are faring
(open loop — a slow server gets a growing queue, exactly what the
admission machinery must be measured under). Request firing, judging,
and outcome accounting are workload/loadgen.py's (`fire_one` /
`Collector` — TTFT/ITL/SLO verdicts, terminal-outcome breakdown,
post-run /metrics scrape), reused rather than duplicated.

Trace IO is stdlib-only; replay needs only loadgen (urllib+threading).
A copy of butterfly_tpu/workload/replay.py on the port's models and
loadgen.
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from butterfly_tpu_torch.workload import loadgen as lg
from butterfly_tpu_torch.workload.models import RequestSpec, Workload

TRACE_KIND = "butterfly-workload-trace"
TRACE_VERSION = 1


# ---------------------------------------------------------------------------
# Trace files
# ---------------------------------------------------------------------------


def trace_text(specs: List[RequestSpec], *,
               workload: Optional[Workload] = None,
               arrival: Optional[str] = None,
               seed: Optional[int] = None) -> str:
    """Render a trace as JSONL text (header + one line per request).
    Key order is pinned (sort_keys) so equal traces are equal bytes."""
    header = {"kind": TRACE_KIND, "version": TRACE_VERSION,
              "n": len(specs)}
    if workload is not None:
        header["workload"] = workload.spec()
    if arrival is not None:
        header["arrival"] = arrival
    if seed is not None:
        header["seed"] = seed
    lines = [json.dumps(header, sort_keys=True)]
    lines += [json.dumps(s.to_json(), sort_keys=True) for s in specs]
    return "\n".join(lines) + "\n"


def save_trace(path, specs: List[RequestSpec], *,
               workload: Optional[Workload] = None,
               arrival: Optional[str] = None,
               seed: Optional[int] = None) -> None:
    Path(path).write_text(trace_text(specs, workload=workload,
                                     arrival=arrival, seed=seed))


def load_trace(path) -> Tuple[Dict, List[RequestSpec]]:
    """Read a trace file -> (header, specs). Raises ValueError on a
    file that isn't a butterfly workload trace (a stray JSONL fed to
    --trace should fail loudly, not replay garbage)."""
    lines = [ln for ln in Path(path).read_text().splitlines()
             if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty trace file")
    header = json.loads(lines[0])
    if not isinstance(header, dict) or header.get("kind") != TRACE_KIND:
        raise ValueError(f"{path}: not a {TRACE_KIND} file")
    specs = [RequestSpec.from_json(json.loads(ln)) for ln in lines[1:]]
    if header.get("n") is not None and int(header["n"]) != len(specs):
        raise ValueError(f"{path}: header says {header['n']} requests, "
                         f"file has {len(specs)}")
    return header, specs


# ---------------------------------------------------------------------------
# Open-loop replay
# ---------------------------------------------------------------------------


def replay_trace(url: str, specs: List[RequestSpec], *,
                 path: str = "/generate", timeout: float = 120.0,
                 speed: float = 1.0,
                 slo_ttft_ms: Optional[float] = None,
                 slo_itl_ms: Optional[float] = None,
                 scrape: bool = True) -> Dict:
    """Fire `specs` at `url` open-loop on their absolute schedule.

    One thread per request sleeps until its `arrival_s / speed` offset
    from the common start, then fires — each thread computes its delay
    from the shared t0, so schedule error never accumulates across
    requests (absolute-time fidelity, not cumulative gaps). `speed` > 1
    compresses the schedule (replay a 60 s trace in 6 s at speed=10).

    Returns the loadgen summary shape (outcomes/terminal breakdown,
    latency + TTFT percentiles, SLO attainment when objectives are
    declared) plus replay bookkeeping and — like every loadgen run —
    the target's post-run server-side counters under ``server`` so
    client-observed and server-counted outcomes sit in one artifact.
    """
    if speed <= 0:
        raise ValueError(f"speed must be > 0, got {speed}")
    col = lg.Collector(slo_ttft_ms=slo_ttft_ms, slo_itl_ms=slo_itl_ms)
    t0 = time.monotonic()

    def fire(spec: RequestSpec) -> None:
        delay = spec.arrival_s / speed - (time.monotonic() - t0)
        if delay > 0:
            time.sleep(delay)
        lg.fire_one(url, path, spec.payload(), timeout, col,
                    label=f"trace-{spec.index}")

    threads = [threading.Thread(target=fire, args=(s,), daemon=True)
               for s in specs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    out = col.summary(wall)
    out["open_loop"] = True
    out["replay_speed"] = speed
    out["offered_span_s"] = (max(s.arrival_s for s in specs) / speed
                             if specs else 0.0)
    if scrape:
        out["server"] = lg.scrape_server_counters(url, timeout=10.0)
    return out
