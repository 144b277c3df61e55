"""Load generator for a serve replica, router, or fleet control plane.

A copy of tools/loadgen.py inside the port, whose open-loop path
imports the port's workload package instead of the JAX package's.
stdlib-only (urllib + threading — no torch, no backend). Two drive
modes:

* **Closed loop** (default): each of ``--clients`` worker threads keeps
  exactly ONE request in flight (issue, wait, repeat) — exercises
  continuous batching without open-loop queue explosion. The offered
  rate is throttled by the server's own latency, so this mode can
  never really force queue growth, shedding, or preemption.
* **Open loop** (``--workload NAME`` or ``--trace FILE``): requests
  fire on an absolute arrival schedule (``--arrival poisson:8``,
  ``burst:...``, ``ramp:...`` — workload/arrivals.py)
  regardless of how earlier requests are faring. This is the
  admission-control regime: load is no longer bounded by client count,
  so the queue, the shed path, and the page pool actually get tested.
  ``--save trace.jsonl`` persists the generated trace for replay.

Request firing and judging live in ``fire_one`` + ``Collector`` and are
shared by both modes AND by the workload trace replay
(workload/replay.py) — one accounting implementation,
every summary the same shape.

Every summary also scrapes the target's ``/metrics`` after the run and
folds the server-side counters (``serving_preemptions``, ``shed_total``,
``deadline_expired_total``) in under ``server``, so client-observed and
server-counted outcomes are checked against each other in one artifact.

``--prefix-share R`` (closed loop) is the affinity workload knob:
fraction of requests whose token prompt begins with a SHARED
``--shared-len``-token prefix. ``--soak`` is the fleet mode: while the
closed-loop load runs, every replica behind the router/control plane is
rolled through drain -> (restart) -> undrain (``run_fleet_soak``).
``--slo-ttft-ms`` / ``--slo-itl-ms`` declare latency objectives judged
client-side per request (``slo_attainment`` in the summary).

Importable by tests (``run_load`` / ``run_fleet_soak`` / ``fire_one`` /
``Collector``) and runnable standalone:

    python -m butterfly_tpu_torch.workload.loadgen \
        --url http://127.0.0.1:8100 --clients 8 --requests 16 \
        --prefix-share 0.5 --json
    python -m butterfly_tpu_torch.workload.loadgen \
        --url http://127.0.0.1:8100 --workload mixed_chat --n 64 \
        --arrival burst:20:0.5:2 --json

Both paths stay torch-free: the open-loop path imports only the
stdlib modules of butterfly_tpu_torch.workload.
"""
from __future__ import annotations

import argparse
import json
import random
import re
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional


def _percentile(xs: List[float], p: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    k = min(len(s) - 1, max(0, int(round(p / 100 * (len(s) - 1)))))
    return s[k]


def shared_prefix(shared_len: int, seed: int = 0,
                  vocab: int = 64) -> List[int]:
    """The deterministic shared-prefix token block (page-aligned lengths
    make it land whole pages in the replicas' prefix caches)."""
    rng = random.Random(10_000 + seed)
    return [rng.randrange(1, vocab) for _ in range(shared_len)]


class Collector:
    """Thread-safe per-request outcome accounting shared by the
    closed-loop clients, the fleet soak, and the open-loop trace
    replay (workload/replay.py) — TTFT/ITL/SLO verdicts and the
    terminal-outcome breakdown live HERE, once.

    Outcome semantics: an HTTP error IS a terminal outcome (the server
    answered definitively) — 429 = shed/backpressure, 504 = deadline
    exceeded; anything else is a fault. `terminal` counts requests that
    got ANY definitive answer; the zero-hang property of a soak is
    terminal == sent with outcomes["error"] == 0.
    """

    def __init__(self, slo_ttft_ms: Optional[float] = None,
                 slo_itl_ms: Optional[float] = None):
        self.lock = threading.Lock()
        self.slo_ttft_ms = slo_ttft_ms
        self.slo_itl_ms = slo_itl_ms
        self.slo_declared = slo_ttft_ms is not None or slo_itl_ms is not None
        self.latencies: List[float] = []
        self.ttfts: List[float] = []
        self.shared_latencies: List[float] = []
        self.by_replica: Dict[str, int] = {}
        self.errors: List[str] = []
        self.counts = {"sent": 0, "ok": 0, "shared": 0, "disaggregated": 0,
                       "slo_ok": 0, "slo_ttft_ok": 0, "slo_itl_ok": 0}
        self.outcomes = {"ok": 0, "shed_429": 0, "deadline_504": 0,
                         "error": 0}

    def record_ok(self, dt: float, ttft, total, n_toks: int,
                  routed: Optional[str], disagg: bool,
                  shared: bool = False) -> None:
        # client-side SLO verdicts for this request: a response missing
        # the fields its verdict needs counts as a miss — the client
        # couldn't verify its SLO
        ttft_ok = itl_ok = True
        if self.slo_ttft_ms is not None:
            ttft_ok = isinstance(ttft, (int, float)) \
                and ttft * 1e3 <= self.slo_ttft_ms
        if self.slo_itl_ms is not None and n_toks > 1 \
                and isinstance(ttft, (int, float)) \
                and isinstance(total, (int, float)):
            itl_ok = ((total - ttft) / (n_toks - 1)
                      * 1e3 <= self.slo_itl_ms)
        elif self.slo_itl_ms is not None and (
                not isinstance(total, (int, float))):
            itl_ok = False
        with self.lock:
            self.counts["sent"] += 1
            self.counts["ok"] += 1
            self.outcomes["ok"] += 1
            self.counts["shared"] += int(shared)
            self.counts["disaggregated"] += int(disagg)
            if self.slo_declared:
                self.counts["slo_ttft_ok"] += int(ttft_ok)
                self.counts["slo_itl_ok"] += int(itl_ok)
                self.counts["slo_ok"] += int(ttft_ok and itl_ok)
            self.latencies.append(dt)
            if isinstance(ttft, (int, float)):
                self.ttfts.append(float(ttft))
            if shared:
                self.shared_latencies.append(dt)
            if routed:
                self.by_replica[routed] = self.by_replica.get(routed, 0) + 1

    def record_http_error(self, code: int, label: str) -> None:
        with self.lock:
            self.counts["sent"] += 1
            if code == 429:
                self.outcomes["shed_429"] += 1
            elif code == 504:
                self.outcomes["deadline_504"] += 1
            else:
                self.outcomes["error"] += 1
                self.errors.append(f"{label}: http {code}")

    def record_transport_error(self, err, label: str) -> None:
        with self.lock:
            self.counts["sent"] += 1
            self.outcomes["error"] += 1
            self.errors.append(f"{label}: {err}")

    def summary(self, wall: float) -> Dict:
        c, o = self.counts, self.outcomes
        return {
            "sent": c["sent"], "ok": c["ok"],
            "failed": c["sent"] - c["ok"],
            # terminal-outcome breakdown: every sent request lands in
            # exactly one bucket; `terminal` excludes only transport
            # errors/hangs
            "outcomes": dict(o),
            "terminal": o["ok"] + o["shed_429"] + o["deadline_504"],
            "shared_prefix_requests": c["shared"],
            "disaggregated": c["disaggregated"],
            "wall_s": wall,
            "rps": c["ok"] / wall if wall > 0 else 0.0,
            "latency_p50_s": _percentile(self.latencies, 50),
            "latency_p95_s": _percentile(self.latencies, 95),
            "ttft_p50_s": _percentile(self.ttfts, 50),
            "ttft_p95_s": _percentile(self.ttfts, 95),
            "shared_latency_p50_s": _percentile(self.shared_latencies, 50),
            "by_replica": dict(self.by_replica),
            "errors": self.errors[:20],
            "slo_ttft_ms": self.slo_ttft_ms,
            "slo_itl_ms": self.slo_itl_ms,
            "slo_attainment": (c["slo_ok"] / c["ok"]
                               if self.slo_declared and c["ok"] else None),
            "slo_ttft_ok": c["slo_ttft_ok"] if self.slo_declared else None,
            "slo_itl_ok": c["slo_itl_ok"] if self.slo_declared else None,
        }


def fire_one(url: str, path: str, payload: Dict, timeout: float,
             col: Collector, label: str = "req",
             shared: bool = False) -> None:
    """POST one request and record its outcome into `col`."""
    body = json.dumps(payload).encode()
    req = urllib.request.Request(
        url + path, data=body,
        headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read()
            routed = resp.headers.get("X-Routed-To")
        dt = time.monotonic() - t0
        try:  # /generate bodies carry ttft_s (replica-measured direct,
            # control-plane-measured across a disaggregated handoff)
            # + the handoff marker
            obj = json.loads(raw or b"{}")
            ttft = obj.get("ttft_s")
            disagg = bool(obj.get("disaggregated"))
            n_toks = len(obj.get("tokens") or ())
            total = obj.get("total_s")
        except (ValueError, AttributeError):
            ttft, disagg, n_toks, total = None, False, 0, None
        col.record_ok(dt, ttft, total, n_toks, routed, disagg,
                      shared=shared)
    except urllib.error.HTTPError as e:
        try:
            e.read()
        except OSError:
            pass
        e.close()
        col.record_http_error(e.code, label)
    except (urllib.error.URLError, OSError) as e:
        col.record_transport_error(e, label)


#: prometheus sample line: name{labels} value  (labels optional)
_METRIC_RE = re.compile(
    r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")

#: server-side counter families folded into every loadgen/replay
#: summary (labeled families sum over their children), keyed by the
#: summary field name they land under
_SERVER_FAMILIES = {
    "serving_preemptions": "butterfly_preemptions_total",
    "shed_total": "butterfly_shed_total",
    "deadline_expired_total": "butterfly_deadline_expired_total",
    "tokens_generated_total": "butterfly_tokens_generated_total",
}


def scrape_server_counters(url: str, timeout: float = 10.0) -> Dict:
    """GET /metrics and fold the overload-protection counters into a
    small dict, so a load run's JSON carries the SERVER-counted
    outcomes next to the client-observed ones (a shed the client saw
    as 429 should show up in shed_total; a preemption is invisible to
    clients and ONLY shows up here). Families absent at the target
    (e.g. a plain router's registry) read 0.0; an unreachable /metrics
    reads {"scraped": False}."""
    try:
        with urllib.request.urlopen(url + "/metrics",
                                    timeout=timeout) as resp:
            text = resp.read().decode("utf-8", "replace")
    except (urllib.error.URLError, OSError, ValueError) as e:
        return {"scraped": False, "error": str(e)[:200]}
    sums: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _METRIC_RE.match(line)
        if not m:
            continue
        name, _, raw = m.groups()
        try:
            val = float(raw)
        except ValueError:
            continue
        sums[name] = sums.get(name, 0.0) + val
    out: Dict = {"scraped": True}
    for field, family in _SERVER_FAMILIES.items():
        out[field] = sums.get(family, 0.0)
    return out


def run_load(url: str, clients: int = 4, requests_per_client: int = 8,
             prefix_share: float = 0.5, shared_len: int = 32,
             tail_len: int = 8, max_tokens: int = 8, seed: int = 0,
             vocab: int = 64, path: str = "/generate",
             timeout: float = 120.0,
             slo_ttft_ms: Optional[float] = None,
             slo_itl_ms: Optional[float] = None,
             deadline_ms: Optional[float] = None,
             priority: Optional[str] = None,
             speculative: Optional[bool] = None,
             arrival: Optional[str] = None,
             scrape: bool = True) -> Dict:
    """Drive `url` closed-loop; returns aggregate stats.

    Every request uses token-id prompts (deterministic, tokenizer-free).
    A `prefix_share` fraction starts with the shared prefix plus a
    per-request tail; the rest are fully private prompts of the same
    total length, so the two populations differ only in shareability.

    `deadline_ms` stamps a latency budget on every request (the server
    504s whatever blows it); `priority` tags the admission class
    ('interactive'/'batch'; batch sheds first under load). Outcome /
    SLO semantics live in `Collector`; the summary additionally carries
    the post-run server-side counters under ``server``
    (`scrape_server_counters`).

    `arrival` (a workload/arrivals.py spec — ``ramp:2:50:10``,
    ``burst:20:0.5:2``, ``poisson:8``) switches the lanes from
    closed-loop to a SCHEDULED offered load: the clients*requests
    arrival offsets are drawn once from the process and dealt round-
    robin across the lanes, and each lane sleeps until a request's
    offset before firing. Per-lane it is semi-open — a response that
    overruns the gap delays that lane's next shot but nobody else's —
    which is what ramps the pressure an elastic fleet has to absorb."""
    prefix = shared_prefix(shared_len, seed, vocab)
    col = Collector(slo_ttft_ms=slo_ttft_ms, slo_itl_ms=slo_itl_ms)
    offsets = None
    if arrival is not None:
        _, arrivals, _ = _workload_modules()
        offsets = arrivals.parse_arrival(arrival).times(
            clients * requests_per_client, seed)
    t_start = time.monotonic()

    def one_client(cid: int) -> None:
        rng = random.Random(seed * 1000 + cid)
        for i in range(requests_per_client):
            is_shared = rng.random() < prefix_share
            tail = [rng.randrange(1, vocab) for _ in range(tail_len)]
            tokens = (prefix + tail) if is_shared else \
                [rng.randrange(1, vocab)
                 for _ in range(shared_len + tail_len)]
            payload = {
                "tokens": tokens, "max_tokens": max_tokens,
                "stop_token": -1,
                "request_id": f"loadgen-{cid}-{i}"}
            if deadline_ms is not None:
                payload["deadline_ms"] = deadline_ms
            if priority is not None:
                payload["priority"] = priority
            if speculative is not None:
                payload["speculative"] = speculative
            if offsets is not None:
                # round-robin deal keeps each lane's schedule ascending
                # while spreading a ramp's dense tail across all lanes
                wait = t_start + offsets[cid + clients * i] \
                    - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
            fire_one(url, path, payload, timeout, col,
                     label=f"client{cid}#{i}", shared=is_shared)

    threads = [threading.Thread(target=one_client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out = col.summary(time.monotonic() - t_start)
    if arrival is not None:
        out["arrival"] = arrival
    if scrape:
        out["server"] = scrape_server_counters(url)
    return out


def _get_json(url: str, path: str, timeout: float = 10.0) -> Dict:
    with urllib.request.urlopen(url + path, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


def _post_json(url: str, path: str, obj: Dict, timeout: float = 10.0) -> Dict:
    req = urllib.request.Request(
        url + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


def _wait_drained(url: str, rid: str, timeout: float = 30.0) -> bool:
    """Poll the router snapshot until `rid` has zero outstanding
    proxied requests (its in-flight work finished; only NEW requests
    were being refused by the drain)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        snaps = _get_json(url, "/router/replicas").get("replicas", [])
        me = next((s for s in snaps if s["replica"] == rid), None)
        if me is not None and int(me.get("outstanding", 0)) == 0:
            return True
        time.sleep(0.05)
    return False


def run_fleet_soak(url: str, clients: int = 4,
                   requests_per_client: int = 8,
                   prefix_share: float = 0.5, shared_len: int = 32,
                   tail_len: int = 8, max_tokens: int = 8, seed: int = 0,
                   vocab: int = 64, timeout: float = 120.0,
                   replicas: Optional[List[str]] = None,
                   restart_hook=None, settle_s: float = 0.3,
                   slo_ttft_ms: Optional[float] = None,
                   slo_itl_ms: Optional[float] = None,
                   deadline_ms: Optional[float] = None,
                   priority: Optional[str] = None,
                   speculative: Optional[bool] = None,
                   arrival: Optional[str] = None) -> Dict:
    """Fleet soak: closed-loop load against a control plane WHILE every
    replica is rolled through drain -> (restart) -> undrain, one at a
    time. The pass/fail property is the router tier's: zero dropped
    un-started requests — a drained/restarting replica stops receiving
    new work, its in-flight work finishes, and the rest of the fleet
    absorbs the traffic.

    `restart_hook(rid)` (optional) bounces the replica between drain
    and undrain — the in-process harness passes
    ``fleet.by_rid[rid].restart``; against a real deployment the
    operator's supervisor plays that part. Returns the load stats plus
    the control plane's /fleet/state counters (kv_transfer_hit_rate,
    transfer bytes/pages, disagg/direct split) and the rolling-cycle
    log."""
    if replicas is None:
        replicas = [s["replica"] for s in
                    _get_json(url, "/router/replicas").get("replicas", [])]
    result: Dict = {}

    def _load():
        result.update(run_load(
            url, clients=clients, requests_per_client=requests_per_client,
            prefix_share=prefix_share, shared_len=shared_len,
            tail_len=tail_len, max_tokens=max_tokens, seed=seed,
            vocab=vocab, timeout=timeout, slo_ttft_ms=slo_ttft_ms,
            slo_itl_ms=slo_itl_ms, deadline_ms=deadline_ms,
            priority=priority, speculative=speculative,
            arrival=arrival))

    t = threading.Thread(target=_load)
    t.start()
    cycles = []
    for rid in replicas:
        cycle = {"replica": rid}
        _post_json(url, "/router/drain", {"replica": rid})
        cycle["drained"] = _wait_drained(url, rid)
        if restart_hook is not None:
            restart_hook(rid)
            cycle["restarted"] = True
        time.sleep(settle_s)
        _post_json(url, "/router/undrain", {"replica": rid})
        cycles.append(cycle)
        if t.is_alive():
            time.sleep(settle_s)
    t.join()
    result["rolling_cycles"] = cycles
    try:  # a plain (non-fleet) router has no /fleet/state — soak still valid
        state = _get_json(url, "/fleet/state")
        result["fleet_metrics"] = state.get("metrics", {})
        result["fleet_tiers"] = state.get("tiers", {})
    except (urllib.error.URLError, OSError, ValueError):
        pass
    return result


def _workload_modules():
    """Lazy import of the workload subsystem (open-loop mode only;
    replay.py imports this module, so the import waits for the call)."""
    from butterfly_tpu_torch.workload import arrivals, models, replay
    return models, arrivals, replay


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="load generator for butterfly serve/route "
                    "(closed-loop clients, or open-loop workload/trace "
                    "replay)")
    ap.add_argument("--url", required=True,
                    help="base URL, e.g. http://127.0.0.1:8100")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8,
                    help="requests per client (closed loop)")
    ap.add_argument("--prefix-share", type=float, default=0.5)
    ap.add_argument("--shared-len", type=int, default=32)
    ap.add_argument("--tail-len", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--path", default="/generate")
    ap.add_argument("--timeout", type=float, default=120.0)
    # -- open-loop workload mode ------------------------------------------
    ap.add_argument("--workload", default=None, metavar="NAME",
                    help="OPEN-LOOP mode: generate this canned workload "
                         "(workload/models.py: mixed_chat, uniform) "
                         "and fire it on the --arrival schedule instead "
                         "of running closed-loop clients")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="OPEN-LOOP mode: replay a saved JSONL trace "
                         "(butterfly workload generate / --save) with "
                         "absolute-time fidelity")
    ap.add_argument("--arrival", default=None,
                    help="arrival process: poisson:<rate>"
                         ", burst:<rate_on>:<mean_on_s>:<mean_off_s>"
                         "[:<rate_off>], or ramp:<r0>:<r1>:<ramp_s>. "
                         "With --workload this paces the open-loop "
                         "replay (default poisson:8); in the default "
                         "and --soak modes it switches the client "
                         "lanes from closed-loop to the scheduled "
                         "offered load (e.g. --arrival ramp:2:50:10 "
                         "to ramp pressure on an elastic fleet)")
    ap.add_argument("--n", type=int, default=32,
                    help="total requests to generate for --workload")
    ap.add_argument("--speed", type=float, default=1.0,
                    help="replay time compression: 2.0 fires a trace's "
                         "schedule twice as fast")
    ap.add_argument("--save", default=None, metavar="FILE",
                    help="with --workload: also save the generated "
                         "trace as JSONL before firing it")
    ap.add_argument("--vocab", type=int, default=258,
                    help="workload token-id vocabulary (match the "
                         "model; 258 = tiny/ByteTokenizer)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="workload prefix alignment unit — match the "
                         "server's --page-size so shared prefixes land "
                         "whole pages")
    ap.add_argument("--prompt-lo", type=int, default=32)
    ap.add_argument("--prompt-hi", type=int, default=1024)
    ap.add_argument("--max-new-lo", type=int, default=8)
    ap.add_argument("--max-new-hi", type=int, default=256)
    # -- shared knobs ------------------------------------------------------
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="declared TTFT objective: judge every request "
                         "client-side and report slo_attainment")
    ap.add_argument("--slo-itl-ms", type=float, default=None,
                    help="declared mean inter-token-latency objective "
                         "(per request), judged client-side")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="stamp this latency budget (deadline_ms) on "
                         "every request; the server answers 504 for "
                         "whatever blows it — the summary's outcomes "
                         "dict shows the deadline_504 count")
    ap.add_argument("--priority", choices=["interactive", "batch"],
                    default=None,
                    help="admission class tag: 'batch' is shed first "
                         "when SLO-aware admission is active")
    ap.add_argument("--speculative", choices=["on", "off"], default=None,
                    help="stamp \"speculative\": true/false on every "
                         "request (per-request opt-in/out of draft "
                         "acceptance on a `serve --speculate` replica; "
                         "omit to leave the server default)")
    ap.add_argument("--soak", action="store_true",
                    help="fleet soak mode: roll every replica through "
                         "drain/undrain (discovered via "
                         "/router/replicas) while the load runs; "
                         "requires --url to be a router or fleet "
                         "control plane")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    args = ap.parse_args(argv)
    if args.trace and args.workload:
        ap.error("--trace and --workload are mutually exclusive")
    if args.trace or args.workload:
        if args.soak:
            ap.error("--soak is a closed-loop fleet mode; open-loop "
                     "workload replay does its own pacing")
        models, arrivals, replay = _workload_modules()
        if args.trace:
            _, specs = replay.load_trace(args.trace)
        else:
            wl = models.get_workload(
                args.workload, page_size=args.page_size,
                vocab=args.vocab, prompt_lo=args.prompt_lo,
                prompt_hi=args.prompt_hi, max_new_lo=args.max_new_lo,
                max_new_hi=args.max_new_hi,
                deadline_ms=args.deadline_ms)
            specs = wl.sample(args.n, args.seed)
            arrivals.assign_arrivals(
                specs,
                arrivals.parse_arrival(args.arrival or "poisson:8"),
                args.seed)
            if args.priority is not None:
                for s in specs:
                    s.priority = args.priority
            if args.speculative is not None:
                for s in specs:
                    s.speculative = args.speculative == "on"
            if args.save:
                replay.save_trace(args.save, specs, workload=wl,
                                  arrival=args.arrival or "poisson:8",
                                  seed=args.seed)
        stats = replay.replay_trace(
            args.url, specs, path=args.path, timeout=args.timeout,
            speed=args.speed, slo_ttft_ms=args.slo_ttft_ms,
            slo_itl_ms=args.slo_itl_ms)
    elif args.soak:
        stats = run_fleet_soak(args.url, clients=args.clients,
                               requests_per_client=args.requests,
                               prefix_share=args.prefix_share,
                               shared_len=args.shared_len,
                               tail_len=args.tail_len,
                               max_tokens=args.max_tokens, seed=args.seed,
                               timeout=args.timeout,
                               slo_ttft_ms=args.slo_ttft_ms,
                               slo_itl_ms=args.slo_itl_ms,
                               deadline_ms=args.deadline_ms,
                               priority=args.priority,
                               speculative=(None if args.speculative is None
                                            else args.speculative == "on"),
                               arrival=args.arrival)
    else:
        stats = run_load(args.url, clients=args.clients,
                         requests_per_client=args.requests,
                         prefix_share=args.prefix_share,
                         shared_len=args.shared_len, tail_len=args.tail_len,
                         max_tokens=args.max_tokens, seed=args.seed,
                         path=args.path, timeout=args.timeout,
                         slo_ttft_ms=args.slo_ttft_ms,
                         slo_itl_ms=args.slo_itl_ms,
                         deadline_ms=args.deadline_ms,
                         priority=args.priority,
                         speculative=(None if args.speculative is None
                                      else args.speculative == "on"),
                         arrival=args.arrival)
    if args.json:
        print(json.dumps(stats, indent=2))
    else:
        print(f"sent={stats['sent']} ok={stats['ok']} "
              f"failed={stats['failed']} rps={stats['rps']:.2f}")
        o = stats["outcomes"]
        print(f"outcomes: ok={o['ok']} shed_429={o['shed_429']} "
              f"deadline_504={o['deadline_504']} error={o['error']} "
              f"(terminal {stats['terminal']}/{stats['sent']})")
        print(f"latency p50={stats['latency_p50_s'] * 1e3:.1f}ms "
              f"p95={stats['latency_p95_s'] * 1e3:.1f}ms")
        if stats.get("slo_attainment") is not None:
            print(f"slo attainment={stats['slo_attainment']:.3f} "
                  f"(ttft_ok={stats['slo_ttft_ok']}/{stats['ok']}, "
                  f"itl_ok={stats['slo_itl_ok']}/{stats['ok']})")
        srv = stats.get("server") or {}
        if srv.get("scraped"):
            print(f"server counters: preemptions="
                  f"{srv['serving_preemptions']:.0f} "
                  f"shed={srv['shed_total']:.0f} "
                  f"deadline_expired={srv['deadline_expired_total']:.0f}")
        if stats["by_replica"]:
            print("by replica: " + ", ".join(
                f"{rid}={n}" for rid, n in
                sorted(stats["by_replica"].items())))
        for e in stats["errors"]:
            print(f"error: {e}", file=sys.stderr)
    # sheds and deadline 504s are terminal outcomes the run ASKED for
    # (backpressure working as designed) — only transport errors/hangs
    # and 5xx faults fail the run
    return 0 if stats["outcomes"]["error"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
