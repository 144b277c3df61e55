"""Fleet control plane: the router tier grown KV-aware.

Extends the multi-replica router (router/proxy.py) into the
disaggregated prefill/decode architecture (DistServe OSDI'24 /
Mooncake FAST'25): the compute-bound prefill phase and the
latency-bound decode phase interfere when they share a replica — a
long prompt's prefill stalls every decoding request's next token — so
the control plane runs them on separate replica tiers and streams the
KV state between them by content hash.

Request path (``POST /generate``, token-id body, non-streaming):

1. **classify** — predicted prefill cost = prompt tokens minus the
   tokens expected warm on the decode tier (the affinity ring is the
   predictor: a prefix population routed before has its shared head
   registered on its ring target). Below ``disagg_threshold``, or for
   string prompts (the control plane cannot compute the replicas'
   token-block hashes without a tokenizer), streaming, or
   ``/v1/completions``, the request dispatches DIRECT to the decode
   tier through the inherited router proxy — affinity, failover, and
   the single retry rule all unchanged.
2. **prefill leg** — the request runs on a prefill-role replica with
   ``max_tokens=1``: full prompt prefill + the first token. TTFT is
   measured here, across the handoff.
3. **KV transfer** — the prompt's chain hashes
   (cache/prefix.py:chain_block_hashes — the very keys the replica
   registries use) are exported from the prefill replica
   (``GET /kv/pages``) and imported into the chosen decode replica
   (``POST /kv/import``) verbatim; the pages land warm in its prefix
   registry.
4. **decode leg** — generation resumes on the decode replica with
   prompt = original + first token: admission prefix-hits the imported
   pages and prefills only the partial trailing block, then decodes to
   budget. Greedy outputs are byte-identical to single-replica serving
   (the warm-prefill parity contract).

Every leg degrades safely: a failed export/import just means the
decode replica prefills the whole prompt itself; a failed prefill or
decode leg falls back to a direct dispatch (no client byte has been
sent before the combined response). Correctness never depends on a
transfer landing.

Fleet state: the pool's existing /health probe loop now carries role,
free_pages, and inflight_depth per replica (serve/server.py), so
``GET /fleet/state`` and the placement decision read one table with no
second poll path.

Observability plane (docs/observability.md §fleet tracing):

* every proxied request is traced as control-plane LEG spans (classify,
  prefill_leg, kv_export, kv_import, decode_leg / direct_leg, fallback)
  under an ``X-Request-Id`` the handler mints when the client didn't,
  and forwards on EVERY leg — so each replica's own tracer keys the
  same id. ``GET /fleet/trace?request_id=`` joins the legs with the
  involved replicas' timelines (``/debug/requests?request_id=``) on one
  clock, using the per-replica clock offset the health prober estimates
  from the probe RTT midpoint.
* the prober also scrapes each replica's ``/metrics``;
  ``GET /fleet/metrics`` re-exports the fleet rollup — counters summed,
  histograms re-bucketed exactly (fixed shared ladders), per-replica
  autoscale gauges labeled ``{replica=...}``.
* declared SLOs (``--slo-ttft-ms`` / ``--slo-itl-ms``) are measured
  across the whole handoff into ``fleet_slo_*`` counters and a rolling
  burn-rate gauge.

stdlib-only, like the rest of the router tier. A copy of
butterfly_tpu/fleet/controlplane.py on the port's router, cache/prefix.py
and obs modules.
"""
from __future__ import annotations

import itertools
import json
import socket
import time
import urllib.error
import urllib.request
import uuid
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from butterfly_tpu_torch.cache.prefix import chain_block_hashes
from butterfly_tpu_torch.obs.registry import (
    LATENCY_BUCKETS, MetricsRegistry, render_parsed, sum_expositions)
from butterfly_tpu_torch.obs.ticklog import FlightRecorder
from butterfly_tpu_torch.obs.timeseries import (
    FLEET_TIMESERIES_SCHEMA, default_fleet_rules, evaluate_rules)
from butterfly_tpu_torch.obs.trace import Tracer, merge_fleet_trace
from butterfly_tpu_torch.router.policy import (PrefixAffinityPolicy,
                                               affinity_key)
from butterfly_tpu_torch.router.pool import Replica, ReplicaPool
from butterfly_tpu_torch.router.proxy import (
    RouterState, extract_route_tokens, make_router_handler)


class ControlPlaneState(RouterState):
    """RouterState plus the disaggregation planner's knobs and the
    fleet_* instrument families."""

    def __init__(self, pool: ReplicaPool, policy: PrefixAffinityPolicy,
                 registry: Optional[MetricsRegistry] = None,
                 read_timeout: float = 300.0,
                 disagg_threshold: int = 64,
                 handoff_timeout: float = 60.0,
                 slo_ttft_s: Optional[float] = None,
                 slo_itl_s: Optional[float] = None,
                 tracer: Optional[Tracer] = None,
                 chaos=None):
        super().__init__(pool, policy, registry=registry,
                         read_timeout=read_timeout)
        self.page_size = policy.page_size
        # Optional seeded fault plan (fleet/chaos.py ChaosPlan): _call
        # consults it before every handoff leg, so network faults
        # between control plane and replicas are injectable with the
        # same determinism as the replica-side hooks. None = no chaos.
        self.chaos = chaos
        # Control-plane tracer: every proxied request gets a timeline of
        # LEG spans (classify, prefill_leg, kv_export, kv_import,
        # decode_leg, direct_leg, fallback) keyed by the same
        # X-Request-Id the replicas trace under — GET /fleet/trace
        # joins them into one cross-replica waterfall. Tracer's internal
        # lock makes it safe for the handler threads.
        self.tracer = tracer if tracer is not None else Tracer()
        self._trace_ids = itertools.count()
        # declared latency objectives, measured ACROSS the handoff (the
        # latency the client sees, not any single replica's view)
        self.slo_ttft_s = slo_ttft_s
        self.slo_itl_s = slo_itl_s
        self._slo_window: deque = deque(maxlen=256)
        # predicted FRESH prefill tokens at which a request is worth
        # the handoff (two extra HTTP round trips + the page bytes)
        self.disagg_threshold = max(1, int(disagg_threshold))
        self.handoff_timeout = handoff_timeout
        # prefix populations seen before (affinity key -> True),
        # bounded LRU: the shared head of a repeat population is
        # expected warm on its ring target, shrinking the predicted
        # prefill cost so repeat traffic stays on the decode tier
        self._seen: "OrderedDict[bytes, bool]" = OrderedDict()
        self._seen_cap = 4096
        reg = self.registry
        self._c_disagg = reg.counter(
            "fleet_disagg_requests_total",
            "Requests served via the prefill->transfer->decode handoff")
        self._c_direct = reg.counter(
            "fleet_direct_requests_total",
            "Requests dispatched directly to the decode tier")
        self._c_fallback = reg.counter(
            "fleet_disagg_fallbacks_total",
            "Handoffs that fell back to a direct dispatch mid-flight "
            "(prefill leg, transfer, or decode leg failed)")
        self._c_xfer_bytes = reg.counter(
            "fleet_kv_transfer_bytes_total",
            "Raw KV page bytes exported across replicas")
        self._c_xfer_pages = reg.counter(
            "fleet_kv_transfer_pages_total",
            "KV pages landed into decode-tier prefix registries")
        self._c_xfer_hits = reg.counter(
            "fleet_kv_transfer_hits_total",
            "Requested chain hashes the prefill replica had registered")
        self._c_xfer_miss = reg.counter(
            "fleet_kv_transfer_misses_total",
            "Requested chain hashes missing at export (evicted or "
            "never registered) — the decode replica prefills those "
            "blocks itself")
        self._h_ttft = reg.histogram(
            "fleet_ttft_seconds",
            "Control-plane TTFT for disaggregated requests: client "
            "arrival to the prefill leg's first token, across the "
            "handoff", LATENCY_BUCKETS)
        self._c_slo_ttft_ok = reg.counter(
            "fleet_slo_ttft_ok_total",
            "Disaggregated requests whose cross-handoff TTFT met the "
            "declared objective (--slo-ttft-ms on the route CLI)")
        self._c_slo_itl_ok = reg.counter(
            "fleet_slo_itl_ok_total",
            "Disaggregated requests whose mean inter-token gap met the "
            "declared ITL objective")
        self._c_slo_viol = reg.counter_family(
            "fleet_slo_violations_total",
            "Disaggregated requests that missed a declared latency "
            "objective, by objective kind", ("kind",))
        self._g_slo_burn = reg.gauge(
            "fleet_slo_burn_rate",
            "Fraction of the last 256 disaggregated requests that "
            "violated ANY declared objective")
        # classified handoff-leg failures: one
        # series per (leg, kind) instead of a bare except bucket —
        # a dashboard can tell a timing-out prefill tier from a
        # decode tier returning garbage
        self._c_leg_fail = reg.counter_family(
            "fleet_leg_failures_total",
            "Handoff-leg failures by leg (prefill_leg/kv_export/"
            "kv_import/decode_leg) and kind (timeout/refused/"
            "bad_status/bad_body/chaos)", ("leg", "kind"))
        self._c_deadline = reg.counter_family(
            "fleet_deadline_expired_total",
            "Requests whose deadline budget expired at the control "
            "plane, by where (arrival, or the handoff leg about to "
            "run)", ("where",))
        # Control-plane anomaly flight recorder: records the
        # fleet-level event classes the replicas can't see — breaker
        # transitions and control-plane deadline 504s — and joins the
        # per-replica rings at GET /fleet/flightrecorder (events
        # shifted onto this process's clock by the health-probe offset,
        # exactly like the fleet trace merge).
        self.flightrec = FlightRecorder()
        pool.on_breaker_open = lambda rid: self.flightrec.note(
            "breaker", replica=rid, transition="open")
        # Per-replica alert rules over the scrape-derived gauge history
        #: rules are STATEFUL (rising-edge latch), so each
        # replica gets its own set, built lazily at its first probe.
        # The pool calls the hook outside its lock after every probe;
        # fired alerts land in this flight recorder as `alert` events
        # with the surrounding series attached.
        self._replica_rules: Dict[str, list] = {}
        pool.on_series_sample = self._on_series_sample

    def _on_series_sample(self, rid: str, tail: list,
                          missed: int) -> None:
        rules = self._replica_rules.get(rid)
        if rules is None:
            rules = self._replica_rules[rid] = default_fleet_rules()
        evaluate_rules(rules, tail, flightrec=self.flightrec,
                       source=rid, missing=missed)

    # -- planning -----------------------------------------------------------

    def direct_plan(self, tokens) -> Tuple[List[Replica], Optional[str]]:
        """Decode-tier candidates (any-role fallback when the decode
        tier is empty/unroutable — a degraded fleet still serves)."""
        cands, aff = self.policy.plan(tokens, role="decode")
        if not cands:
            cands, aff = self.policy.plan(tokens)
        return cands, aff

    def predicted_cost(self, ids: List[int]) -> int:
        """Predicted FRESH prefill tokens: prompt length minus the
        shared head expected warm on the decode tier (affinity-ring
        populations seen before). A heuristic, deliberately cheap —
        misprediction costs only placement, never correctness."""
        key = affinity_key(ids, self.page_size, self.policy.affinity_blocks)
        warm = 0
        with self._mlock:
            seen = key is not None and key in self._seen
            if seen:
                self._seen.move_to_end(key)
        if seen:
            warm = min((len(ids) - 1) // self.page_size,
                       self.policy.affinity_blocks) * self.page_size
        return len(ids) - warm

    def note_seen(self, ids: List[int]) -> None:
        key = affinity_key(ids, self.page_size, self.policy.affinity_blocks)
        if key is None:
            return
        with self._mlock:
            self._seen[key] = True
            self._seen.move_to_end(key)
            while len(self._seen) > self._seen_cap:
                self._seen.popitem(last=False)

    def observe(self, hist, v: float) -> None:
        with self._mlock:
            hist.observe(v)

    def add(self, counter, n: float) -> None:
        """Locked multi-increment (instruments are multi-writer here —
        handler threads — like every RouterState update)."""
        with self._mlock:
            counter.inc(n)

    def record_leg_failure(self, leg: str, kind: str) -> None:
        with self._mlock:
            self._c_leg_fail.labels(leg, kind).inc()

    def record_deadline(self, where: str) -> None:
        with self._mlock:
            self._c_deadline.labels(where).inc()
        self.flightrec.note("deadline_504", where=where)
        # expiry-burst trigger: the control plane sees spent-budget
        # storms the replicas never receive (504 before any leg runs)
        self.flightrec.poll({"deadline_expired_total": sum(
            c.value for c in self._c_deadline._children.values())})

    def fleet_counters(self) -> Dict[str, float]:
        hits = self._c_xfer_hits.value
        miss = self._c_xfer_miss.value
        return {
            "disagg_requests": self._c_disagg.value,
            "direct_requests": self._c_direct.value,
            "disagg_fallbacks": self._c_fallback.value,
            "kv_transfer_bytes": self._c_xfer_bytes.value,
            "kv_transfer_pages": self._c_xfer_pages.value,
            "kv_transfer_hits": hits,
            "kv_transfer_misses": miss,
            "kv_transfer_hit_rate":
                hits / (hits + miss) if hits + miss else 0.0,
            "leg_failures": sum(
                c.value for c in self._c_leg_fail._children.values()),
            "deadline_expired": sum(
                c.value for c in self._c_deadline._children.values()),
            "breaker_opens": self.pool.breaker_opens_total(),
        }

    def fleet_state(self) -> Dict:
        """The GET /fleet/state body: per-replica placement signals
        (role, liveness, queue depth, page headroom, pipeline depth —
        all from the ONE /health probe loop), the tier membership view
        the planner routes by, and the fleet counters."""
        snaps = self.pool.snapshot()
        tiers = {
            tier: [s["replica"] for s in snaps
                   if s["role"] in (tier, "both")]
            for tier in ("prefill", "decode")
        }
        out = {"replicas": snaps, "tiers": tiers,
               "disagg_threshold": self.disagg_threshold,
               "slo": {"ttft_s": self.slo_ttft_s,
                       "itl_s": self.slo_itl_s},
               "metrics": self.fleet_counters()}
        if self.chaos is not None:
            out["chaos"] = self.chaos.summary()
        return out

    # -- distributed tracing ------------------------------------------------

    def begin_trace(self, request_id: str, **attrs) -> int:
        """Open a control-plane timeline for one proxied request; the
        returned tid keys this handler's span events. The client
        request id is the cross-replica join key."""
        tid = next(self._trace_ids)
        self.tracer.begin_request(tid, request_id=request_id, **attrs)
        return tid

    def observe_slo(self, ttft_s: Optional[float],
                    itl_mean_s: Optional[float]) -> Dict[str, bool]:
        """Record one disaggregated request's attainment against the
        declared objectives; returns the per-objective verdicts (empty
        when no objective is declared)."""
        out: Dict[str, bool] = {}
        if self.slo_ttft_s is None and self.slo_itl_s is None:
            return out
        viol = False
        with self._mlock:
            if self.slo_ttft_s is not None:
                ok = ttft_s is not None and ttft_s <= self.slo_ttft_s
                out["slo_ttft_ok"] = ok
                (self._c_slo_ttft_ok.inc() if ok
                 else self._c_slo_viol.labels("ttft").inc())
                viol |= not ok
            if self.slo_itl_s is not None and itl_mean_s is not None:
                ok = itl_mean_s <= self.slo_itl_s
                out["slo_itl_ok"] = ok
                (self._c_slo_itl_ok.inc() if ok
                 else self._c_slo_viol.labels("itl").inc())
                viol |= not ok
            self._slo_window.append(1.0 if viol else 0.0)
            self._g_slo_burn.set(sum(self._slo_window)
                                 / len(self._slo_window))
        return out

    def assemble_trace(self, request_id: str) -> Optional[Dict]:
        """The GET /fleet/trace body: this control plane's leg spans for
        `request_id`, joined with every involved replica's own timeline
        (fetched via /debug/requests?request_id=) on ONE clock — each
        replica's monotonic events convert to its wall clock via its
        tracer anchors, then shift by the health-probe clock-offset
        estimate. A replica that is down (or restarted with a fresh
        tracer) degrades to control-plane spans only, with its error
        recorded under `sources`."""
        tl = self.tracer.find_by_request_id(request_id)
        if tl is None:
            return None
        rids: List[str] = []
        for ev in tl["events"]:
            rid = ev.get("replica")
            if rid and rid not in rids:
                rids.append(rid)
        replicas: Dict[str, Dict] = {}
        for rid in rids:
            rep = self.pool.get(rid)
            info: Dict = {"offset_s": rep.clock_offset if rep else None}
            try:
                url = (f"http://{rep.host}:{rep.port}/debug/requests"
                       f"?request_id={request_id}") if rep else None
                if url is None:
                    raise LookupError(f"unknown replica {rid}")
                # the pool's probe timeout governs every control-plane
                # side channel — one knob, no stray hard-coded 5.0
                with urllib.request.urlopen(
                        url, timeout=self.pool.probe_timeout) as resp:
                    info["dump"] = json.loads(resp.read() or b"{}")
            except Exception as e:  # down/restarting: degrade, never 500
                info["dump"] = None
                info["error"] = f"{type(e).__name__}: {e}"
            replicas[rid] = info
        return merge_fleet_trace(
            request_id,
            {"timeline": tl, "t0_wall": self.tracer.t0_wall,
             "t0_monotonic": self.tracer.t0_monotonic},
            replicas)

    # -- fleet metrics rollup -----------------------------------------------

    #: replica flat-dict gauges re-exported per replica from the scrape
    #: (the autoscale signal surface ROADMAP item 3 reads); everything
    #: else gauge-typed is dropped from the rollup — summing uptimes or
    #: queue-depth snapshots across replicas is not a meaningful series.
    AUTOSCALE_GAUGES = ("queue_depth", "active_requests", "kv_pages_free",
                        "kv_pages_total", "inflight_depth",
                        "tokens_per_sec", "device_bubble_p50",
                        "device_bubble_p95", "slo_burn_rate",
                        # tick anatomy: host-bound vs
                        # device-bound per replica — an autoscaler that
                        # only sees queue depth can't tell which tier
                        # needs more replicas vs a faster host path
                        "tick_host_frac", "tick_phase_dominant_p95",
                        # host KV tier: revive economics per
                        # replica — absent on tier-less replicas (the
                        # re-export skips absent gauges)
                        "kv_tier_hit_rate")

    #: consecutive failed /metrics scrapes after which a replica's
    #: re-exported gauges are DROPPED from /fleet/metrics: a gauge
    #: frozen at its last good value reads as a live flat line to an
    #: autoscaler, which is worse than an absent series. Counters keep
    #: the last good scrape through the outage (a sum that briefly
    #: under-counts then catches up is the normal counter contract).
    SCRAPE_STALE_AFTER = 3

    def fleet_metrics_text(self) -> str:
        """The GET /fleet/metrics body: one exposition aggregating every
        replica's last-scraped /metrics. Counters sum; histograms sum
        bucket-wise (exact — the registry's fixed ladders are identical
        across replicas, and mismatched ladders are dropped rather than
        mis-summed); per-replica autoscale gauges ride along labeled
        {replica="host:port"}. Replica families re-export namespaced
        butterfly_fleet_*."""
        by_rid = self.pool.metrics_by_replica()
        agg = sum_expositions(list(by_rid.values()))

        def rename(name: str) -> str:
            return name.replace("butterfly_", "butterfly_fleet_", 1) \
                if name.startswith("butterfly_") else "fleet_" + name

        lines = render_parsed(agg, rename=rename)
        lines.append("# HELP butterfly_fleet_replicas_scraped Replicas "
                     "contributing to this rollup (last /metrics scrape "
                     "retained through transient failures)")
        lines.append("# TYPE butterfly_fleet_replicas_scraped gauge")
        lines.append(f"butterfly_fleet_replicas_scraped {len(by_rid)}")
        # per-replica autoscale gauges, from each replica's own scrape —
        # minus replicas whose scrapes have been failing (stale-gauge
        # drop: see SCRAPE_STALE_AFTER)
        stale = set(self.pool.stale_scrapes(self.SCRAPE_STALE_AFTER))
        per_rep: Dict[str, List[Tuple[str, float]]] = {}
        for rid, families in sorted(by_rid.items()):
            if rid in stale:
                continue
            for key in self.AUTOSCALE_GAUGES:
                fam = families.get(f"butterfly_{key}")
                if not fam:
                    continue
                v = fam["samples"].get((f"butterfly_{key}", ()))
                if v is not None:
                    per_rep.setdefault(key, []).append((rid, v))
        for key, samples in sorted(per_rep.items()):
            full = f"butterfly_fleet_replica_{key}"
            lines.append(f"# TYPE {full} gauge")
            lines.extend(f'{full}{{replica="{rid}"}} {v:g}'
                         for rid, v in samples)
        return "\n".join(lines) + ("\n" if lines else "")

    # -- fleet flight-recorder rollup ---------------------------------------

    def flightrecorder_rollup(self) -> Dict:
        """The GET /fleet/flightrecorder body: this control plane's own
        anomaly ring (breaker transitions, control-plane 504s) merged
        with every replica's /debug/flightrecorder dump on ONE clock —
        each replica's wall-clock event stamps shift by the clock
        offset the health prober estimated (the trace-merge
        timeline), so a fleet-wide anomaly reads as one ordered story.
        Unreachable replicas degrade to an error entry, never a 500."""
        sources: Dict[str, Dict] = {}
        merged: List[Dict] = []
        dumps: List[Dict] = []

        def absorb(src: str, dump: Dict, offset: float) -> None:
            evs = []
            for ev in dump.get("events", ()):
                ev2 = dict(ev)
                ev2["source"] = src
                ev2["t_fleet"] = float(ev.get("t_wall", 0.0)) - offset
                evs.append(ev2)
            merged.extend(evs)
            for art in dump.get("dumps", ()):
                dumps.append({"source": src, "offset_s": offset, **art})
            sources[src] = {"events": len(evs),
                            "dumps": len(dump.get("dumps", ())),
                            "offset_s": offset,
                            "triggers_fired":
                                dump.get("triggers_fired", {})}

        absorb("control", self.flightrec.dump(), 0.0)
        for snap in self.pool.snapshot():
            rid = snap["replica"]
            offset = snap.get("clock_offset_s") or 0.0
            try:
                url = f"http://{rid}/debug/flightrecorder"
                with urllib.request.urlopen(
                        url, timeout=self.pool.probe_timeout) as resp:
                    dump = json.loads(resp.read() or b"{}")
            except Exception as e:  # down/restarting: degrade
                sources[rid] = {"events": 0, "missing": True,
                                "error": f"{type(e).__name__}: {e}"}
                continue
            if not dump.get("enabled"):
                sources[rid] = {"events": 0, "enabled": False}
                continue
            absorb(rid, dump, offset)
        merged.sort(key=lambda ev: ev["t_fleet"])
        return {"sources": sources, "events": merged, "dumps": dumps}

    # -- fleet timeseries rollup --------------------------------------------

    def fleet_timeseries(self) -> Dict:
        """The GET /fleet/timeseries body: every replica's signal
        history merged on ONE clock. Two sample populations per
        replica, both tagged with their source:

        * ``scrape:<rid>`` — the pool's scrape-derived gauge ring,
          stamped on THIS process's wall clock at the probe RTT
          midpoint (offset zero by construction);
        * ``<rid>`` — the replica's own /debug/timeseries dump, its
          wall stamps shifted by the health prober's clock-offset
          estimate (the trace-merge timeline).

        Alert events ride along: each replica dump's fired alerts plus
        the control plane's own `alert` flight-recorder events (the
        per-replica flatline/slope rules). Unreachable replicas degrade
        to an error entry, never a 500."""
        sources: Dict[str, Dict] = {}
        merged: List[Dict] = []
        alerts: List[Dict] = []

        def absorb(src: str, samples, offset: float) -> None:
            n = 0
            for s in samples:
                s2 = dict(s)
                s2["source"] = src
                s2["t_fleet"] = float(s.get("t_wall", 0.0)) - offset
                merged.append(s2)
                n += 1
            sources[src] = {"samples": n, "offset_s": offset}

        for rid, ring in sorted(self.pool.series_by_replica().items()):
            absorb(f"scrape:{rid}", ring, 0.0)
        for snap in self.pool.snapshot():
            rid = snap["replica"]
            offset = snap.get("clock_offset_s") or 0.0
            try:
                url = f"http://{rid}/debug/timeseries"
                with urllib.request.urlopen(
                        url, timeout=self.pool.probe_timeout) as resp:
                    dump = json.loads(resp.read() or b"{}")
            except Exception as e:  # down/restarting: degrade
                sources[rid] = {"samples": 0, "missing": True,
                                "error": f"{type(e).__name__}: {e}"}
                continue
            if not dump.get("enabled"):
                sources[rid] = {"samples": 0, "enabled": False}
                continue
            absorb(rid, dump.get("samples", ()), offset)
            for a in dump.get("alerts", ()):
                a2 = dict(a)
                a2.setdefault("source", rid)
                a2["t_fleet"] = float(a.get("t_wall", 0.0)) - offset
                alerts.append(a2)
        for ev in self.flightrec.dump().get("events", ()):
            if ev.get("kind") == "alert":
                a2 = dict(ev)
                a2.setdefault("source", "control")
                a2["t_fleet"] = float(ev.get("t_wall", 0.0))
                alerts.append(a2)
        merged.sort(key=lambda s: s["t_fleet"])
        alerts.sort(key=lambda a: a["t_fleet"])
        return {"schema": FLEET_TIMESERIES_SCHEMA, "sources": sources,
                "samples": merged, "alerts": alerts}


def make_fleet_handler(state: ControlPlaneState):
    """The control-plane HTTP handler: the router handler (proxy,
    admin drain/undrain, /metrics, /router/replicas) plus /fleet/state
    and the disaggregated dispatch path."""
    Base = make_router_handler(state)

    class FleetHandler(Base):

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/fleet/state":
                self._json(200, state.fleet_state())
            elif path == "/fleet/trace":
                self._fleet_trace()
            elif path == "/fleet/flightrecorder":
                self._json(200, state.flightrecorder_rollup())
            elif path == "/debug/flightrecorder":
                # the control plane's OWN ring (breaker opens, deadline
                # 504s, autoscaler scale/scale_held decisions) — same
                # shape a replica serves under this path
                self._json(200, state.flightrec.dump())
            elif path == "/fleet/timeseries":
                self._json(200, state.fleet_timeseries())
            elif path == "/fleet/metrics":
                body = state.fleet_metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                Base.do_GET(self)

        def _fleet_trace(self) -> None:
            from urllib.parse import parse_qs, urlparse
            qs = parse_qs(urlparse(self.path).query)
            rid = qs.get("request_id", [None])[0]
            if not rid:
                self._json(400, {"error": "missing ?request_id= (the "
                                          "X-Request-Id / request_id the "
                                          "request was tagged with)"})
                return
            merged = state.assemble_trace(str(rid)[:128])
            if merged is None:
                self._json(404, {"error": f"no control-plane timeline "
                                          f"for request_id {rid!r} "
                                          f"(evicted or never seen)"})
            else:
                self._json(200, merged)

        # -- classification ---------------------------------------------------

        def _ensure_request_id(self, obj) -> str:
            """The distributed trace id: client header wins, then a
            request_id body field, else one is minted. Injected into
            self.headers so the inherited proxy forwards it on direct
            dispatches — every replica then traces under the SAME id
            the control plane does."""
            rid = self.headers.get("X-Request-Id") \
                or (obj.get("request_id") if isinstance(obj, dict)
                    else None)
            rid = str(rid)[:128] if rid else \
                f"fleet-{uuid.uuid4().hex[:12]}"
            if self.headers.get("X-Request-Id") != rid:
                del self.headers["X-Request-Id"]
                self.headers["X-Request-Id"] = rid
            return rid

        def _ensure_deadline(self, obj, t_arrive: float) -> Optional[float]:
            """The request's latency budget as an ABSOLUTE monotonic
            deadline: X-Deadline-Ms header wins, then a deadline_ms
            body field. The value is the REMAINING budget at this hop —
            every forward re-stamps the header with what's left, so the
            budget is consumed across the whole fleet path, not reset
            per process. Malformed values pass through untouched (the
            replica 400s them)."""
            dl = self.headers.get("X-Deadline-Ms")
            if dl is None and isinstance(obj, dict):
                dl = obj.get("deadline_ms")
            if dl is None:
                return None
            try:
                return t_arrive + float(dl) / 1e3
            except (TypeError, ValueError):
                return None

        def _restamp_deadline(self, deadline_s: Optional[float]) -> None:
            """Refresh X-Deadline-Ms to the remaining budget before the
            inherited direct-dispatch proxy forwards the headers."""
            if deadline_s is None:
                return
            rem = max(1, int((deadline_s - time.monotonic()) * 1e3))
            del self.headers["X-Deadline-Ms"]
            self.headers["X-Deadline-Ms"] = str(rem)

        def _deadline_504(self, tid: int, request_id: str,
                          t_arrive: float, where: str,
                          detail: Optional[dict] = None) -> None:
            """Terminal deadline verdict: 504 with where-it-died +
            elapsed, counted and traced. `detail` merges a downstream
            504 body (the replica's own where/elapsed) when the expiry
            happened there."""
            state.record_deadline(where)
            elapsed = time.monotonic() - t_arrive
            state.tracer.event(tid, "finish", state="deadline_expired",
                               where=where, total_s=elapsed)
            body = {"error": "deadline exceeded", "where": where,
                    "elapsed_ms": elapsed * 1e3,
                    "request_id": request_id}
            for k in ("where", "elapsed_ms", "deadline_ms"):
                if detail and k in detail:
                    body[k] = detail[k]
            self._json(504, body)

        def _proxy(self, path: str) -> None:
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
            except (ValueError, OSError):
                self._json(400, {"error": "unreadable body"})
                return
            try:
                obj = json.loads(body or b"{}")
            except (ValueError, UnicodeDecodeError):
                obj = None
            t_arrive = time.monotonic()
            request_id = self._ensure_request_id(obj)
            deadline_s = self._ensure_deadline(obj, t_arrive)
            ids = self._token_ids(obj)
            tid = state.begin_trace(request_id, path=path,
                                    prompt_len=len(ids) if ids else None)
            if deadline_s is not None and t_arrive >= deadline_s:
                # arrived with a spent budget: terminal 504 here — it
                # must not burn a classify, a handoff, or a queue slot
                self._deadline_504(tid, request_id, t_arrive, "arrival")
                return
            plan = self._disagg_plan(path, obj, ids)
            state.tracer.event(
                tid, "classify", dur_s=time.monotonic() - t_arrive,
                decision="disagg" if plan else "direct",
                predicted_cost=state.predicted_cost(ids) if ids else None,
                threshold=state.disagg_threshold)
            if plan is None:
                state.inc(state._c_direct)
                if ids:
                    state.note_seen(ids)
                route_tokens = extract_route_tokens(body)
                self._restamp_deadline(deadline_s)
                t0 = time.monotonic()
                served = self._dispatch(path, body,
                                        *state.direct_plan(route_tokens))
                state.tracer.event(tid, "direct_leg",
                                   dur_s=time.monotonic() - t0,
                                   replica=served,
                                   status="ok" if served else "failed")
                state.tracer.event(tid, "finish", state="direct",
                                   total_s=time.monotonic() - t_arrive)
                return
            pre, dec = plan
            self._disaggregate(obj, ids, pre, dec, tid=tid,
                               request_id=request_id, t_arrive=t_arrive,
                               deadline_s=deadline_s)

        def _token_ids(self, obj) -> Optional[List[int]]:
            """Explicit token ids only: a string prompt would hash its
            UTF-8 bytes, which can never match the replicas'
            tokenized page blocks — such requests route direct."""
            if not isinstance(obj, dict):
                return None
            ids = obj.get("tokens")
            if ids is None and isinstance(obj.get("prompt"), list):
                ids = obj["prompt"]
            if not isinstance(ids, list) or not ids:
                return None
            try:
                return [int(t) for t in ids]
            except (ValueError, TypeError):
                return None

        def _disagg_plan(self, path, obj, ids
                         ) -> Optional[Tuple[Replica, Replica]]:
            """(prefill replica, decode replica) when the handoff is
            worth it, else None -> direct dispatch."""
            if path != "/generate" or not isinstance(obj, dict) \
                    or obj.get("stream") or ids is None:
                return None
            if len(ids) < state.page_size + 1:
                return None  # no full page to transfer
            if state.predicted_cost(ids) < state.disagg_threshold:
                return None
            dec_cands, _ = state.policy.plan(ids, role="decode")
            pre_cands, _ = state.policy.plan(ids, role="prefill")
            if not dec_cands or not pre_cands:
                return None
            dec = dec_cands[0]
            # a handoff to yourself is just a slower direct dispatch
            pre = next((r for r in pre_cands if r.rid != dec.rid), None)
            if pre is None:
                return None
            return pre, dec

        # -- the handoff ------------------------------------------------------

        @staticmethod
        def _transport_kind(e) -> str:
            """Classify a transport failure for the
            fleet_leg_failures_total{leg,kind} family."""
            import http.client
            reason = getattr(e, "reason", None)
            if isinstance(e, (socket.timeout, TimeoutError)) \
                    or isinstance(reason, (socket.timeout, TimeoutError)):
                return "timeout"
            if isinstance(e, http.client.IncompleteRead) \
                    or isinstance(reason, http.client.IncompleteRead):
                return "bad_body"  # died mid-body (truncated response)
            return "refused"  # refused / reset / garbled status line

        def _call(self, rep: Replica, method: str, path: str,
                  obj=None, timeout: Optional[float] = None,
                  request_id: Optional[str] = None, leg: str = "leg",
                  deadline_s: Optional[float] = None):
            """One control-plane HTTP call with pool feedback. Returns
            (status, parsed body) — status None on transport failure.
            `request_id` rides as X-Request-Id so the replica's tracer
            (and its kv-transfer error bodies) key the same distributed
            request the control plane is tracing. `leg` names the
            handoff leg for the classified
            fleet_leg_failures_total{leg,kind} accounting (timeout vs
            refused vs bad_status vs bad_body), which also feeds the
            pool's per-replica circuit breaker. `deadline_s` (absolute
            monotonic) caps the socket timeout at the remaining budget
            and forwards it as X-Deadline-Ms so the replica re-anchors
            the budget at its own arrival."""
            url = f"http://{rep.host}:{rep.port}{path}"
            data = json.dumps(obj).encode() if obj is not None else None
            headers = {"Content-Type": "application/json"}
            if request_id:
                headers["X-Request-Id"] = request_id
            tmo = timeout or state.read_timeout
            if deadline_s is not None:
                rem = deadline_s - time.monotonic()
                headers["X-Deadline-Ms"] = str(max(1, int(rem * 1e3)))
                tmo = min(tmo, max(1e-3, rem))
            if state.chaos is not None:
                from butterfly_tpu_torch.fleet.chaos import ChaosIdent
                inj = state.chaos.decide(
                    ChaosIdent(rid=rep.rid, role=rep.role), path,
                    where="call")
                if inj is not None:
                    if inj.kind == "delay":
                        time.sleep(inj.delay_s)
                    else:
                        # every non-delay call-scope fault is "the leg
                        # never produced a usable response" — fail it
                        # through the SAME accounting a real refused
                        # connect takes (pool liveness, breaker, leg
                        # counter), so chaos exercises the real paths
                        err = f"chaos: injected {inj.kind}"
                        state.record_leg_failure(leg, "chaos")
                        state.pool.note_connect_failure(rep.rid, err)
                        state.pool.note_leg_failure(rep.rid, err)
                        return None, {"error": err}
            req = urllib.request.Request(
                url, data=data, method=method, headers=headers)
            state.pool.note_dispatch(rep.rid)
            try:
                with urllib.request.urlopen(req, timeout=tmo) as resp:
                    status, raw = resp.status, resp.read()
            except urllib.error.HTTPError as e:
                try:
                    body = json.loads(e.read() or b"{}")
                except (ValueError, OSError):
                    body = {}
                e.close()
                if e.code == 503:
                    state.pool.note_wedged(rep.rid, "503 during handoff")
                if e.code >= 500 and e.code != 504:
                    # 5xx = the replica failed the leg (504 is the
                    # request's OWN deadline verdict, not replica
                    # health — it must not trip the breaker)
                    state.record_leg_failure(leg, "bad_status")
                    state.pool.note_leg_failure(rep.rid, f"http {e.code}")
                else:
                    state.pool.note_leg_ok(rep.rid)
                return e.code, body
            except Exception as e:  # refused / reset / timeout
                kind = self._transport_kind(e)
                state.record_leg_failure(leg, kind)
                state.pool.note_connect_failure(rep.rid, str(e))
                state.pool.note_leg_failure(rep.rid, str(e))
                return None, {"error": str(e)}
            finally:
                state.pool.note_done(rep.rid)
            try:
                body = json.loads(raw or b"{}")
            except (ValueError, UnicodeDecodeError) as e:
                # a 200 whose body doesn't parse: the replica (or the
                # network) corrupted the leg — distinct failure kind
                state.record_leg_failure(leg, "bad_body")
                state.pool.note_leg_failure(rep.rid, f"bad body: {e}")
                return None, {"error": f"bad body: {e}"}
            state.pool.note_leg_ok(rep.rid)
            return status, body

        def _fallback(self, obj, ids, tid, t_arrive, reason,
                      request_id: str = "",
                      deadline_s: Optional[float] = None) -> None:
            """A handoff leg failed before any client byte: re-dispatch
            the ORIGINAL request direct (the decode replica recomputes
            the whole prompt — slower, never wrong). A spent deadline
            short-circuits to 504 instead: re-running the prompt for a
            client that already missed its budget is pure waste."""
            if deadline_s is not None and time.monotonic() >= deadline_s:
                self._deadline_504(tid, request_id, t_arrive, "fallback")
                return
            state.inc(state._c_fallback)
            state.tracer.event(tid, "fallback", reason=reason)
            body = json.dumps(obj).encode()
            self._restamp_deadline(deadline_s)
            t0 = time.monotonic()
            served = self._dispatch("/generate", body,
                                    *state.direct_plan(ids))
            state.tracer.event(tid, "direct_leg",
                               dur_s=time.monotonic() - t0,
                               replica=served,
                               status="ok" if served else "failed")
            state.tracer.event(tid, "finish", state="fallback",
                               total_s=time.monotonic() - t_arrive)

        def _disaggregate(self, obj: dict, ids: List[int],
                          pre: Replica, dec: Replica, tid: int,
                          request_id: str, t_arrive: float,
                          deadline_s: Optional[float] = None) -> None:
            t0 = t_arrive  # TTFT/total measure from client arrival
            state.inc(state._c_disagg)
            max_tokens = int(obj.get("max_tokens",
                                     obj.get("max_new_tokens", 64)))
            # 1. prefill leg: full prompt + first token on the prefill tier
            a_req = {"tokens": ids, "max_tokens": 1,
                     "request_id": request_id}
            for k in ("temperature", "stop_token", "priority"):
                if k in obj:
                    a_req[k] = obj[k]
            t_leg = time.monotonic()
            code, a = self._call(pre, "POST", "/generate", a_req,
                                 timeout=state.handoff_timeout,
                                 request_id=request_id, leg="prefill_leg",
                                 deadline_s=deadline_s)
            state.tracer.event(tid, "prefill_leg",
                               dur_s=time.monotonic() - t_leg,
                               replica=pre.rid,
                               status="ok" if code == 200 else f"{code}")
            if code == 504:
                # the replica's own deadline verdict: propagate, never
                # fall back — a re-prefill for a blown budget is waste
                self._deadline_504(tid, request_id, t_arrive,
                                   "prefill_leg", detail=a)
                return
            if code != 200 or not a.get("tokens"):
                self._fallback(obj, ids, tid, t_arrive,
                               f"prefill leg {code}",
                               request_id=request_id,
                               deadline_s=deadline_s)
                return
            ttft = time.monotonic() - t0
            state.observe(state._h_ttft, ttft)
            first = [int(t) for t in a["tokens"]]
            # 2. KV transfer: the prompt's full-page chain, A -> B.
            # Failures are absorbed — B prefills uncovered blocks itself.
            imported = 0
            hashes = [h.hex() for h in chain_block_hashes(ids,
                                                          state.page_size)]
            if hashes and not (deadline_s is not None
                               and time.monotonic() >= deadline_s):
                # transfer is an optimization: with a spent budget it
                # is simply skipped (the 504 verdict comes from the
                # decode leg below, which owns the terminal response)
                t_leg = time.monotonic()
                code, exp = self._call(
                    pre, "GET", "/kv/pages?hashes=" + ",".join(hashes),
                    timeout=state.handoff_timeout, request_id=request_id,
                    leg="kv_export", deadline_s=deadline_s)
                n_pages = len(exp.get("pages", ())) if code == 200 else 0
                state.tracer.event(
                    tid, "kv_export", dur_s=time.monotonic() - t_leg,
                    replica=pre.rid, pages=n_pages,
                    bytes=int(exp.get("bytes", 0)) if code == 200 else 0,
                    status="ok" if code == 200 else f"{code}")
                if code == 200:
                    state.add(state._c_xfer_hits, n_pages)
                    state.add(state._c_xfer_miss,
                              len(exp.get("missing", ())))
                    state.add(state._c_xfer_bytes,
                              int(exp.get("bytes", 0)))
                    if n_pages:
                        t_leg = time.monotonic()
                        code, imp = self._call(dec, "POST", "/kv/import",
                                               exp,
                                               timeout=state.handoff_timeout,
                                               request_id=request_id,
                                               leg="kv_import",
                                               deadline_s=deadline_s)
                        if code == 200:
                            # skipped = already cached on B (an earlier
                            # transfer or B's own traffic): warm either
                            # way, the handoff's purpose
                            imported = int(imp.get("imported", 0)) \
                                + int(imp.get("skipped", 0))
                            state.add(state._c_xfer_pages, imported)
                        state.tracer.event(
                            tid, "kv_import",
                            dur_s=time.monotonic() - t_leg,
                            replica=dec.rid, imported=imported,
                            status="ok" if code == 200 else f"{code}")
            state.note_seen(ids)
            meta = {"disaggregated": True, "prefill_replica": pre.rid,
                    "decode_replica": dec.rid, "request_id": request_id,
                    "kv_pages_imported": imported, "ttft_s": ttft}
            # 3. decode leg: prompt + first token, remaining budget.
            # Admission on B prefix-hits the imported pages and
            # prefills only the partial trailing block.
            if max_tokens <= 1 or a.get("stopped"):
                self._finish_disagg(t0, first, a.get("text", ""),
                                    a.get("stopped", False), meta, dec.rid,
                                    tid)
                return
            if deadline_s is not None and time.monotonic() >= deadline_s:
                # budget spent between prefill and decode: terminal 504
                # — the decode tier never sees (or seats) this request
                self._deadline_504(tid, request_id, t_arrive,
                                   "decode_leg")
                return
            b_req = {"tokens": ids + first, "max_tokens": max_tokens - 1,
                     "request_id": request_id}
            for k in ("temperature", "stop_token", "top_p", "top_k",
                      "priority"):
                if k in obj:
                    b_req[k] = obj[k]
            t_leg = time.monotonic()
            code, b = self._call(dec, "POST", "/generate", b_req,
                                 request_id=request_id, leg="decode_leg",
                                 deadline_s=deadline_s)
            state.tracer.event(tid, "decode_leg",
                               dur_s=time.monotonic() - t_leg,
                               replica=dec.rid,
                               tokens=len(b.get("tokens", ())),
                               status="ok" if code == 200 else f"{code}")
            if code == 504:
                self._deadline_504(tid, request_id, t_arrive,
                                   "decode_leg", detail=b)
                return
            if code != 200:
                self._fallback(obj, ids, tid, t_arrive,
                               f"decode leg {code}",
                               request_id=request_id,
                               deadline_s=deadline_s)
                return
            self._finish_disagg(
                t0, first + [int(t) for t in b.get("tokens", ())],
                a.get("text", "") + b.get("text", ""),
                b.get("stopped", False), meta, dec.rid, tid)

        def _finish_disagg(self, t0, tokens, text, stopped, meta,
                           rid, tid) -> None:
            state.count(rid, "ok")
            total = time.monotonic() - t0
            ttft = meta.get("ttft_s")
            itl_mean = ((total - ttft) / (len(tokens) - 1)
                        if ttft is not None and len(tokens) > 1 else None)
            verdicts = state.observe_slo(ttft, itl_mean)
            attrs = dict(verdicts)
            if itl_mean is not None:
                attrs["itl_mean_s"] = itl_mean
            state.tracer.event(tid, "finish", state="disaggregated",
                               tokens=len(tokens), total_s=total,
                               ttft_s=ttft, **attrs)
            self._json(200, {
                "tokens": tokens, "text": text, "stopped": stopped,
                "total_s": total, **meta, **verdicts,
            }, headers={"X-Routed-To": rid})

    return FleetHandler


def fleet_forever(backends: List[str], host: str = "0.0.0.0",
                  port: int = 8100, page_size: int = 16,
                  affinity_blocks: int = 4, saturate_after: int = 8,
                  probe_interval: float = 0.5, probe_timeout: float = 2.0,
                  dead_after: int = 3, read_timeout: float = 300.0,
                  disagg_threshold: int = 64,
                  slo_ttft_s: Optional[float] = None,
                  slo_itl_s: Optional[float] = None,
                  ready_event=None):
    """Blocking control-plane loop (`butterfly route --disaggregate`).
    Same shape as router.proxy.route_forever — the control plane IS the
    router, grown KV-aware."""
    import threading
    from http.server import ThreadingHTTPServer

    registry = MetricsRegistry()
    pool = ReplicaPool(backends, probe_interval=probe_interval,
                       probe_timeout=probe_timeout, dead_after=dead_after,
                       registry=registry, scrape_metrics=True)
    policy = PrefixAffinityPolicy(pool, page_size=page_size,
                                  affinity_blocks=affinity_blocks,
                                  saturate_after=saturate_after)
    state = ControlPlaneState(pool, policy, registry=registry,
                              read_timeout=read_timeout,
                              disagg_threshold=disagg_threshold,
                              slo_ttft_s=slo_ttft_s, slo_itl_s=slo_itl_s)
    pool.probe_all()   # one synchronous round: roles known at bind
    pool.start()

    class _Server(ThreadingHTTPServer):
        request_queue_size = 128

    httpd = _Server((host, port), make_fleet_handler(state))
    state.httpd = httpd
    if ready_event is not None:
        ready_event.set()
    snaps = pool.snapshot()
    n_pre = sum(1 for s in snaps if s["role"] in ("prefill", "both"))
    n_dec = sum(1 for s in snaps if s["role"] in ("decode", "both"))
    print(f"[butterfly] fleet control plane on {host}:{port}: "
          f"{len(snaps)} replicas ({n_pre} prefill-capable, "
          f"{n_dec} decode-capable), disagg threshold "
          f"{state.disagg_threshold} tokens", flush=True)
    try:
        httpd.serve_forever()
    finally:
        pool.stop()
        httpd.server_close()
    return 0
