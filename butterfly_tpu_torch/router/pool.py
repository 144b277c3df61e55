"""Replica pool: health-aware membership for the multi-replica router.

Each backend `butterfly serve` replica is tracked as a `Replica` with a
liveness state plus an orthogonal admin `drain` flag:

* ``live``      last probe returned 200 — routable.
* ``degraded``  reachable-but-unhealthy (a wedged replica's 503) or a
                fresh connection failure below the dead threshold —
                excluded from routing, re-probed at the normal cadence.
* ``dead``      >= `dead_after` consecutive connection failures — re-
                probed with jittered exponential backoff so a downed
                host isn't hammered, and a restarted one is found within
                `backoff_max`.
* ``draining``  admin-requested (POST /router/drain): no NEW requests
                route to it, in-flight ones finish; probing continues so
                an undrain returns it at its true liveness.

The prober is one daemon thread issuing `GET /health` per due replica
(serve/server.py answers it without taking the scheduler lock, so a
busy replica still probes fast). The 200 body carries `queue_depth` and
`active` — the load signal the least-loaded policy reads — so the
router never scrapes full Prometheus text on the request path.

Proxy feedback short-circuits the prober: a connection-refused or
wedged-503 observed while forwarding marks the replica immediately, so
the very next request skips it instead of waiting out a probe cycle.

stdlib-only; thread-safe (one lock around membership state — probe I/O
happens outside it). A copy of butterfly_tpu/router/pool.py.
"""
from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Dict, List, Optional

LIVE = "live"
DEGRADED = "degraded"
DEAD = "dead"
DRAINING = "draining"


class Replica:
    """One backend's membership record. Mutated only under the pool lock."""

    __slots__ = ("rid", "host", "port", "liveness", "drain", "outstanding",
                 "queue_depth", "active", "fails", "probes", "last_probe_t",
                 "next_probe_t", "last_error", "role", "free_pages",
                 "inflight", "clock_offset", "metrics_families",
                 "metrics_t", "breaker", "breaker_fails",
                 "breaker_next_probe_t", "breaker_opens", "series",
                 "scrape_fails")

    def __init__(self, rid: str, host: str, port: int):
        self.rid = rid
        self.host = host
        self.port = port
        # optimistic start: routable until a probe (or proxy feedback)
        # says otherwise — the router must not 503 a healthy fleet just
        # because the first probe round hasn't completed yet
        self.liveness = LIVE
        self.drain = False
        self.outstanding = 0     # router-tracked in-flight proxied requests
        self.queue_depth = 0     # from the last /health scrape
        self.active = 0          # from the last /health scrape
        self.role = "both"       # fleet tier (prefill|decode|both), scraped
        self.free_pages: Optional[int] = None  # KV page headroom, scraped
        self.inflight = 0        # decode blocks in flight, scraped
        # estimated replica_wall - router_wall clock offset (seconds),
        # from the /health probe RTT midpoint: the replica stamps
        # `now_wall` into its response, and offset = now_wall - the
        # midpoint of our send/receive wall times. Accurate to ~RTT/2 —
        # what the fleet trace merge needs to place a replica's span
        # events on the control plane's clock. None until a probe with
        # a now_wall-carrying replica lands.
        self.clock_offset: Optional[float] = None
        # last parsed /metrics exposition (obs.registry.parse_exposition
        # output) when the pool scrapes metrics; feeds /fleet/metrics
        self.metrics_families: Optional[dict] = None
        self.metrics_t: Optional[float] = None
        # per-replica gauge history ring: each successful
        # scrape appends one {"t_wall", "signals"} entry — this
        # replica's signal trajectory as seen from the scraping
        # process's clock — the /fleet/timeseries merge input and the
        # window the control plane's per-replica alert rules read
        self.series: deque = deque(maxlen=240)
        # consecutive FAILED scrapes (scrape_metrics mode only; probe
        # failures count too — a down replica reports nothing): drives
        # the stale-gauge drop in /fleet/metrics and the
        # replica-flatline alert rule
        self.scrape_fails = 0
        self.fails = 0           # consecutive probe/connect failures
        self.probes = 0
        self.last_probe_t: Optional[float] = None
        self.next_probe_t = 0.0  # due immediately
        self.last_error = ""
        # Serving-path circuit breaker, ORTHOGONAL to probe liveness: a
        # replica whose /health answers fine can still fail every
        # request leg (wedged scheduler, chaos-injected faults,
        # timeouts). `breaker_threshold` consecutive leg failures OPEN
        # the breaker — candidates() skips it entirely — and after
        # `breaker_cooldown` it goes HALF-OPEN: exactly one probe
        # request is let through; success closes it, failure re-opens.
        self.breaker = "closed"          # closed | open | half_open
        self.breaker_fails = 0           # consecutive leg failures
        self.breaker_next_probe_t = 0.0  # when open -> half_open
        self.breaker_opens = 0           # lifetime open transitions

    @property
    def state(self) -> str:
        """Reported state: the admin drain flag masks liveness."""
        return DRAINING if self.drain else self.liveness

    @property
    def routable(self) -> bool:
        return self.liveness == LIVE and not self.drain

    def serves(self, role: Optional[str]) -> bool:
        """Does this replica belong to the given fleet tier? role=None
        means any; 'both' replicas belong to every tier."""
        return role is None or self.role == role or self.role == "both"

    def load_score(self):
        """Ordering key for least-loaded fallback: router-tracked
        outstanding first (always fresh), then the replica's own scraped
        backlog, then KV page PRESSURE (negated free-page headroom: a
        replica one admission from page exhaustion — and therefore from
        preempting its own runners — must stop winning least-outstanding
        ties; unknown headroom scores as zero pages, the conservative
        read for a member that has never answered a probe), then rid for
        determinism."""
        return (self.outstanding, self.queue_depth + self.active,
                -(self.free_pages or 0), self.rid)

    def snapshot(self) -> dict:
        return {"replica": self.rid, "state": self.state, "role": self.role,
                "outstanding": self.outstanding,
                "queue_depth": self.queue_depth, "active": self.active,
                "free_pages": self.free_pages, "inflight": self.inflight,
                "clock_offset_s": self.clock_offset,
                "consecutive_failures": self.fails,
                "scrape_fails": self.scrape_fails,
                "breaker": self.breaker,
                "breaker_fails": self.breaker_fails,
                "breaker_opens": self.breaker_opens,
                "probes": self.probes, "last_error": self.last_error}


def _flat_gauges(families: dict) -> Dict[str, float]:
    """Unlabeled gauge samples from a parsed /metrics exposition, keyed
    by the short signal name (the `butterfly_` prefix stripped so the
    fleet timeline and a replica's own /debug/timeseries speak the same
    signal vocabulary). Labeled gauge families are skipped — a history
    ring wants scalar trajectories."""
    out: Dict[str, float] = {}
    for name, fam in families.items():
        if fam.get("type") != "gauge":
            continue
        v = fam["samples"].get((name, ()))
        if v is None:
            continue
        short = name[len("butterfly_"):] \
            if name.startswith("butterfly_") else name
        out[short] = float(v)
    return out


def parse_backend(spec: str) -> tuple:
    """'host:port' -> (host, port); bare ':port'/'port' default host."""
    spec = spec.strip()
    if ":" in spec:
        host, _, port = spec.rpartition(":")
        host = host or "127.0.0.1"
    else:
        host, port = "127.0.0.1", spec
    return host, int(port)


class ReplicaPool:
    def __init__(self, backends: List[str], probe_interval: float = 0.5,
                 probe_timeout: float = 2.0, dead_after: int = 3,
                 backoff_base: float = 0.5, backoff_max: float = 10.0,
                 registry=None, scrape_metrics: bool = False,
                 breaker_threshold: int = 3,
                 breaker_cooldown: float = 2.0):
        if not backends:
            raise ValueError("router needs at least one backend")
        self.probe_interval = probe_interval
        self.probe_timeout = probe_timeout
        self.dead_after = dead_after
        # serving-path circuit breaker (see Replica.breaker): leg
        # failures to open, seconds open before a half-open probe
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        # fleet mode: each successful /health probe is followed by a
        # GET /metrics scrape, parsed and cached on the Replica — the
        # control plane's /fleet/metrics rollup reads the cache instead
        # of fanning out N HTTP calls per dashboard scrape. Off for the
        # plain router (no aggregation surface there).
        self.scrape_metrics = scrape_metrics
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.replicas: Dict[str, Replica] = {}
        for spec in backends:
            host, port = parse_backend(spec)
            rid = f"{host}:{port}"
            if rid in self.replicas:
                raise ValueError(f"duplicate backend {rid}")
            self.replicas[rid] = Replica(rid, host, port)
        # optional observer for breaker OPEN transitions (the fleet
        # control plane's flight recorder hooks this): called with the
        # replica id, under the pool lock — must be quick and must
        # never call back into the pool
        self.on_breaker_open = None
        # optional per-probe series observer (scrape_metrics mode): the
        # control plane hooks this to run its per-replica alert rules
        # (replica-flatline, pages-free-slope) against the gauge
        # history. Called OUTSIDE the pool lock after each probe with
        # (rid, recent series tail, consecutive scrape failures); must
        # never call back into the pool
        self.on_series_sample = None
        # per-replica outstanding gauge on the router's own registry
        self._g_out = None
        self._c_breaker_open = None
        if registry is not None:
            self._g_out = registry.gauge_family(
                "router_outstanding_requests",
                "Requests currently proxied to each replica", ("replica",))
            for rid in self.replicas:
                self._g_out.labels(rid).set(0)
            self._c_breaker_open = registry.counter_family(
                "router_breaker_open_total",
                "Circuit-breaker open transitions per replica "
                "(breaker_threshold consecutive request-leg failures; "
                "half-open probes after breaker_cooldown)", ("replica",))

    # -- membership queries --------------------------------------------------

    def get(self, rid: str) -> Optional[Replica]:
        return self.replicas.get(rid)

    def routable(self) -> List[Replica]:
        with self._lock:
            return [r for r in self.replicas.values() if r.routable]

    def candidates(self, role: Optional[str] = None) -> List[Replica]:
        """Replicas worth attempting, best liveness first: routable ones,
        else (all degraded — e.g. one connect blip marked the only
        replica before its re-probe) the degraded ones as a last resort.
        Dead and draining members are never returned — dead is the
        pool's signal the proxy must not waste a connect on it — and
        neither are members whose circuit breaker is OPEN (a half-open
        member is returned only while it has no in-flight probe, so one
        request at a time tests the recovery).
        `role` restricts to one fleet tier ('prefill'/'decode'; 'both'
        replicas belong to every tier) — the control plane's
        disaggregated planner asks per tier, the plain router asks for
        all; while a whole tier's breakers are open the planner gets an
        empty list and the disagg path degrades to direct dispatch."""
        now = time.monotonic()
        with self._lock:
            live = [r for r in self.replicas.values()
                    if r.routable and r.serves(role)
                    and self._breaker_admits(r, now)]
            if live:
                return live
            return [r for r in self.replicas.values()
                    if r.liveness == DEGRADED and not r.drain
                    and r.serves(role) and self._breaker_admits(r, now)]

    def _breaker_admits(self, r: Replica, now: float) -> bool:
        """Lock held. Open breakers flip to half-open once the cooldown
        passes; a half-open member admits exactly one probe request at
        a time (outstanding == 0)."""
        if r.breaker == "closed":
            return True
        if r.breaker == "open":
            if now < r.breaker_next_probe_t:
                return False
            r.breaker = "half_open"
        return r.outstanding == 0

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [r.snapshot() for r in self.replicas.values()]

    # -- proxy feedback ------------------------------------------------------

    def note_dispatch(self, rid: str) -> None:
        with self._lock:
            r = self.replicas[rid]
            r.outstanding += 1
            if self._g_out is not None:
                self._g_out.labels(rid).set(r.outstanding)

    def note_done(self, rid: str) -> None:
        with self._lock:
            r = self.replicas[rid]
            r.outstanding = max(0, r.outstanding - 1)
            if self._g_out is not None:
                self._g_out.labels(rid).set(r.outstanding)

    def note_connect_failure(self, rid: str, err: str = "") -> None:
        """Proxy saw a refused/reset connect: count it toward dead and
        stop routing there now — don't wait for the next probe cycle."""
        with self._lock:
            self._fail(self.replicas[rid], err or "connect failed",
                       time.monotonic())

    def note_wedged(self, rid: str, err: str = "") -> None:
        """Proxy saw a wedged-503: reachable but unhealthy. Degrade
        without advancing toward dead (the process is up; its prober
        probe will flip it back the moment /health recovers)."""
        with self._lock:
            r = self.replicas[rid]
            if r.liveness == LIVE:
                r.liveness = DEGRADED
            r.last_error = err or "503 from replica"

    # -- circuit breaker (request-leg feedback) -----------------------------

    def note_leg_ok(self, rid: str) -> None:
        """A request leg to `rid` produced a usable response: reset the
        consecutive-failure count; a half-open breaker CLOSES (the
        probe succeeded — full restore)."""
        with self._lock:
            r = self.replicas.get(rid)
            if r is None:
                return
            r.breaker_fails = 0
            r.breaker = "closed"

    def note_leg_failure(self, rid: str, err: str = "") -> None:
        """A request leg to `rid` failed (refused, wedged-503, timeout,
        truncated, bad body). `breaker_threshold` consecutive failures
        open the breaker; any failure during half-open re-opens it
        immediately — one bad probe is enough evidence."""
        with self._lock:
            r = self.replicas.get(rid)
            if r is None:
                return
            r.breaker_fails += 1
            if r.breaker == "half_open" \
                    or r.breaker_fails >= self.breaker_threshold:
                self._open_breaker(r, err)

    def _open_breaker(self, r: Replica, err: str) -> None:
        """Lock held."""
        if r.breaker != "open":
            r.breaker_opens += 1
            if self._c_breaker_open is not None:
                self._c_breaker_open.labels(r.rid).inc()
            if self.on_breaker_open is not None:
                try:
                    self.on_breaker_open(r.rid)
                except Exception:
                    pass  # an observer must never break routing
        r.breaker = "open"
        r.breaker_next_probe_t = time.monotonic() + self.breaker_cooldown
        if err:
            r.last_error = err

    def breaker_opens_total(self) -> int:
        with self._lock:
            return sum(r.breaker_opens for r in self.replicas.values())

    # -- membership changes (fleet elasticity) -------------------------------

    def add(self, spec: str) -> str:
        """Register a new backend at runtime (the autoscaler's
        spawn-attach). The member starts optimistically LIVE with
        next_probe_t due immediately — the very next probe cycle (or an
        explicit probe_one) learns its role and load signals. Returns
        the canonical rid; raises on a duplicate."""
        host, port = parse_backend(spec)
        rid = f"{host}:{port}"
        with self._lock:
            if rid in self.replicas:
                raise ValueError(f"duplicate backend {rid}")
            self.replicas[rid] = Replica(rid, host, port)
            if self._g_out is not None:
                self._g_out.labels(rid).set(0)
        return rid

    def remove(self, rid: str) -> bool:
        """Forget a backend at runtime (the autoscaler's retire, called
        AFTER drain + stop — the pool does no draining itself). False
        if the rid is unknown. The last member cannot be removed: an
        empty pool can route nothing and __init__ forbids starting
        that way."""
        with self._lock:
            if rid not in self.replicas:
                return False
            if len(self.replicas) == 1:
                raise ValueError("cannot remove the last replica")
            del self.replicas[rid]
            return True

    # -- admin ---------------------------------------------------------------

    def set_drain(self, rid: str, draining: bool) -> Optional[dict]:
        with self._lock:
            r = self.replicas.get(rid)
            if r is None:
                return None
            r.drain = draining
            return r.snapshot()

    # -- probing -------------------------------------------------------------

    def probe_one(self, r: Replica) -> None:
        """Synchronous probe of one replica; state applied under the
        lock, network I/O outside it."""
        url = f"http://{r.host}:{r.port}/health"
        now = time.monotonic()
        w0 = time.time()
        try:
            with urllib.request.urlopen(url,
                                        timeout=self.probe_timeout) as resp:
                body = json.loads(resp.read() or b"{}")
            ok, detail = True, body
        except urllib.error.HTTPError as e:  # reachable, unhealthy (503)
            ok, detail = False, f"http {e.code}"
            e.close()
        except Exception as e:  # refused / timeout / reset / bad JSON
            ok, detail = None, f"{type(e).__name__}: {e}"
        w1 = time.time()
        scraped = self._scrape(r) if ok and self.scrape_metrics else None
        series_tail = None
        scrape_fails = 0
        with self._lock:
            r.probes += 1
            r.last_probe_t = now
            if ok:
                r.liveness = LIVE
                r.fails = 0
                r.last_error = ""
                r.queue_depth = int(detail.get("queue_depth", 0) or 0)
                r.active = int(detail.get("active", 0) or 0)
                # fleet signals (serve/server.py /health): absent on a
                # pre-fleet replica — keep the conservative defaults
                r.role = str(detail.get("role") or "both")
                fp = detail.get("free_pages")
                r.free_pages = int(fp) if fp is not None else None
                r.inflight = int(detail.get("inflight_depth", 0) or 0)
                # clock offset from the probe RTT midpoint: the replica
                # stamped now_wall somewhere inside [w0, w1]; the
                # midpoint is the minimum-error estimate without a
                # second exchange (NTP's trick). Error bound ~RTT/2.
                nw = detail.get("now_wall")
                if nw is not None:
                    r.clock_offset = float(nw) - (w0 + w1) / 2.0
                if scraped is not None:
                    r.metrics_families = scraped
                    r.metrics_t = now
                    r.scrape_fails = 0
                    # gauge history append: stamped with the
                    # probe RTT midpoint on THIS process's wall clock,
                    # so the fleet merge needs no offset shift for
                    # scrape-derived samples
                    r.series.append({
                        "t_wall": (w0 + w1) / 2.0,
                        "signals": _flat_gauges(scraped)})
                elif self.scrape_metrics:
                    r.scrape_fails += 1
                r.next_probe_t = now + self.probe_interval
            elif ok is False:  # wedged: degraded, normal re-probe cadence
                r.liveness = DEGRADED
                r.last_error = detail
                if self.scrape_metrics:
                    r.scrape_fails += 1
                r.next_probe_t = now + self.probe_interval
            else:
                if self.scrape_metrics:
                    r.scrape_fails += 1
                self._fail(r, detail, now)
            if self.scrape_metrics and self.on_series_sample is not None:
                series_tail = list(r.series)[-16:]
                scrape_fails = r.scrape_fails
        if series_tail is not None:
            try:  # an observer must never break probing
                self.on_series_sample(r.rid, series_tail, scrape_fails)
            except Exception:
                pass

    def _scrape(self, r: Replica):
        """Fetch + parse one replica's /metrics (network + parse OUTSIDE
        the pool lock). Returns parsed families or None on any failure —
        a replica whose /metrics hiccups keeps its last good scrape."""
        from butterfly_tpu_torch.obs.registry import parse_exposition
        try:
            url = f"http://{r.host}:{r.port}/metrics"
            with urllib.request.urlopen(url,
                                        timeout=self.probe_timeout) as resp:
                return parse_exposition(resp.read().decode(
                    "utf-8", "replace"))
        except Exception:
            return None

    def metrics_by_replica(self) -> Dict[str, dict]:
        """Last parsed /metrics scrape per replica (fleet rollup input);
        replicas never scraped (down, or scrape_metrics off) are absent."""
        with self._lock:
            return {rid: r.metrics_families
                    for rid, r in self.replicas.items()
                    if r.metrics_families is not None}

    def series_by_replica(self) -> Dict[str, List[dict]]:
        """Each replica's scrape-derived gauge history ring (the
        /fleet/timeseries merge input); empty rings are absent. Entries
        are stamped on THIS process's wall clock (probe RTT midpoint),
        so they merge at offset zero."""
        with self._lock:
            return {rid: list(r.series)
                    for rid, r in self.replicas.items() if r.series}

    def stale_scrapes(self, after: int) -> List[str]:
        """Replica ids whose last `after`+ scrape attempts all failed:
        their re-exported gauges are STALE (frozen at the last good
        scrape) and /fleet/metrics drops them rather than serving a
        flat line as live data."""
        with self._lock:
            return [rid for rid, r in self.replicas.items()
                    if r.scrape_fails >= after]

    def _fail(self, r: Replica, err: str, now: float) -> None:
        """Shared connect-failure accounting (lock held): escalate
        degraded -> dead and schedule the jittered-backoff re-probe."""
        r.fails += 1
        r.last_error = err
        if r.fails >= self.dead_after:
            r.liveness = DEAD
            # jittered exponential backoff: doubling from the threshold,
            # capped, x[0.5, 1.5) jitter so a fleet of routers doesn't
            # re-probe a recovering host in lockstep
            delay = min(self.backoff_max,
                        self.backoff_base
                        * 2 ** min(r.fails - self.dead_after, 20))
            r.next_probe_t = now + delay * (0.5 + random.random())
        else:
            r.liveness = DEGRADED
            r.next_probe_t = now + self.probe_interval

    def probe_due(self) -> int:
        """Probe every replica whose next_probe_t has passed. Returns how
        many were probed (tests drive this synchronously)."""
        now = time.monotonic()
        with self._lock:
            due = [r for r in self.replicas.values()
                   if r.next_probe_t <= now]
        for r in due:
            self.probe_one(r)
        return len(due)

    def probe_all(self) -> None:
        for r in list(self.replicas.values()):
            self.probe_one(r)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.probe_due()
            self._stop.wait(self.probe_interval / 2)

    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
