"""Metrics time series: the bounded signal-history ring and
the declarative alert rules.

Every observability surface so far answers "what is the value NOW":
``metrics()`` is a point snapshot, ``/fleet/metrics`` a point rollup.
The self-tuning controller (ROADMAP item 6) and the autoscaler (item 2)
both need *trajectories* — a ramp is invisible in a single scrape. This
module is that sensing substrate:

* ``SignalRecorder`` — a bounded ring of periodic signal snapshots the
  scheduler loop thread samples every ``interval_s`` (``due()`` is one
  monotonic compare; a scheduler built without a recorder pays a single
  ``is None`` check per tick). Gauge signals are stored as-is;
  monotonic counters are passed as cumulative values and stored as
  per-second RATES (``Counter.rate`` deltas, clamped at zero so a
  counter reset — replica restart — never renders a negative rate).
  Served raw at ``GET /debug/timeseries?since=&signals=`` under its own
  lock, readable while the scheduler is wedged (the /debug/ticks
  contract).

* ``AlertRule`` — a declarative predicate over one signal's recent
  window: ``sustained_above`` (every sample in the window crossed),
  ``drift_above`` (recent-window mean minus prior-window mean),
  ``slope_below`` (least-squares slope per sample), ``flatline`` (a
  source stopped producing samples — fleet-side, driven by consecutive
  failed scrapes). Rules fire on the RISING edge only (one alert per
  excursion, not one per sample) and emit a structured ``alert`` event
  into the PR-15 flight recorder with the surrounding series attached,
  so a threshold crossing freezes its own post-mortem context.

Determinism contract (BTF005): this module never reads the wall clock —
ring ordering is by sequence number and ``time.monotonic()`` only, and
wall stamps are supplied by CALLERS (the scheduler/server, outside the
determinism scope) via the ``t_wall`` parameter. Host-only contract
(BTF003): ``sample`` / ``evaluate_rules`` do plain dict/float
arithmetic — no device value is ever materialized here.

stdlib-only: importable without torch (tools/dashboard.py consumes the
dumped JSON with no backend, like tick_report.py).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

from butterfly_tpu_torch.obs.registry import Counter

#: timeseries dump schema version (pinned by the dashboard smoke tests)
TIMESERIES_SCHEMA = "butterfly-timeseries-v1"
FLEET_TIMESERIES_SCHEMA = "butterfly-fleet-timeseries-v1"

#: alert predicate kinds (AlertRule.kind)
ALERT_KINDS = ("sustained_above", "drift_above", "slope_below",
               "flatline")


def slope_per_sample(values: Sequence[float]) -> float:
    """Least-squares slope of a series in signal-units PER SAMPLE
    (samples are interval-spaced, so units/second = this / interval).
    Plain host arithmetic over a short window."""
    n = len(values)
    if n < 2:
        return 0.0
    mx = (n - 1) / 2.0
    my = sum(values) / n
    num = sum((i - mx) * (v - my) for i, v in enumerate(values))
    den = sum((i - mx) ** 2 for i in range(n))
    return num / den if den else 0.0


class AlertRule:
    """One declarative predicate over one signal's recent window.

    ``window`` is the number of consecutive samples the predicate
    examines (``drift_above`` compares the last ``window`` against the
    ``window`` before it; ``flatline`` counts consecutive MISSING
    samples instead). ``threshold`` is in signal units
    (``slope_below``: units per sample). Rules are stateful — ``active``
    latches while the predicate holds so each excursion fires exactly
    one alert — and therefore must NOT be shared across sources; build
    one rule set per recorder / per replica (``default_rules()`` /
    ``default_fleet_rules()``).
    """

    __slots__ = ("name", "signal", "window", "kind", "threshold",
                 "severity", "active")

    def __init__(self, name: str, signal: str, window: int, kind: str,
                 threshold: float, severity: str = "warn"):
        if kind not in ALERT_KINDS:
            raise ValueError(f"unknown alert kind {kind!r}: "
                             f"expected one of {ALERT_KINDS}")
        if window < 1:
            raise ValueError(f"alert rule {name!r} needs window >= 1")
        self.name = name
        self.signal = signal
        self.window = int(window)
        self.kind = kind
        self.threshold = float(threshold)
        self.severity = severity
        self.active = False

    def describe(self) -> Dict[str, Any]:
        return {"rule": self.name, "signal": self.signal,
                "window": self.window, "kind": self.kind,
                "threshold": self.threshold, "severity": self.severity}


def default_rules() -> List[AlertRule]:
    """The seeded replica-side rule set: the error budget burning for a
    sustained window, the host share of tick wall drifting up (a host-
    path regression creeping in), and KV page headroom draining toward
    preemption pressure."""
    return [
        AlertRule("slo_burn_sustained", "slo_burn_rate", window=5,
                  kind="sustained_above", threshold=0.5, severity="page"),
        AlertRule("host_frac_drift", "tick_host_frac", window=8,
                  kind="drift_above", threshold=0.15, severity="warn"),
        AlertRule("pages_free_slope", "kv_pages_free", window=8,
                  kind="slope_below", threshold=-1.0, severity="warn"),
    ]


def default_fleet_rules() -> List[AlertRule]:
    """The seeded control-plane rule set, instantiated PER REPLICA
    (rules are stateful): a replica that stopped answering /metrics
    scrapes has flatlined — its gauges are about to be dropped from the
    /fleet/metrics re-export, and the autoscaler must hear about it."""
    return [
        AlertRule("replica_flatline", "scrape", window=3,
                  kind="flatline", threshold=3, severity="page"),
        AlertRule("pages_free_slope", "kv_pages_free", window=8,
                  kind="slope_below", threshold=-1.0, severity="warn"),
    ]


def evaluate_rules(rules: Sequence[AlertRule],
                   samples: Sequence[Dict[str, Any]],
                   flightrec=None, source: Optional[str] = None,
                   missing: int = 0) -> List[Dict[str, Any]]:
    """Evaluate every rule against the tail of ``samples`` (ring
    entries: dicts with a ``signals`` mapping). Fires on the RISING
    edge only; a fired rule stays ``active`` (silent) until its
    predicate releases. ``missing`` drives the ``flatline`` kind: the
    count of consecutive samples a source failed to produce.

    Each fired alert is returned AND noted into ``flightrec`` (event
    kind ``alert``) with the surrounding series attached — the post-
    mortem context the flight recorder freezes on its next trigger.
    Host-only dict/float arithmetic (BTF003 hot set)."""
    fired: List[Dict[str, Any]] = []
    for rule in rules:
        if rule.kind == "flatline":
            hot = missing >= rule.window
            value = float(missing)
            tail: List[float] = []
        else:
            tail = [float(s["signals"][rule.signal]) for s in samples
                    if rule.signal in s.get("signals", {})]
            hot, value = _series_predicate(rule, tail)
        if not hot:
            rule.active = False
            continue
        if rule.active:
            continue  # still in the same excursion: one alert, not N
        rule.active = True
        rec: Dict[str, Any] = dict(rule.describe())
        # the flight-recorder event kind is "alert"; the rule's
        # predicate kind rides under its own key
        rec["predicate"] = rec.pop("kind")
        rec["value"] = value
        rec["series"] = tail[-(2 * rule.window):]
        if source is not None:
            rec["source"] = source
        fired.append(rec)
        if flightrec is not None:
            flightrec.note("alert", **rec)
    return fired


def _series_predicate(rule: AlertRule, tail: List[float]):
    """(predicate holds, observed value) for the series-window kinds.
    A window shorter than the rule demands NEVER fires — one bad sample
    is a blip, not an alert (the mutcheck alert-predicate mutant
    weakens exactly this guard)."""
    if len(tail) < rule.window:
        return False, 0.0
    if rule.kind == "sustained_above":
        window = tail[-rule.window:]
        return all(v > rule.threshold for v in window), window[-1]
    if rule.kind == "drift_above":
        if len(tail) < 2 * rule.window:
            return False, 0.0
        recent = tail[-rule.window:]
        prior = tail[-2 * rule.window:-rule.window]
        drift = sum(recent) / len(recent) - sum(prior) / len(prior)
        return drift > rule.threshold, drift
    # slope_below
    slope = slope_per_sample(tail[-rule.window:])
    return slope < rule.threshold, slope


class SignalRecorder:
    """Bounded ring of periodic signal snapshots. One writer (the
    scheduler loop thread calls ``due()``/``sample()``), any number of
    readers (HTTP handlers call ``dump()``) — the ring takes a tiny
    internal lock, never the serving lock, so a wedged scheduler's
    history stays inspectable."""

    def __init__(self, interval_s: float = 1.0, capacity: int = 600,
                 rules: Optional[List[AlertRule]] = None,
                 flightrec=None, max_alerts: int = 64):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0 (a disabled "
                             "recorder is spelled timeseries=None)")
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self.rules = list(rules) if rules is not None else []
        self.flightrec = flightrec
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._alerts: deque = deque(maxlen=max_alerts)
        self._seq = 0
        # -inf sentinel: the first due() after construction samples
        # immediately (monotonic-only ordering — BTF005)
        self._last_t = float("-inf")
        # previous cumulative counter values + their monotonic stamp,
        # for the per-second rate deltas (None until the first sample)
        self._prev_rates: Dict[str, float] = {}
        self._prev_t: Optional[float] = None
        # how much tail the rule windows need (drift looks back 2x)
        self._rule_tail = max(
            [2 * r.window for r in self.rules], default=0)

    def due(self, now: Optional[float] = None) -> bool:
        """One float compare: is the next periodic sample owed? The
        scheduler's per-tick cost when a recorder is attached."""
        if now is None:
            now = time.monotonic()
        return now - self._last_t >= self.interval_s

    def sample(self, gauges: Dict[str, float],
               rates: Optional[Dict[str, float]] = None,
               t_wall: float = 0.0) -> List[Dict[str, Any]]:
        """Append one snapshot and evaluate the alert rules. ``gauges``
        are stored as-is; ``rates`` maps OUTPUT signal name ->
        CUMULATIVE counter value, converted to a per-second rate
        against the previous sample (``Counter.rate``: first sample and
        counter resets clamp to 0.0, never negative). ``t_wall`` is the
        caller's wall stamp — this module never reads the wall clock
        (BTF005), and the fleet merge shifts these stamps by the probe
        clock offset. Returns the alerts fired by this sample."""
        now = time.monotonic()
        signals = {k: float(v) for k, v in gauges.items()}
        if rates:
            prev_t = self._prev_t
            dt = now - prev_t if prev_t is not None else 0.0
            for name, cum in rates.items():
                signals[name] = Counter.rate(
                    self._prev_rates.get(name, 0.0), float(cum), dt) \
                    if prev_t is not None else 0.0
            self._prev_rates = {k: float(v) for k, v in rates.items()}
            self._prev_t = now
        entry = {"seq": self._seq, "t_mono": now,
                 "t_wall": float(t_wall), "signals": signals}
        with self._lock:
            self._ring.append(entry)
            self._seq += 1
            tail = list(self._ring)[-self._rule_tail:] \
                if self._rule_tail else []
        self._last_t = now
        fired = evaluate_rules(self.rules, tail,
                               flightrec=self.flightrec) \
            if self.rules else []
        if fired:
            with self._lock:
                for rec in fired:
                    self._alerts.append({"t_wall": float(t_wall),
                                         "seq": entry["seq"], **rec})
        return fired

    # -- read side -----------------------------------------------------------

    def dump(self, since: Optional[int] = None,
             signals: Optional[Sequence[str]] = None) -> Dict[str, Any]:
        """JSON-ready snapshot: the GET /debug/timeseries body.
        ``since`` pages by sequence number (samples with seq >= since —
        the /debug/ticks contract; a since older than the ring's tail
        returns what survived the wrap); ``signals`` filters each
        sample's signal map to the named set."""
        with self._lock:
            samples = list(self._ring)
            seq = self._seq
            alerts = list(self._alerts)
        if since is not None:
            samples = [s for s in samples if s["seq"] >= since]
        if signals:
            want = set(signals)
            samples = [{**s, "signals": {k: v
                                         for k, v in s["signals"].items()
                                         if k in want}}
                       for s in samples]
        return {"enabled": True, "schema": TIMESERIES_SCHEMA,
                "capacity": self.capacity, "interval_s": self.interval_s,
                "next_seq": seq, "rules": [r.describe()
                                           for r in self.rules],
                "samples": samples, "alerts": alerts}


def series_summary(dump: Dict[str, Any],
                   signals: Optional[Sequence[str]] = None) \
        -> Dict[str, Dict[str, float]]:
    """Downsample a timeseries dump to shape scalars per signal —
    peak/mean/slope (units per sample) plus the sample count — the
    summary the bench JSON carries so BENCH rounds record trajectory
    shape, not just endpoint values."""
    series: Dict[str, List[float]] = {}
    for s in dump.get("samples", ()):
        for k, v in s.get("signals", {}).items():
            if signals is None or k in signals:
                series.setdefault(k, []).append(float(v))
    return {k: {"peak": max(vals),
                "mean": sum(vals) / len(vals),
                "slope": slope_per_sample(vals),
                "n": float(len(vals))}
            for k, vals in sorted(series.items())}
