"""Closed-loop fleet autoscaler: grow/shrink the prefill and decode
tiers independently from scraped signal HISTORY.

The control loop sits on the control plane next to the router (it is
the consumer the per-replica scrape rings were built for): each step it
reads `pool.series_by_replica()` — the last ~4 minutes of every
replica's unlabeled gauges at scrape cadence — and compares each tier's
trailing per-replica mean of one signal (queue_depth by default)
against a high/low band. Ring history rather than instantaneous
samples is the whole point: a single scrape of queue_depth says nothing
(queues oscillate at batch cadence); a window mean says "this tier has
been saturated for N scrape intervals".

Scale-up goes through ``FleetHandle.spawn`` (shared-param-tree attach,
warm-before-join — a joining replica never serves a compile-cold
request), scale-down through ``FleetHandle.retire``
(drain-before-retire — no request is dropped across a shrink). Both
are injected as plain callables so unit tests drive decisions against
a fake pool without booting replicas.

Two guards shape the loop:

* **Shedding is the backpressure floor.** When a tier's replicas start
  returning 429s (the scheduler's predicted-TTFT admission shedding),
  the tier is under-provisioned *by definition* — the gauge band is
  bypassed and the tier scales up on the shed evidence alone. The
  autoscaler reads the ``shed_total`` counter deltas straight from the
  pool's parsed scrapes.
* **Scale-down hysteresis.** A shrink is only allowed once a full
  ``cooldown_down_s`` has passed since the tier's last scale action in
  EITHER direction. Without it the loop flaps: shrink drops capacity,
  queue depth rises, the next step grows again, forever paying the
  spawn warmup. Scale-up uses a much shorter cooldown — reacting
  slowly to overload costs SLO, reacting slowly to idleness only costs
  replica-seconds.

Every decision (and every refusal with a reason) lands in the control
plane's flight recorder, so `GET /debug/flightrecorder` shows scale
events interleaved with breaker opens and deadline 504s — the
"why did the fleet change shape at 14:03" audit trail.

stdlib-only. A copy of butterfly_tpu/fleet/autoscale.py.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

__all__ = ["TierPolicy", "Autoscaler"]


@dataclass
class TierPolicy:
    """Scaling policy for one fleet tier (one role)."""

    role: str                      # "prefill" | "decode" | "both"
    min_replicas: int = 1
    max_replicas: int = 4
    #: unlabeled replica gauge from the scrape rings (short name, e.g.
    #: "queue_depth", "active_requests", "slo_burn_rate")
    signal: str = "queue_depth"
    high: float = 4.0              # tier mean above -> scale up
    low: float = 0.5               # tier mean below -> scale down
    window: int = 3                # trailing ring samples averaged
    cooldown_up_s: float = 2.0     # min gap before another grow
    cooldown_down_s: float = 15.0  # hysteresis: quiet time before shrink

    def __post_init__(self) -> None:
        if self.min_replicas < 0 or self.max_replicas < self.min_replicas:
            raise ValueError(
                f"tier {self.role!r}: need 0 <= min <= max, got "
                f"{self.min_replicas}..{self.max_replicas}")
        if self.low >= self.high:
            raise ValueError(
                f"tier {self.role!r}: low band {self.low} must sit below "
                f"high band {self.high} (the dead zone IS the hysteresis)")


@dataclass
class _Decision:
    """One evaluated step for one tier (kept for tests/benchmarks)."""
    t: float
    tier: str
    direction: Optional[str]       # "up" | "down" | None (held)
    reason: str
    value: Optional[float]
    n_before: int
    rid: Optional[str] = None


class Autoscaler:
    """The control loop. ``step()`` is synchronous and injectable-time
    (unit tests drive it sample by sample); ``start()`` runs it on a
    daemon thread at ``interval_s`` for live fleets."""

    def __init__(self, state, spawn: Callable, retire: Callable,
                 policies: List[TierPolicy], interval_s: float = 1.0):
        roles = [p.role for p in policies]
        if len(set(roles)) != len(roles):
            raise ValueError(f"duplicate tier policies: {roles}")
        self.state = state
        self.pool = state.pool
        self.spawn = spawn    # role -> handle-or-rid
        self.retire = retire  # rid -> bool
        self.policies = list(policies)
        self.interval_s = interval_s
        self._last_scale: Dict[str, float] = {}
        self._last_step_t: Optional[float] = None
        self._last_shed: Dict[str, float] = {}
        self.replica_seconds = 0.0  # integral of live replicas over time
        self.decisions: List[_Decision] = []
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = state.registry
        self._c_decisions = reg.counter_family(
            "fleet_autoscale_decisions_total",
            "Autoscaler scale actions taken, by tier and direction",
            ("tier", "direction"))
        self._c_held = reg.counter_family(
            "fleet_autoscale_held_total",
            "Scale actions wanted but refused (cooldown/bounds), by tier",
            ("tier",))
        self._c_shed_floor = reg.counter(
            "fleet_autoscale_shed_floor_total",
            "Scale-ups forced by replica admission shedding (429s) "
            "bypassing the signal band — the backpressure floor")
        self._c_errors = reg.counter(
            "fleet_autoscale_errors_total",
            "Spawn/retire attempts that raised (decision was logged, "
            "fleet shape unchanged)")
        self._g_tier = reg.gauge_family(
            "fleet_autoscale_replicas",
            "Current replicas per tier as the autoscaler sees them",
            ("tier",))
        self._g_repsec = reg.gauge(
            "fleet_autoscale_replica_seconds_total",
            "Integral of live replica count over wall time since the "
            "loop started — the cost side of the elasticity tradeoff")

    # -- signal reads --------------------------------------------------------

    def _tier_rids(self, role: str) -> List[str]:
        with self.pool._lock:
            return [rid for rid, r in self.pool.replicas.items()
                    if r.role == role]

    def _trailing_mean(self, samples: List[dict], signal: str,
                       window: int) -> Optional[float]:
        vals = [s["signals"][signal] for s in samples[-window:]
                if signal in s.get("signals", {})]
        if not vals:
            return None
        return sum(vals) / len(vals)

    def _tier_signal(self, rids: List[str], pol: TierPolicy,
                     series: Dict[str, List[dict]]) -> Optional[float]:
        """Mean over the tier's replicas of each replica's trailing
        window mean. Replicas with no ring data yet (just spawned, or
        scrapes failing) contribute nothing — a tier with NO data holds
        rather than guessing."""
        means = []
        for rid in rids:
            m = self._trailing_mean(series.get(rid, []), pol.signal,
                                    pol.window)
            if m is not None:
                means.append(m)
        if not means:
            return None
        return sum(means) / len(means)

    def _shed_delta(self, rids: List[str]) -> float:
        """New shed_total counts since the previous step across the
        tier, read from the pool's parsed scrapes (sheds are a labeled
        counter family, so they never appear in the gauge rings)."""
        by_rid = self.pool.metrics_by_replica()
        delta = 0.0
        for rid in rids:
            fam = (by_rid.get(rid) or {}).get("butterfly_shed_total")
            if not fam:
                continue
            total = sum(v for v in fam["samples"].values())
            prev = self._last_shed.get(rid, total)
            delta += max(0.0, total - prev)
            self._last_shed[rid] = total
        return delta

    # -- the loop ------------------------------------------------------------

    def step(self, now: Optional[float] = None) -> List[_Decision]:
        """Evaluate every tier once. Returns this step's decisions
        (direction None = held, with the reason)."""
        if now is None:
            now = time.monotonic()
        # replica-seconds integral: cost accounting for the acceptance
        # comparison against a static peak-provisioned fleet
        if self._last_step_t is not None and now > self._last_step_t:
            with self.pool._lock:
                n_live = len(self.pool.replicas)
            self.replica_seconds += n_live * (now - self._last_step_t)
            self._g_repsec.set(self.replica_seconds)
        self._last_step_t = now

        series = self.pool.series_by_replica()
        out: List[_Decision] = []
        for pol in self.policies:
            out.append(self._step_tier(pol, series, now))
        self.decisions.extend(out)
        del self.decisions[:-1024]
        return out

    def _step_tier(self, pol: TierPolicy, series: Dict[str, List[dict]],
                   now: float) -> _Decision:
        rids = self._tier_rids(pol.role)
        n = len(rids)
        self._g_tier.labels(pol.role).set(n)
        value = self._tier_signal(rids, pol, series)
        shed = self._shed_delta(rids)

        direction: Optional[str] = None
        reason = "in_band"
        if n < pol.min_replicas:
            direction, reason = "up", "below_min"
        elif n > pol.max_replicas:
            direction, reason = "down", "above_max"
        elif shed > 0 and n < pol.max_replicas:
            # backpressure floor: replicas 429ing means the signal band
            # is already academic — grow on the shed evidence alone
            direction, reason = "up", "shed_floor"
        elif value is not None and value > pol.high:
            if n < pol.max_replicas:
                direction, reason = "up", "signal_high"
            else:
                reason = "at_max"
        elif value is not None and value < pol.low:
            if n > pol.min_replicas:
                direction, reason = "down", "signal_low"
            else:
                reason = "at_min"
        elif value is None:
            reason = "no_data"

        last = self._last_scale.get(pol.role, float("-inf"))
        if direction == "up" and reason != "below_min" \
                and now - last < pol.cooldown_up_s:
            self._c_held.labels(pol.role).inc()
            return self._held(now, pol, "cooldown_up", value, n)
        if direction == "down":
            # scale-down hysteresis: a shrink needs a FULL quiet window
            # since the tier's last scale action in either direction,
            # or grow->shrink->grow flapping pays the warmup forever
            if now - last < pol.cooldown_down_s:
                self._c_held.labels(pol.role).inc()
                return self._held(now, pol, "cooldown_down", value, n)

        if direction is None:
            return _Decision(now, pol.role, None, reason, value, n)

        rid = None
        try:
            if direction == "up":
                h = self.spawn(pol.role)
                rid = getattr(h, "rid", h)
                if reason == "shed_floor":
                    self._c_shed_floor.inc()
            else:
                rid = self._pick_victim(rids, pol, series)
                self.retire(rid)
        except Exception as e:  # fleet shape unchanged; loop survives
            self._c_errors.inc()
            self.state.flightrec.note(
                "scale_error", tier=pol.role, direction=direction,
                reason=reason, error=f"{type(e).__name__}: {e}")
            return self._held(now, pol, "action_failed", value, n)

        self._last_scale[pol.role] = now
        self._c_decisions.labels(pol.role, direction).inc()
        self.state.flightrec.note(
            "scale", tier=pol.role, direction=direction, reason=reason,
            value=-1.0 if value is None else round(value, 4),
            n_before=n, n_after=n + (1 if direction == "up" else -1),
            rid=rid)
        return _Decision(now, pol.role, direction, reason, value, n,
                         rid=rid)

    def _held(self, now: float, pol: TierPolicy, why: str,
              value: Optional[float], n: int) -> _Decision:
        self.state.flightrec.note(
            "scale_held", tier=pol.role, reason=why,
            value=-1.0 if value is None else round(value, 4), n=n)
        return _Decision(now, pol.role, None, why, value, n)

    def _pick_victim(self, rids: List[str], pol: TierPolicy,
                     series: Dict[str, List[dict]]) -> str:
        """Least-loaded member: fewest router-tracked in-flight legs,
        then lowest trailing signal mean — retiring the busiest member
        would maximize the drain wait for no reason."""
        def load(rid: str):
            r = self.pool.get(rid)
            out = r.outstanding if r is not None else 0
            m = self._trailing_mean(series.get(rid, []), pol.signal,
                                    pol.window)
            return (out, m if m is not None else 0.0, rid)
        return min(rids, key=load)

    # -- daemon --------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop_ev.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="butterfly-autoscale")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop_ev.wait(self.interval_s):
            try:
                self.step()
            except Exception as e:  # never kill the loop from one step
                self._c_errors.inc()
                self.state.flightrec.note(
                    "scale_error", tier="*", direction="none",
                    reason="step_raised",
                    error=f"{type(e).__name__}: {e}")

    def stop(self) -> None:
        self._stop_ev.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    # -- reporting -----------------------------------------------------------

    def stats(self) -> Dict:
        """Benchmark/acceptance summary: cost integral + action log."""
        acted = [d for d in self.decisions if d.direction is not None]
        return {
            "replica_seconds": round(self.replica_seconds, 3),
            "steps": len(self.decisions),
            "scale_ups": sum(1 for d in acted if d.direction == "up"),
            "scale_downs": sum(1 for d in acted if d.direction == "down"),
            "events": [
                {"t": d.t, "tier": d.tier, "direction": d.direction,
                 "reason": d.reason, "rid": d.rid,
                 "value": d.value} for d in acted],
        }
