"""Open-loop arrival processes: offered load the server can't gate.

A closed-loop client (tools/loadgen.py's default) keeps one request in
flight — the server's own latency throttles the offered rate, so queue
growth, shedding, and preemption can never really be forced. These
processes generate **absolute arrival times** independent of service
progress (open loop), the regime where admission control and the page
pool actually get tested:

  Poisson(rate)                memoryless steady offered load
  MarkovOnOff(rate_on, ...)    bursty: ON phases at a high rate
                               alternate with quiet OFF phases
                               (Markov-modulated Poisson — the classic
                               bursty-traffic model; production arrival
                               traces are bursty, Splitwise §3)
  Ramp(rate0, rate1, ramp_s)   linearly ramp the offered rate — the
                               find-the-saturation-point sweep shape

Every process is deterministic given (spec, seed): `times(n, seed)`
returns n ascending arrival offsets (seconds from trace start). All
stdlib (`random.Random`), no numpy. A copy of
butterfly_tpu/workload/arrivals.py.

String specs (CLI / bench / trace headers) parse via `parse_arrival`:

    poisson:8            8 req/s Poisson
    burst:20:0.5:2       ON at 20 req/s for ~0.5s, OFF ~2s (rate 0)
    burst:20:0.5:2:1     ... with a 1 req/s trickle while OFF
    ramp:2:50:10         2 -> 50 req/s over 10s, then hold 50
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import List


def _rng(seed: int) -> random.Random:
    # decorrelate from workload sampling streams (models._stream hashes;
    # arrival processes just offset into a distinct constant)
    return random.Random((seed << 1) ^ 0xA55A5AA5)


@dataclass(frozen=True)
class Poisson:
    """Memoryless arrivals at `rate` requests/second."""
    rate: float

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"poisson rate must be > 0, got {self.rate}")

    def times(self, n: int, seed: int = 0) -> List[float]:
        rng = _rng(seed)
        t, out = 0.0, []
        for _ in range(n):
            dt = rng.expovariate(self.rate)
            t += dt
            out.append(t)
        return out

    def spec(self) -> str:
        return f"poisson:{self.rate:g}"


@dataclass(frozen=True)
class MarkovOnOff:
    """Markov-modulated on/off bursts.

    Exponentially-distributed ON phases (mean `mean_on_s`) emit
    arrivals at `rate_on`; OFF phases (mean `mean_off_s`) at `rate_off`
    (default 0 = silent). Mean offered rate is
    rate_on*p_on + rate_off*(1-p_on) with p_on = on/(on+off), but the
    *instantaneous* rate during a burst is what overruns a page pool
    sized for the mean — the preemption-forcing property the mixed
    bench leans on.
    """
    rate_on: float
    mean_on_s: float
    mean_off_s: float
    rate_off: float = 0.0

    def __post_init__(self):
        if self.rate_on <= 0 or self.mean_on_s <= 0 or self.mean_off_s <= 0:
            raise ValueError("burst rate_on/mean_on_s/mean_off_s must "
                             "be > 0")
        if self.rate_off < 0:
            raise ValueError("burst rate_off must be >= 0")

    def times(self, n: int, seed: int = 0) -> List[float]:
        rng = _rng(seed)
        t, out = 0.0, []
        on = True
        while len(out) < n:
            rate = self.rate_on if on else self.rate_off
            mean = self.mean_on_s if on else self.mean_off_s
            phase_end = t + rng.expovariate(1.0 / mean)
            while len(out) < n and rate > 0:
                gap = rng.expovariate(rate)
                if t + gap > phase_end:
                    break
                t += gap
                out.append(t)
            t = phase_end
            on = not on
        return out

    def spec(self) -> str:
        s = (f"burst:{self.rate_on:g}:{self.mean_on_s:g}"
             f":{self.mean_off_s:g}")
        return s + (f":{self.rate_off:g}" if self.rate_off else "")


@dataclass(frozen=True)
class Ramp:
    """Linear rate ramp rate0 -> rate1 over `ramp_s` seconds, holding
    rate1 after — the ramp-to-saturation shape. Sampled exactly by
    inverting the cumulative intensity Lambda(t) at unit-rate
    exponential marks (inhomogeneous-Poisson inversion, no thinning)."""
    rate0: float
    rate1: float
    ramp_s: float

    def __post_init__(self):
        if self.rate0 < 0 or self.rate1 <= 0 or self.ramp_s <= 0:
            raise ValueError("ramp needs rate0 >= 0, rate1 > 0, "
                             "ramp_s > 0")

    def _invert(self, s: float) -> float:
        """t such that Lambda(t) = s."""
        a = (self.rate1 - self.rate0) / (2.0 * self.ramp_s)
        s_ramp = self.rate0 * self.ramp_s + a * self.ramp_s ** 2
        if s <= s_ramp:
            if abs(a) < 1e-12:  # flat "ramp"
                return s / max(self.rate0, 1e-12)
            # solve a t^2 + rate0 t - s = 0 for the positive root
            return ((-self.rate0
                     + math.sqrt(self.rate0 ** 2 + 4.0 * a * s))
                    / (2.0 * a))
        return self.ramp_s + (s - s_ramp) / self.rate1

    def times(self, n: int, seed: int = 0) -> List[float]:
        rng = _rng(seed)
        s, out = 0.0, []
        for _ in range(n):
            s += rng.expovariate(1.0)
            out.append(self._invert(s))
        return out

    def spec(self) -> str:
        return f"ramp:{self.rate0:g}:{self.rate1:g}:{self.ramp_s:g}"


def parse_arrival(spec: str):
    """Parse an arrival-process string spec (see module docstring)."""
    parts = str(spec).split(":")
    kind, args = parts[0], parts[1:]
    try:
        if kind == "poisson" and len(args) == 1:
            return Poisson(float(args[0]))
        if kind == "burst" and len(args) in (3, 4):
            return MarkovOnOff(float(args[0]), float(args[1]),
                               float(args[2]),
                               float(args[3]) if len(args) == 4 else 0.0)
        if kind == "ramp" and len(args) == 3:
            return Ramp(float(args[0]), float(args[1]), float(args[2]))
    except ValueError as e:
        # re-raise numeric/validation errors with the spec attached
        raise ValueError(f"bad arrival spec {spec!r}: {e}") from None
    raise ValueError(
        f"unknown arrival spec {spec!r}: expected poisson:<rate>, "
        "burst:<rate_on>:<mean_on_s>:<mean_off_s>[:<rate_off>], or "
        "ramp:<rate0>:<rate1>:<ramp_s>")


def assign_arrivals(specs, process, seed: int = 0):
    """Stamp `arrival_s` on each RequestSpec in index order from the
    process's deterministic schedule. Returns `specs` (mutated)."""
    ts = process.times(len(specs), seed)
    for s, t in zip(specs, ts):
        s.arrival_s = t
    return specs
