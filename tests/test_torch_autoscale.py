"""PyTorch port: the closed-loop autoscaler (fleet/autoscale.py), held
against the JAX package's, and the autoscale bench leg on the CPU.

The autoscaler is a stdlib copy: the same synthetic signal series (seeded
queue-depth rings and shed counters fed into fake pools, the JAX test's
idiom) must give the same decision log, the same spawn / retire calls
and the same cost integral in both packages. The bench leg
(obs/benchmark.py:run_autoscale_benchmark) runs once on the CPU at a
reduced ramp and returns the JAX leg's keys.
"""
import ast
import dataclasses
import inspect
import textwrap

import numpy as np
import pytest
import torch

from butterfly_tpu.fleet import autoscale as JA
from butterfly_tpu.obs import benchmark as JB
from butterfly_tpu.obs.registry import MetricsRegistry as JRegistry
from butterfly_tpu.obs.ticklog import FlightRecorder as JFlightRecorder
from butterfly_tpu.router.pool import ReplicaPool as JPool
from butterfly_tpu_torch.fleet import autoscale as TA
from butterfly_tpu_torch.obs import benchmark as TB
from butterfly_tpu_torch.obs.registry import MetricsRegistry as TRegistry
from butterfly_tpu_torch.obs.ticklog import FlightRecorder as TFlightRecorder
from butterfly_tpu_torch.router.pool import ReplicaPool as TPool

torch.set_num_threads(1)


class FakeState:
    """The slice of ControlPlaneState the autoscaler reads."""

    def __init__(self, pool, registry, flightrec):
        self.pool = pool
        self.registry = registry
        self.flightrec = flightrec


class FakeFleet:
    """spawn / retire as pool membership changes, recorded."""

    def __init__(self, pool):
        self.pool = pool
        self.calls = []
        self._port = 9500

    def spawn(self, role):
        rid = f"127.0.0.1:{self._port}"
        self._port += 1
        self.pool.add(rid)
        self.pool.replicas[rid].role = role
        self.calls.append(("spawn", role, rid))
        return rid

    def retire(self, rid):
        self.pool.remove(rid)
        self.calls.append(("retire", rid))
        return True


def _scaler(A, Pool, Registry, FlightRecorder, roles, policies):
    specs = [f"127.0.0.1:{9001 + i}" for i in range(len(roles))]
    pool = Pool(specs, probe_interval=999.0)
    for spec, role in zip(specs, roles):
        pool.replicas[spec].role = role
    fleet = FakeFleet(pool)
    state = FakeState(pool, Registry(), FlightRecorder())
    pols = [A.TierPolicy(**p) for p in policies]
    return A.Autoscaler(state, fleet.spawn, fleet.retire, pols), pool, fleet


def _shed_families(total):
    return {"butterfly_shed_total": {
        "type": "counter",
        "samples": {("butterfly_shed_total", (("priority", "batch"),)):
                    float(total)}}}


POLICIES = [
    dict(role="prefill", min_replicas=1, max_replicas=3, high=4.0, low=0.5,
         window=2, cooldown_up_s=1.0, cooldown_down_s=3.0),
    dict(role="decode", min_replicas=1, max_replicas=4, high=3.0, low=1.0,
         window=3, cooldown_up_s=0.5, cooldown_down_s=5.0),
]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decision_log_matches_reference(seed):
    """80 steps of a seeded signal series (regimes of high, in-band and
    idle queue depth per tier, plus shed-counter bursts) fed identically
    into both packages' pools: every step's decisions, the spawn / retire
    calls, the pool membership and the stats are equal."""
    roles = ["prefill", "decode", "decode"]
    j, jpool, jfleet = _scaler(JA, JPool, JRegistry, JFlightRecorder, roles,
                               POLICIES)
    t, tpool, tfleet = _scaler(TA, TPool, TRegistry, TFlightRecorder, roles,
                               POLICIES)
    rng = np.random.default_rng(seed)
    shed = {}
    now = 100.0
    for step in range(80):
        regime = {"prefill": rng.choice([0.1, 2.0, 8.0]),
                  "decode": rng.choice([0.2, 2.0, 6.0])}
        rids = sorted(jpool.replicas)
        assert rids == sorted(tpool.replicas)
        for rid in rids:
            role = jpool.replicas[rid].role
            depth = float(regime[role] * rng.uniform(0.5, 1.5))
            burst = rng.random() < 0.05
            shed[rid] = shed.get(rid, 0.0) + (4.0 if burst else 0.0)
            for pool in (jpool, tpool):
                rep = pool.replicas[rid]
                rep.series.append({"t_wall": now,
                                   "signals": {"queue_depth": depth}})
                rep.metrics_families = _shed_families(shed[rid])
        now += float(rng.uniform(0.2, 1.5))
        jd = [dataclasses.asdict(d) for d in j.step(now=now)]
        td = [dataclasses.asdict(d) for d in t.step(now=now)]
        assert td == jd, step
    assert tfleet.calls == jfleet.calls
    assert t.stats() == j.stats()
    assert any(c[0] == "spawn" for c in jfleet.calls)
    assert any(c[0] == "retire" for c in jfleet.calls)


def _jax_leg_keys(fn):
    """The string keys of the dict literal a JAX bench leg returns."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    ret = [n for n in ast.walk(tree) if isinstance(n, ast.Return)][-1]
    return {k.value for k in ret.value.keys if k is not None}


def test_autoscale_leg_on_cpu_has_reference_keys():
    """The autoscale leg on the CPU, a short ramp (1p1d, 2 clients x 3
    requests, ramp 4 -> 40 req/s over 1 s, 2 s settle): the JAX leg's
    keys, every request answered."""
    out = TB.run_autoscale_benchmark(
        "1p1d", clients=2, requests_per_client=3, max_tokens=4,
        arrival="ramp:4:40:1", settle_s=2.0, device="cpu")
    assert set(out) == _jax_leg_keys(JB.run_autoscale_benchmark)
    assert out["autoscale_requests"] == 6
    assert out["autoscale_dropped"] == 0
    assert out["autoscale_replica_seconds"] > 0
