"""PyTorch port: seeded fault injection (fleet/chaos.py), held against the
JAX package's, and the chaos bench leg on the CPU.

The chaos plan is a stdlib copy: the same seed gives the same
`default_plan` rules and, over one fixed sequence of (replica identity,
endpoint, scope) calls, the same injection decisions, log and per-rule
budgets in both packages. A tiny chaos soak (obs/benchmark.py:
run_chaos_benchmark on a CPU 2p2d fleet) ends every request in a
terminal outcome while faults fire, and returns the JAX leg's keys.
"""
import ast
import inspect
import textwrap

import numpy as np
import pytest
import torch

from butterfly_tpu.fleet import chaos as JC
from butterfly_tpu.obs import benchmark as JB
from butterfly_tpu_torch.fleet import chaos as TC
from butterfly_tpu_torch.obs import benchmark as TB

torch.set_num_threads(1)

ENDPOINTS = ["/generate", "/kv/pages", "/kv/import", "/health",
             "/v1/completions"]


def _idents(C):
    return [C.ChaosIdent(f"127.0.0.1:{9001 + i}", role, idx)
            for i, (role, idx) in enumerate(
                [("prefill", 0), ("prefill", 1), ("decode", 0),
                 ("decode", 1), ("both", 0)])]


def _drive(plan, C, calls):
    idents = _idents(C)
    out = []
    for who, ep, where in calls:
        inj = plan.decide(idents[who], ep, where=where)
        out.append(None if inj is None else (inj.kind, inj.delay_s))
    return out


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_default_plan_decisions_match_reference(seed):
    jplan, tplan = JC.default_plan(seed=seed), TC.default_plan(seed=seed)
    assert tplan.summary() == jplan.summary()
    rng = np.random.default_rng(seed)
    calls = [(int(rng.integers(5)), ENDPOINTS[int(rng.integers(5))],
              str(rng.choice(["replica", "call"]))) for _ in range(400)]
    got, want = _drive(tplan, TC, calls), _drive(jplan, JC, calls)
    assert got == want
    assert tplan.log == jplan.log
    assert tplan.summary() == jplan.summary()
    assert jplan.total_injected > 0


PLANS = [
    {"seed": 42, "faults": [
        {"kind": "wedge", "target": "decode:0", "endpoint": "/generate",
         "p": 0.5, "count": 5},
        {"kind": "delay", "target": "*", "p": 0.25, "count": 10,
         "delay_s": 0.01}]},
    {"seed": 7, "faults": [
        {"kind": "drop", "target": "prefill", "where": "call", "p": 0.3},
        {"kind": "truncate", "target": "127.0.0.1:9003", "p": 0.6,
         "count": 3},
        {"kind": "error", "target": "*", "endpoint": "/health", "p": 1.0,
         "count": 2}]},
    {"seed": 1},
    {"faults": [{"kind": "explode"}]},
    {"faults": [{"kind": "drop", "p": 1.5}]},
    {"faults": [{"kind": "drop", "count": 0}]},
    {"faults": [{"kind": "drop", "where": "everywhere"}]},
]


@pytest.mark.parametrize("spec", PLANS, ids=range(len(PLANS)))
def test_plan_from_json_matches_reference(spec):
    """Valid plans decide identically; invalid ones raise the same
    error in both packages."""
    try:
        jplan = JC.ChaosPlan.from_json(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TC.ChaosPlan.from_json(spec)
        assert str(got.value) == str(e)
        return
    tplan = TC.ChaosPlan.from_json(spec)
    calls = [(i % 5, ENDPOINTS[i % 4], "replica" if i % 3 else "call")
             for i in range(120)]
    assert _drive(tplan, TC, calls) == _drive(jplan, JC, calls)
    assert tplan.summary() == jplan.summary()


def _jax_leg_keys(fn):
    """The string keys of the dict literal a JAX bench leg returns."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    ret = [n for n in ast.walk(tree) if isinstance(n, ast.Return)][-1]
    return {k.value for k in ret.value.keys if k is not None}


def test_chaos_leg_ends_every_request_terminal():
    """The chaos leg on a CPU 2p2d fleet (2 clients x 3 requests plus the
    spent-deadline burst): every request terminal, faults injected, the
    expiry burst's 504s counted, and the JAX leg's keys."""
    out = TB.run_chaos_benchmark("2p2d", clients=2, requests_per_client=3,
                                 max_tokens=4, device="cpu")
    assert set(out) == _jax_leg_keys(JB.run_chaos_benchmark)
    assert out["chaos_requests"] == 9
    assert out["chaos_unterminal"] == 0
    assert out["chaos_terminal"] == out["chaos_requests"]
    assert out["chaos_injected"] > 0
    assert out["chaos_deadline_504"] >= 3
