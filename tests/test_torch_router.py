"""PyTorch port: the router tier (router/), held against the JAX package.

The router is a stdlib copy, so the same inputs must give the same
results in both packages: `extract_route_tokens` on request bodies,
`affinity_key` and the hash ring on seeded prompts, and the pool and
policy under one seeded sequence of state changes (snapshots and plans
compared after every step). Then the plain router in front of two port
replicas on the CPU gives the tokens a direct request to one of them
gives.
"""
import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from butterfly_tpu.router import policy as JP
from butterfly_tpu.router import pool as JPool
from butterfly_tpu.router import proxy as JX
from butterfly_tpu_torch.core.config import RuntimeConfig, tiny
from butterfly_tpu_torch.engine.serving import ServingEngine
from butterfly_tpu_torch.models.common import Model, init_params
from butterfly_tpu_torch.obs.registry import MetricsRegistry
from butterfly_tpu_torch.router import policy as TP
from butterfly_tpu_torch.router import pool as TPool
from butterfly_tpu_torch.router import proxy as TX
from butterfly_tpu_torch.sched.scheduler import Scheduler
from butterfly_tpu_torch.serve.server import ServerState, make_handler
from butterfly_tpu_torch.utils.tokenizer import ByteTokenizer

torch.set_num_threads(1)

PAGE = 8
RIDS = ["127.0.0.1:9101", "127.0.0.1:9102", "127.0.0.1:9103",
        "127.0.0.1:9104"]

BODIES = [
    json.dumps({"tokens": [1, 2, 3]}).encode(),
    json.dumps({"prompt": [4, 5]}).encode(),
    json.dumps({"prompt": "hi"}).encode(),
    json.dumps({"prompt": "snow ☃ man", "max_tokens": 3}).encode(),
    json.dumps({"prompt": 7}).encode(),
    json.dumps({"tokens": "not a list"}).encode(),
    b"not json",
    b"",
]


@pytest.mark.parametrize("body", BODIES, ids=range(len(BODIES)))
def test_extract_route_tokens_matches_reference(body):
    assert TX.extract_route_tokens(body) == JX.extract_route_tokens(body)


def test_affinity_key_and_ring_match_reference():
    """Seeded prompts of 0-80 tokens, page sizes 4/8/16, 1-4 blocks: equal
    affinity keys, and the ring orders every rid the same way."""
    rng = np.random.default_rng(0)
    jring, tring = JP.HashRing(RIDS), TP.HashRing(RIDS)
    for _ in range(60):
        toks = rng.integers(0, 258, int(rng.integers(0, 81))).tolist()
        page = int(rng.choice([4, 8, 16]))
        blocks = int(rng.integers(1, 5))
        jk = JP.affinity_key(toks, page, blocks)
        assert TP.affinity_key(toks, page, blocks) == jk
        if jk is not None:
            assert tring.ordered(jk) == jring.ordered(jk)


def _pools():
    out = []
    for P, Pol in ((JPool, JP), (TPool, TP)):
        pool = P.ReplicaPool(list(RIDS), probe_interval=999.0,
                             breaker_threshold=2, breaker_cooldown=999.0)
        out.append((pool, Pol.PrefixAffinityPolicy(
            pool, page_size=PAGE, affinity_blocks=2, saturate_after=3)))
    return out


def _snap(pool):
    return sorted(pool.snapshot(), key=lambda s: s["replica"])


def _plan(policy, toks, role):
    cands, aff = policy.plan(toks, role=role)
    return [r.rid for r in cands], aff


def test_pool_and_policy_state_changes_match_reference():
    """One seeded sequence of the proxy's and prober's feedback calls
    (dispatch / done, connect failures, wedged 503s, leg failures and
    successes, drain, role and page-headroom scrapes, membership
    changes) applied to both pools: identical snapshots and identical
    plans for seeded prompts after every step."""
    (jpool, jpol), (tpool, tpol) = _pools()
    rng = np.random.default_rng(1)
    ops = ["dispatch", "done", "connect_failure", "wedged", "leg_failure",
           "leg_ok", "drain", "undrain", "scrape", "add", "remove"]
    next_port = 9200
    for step in range(150):
        op = ops[int(rng.integers(len(ops)))]
        rids = sorted(jpool.replicas)
        rid = rids[int(rng.integers(len(rids)))]
        if op == "add":
            spec = f"127.0.0.1:{next_port}"
            next_port += 1
            for p, pol in ((jpool, jpol), (tpool, tpol)):
                p.add(spec)
                pol.rebuild_ring()
        elif op == "remove":
            if len(rids) > 2:
                for p, pol in ((jpool, jpol), (tpool, tpol)):
                    p.remove(rid)
                    pol.rebuild_ring()
        elif op == "scrape":
            role = str(rng.choice(["prefill", "decode", "both"]))
            free, depth = int(rng.integers(0, 64)), int(rng.integers(0, 5))
            for p in (jpool, tpool):
                r = p.get(rid)
                r.role, r.free_pages, r.queue_depth = role, free, depth
        else:
            for p in (jpool, tpool):
                {"dispatch": lambda: p.note_dispatch(rid),
                 "done": lambda: p.note_done(rid),
                 "connect_failure": lambda: p.note_connect_failure(rid, "x"),
                 "wedged": lambda: p.note_wedged(rid, "503"),
                 "leg_failure": lambda: p.note_leg_failure(rid, "leg"),
                 "leg_ok": lambda: p.note_leg_ok(rid),
                 "drain": lambda: p.set_drain(rid, True),
                 "undrain": lambda: p.set_drain(rid, False)}[op]()
        assert _snap(tpool) == _snap(jpool), (step, op)
        toks = rng.integers(0, 258, int(rng.integers(0, 40))).tolist()
        for role in (None, "prefill", "decode"):
            assert _plan(tpol, toks, role) == _plan(jpol, toks, role), \
                (step, op, role)
    assert tpool.breaker_opens_total() == jpool.breaker_opens_total()


def _replica(model, params):
    rt = RuntimeConfig(max_batch_size=2, max_seq_len=64, page_size=PAGE,
                       num_pages=24, prefix_caching=True)
    state = ServerState(Scheduler(ServingEngine(model, params, rt)),
                        ByteTokenizer())
    state.thread.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return state, httpd


def _post(url, obj):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read()), resp.headers.get("X-Routed-To")


def test_router_in_front_of_port_replicas_matches_direct():
    """`butterfly route` (plain router) over two port replicas sharing one
    tree: each prompt's greedy tokens equal a direct request's, and the
    router says which replica served it."""
    model = Model(tiny("llama", dtype="float32", param_dtype="float32"),
                  device="cpu")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    params = init_params(model.cfg, gen, "cpu")
    reps = [_replica(model, params) for _ in range(2)]
    rids = [f"127.0.0.1:{h.server_port}" for _, h in reps]
    registry = MetricsRegistry()
    pool = TPool.ReplicaPool(rids, probe_interval=0.2, registry=registry)
    policy = TP.PrefixAffinityPolicy(pool, page_size=PAGE,
                                     affinity_blocks=2)
    state = TX.RouterState(pool, policy, registry=registry,
                           read_timeout=60.0)
    router = ThreadingHTTPServer(("127.0.0.1", 0),
                                 TX.make_router_handler(state))
    threading.Thread(target=router.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{router.server_port}"
    try:
        pool.probe_all()
        rng = np.random.default_rng(2)
        for n in (5, 17, 24, 40):
            body = {"tokens": rng.integers(1, 258, n).tolist(),
                    "max_tokens": 6}
            routed, rid = _post(url, body)
            direct, _ = _post(f"http://{rids[0]}", body)
            assert rid in rids
            assert routed["tokens"] == direct["tokens"]
            assert len(routed["tokens"]) == 6
    finally:
        pool.stop()
        router.shutdown()
        router.server_close()
        for st, h in reps:
            st.stop.set()
            h.shutdown()
            h.server_close()
