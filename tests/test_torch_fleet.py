"""PyTorch port: the in-process fleet (fleet/harness.py behind the control
plane, fleet/controlplane.py), held against the JAX package's fleet.

Both packages start a 1p1d fleet on the tiny model at the JAX fleet
tests' size (f32, page 8, max_batch 2, max_seq 128, threshold 16); the
port's replicas run on the CPU with the JAX tree converted through
models/bridge.py. The same greedy prompts through both control planes
give byte-identical tokens, equal handoff metadata and equal transfer
counters, and /health and /fleet/state carry the same keys. Port only:
the /kv round trip lands identical page bytes, spawn / retire serve and
free the retired replica, the fleet bench leg's rolling drain/restart
soak drops nothing, and the `fleet` CLI defaults to CUDA.
"""
import ast
import inspect
import json
import subprocess
import sys
import textwrap
import urllib.request
import weakref
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from butterfly_tpu.cache.prefix import chain_block_hashes
from butterfly_tpu.core.config import tiny as jtiny
from butterfly_tpu.fleet.harness import start_fleet as jstart_fleet
from butterfly_tpu.models.common import Model as JModel
from butterfly_tpu.obs import benchmark as JB
from butterfly_tpu_torch.core.config import tiny
from butterfly_tpu_torch.fleet.harness import start_fleet
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.models.common import Model
from butterfly_tpu_torch.obs import benchmark as TB
from butterfly_tpu_torch.serve.cli import main as cli_main

torch.set_num_threads(1)

PAGE = 8
FLEET_KW = dict(page_size=PAGE, max_batch=2, max_seq=128,
                disagg_threshold=16, slo_ttft_s=120.0, slo_itl_s=120.0)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def fleets():
    jmodel = JModel(jtiny("llama", dtype="float32", param_dtype="float32"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = Model(tiny("llama", dtype="float32", param_dtype="float32"),
                   device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    jf = jstart_fleet("1p1d", model=jmodel, params=jparams, **FLEET_KW)
    try:
        tf = start_fleet("1p1d", model=tmodel, params=tparams,
                         device="cpu", **FLEET_KW)
    except BaseException:
        jf.stop()
        raise
    yield jf, tf
    jf.stop()
    tf.stop()


def post(url, path, obj, timeout=60):
    req = urllib.request.Request(
        url + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def get(url, path, timeout=30):
    with urllib.request.urlopen(url + path, timeout=timeout) as resp:
        return json.loads(resp.read())


def _prompts():
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 258, 24).tolist()
    return [rng.integers(1, 258, 40).tolist(),
            shared + rng.integers(1, 258, 9).tolist(),
            shared + rng.integers(1, 258, 17).tolist(),
            rng.integers(1, 258, 5).tolist(),      # under the threshold
            rng.integers(1, 258, 61).tolist()]


HANDOFF_KEYS = ("disaggregated", "kv_pages_imported", "stopped")


def test_greedy_tokens_and_transfer_counters_match_reference(fleets):
    """The same prompts, in the same order, through both control planes:
    identical tokens and handoff metadata per request, then equal
    fleet_disaggregated / kv_transfer_pages / kv_transfer_bytes."""
    jf, tf = fleets
    for prompt in _prompts():
        body = {"tokens": prompt, "max_tokens": 8, "stop_token": -1}
        want, got = post(jf.url, "/generate", body), \
            post(tf.url, "/generate", body)
        assert got["tokens"] == want["tokens"]
        assert len(got["tokens"]) == 8
        for k in HANDOFF_KEYS:
            assert got.get(k) == want.get(k), k
    jc, tc = jf.state.fleet_counters(), tf.state.fleet_counters()
    assert tc == jc
    assert jc["disagg_requests"] == 4 and jc["kv_transfer_pages"] > 0
    jm, tm = get(jf.url, "/fleet/state")["metrics"], \
        get(tf.url, "/fleet/state")["metrics"]
    for k in ("disagg_requests", "kv_transfer_pages", "kv_transfer_bytes"):
        assert tm[k] == jm[k], k


def test_health_and_fleet_state_keys_match_reference(fleets):
    jf, tf = fleets
    for jr, tr in zip(jf.replicas, tf.replicas):
        jh, th = get(jr.url, "/health"), get(tr.url, "/health")
        assert set(th) == set(jh)
        assert th["role"] == jh["role"] == jr.role
    js, ts = get(jf.url, "/fleet/state"), get(tf.url, "/fleet/state")
    assert set(ts) == set(js)
    assert set(ts["metrics"]) == set(js["metrics"])
    assert set(ts["tiers"]) == set(js["tiers"])
    assert [set(r) for r in ts["replicas"]] == \
        [set(r) for r in js["replicas"]]


def test_kv_roundtrip_lands_identical_page_bytes(fleets):
    """Export a prompt's pages from the prefill replica, import them into
    the decode replica, export the same hashes from there: the page
    bytes of the two exports are identical."""
    _, tf = fleets
    pre, dec = tf.replicas
    prompt = list(range(100, 132))   # 4 full pages
    post(pre.url, "/generate", {"tokens": prompt, "max_tokens": 1,
                                "stop_token": -1})
    hashes = ",".join(h.hex() for h in chain_block_hashes(prompt, PAGE))
    a = get(pre.url, f"/kv/pages?hashes={hashes}")
    assert len(a["pages"]) == 4 and a["bytes"] > 0
    res = post(dec.url, "/kv/import", a)
    assert res["imported"] + res["skipped"] == 4
    b = get(dec.url, f"/kv/pages?hashes={hashes}")
    assert b["pages"] == a["pages"] and b["bytes"] == a["bytes"]


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def test_spawn_serves_and_retire_frees_the_replica(fleets):
    """spawn("decode") joins a warm replica that answers; retire drains
    and stops it, detaches it from the pool and frees its engine (no
    reference to its KV pool survives the retire)."""
    _, tf = fleets
    handle = tf.spawn("decode")
    try:
        assert handle.role == "decode" and handle.rid in tf.by_rid
        # one weight tree for every replica: the same tensors, not copies
        assert all(a is b for a, b in zip(
            _leaves(handle.sched.engine.params),
            _leaves(tf.replicas[0].sched.engine.params)))
        r = post(handle.url, "/generate", {"tokens": [5, 6, 7, 8],
                                           "max_tokens": 3})
        assert len(r["tokens"]) == 3
        state = get(tf.url, "/fleet/state")
        assert handle.rid in state["tiers"]["decode"]
        engine = weakref.ref(handle.sched.engine)
        rid = handle.rid
    finally:
        del handle
    assert tf.retire("127.0.0.1:1") is False
    assert tf.retire(rid) is True
    assert engine() is None, "the retired replica's engine is still alive"
    assert rid not in tf.by_rid and tf.state.pool.get(rid) is None
    assert len(tf.replicas) == 2


def _jax_leg_keys(fn):
    """The string keys of the dict literal a JAX bench leg returns."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    ret = [n for n in ast.walk(tree) if isinstance(n, ast.Return)][-1]
    return {k.value for k in ret.value.keys if k is not None}


def test_fleet_leg_rolling_restart_drops_nothing():
    """The fleet bench leg on a CPU 2p2d fleet (2 clients x 3 requests):
    the direct phase, then the disaggregated soak through a rolling
    drain/restart of all four replicas with zero dropped requests and
    pages transferred; the JAX leg's keys."""
    out = TB.run_fleet_benchmark("2p2d", clients=2, requests_per_client=3,
                                 max_tokens=4, device="cpu")
    assert set(out) == _jax_leg_keys(JB.run_fleet_benchmark)
    assert out["fleet_dropped"] == 0
    assert out["fleet_requests"] == 6
    assert out["fleet_rolling_cycles"] == 4
    assert out["fleet_disaggregated"] > 0
    assert out["kv_transfer_pages"] > 0


def test_fleet_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main(["fleet", "--topology", "1p1d"])


def test_fleet_cli_on_cpu_serves_the_control_plane():
    """`fleet --topology 1p1d --device cpu` starts, prints the control
    plane's URL, and answers /fleet/state there."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "butterfly_tpu_torch.serve.cli", "fleet",
         "--topology", "1p1d", "--device", "cpu"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        url = None
        for line in proc.stdout:
            if "control plane:" in line:
                url = line.split("control plane:")[1].split()[0]
                break
        assert url is not None, "no control-plane line"
        state = get(url, "/fleet/state")
        assert set(state["tiers"]) >= {"prefill", "decode"}
    finally:
        proc.terminate()
        proc.wait(timeout=30)
