"""PyTorch port: KV page transfer (fleet/kvtransfer.py) and the /kv/*
endpoints, on tiny llama on the CPU.

Port to port: an export imported into a second engine lands the same
bits (float and int8 pools), the importing side's next admission hits
the imported pages, and its greedy tokens equal a local prefill's. Port
against JAX: the payload has the reference's structure (keys, hashes,
missing, geometry, including "dtype": "bfloat16" for a bf16 pool), its
f32 page values are within 2e-5 of the reference's, and a JAX bf16
payload decodes in the port to the reference's bytes. Over HTTP: GET
/kv/pages -> POST /kv/import between two in-process servers, and a
geometry mismatch answers 409."""
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from butterfly_tpu.cache.prefix import chain_block_hashes
from butterfly_tpu.core.config import RuntimeConfig as JRuntime, tiny
from butterfly_tpu.engine.serving import ServingEngine as JEngine
from butterfly_tpu.fleet import kvtransfer as JK
from butterfly_tpu.models.common import Model as JModel
from butterfly_tpu.sched.scheduler import Scheduler as JScheduler
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.engine.serving import ServingEngine
from butterfly_tpu_torch.fleet import kvtransfer as TK
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.models.common import Model
from butterfly_tpu_torch.sched.scheduler import Scheduler
from butterfly_tpu_torch.serve.server import ServerState, make_handler
from butterfly_tpu_torch.utils.tokenizer import ByteTokenizer

torch.set_num_threads(1)

PAGE = 8
PROMPT = list(range(1, 41))   # 5 full pages
TOL = 2e-5


def _cfgs(dtype):
    return (tiny("llama", dtype=dtype, param_dtype="float32"),
            tconfig.tiny("llama", dtype=dtype, param_dtype="float32"))


@pytest.fixture(scope="module")
def weights():
    jp = JModel(_cfgs("float32")[0]).init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _rt(mod, **kw):
    return mod(max_batch_size=2, max_seq_len=128, page_size=PAGE,
               prefix_caching=True, **kw)


def _port(tp, dtype="float32", **kw):
    return Scheduler(ServingEngine(Model(_cfgs(dtype)[1], device="cpu"), tp,
                                   _rt(tconfig.RuntimeConfig, **kw)))


def _run(sched, prompt, n):
    r = sched.submit(prompt, max_new_tokens=n, stop_token=-1)
    sched.run_until_done()
    assert r.state == "finished"
    return r.output


def _hexes(prompt):
    return [h.hex() for h in chain_block_hashes(prompt, PAGE)]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_port_to_port_roundtrip_is_bit_exact(weights, kv_quant):
    _, tp = weights
    a = _port(tp, kv_quant=kv_quant)
    first = _run(a, PROMPT, 1)
    payload = TK.export_payload(a, _hexes(PROMPT))
    assert [p["hash"] for p in payload["pages"]] == _hexes(PROMPT)
    assert payload["missing"] == [] and payload["bytes"] > 0
    json.dumps(payload)                                 # JSON-safe
    src = a.engine.read_pages([a.alloc.lookup(bytes.fromhex(h))
                               for h in _hexes(PROMPT)])

    b = _port(tp, kv_quant=kv_quant)
    res = TK.import_payload(b, payload)
    assert res["imported"] == 5 and not res["no_space"]
    dst = b.engine.read_pages([b.alloc.lookup(bytes.fromhex(h))
                               for h in _hexes(PROMPT)])
    for x, y in zip(src, dst):
        assert (x is None and y is None) or torch.equal(x, y)
    assert TK.import_payload(b, payload)["skipped"] == 5   # idempotent
    # B continues from A's first token with a full-prefix hit, and the
    # two halves equal one local run
    rest = _run(b, PROMPT + first, 7)
    assert b.alloc.hit_tokens == 40
    local = _run(_port(tp, kv_quant=kv_quant), PROMPT, 8)
    assert first + rest == local


def test_import_refuses_bad_payloads(weights):
    _, tp = weights
    a = _port(tp)
    _run(a, PROMPT[:16], 1)
    payload = TK.export_payload(a, _hexes(PROMPT[:16]))
    b = _port(tp)
    with pytest.raises(ValueError, match="geometry"):
        TK.import_payload(b, {**payload, "meta": {**payload["meta"],
                                                  "page_size": 16}})
    with pytest.raises(ValueError, match="version"):
        TK.import_payload(b, {**payload, "version": 99})
    short = json.loads(json.dumps(payload))
    short["pages"][0]["k"]["shape"][0] += 1
    with pytest.raises(ValueError, match="bytes"):
        TK.import_payload(b, short)
    plain = Scheduler(ServingEngine(
        Model(_cfgs("float32")[1], device="cpu"), tp,
        tconfig.RuntimeConfig(max_batch_size=2, max_seq_len=64,
                              page_size=PAGE)))
    with pytest.raises(LookupError, match="prefix caching"):
        TK.export_payload(plain, _hexes(PROMPT[:16]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_payload_matches_the_jax_payload(weights, dtype):
    jp, tp = weights
    jcfg = _cfgs(dtype)[0]
    js = JScheduler(JEngine(JModel(jcfg), jp, _rt(JRuntime),
                            use_kernels=False))
    ts = _port(tp, dtype=dtype)
    hexes = _hexes(PROMPT)
    other = chain_block_hashes(list(range(50, 70)), PAGE)[0].hex()
    for s in (js, ts):
        _run(s, PROMPT, 1)
    want = JK.export_payload(js, hexes + [other])
    got = TK.export_payload(ts, hexes + [other])
    assert got.keys() == want.keys()
    assert got["meta"] == want["meta"]
    assert got["meta"]["dtype"] == dtype
    assert got["missing"] == want["missing"] == [other]
    assert got["bytes"] == want["bytes"]
    assert [p["hash"] for p in got["pages"]] == \
        [p["hash"] for p in want["pages"]] == hexes
    for pg, pw in zip(got["pages"], want["pages"]):
        assert pg.keys() == pw.keys()
        for key in ("k", "v"):
            assert pg[key]["dtype"] == pw[key]["dtype"] == dtype
            assert pg[key]["shape"] == pw[key]["shape"]
            # the JAX payload's bytes decode in the port to the same
            # values the reference decodes
            ref = np.asarray(JK._dec(pw[key]), np.float32)
            assert np.array_equal(TK._dec(pw[key]).float().numpy(), ref)
            tol = TOL if dtype == "float32" else 2e-2
            np.testing.assert_allclose(TK._dec(pg[key]).float().numpy(),
                                       ref, atol=tol, rtol=0)


@pytest.fixture(scope="module")
def two_servers(weights):
    from http.server import ThreadingHTTPServer
    _, tp = weights
    out, stops = [], []
    for _ in range(2):
        state = ServerState(_port(tp), ByteTokenizer())
        state.thread.start()
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        out.append(f"http://127.0.0.1:{httpd.server_port}")
        stops.append((state, httpd))
    yield out
    for state, httpd in stops:
        state.stop.set()
        httpd.shutdown()
        httpd.server_close()


def _post(url, path, obj):
    req = urllib.request.Request(url + path, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as resp:
        return json.loads(resp.read())


def test_kv_endpoints_roundtrip_over_http(two_servers):
    pre, dec = two_servers
    prompt = list(range(1, 25))                  # 3 full pages
    first = _post(pre, "/generate", {"tokens": prompt, "max_tokens": 1,
                                     "stop_token": -1})["tokens"]
    payload = _get(pre, "/kv/pages?hashes=" + ",".join(_hexes(prompt)))
    assert len(payload["pages"]) == 3 and payload["bytes"] > 0
    assert _post(dec, "/kv/import", payload)["imported"] == 3
    rest = _post(dec, "/generate", {"tokens": prompt + first,
                                    "max_tokens": 5,
                                    "stop_token": -1})["tokens"]
    local = _post(pre, "/generate", {"tokens": prompt, "max_tokens": 6,
                                     "stop_token": -1})["tokens"]
    assert first + rest == local
    bad = dict(payload, meta={**payload["meta"],
                              "num_layers": payload["meta"]["num_layers"]
                              + 1})
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(dec, "/kv/import", bad)
    assert e.value.code == 409
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(pre, "/kv/pages?hashes=nothex")
    assert e.value.code == 400
