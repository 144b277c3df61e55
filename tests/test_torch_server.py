"""PyTorch port: the HTTP server in-process on the CPU with tiny llama.

/generate (blocking and SSE), /v1/completions, /health and /metrics
answer as in the JAX package; greedy /generate text on the bridged JAX
weights equals ByteTokenizer.decode of the JAX Scheduler's greedy tokens;
/kv/* and /debug/profile answer 501 until their slices; `serve`'s
startup machinery builds on the CPU and refuses unported flags."""
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from butterfly_tpu.core.config import RuntimeConfig, tiny
from butterfly_tpu.engine.serving import ServingEngine as JEngine
from butterfly_tpu.models.common import Model as JModel
from butterfly_tpu.sched.scheduler import Scheduler as JScheduler
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.engine.serving import ServingEngine
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.models.common import Model
from butterfly_tpu_torch.sched.scheduler import Scheduler
from butterfly_tpu_torch.serve.server import ServerState, make_handler
from butterfly_tpu_torch.utils.tokenizer import ByteTokenizer

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls

CFG = tiny("llama", dtype="float32", param_dtype="float32")
TCFG = tconfig.tiny("llama", dtype="float32", param_dtype="float32")
RT = dict(max_batch_size=2, max_seq_len=64, page_size=8)


@pytest.fixture(scope="module")
def jax_params():
    return JModel(CFG).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def server(jax_params):
    from http.server import ThreadingHTTPServer

    from butterfly_tpu_torch.obs.ticklog import FlightRecorder
    from butterfly_tpu_torch.obs.trace import Tracer
    params = params_from_numpy(jax.tree.map(np.asarray, jax_params),
                               device="cpu")
    engine = ServingEngine(Model(TCFG, device="cpu"), params,
                           tconfig.RuntimeConfig(**RT))
    sched = Scheduler(engine, tracer=Tracer(), flightrec=FlightRecorder())
    state = ServerState(sched, ByteTokenizer())
    state.thread.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_port}"
    state.stop.set()
    httpd.shutdown()
    httpd.server_close()


def post(url, path, obj, raw=False):
    req = urllib.request.Request(
        url + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    resp = urllib.request.urlopen(req, timeout=120)
    return resp if raw else json.loads(resp.read())


def get(url, path):
    return urllib.request.urlopen(url + path, timeout=30).read().decode()


def test_health_and_metrics(server):
    body = json.loads(get(server, "/health"))
    assert body["status"] == "ok" and body["queue_depth"] >= 0
    post(server, "/generate", {"prompt": "hi", "max_tokens": 3,
                               "stop_token": -1})
    text = get(server, "/metrics")
    assert "tokens_generated_total" in text and "ttft_seconds_bucket" in text


def test_generate_blocking_and_sse(server):
    out = post(server, "/generate",
               {"prompt": "hello", "max_tokens": 5, "stop_token": -1})
    assert len(out["tokens"]) == 5 and out["ttft_s"] >= 0
    resp = post(server, "/generate", {"prompt": "hello", "max_tokens": 5,
                                      "stop_token": -1, "stream": True},
                raw=True)
    assert resp.headers["Content-Type"] == "text/event-stream"
    events = [ln[6:] for ln in resp.read().decode().splitlines()
              if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    toks = [json.loads(e)["token"] for e in events[:-1]]
    assert toks == out["tokens"]  # greedy: streaming changes nothing


def test_completions(server):
    out = post(server, "/v1/completions",
               {"prompt": "abc", "max_tokens": 4, "stop_token": -1})
    assert out["object"] == "text_completion"
    assert out["usage"]["completion_tokens"] == 4
    assert out["choices"][0]["finish_reason"] == "length"


def test_greedy_text_matches_jax_scheduler(server, jax_params):
    prompt = "The paged pool"
    tok = ByteTokenizer()
    sched = JScheduler(JEngine(JModel(CFG), jax_params, RuntimeConfig(**RT)))
    req = sched.submit(tok.encode(prompt), max_new_tokens=12,
                       stop_token=-1)
    sched.run_until_done()
    out = post(server, "/generate",
               {"prompt": prompt, "max_tokens": 12, "stop_token": -1})
    assert out["tokens"] == req.output
    assert out["text"] == tok.decode(req.output)


@pytest.mark.parametrize("method,path", [("GET", "/kv/pages?hashes=00ff"),
                                         ("POST", "/kv/import"),
                                         ("POST", "/debug/profile")])
def test_unported_endpoints_answer_501(server, method, path):
    data = json.dumps({"duration_ms": 10}).encode() \
        if method == "POST" else None
    req = urllib.request.Request(server + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 501
    assert "not ported" in e.value.read().decode()


def test_serve_machinery_builds_on_cpu():
    from butterfly_tpu_torch.serve.cli import build_parser
    from butterfly_tpu_torch.serve.server import build_serving
    args = build_parser().parse_args(
        ["serve", "--model", "tiny", "--device", "cpu", "--max-seq", "128",
         "--port", "0", "--timeseries-interval", "0"])
    sched, tok, rt = build_serving(args)
    assert sched.engine.device.type == "cpu"
    assert rt.mixed_dispatch and rt.kv_write_combine
    assert sched.metrics()["tokens_generated_total"] > 0  # the warm-up ran
    for flag in (["--speculate", "2"], ["--prefix-caching"],
                 ["--quant", "int8"], ["--tensor-parallel", "2"],
                 ["--ckpt", "x"]):
        args = build_parser().parse_args(
            ["serve", "--model", "tiny", "--device", "cpu"] + flag)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            build_serving(args)
