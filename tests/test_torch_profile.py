"""PyTorch port: profiling (obs/profile.py on torch.profiler) and the
`lint` subcommand, on the CPU.

Held: StepTimer's percentiles equal the JAX package's on the same
latencies; `trace()` writes a Chrome trace holding an `annotate` region;
`start_profiler_server` returns False, never raises, on a bound port and
on a second start, and answers POST /profile with its capture's result
(501 when no serve loop supplies the capture); POST /debug/profile
on a live CPU server answers 200 with a trace of the loop's ticks and
409 while a capture is in flight; `serve --profiler-port` hands its
captures to the loop; `butterfly lint --list-rules` lists the JAX CLI's
rules (the port's own checker; BTF002 not ported).
"""
import contextlib
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from butterfly_tpu.obs.profile import StepTimer as JStepTimer
from butterfly_tpu.serve import cli as jcli
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.engine.serving import ServingEngine
from butterfly_tpu_torch.models.common import Model, init_params
from butterfly_tpu_torch.obs import profile as P
from butterfly_tpu_torch.sched.scheduler import Scheduler
from butterfly_tpu_torch.serve import cli
from butterfly_tpu_torch.serve.server import (ServerState, make_handler,
                                              serve_forever)
from butterfly_tpu_torch.utils.tokenizer import ByteTokenizer

torch.set_num_threads(1)

TCFG = tconfig.tiny("llama", dtype="float32", param_dtype="float32")


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _post(url, obj, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _sched():
    gen = torch.Generator()
    gen.manual_seed(0)
    engine = ServingEngine(Model(TCFG, device="cpu"),
                           init_params(TCFG, gen, "cpu"),
                           tconfig.RuntimeConfig(max_batch_size=2,
                                                 max_seq_len=64, page_size=8))
    return Scheduler(engine)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _listening(sched):
    from http.server import ThreadingHTTPServer
    state = ServerState(sched, ByteTokenizer())
    state.thread.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_port}", state
    finally:
        state.stop.set()
        httpd.shutdown()
        httpd.server_close()
        state.thread.join(timeout=30)


def test_step_timer_percentiles_match_jax():
    lat = np.random.RandomState(0).exponential(0.02, 300).tolist()
    j, t = JStepTimer(capacity=256), P.StepTimer(capacity=256)
    assert t.percentiles() == j.percentiles() == {}
    for timer in (j, t):
        timer._lat.extend(lat)
    assert t.percentiles() == j.percentiles()
    assert t.percentiles()["steps_recorded"] == 256.0
    with t.step():
        pass
    assert t.percentiles()["steps_recorded"] == 256.0


def test_trace_writes_an_annotated_chrome_trace(tmp_path):
    with P.trace(str(tmp_path)):
        with P.annotate("butterfly_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in _events(files[0])}
    assert "butterfly_region" in names
    # one capture at a time: the process-global profiler is free again
    P.start_capture(str(tmp_path / "again"))
    with pytest.raises(P.ProfilerBusy):
        P.start_capture(str(tmp_path / "third"))
    assert os.path.exists(P.stop_capture())


def test_profiler_server_never_raises(tmp_path):
    taken = socket.socket()
    taken.bind(("", 0))
    taken.listen(1)
    try:
        assert P.start_profiler_server(taken.getsockname()[1]) is False
    finally:
        taken.close()
    # no serve loop supplies the capture: listening, but every capture 501s
    port = _free_port()
    assert P.start_profiler_server(port) is True
    try:
        assert P.start_profiler_server(_free_port()) is False  # second start
        with pytest.raises(urllib.error.HTTPError) as none:
            _post(f"http://127.0.0.1:{port}/profile",
                  {"duration_ms": 50, "logdir": str(tmp_path)})
        assert none.value.code == 501
        assert "serve loop" in json.loads(none.value.read())["error"]
    finally:
        P.stop_profiler_server()

    def capture(duration_ms, logdir):
        with P.trace(logdir):
            with P.annotate("captured"):
                time.sleep(duration_ms / 1e3)
        (name,) = os.listdir(logdir)
        return {"trace": os.path.join(logdir, name)}

    port = _free_port()
    assert P.start_profiler_server(port, capture=capture) is True
    try:
        code, body = _post(f"http://127.0.0.1:{port}/profile",
                           {"duration_ms": 50, "logdir": str(tmp_path)})
        assert code == 200 and os.path.exists(body["trace"])
        assert os.path.dirname(body["trace"]) == str(tmp_path)
    finally:
        P.stop_profiler_server()


def test_debug_profile_captures_the_live_loop_and_409s():
    sched = _sched()
    with _listening(sched) as (url, state):
        box = {}

        def long_capture():
            box["res"] = _post(url + "/debug/profile", {"duration_ms": 1500})

        t = threading.Thread(target=long_capture)
        t.start()
        deadline = time.monotonic() + 30
        while not state._profile_active and time.monotonic() < deadline:
            time.sleep(0.01)   # the loop thread has started the capture
        assert state._profile_active
        with pytest.raises(urllib.error.HTTPError) as busy:
            _post(url + "/debug/profile", {"duration_ms": 10})
        assert busy.value.code == 409
        # requests served while the capture runs land in its trace
        _post(url + "/generate", {"prompt": "hi", "max_tokens": 4,
                                  "stop_token": -1})
        t.join(timeout=60)
        assert not t.is_alive()
        code, body = box["res"]
    assert code == 200 and body["files"] and os.path.exists(body["trace"])
    names = {e.get("name") for e in _events(body["trace"])}
    assert any(n and n.startswith("aten::") for n in names)


def test_serve_profiler_port_hands_captures_to_the_loop(tmp_path,
                                                       monkeypatch):
    from butterfly_tpu_torch.serve import server
    states = []

    class Spy(server.ServerState):   # to stop serve_forever afterwards
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            states.append(self)

    monkeypatch.setattr(server, "ServerState", Spy)
    sched = _sched()
    port, prof_port = _free_port(), _free_port()
    ready = threading.Event()
    th = threading.Thread(target=serve_forever, daemon=True, kwargs=dict(
        scheduler=sched, tokenizer=ByteTokenizer(), host="127.0.0.1",
        port=port, ready_event=ready, profiler_port=prof_port))
    th.start()
    assert ready.wait(timeout=60)
    try:
        out = {}
        t = threading.Thread(target=lambda: out.update(res=_post(
            f"http://127.0.0.1:{prof_port}/profile",
            {"duration_ms": 800, "logdir": str(tmp_path)})))
        t.start()
        deadline = time.monotonic() + 30
        while not states[0]._profile_active and time.monotonic() < deadline:
            time.sleep(0.01)   # the loop thread has started the capture
        _post(f"http://127.0.0.1:{port}/generate",
              {"prompt": "hello", "max_tokens": 6, "stop_token": -1})
        t.join(timeout=60)
        code, body = out["res"]
        assert code == 200 and body["logdir"] == str(tmp_path)
        assert body["files"] == [os.path.basename(body["trace"])]
        # the loop thread ran the capture: its ticks' ops are in it
        names = {e.get("name") for e in _events(body["trace"])}
        assert any(n and n.startswith("aten::") for n in names)
    finally:
        states[0].httpd.shutdown()
        th.join(timeout=30)
    assert not th.is_alive()
    # serve_forever closed its profiler server on the way out
    assert P.start_profiler_server(prof_port) is True
    P.stop_profiler_server()


def test_lint_list_rules_matches_the_jax_cli(capsys):
    """The port's catalog (its own checker, butterfly_tpu_torch/tools/)
    lists every rule of the JAX CLI's under the same id and slug, each
    scoped to the port's paths; BTF002 (use after donation) is listed
    as not ported, with why."""
    import re
    assert jcli.main(["lint", "--list-rules"]) == 0
    want = re.findall(r"^(BTF\d{3})  (\S+)", capsys.readouterr().out, re.M)
    assert cli.main(["lint", "--list-rules"]) == 0
    got = capsys.readouterr().out
    assert re.findall(r"^(BTF\d{3})  (\S+)", got, re.M) == want
    assert "BTF001" in got and "butterfly_tpu/" not in got
    assert re.search(r"^BTF002  use-after-donation  \(not ported\) torch "
                     r"has no donate_argnums", got, re.M)
