"""PyTorch port: trace files and open-loop replay (workload/replay.py), the
load generator (workload/loadgen.py) and the `workload` CLI, held
against the JAX package and tools/loadgen.py.

`trace_text` / `save_trace` / `load_trace` give identical bytes for the
same specs in both packages, and each package loads the other's file;
`workload generate` prints the same line and writes the same file from
both CLIs; the loadgen copy draws the same prompts as tools/loadgen.py;
a trace replayed at a port replica by the port and by the JAX replay
gives the same summary keys and outcomes. A subprocess runs the port's
autoscale leg and `workload replay` (the open-loop path that pulls the
workload package) and then finds neither jax nor butterfly_tpu imported.
`dash` renders a timeseries dump as the JAX CLI does.
"""
import contextlib
import importlib
import io
import json
import subprocess
import sys
import threading
from http.server import ThreadingHTTPServer
from pathlib import Path

import pytest
import torch

from butterfly_tpu.serve.cli import main as jmain
from butterfly_tpu.workload import arrivals as JArr
from butterfly_tpu.workload import models as JM
from butterfly_tpu.workload import replay as JR
from butterfly_tpu_torch.core.config import RuntimeConfig, tiny
from butterfly_tpu_torch.engine.serving import ServingEngine
from butterfly_tpu_torch.models.common import Model
from butterfly_tpu_torch.sched.scheduler import Scheduler
from butterfly_tpu_torch.serve.cli import main as tmain
from butterfly_tpu_torch.serve.server import ServerState, make_handler
from butterfly_tpu_torch.utils.tokenizer import ByteTokenizer
from butterfly_tpu_torch.workload import arrivals as TArr
from butterfly_tpu_torch.workload import loadgen as TL
from butterfly_tpu_torch.workload import models as TM
from butterfly_tpu_torch.workload import replay as TR

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SHAPE = dict(page_size=8, vocab=258, prompt_lo=8, prompt_hi=24,
             max_new_lo=2, max_new_hi=6)
CASES = [("mixed_chat", "poisson:50", 0), ("mixed_chat", "burst:40:0.2:0.3",
                                            3),
         ("uniform", "ramp:5:50:1", 1), ("uniform", "poisson:8", 7)]


def _specs(M, Arr, name, arrival, seed, n=10):
    wl = M.get_workload(name, **SHAPE)
    specs = wl.sample(n, seed)
    Arr.assign_arrivals(specs, Arr.parse_arrival(arrival), seed)
    return wl, specs


@pytest.mark.parametrize("name,arrival,seed", CASES)
def test_trace_text_matches_reference(name, arrival, seed):
    jwl, js = _specs(JM, JArr, name, arrival, seed)
    twl, ts = _specs(TM, TArr, name, arrival, seed)
    kw = dict(arrival=arrival, seed=seed)
    assert TR.trace_text(ts, workload=twl, **kw) == \
        JR.trace_text(js, workload=jwl, **kw)


@pytest.mark.parametrize("name,arrival,seed", CASES[:2])
def test_save_and_load_trace_across_packages(tmp_path, name, arrival, seed):
    """Each package loads the other's file and re-saves it to the same
    bytes."""
    twl, ts = _specs(TM, TArr, name, arrival, seed)
    jwl, _ = _specs(JM, JArr, name, arrival, seed)
    p_t, p_j = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    TR.save_trace(p_t, ts, workload=twl, arrival=arrival, seed=seed)
    jh, js = JR.load_trace(p_t)
    JR.save_trace(p_j, js, workload=jwl, arrival=arrival, seed=seed)
    assert p_j.read_bytes() == p_t.read_bytes()
    th, ts2 = TR.load_trace(p_j)
    assert th == jh
    assert [s.payload() for s in ts2] == [s.payload() for s in js]
    with pytest.raises(ValueError):
        (tmp_path / "x.jsonl").write_text('{"some": "json"}\n')
        TR.load_trace(tmp_path / "x.jsonl")


def _run_cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_workload_generate_cli_matches_reference(tmp_path):
    args = ["workload", "generate", "--workload", "mixed_chat", "--n", "6",
            "--seed", "3", "--arrival", "poisson:50", "--page-size", "8",
            "--prompt-lo", "8", "--prompt-hi", "24", "--max-new-lo", "2",
            "--max-new-hi", "6", "--vocab", "258"]
    out = tmp_path / "trace.jsonl"
    rc_t, text_t = _run_cli(tmain, args + ["--out", str(out)])
    bytes_t = out.read_bytes()
    rc_j, text_j = _run_cli(jmain, args + ["--out", str(out)])
    assert rc_t == rc_j == 0
    assert text_t == text_j and json.loads(text_t)["n"] == 6
    assert out.read_bytes() == bytes_t


def test_loadgen_copy_draws_the_tools_prompts():
    tools = str(ROOT / "tools")
    sys.path.insert(0, tools)
    try:
        ref = importlib.import_module("loadgen")
    finally:
        sys.path.remove(tools)
    for n, seed, vocab in ((32, 0, 64), (48, 3, 258), (5, 11, 64)):
        assert TL.shared_prefix(n, seed, vocab) == \
            ref.shared_prefix(n, seed, vocab)


@pytest.fixture(scope="module")
def replica():
    model = Model(tiny("llama", dtype="float32", param_dtype="float32"),
                  device="cpu")
    rt = RuntimeConfig(max_batch_size=4, max_seq_len=112, page_size=8,
                       prefix_caching=True)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    state = ServerState(Scheduler(ServingEngine(model, model.init(gen), rt)),
                        ByteTokenizer())
    state.thread.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_port}"
    state.stop.set()
    httpd.shutdown()
    httpd.server_close()


def test_replay_matches_reference_replay(replica):
    """One trace replayed by the port and by the JAX package
    at the same port replica: every request answered by both, and the
    same summary keys and request counts."""
    _, ts = _specs(TM, TArr, "mixed_chat", "poisson:50", 0, n=6)
    _, js = _specs(JM, JArr, "mixed_chat", "poisson:50", 0, n=6)
    got = TR.replay_trace(replica, ts, speed=10.0, timeout=60.0,
                          slo_ttft_ms=60000.0)
    want = JR.replay_trace(replica, js, speed=10.0, timeout=60.0,
                           slo_ttft_ms=60000.0)
    assert set(got) == set(want)
    assert got["outcomes"] == want["outcomes"] == \
        {"ok": 6, "shed_429": 0, "deadline_504": 0, "error": 0}
    assert got["sent"] == want["sent"] == 6
    assert set(got["server"]) == set(want["server"])


_NO_JAX_SCRIPT = r"""
import json, sys, tempfile, os
import torch
torch.set_num_threads(1)
from butterfly_tpu_torch.obs.benchmark import run_autoscale_benchmark
from butterfly_tpu_torch.fleet.harness import start_fleet
from butterfly_tpu_torch.serve.cli import main
out = run_autoscale_benchmark("1p1d", clients=1, requests_per_client=2,
                              max_tokens=2, arrival="ramp:4:20:0.5",
                              settle_s=0.5, device="cpu")
assert out["autoscale_dropped"] == 0, out
fleet = start_fleet("1p1d", device="cpu")
try:
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.jsonl")
        assert main(["workload", "generate", "--n", "3", "--arrival",
                     "poisson:50", "--page-size", "8", "--prompt-lo", "8",
                     "--prompt-hi", "24", "--max-new-lo", "2",
                     "--max-new-hi", "4", "--out", path]) == 0
        assert main(["workload", "replay", "--trace", path, "--url",
                     fleet.url, "--speed", "20"]) == 0
finally:
    fleet.stop()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "butterfly_tpu"))
print("IMPORTED=" + json.dumps(bad))
"""


def test_open_loop_paths_import_no_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("IMPORTED=")][-1]
    assert json.loads(line.split("=", 1)[1]) == []


def test_dash_cli_matches_reference(tmp_path):
    """`dash` renders a timeseries dump (the port's SignalRecorder) the
    same way from both CLIs: --text on stdout, HTML to a file."""
    from butterfly_tpu_torch.obs.timeseries import AlertRule, SignalRecorder
    rec = SignalRecorder(interval_s=1e-9, rules=[
        AlertRule("busy", "queue_depth", 2, "sustained_above", 0.5)])
    for i in range(12):
        rec.sample({"queue_depth": float(i % 5),
                    "kv_pages_free": 40.0 - i}, t_wall=100.0 + i)
    dump = tmp_path / "ts.json"
    dump.write_text(json.dumps(rec.dump()))
    rc_t, text_t = _run_cli(tmain, ["dash", str(dump), "--text"])
    rc_j, text_j = _run_cli(jmain, ["dash", str(dump), "--text"])
    assert rc_t == rc_j == 0
    assert text_t == text_j and "kv_pages_free" in text_t
    html_t, html_j = tmp_path / "t.html", tmp_path / "j.html"
    assert tmain(["dash", str(dump), "--out", str(html_t)]) == 0
    assert jmain(["dash", str(dump), "--out", str(html_j)]) == 0
    assert html_t.read_text() == html_j.read_text()
    assert "<svg" in html_t.read_text()
