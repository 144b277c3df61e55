"""PyTorch port: meshes over several processes (core/mesh.py:
init_distributed, global_devices, slice_groups, make_hybrid_mesh;
obs/health.py:all_hosts_probe; the tensor axis across processes through
parallel/tensor.py's collectives) against the JAX package's own
two-process runs, float32, on the CPU.

Two pairs of subprocess workers (torch_distributed_worker.py), one CPU
device a process: a JAX pair (jax.distributed) and a port pair (gloo),
each with a real rendezvous. The tiny float32 Llama from PRNGKey(0), with
tensor = 2 across the two processes, must give in both port processes
the JAX processes' greedy tokens (generate fused and stepped, a Scheduler
over a ServingEngine), and logits within 2e-5 of the port's one-process
tensor = 2 run (for two shards the float32 all-reduce is the one-process
sum, so the bits are expected equal). A data axis across processes fails
in the JAX package at its first read-back and is refused by the port at
engine construction; the seq axis across them runs generate_long
(stage and expert across processes: tests/test_torch_distributed_axes.py;
seq and data inside: tests/test_torch_distributed_seq.py). The CLI under
BUTTERFLY_NUM_PROCESSES=2 prints, in both processes, the one-process
text.
"""
import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import mesh_utils

from butterfly_tpu.core import mesh as JM
from butterfly_tpu.core.config import MeshConfig as JMeshConfig, tiny as jtiny
from butterfly_tpu.models.common import Model as JModel
from butterfly_tpu_torch.core import mesh as TM
from butterfly_tpu_torch.core.config import (MESH_AXES, MeshConfig,
                                             RuntimeConfig, tiny)
from butterfly_tpu_torch.engine.engine import InferenceEngine
from butterfly_tpu_torch.engine.sampling import SamplingParams
from butterfly_tpu_torch.models import common as TC
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.obs.health import all_hosts_probe
from butterfly_tpu_torch.parallel.partition import Shards, shard_params
from butterfly_tpu_torch.quant.int8 import (quantize_int8,
                                            shard_quantized_params)
from butterfly_tpu_torch.serve import cli

import torch_distributed_worker as W

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
TOL = 2e-5
TIMEOUT = 240   # tests/test_distributed.py's communicate bound


def _child_env(**extra):
    env = dict(os.environ)
    # 1 local CPU device per JAX process; one compute thread a worker, so
    # the four workers leave the other tests of the run their cores
    env["XLA_FLAGS"] = ("--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1")
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pairs(cmds):
    """Start every command at once; (rc, output) of each, all bounded by
    TIMEOUT and killed past it."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=e, text=True)
             for c, e in cmds]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _cfg():
    return tiny("llama", dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(path of the JAX tree of PRNGKey(0) as .npz, the bridged port
    tree)."""
    cfg = jtiny("llama", dtype="float32", param_dtype="float32")
    tree = jax.tree.map(np.asarray, JModel(cfg).init(jax.random.PRNGKey(0)))
    path = tmp_path_factory.mktemp("w") / "weights.npz"
    np.savez(path, **W.flatten(tree))
    return path, params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """The JAX pair's and the port pair's results, both pairs run at
    once: {"jax": [proc0, proc1], "port": [...], "npz": [...]}."""
    out = tmp_path_factory.mktemp("runs")
    worker = str(HERE / "torch_distributed_worker.py")
    jport, tport = _free_port(), _free_port()
    cmds = [([sys.executable, worker, "jax", str(p), "2", str(jport),
              str(out)], _child_env()) for p in range(2)]
    cmds += [([sys.executable, worker, "port", str(p), "2", str(tport),
               str(out), str(weights[0])], _child_env()) for p in range(2)]
    for rc, log in _run_pairs(cmds):
        assert rc == 0, f"worker failed:\n{log}"
    return {m: [json.loads((out / f"{m}{p}.json").read_text())
                for p in range(2)] for m in ("jax", "port")} | {
        "npz": [dict(np.load(out / f"port{p}.npz")) for p in range(2)]}


def _one_process_t2():
    return TM.make_mesh(MeshConfig(tensor=2), ["cpu"] * 2)


# -- (1) rendezvous, the worker sum, the probe -------------------------------

def test_two_process_rendezvous_sum_and_probe(runs):
    """tests/test_distributed.py:test_two_process_distributed_psum's
    counterpart: each process contributes pid + 1, the all-reduce gives
    3, all_hosts_probe() is true in both, and both see the same global
    devices (one CPU device a process, one host: one slice)."""
    for r in runs["port"]:
        assert r["sum"] == 3.0 and r["probe"] is True
        assert r["devices"] == [[0, 0, 0, "cpu"], [1, 1, 0, "cpu"]]


def test_init_distributed_defaults(monkeypatch):
    """One process is a no-op; torchrun's variables stand in for JAX's
    cluster detection, a missing one raising in JAX's words."""
    monkeypatch.delenv("BUTTERFLY_NUM_PROCESSES", raising=False)
    TM.init_distributed()
    assert not torch.distributed.is_initialized()
    TM.init_distributed(num_processes=1)
    assert TM.process_index() == 0 and TM.process_count() == 1
    monkeypatch.setenv("BUTTERFLY_NUM_PROCESSES", "2")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="^coordinator_address should be "
                       "defined.$"):
        TM.init_distributed()
    with pytest.raises(ValueError, match="process id of the current "
                       "process must be defined"):
        TM.init_distributed(coordinator="127.0.0.1:1")
    with pytest.raises(ValueError, match="process_id < num_processes"):
        TM.init_distributed(coordinator="127.0.0.1:1", process_id=2)
    assert not torch.distributed.is_initialized()


def test_all_hosts_probe_against_global_count(monkeypatch):
    """In a group of several processes the probe all-reduces each
    process's ones and compares the total with the global device count:
    a process whose device did not answer makes it false."""
    fake = [TM.GlobalDevice(i, torch.device("cpu"), i, 0) for i in range(2)]
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(TM, "global_devices", lambda device: list(fake))
    for other, want in ((1.0, True), (0.0, False)):
        def peer(t, *a, other=other, **kw):
            t += other
        monkeypatch.setattr(torch.distributed, "all_reduce", peer)
        assert all_hosts_probe(["cpu"]) is want


# -- (2) the hybrid mesh -----------------------------------------------------

class _JaxFake:
    """A device the JAX helpers read (tests/test_distributed.py's fake,
    with what create_hybrid_device_mesh reads too)."""

    def __init__(self, i, slice_index):
        self.id = i
        self.slice_index = slice_index
        self.process_index = slice_index
        self.platform = "cpu"
        self.device_kind = "cpu"

    def __repr__(self):
        return f"dev{self.id}@slice{self.slice_index}"


def _both(slices):
    """The same fake devices for the JAX package and for the port."""
    return ([_JaxFake(i, s) for i, s in enumerate(slices)],
            [TM.GlobalDevice(i, torch.device("cpu"), s, s)
             for i, s in enumerate(slices)])


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_hybrid_mesh_validations_match_jax():
    """JAX's three ValueErrors, message for message."""
    cases = [
        ([i // 4 for i in range(8)], dict(data=2, tensor=4), ("nope",)),
        ([i // 4 for i in range(8)], dict(data=4, tensor=2), ("data",)),
        ([0 if i < 5 else 1 for i in range(8)], dict(data=2, tensor=4),
         ("data",)),
    ]
    for slices, axes, dcn in cases:
        jd, td = _both(slices)
        want = _message(lambda: JM.make_hybrid_mesh(JMeshConfig(**axes), jd,
                                                    dcn_axes=dcn))
        got = _message(lambda: TM.make_hybrid_mesh(MeshConfig(**axes), td,
                                                   dcn_axes=dcn))
        assert got == want


def test_hybrid_mesh_single_slice_falls_back():
    """One slice (plain devices, or every GlobalDevice on one host) gives
    make_mesh's mesh."""
    cfg = MeshConfig(data=2, tensor=2)
    a = TM.make_hybrid_mesh(cfg, ["cpu"] * 4)
    b = TM.make_mesh(cfg, ["cpu"] * 4)
    assert a.shape == b.shape and list(a.devices.flat) == list(b.devices.flat)
    _, td = _both([0] * 4)
    c = TM.make_hybrid_mesh(cfg, td)
    assert c.ids.reshape(-1).tolist() == [0, 1, 2, 3]
    assert c.processes.reshape(-1).tolist() == [0, 0, 0, 0]


@pytest.mark.parametrize("axes,dcn", [
    (dict(data=2, tensor=4), ("data",)),
    (dict(stage=2, seq=2, tensor=2), ("seq",)),
])
@pytest.mark.parametrize("interleaved", [False, True])
def test_hybrid_mesh_arrangement_matches_jax(axes, dcn, interleaved):
    """The device ids in mesh order equal
    jax.experimental.mesh_utils.create_hybrid_device_mesh's, with the
    slices in blocks or interleaved through the device list."""
    slices = [i % 2 if interleaved else i // 4 for i in range(8)]
    jd, td = _both(slices)
    cfg = MeshConfig(**axes)
    sizes = dict(zip(MESH_AXES, cfg.axis_sizes))
    dcn_shape = [sizes[a] if a in dcn else 1 for a in MESH_AXES]
    ici_shape = [1 if a in dcn else sizes[a] for a in MESH_AXES]
    want = mesh_utils.create_hybrid_device_mesh(
        ici_shape, dcn_shape, devices=jd, allow_split_physical_axes=True)
    mesh = TM.make_hybrid_mesh(cfg, td, dcn_axes=dcn)
    assert mesh.ids.shape == want.shape
    assert mesh.ids.reshape(-1).tolist() == [d.id for d in want.flat]
    assert mesh.processes.reshape(-1).tolist() == \
        [d.process_index for d in want.flat]
    assert TM.axes_across_processes(mesh) == list(dcn)


def test_placement_holds_only_local_shards(weights, monkeypatch):
    """On a mesh whose second tensor shard is another process's, the
    placement holds shard 0 alone: exactly half of every split leaf and
    the whole of every replicated one, and nothing for the other
    process's part."""
    _, params = weights
    cfg = _cfg()
    monkeypatch.setattr(TM, "process_count", lambda: 2)
    mesh = TM.make_mesh(MeshConfig(tensor=2), [
        TM.GlobalDevice(i, torch.device("cpu"), i, 0) for i in range(2)])
    placed = shard_params(params, cfg, mesh, copy=True)
    whole = split = 0

    def walk(s, t):
        nonlocal whole, split
        if isinstance(s, dict):
            for k in s:
                walk(s[k], t[k])
        elif isinstance(s, Shards):
            assert (len(s.parts), s.offset, s.count) == (1, 0, 2)
            assert s.shape == t.shape and s.distributed
            assert torch.equal(s.parts[0], t.narrow(
                s.split, 0, t.shape[s.split] // 2))
            split += t.nbytes
            whole += s.nbytes
        else:
            whole += s.nbytes
    walk(placed, params)
    replicated = sum(t.nbytes for t in _leaves(params)) - split
    assert whole == split // 2 + replicated


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# -- (3) tensor = 2 across two processes against the JAX package -------------

def test_tensor_across_processes_matches_jax(runs):
    """Greedy generate (fused and stepped) and the Scheduler's tokens in
    both port processes equal the JAX package's two-process run; each
    port process holds its own half of every split leaf."""
    j0, j1 = runs["jax"]
    assert j0["generate"] == j1["generate"] and j0["serve"] == j1["serve"]
    for p, r in enumerate(runs["port"]):
        assert r["generate"] == j0["generate"]
        assert r["generate_stepped"] == j0["generate"]
        assert r["serve"] == j0["serve"]
        assert r["wq"] == [True, 1, p, 2, [2, 64, 4, 16]]


def test_tensor_across_processes_logits_and_one_process(runs, weights):
    """The forward's logits (a prefill and a decode step) in both
    processes within 2e-5 of the port's one-process tensor = 2 run; the
    temperature > 0 tokens, the int8 weight tree's and the int8 KV
    pool's equal the one-process run's in both processes."""
    _, params = weights
    cfg = _cfg()
    mesh = _one_process_t2()
    placed = shard_params(params, cfg, mesh)
    toks = torch.as_tensor(W.LOGIT_TOKENS)
    with TM.mesh_ctx(mesh):
        cache = TC.init_cache(cfg, toks.shape[0], 32, device="cpu",
                              mesh=mesh)
        pre, cache = TC.forward(placed, cfg, toks, cache)
        step, cache = TC.forward(placed, cfg, toks[:, :1], cache)
    worst = 0.0
    for z in runs["npz"]:
        for got, want in ((z["prefill"], pre), (z["step"], step)):
            assert got.shape == tuple(want.shape)
            worst = max(worst, float(np.abs(got - want.numpy()).max()))
    print(f"largest logit difference to the one-process run: {worst}")
    assert worst <= TOL

    model = TC.Model(cfg, device="cpu")
    eng = InferenceEngine(model, placed, mesh=mesh)
    t1 = eng.generate(W.GEN_PROMPTS, SamplingParams(
        max_new_tokens=W.GEN_NEW, temperature=1.0), seed=5).tokens.tolist()
    kv8 = W.serve(model, placed, RuntimeConfig(kv_quant="int8",
                                               **W.SERVE_RT), mesh)
    q8 = InferenceEngine(model, shard_quantized_params(
        quantize_int8(params, cfg), cfg, mesh), mesh=mesh).generate(
        W.GEN_PROMPTS, SamplingParams(max_new_tokens=W.GEN_NEW)
    ).tokens.tolist()
    for r in runs["port"]:
        assert r["generate_t1"] == t1
        assert r["serve_kv_int8"] == kv8
        assert r["generate_int8"] == q8


def test_tensor_across_processes_other_paths(runs):
    """One kv head (K/V replicated over the tensor axis), GPT-2 (biases,
    the tied vocab-split head), prefix caching and the alternating path
    give in both processes the one-process tensor = 2 run's tokens."""
    want = W.variants(_one_process_t2())
    assert want["prefix"][0] == want["alternating"][0]
    for r in runs["port"]:
        assert r["variants"] == want


# -- (4) the refusals --------------------------------------------------------

def test_data_across_processes_refused_as_jax_fails(runs, weights):
    """A data axis across the two processes: the JAX worker raises
    RuntimeError at its first read-back; the port refuses at engine
    construction, and that is its only refusal here. The seq axis across
    the processes runs: generate_long on the 37-token prompt gives in
    both processes the one-process seq = 2 run's tokens (stage and
    expert across processes: tests/test_torch_distributed_axes.py; seq
    and data inside: tests/test_torch_distributed_seq.py)."""
    for r in runs["jax"]:
        kind, msg = r["data_error"]
        assert kind == "RuntimeError" and "non-addressable" in msg
    model = TC.Model(_cfg(), device="cpu")
    want = InferenceEngine(model, weights[1], mesh=TM.make_mesh(
        MeshConfig(seq=2), ["cpu"] * 2)).generate_long(
        W.LONG_PROMPT, SamplingParams(max_new_tokens=W.GEN_NEW)
    ).tokens.tolist()
    for r in runs["port"]:
        kind, msg = r["refusals"]["data"]
        assert kind == "RuntimeError"
        assert "first read-back" in msg and "engine/engine.py:259" in msg
        assert set(r["refusals"]) == {"data"}
        assert r["seq_long"] == want


# -- (5) the CLI -------------------------------------------------------------

def test_cli_generate_two_processes(capsys):
    """`generate --tensor-parallel 2` in two processes
    (BUTTERFLY_NUM_PROCESSES=2, torchrun's variables) prints the
    one-process run's text in both."""
    args = ["generate", "--model", "tiny", "--device", "cpu",
            "--tensor-parallel", "2", "--prompt", "hello", "--max-new", "8"]
    assert cli.main(args) == 0
    want = capsys.readouterr().out
    port = _free_port()
    cmds = [([sys.executable, "-m", "butterfly_tpu_torch.serve.cli", *args],
             _child_env(BUTTERFLY_NUM_PROCESSES="2", MASTER_ADDR="127.0.0.1",
                        MASTER_PORT=str(port), RANK=str(r)))
            for r in range(2)]
    outs = _run_pairs(cmds)
    for rc, out in outs:
        assert rc == 0, out
        assert want in out


def test_cli_dcn_axes_reach_the_hybrid_mesh(monkeypatch):
    """--dcn-axes reaches make_hybrid_mesh; an unknown axis exits with
    the JAX CLI's message."""
    seen = {}

    def hybrid(cfg, devices, dcn_axes):
        seen["dcn"] = dcn_axes
        return TM.make_mesh(cfg, devices)
    monkeypatch.setattr(TM, "make_hybrid_mesh", hybrid)
    ns = dict(tensor_parallel=2, stage_parallel=2, expert_parallel=1,
              data_parallel=1, device="cpu")
    mesh = cli.build_mesh(argparse.Namespace(dcn_axes="data,stage", **ns))
    assert seen["dcn"] == ("data", "stage") and mesh.shape["stage"] == 2
    with pytest.raises(SystemExit, match=r"^error: unknown mesh axes "
                       r"\['nope'\]$"):
        cli.build_mesh(argparse.Namespace(dcn_axes="data,nope", **ns))
