"""PyTorch port: two mesh axes across processes at once, or one across
beside another inside them (one process group per axis: core/mesh.py),
against the JAX package's own two- and four-process runs, float32, on
the CPU.

Subprocess workers (torch_distributed_worker.py, modes `jax_two` and
`port_two`), each job with a real rendezvous, all run at once: for each
pair of stage, expert, seq and tensor (the tiny float32 Llama from
PRNGKey(0), the tiny Mixtral with moe_impl="ep" where the pair holds
expert) in three layouts, A (two processes of two devices, the outer
axis in MESH_AXES order across them and the inner inside), B (the inner
across, the outer inside) and C (four processes of one device, both
across), and with data = 2 inside two processes of four devices beside
an axis across and another inside: greedy generate (fused and stepped)
and the Scheduler's tokens, under seq generate_long and the Scheduler
through the long-prompt lane, in every port process equal the JAX
processes' own run of the same mesh; the logits within 2e-5 of the
port's one-process run of that mesh; temperature 1.0 alike in every
process; each process holds exactly its block of every leaf. A stage
axis across beside tensor, where the JAX package fails at its first
read-back, raises RuntimeError before any weight is placed; a
ServingEngine with the draft model builds where only seq crosses the
processes and raises RuntimeError where tensor, stage or expert does.
"""
import argparse
import json
import random
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from butterfly_tpu.core.config import tiny as jtiny
from butterfly_tpu.models.common import Model as JModel
from butterfly_tpu_torch.core import mesh as TM
from butterfly_tpu_torch.core.config import MESH_AXES, MeshConfig, tiny
from butterfly_tpu_torch.models import common as TC
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.parallel.partition import Shards, shard_params
from butterfly_tpu_torch.serve import cli

import torch_distributed_worker as W
from test_torch_distributed import _child_env, _run_pairs
from test_torch_distributed_axes import _same_tree

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
TOL = 2e-5
ARCHS = {"llama": {}, "mixtral": dict(moe_impl="ep")}
# the JAX jobs: one a layout (processes, CPU devices a process); the
# port's: A, B and D in one job of two processes, C in one of four
JAX_JOBS = (("A", 2, 2), ("B", 2, 2), ("C", 4, 1), ("D", 2, 4))
PORT_JOBS = (("ABD", 2), ("C", 4))
CASES = {key: (axes, dcn, arch)
         for lay in "ABCD" for key, axes, dcn, arch in W.two_cases(lay)}
# where the JAX package fails: a stage axis across beside tensor
REFUSED = [k for k, (axes, dcn, _) in CASES.items()
           if "stage" in dcn and axes.get("tensor", 1) > 1]
RUNS = [k for k in CASES if k not in REFUSED]
LOGITS = ("prefill", "step", "long_prefill", "long_step")
# the bound on all the jobs together: sixteen processes compile at once
# (about 200 s on an 8-core host with other work beside them)
JOBS_TIMEOUT = 900


def _quiet_ports(n):
    """n distinct free TCP ports below Linux's ephemeral range (32768 and
    up): a rendezvous port taken from that range can be handed to an
    outgoing connection of another job (gloo opens many) in the seconds
    before a JAX coordinator binds it, which then fails to start."""
    ports = []
    while len(ports) < n:
        port = random.randrange(20000, 32768)
        if port in ports:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        ports.append(port)
    return ports


def _run_jobs(cmds):
    """Start every command at once; (rc, output) of each, all bounded by
    JOBS_TIMEOUT together and killed past it."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=e, text=True)
             for c, e in cmds]
    deadline = time.monotonic() + JOBS_TIMEOUT
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _cfg(arch):
    return tiny(arch, dtype="float32", param_dtype="float32", **ARCHS[arch])


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(directory of the JAX trees of PRNGKey(0) as llama.npz and
    mixtral.npz, {arch: the bridged port tree})."""
    wdir = tmp_path_factory.mktemp("w")
    out = {}
    for arch in ARCHS:
        cfg = jtiny(arch, dtype="float32", param_dtype="float32")
        tree = jax.tree.map(np.asarray,
                            JModel(cfg).init(jax.random.PRNGKey(0)))
        np.savez(wdir / f"{arch}.npz", **W.flatten(tree))
        out[arch] = params_from_numpy(tree, device="cpu")
    return wdir, out


@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    """Every job's results, all jobs run at once: {"jax": {case: [per
    process]}, "port": {...}}."""
    out = tmp_path_factory.mktemp("runs")
    worker = str(HERE / "torch_distributed_worker.py")
    cmds = []
    ports = _quiet_ports(len(JAX_JOBS) + len(PORT_JOBS))
    for (lay, n, per), port in zip(JAX_JOBS, ports):
        env = _child_env()
        env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={per} "
                            + env["XLA_FLAGS"])
        cmds += [([sys.executable, worker, "jax_two", str(p), str(n),
                   str(port), str(out), lay], env) for p in range(n)]
    for (lays, n), port in zip(PORT_JOBS, ports[len(JAX_JOBS):]):
        cmds += [([sys.executable, worker, "port_two", str(p), str(n),
                   str(port), str(out), str(trees[0]), lays], _child_env())
                 for p in range(n)]
    t0 = time.monotonic()
    for rc, log in _run_jobs(cmds):
        assert rc == 0, f"worker failed:\n{log}"
    print(f"the jobs took {time.monotonic() - t0:.1f} s")
    res = {"jax": {}, "port": {}}
    for kind, jobs in (("jax", [(lay, n) for lay, n, _ in JAX_JOBS]),
                       ("port", PORT_JOBS)):
        for lays, n in jobs:
            per = [json.loads((out / f"{kind}_two_{lays}{p}.json")
                              .read_text()) for p in range(n)]
            for key in per[0]:
                res[kind][key] = [r[key] for r in per]
    return res


@pytest.fixture(scope="module")
def one_process(trees):
    """The port's logits and placement on a one-process mesh of each
    case's axes (CPU shards): the yardstick of the logits."""
    out = {}
    for key in RUNS:
        axes, _, arch = CASES[key]
        cfg = _cfg(arch)
        mesh = TM.make_mesh(MeshConfig(**axes),
                            ["cpu"] * MeshConfig(**axes).num_devices)
        out[key] = W.two_logits(mesh, axes, trees[1][arch], cfg)
        out[key]["axes"] = _split_axes(shard_params(trees[1][arch], cfg,
                                                    mesh))
    return out


# -- (1) the JAX package's tokens ---------------------------------------------

@pytest.mark.parametrize("key", RUNS)
def test_two_axes_match_jax(runs, key):
    """Greedy generate (fused and stepped) and the Scheduler's tokens
    (under seq: generate_long and the Scheduler through the long-prompt
    lane, with the lane's token count; under stage x seq generate_long
    raises the JAX engine's NotImplementedError) in every port process
    equal the JAX package's run of the same mesh, which agrees with
    itself in every process."""
    # the seconds of each phase (s_*) are each process's own
    js = [{k: v for k, v in j.items() if not k.startswith("s_")}
          for j in runs["jax"][key]]
    ps = runs["port"][key]
    assert all(j == js[0] for j in js)
    j = js[0]
    assert "error" not in j, j
    for r in ps:
        assert r["generate"] == j["generate"]
        assert r["generate_stepped"] == j["generate"]
        if "seq" in CASES[key][0]:
            assert r["long"] == j["long"]
            assert r["lane"] == j["lane"]
            assert r["lane_tokens"] == j["lane_tokens"]
        else:
            assert r["serve"] == j["serve"]
    if "stage" in CASES[key][0] and "seq" in CASES[key][0]:
        assert j["long"][0] == "NotImplementedError"
    elif "seq" in CASES[key][0]:
        assert j["lane_tokens"] == len(W.LONG_PROMPT)


@pytest.mark.parametrize("key", RUNS)
def test_two_axes_layout(runs, key):
    """Each process holds the block of the mesh the layout names: under
    A the outer axis's index is the process, under B the inner's, under
    C both (row-major), under D the crossing axis's with data and the
    other axis inside; temperature 1.0 at a fixed seed samples the same
    tokens in every process."""
    axes, dcn, _ = CASES[key]
    sizes = MeshConfig(**axes).axis_sizes
    idx = np.indices(sizes).reshape(len(sizes), -1)
    want = np.zeros(idx.shape[1], dtype=int)
    for a in dcn:
        i = MESH_AXES.index(a)
        want = want * sizes[i] + idx[i]
    ps = runs["port"][key]
    for r in ps:
        assert r["processes"] == want.tolist()
        assert r["generate_t1"] == ps[0]["generate_t1"]


# -- (2) the port's one-process run ------------------------------------------

@pytest.mark.parametrize("key", RUNS)
def test_two_axes_logits(runs, one_process, key):
    """The forward's logits (an 8-token prefill and a decode step; the
    pipeline's under stage) and, under seq without stage, the
    seq-parallel prefill of the long prompt and a decode step over its
    sharded cache, in every process within 2e-5 of the one-process run
    of the same mesh."""
    want = one_process[key]
    worst = 0.0
    for r in runs["port"][key]:
        for name in LOGITS:
            if name not in want:
                assert name not in r
                continue
            got, ref = np.asarray(r[name]), np.asarray(want[name])
            assert got.shape == ref.shape
            worst = max(worst, float(np.abs(got - ref).max()))
    print(f"{key}: largest logit difference to one process: {worst}")
    assert worst <= TOL


def _split_axes(tree, path=""):
    """{leaf path: the axes its placement splits it over} of a tree
    placed in one process (nested splits too)."""
    out = {}
    for k, v in tree.items():
        key = f"{path}/{k}" if path else k
        if isinstance(v, dict):
            out.update(_split_axes(v, key))
        elif v is not None:
            axes = []
            while isinstance(v, Shards):
                if v.split is not None:
                    axes.append(v.axis)
                v = v.parts[0]
            out[key] = axes
    return out


@pytest.mark.parametrize("key", RUNS)
def test_two_axes_placement(runs, trees, one_process, key):
    """Each process holds exactly its block of every leaf: the whole
    leaf over the product of the sizes of the crossing axes the leaf is
    split over (under expert x tensor across, an expert leaf a quarter,
    an attention leaf a half; a stage's layers under stage x expert a
    half, its expert leaves a quarter; under seq nothing more)."""
    axes, dcn, arch = CASES[key]
    flat = dict(_leaf_items(trees[1][arch]))
    split = one_process[key]["axes"]
    assert set(split) == set(flat)
    for r in runs["port"][key]:
        for leaf, held in r["held"].items():
            f = int(np.prod([axes[a] for a in split[leaf] if a in dcn]))
            assert held * f == flat[leaf].nbytes, (leaf, held, f)
        assert set(r["held"]) == set(flat)


def _leaf_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v.numpy()


# -- (3) what stays refused --------------------------------------------------

@pytest.mark.parametrize("key", RUNS)
def test_two_axes_draft_model_refused_where_jax_fails(runs, key):
    """A ServingEngine with the draft model (RuntimeConfig.draft_model=
    "model") builds where neither tensor, stage nor expert crosses the
    processes (seq across, alone or beside an axis inside them), and is
    refused at build with RuntimeError in every process where one of
    them crosses: the JAX package fails there at its first spec block
    (tests/test_torch_distributed.py, test_torch_distributed_axes.py),
    and runs under seq across (test_torch_distributed_seq.py)."""
    _, dcn, _ = CASES[key]
    crossing = [a for a in ("tensor", "stage", "expert") if a in dcn]
    for r in runs["port"][key]:
        if crossing:
            kind, msg = r["draft"]
            assert kind == "RuntimeError"
            assert f"{crossing[0]} axis crosses processes" in msg
        else:
            assert r["draft"] is None

@pytest.mark.parametrize("key", REFUSED)
def test_stage_across_beside_tensor_refused(runs, key):
    """A stage axis across processes beside tensor = 2 (inside them,
    layout A, or across them, C): the JAX package fails at its first
    read-back in every process, and the port refuses with RuntimeError
    naming that failure, at placement, before any weight is placed."""
    for j in runs["jax"][key]:
        kind, msg = j["error"]
        assert kind == "RuntimeError" and "non-addressable" in msg
        assert "generate" not in j
    for r in runs["port"][key]:
        kind, msg = r["error"]
        assert kind == "RuntimeError"
        assert "engine/engine.py:259" in msg and \
            "sched/scheduler.py:2041" in msg
        assert "held" not in r


def _fake_mesh(monkeypatch, axes, procs, me=0):
    """A mesh of `axes` over CPU devices whose process indices are
    `procs` in mesh order, as process `me` of that job sees it."""
    monkeypatch.setattr(TM, "process_count", lambda: max(procs) + 1)
    monkeypatch.setattr(TM, "process_index", lambda: me)
    return TM.make_mesh(MeshConfig(**axes), [
        TM.GlobalDevice(i, torch.device("cpu"), p, 0)
        for i, p in enumerate(procs)])


@pytest.mark.parametrize("me,stage,expert", [
    (0, [0, 2], [0, 1]), (1, [1, 3], [0, 1]), (2, [0, 2], [2, 3]),
    (3, [1, 3], [2, 3])])
def test_owners_at_own_coordinates(monkeypatch, me, stage, expert):
    """On stage x expert across four processes (layout C) the owners of
    the stages are those at this process's expert shard and the owners
    of the expert shards those at its stage: its peers of the hand-off
    and of the all-to-all; its own coordinates are its block's first."""
    mesh = _fake_mesh(monkeypatch, dict(stage=2, expert=2), [0, 1, 2, 3],
                      me)
    TM.check_process_mesh(mesh)
    assert TM.owners(mesh, "stage") == stage
    assert TM.owners(mesh, "expert") == expert
    assert (mesh.home["stage"], mesh.home["expert"]) == divmod(me, 2)
    assert TM.crossing_owners(mesh, "seq") is None


@pytest.mark.parametrize("procs,crossing", [
    ([0, 1, 0, 1], "tensor"), ([0, 0, 1, 1], "stage")])
def test_local_helpers_read_own_coordinates(monkeypatch, procs, crossing):
    """A helper that takes coordinates reads an axis not named at this
    process's own: on stage x tensor with tensor across (B) process 1's
    local tensor run is shard 1 at every stage; with stage across (A,
    refused beside tensor, but laid out alike) process 1's stages are
    stage 1 alone."""
    mesh = _fake_mesh(monkeypatch, dict(stage=2, tensor=2), procs, 1)
    assert TM.axes_across_processes(mesh) == [crossing]
    if crossing == "tensor":
        assert mesh.local_range("tensor") == (1, 2)
        assert mesh.local_range("stage") == (0, 2)
    else:
        assert mesh.local_range("stage") == (1, 2)
        assert mesh.local_range("tensor") == (0, 2)
        with pytest.raises(RuntimeError, match="engine/engine.py:259"):
            TM.check_process_mesh(mesh)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_held_experts_split_over_tensor_inside(monkeypatch, quant):
    """Expert across two processes beside tensor = 2 inside them (A):
    the CLI's loader keeps this process's experts
    (parallel/partition.py:place_held_experts) and the placement splits
    each of them over its two tensor shards, as it splits the whole
    tree's: the placed trees are equal, float or int8."""
    cfg = _cfg("mixtral")
    mesh = _fake_mesh(monkeypatch, dict(expert=2, tensor=2), [0, 0, 1, 1],
                      1)
    model = TC.Model(cfg, device="cpu")
    args = argparse.Namespace(ckpt=None, quant=quant)
    part = shard_params(cli.load_params(model, args, mesh), cfg, mesh)
    w = part["layers"]["moe"]["w_up"]
    w = w["q8"] if isinstance(w, dict) else w
    assert (w.axis, w.offset, len(w.parts), w.count) == ("expert", 1, 1, 2)
    assert w.parts[0].axis == "tensor" and len(w.parts[0].parts) == 2
    _same_tree(part, shard_params(cli.load_params(model, args), cfg, mesh))


# -- (4) the CLI -------------------------------------------------------------

@pytest.mark.parametrize("dcn,refused", [("tensor", False), ("stage", True),
                                         ("stage,tensor", True)])
def test_cli_builds_two_axis_meshes(monkeypatch, dcn, refused):
    """--dcn-axes names the axes that cross the processes: with
    --stage-parallel 2 --tensor-parallel 2 in two processes `tensor`
    lays tensor across and stage inside; `stage` (two processes) and
    `stage,tensor` (four) exit with the refusal's message."""
    P = 2 ** len(dcn.split(","))
    monkeypatch.setattr(TM, "process_count", lambda: P)
    monkeypatch.setattr(TM, "init_distributed", lambda: None)
    monkeypatch.setattr(TM, "global_devices", lambda device, per_process: [
        TM.GlobalDevice(i, torch.device("cpu"), i // per_process, 0)
        for i in range(P * per_process)])
    ns = argparse.Namespace(tensor_parallel=2, stage_parallel=2,
                            expert_parallel=1, seq_parallel=1,
                            data_parallel=1, device="cpu", dcn_axes=dcn)
    if refused:
        with pytest.raises(SystemExit, match="error: a stage axis across "
                           "processes beside a tensor axis"):
            cli.build_mesh(ns)
        return
    mesh = cli.build_mesh(ns)
    assert mesh.processes.reshape(-1).tolist() == [0, 1, 0, 1]
    assert TM.axes_across_processes(mesh) == ["tensor"]


def test_cli_generate_two_axes_two_processes(capsys):
    """`generate --stage-parallel 2 --tensor-parallel 2 --dcn-axes
    tensor` in two processes (BUTTERFLY_NUM_PROCESSES=2, torchrun's
    variables): tensor across them, both stages inside each; both print
    the one-process run's text."""
    args = ["generate", "--model", "tiny", "--device", "cpu", "--prompt",
            "hello", "--max-new", "8", "--stage-parallel", "2",
            "--tensor-parallel", "2"]
    assert cli.main(args) == 0
    want = capsys.readouterr().out
    assert want.strip()
    port, = _quiet_ports(1)
    cmds = [([sys.executable, "-m", "butterfly_tpu_torch.serve.cli", *args,
              "--dcn-axes", "tensor"],
             _child_env(BUTTERFLY_NUM_PROCESSES="2", MASTER_ADDR="127.0.0.1",
                        MASTER_PORT=str(port), RANK=str(r)))
            for r in range(2)]
    for rc, out in _run_pairs(cmds):
        assert rc == 0, out
        assert want in out
