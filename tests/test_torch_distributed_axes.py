"""PyTorch port: the stage axis and the expert axis across processes
(parallel/pipeline.py's send / receive hand-offs and broadcast,
parallel/expert.py's all-to-all and all-gathers, parallel/partition.py's
per-process placement) against the JAX package's own two-process runs,
float32, on the CPU.

Two pairs of subprocess workers (torch_distributed_worker.py, modes
`jax_axes` and `port_axes`), one CPU device a process, each pair with a
real rendezvous: the tiny float32 Llama from PRNGKey(0) with stage = 2
across the two processes (one layer a stage), then the tiny float32
Mixtral (moe_impl="ep") with expert = 2 across them. Both port processes
must give the JAX processes' greedy tokens (generate, fused and stepped,
one expert run on the a2a path at prefill; a Scheduler over a
ServingEngine), and every other run (temperature 1.0, the int8 KV pool,
the alternating path, n-gram speculation, the interleaved schedule, the
int8 tree) the port's one-process run on the same mesh; the forward's
logits within 2e-5 of it. Each process holds only its own stages' or
expert shards' parts plus the replicated rest. Meshes that still span
processes only with a refusal raise it, and a data axis inside them
beside the one that crosses runs; the CLI under
BUTTERFLY_NUM_PROCESSES=2 prints the one-process text in both processes.
"""
import argparse
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from butterfly_tpu.core.config import tiny as jtiny
from butterfly_tpu.models.common import Model as JModel
from butterfly_tpu_torch.core import config as TCFG
from butterfly_tpu_torch.core import mesh as TM
from butterfly_tpu_torch.core.config import MeshConfig, tiny
from butterfly_tpu_torch.models import common as TC
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.parallel.partition import (Shards,
                                                    held_expert_range,
                                                    shard_params)
from butterfly_tpu_torch.serve import cli

import torch_distributed_worker as W
from test_torch_ckpt import hf_state_dict, write_hf_dir
from test_torch_distributed import _child_env, _free_port, _run_pairs

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
TOL = 2e-5
ARCH = {"stage": ("llama", {}), "expert": ("mixtral", dict(moe_impl="ep"))}


def _cfg(axis):
    arch, kw = ARCH[axis]
    return tiny(arch, dtype="float32", param_dtype="float32", **kw)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(directory of the JAX trees of PRNGKey(0) as llama.npz and
    mixtral.npz, {axis: the bridged port tree})."""
    wdir = tmp_path_factory.mktemp("w")
    out = {}
    for axis, (arch, _) in ARCH.items():
        cfg = jtiny(arch, dtype="float32", param_dtype="float32")
        tree = jax.tree.map(np.asarray,
                            JModel(cfg).init(jax.random.PRNGKey(0)))
        np.savez(wdir / f"{arch}.npz", **W.flatten(tree))
        out[axis] = params_from_numpy(tree, device="cpu")
    return wdir, out


@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    """The JAX pair's and the port pair's results, both pairs run at
    once: {"jax": [proc0, proc1], "port": [...]}."""
    out = tmp_path_factory.mktemp("runs")
    worker = str(HERE / "torch_distributed_worker.py")
    jport, tport = _free_port(), _free_port()
    cmds = [([sys.executable, worker, "jax_axes", str(p), "2", str(jport),
              str(out)], _child_env()) for p in range(2)]
    cmds += [([sys.executable, worker, "port_axes", str(p), "2", str(tport),
               str(out), str(trees[0])], _child_env()) for p in range(2)]
    for rc, log in _run_pairs(cmds):
        assert rc == 0, f"worker failed:\n{log}"
    return {m: [json.loads((out / f"{m}{p}.json").read_text())
                for p in range(2)] for m in ("jax_axes", "port_axes")}


@pytest.fixture(scope="module")
def one_process(trees):
    """The port's runs of each axis on a one-process mesh of 2 CPU
    shards: the yardstick of everything the JAX pair does not run."""
    out = {}
    for axis in ARCH:
        cfg = _cfg(axis)
        mesh = TM.make_mesh(MeshConfig(**{axis: 2}), ["cpu"] * 2)
        out[axis] = W.axes_runs(mesh, axis, trees[1][axis], cfg,
                                TC.Model(cfg, device="cpu"))
    return out


# -- (1) the JAX pair's tokens -----------------------------------------------

@pytest.mark.parametrize("axis", ["stage", "expert"])
def test_axis_across_processes_matches_jax(runs, axis):
    """Greedy generate (fused and stepped; under expert also a prompt
    batch whose even padded length takes the a2a path at prefill) and
    the Scheduler's tokens in both port processes equal the JAX
    package's two-process run, which agrees with itself."""
    j0, j1 = runs["jax_axes"]
    keys = [k for k in j0 if k.startswith(axis)]
    assert keys and all(j0[k] == j1[k] for k in keys)
    for r in runs["port_axes"]:
        got = r[axis]
        assert got["generate"] == j0[f"{axis}_generate"]
        assert got["generate_stepped"] == j0[f"{axis}_generate"]
        assert got["serve"] == j0[f"{axis}_serve"]
        if axis == "expert":
            assert got["generate_a2a"] == j0["expert_generate_a2a"]


# -- (2) the port's one-process run ------------------------------------------

@pytest.mark.parametrize("axis", ["stage", "expert"])
def test_axis_across_processes_logits(runs, one_process, axis):
    """The forward's logits (an 8-token prefill: the pipeline's hand-off
    and broadcast under stage, the a2a path under expert; then a decode
    step: the einsum path) in both processes within 2e-5 of the
    one-process run on the same mesh."""
    want = one_process[axis]
    worst = 0.0
    for r in runs["port_axes"]:
        for key in ("prefill", "step"):
            got, ref = np.asarray(r[axis][key]), np.asarray(want[key])
            assert got.shape == ref.shape
            worst = max(worst, float(np.abs(got - ref).max()))
    print(f"{axis}: largest logit difference to one process: {worst}")
    assert worst <= TOL


@pytest.mark.parametrize("axis,key", [
    ("stage", "generate_t1"), ("stage", "serve_kv_int8"),
    ("stage", "alternating"), ("stage", "speculative"),
    ("stage", "serve_spec"), ("stage", "interleaved"),
    ("expert", "generate_t1"), ("expert", "alternating"),
    ("expert", "speculative"), ("expert", "serve_spec"),
    ("expert", "generate_int8"),
])
def test_axis_across_processes_paths_match_one_process(runs, one_process,
                                                        axis, key):
    """Temperature 1.0 at a fixed seed, the int8 KV pool, the alternating
    path (fresh and warm flash per local stage, or under expert in each
    process beside the expert exchanges), n-gram speculation
    (generate_speculative and the serving spec blocks), the
    interleaved schedule (4 layers, V = 2: the wrap from the last stage
    back to stage 0 crosses the processes) and the int8 tree give in
    both processes the one-process run's tokens."""
    want = one_process[axis][key]
    for r in runs["port_axes"]:
        assert r[axis][key] == want


@pytest.mark.parametrize("axis", ["stage", "expert"])
def test_axis_across_processes_placement(runs, trees, one_process, axis):
    """Each process holds its own half of every leaf split over the
    crossing axis (process p: shard p of 2, one part) and the whole of
    every other leaf (the embedding, the final norm and the head in
    every process, as JAX's P() replicates them; under expert the
    attention, the norms and the router too): its bytes are exactly
    that, half the one-process mesh's split bytes."""
    params = trees[1][axis]
    flat = W.flatten({k: v.numpy() for k, v in _leaf_items(params)})
    split = [k for k in flat if (k.startswith("layers/") if axis == "stage"
                                 else k.split("/")[-1] in
                                 ("w_gate", "w_up", "w_down"))]
    whole = sum(v.nbytes for v in flat.values())
    half = sum(flat[k].nbytes for k in split) // 2
    held_one, split_one = one_process[axis]["held"]
    assert held_one == whole and split_one == {}
    for p, r in enumerate(runs["port_axes"]):
        held, parts = r[axis]["held"]
        assert held == whole - half
        assert parts == {k: [axis, p, 1, 2] for k in split}


def _leaf_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("axis", ["stage", "expert"])
def test_axis_across_processes_two_shards_a_process(runs, axis):
    """Four shards over the two processes, a run of two each: stage = 4
    (two stages a process, hand-offs inside a process and across) and
    expert = 4 (the all-to-all carries two shards' blocks a process)
    give in both processes the one-process run's tokens."""
    mesh = TM.make_mesh(MeshConfig(**{axis: 4}), ["cpu"] * 4)
    want = W.four_shard_runs(mesh, axis)
    for r in runs["port_axes"]:
        assert r[f"{axis}4"] == want


# -- (3) the meshes still refused --------------------------------------------

def _fake_mesh(monkeypatch, axes, procs):
    """A mesh of `axes` over CPU devices whose process indices are
    `procs` in mesh order, as process 0 of that job sees it."""
    monkeypatch.setattr(TM, "process_count", lambda: max(procs) + 1)
    return TM.make_mesh(MeshConfig(**axes), [
        TM.GlobalDevice(i, torch.device("cpu"), p, 0)
        for i, p in enumerate(procs)])


@pytest.mark.parametrize("axes,procs,crossing", [
    (dict(stage=2, tensor=2), [0, 1, 2, 3], "stage, tensor"),
    (dict(stage=2, expert=2), [0, 1, 2, 3], "stage, expert"),
    (dict(expert=2, tensor=2), [0, 1, 2, 3], "expert, tensor"),
    (dict(stage=2, tensor=2), [0, 0, 1, 1], "stage"),
    (dict(data=2, seq=2), [0, 1, 0, 1], "seq"),
])
def test_two_axes_across_processes_refused(monkeypatch, axes, procs,
                                           crossing):
    """Two axes crossing the processes at once, or another axis than
    data inside them beside the one that crosses, raise
    NotImplementedError naming their ROADMAP item; a data axis inside
    the processes beside the one that crosses (data = 2 beside seq
    across) passes."""
    mesh = _fake_mesh(monkeypatch, axes, procs)
    assert ", ".join(TM.axes_across_processes(mesh)) == crossing
    if axes.get("data", 1) > 1:
        TM.check_process_mesh(mesh)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1: two "
                       "axes across processes at once"):
        TM.check_process_mesh(mesh)


def test_data_inside_processes_refused(monkeypatch, runs):
    """A data axis inside the processes beside an axis across them runs:
    the mesh check passes for each of tensor, stage, expert and seq
    across, each process's devices of each data group are its own
    (`data_devices`, `local_group_devices`), and the worker's greedy
    generate with data = 2 inside beside stage across gives the JAX
    pair's stage tokens. What stays refused: a data axis across the
    processes (RuntimeError in the worker, the JAX package's failure),
    and a crossing axis that does not run in process order
    (ValueError, in a data group too); seq across the processes runs
    generate_long alike in both workers."""
    for axis in ("tensor", "stage", "expert", "seq"):
        mesh = _fake_mesh(monkeypatch, {"data": 2, axis: 2}, [0, 1, 0, 1])
        TM.check_process_mesh(mesh)
        assert TM.axes_across_processes(mesh) == [axis]
        assert [TM.owner(mesh, axis, i) for i in range(2)] == [0, 1]
        assert mesh.local_group_devices(1) == [torch.device("cpu")]
    mesh = _fake_mesh(monkeypatch, dict(expert=4), [0, 1, 0, 1])
    with pytest.raises(ValueError, match="expert axis must hold every one"):
        TM.check_process_mesh(mesh)
    mesh = _fake_mesh(monkeypatch, dict(data=2, expert=2), [1, 0, 1, 0])
    with pytest.raises(ValueError, match="in data group 0"):
        TM.check_process_mesh(mesh)
    mesh = _fake_mesh(monkeypatch, dict(data=2, tensor=2), [0, 0, 1, 1])
    with pytest.raises(RuntimeError, match="first read-back"):
        TM.check_process_mesh(mesh)
    j0 = runs["jax_axes"][0]
    a, b = runs["port_axes"]
    for r in (a, b):
        kind, msg = r["refusals"]["data"]
        assert kind == "RuntimeError" and "first read-back" in msg
        assert r["data2_stage_generate"] == j0["stage_generate"]
    assert a["seq_long"] == b["seq_long"]


def test_owner_and_local_stages(monkeypatch):
    """`owner` names the process of a stage or an expert shard; a
    process's stages are its run of them."""
    mesh = _fake_mesh(monkeypatch, dict(stage=4), [0, 0, 1, 1])
    assert [TM.owner(mesh, "stage", s) for s in range(4)] == [0, 0, 1, 1]
    assert mesh.local_range("stage") == (0, 2)
    TM.check_process_mesh(mesh)


def _same_tree(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, Shards):
        assert isinstance(b, Shards)
        assert (a.axis, a.split, a.offset, a.count) == \
            (b.axis, b.split, b.offset, b.count)
        assert len(a.parts) == len(b.parts)
        for x, y in zip(a.parts, b.parts):
            _same_tree(x, y)
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("source", ["draw", "draw_int8", "ckpt",
                                    "ckpt_int8"])
def test_local_experts_load_like_the_whole(monkeypatch, tmp_path, source):
    """On a mesh whose expert axis crosses processes the CLI's loader
    (serve/cli.py:load_params: the random draw, float or int8, and an HF
    checkpoint, float or quantized as it loads) keeps only this
    process's experts, and the placed tree equals the placement of the
    whole tree: every expert is still drawn, so the kept ones are the
    whole draw's."""
    cfg = _cfg("expert")
    mesh = _fake_mesh(monkeypatch, dict(expert=2), [0, 1])
    assert held_expert_range(cfg, mesh) == (0, 2)
    assert held_expert_range(cfg, None) is None
    ckpt = None
    if source.startswith("ckpt"):
        ckpt = str(tmp_path)
        write_hf_dir(ckpt, cfg, hf_state_dict(cfg))
    args = argparse.Namespace(
        ckpt=ckpt, quant="int8" if source.endswith("int8") else "none")
    model = TC.Model(cfg, device="cpu")
    part = cli.load_params(model, args, mesh)
    w = part["layers"]["moe"]["w_up"]
    w = w["q8"] if isinstance(w, dict) else w
    assert isinstance(w, Shards) and (w.offset, len(w.parts), w.count) \
        == (0, 1, 2) and w.parts[0].shape[1] == 2
    _same_tree(shard_params(part, cfg, mesh),
               shard_params(cli.load_params(model, args), cfg, mesh))


# -- (4) the CLI -------------------------------------------------------------

_TINY_MIXTRAL = ("import sys; from butterfly_tpu_torch.core import config as C; "
                 "C.PRESETS['tiny-mixtral'] = lambda: C.tiny('mixtral', "
                 "dtype='float32', param_dtype='float32'); "
                 "from butterfly_tpu_torch.serve import cli; "
                 "sys.exit(cli.main(sys.argv[1:]))")


@pytest.mark.parametrize("axis,model", [("stage", "tiny"),
                                        ("expert", "tiny-mixtral")])
def test_cli_generate_two_processes_axis(capsys, monkeypatch, axis, model):
    """`generate --stage-parallel 2` (the tiny Llama) and `generate
    --expert-parallel 2` (a tiny Mixtral: the CLI has none, as the JAX
    CLI has none, so the test adds it to the presets in each process) in
    two processes (BUTTERFLY_NUM_PROCESSES=2, torchrun's variables) print
    the one-process run's text in both."""
    monkeypatch.setitem(TCFG.PRESETS, "tiny-mixtral",
                        lambda: tiny("mixtral", dtype="float32",
                                     param_dtype="float32"))
    args = ["generate", "--model", model, "--device", "cpu",
            f"--{axis}-parallel", "2", "--prompt", "hello", "--max-new", "8"]
    assert cli.main(args) == 0
    want = capsys.readouterr().out
    assert want.strip()
    port = _free_port()
    cmds = [([sys.executable, "-c", _TINY_MIXTRAL, *args],
             _child_env(BUTTERFLY_NUM_PROCESSES="2", MASTER_ADDR="127.0.0.1",
                        MASTER_PORT=str(port), RANK=str(r)))
            for r in range(2)]
    for rc, out in _run_pairs(cmds):
        assert rc == 0, out
        assert want in out
