"""PyTorch port: the seq axis across processes (parallel/sequence.py's
ring pass, Ulysses' all-to-alls, the decode merges' all-gathers, the
serving long-prompt lane) and a data axis inside the processes beside
each axis that may cross them, against the JAX package's own
two-process runs, float32, on the CPU.

Two pairs of subprocess workers (torch_distributed_worker.py, modes
`jax_seq` and `port_seq`), each pair with a real rendezvous, run at once.
With seq = 2 across the processes (one device a process) the tiny
float32 Llama from PRNGKey(0) runs generate_long on a 37-token prompt
(ring and Ulysses) and a Scheduler over a ServingEngine whose long-prompt
lane takes that prompt: both port processes must give the JAX
processes' tokens and lane count, and every other run (the int8 KV,
temperature 1.0) the port's one-process seq = 2 run's; the draft model
(linear and a token tree) gives the JAX pair's tokens, and the draft's
own cache after the run equals the one-process run's; the forward's and
a decode step's logits within 2e-5 of it; each process holds its own
seq shard alone. Then data = 2 inside each process (two CPU devices a
process) beside each of tensor, stage, expert (the tiny Mixtral) and seq
across them: greedy generate and serving equal the JAX pair's, and
beside seq across the draft model too, as with tensor = 2 inside. The CLI
under BUTTERFLY_NUM_PROCESSES=2 prints the one-process text in both
processes, seq across alone and with data inside.
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
from butterfly_tpu_torch.core import mesh as TM
from butterfly_tpu_torch.core.config import MeshConfig, tiny
from butterfly_tpu_torch.models import common as TC
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.serve import cli

import torch_distributed_worker as W
from test_torch_distributed import _child_env, _free_port, _run_pairs

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
TOL = 2e-5


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(directory of the JAX trees of PRNGKey(0) as llama.npz and
    mixtral.npz, the bridged port Llama)."""
    wdir = tmp_path_factory.mktemp("w")
    port = None
    for arch in ("llama", "mixtral"):
        cfg = jtiny(arch, dtype="float32", param_dtype="float32")
        tree = jax.tree.map(np.asarray,
                            JModel(cfg).init(jax.random.PRNGKey(0)))
        np.savez(wdir / f"{arch}.npz", **W.flatten(tree))
        if arch == "llama":
            port = params_from_numpy(tree, device="cpu")
    return wdir, port


@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    """The JAX pairs' and the port pair's results, every pair run at
    once: {"jax_seq": [proc0, proc1], "jax_seq_draft": [...], "port_seq":
    [...]}."""
    out = tmp_path_factory.mktemp("runs")
    worker = str(HERE / "torch_distributed_worker.py")
    jport, dport, tport = _free_port(), _free_port(), _free_port()
    jenv = _child_env()
    # two CPU devices a JAX process, for the data-inside meshes
    jenv["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                         + jenv["XLA_FLAGS"])
    cmds = [([sys.executable, worker, "jax_seq", str(p), "2", str(jport),
              str(out)], jenv) for p in range(2)]
    # the draft model's JAX run, a job of its own beside the main one
    cmds += [([sys.executable, worker, "jax_seq", str(p), "2", str(dport),
               str(out), "draft"], jenv) for p in range(2)]
    cmds += [([sys.executable, worker, "port_seq", str(p), "2", str(tport),
               str(out), str(trees[0])], _child_env()) for p in range(2)]
    for rc, log in _run_pairs(cmds):
        assert rc == 0, f"worker failed:\n{log}"
    return {m: [json.loads((out / f"{m}{p}.json").read_text())
                for p in range(2)]
            for m in ("jax_seq", "jax_seq_draft", "port_seq")}


@pytest.fixture(scope="module")
def one_process(trees):
    """The port's seq runs on a one-process mesh of 2 CPU shards: the
    yardstick of everything the JAX pair does not run."""
    cfg = tiny("llama", dtype="float32", param_dtype="float32")
    return W.seq_runs(TM.make_mesh(MeshConfig(seq=2), ["cpu"] * 2),
                      trees[1], cfg, TC.Model(cfg, device="cpu"))


# -- (1) seq across the processes --------------------------------------------

def test_seq_across_processes_matches_jax(runs):
    """generate_long on the 37-token prompt (ring and Ulysses) and the
    Scheduler's tokens through the long-prompt lane, with its
    seq_parallel_prefill_tokens_total, in both port processes equal the
    JAX package's two-process run, which agrees with itself."""
    j0, j1 = runs["jax_seq"]
    assert j0 == j1
    assert j0["seq_lane_tokens"] == len(W.LONG_PROMPT)
    for r in runs["port_seq"]:
        got = r["seq"]
        assert got["long_ring_none"] == j0["seq_long_ring"]
        assert got["long_ulysses_none"] == j0["seq_long_ulysses"]
        assert got["serve"] == j0["seq_serve"]
        assert got["lane_tokens"] == j0["seq_lane_tokens"]


def test_seq_across_processes_logits(runs, one_process):
    """The forward's logits (every shard's, gathered) and one decode
    step's (the partials all-gathered and combined in shard order) in
    both processes within 2e-5 of the one-process seq = 2 run."""
    worst = 0.0
    for r in runs["port_seq"]:
        for key in ("prefill", "step"):
            got = np.asarray(r["seq"][key])
            ref = np.asarray(one_process[key])
            assert got.shape == ref.shape
            worst = max(worst, float(np.abs(got - ref).max()))
    print(f"largest logit difference to one process: {worst}")
    assert worst <= TOL


@pytest.mark.parametrize("key", ["long_ring_int8", "long_ulysses_int8",
                                 "long_t1_none", "long_t1_int8",
                                 "serve_int8"])
def test_seq_across_processes_paths_match_one_process(runs, one_process,
                                                      key):
    """The int8 KV (the ring's codes and scales pass between the
    processes; Ulysses reshards their dequantised values), temperature
    1.0 at a fixed seed and the int8 pool's long-prompt lane give in both
    processes the one-process run's tokens."""
    for r in runs["port_seq"]:
        assert r["seq"][key] == one_process[key]


def test_seq_across_processes_holds_own_shards(runs, one_process):
    """Each process builds only its own seq shard's weight tree and keeps
    only its own shard's K/V (None for the other's); one process holds
    both."""
    assert one_process["trees"] == [False, False]
    assert one_process["prefix_remote"] == [False, False]
    for p, r in enumerate(runs["port_seq"]):
        other = [i != p for i in range(2)]
        assert r["seq"]["trees"] == other
        assert r["seq"]["prefix_remote"] == other


# the JAX package's one-process draft-model tokens: its two-process run
# under seq = 2 across gives them too (checked live below); its token
# tree and its runs beside tensor = 2 or data = 2 inside the processes,
# recorded in ROADMAP.md Queue 1 item 2, give the same tokens
DRAFT_TOKENS = [[140, 109, 49, 49, 49, 49], [39, 42, 200, 34, 192, 27]]


@pytest.mark.parametrize("key", ["draft", "draft_tree"])
def test_draft_model_seq_across_processes_matches_jax(runs, key):
    """The draft model (RuntimeConfig.draft_model="model", one layer,
    gamma 3; and a token tree of width 2) with the seq axis across the
    processes: the Scheduler's tokens in each port process equal the
    JAX pair's linear run in the same process (its one-process tokens;
    its recorded tree run gives them too)."""
    for j in runs["jax_seq_draft"]:
        assert j["seq_draft"] == DRAFT_TOKENS
    for j, r in zip(runs["jax_seq_draft"], runs["port_seq"]):
        assert r["seq"][key]["tokens"] == j["seq_draft"]


@pytest.mark.parametrize("key", ["draft", "draft_tree"])
def test_draft_model_seq_across_processes_state(runs, one_process, key):
    """The draft's own cache after the run (every admission's prefill
    from host truth, every round's rollback to the accepted count): its
    lengths equal, and its K within 2e-5 of, the one-process seq = 2
    run's in both processes."""
    want = one_process[key]
    for r in runs["port_seq"]:
        got = r["seq"][key]
        assert got["draft_len"] == want["draft_len"]
        diff = np.abs(np.asarray(got["draft_k"]) - np.asarray(want["draft_k"]))
        assert diff.max() <= TOL


@pytest.mark.parametrize("key", ["data2_seq", "seq_tensor2"])
def test_draft_model_seq_across_beside_inside_axis_matches_jax(runs, key):
    """The draft model with seq across the processes beside data = 2
    inside them, or beside tensor = 2 inside them: the port's tokens in
    each process equal the JAX pair's seq = 2 draft run in the same
    process (the JAX package's recorded runs on these two layouts give
    those tokens too)."""
    for j, r in zip(runs["jax_seq_draft"], runs["port_seq"]):
        if key == "data2_seq":
            assert r[key]["draft"] == j["seq_draft"]
        else:
            assert r["seq_tensor2_draft"]["tokens"] == j["seq_draft"]
            assert r["seq_tensor2_draft"]["processes"] == [0, 0, 1, 1]


# -- (2) data inside the processes -------------------------------------------

@pytest.mark.parametrize("axis", ["tensor", "stage", "expert", "seq"])
def test_data_inside_processes_matches_jax(runs, axis):
    """data = 2 inside each process beside `axis` across them (each data
    group one device of each process): greedy generate and the
    Scheduler's tokens (under seq through the long-prompt lane) in both
    port processes equal the JAX pair's; under seq generate_long gives
    the JAX pair's seq = 2 tokens."""
    j0, j1 = runs["jax_seq"]
    key = f"data2_{axis}"
    for r in runs["port_seq"]:
        got = r[key]
        assert got["processes"] == [0, 1, 0, 1]
        assert got["generate"] == j0[f"{key}_generate"]
        assert got["serve"] == j0[f"{key}_serve"]
        if axis == "seq":
            assert got["long"] == j0["seq_long_ring"]
            assert got["lane_tokens"] == len(W.LONG_PROMPT)


def test_cli_dcn_axes_put_data_inside(monkeypatch):
    """In a job of two processes `--dcn-axes seq` with `--seq-parallel 2
    --data-parallel 2` takes two CPU devices a process and counts each
    process as a slice: seq crosses the processes, data lies inside
    them. The default `--dcn-axes data` keeps the hosts' one slice (seq
    alone across, as before)."""
    monkeypatch.setattr(TM, "process_count", lambda: 2)
    monkeypatch.setattr(TM, "init_distributed", lambda: None)
    monkeypatch.setattr(TM, "global_devices", lambda device, per_process: [
        TM.GlobalDevice(i, torch.device("cpu"), i // per_process, 0)
        for i in range(2 * per_process)])
    ns = dict(tensor_parallel=1, stage_parallel=1, expert_parallel=1,
              device="cpu")
    mesh = cli.build_mesh(argparse.Namespace(
        seq_parallel=2, data_parallel=2, dcn_axes="seq", **ns))
    assert mesh.processes.reshape(-1).tolist() == [0, 1, 0, 1]
    assert TM.axes_across_processes(mesh) == ["seq"]
    mesh = cli.build_mesh(argparse.Namespace(
        seq_parallel=2, data_parallel=1, dcn_axes="data", **ns))
    assert mesh.processes.reshape(-1).tolist() == [0, 1]


# -- (3) the CLI -------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--seq-parallel", "2"],
    ["--seq-parallel", "2", "--data-parallel", "2", "--dcn-axes", "seq"],
])
def test_cli_generate_seq_parallel_two_processes(capsys, flags):
    """`generate --seq-parallel 2` (generate_long) in two processes
    (BUTTERFLY_NUM_PROCESSES=2, torchrun's variables), alone and with
    data = 2 inside the processes, prints in both the one-process run's
    text."""
    args = ["generate", "--model", "tiny", "--device", "cpu", "--prompt",
            "hello", "--max-new", "8"]
    assert cli.main(args + ["--seq-parallel", "2"]) == 0
    want = capsys.readouterr().out
    assert want.strip()
    port = _free_port()
    cmds = [([sys.executable, "-m", "butterfly_tpu_torch.serve.cli", *args,
              *flags],
             _child_env(BUTTERFLY_NUM_PROCESSES="2", MASTER_ADDR="127.0.0.1",
                        MASTER_PORT=str(port), RANK=str(r)))
            for r in range(2)]
    for rc, out in _run_pairs(cmds):
        assert rc == 0, out
        assert want in out
        assert "over 2-way sequence parallelism" in out
