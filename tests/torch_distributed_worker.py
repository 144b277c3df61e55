"""Worker for tests/test_torch_distributed*.py (run as a subprocess): one
process of a job of two (or four) processes, on the CPU.

    python torch_distributed_worker.py jax  <pid> <n> <port> <outdir>
    python torch_distributed_worker.py port <pid> <n> <port> <outdir> <weights.npz>
    python torch_distributed_worker.py jax_axes  <pid> <n> <port> <outdir>
    python torch_distributed_worker.py port_axes <pid> <n> <port> <outdir> <weights_dir>
    python torch_distributed_worker.py jax_seq   <pid> <n> <port> <outdir> [draft]
    python torch_distributed_worker.py port_seq  <pid> <n> <port> <outdir> <weights_dir>
    python torch_distributed_worker.py jax_two   <pid> <n> <port> <outdir> <layout>
    python torch_distributed_worker.py port_two  <pid> <n> <port> <outdir> <weights_dir> <layouts>

`jax` runs the JAX package's multi-host path (init_distributed,
make_hybrid_mesh over jax.devices(), shard_params) on the tiny float32
Llama from PRNGKey(0): greedy generate and a Scheduler over a
ServingEngine with the tensor axis across the two processes, the
Scheduler with the draft model there (DRAFT_RT), which the JAX package
fails at its first spec block, then a data axis across them, which it
fails at its first read-back. Every JAX mode ends with the coordination
service's shutdown and os._exit (`_jax_exit`).
`port` runs the same on butterfly_tpu_torch (gloo), with the same weights
from `weights.npz` (models/bridge.py:params_from_numpy), plus the worker
sum, all_hosts_probe, the forward's logits, the data axis's refusal, the
draft model's refusal at engine build and generate_long with the seq
axis across the processes. Each writes
`<outdir>/<mode><pid>.json` (and the port `<outdir>/port<pid>.npz`).

`jax_axes` and `port_axes` run the same with the stage axis across the
two processes (the tiny float32 Llama, one layer a stage) and then the
expert axis (the tiny float32 Mixtral, moe_impl="ep"), both trees from
PRNGKey(0) (the port's from `<weights_dir>/llama.npz`, `mixtral.npz`):
greedy generate (fused; and an expert run whose padded prompt length is
even, so its prefill takes the a2a path) and the Scheduler's tokens; the
Scheduler with the draft model, which the JAX package fails (the port
refuses it at engine build).
The port adds the stepped loop, temperature 1.0, the int8 KV pool, the
alternating path, n-gram speculation (generate and serving), the
interleaved schedule (a 4-layer Llama from torch seed 0, V = 2), the
int8 tree, the forward's logits, what each process holds, and each axis
at 4 shards, a run of two a process; then the data axis's refusal,
generate_long with seq across and generate with data = 2 inside beside
stage across.

`jax_seq` and `port_seq` run the seq axis across the two processes (the
tiny float32 Llama: generate_long, ring and Ulysses, on a 37-token
prompt; a Scheduler whose long-prompt lane takes it; with `draft` a job
of its own runs the Scheduler with the draft model), then data = 2
inside each process beside each of
tensor, stage, expert (the tiny Mixtral) and seq across them (two CPU
devices a process). The port adds the int8 KV, temperature 1.0, the
forward's and a decode step's logits, which seq shards each process
holds, the draft model's token tree and the draft's cache after its
runs, and the draft model beside data = 2 and beside tensor = 2 inside
the processes.

`jax_two` and `port_two` run two mesh axes at once (tests/
test_torch_distributed_two.py): each pair of stage, expert, seq and
tensor (`PAIRS`) in layout A (the outer axis across two processes of two
devices, the inner inside), B (the inner across) or C (both across four
processes of one device), or data = 2 inside two processes of four
devices beside an axis across and one inside (`DATA_INSIDE`, layout D):
greedy generate, the Scheduler, and under seq generate_long and the
Scheduler through the long-prompt lane. The port adds the stepped loop,
temperature 1.0, the logits (`two_logits`), what each process holds and
whether a ServingEngine with the draft model builds.
"""
import json
import os
import sys
import time

import numpy as np

GEN_PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9]]
GEN_NEW = 6
SERVE_NEW = 4
SERVE_RT = dict(max_batch_size=2, max_seq_len=64, page_size=8)
LOGIT_TOKENS = np.random.RandomState(3).randint(0, 258, (2, 7))
# an even padded length: the expert = 2 prefill takes the a2a path
A2A_PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8], [7, 8, 9]]
AXES_LOGIT_TOKENS = np.random.RandomState(4).randint(0, 258, (2, 8))
# the seq axis across the processes: a 37-token prompt, the long-prompt
# lane's threshold below it
LONG_PROMPT = np.random.RandomState(7).randint(1, 258, 37).tolist()
SEQ_THRESHOLD = 16
# data = 2 inside each process beside each axis across them
INSIDE = (("tensor", "llama", {}), ("stage", "llama", {}),
          ("expert", "mixtral", dict(moe_impl="ep")), ("seq", "llama", {}))
# the draft model (RuntimeConfig.draft_model="model"): the first layer of
# the two-layer target, gamma 3, GEN_NEW new tokens a request; a token
# tree of width 2 and 7 nodes
DRAFT_RT = dict(speculative_gamma=3, draft_model="model", draft_layers=1,
                **SERVE_RT)
DRAFT_TREE = dict(spec_tree_width=2, spec_tree_nodes=7)


def flatten(tree, prefix=""):
    """A nested dict of arrays as {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def serve(model, params, rt, mesh, prompts=GEN_PROMPTS):
    """The greedy outputs of `prompts` through a Scheduler over a
    ServingEngine (SERVE_NEW new tokens each)."""
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    sched = Scheduler(ServingEngine(model, params, rt, mesh=mesh))
    reqs = [sched.submit(p, max_new_tokens=SERVE_NEW) for p in prompts]
    sched.run_until_done()
    return [r.output for r in reqs]


def draft_serve(model, params, mesh, tree=False):
    """GEN_PROMPTS (GEN_NEW new tokens each) through a Scheduler whose
    ServingEngine drafts with the draft model (DRAFT_RT; a token tree
    with `tree`): {"tokens", and where the draft cache is one tensor
    "draft_len": its lengths and "draft_k": its K summed over kv heads
    and head dims [L, S, W] after the run (the admissions' prefills and
    every round's rollback)}."""
    import torch
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    rt = RuntimeConfig(**DRAFT_RT, **(DRAFT_TREE if tree else {}))
    sched = Scheduler(ServingEngine(model, params, rt, mesh=mesh))
    reqs = [sched.submit(p, max_new_tokens=GEN_NEW) for p in GEN_PROMPTS]
    sched.run_until_done()
    out = {"tokens": [r.output for r in reqs]}
    state = sched.engine._draft_state
    if torch.is_tensor(state.k):
        out["draft_len"] = state.length.tolist()
        out["draft_k"] = state.k.sum(dim=(-2, -1)).tolist()
    return out


def draft_refusal(model, params, mesh):
    """(type, message) of building a ServingEngine with the draft model
    on `mesh`, or None where it builds."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.serving import ServingEngine
    return _error(lambda: ServingEngine(model, params,
                                        RuntimeConfig(**DRAFT_RT), mesh=mesh))


def variants(mesh):
    """Paths beside the main ones, with weights from torch seed 0 on
    `mesh`: a tiny Llama with one kv head (replicated K/V under tensor =
    2: each shard's q heads against the whole K/V), greedy generate and
    serving; tiny GPT-2 (biases, tied embeddings: the LM head is the
    vocab-split embedding); the Llama's serving with prefix caching (two
    requests sharing a prompt) and on the alternating path (fresh and
    warm flash per shard). {name: tokens}."""
    import torch
    from butterfly_tpu_torch.core.config import RuntimeConfig, tiny
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.models import common as TC
    out = {}
    for name, arch, kw in (("kv1", "llama", dict(num_kv_heads=1)),
                           ("gpt2", "gpt2", {}), ("llama", "llama", {})):
        cfg = tiny(arch, dtype="float32", param_dtype="float32", **kw)
        model = TC.Model(cfg, device="cpu")
        params = TC.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        if name != "llama":
            out[f"{name}_generate"] = InferenceEngine(
                model, params, mesh=mesh).generate(
                GEN_PROMPTS, SamplingParams(max_new_tokens=GEN_NEW)
            ).tokens.tolist()
        out[f"{name}_serve"] = serve(model, params,
                                     RuntimeConfig(**SERVE_RT), mesh)
    for name, kw in (("prefix", dict(prefix_caching=True)),
                     ("alternating", dict(mixed_dispatch=False))):
        out[name] = serve(model, params, RuntimeConfig(**SERVE_RT, **kw),
                          mesh, prompts=[GEN_PROMPTS[0] * 4,
                                         GEN_PROMPTS[0] * 4 + [9]])
    return out


def _error(fn):
    """(exception type name, message) of fn(), or None when it returns."""
    try:
        fn()
    except Exception as e:   # noqa: BLE001 - recorded for the test
        return [type(e).__name__, str(e)]
    return None


def run_jax(pid, n, port, outdir):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from butterfly_tpu.core.config import MeshConfig, RuntimeConfig, tiny
    from butterfly_tpu.core.mesh import init_distributed, make_hybrid_mesh
    from butterfly_tpu.engine.engine import InferenceEngine
    from butterfly_tpu.engine.sampling import SamplingParams
    from butterfly_tpu.engine.serving import ServingEngine
    from butterfly_tpu.models.common import Model
    from butterfly_tpu.parallel.partition import shard_params
    from butterfly_tpu.sched.scheduler import Scheduler

    init_distributed(coordinator=f"127.0.0.1:{port}", num_processes=n,
                     process_id=pid)
    cfg = tiny("llama", dtype="float32", param_dtype="float32")
    model = Model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    out = {}
    mesh = make_hybrid_mesh(MeshConfig(tensor=n), jax.devices())
    sp = shard_params(params, cfg, mesh)
    eng = InferenceEngine(model, sp, mesh=mesh)
    out["generate"] = eng.generate(
        GEN_PROMPTS, SamplingParams(max_new_tokens=GEN_NEW)).tokens.tolist()
    rt = RuntimeConfig(**SERVE_RT)
    sched = Scheduler(ServingEngine(model, sp, rt, mesh=mesh))
    reqs = [sched.submit(p, max_new_tokens=SERVE_NEW) for p in GEN_PROMPTS]
    sched.run_until_done()
    out["serve"] = [r.output for r in reqs]
    # the draft model with the tensor axis across: fails at its first
    # spec block
    out["draft"] = _jax_draft(model, sp, mesh)

    dmesh = make_hybrid_mesh(MeshConfig(data=n), jax.devices())
    deng = InferenceEngine(model, shard_params(params, cfg, dmesh),
                           mesh=dmesh)
    out["data_error"] = _error(lambda: deng.generate(
        GEN_PROMPTS, SamplingParams(max_new_tokens=GEN_NEW)))
    with open(os.path.join(outdir, f"jax{pid}.json"), "w") as f:
        json.dump(out, f)
    _jax_exit(jax)


def run_port(pid, n, port, outdir, weights):
    import torch
    torch.set_num_threads(1)
    from butterfly_tpu_torch.core.config import (MeshConfig, RuntimeConfig,
                                                 tiny)
    from butterfly_tpu_torch.core.mesh import (global_devices,
                                               init_distributed,
                                               make_hybrid_mesh, mesh_ctx)
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.models import common as TC
    from butterfly_tpu_torch.models.bridge import params_from_numpy
    from butterfly_tpu_torch.obs.health import all_hosts_probe
    from butterfly_tpu_torch.parallel.partition import Shards, shard_params
    from butterfly_tpu_torch.quant.int8 import (quantize_int8,
                                                shard_quantized_params)

    init_distributed(coordinator=f"127.0.0.1:{port}", num_processes=n,
                     process_id=pid, timeout_s=60)
    out = {}
    x = torch.full((1,), float(pid + 1))
    torch.distributed.all_reduce(x)
    out["sum"] = x.item()
    out["probe"] = all_hosts_probe(["cpu"])
    devs = global_devices("cpu")
    out["devices"] = [[d.id, d.process_index, d.slice_index, str(d.device)]
                      for d in devs]

    cfg = tiny("llama", dtype="float32", param_dtype="float32")
    model = TC.Model(cfg, device="cpu")
    params = params_from_numpy(unflatten(dict(np.load(weights))),
                               device="cpu")
    mesh = make_hybrid_mesh(MeshConfig(tensor=n), devs)
    placed = shard_params(params, cfg, mesh)
    wq = placed["layers"]["attn"]["wq"]
    out["wq"] = [isinstance(wq, Shards), len(wq.parts), wq.offset, wq.count,
                 list(wq.shape)]

    toks = torch.as_tensor(LOGIT_TOKENS)
    with mesh_ctx(mesh):
        cache = TC.init_cache(cfg, toks.shape[0], 32, device="cpu",
                              mesh=mesh)
        prefill, cache = TC.forward(placed, cfg, toks, cache)
        step, cache = TC.forward(placed, cfg, toks[:, :1], cache)

    eng = InferenceEngine(model, placed, mesh=mesh)
    sp = SamplingParams(max_new_tokens=GEN_NEW)
    out["generate"] = eng.generate(GEN_PROMPTS, sp).tokens.tolist()
    out["generate_stepped"] = eng.generate(GEN_PROMPTS, sp,
                                           fused=False).tokens.tolist()
    out["generate_t1"] = eng.generate(
        GEN_PROMPTS, SamplingParams(max_new_tokens=GEN_NEW, temperature=1.0),
        seed=5).tokens.tolist()
    out["serve"] = serve(model, placed, RuntimeConfig(**SERVE_RT), mesh)
    out["serve_kv_int8"] = serve(model, placed, RuntimeConfig(
        kv_quant="int8", **SERVE_RT), mesh)
    qeng = InferenceEngine(model, shard_quantized_params(
        quantize_int8(params, cfg), cfg, mesh), mesh=mesh)
    out["generate_int8"] = qeng.generate(GEN_PROMPTS, sp).tokens.tolist()

    out["variants"] = variants(mesh)

    # a data axis across the processes is refused (the JAX package fails
    # there); seq across them runs generate_long
    dmesh = make_hybrid_mesh(MeshConfig(data=n), devs)
    out["refusals"] = {"data": _error(lambda: InferenceEngine(
        model, params, mesh=dmesh))}
    # the draft model with the tensor axis across: refused at build
    out["draft"] = draft_refusal(model, placed, mesh)
    out["seq_long"] = InferenceEngine(
        model, params, mesh=make_hybrid_mesh(MeshConfig(seq=n), devs)
    ).generate_long(LONG_PROMPT, sp).tokens.tolist()
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(outdir, f"port{pid}.npz"),
             prefill=prefill.numpy(), step=step.numpy())
    with open(os.path.join(outdir, f"port{pid}.json"), "w") as f:
        json.dump(out, f)


def run_jax_axes(pid, n, port, outdir):
    """The JAX package with stage = n, then expert = n, across the
    processes."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from butterfly_tpu.core.config import MeshConfig, RuntimeConfig, tiny
    from butterfly_tpu.core.mesh import init_distributed, make_hybrid_mesh
    from butterfly_tpu.engine.engine import InferenceEngine
    from butterfly_tpu.engine.sampling import SamplingParams
    from butterfly_tpu.engine.serving import ServingEngine
    from butterfly_tpu.models.common import Model
    from butterfly_tpu.parallel.partition import shard_params
    from butterfly_tpu.sched.scheduler import Scheduler

    init_distributed(coordinator=f"127.0.0.1:{port}", num_processes=n,
                     process_id=pid)
    out = {}
    for axis, arch, kw in (("stage", "llama", {}),
                           ("expert", "mixtral", dict(moe_impl="ep"))):
        cfg = tiny(arch, dtype="float32", param_dtype="float32", **kw)
        model = Model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        mesh = make_hybrid_mesh(MeshConfig(**{axis: n}), jax.devices())
        sp = shard_params(params, cfg, mesh)
        eng = InferenceEngine(model, sp, mesh=mesh)
        gsp = SamplingParams(max_new_tokens=GEN_NEW)
        out[f"{axis}_generate"] = eng.generate(GEN_PROMPTS,
                                               gsp).tokens.tolist()
        if axis == "expert":
            out["expert_generate_a2a"] = eng.generate(
                A2A_PROMPTS, gsp).tokens.tolist()
        sched = Scheduler(ServingEngine(model, sp, RuntimeConfig(**SERVE_RT),
                                        mesh=mesh))
        reqs = [sched.submit(p, max_new_tokens=SERVE_NEW)
                for p in GEN_PROMPTS]
        sched.run_until_done()
        out[f"{axis}_serve"] = [r.output for r in reqs]
        # the draft model with this axis across: fails at its first spec
        # block
        out[f"{axis}_draft"] = _jax_draft(model, sp, mesh)
    with open(os.path.join(outdir, f"jax_axes{pid}.json"), "w") as f:
        json.dump(out, f)
    _jax_exit(jax)


def _held(tree):
    """(bytes this process holds, {leaf: [offset, parts, count]} of every
    leaf split over processes) of a placed tree."""
    from butterfly_tpu_torch.parallel.partition import Shards
    held, split = 0, {}

    def walk(t, path):
        nonlocal held
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}" if path else k)
        elif isinstance(t, Shards):
            held += t.nbytes
            if t.distributed:
                split[path] = [t.axis, t.offset, len(t.parts), t.count]
        elif t is not None:
            held += t.nbytes
    walk(tree, "")
    return held, split


def axes_runs(mesh, axis, params, cfg, model):
    """The port's runs on `mesh` (`axis` = stage or expert of 2) with the
    bridged JAX tree `params`: {name: tokens or logits (lists)}. Run the
    same in one process (the test's yardstick) and in each worker."""
    import torch
    from butterfly_tpu_torch.core.config import RuntimeConfig, tiny
    from butterfly_tpu_torch.core.mesh import mesh_ctx
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.models import common as TC
    from butterfly_tpu_torch.parallel.partition import shard_params
    from butterfly_tpu_torch.parallel.pipeline import pipeline_forward
    from butterfly_tpu_torch.quant.int8 import (quantize_int8,
                                                shard_quantized_params)
    out = {}
    placed = shard_params(params, cfg, mesh)
    out["held"] = _held(placed)
    toks = torch.as_tensor(AXES_LOGIT_TOKENS)
    fwd = TC.forward if axis == "expert" else (
        lambda p, c, t, kv: pipeline_forward(p, c, t, kv, mesh))
    with mesh_ctx(mesh):
        cache = TC.init_cache(cfg, toks.shape[0], 32, device="cpu",
                              mesh=mesh)
        prefill, cache = fwd(placed, cfg, toks, cache)
        step, cache = fwd(placed, cfg, toks[:, :1], cache)
    out["prefill"] = prefill.tolist()
    out["step"] = step.tolist()
    eng = InferenceEngine(model, placed, mesh=mesh)
    sp = SamplingParams(max_new_tokens=GEN_NEW)
    out["generate"] = eng.generate(GEN_PROMPTS, sp).tokens.tolist()
    out["generate_stepped"] = eng.generate(GEN_PROMPTS, sp,
                                           fused=False).tokens.tolist()
    out["generate_t1"] = eng.generate(
        GEN_PROMPTS, SamplingParams(max_new_tokens=GEN_NEW, temperature=1.0),
        seed=5).tokens.tolist()
    out["serve"] = serve(model, placed, RuntimeConfig(**SERVE_RT), mesh)
    out["alternating"] = serve(model, placed, RuntimeConfig(
        mixed_dispatch=False, **SERVE_RT), mesh,
        prompts=[GEN_PROMPTS[0] * 4, GEN_PROMPTS[0] * 4 + [9]])
    # n-gram speculation: generate_speculative and the serving spec blocks
    out["speculative"] = eng.generate_speculative(
        GEN_PROMPTS[0] * 3, sp, gamma=3).tokens.tolist()
    out["serve_spec"] = serve(model, placed, RuntimeConfig(
        speculative_gamma=3, **SERVE_RT), mesh,
        prompts=[GEN_PROMPTS[0] * 3, GEN_PROMPTS[1] * 3])
    if axis == "expert":
        out["generate_a2a"] = eng.generate(A2A_PROMPTS, sp).tokens.tolist()
        q8 = shard_quantized_params(quantize_int8(params, cfg), cfg, mesh)
        out["generate_int8"] = InferenceEngine(model, q8, mesh=mesh).generate(
            A2A_PROMPTS, sp).tokens.tolist()
        return out
    out["serve_kv_int8"] = serve(model, placed, RuntimeConfig(
        kv_quant="int8", **SERVE_RT), mesh)
    # the interleaved schedule: 4 layers, two chunks a stage
    cfg4 = tiny("llama", dtype="float32", param_dtype="float32",
                num_layers=4)
    p4 = TC.init_params(cfg4, torch.Generator().manual_seed(0), "cpu")
    out["interleaved"] = InferenceEngine(
        TC.Model(cfg4, device="cpu"), p4, mesh=mesh, num_microbatches=2,
        virtual_stages=2).generate(GEN_PROMPTS, sp).tokens.tolist()
    return out


def four_shard_runs(mesh, axis):
    """Greedy generate (under expert also the a2a prompts) and serving
    with weights from torch seed 0 on a mesh of 4 `axis` shards: the
    tiny Llama at 4 layers (one a stage), or the tiny Mixtral (one
    expert a shard). {name: tokens}."""
    import torch
    from butterfly_tpu_torch.core.config import RuntimeConfig, tiny
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.models import common as TC
    cfg = (tiny("llama", dtype="float32", param_dtype="float32",
                num_layers=4) if axis == "stage" else
           tiny("mixtral", dtype="float32", param_dtype="float32",
                moe_impl="ep"))
    model = TC.Model(cfg, device="cpu")
    params = TC.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = InferenceEngine(model, params, mesh=mesh)
    sp = SamplingParams(max_new_tokens=GEN_NEW)
    out = {"generate": eng.generate(GEN_PROMPTS, sp).tokens.tolist(),
           "serve": serve(model, params, RuntimeConfig(**SERVE_RT), mesh)}
    if axis == "expert":
        out["generate_a2a"] = eng.generate(A2A_PROMPTS, sp).tokens.tolist()
    return out


def run_port_axes(pid, n, port, outdir, wdir):
    import torch
    torch.set_num_threads(1)
    from butterfly_tpu_torch.core.config import MeshConfig, tiny
    from butterfly_tpu_torch.core.mesh import (GlobalDevice, global_devices,
                                               init_distributed,
                                               make_hybrid_mesh, make_mesh)
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.models import common as TC
    from butterfly_tpu_torch.models.bridge import params_from_numpy

    init_distributed(coordinator=f"127.0.0.1:{port}", num_processes=n,
                     process_id=pid, timeout_s=60)
    devs = global_devices("cpu")
    out = {}
    for axis, arch, kw in (("stage", "llama", {}),
                           ("expert", "mixtral", dict(moe_impl="ep"))):
        cfg = tiny(arch, dtype="float32", param_dtype="float32", **kw)
        params = params_from_numpy(unflatten(dict(np.load(
            os.path.join(wdir, f"{arch}.npz")))), device="cpu")
        mesh = make_hybrid_mesh(MeshConfig(**{axis: n}), devs)
        out[axis] = axes_runs(mesh, axis, params, cfg,
                              TC.Model(cfg, device="cpu"))
        out[f"{axis}_draft"] = draft_refusal(TC.Model(cfg, device="cpu"),
                                             params, mesh)
        # a run of two shards a process: 4 shards over the two
        four = [GlobalDevice(i, torch.device("cpu"), i * n // 4, 0)
                for i in range(4)]
        out[f"{axis}4"] = four_shard_runs(
            make_mesh(MeshConfig(**{axis: 4}), four), axis)
    # a data axis across the processes is refused; seq across them and
    # data inside them beside the stage axis run
    cfg = tiny("llama", dtype="float32", param_dtype="float32")
    params = params_from_numpy(unflatten(dict(np.load(
        os.path.join(wdir, "llama.npz")))), device="cpu")
    model = TC.Model(cfg, device="cpu")
    dmesh = make_hybrid_mesh(MeshConfig(data=n), devs)
    out["refusals"] = {"data": _error(lambda: InferenceEngine(
        model, params, mesh=dmesh))}
    sp = SamplingParams(max_new_tokens=GEN_NEW)
    out["seq_long"] = InferenceEngine(
        model, params, mesh=make_hybrid_mesh(MeshConfig(seq=n), devs)
    ).generate_long(LONG_PROMPT, sp).tokens.tolist()
    out["data2_stage_generate"] = InferenceEngine(
        model, params, mesh=make_hybrid_mesh(
            MeshConfig(data=2, stage=n), inside_devices(n),
            dcn_axes=("stage",))).generate(GEN_PROMPTS, sp).tokens.tolist()
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    with open(os.path.join(outdir, f"port_axes{pid}.json"), "w") as f:
        json.dump(out, f)


def _jax_serve(model, params, rt, mesh, prompts, new=SERVE_NEW):
    from butterfly_tpu.engine.serving import ServingEngine
    from butterfly_tpu.sched.scheduler import Scheduler
    sched = Scheduler(ServingEngine(model, params, rt, mesh=mesh))
    reqs = [sched.submit(p, max_new_tokens=new) for p in prompts]
    sched.run_until_done()
    return [r.output for r in reqs], sched


def _jax_draft(model, params, mesh, tree=False):
    """The JAX package's Scheduler with the draft model (DRAFT_RT; a
    token tree with `tree`) on GEN_PROMPTS, GEN_NEW new tokens each: its
    tokens, or (type, message) of its failure."""
    from butterfly_tpu.core.config import RuntimeConfig
    rt = RuntimeConfig(**DRAFT_RT, **(DRAFT_TREE if tree else {}))
    got = []
    err = _error(lambda: got.append(_jax_serve(
        model, params, rt, mesh, GEN_PROMPTS, new=GEN_NEW)[0]))
    return err or got[0]


def _jax_exit(jax):
    """Leave the coordination service together (the first process hosts
    it: leaving alone, it takes the others down), then exit: a JAX
    process that failed a read-back or a spec block does not exit on its
    own."""
    jax.distributed.shutdown()
    os._exit(0)


def run_jax_seq(pid, n, port, outdir, part="main"):
    """The JAX package with seq = n across the processes (one device a
    process: generate_long ring and Ulysses, the Scheduler's long-prompt
    lane), then data = 2 inside each process beside each of tensor,
    stage, expert and seq across them (two CPU devices a process, the
    mesh over jax.devices() in the order [d0, d2, d1, d3]). With part
    "draft" a job of its own runs only the Scheduler with the draft
    model on the seq mesh, beside the main job (`jax_seq_draft<pid>.json`),
    so that neither outlasts its time bound."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from butterfly_tpu.core.config import MeshConfig, RuntimeConfig, tiny
    from butterfly_tpu.core.mesh import (init_distributed, make_hybrid_mesh,
                                         make_mesh)
    from butterfly_tpu.engine.engine import InferenceEngine
    from butterfly_tpu.engine.sampling import SamplingParams
    from butterfly_tpu.models.common import Model
    from butterfly_tpu.parallel.partition import shard_params

    init_distributed(coordinator=f"127.0.0.1:{port}", num_processes=n,
                     process_id=pid)
    devs = jax.devices()
    out = {}
    gsp = SamplingParams(max_new_tokens=GEN_NEW)
    trees = {}
    for arch, kw in (("llama", {}), ("mixtral", dict(moe_impl="ep"))):
        cfg = tiny(arch, dtype="float32", param_dtype="float32", **kw)
        model = Model(cfg)
        trees[arch] = (cfg, model, model.init(jax.random.PRNGKey(0)))
    cfg, model, params = trees["llama"]
    # seq across: one device of each process
    smesh = make_hybrid_mesh(MeshConfig(seq=n), devs[::len(devs) // n])
    if part == "draft":
        # the draft model with the seq axis across (its token tree and the
        # meshes with tensor or data inside give the same tokens: ROADMAP.md
        # Queue 1 item 2 records those runs)
        out["seq_draft"] = _jax_draft(model, shard_params(params, cfg, smesh),
                                      smesh)
        with open(os.path.join(outdir, f"jax_seq_draft{pid}.json"), "w") as f:
            json.dump(out, f)
        _jax_exit(jax)
    eng = InferenceEngine(model, shard_params(params, cfg, smesh),
                          mesh=smesh)
    for impl in ("ring", "ulysses"):
        out[f"seq_long_{impl}"] = eng.generate_long(
            LONG_PROMPT, gsp, impl=impl).tokens.tolist()
    out["seq_serve"], sched = _jax_serve(
        model, shard_params(params, cfg, smesh), RuntimeConfig(
            seq_parallel_threshold=SEQ_THRESHOLD, **SERVE_RT), smesh,
        [LONG_PROMPT, GEN_PROMPTS[0]])
    out["seq_lane_tokens"] = int(
        sched.metrics()["seq_parallel_prefill_tokens_total"])
    # data = 2 inside the processes: each group one device of each
    order = [d for i in range(len(devs) // n) for d in devs[i::len(devs) // n]]
    for axis, arch, _ in INSIDE:
        cfg, model, params = trees[arch]
        mesh = make_mesh(MeshConfig(data=2, **{axis: n}), order)
        sp = shard_params(params, cfg, mesh)
        key = f"data2_{axis}"
        out[f"{key}_generate"] = InferenceEngine(
            model, sp, mesh=mesh).generate(GEN_PROMPTS, gsp).tokens.tolist()
        if axis == "seq":
            out[f"{key}_serve"], _ = _jax_serve(model, sp, RuntimeConfig(
                seq_parallel_threshold=SEQ_THRESHOLD, **SERVE_RT), mesh,
                [LONG_PROMPT, GEN_PROMPTS[0]])
        else:
            out[f"{key}_serve"], _ = _jax_serve(
                model, sp, RuntimeConfig(**SERVE_RT), mesh, GEN_PROMPTS)
    with open(os.path.join(outdir, f"jax_seq{pid}.json"), "w") as f:
        json.dump(out, f)
    _jax_exit(jax)


def seq_runs(mesh, params, cfg, model):
    """The port's runs on a seq = 2 `mesh`: generate_long (ring and
    Ulysses; float and int8 KV; temperature 1.0), the Scheduler's
    long-prompt lane, the forward's and one decode step's logits, and
    which shards this process holds. Run in one process (the test's
    yardstick) and in each worker. {name: lists}."""
    import torch
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.core.mesh import axis_group, mesh_ctx
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.models import common as TC
    from butterfly_tpu_torch.parallel.sequence import (
        gather_local, replicate_params, sp_decode_step, sp_forward)
    out = {}
    sp = SamplingParams(max_new_tokens=GEN_NEW)
    t1 = SamplingParams(max_new_tokens=GEN_NEW, temperature=1.0)
    for kvq in ("none", "int8"):
        eng = InferenceEngine(model, params, RuntimeConfig(kv_quant=kvq),
                              mesh=mesh)
        for impl in ("ring", "ulysses"):
            out[f"long_{impl}_{kvq}"] = eng.generate_long(
                LONG_PROMPT, sp, impl=impl).tokens.tolist()
        out[f"long_t1_{kvq}"] = eng.generate_long(
            LONG_PROMPT, t1, seed=5).tokens.tolist()
    rt = RuntimeConfig(seq_parallel_threshold=SEQ_THRESHOLD, **SERVE_RT)
    out["serve"], out["lane_tokens"] = lane_serve(model, params, rt, mesh)
    out["serve_int8"], _ = lane_serve(model, params, RuntimeConfig(
        kv_quant="int8", seq_parallel_threshold=SEQ_THRESHOLD, **SERVE_RT),
        mesh)
    out["draft"] = draft_serve(model, params, mesh)
    out["draft_tree"] = draft_serve(model, params, mesh, tree=True)
    # the forward's logits (every shard's, gathered) and one decode step
    reps = replicate_params(params, mesh)
    out["trees"] = [t is None for t in reps.trees[0]]
    toks = torch.as_tensor([LONG_PROMPT + [0]], dtype=torch.int32)
    with mesh_ctx(mesh):
        logits, prefix = sp_forward(reps, cfg, toks, mesh)
        out["prefix_remote"] = [k is None for k in prefix.k]
        out["prefill"] = torch.cat(gather_local(
            logits, axis_group("seq")), dim=1).tolist()
        suffix = TC.init_cache(cfg, 1, 4, device="cpu", mesh=mesh)
        plen = torch.full((1,), len(LONG_PROMPT), dtype=torch.int32)
        step, _ = sp_decode_step(reps, cfg, toks[:, :1], plen[:, None],
                                 prefix, suffix, mesh, prefix_len=plen)
    out["step"] = step.tolist()
    return out


def lane_serve(model, params, rt, mesh):
    """(tokens, seq_parallel_prefill_tokens_total) of the long prompt and
    GEN_PROMPTS[0] through a Scheduler over a ServingEngine."""
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    sched = Scheduler(ServingEngine(model, params, rt, mesh=mesh))
    reqs = [sched.submit(p, max_new_tokens=SERVE_NEW)
            for p in (LONG_PROMPT, GEN_PROMPTS[0])]
    sched.run_until_done()
    return ([r.output for r in reqs],
            int(sched.metrics().get("seq_parallel_prefill_tokens_total", 0)))


def inside_runs(mesh, axis, params, cfg, model):
    """Greedy generate and serving on a mesh of data = 2 beside `axis`
    (under seq also generate_long, and serving through the lane)."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    eng = InferenceEngine(model, params, mesh=mesh)
    sp = SamplingParams(max_new_tokens=GEN_NEW)
    out = {"generate": eng.generate(GEN_PROMPTS, sp).tokens.tolist()}
    if axis == "seq":
        out["long"] = eng.generate_long(LONG_PROMPT, sp).tokens.tolist()
        out["serve"], out["lane_tokens"] = lane_serve(
            model, params, RuntimeConfig(
                seq_parallel_threshold=SEQ_THRESHOLD, **SERVE_RT), mesh)
        out["draft"] = draft_serve(model, params, mesh)["tokens"]
    else:
        out["serve"] = serve(model, params, RuntimeConfig(**SERVE_RT), mesh)
    return out


def inside_devices(n):
    """Two CPU devices a process, each process its own slice, so that
    make_hybrid_mesh lays its dcn axis across the processes."""
    import torch
    from butterfly_tpu_torch.core.mesh import GlobalDevice
    return [GlobalDevice(i, torch.device("cpu"), i // 2, i // 2)
            for i in range(2 * n)]


def run_port_seq(pid, n, port, outdir, wdir):
    import torch
    torch.set_num_threads(1)
    from butterfly_tpu_torch.core.config import MeshConfig, tiny
    from butterfly_tpu_torch.core.mesh import (global_devices,
                                               init_distributed,
                                               make_hybrid_mesh)
    from butterfly_tpu_torch.models import common as TC
    from butterfly_tpu_torch.models.bridge import params_from_numpy

    init_distributed(coordinator=f"127.0.0.1:{port}", num_processes=n,
                     process_id=pid, timeout_s=60)
    trees = {}
    for arch, kw in (("llama", {}), ("mixtral", dict(moe_impl="ep"))):
        cfg = tiny(arch, dtype="float32", param_dtype="float32", **kw)
        trees[arch] = (cfg, TC.Model(cfg, device="cpu"), params_from_numpy(
            unflatten(dict(np.load(os.path.join(wdir, f"{arch}.npz")))),
            device="cpu"))
    cfg, model, params = trees["llama"]
    out = {"seq": seq_runs(make_hybrid_mesh(
        MeshConfig(seq=n), global_devices("cpu")), params, cfg, model)}
    for axis, arch, _ in INSIDE:
        cfg, model, params = trees[arch]
        mesh = make_hybrid_mesh(MeshConfig(data=2, **{axis: n}),
                                inside_devices(n), dcn_axes=(axis,))
        out[f"data2_{axis}"] = inside_runs(mesh, axis, params, cfg, model)
        out[f"data2_{axis}"]["processes"] = mesh.processes.reshape(
            -1).tolist()
    # the draft model with seq across beside tensor = 2 inside
    cfg, model, params = trees["llama"]
    mesh = make_hybrid_mesh(MeshConfig(seq=n, tensor=2), inside_devices(n),
                            dcn_axes=("seq",))
    out["seq_tensor2_draft"] = {
        "tokens": draft_serve(model, params, mesh)["tokens"],
        "processes": mesh.processes.reshape(-1).tolist()}
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    with open(os.path.join(outdir, f"port_seq{pid}.json"), "w") as f:
        json.dump(out, f)


# two mesh axes at once: (outer, inner) in MESH_AXES order and the tiny
# tree each pair serves (Mixtral where the pair holds expert)
PAIRS = (("stage", "tensor", "llama"), ("stage", "expert", "mixtral"),
         ("stage", "seq", "llama"), ("expert", "tensor", "mixtral"),
         ("expert", "seq", "mixtral"), ("seq", "tensor", "llama"))
# the layouts: A the outer axis across two processes and the inner inside
# them (two devices a process), B the inner across and the outer inside,
# C both across four processes (one device each)
LAYOUTS = {"A": lambda o, i: (o,), "B": lambda o, i: (i,),
           "C": lambda o, i: (o, i)}
# data = 2 inside two processes (four devices each) beside an axis
# across them and another inside: (across, inside, tree)
DATA_INSIDE = (("expert", "tensor", "mixtral"), ("seq", "tensor", "llama"),
               ("stage", "expert", "mixtral"))


def two_cases(layouts):
    """[(key, axes, dcn axes, tree)] of the meshes of `layouts` (a
    string of A, B, C and D: D the data-inside meshes), in the order
    every worker runs them."""
    out = []
    for lay in layouts:
        if lay == "D":
            out += [(f"data2_{a}_{i}", {"data": 2, a: 2, i: 2}, (a,), arch)
                    for a, i, arch in DATA_INSIDE]
            continue
        out += [(f"{o}_{i}_{lay}", {o: 2, i: 2}, LAYOUTS[lay](o, i), arch)
                for o, i, arch in PAIRS]
    return out


def _jax_two_order(devs, axes, dcn):
    """jax.devices() (process-major) arranged in mesh order so that the
    axes `dcn` index the processes and the others a process's own
    devices (make_hybrid_mesh's arrangement, processes as slices)."""
    from butterfly_tpu.core.config import MESH_AXES, MeshConfig
    shape = dict(zip(MESH_AXES, MeshConfig(**axes).axis_sizes))
    procs = [shape[a] if a in dcn else 1 for a in MESH_AXES]
    local = [1 if a in dcn else shape[a] for a in MESH_AXES]
    per = int(np.prod(local))
    order = []
    for idx in np.ndindex(*[shape[a] for a in MESH_AXES]):
        p = np.ravel_multi_index([i // l for i, l in zip(idx, local)], procs)
        j = np.ravel_multi_index([i % l for i, l in zip(idx, local)], local)
        order.append(devs[p * per + j])
    return order


def run_jax_two(pid, n, port, outdir, layouts):
    """The JAX package on the meshes of `layouts` (two_cases): greedy
    generate and the Scheduler's tokens, under seq also generate_long
    (ring) and the Scheduler with the long-prompt lane; an error is
    recorded as (type, message). Ends with os._exit after the
    coordination service's shutdown: a JAX process that failed a
    read-back does not exit on its own."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from butterfly_tpu.core.config import MeshConfig, RuntimeConfig, tiny
    from butterfly_tpu.core.mesh import init_distributed, make_mesh
    from butterfly_tpu.engine.engine import InferenceEngine
    from butterfly_tpu.engine.sampling import SamplingParams
    from butterfly_tpu.models.common import Model
    from butterfly_tpu.parallel.partition import shard_params

    init_distributed(coordinator=f"127.0.0.1:{port}", num_processes=n,
                     process_id=pid)
    devs = jax.devices()
    trees = {}
    for arch, kw in (("llama", {}), ("mixtral", dict(moe_impl="ep"))):
        cfg = tiny(arch, dtype="float32", param_dtype="float32", **kw)
        model = Model(cfg)
        trees[arch] = (cfg, model, model.init(jax.random.PRNGKey(0)))
    gsp = SamplingParams(max_new_tokens=GEN_NEW)
    out = {}
    # the meshes the JAX package fails on run last
    cases = sorted(two_cases(layouts), key=lambda c: "stage" in c[2]
                   and c[1].get("tensor", 1) > 1)
    for key, axes, dcn, arch in cases:
        cfg, model, params = trees[arch]
        mesh = make_mesh(MeshConfig(**axes), _jax_two_order(devs, axes, dcn))
        sp = shard_params(params, cfg, mesh)
        eng = InferenceEngine(model, sp, mesh=mesh)
        run = {}
        t = [time.monotonic()]

        def tick():
            t.append(time.monotonic())
            return round(t[-1] - t[-2], 2)
        try:
            run["generate"] = eng.generate(GEN_PROMPTS,
                                           gsp).tokens.tolist()
            run["s_generate"] = tick()
            if "seq" not in axes:
                run["serve"], _ = _jax_serve(model, sp, RuntimeConfig(
                    **SERVE_RT), mesh, GEN_PROMPTS)
                run["s_serve"] = tick()
        except Exception as e:   # noqa: BLE001 - recorded for the test
            run["error"] = [type(e).__name__, str(e)]
        if "seq" in axes and "error" not in run:
            try:
                run["long"] = eng.generate_long(LONG_PROMPT,
                                                gsp).tokens.tolist()
            except NotImplementedError as e:
                run["long"] = ["NotImplementedError", str(e)]
            run["s_long"] = tick()
            # the Scheduler under seq: its long-prompt lane
            run["lane"], sched = _jax_serve(model, sp, RuntimeConfig(
                seq_parallel_threshold=SEQ_THRESHOLD, **SERVE_RT), mesh,
                [LONG_PROMPT, GEN_PROMPTS[0]])
            run["lane_tokens"] = int(sched.metrics().get(
                "seq_parallel_prefill_tokens_total", 0))
            run["s_lane"] = tick()
        out[key] = run
    with open(os.path.join(outdir, f"jax_two_{layouts}{pid}.json"),
              "w") as f:
        json.dump(out, f)
    print(f"jax_two{pid} done", flush=True)
    _jax_exit(jax)


def _held_leaves(tree, path=""):
    """{leaf path: bytes this process holds} of a placed tree (a split
    leaf's parts, nested ones too)."""
    out = {}
    for k, v in tree.items():
        key = f"{path}/{k}" if path else k
        if isinstance(v, dict):
            out.update(_held_leaves(v, key))
        elif v is not None:
            out[key] = _nbytes(v)
    return out


def _nbytes(x):
    from butterfly_tpu_torch.parallel.partition import Shards
    if isinstance(x, Shards):
        return sum(_nbytes(p) for p in x.parts)
    return x.nbytes


def two_logits(mesh, axes, params, cfg):
    """The port's logits on `mesh`: an 8-token prefill and a decode step
    (the pipeline's under stage); under seq (without stage) also the
    seq-parallel prefill of the long prompt and a decode step over its
    sharded cache. {name: lists}. Run in one process (the yardstick)
    and in each worker."""
    import torch
    from butterfly_tpu_torch.core.mesh import axis_group, mesh_ctx
    from butterfly_tpu_torch.models import common as TC
    from butterfly_tpu_torch.parallel.partition import shard_params
    from butterfly_tpu_torch.parallel.pipeline import pipeline_forward
    from butterfly_tpu_torch.parallel.sequence import (
        gather_local, replicate_params, sp_decode_step, sp_forward)
    out = {}
    placed = shard_params(params, cfg, mesh)
    toks = torch.as_tensor(AXES_LOGIT_TOKENS)
    fwd = TC.forward if "stage" not in axes else (
        lambda p, c, t, kv: pipeline_forward(p, c, t, kv, mesh))
    with mesh_ctx(mesh):
        cache = TC.init_cache(cfg, toks.shape[0], 32, device="cpu",
                              mesh=mesh)
        prefill, cache = fwd(placed, cfg, toks, cache)
        step, cache = fwd(placed, cfg, toks[:, :1], cache)
        out["prefill"], out["step"] = prefill.tolist(), step.tolist()
        if "seq" in axes and "stage" not in axes:
            reps = replicate_params(placed, mesh)
            ltoks = torch.as_tensor([LONG_PROMPT + [0]], dtype=torch.int32)
            logits, prefix = sp_forward(reps, cfg, ltoks, mesh)
            out["long_prefill"] = torch.cat(gather_local(
                logits, axis_group("seq")), dim=1).tolist()
            suffix = TC.init_cache(cfg, 1, 4, device="cpu", mesh=mesh)
            plen = torch.full((1,), len(LONG_PROMPT), dtype=torch.int32)
            lstep, _ = sp_decode_step(reps, cfg, ltoks[:, :1], plen[:, None],
                                      prefix, suffix, mesh, prefix_len=plen)
            out["long_step"] = lstep.tolist()
    return out


def two_runs(mesh, axes, params, cfg, model):
    """The port's runs on `mesh`: what each process holds, the logits
    (two_logits), greedy generate (fused and stepped), temperature 1.0
    and the Scheduler's tokens; under seq also generate_long (ring) and
    the Scheduler with the long-prompt lane; whether a ServingEngine with
    the draft model builds ("draft": None, or its refusal). A refusal of
    the mesh is recorded as {"error": (type, message)}."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.parallel.partition import shard_params
    try:
        placed = shard_params(params, cfg, mesh)
    except Exception as e:   # noqa: BLE001 - recorded for the test
        return {"error": [type(e).__name__, str(e)]}
    out = {"held": _held_leaves(placed),
           "draft": draft_refusal(model, placed, mesh)}
    out.update(two_logits(mesh, axes, params, cfg))
    eng = InferenceEngine(model, placed, mesh=mesh)
    sp = SamplingParams(max_new_tokens=GEN_NEW)
    out["generate"] = eng.generate(GEN_PROMPTS, sp).tokens.tolist()
    out["generate_stepped"] = eng.generate(GEN_PROMPTS, sp,
                                           fused=False).tokens.tolist()
    out["generate_t1"] = eng.generate(
        GEN_PROMPTS, SamplingParams(max_new_tokens=GEN_NEW, temperature=1.0),
        seed=5).tokens.tolist()
    if "seq" not in axes:
        out["serve"] = serve(model, placed, RuntimeConfig(**SERVE_RT), mesh)
    else:
        try:
            out["long"] = eng.generate_long(LONG_PROMPT,
                                            sp).tokens.tolist()
        except NotImplementedError as e:    # stage x seq, as in JAX
            out["long"] = [type(e).__name__, str(e)]
        out["lane"], out["lane_tokens"] = lane_serve(
            model, placed, RuntimeConfig(
                seq_parallel_threshold=SEQ_THRESHOLD, **SERVE_RT), mesh)
    return out


def two_devices(n, layouts):
    """The GlobalDevices of a layout's job: each process its own slice,
    one CPU device a process for C, two for A and B, four for D."""
    import torch
    from butterfly_tpu_torch.core.mesh import GlobalDevice
    per = {"C": 1, "A": 2, "B": 2, "D": 4}[layouts[0]]
    return [GlobalDevice(i, torch.device("cpu"), i // per, i // per)
            for i in range(per * n)]


def run_port_two(pid, n, port, outdir, wdir, layouts):
    """The port on the meshes of `layouts` (two_cases), the same weights
    as the JAX workers (`<wdir>/llama.npz`, `mixtral.npz`): two_runs
    of each, plus the mesh's process layout."""
    import torch
    torch.set_num_threads(1)
    from butterfly_tpu_torch.core.config import MeshConfig, tiny
    from butterfly_tpu_torch.core.mesh import init_distributed, make_hybrid_mesh
    from butterfly_tpu_torch.models import common as TC
    from butterfly_tpu_torch.models.bridge import params_from_numpy

    init_distributed(coordinator=f"127.0.0.1:{port}", num_processes=n,
                     process_id=pid, timeout_s=60)
    trees = {}
    for arch, kw in (("llama", {}), ("mixtral", dict(moe_impl="ep"))):
        cfg = tiny(arch, dtype="float32", param_dtype="float32", **kw)
        trees[arch] = (cfg, TC.Model(cfg, device="cpu"), params_from_numpy(
            unflatten(dict(np.load(os.path.join(wdir, f"{arch}.npz")))),
            device="cpu"))
    out = {}
    for lay in layouts:
        devs = two_devices(n, lay)
        for key, axes, dcn, arch in two_cases(lay):
            cfg, model, params = trees[arch]
            mesh = make_hybrid_mesh(MeshConfig(**axes), devs, dcn_axes=dcn)
            out[key] = two_runs(mesh, axes, params, cfg, model)
            out[key]["processes"] = mesh.processes.reshape(-1).tolist()
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    with open(os.path.join(outdir, f"port_two_{layouts}{pid}.json"),
              "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    mode, pid, n, port, outdir = (sys.argv[1], int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4], sys.argv[5])
    if mode == "jax":
        run_jax(pid, n, port, outdir)
    elif mode == "port":
        run_port(pid, n, port, outdir, sys.argv[6])
    elif mode == "jax_axes":
        run_jax_axes(pid, n, port, outdir)
    elif mode == "jax_seq":
        run_jax_seq(pid, n, port, outdir, *sys.argv[6:7])
    elif mode == "port_seq":
        run_port_seq(pid, n, port, outdir, sys.argv[6])
    elif mode == "jax_two":
        run_jax_two(pid, n, port, outdir, sys.argv[6])
    elif mode == "port_two":
        run_port_two(pid, n, port, outdir, sys.argv[6], sys.argv[7])
    else:
        run_port_axes(pid, n, port, outdir, sys.argv[6])
    print(f"{mode}{pid} done", flush=True)
