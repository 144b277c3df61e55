"""Worker for tests/test_torch_distributed.py and
tests/test_torch_distributed_axes.py (run as a subprocess): one process
of a two-process job, on the CPU, one device a process.

    python torch_distributed_worker.py jax  <pid> <n> <port> <outdir>
    python torch_distributed_worker.py port <pid> <n> <port> <outdir> <weights.npz>
    python torch_distributed_worker.py jax_axes  <pid> <n> <port> <outdir>
    python torch_distributed_worker.py port_axes <pid> <n> <port> <outdir> <weights_dir>
    python torch_distributed_worker.py jax_seq   <pid> <n> <port> <outdir>
    python torch_distributed_worker.py port_seq  <pid> <n> <port> <outdir> <weights_dir>

`jax` runs the JAX package's multi-host path (init_distributed,
make_hybrid_mesh over jax.devices(), shard_params) on the tiny float32
Llama from PRNGKey(0): greedy generate and a Scheduler over a
ServingEngine with the tensor axis across the two processes, then a data
axis across them, which the JAX package fails at its first read-back.
`port` runs the same on butterfly_tpu_torch (gloo), with the same weights
from `weights.npz` (models/bridge.py:params_from_numpy), plus the worker
sum, all_hosts_probe, the forward's logits, the data axis's refusal and
generate_long with the seq axis across the processes. Each writes
`<outdir>/<mode><pid>.json` (and the port `<outdir>/port<pid>.npz`).

`jax_axes` and `port_axes` run the same with the stage axis across the
two processes (the tiny float32 Llama, one layer a stage) and then the
expert axis (the tiny float32 Mixtral, moe_impl="ep"), both trees from
PRNGKey(0) (the port's from `<weights_dir>/llama.npz`, `mixtral.npz`):
greedy generate (fused; and an expert run whose padded prompt length is
even, so its prefill takes the a2a path) and the Scheduler's tokens.
The port adds the stepped loop, temperature 1.0, the int8 KV pool, the
alternating path, n-gram speculation (generate and serving), the
interleaved schedule (a 4-layer Llama from torch seed 0, V = 2), the
int8 tree, the forward's logits, what each process holds, and each axis
at 4 shards, a run of two a process; then the data axis's refusal,
generate_long with seq across and generate with data = 2 inside beside
stage across.

`jax_seq` and `port_seq` run the seq axis across the two processes (the
tiny float32 Llama: generate_long, ring and Ulysses, on a 37-token
prompt; a Scheduler whose long-prompt lane takes it), then data = 2
inside each process beside each of tensor, stage, expert (the tiny
Mixtral) and seq across them (two CPU devices a process). The port adds
the int8 KV, temperature 1.0, the forward's and a decode step's logits
and which seq shards each process holds.
"""
import json
import os
import sys

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

    dmesh = make_hybrid_mesh(MeshConfig(data=n), jax.devices())
    deng = InferenceEngine(model, shard_params(params, cfg, dmesh),
                           mesh=dmesh)
    out["data_error"] = _error(lambda: deng.generate(
        GEN_PROMPTS, SamplingParams(max_new_tokens=GEN_NEW)))
    with open(os.path.join(outdir, f"jax{pid}.json"), "w") as f:
        json.dump(out, f)


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
    with open(os.path.join(outdir, f"jax_axes{pid}.json"), "w") as f:
        json.dump(out, f)


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


def _jax_serve(model, params, rt, mesh, prompts):
    from butterfly_tpu.engine.serving import ServingEngine
    from butterfly_tpu.sched.scheduler import Scheduler
    sched = Scheduler(ServingEngine(model, params, rt, mesh=mesh))
    reqs = [sched.submit(p, max_new_tokens=SERVE_NEW) for p in prompts]
    sched.run_until_done()
    return [r.output for r in reqs], sched


def run_jax_seq(pid, n, port, outdir):
    """The JAX package with seq = n across the processes (one device a
    process: generate_long ring and Ulysses, the Scheduler's long-prompt
    lane), then data = 2 inside each process beside each of tensor,
    stage, expert and seq across them (two CPU devices a process, the
    mesh over jax.devices() in the order [d0, d2, d1, d3])."""
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


def seq_runs(mesh, params, cfg, model):
    """The port's runs on a seq = 2 `mesh`: generate_long (ring and
    Ulysses; float and int8 KV; temperature 1.0), the Scheduler's
    long-prompt lane, the forward's and one decode step's logits, and
    which shards this process holds. Run in one process (the test's
    yardstick) and in each worker. {name: lists}."""
    import torch
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.core.mesh import mesh_ctx
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
    # the forward's logits (every shard's, gathered) and one decode step
    reps = replicate_params(params, mesh)
    out["trees"] = [t is None for t in reps.trees[0]]
    toks = torch.as_tensor([LONG_PROMPT + [0]], dtype=torch.int32)
    with mesh_ctx(mesh):
        logits, prefix = sp_forward(reps, cfg, toks, mesh)
        out["prefix_remote"] = [k is None for k in prefix.k]
        out["prefill"] = torch.cat(gather_local(logits), dim=1).tolist()
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
            int(sched.metrics()["seq_parallel_prefill_tokens_total"]))


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
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    with open(os.path.join(outdir, f"port_seq{pid}.json"), "w") as f:
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
        run_jax_seq(pid, n, port, outdir)
    elif mode == "port_seq":
        run_port_seq(pid, n, port, outdir, sys.argv[6])
    else:
        run_port_axes(pid, n, port, outdir, sys.argv[6])
    print(f"{mode}{pid} done", flush=True)
