"""Trace one program of a decode path with torch.profiler and print its
top device kernels: the port of tools/profile_decode.py.

    python -m butterfly_tpu_torch.tools.profile_decode [--max-new N]
        [--out DIR]
    ... --serving [--steps-per-tick K]
    ... --prefill [--prefill-max-batch B]
    ... --pipeline [--steps-per-tick K]
    ... --spec [--gamma G]
    ... --spec --draft-source model --tree-width 2 [--tree-nodes N]
    ... --long-context

Each mode warms its path outside the trace window, then traces exactly
the program the JAX script traces:

* default: only the offline engine's fused decode loop; prefill and the
  first sample run before the window opens;
* `--serving`: one block of a warmed Scheduler (the block a tick
  dispatches: `mixed_block_async` under mixed dispatch);
* `--pipeline`: two such blocks, the second dispatched on the first's
  device carry before the first is drained (dispatch-ahead);
* `--spec`: one speculative block (`mixed_spec_block_async`, or
  `spec_block_async` where the draft source takes the alternating path);
* `--prefill`: one gang admission (`prefill_batch`);
* `--long-context`: one `sp_prefill_chunk` plus one decode block, on a
  seq = 4 mesh (one seq shard per card with 4 cards or a multiple of 4,
  else all four on cuda:0; CPU shards with `--device cpu`).

The capture records CPU and CUDA activity and is written as a Chrome
trace under `--out` (default: a new temp dir). The report is read from
the raw kineto events (obs/profile.py): the top `--top` device kernels
by self time, beside the window's host wall, device busy time and idle
share; on the CPU, where no kernel runs, the top host ops instead.

The device is the card unless `--device cpu` is given. On the card the
model is the `1b` proxy (default) or the `8b` preset (Llama-3-8B,
max_seq_len 2048) with int8 weights and an int8 KV pool; on the CPU the
tiny f32 config with int8 weights and a float pool (batch 4, prompt 32,
16 new), as the JAX script's CPU branch. The mode functions take
(model, params, kv_quant, opts) so a caller can pass its own tree.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

#: the JAX script's round-4 proxy on the card (Llama-style, ~1.2B)
PROXY_1B = dict(arch="llama", vocab_size=32000, hidden_size=2048,
                num_layers=16, num_heads=16, num_kv_heads=8, head_dim=128,
                intermediate_size=5632, max_seq_len=2048)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m butterfly_tpu_torch.tools.profile_decode",
        description="trace one decode-path program with torch.profiler")
    ap.add_argument("--max-new", type=int, default=128)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--preset", default="1b", choices=("1b", "8b"),
                    help="'1b' (the proxy) or '8b' (Llama-3-8B)")
    ap.add_argument("--out", default=None, help="trace dir (default: tmp)")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--serving", action="store_true",
                    help="trace one serving block of a warmed Scheduler")
    ap.add_argument("--steps-per-tick", type=int, default=16,
                    help="block width (RuntimeConfig.decode_steps_per_tick)")
    ap.add_argument("--prefill", action="store_true",
                    help="trace one gang admission (engine.prefill_batch)")
    ap.add_argument("--prefill-max-batch", type=int, default=8,
                    help="gang width for --prefill (clamped to --batch)")
    ap.add_argument("--pipeline", action="store_true",
                    help="trace two chained in-flight serving blocks")
    ap.add_argument("--spec", action="store_true",
                    help="trace one speculative block")
    ap.add_argument("--gamma", type=int, default=4,
                    help="draft width for --spec")
    ap.add_argument("--draft-source", default="ngram",
                    help="draft source for --spec: ngram or model")
    ap.add_argument("--tree-width", type=int, default=0,
                    help="token-tree width for --spec (needs "
                         "--draft-source model; 0 = linear)")
    ap.add_argument("--tree-nodes", type=int, default=0,
                    help="tree node budget for --tree-width (0 = auto)")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="draft model depth (0 = num_layers/4, floor 1)")
    ap.add_argument("--long-context", action="store_true",
                    help="trace one seq-parallel prefill chunk plus one "
                         "decode block on a seq = 4 mesh")
    return ap


def options(**kw) -> argparse.Namespace:
    """The parser's defaults with `kw` (flag names with underscores)
    replaced: the options a mode function takes from a caller."""
    opts = build_parser().parse_args([])
    for k, v in kw.items():
        if not hasattr(opts, k):
            raise TypeError(f"no option {k!r}")
        setattr(opts, k, v)
    return opts


def build_model(opts):
    """(model, params, kv_quant) as the JAX script builds them, on
    `opts.device`; the CPU branch also sets its batch shape on `opts`."""
    from butterfly_tpu_torch.core.config import ModelConfig, llama3_8b, tiny
    from butterfly_tpu_torch.models.common import Model, init_params
    from butterfly_tpu_torch.quant.int8 import (init_params_quantized,
                                                quantize_int8)
    if opts.device == "cpu":
        if opts.preset != "1b":
            print(f"warning: --device cpu profiles the tiny config, NOT "
                  f"--preset {opts.preset}", file=sys.stderr)
        cfg = tiny("llama", dtype="float32", param_dtype="float32")
        opts.batch, opts.prompt_len, opts.max_new = 4, 32, 16
        model = Model(cfg, device="cpu")
        gen = torch.Generator(device="cpu")
        gen.manual_seed(0)
        return (model, quantize_int8(init_params(cfg, gen, "cpu"), cfg),
                "none")
    cfg = llama3_8b().replace(max_seq_len=2048) if opts.preset == "8b" \
        else ModelConfig(**PROXY_1B)
    model = Model(cfg, device=opts.device)
    gen = torch.Generator(device=opts.device)
    gen.manual_seed(0)
    return model, init_params_quantized(cfg, gen, opts.device), "int8"


# -- the trace window ---------------------------------------------------------

class Window:
    """A finished capture: its profiler and its host wall in ms."""

    def __init__(self):
        self.prof = None
        self.wall_ms = 0.0


@contextlib.contextmanager
def capture(device):
    """The trace window: torch.profiler (CPU, and CUDA on the card) around
    the enclosed dispatches, closed after the device has finished them
    (the JAX script's block_until_ready inside the window)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    if cuda:
        torch.cuda.synchronize(device)
    w = Window()
    prof = profile(activities=acts)
    prof.start()
    t0 = time.perf_counter()
    try:
        yield w
        if cuda:
            torch.cuda.synchronize(device)
        w.wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        prof.stop()
        w.prof = prof


def report(w: Window, mode: str, opts) -> Dict:
    """The window's figures: the Chrome trace written under `opts.out`,
    host wall, device busy and idle share, and the top `opts.top` device
    kernels by self time (host ops by inclusive time where the window
    ran no kernel). The profiler is dropped here."""
    from butterfly_tpu_torch.obs.profile import device_kernels, host_ops
    out = opts.out or tempfile.mkdtemp(prefix=f"{mode}_trace_")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"{mode}_trace_{os.getpid()}_"
                             f"{time.monotonic_ns()}.json")
    w.prof.export_chrome_trace(path)
    kernels = device_kernels(w.prof)
    busy = sum(k.self_device_time_total for k in kernels) / 1e3
    if kernels:
        rows = [dict(kind="kernel", name=k.key, calls=k.count,
                     ms=k.self_device_time_total / 1e3) for k in kernels]
    else:
        rows = [dict(kind="host op", name=name, calls=n, ms=us / 1e3)
                for name, n, us in host_ops(w.prof)]
    rows.sort(key=lambda r: -r["ms"])
    # the profiler sits in a reference cycle (its action map holds its
    # own bound methods): collect it now, not at the interpreter's exit,
    # where with TEARDOWN_CUPTI=1 its destruction after CUPTI's teardown
    # hangs the exit
    w.prof = None
    gc.collect()
    return dict(mode=mode, trace=path, wall_ms=w.wall_ms,
                device_busy_ms=busy if kernels else None,
                idle_share=1 - busy / w.wall_ms if kernels and w.wall_ms
                else None, kernels=[k.key for k in kernels],
                top=rows[:opts.top])


def print_report(r: Dict, file=None) -> None:
    file = file or sys.stdout
    print(f"# trace: {r['trace']}", file=sys.stderr)
    busy = "not measured" if r["device_busy_ms"] is None \
        else f"{r['device_busy_ms']:.3f}"
    idle = "not measured" if r["idle_share"] is None \
        else f"{r['idle_share']:.3f}"
    print(f"mode={r['mode']} wall_ms={r['wall_ms']:.3f} "
          f"device_busy_ms={busy} idle_share={idle}", file=file)
    total = sum(row["ms"] for row in r["top"]) or 1e-9
    print(f"{'ms':>12} {'%':>6} {'calls':>7}  {'kind':<8} name", file=file)
    for row in r["top"]:
        print(f"{row['ms']:12.4f} {100 * row['ms'] / total:6.2f} "
              f"{row['calls']:7d}  {row['kind']:<8} {row['name'][:100]}",
              file=file)


# -- helpers shared by the serving modes -------------------------------------

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _serving_block(sched, k: int) -> None:
    """Dispatch the block one tick dispatches (Scheduler.tick's choice);
    a block with no live lane is an error: the trace would be empty."""
    if sched._mixed_mode:
        ok = sched._mixed_block(k)
    else:
        ok = sched._spec_block(k) if sched._spec_mode \
            else sched._decode_block(k)
    if not ok:
        raise RuntimeError("no request left to decode in the traced "
                           "block: raise --max-new")


def _scheduler(engine, opts):
    """A Scheduler whose first tick admits the whole batch. Under mixed
    dispatch a block's prefill lanes take C = min(inline budget,
    prefill_chunk) prompt tokens a step, at most budget // C slots at
    once: C is set to one prompt and the budget to the batch's prompts
    (the alternating path admits by prefill_chunk alone)."""
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    if engine.mixed_dispatch_ready:
        engine.runtime = engine.runtime.replace(
            prefill_chunk=opts.prompt_len,
            prefill_inline_budget=max(512, opts.prompt_len * opts.batch))
    return Scheduler(engine)


def _prealloc(sched, extra: int, slack: int = 0) -> None:
    """tick()'s page preallocation, so the traced dispatch pays no
    host-side growth: `extra` tokens past each request's current end."""
    for req in list(sched.running):
        if req in sched.running:
            need = min(len(req.all_tokens) + extra + slack,
                       len(req.prompt) + req.max_new_tokens + slack)
            sched._ensure_or_preempt(req, need)


def _warm(sched) -> None:
    """Run ticks until every submission is admitted and decoding, one
    more, then drain: the programs of the path have all run once."""
    while sched.waiting or sched._prefill_group:
        sched.tick()
    sched.tick()
    sched._drain_inflight()


# -- the modes ----------------------------------------------------------------

def profile_decode_loop(model, params, kv_quant: str, opts) -> Dict:
    """The offline engine's fused decode loop alone: generate() runs once
    to warm, then its body is replayed with prefill and the first sample
    before the window."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.engine import (InferenceEngine,
                                                   _generate_fused,
                                                   _generate_fused_win,
                                                   pad_prompts)
    from butterfly_tpu_torch.engine.sampling import SamplingParams, sample
    cfg = model.cfg
    engine = InferenceEngine(model, params, RuntimeConfig(
        max_seq_len=opts.prompt_len + opts.max_new, kv_quant=kv_quant))
    rng = np.random.RandomState(0)
    prompts = rng.randint(1, cfg.vocab_size,
                          (opts.batch, opts.prompt_len)).tolist()
    sp = SamplingParams(max_new_tokens=opts.max_new)
    engine.generate(prompts, sp)
    tokens, true_lens = pad_prompts(prompts)
    C = engine._decode_window
    steps = sp.max_new_tokens - 1
    iters = -(-steps // C) if steps else 0
    max_seq = max(engine.runtime.max_seq_len,
                  tokens.shape[1] + max(sp.max_new_tokens, iters * C))
    cache = engine._cache_pool.pop((opts.batch, max_seq), None)
    if cache is None:
        cache = engine.new_cache(opts.batch, max_seq)
    gen = torch.Generator(device=engine.device)
    gen.manual_seed(0)
    dev = engine.device
    logits, cache = engine.prefill(torch.as_tensor(tokens).to(dev),
                                   torch.as_tensor(true_lens).to(dev), cache)
    first = sample(logits, gen, sp)
    with capture(dev) as w:
        if C > 1:
            _generate_fused_win(cfg, C, engine.params, first, cache, gen, sp,
                                sp.max_new_tokens,
                                bool(np.all(true_lens == true_lens[0])))
        else:
            _generate_fused(cfg, engine.params, first, cache, gen, sp,
                            sp.max_new_tokens, engine._fwd)
    return report(w, "decode", opts)


def _serving_sched(model, params, kv_quant, opts, **rt_kw):
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.serving import ServingEngine
    k = opts.steps_per_tick
    # budget for the warm-up blocks (about four) and the traced ones, so
    # no request finishes (and frees its slot) before the window
    max_new = max(opts.max_new, 8 * k + 8)
    rt = RuntimeConfig(**{**dict(
        max_batch_size=opts.batch,
        max_seq_len=opts.prompt_len + max_new + 16, kv_quant=kv_quant,
        decode_steps_per_tick=k,
        prefill_chunk=max(512, opts.prompt_len * opts.batch)), **rt_kw})
    sched = _scheduler(ServingEngine(model, params, rt), opts)
    rng = np.random.RandomState(0)
    for _ in range(opts.batch):
        sched.submit(rng.randint(1, model.cfg.vocab_size,
                                 (opts.prompt_len,)).tolist(),
                     max_new_tokens=max_new)
    return sched


def profile_serving_block(model, params, kv_quant: str, opts) -> Dict:
    """One block of a Scheduler warmed through real admissions until
    every slot decodes."""
    k = opts.steps_per_tick
    sched = _serving_sched(model, params, kv_quant, opts)
    _warm(sched)
    _prealloc(sched, k + 1)
    _sync(sched.engine.device)
    with capture(sched.engine.device) as w:
        _serving_block(sched, k)
    sched.run_until_done(max_ticks=10 ** 6)
    return report(w, "serving", opts)


def profile_pipeline(model, params, kv_quant: str, opts) -> Dict:
    """Two chained in-flight blocks: the second dispatched on the first's
    device carry before the first is drained, so the trace shows whether
    the device runs them back to back."""
    k = opts.steps_per_tick
    sched = _serving_sched(model, params, kv_quant, opts, inflight_blocks=2)
    _warm(sched)
    _prealloc(sched, 2 * k + 2)
    _sync(sched.engine.device)
    with capture(sched.engine.device) as w:
        _serving_block(sched, k)   # block 1
        _serving_block(sched, k)   # block 2, on block 1's carry
    sched.run_until_done(max_ticks=10 ** 6)
    return report(w, "pipeline", opts)


def profile_spec_block(model, params, kv_quant: str, opts) -> Dict:
    """One speculative block of a warmed speculating Scheduler, its
    prompts seeded with each request's own greedy continuation so prompt
    lookup finds drafts."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    k, gamma, cfg = opts.steps_per_tick, opts.gamma, model.cfg
    max_new = max(opts.max_new, 4 * k * (gamma + 1) + 8)
    rt = RuntimeConfig(max_batch_size=opts.batch,
                       max_seq_len=opts.prompt_len + max_new + gamma + 16,
                       kv_quant=kv_quant, decode_steps_per_tick=k,
                       speculative_gamma=gamma,
                       draft_model=opts.draft_source,
                       draft_layers=opts.draft_layers,
                       spec_tree_width=opts.tree_width,
                       spec_tree_nodes=opts.tree_nodes,
                       prefill_chunk=max(512, opts.prompt_len * opts.batch))
    rng = np.random.RandomState(0)
    probe = Scheduler(ServingEngine(model, params,
                                    rt.replace(speculative_gamma=0)))
    half = max(1, opts.prompt_len // 2)
    bases = [rng.randint(1, cfg.vocab_size, (half,)).tolist()
             for _ in range(opts.batch)]
    cont = [probe.submit(b, max_new_tokens=opts.prompt_len - half)
            for b in bases]
    probe.run_until_done(max_ticks=10 ** 6)
    del probe
    engine = ServingEngine(model, params, rt)
    sched = _scheduler(engine, opts)
    for b, r in zip(bases, cont):
        sched.submit(b + r.output, max_new_tokens=max_new)
    _warm(sched)
    # a round commits up to spec_emit_width tokens a slot; a tree round
    # verifies N nodes, so the accepted path may sit N - (D+1) deeper
    slack = 0
    if engine.spec_tree_mode:
        slack = engine.spec_tree_geometry[1] - engine.spec_emit_width
    _prealloc(sched, k * engine.spec_emit_width + 1, slack)
    _sync(engine.device)
    with capture(engine.device) as w:
        _serving_block(sched, k)
    sched.run_until_done(max_ticks=10 ** 6)
    return report(w, "spec", opts)


def profile_prefill_batch(model, params, kv_quant: str, opts) -> Dict:
    """One gang admission: a warm-up gang runs the prefill program
    first, then a fresh gang of B waiting requests is admitted inside
    the window (one engine.prefill_batch)."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    B = max(1, min(opts.prefill_max_batch, opts.batch))
    rt = RuntimeConfig(max_batch_size=opts.batch,
                       max_seq_len=opts.prompt_len + opts.max_new + 16,
                       kv_quant=kv_quant, prefill_max_batch=B,
                       prefill_chunk=max(512, opts.prompt_len * B))
    engine = ServingEngine(model, params, rt)
    sched = Scheduler(engine)
    rng = np.random.RandomState(0)

    def prompt():
        return rng.randint(1, model.cfg.vocab_size,
                           (opts.prompt_len,)).tolist()
    for _ in range(B):
        sched.submit(prompt(), max_new_tokens=2)
    sched.run_until_done()
    for _ in range(B):
        sched.submit(prompt(), max_new_tokens=2)
    _sync(engine.device)
    with capture(engine.device) as w:
        sched._admit()   # one gang admission: the batched prefill
    sched.run_until_done(max_ticks=10 ** 6)
    return report(w, "prefill", opts)


def longctx_devices(device) -> list:
    """The seq = 4 mesh's devices: one shard per card where the cards
    come in fours, else all four shards on one device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if n >= 4 and n % 4 == 0:
            return [f"cuda:{i}" for i in range(n)]
        return [str(dev if dev.index is not None
                    else torch.device("cuda:0"))] * 4
    return [str(dev)] * 4


def profile_longctx(model, params, kv_quant: str, opts,
                    devices: Optional[list] = None) -> Dict:
    """The long-prompt lane: one seq-parallel prefill chunk plus one
    decode block beside it, after one long prefill end to end warmed
    both programs."""
    from butterfly_tpu_torch.core.config import MeshConfig, RuntimeConfig
    from butterfly_tpu_torch.core.mesh import make_mesh
    from butterfly_tpu_torch.engine.serving import ServingEngine
    devices = devices or longctx_devices(model.device)
    mesh = make_mesh(MeshConfig(seq=4, data=len(devices) // 4), devices)
    k = opts.steps_per_tick
    chunk = opts.prompt_len            # a shard's work unit per dispatch
    long_len = 8 * chunk               # the lane's admission regime
    max_new = max(opts.max_new, 8 * k + 16)
    rt = RuntimeConfig(max_batch_size=opts.batch,
                       max_seq_len=long_len + max_new + 16,
                       kv_quant=kv_quant, decode_steps_per_tick=k,
                       prefill_chunk=chunk,
                       seq_parallel_threshold=long_len // 2)
    engine = ServingEngine(model, params, rt, mesh=mesh)
    if not engine.supports_seq_parallel:
        raise RuntimeError("the engine cannot run the seq lane on this "
                           "mesh")
    sched = _scheduler(engine, opts)
    rng = np.random.RandomState(0)

    def prompt(n):
        return rng.randint(1, model.cfg.vocab_size, (n,)).tolist()
    warm_long = sched.submit(prompt(long_len), max_new_tokens=2)
    for _ in range(opts.batch - 1):
        sched.submit(prompt(opts.prompt_len), max_new_tokens=max_new)
    while (sched.waiting or sched._prefill_group or sched._sp_group
           or not warm_long.done):
        sched.tick()
    sched._drain_inflight()
    sched.submit(prompt(long_len), max_new_tokens=2)
    sched._sp_admit()
    if not sched._sp_group:
        raise RuntimeError("the long prompt did not enter the seq lane")
    _prealloc(sched, k + 1)
    _sync(engine.device)
    with capture(engine.device) as w:
        sched._sp_prefill_step()       # one seq-parallel chunk
        _serving_block(sched, k)       # one block beside the lane
    sched.run_until_done(max_ticks=10 ** 6)
    return report(w, "long_context", opts)


def run_mode(model, params, kv_quant: str, opts) -> Dict:
    """The mode the flags select."""
    if opts.long_context:
        return profile_longctx(model, params, kv_quant, opts)
    if opts.prefill:
        return profile_prefill_batch(model, params, kv_quant, opts)
    if opts.pipeline:
        return profile_pipeline(model, params, kv_quant, opts)
    if opts.spec:
        return profile_spec_block(model, params, kv_quant, opts)
    if opts.serving:
        return profile_serving_block(model, params, kv_quant, opts)
    return profile_decode_loop(model, params, kv_quant, opts)


def main(argv=None) -> int:
    opts = build_parser().parse_args(argv)
    model, params, kv_quant = build_model(opts)
    r = run_mode(model, params, kv_quant, opts)
    print_report(r)
    print(json.dumps({k: r[k] for k in ("mode", "trace", "wall_ms",
                                        "device_busy_ms", "idle_share")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
