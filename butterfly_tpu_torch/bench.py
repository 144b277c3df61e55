"""Headline benchmark: one JSON line with the headline metric, the port
of the repo's bench.py.

    python -m butterfly_tpu_torch.bench [--device cpu]

Headline: steady-state decode throughput (tokens/sec/chip; one card is
one chip) of Llama-3-8B with int8 weights and an int8 KV cache on the
card, through the benchmark legs of obs/benchmark.py in the order of the
JAX package's bench.py: decode, serving three ways (synchronous, window
off, pipelined), warm-prefix prefill, long context, speculation, the
mixed workload and its operating-point grid, then the fleet, chaos and
autoscale tiers on tiny-model fleets. The line carries the keys of the
JAX package's bench.py. `vs_baseline` is null: bench_baseline.json holds
figures of the JAX package on its own hardware, which nothing here
compares with.

With `--device cpu` it runs the CPU branch of the JAX package's
bench.py: the tiny f32 config with int8 weights and a float pool, at the
CPU sizes, and the long-context lane on eight CPU shards (the eight fake
devices the JAX bench.py forces).

Before anything runs, the tree is linted with tools/staticcheck.py over
its default trees (as `butterfly lint` loads it): a finding makes it
print the finding and exit 2, running no leg.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def lint_preflight():
    """The unsuppressed findings of tools/staticcheck.py over its default
    trees (the repo's tier-1 gate): a number published from a tree that
    breaks the donation, lock, host-sync or determinism contracts is not
    one the serving path can be trusted to have produced."""
    tools = REPO / "tools"
    if not (tools / "staticcheck.py").exists():
        raise FileNotFoundError("bench needs the repo's tools/ directory "
                                "(run from a source checkout)")
    # staticcheck imports its sibling staticrules by name
    sys.path.insert(0, str(tools))
    try:
        staticcheck = importlib.import_module("staticcheck")
    finally:
        sys.path.remove(str(tools))
    return staticcheck.run_default()


def _merge(out: dict, stats: dict) -> None:
    for k, v in stats.items():
        out[k] = round(v, 4) if isinstance(v, float) else v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m butterfly_tpu_torch.bench")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    lint = lint_preflight()
    if lint:
        print("bench: refusing to run on a tree with unsuppressed "
              "staticcheck findings:", file=sys.stderr)
        for f in lint:
            print("  " + f.render(), file=sys.stderr)
        return 2
    t_start = time.monotonic()
    import torch

    from butterfly_tpu_torch.core.config import llama3_8b, tiny
    from butterfly_tpu_torch.engine.engine import cast_params
    from butterfly_tpu_torch.models.common import Model
    from butterfly_tpu_torch.obs.benchmark import (run_autoscale_benchmark,
                                                   run_chaos_benchmark,
                                                   run_decode_benchmark,
                                                   run_fleet_benchmark,
                                                   run_longctx_benchmark,
                                                   run_mixed_benchmark,
                                                   run_serving_benchmark,
                                                   run_spec_benchmark,
                                                   run_warm_prefill_benchmark)
    from butterfly_tpu_torch.quant.int8 import init_params_quantized

    on_card = args.device != "cpu"
    if on_card:
        cfg = llama3_8b().replace(max_seq_len=2048)
        batch, prompt_len, max_new = 128, 128, 128
        serving_kw = dict(n_requests=64, prompt_len=128, max_new=128,
                          max_batch=32, decode_steps_per_tick=16,
                          prefill_max_batch=16)
    else:
        cfg = tiny("llama", dtype="float32", param_dtype="float32")
        batch, prompt_len, max_new = 4, 32, 32
        serving_kw = dict(n_requests=8, prompt_len=16, max_new=32,
                          max_batch=4, decode_steps_per_tick=4,
                          prefill_max_batch=4)
    model = Model(cfg, device=args.device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)
    # int8 weights drawn pre-quantized (the float tree never exists), cast
    # once here: every leg's engines share this tree
    params = cast_params(init_params_quantized(cfg, gen, model.device), cfg)
    kv_quant = "int8" if on_card else "none"

    def log(leg):   # progress on stderr: the leg starting, seconds so far
        print(f"[bench] leg={leg} t_s={time.monotonic() - t_start:.1f}",
              file=sys.stderr, flush=True)
    log("decode")
    stats = run_decode_benchmark(model, params, batch=batch,
                                 prompt_len=prompt_len, max_new=max_new,
                                 kv_quant=kv_quant)
    iso = stats["decode_tokens_per_sec_per_chip"]
    # the serving path at both dispatch-ahead depths and with the
    # write-combined window off; the headline keys are the pipelined run's
    log("serving")
    serving_sync = run_serving_benchmark(
        model, params, kv_quant=kv_quant, inflight_blocks=1,
        isolated_decode_tok_s_chip=iso, **serving_kw)
    serving_nowin = run_serving_benchmark(
        model, params, kv_quant=kv_quant, kv_write_combine=False,
        isolated_decode_tok_s_chip=iso, **serving_kw)
    serving = run_serving_benchmark(
        model, params, kv_quant=kv_quant, isolated_decode_tok_s_chip=iso,
        **serving_kw)
    for k in ("serving_tokens_per_sec_per_chip",
              "serving_capacity_tokens_per_sec", "serving_gap"):
        if k in serving_sync:
            serving[k + "_sync"] = serving_sync[k]
        if k in serving_nowin:
            serving[k + "_nowin"] = serving_nowin[k]
    log("warm_prefill")
    serving.update(run_warm_prefill_benchmark(
        model, params, kv_quant=kv_quant, prompt_len=640,
        prefill_chunk=256, n_requests=6, max_batch=4))
    log("longctx")
    longctx_kw = (dict(prompt_len=4096, prefill_chunk=512, max_new=16,
                       decode_new=64, kv_quant="int8")
                  if on_card else dict(devices=["cpu"] * 8))
    serving.update(run_longctx_benchmark(model, params, **longctx_kw))
    log("spec")
    serving.update(run_spec_benchmark(
        model, params, kv_quant=kv_quant,
        n_requests=serving_kw["n_requests"],
        prompt_len=serving_kw["prompt_len"], max_new=serving_kw["max_new"],
        max_batch=serving_kw["max_batch"],
        decode_steps_per_tick=serving_kw["decode_steps_per_tick"],
        gamma=4, draft_layers=1))
    log("mixed")
    if on_card:
        mixed_kw = dict(n_requests=64, max_batch=32,
                        prompt_lo=32, prompt_hi=1024,
                        max_new_lo=16, max_new_hi=256, page_size=16,
                        pool_fraction=0.15, host_kv_tier_mb=64.0,
                        decode_steps_per_tick=16, inflight_blocks=2,
                        prefill_max_batch=16, kv_quant="int8",
                        grid=[(4, 1), (4, 2), (16, 1), (16, 2)])
    else:
        mixed_kw = dict(n_requests=12, max_batch=4,
                        prompt_lo=8, prompt_hi=48,
                        max_new_lo=16, max_new_hi=48, page_size=8,
                        pool_fraction=0.35, host_kv_tier_mb=8.0,
                        arrival="burst:2000:0.5:0.1",
                        decode_steps_per_tick=4, inflight_blocks=2,
                        prefill_max_batch=4, kv_quant="none",
                        grid=[(1, 1), (1, 2), (4, 1), (4, 2)])
    serving.update(run_mixed_benchmark(model, params, **mixed_kw))
    # the mixed-dispatch pairs as deltas against the alternating path
    for phase, itl, bar in (
            ("serving", "itl_req_mean_p95", "serving_admission_barriers"),
            ("mixed", "mixed_itl_req_mean_p95", "mixed_admission_barriers")):
        if itl in serving and itl + "_alt" in serving:
            serving[phase + "_itl_p95_delta"] = \
                serving[itl] - serving[itl + "_alt"]
        if bar in serving and bar + "_alt" in serving:
            serving[phase + "_admission_barriers_delta"] = \
                serving[bar] - serving[bar + "_alt"]
    value = stats["tokens_per_sec_per_chip"]
    out = {
        "metric": "decode_tokens_per_sec_per_chip",
        "value": round(value, 2),
        "unit": "tokens/sec/chip",
        "vs_baseline": None,
        "model": "llama3-8b" if on_card else "tiny",
        "quant": "int8",
        "kv_quant": kv_quant,
        "decode_isolated_tokens_per_sec_per_chip": round(iso, 2),
        "hbm_util": stats["hbm_util"] if stats["hbm_util"] is None
        else round(stats["hbm_util"], 4),
        "mfu": stats["mfu"] if stats["mfu"] is None
        else round(stats["mfu"], 4),
        "staticcheck_findings_total": len(lint),
    }
    _merge(out, serving)
    fleet_dev = None if on_card else "cpu"
    log("fleet")
    _merge(out, run_fleet_benchmark("2p2d", device=fleet_dev))
    log("chaos")
    _merge(out, run_chaos_benchmark("2p2d", device=fleet_dev))
    log("autoscale")
    _merge(out, run_autoscale_benchmark("1p1d", device=fleet_dev))
    log("done")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
