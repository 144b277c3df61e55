"""`butterfly generate`, `serve` and `bench` on the PyTorch/CUDA port.

    python -m butterfly_tpu_torch.serve.cli generate --model llama3-8b --prompt "hello" --max-new 32
    python -m butterfly_tpu_torch.serve.cli generate --model tiny --device cpu
    python -m butterfly_tpu_torch.serve.cli generate --model tiny --device cpu --seq-parallel 2
    python -m butterfly_tpu_torch.serve.cli serve --model llama3-8b --port 8000
    python -m butterfly_tpu_torch.serve.cli serve --model tiny --device cpu
    python -m butterfly_tpu_torch.serve.cli serve --model tiny --device cpu --seq-parallel 2 --seq-parallel-threshold 256
    python -m butterfly_tpu_torch.serve.cli serve --model tiny --device cpu --prefix-caching --host-tier-mb 64
    python -m butterfly_tpu_torch.serve.cli bench --model tiny --device cpu --serving --mixed --prompt-len 64 --max-new 32
    python -m butterfly_tpu_torch.serve.cli bench --model llama3-8b --serving --mixed --host-tier-mb 512
    python -m butterfly_tpu_torch.serve.cli generate --model tiny --device cpu --quant int8 --speculate 4
    python -m butterfly_tpu_torch.serve.cli serve --model tiny --device cpu --speculate 4 --draft-source model --draft-layers 1
    python -m butterfly_tpu_torch.serve.cli bench --model tiny --device cpu --spec --prompt-len 32 --max-new 32
    python -m butterfly_tpu_torch.serve.cli generate --model mixtral-8x7b --quant int8 --prompt "hello" --max-new 32
    python -m butterfly_tpu_torch.serve.cli generate --model tiny --device cpu --expert-parallel 2
    python -m butterfly_tpu_torch.serve.cli serve --model tiny --device cpu --tensor-parallel 2 --data-parallel 2
    python -m butterfly_tpu_torch.serve.cli route --backends 127.0.0.1:8000,127.0.0.1:8001 --port 8100
    python -m butterfly_tpu_torch.serve.cli fleet --topology 2p2d --device cpu
    python -m butterfly_tpu_torch.serve.cli workload generate --n 32 --out trace.jsonl
    python -m butterfly_tpu_torch.serve.cli workload replay --trace trace.jsonl --url http://127.0.0.1:8100
    python -m butterfly_tpu_torch.serve.cli workload sweep --device cpu --n 16 --prompt-hi 64 --max-new-hi 16
    python -m butterfly_tpu_torch.serve.cli dash timeseries.json --text
    python -m butterfly_tpu_torch.serve.cli generate --model llama3-8b --ckpt /path/to/hf_dir --prompt "hello"
    python -m butterfly_tpu_torch.serve.cli serve --model tiny --device cpu --profiler-port 9999
    python -m butterfly_tpu_torch.serve.cli lint --list-rules

The subcommands keep the JAX CLI's flags (butterfly_tpu/serve/cli.py);
the ones that build an engine (generate, serve, bench, fleet, workload
sweep) add --device (default cuda). route, workload generate|replay and
dash load no model and touch no device. `--seq-parallel N` builds a seq mesh of N
shards, `--expert-parallel N` an expert mesh of N shards (an MoE model
then takes the expert-parallel dispatch, cfg.moe_impl="ep"), and
`--tensor-parallel N` / `--data-parallel M` a tensor x data mesh (the
weights and KV split Megatron-style over N shards, slots and batch rows
over M groups), `--stage-parallel N` a pipeline of N stages (the layer
stack and the KV split over them, microbatches through the GPipe
schedule; with tensor and/or data inside each stage): on cuda:0..n-1
with --device cuda (n cards needed), on the CPU with --device cpu. The
five flags combine freely, as in the JAX CLI; `generate` with
--seq-parallel takes generate_long, which refuses --stage-parallel with
the JAX engine's NotImplementedError (under stages the seq axis is a
replica, and `serve` warns that its long-prompt lane is off).
`--ckpt DIR` loads an HF-format checkpoint directory (safetensors or
pytorch_model*.bin, ckpt/load.py) into the compute dtype, leaf by leaf;
without it, weights are random (demo mode). `--quant int8` quantizes
either one layer at a time as it arrives, so the float tree is never
held. `lint` runs the port's own checker (tools/staticcheck.py of this
package) over butterfly_tpu_torch/.
"""
from __future__ import annotations

import argparse
import math
import sys
import time


def _positive_int(v):
    n = int(v)
    if n < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {n}")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="butterfly",
                                description="Butterfly inference CLI "
                                            "(PyTorch/CUDA port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def slo_flags(sp):
        sp.add_argument("--slo-ttft-ms", type=float, default=None,
                        help="declared time-to-first-token objective (ms)")
        sp.add_argument("--slo-itl-ms", type=float, default=None,
                        help="declared mean inter-token-latency "
                             "objective (ms)")

    def device_flag(sp):
        sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where the engine runs (default cuda; without "
                             "a card, pass cpu explicitly)")

    def common(sp):
        device_flag(sp)
        sp.add_argument("--model", default="tiny",
                        help="preset name (gpt2-124m, llama3-8b, "
                             "llama3-70b, mixtral-8x7b) or 'tiny'")
        sp.add_argument("--ckpt", default=None,
                        help="HF-format checkpoint dir (*.safetensors or "
                             "pytorch_model*.bin, plus config.json); "
                             "default: random weights")
        sp.add_argument("--tokenizer", default=None)
        sp.add_argument("--dtype", default=None,
                        help="override compute dtype")
        sp.add_argument("--tensor-parallel", type=int, default=1,
                        help="split heads, F and vocab over N shards "
                             "(Megatron); --device cuda needs N cards")
        sp.add_argument("--data-parallel", type=int, default=1,
                        help="split slots and batch rows over M groups")
        sp.add_argument("--stage-parallel", type=int, default=1,
                        help="pipeline the layer stack over N stages "
                             "(GPipe); --device cuda needs N cards")
        sp.add_argument("--expert-parallel", type=int, default=1,
                        help="shard an MoE model's experts over N devices "
                             "(GShard all_to_all dispatch); --device cuda "
                             "needs N cards")
        sp.add_argument("--seq-parallel", type=int, default=1,
                        help="shard long prompts over N devices (ring "
                             "attention / Ulysses); --device cuda needs N "
                             "cards")
        sp.add_argument("--seq-impl", choices=["ring", "ulysses"],
                        default="ring",
                        help="attention across the seq shards (generate)")
        sp.add_argument("--max-seq", type=int, default=2048)
        sp.add_argument("--dcn-axes", default="data",
                        help="comma-separated mesh axes that may span "
                             "hosts in a job of several processes "
                             "(BUTTERFLY_NUM_PROCESSES)")
        sp.add_argument("--quant", choices=["none", "int8"], default="none",
                        help="weight-only quantization: int8 codes with "
                             "per-output-channel scales for every matmul "
                             "weight (quant/int8.py)")
        sp.add_argument("--kv-quant", choices=["none", "int8"],
                        default="none",
                        help="KV-cache quantization (int8 halves the cache "
                             "bytes the decode loop reads)")

    g = sub.add_parser("generate", help="one-shot text generation")
    common(g)
    g.add_argument("--prompt", default="Hello")
    g.add_argument("--max-new", type=int, default=64)
    g.add_argument("--temperature", type=float, default=0.0)
    g.add_argument("--top-k", type=int, default=0)
    g.add_argument("--top-p", type=float, default=1.0)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--speculate", type=int, default=0, metavar="GAMMA",
                   help="prompt-lookup speculative decoding: draft GAMMA "
                        "tokens per step, verify them in one forward. "
                        "Greedy output is plain decode's; with "
                        "--temperature > 0 the rejection-sampling "
                        "correction keeps the distribution exact")

    s = sub.add_parser("serve", help="HTTP serving with continuous batching")
    common(s)
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--max-batch", type=int, default=8)
    s.add_argument("--page-size", type=int, default=16)
    s.add_argument("--top-k", type=int, default=0,
                   help="serving-wide top-k sampling filter")
    s.add_argument("--top-p", type=float, default=1.0)
    s.add_argument("--max-queue", type=int, default=256)
    s.add_argument("--no-trace", action="store_true",
                   help="disable per-request tracing (GET /debug/requests)")
    s.add_argument("--role", choices=["prefill", "decode", "both"],
                   default="both",
                   help="fleet placement role advertised on /health")
    s.add_argument("--prefix-caching", action="store_true",
                   help="reuse KV pages across requests sharing a prompt "
                        "prefix (content-hashed, refcounted; cuts TTFT for "
                        "shared system prompts)")
    s.add_argument("--host-tier-mb", type=float, default=0.0,
                   help="host-RAM KV tier budget in MiB (requires "
                        "--prefix-caching): device-pool evictions demote "
                        "pages to host memory instead of dropping them, "
                        "and a later prefix hit on an evicted chain "
                        "revives the pages back to the card. 0 = off")
    s.add_argument("--host-tier-dir", default=None, metavar="DIR",
                   help="optional disk-spill directory for the host KV "
                        "tier: pages LRU-demoted past --host-tier-mb "
                        "spill to .pt files here instead of being dropped")
    s.add_argument("--speculate", type=int, default=0, metavar="GAMMA",
                   help="speculative serving on the block pipeline: draft "
                        "GAMMA tokens per slot, verify every slot in one "
                        "batched (GAMMA+1)-token forward per round, accept "
                        "and roll back on the device; clients opt out per "
                        'request with "speculative": false')
    s.add_argument("--draft-source", default="ngram",
                   help="draft source: 'ngram' (prompt lookup over the "
                        "token history) or 'model' (the on-device draft "
                        "model, models/draft.py)")
    s.add_argument("--draft-layers", type=int, default=0,
                   help="--draft-source model: the draft is the target's "
                        "first N layers, embed/unembed shared (0 = "
                        "num_layers/4, floor 1)")
    s.add_argument("--draft-ckpt", default=None,
                   help="--draft-source model: an independent narrow draft "
                        "checkpoint (HF-format dir with its own "
                        "config.json; same vocabulary as the target)")
    s.add_argument("--spec-tree", type=int, default=0, metavar="WIDTH",
                   help="token-tree speculation of this width (needs "
                        "--draft-source model); 0/1 = linear chain")
    s.add_argument("--spec-tree-nodes", type=int, default=0, metavar="N",
                   help="tree node budget per verify incl. the root; "
                        "(N-1) must divide by --spec-tree; 0 = GAMMA+1")
    s.add_argument("--decode-steps-per-tick", type=_positive_int, default=1,
                   help="fused block width: decode iterations per "
                        "scheduler tick, drained in ONE stacked fetch")
    s.add_argument("--prefill-max-batch", type=_positive_int, default=8)
    s.add_argument("--seq-parallel-threshold", type=int, default=0,
                   help="prompts longer than this many tokens prefill "
                        "through the seq-parallel lane (needs "
                        "--seq-parallel N > 1); 0 = off")
    s.add_argument("--seq-parallel-chunk", type=int, default=0,
                   help="tokens per seq-parallel prefill dispatch (0 = "
                        "N x the prefill chunk)")
    slo_flags(s)
    s.add_argument("--profiler-port", type=int, default=0,
                   help="on-demand torch.profiler captures of the live "
                        "loop over HTTP on this port (POST /profile "
                        "{duration_ms}; obs/profile.py); 0 = off")
    s.add_argument("--flightrec-dir", default=None, metavar="DIR",
                   help="write flight-recorder post-mortems here")
    s.add_argument("--inflight-blocks", type=_positive_int, default=2,
                   help="blocks kept in flight on the device "
                        "(dispatch-ahead)")
    s.add_argument("--timeseries-interval", type=float, default=1.0,
                   metavar="SECONDS",
                   help="GET /debug/timeseries sampling interval; 0 = off")

    b = sub.add_parser("bench", help="throughput microbenchmark")
    common(b)
    b.add_argument("--batch", type=int, default=8)
    b.add_argument("--prompt-len", type=int, default=128)
    b.add_argument("--max-new", type=int, default=128)
    b.add_argument("--serving", action="store_true",
                   help="also run the serving-path benchmark (Scheduler + "
                        "ServingEngine under staggered arrivals) and the "
                        "long-context row at this operating point and "
                        "merge their keys into the JSON line")
    b.add_argument("--inflight-blocks", type=_positive_int, default=2,
                   help="dispatch-ahead depth for --serving / --mixed")
    b.add_argument("--max-batch", type=_positive_int, default=0,
                   help="serving slot count for --serving / --mixed "
                        "(default: --batch)")
    b.add_argument("--mixed", action="store_true",
                   help="also run the mixed-workload serving phase: the "
                        "mixed_chat population fired open-loop in bursts "
                        "against an under-provisioned page pool with "
                        "prefix caching, plus the decode_steps_per_tick x "
                        "inflight_blocks operating-point table + knee; "
                        "merges mixed_* keys into the JSON line")
    b.add_argument("--host-tier-mb", type=float, default=0.0,
                   help="with --mixed: a host-RAM KV tier of this many "
                        "MiB, so the contested pool demotes and revives "
                        "pages instead of dropping them")
    b.add_argument("--spec", action="store_true",
                   help="also run the speculation leg (spec on vs off on "
                        "draft-friendly prompts, then the ngram, model and "
                        "tree draft rows on mixed_chat prompts) and merge "
                        "its spec_* keys into the JSON line (gamma 4, a "
                        "1-layer draft model)")

    # multi-replica router in front of `serve` replicas: loads no model
    # and touches no device, so it gets no common() flags
    r = sub.add_parser("route",
                       help="route requests across serve replicas "
                            "(prefix-affinity + health-aware failover)")
    r.add_argument("--backends", required=True,
                   help="comma-separated replica addresses, e.g. "
                        "10.0.0.1:8000,10.0.0.2:8000")
    r.add_argument("--port", type=int, default=8100)
    r.add_argument("--host", default="0.0.0.0")
    r.add_argument("--page-size", type=int, default=16,
                   help="MUST match the replicas' --page-size: affinity "
                        "keys hash the same token blocks their prefix "
                        "caches key pages by")
    r.add_argument("--affinity-blocks", type=int, default=4,
                   help="leading full prompt blocks hashed into the "
                        "affinity key")
    r.add_argument("--saturate-after", type=int, default=8,
                   help="outstanding requests at which the affinity "
                        "target is considered saturated and routing "
                        "falls back to least-outstanding")
    r.add_argument("--probe-interval", type=float, default=0.5,
                   help="seconds between /health probes of each replica")
    r.add_argument("--dead-after", type=int, default=3,
                   help="consecutive connect failures before a replica "
                        "is marked dead")
    r.add_argument("--read-timeout", type=float, default=300.0,
                   help="per-request socket timeout toward a replica")
    r.add_argument("--disaggregate", action="store_true",
                   help="run the KV-aware fleet control plane instead of "
                        "the plain router: prefill-heavy requests go to "
                        "--role prefill replicas, their KV pages stream "
                        "to a --role decode replica by chain hash "
                        "(GET /kv/pages -> POST /kv/import), and "
                        "generation finishes there")
    r.add_argument("--disagg-threshold", type=int, default=64,
                   help="predicted fresh-prefill tokens at which a "
                        "request is worth the prefill/decode handoff")
    slo_flags(r)

    # local disaggregated fleet for manual debugging: N prefill + M
    # decode in-process tiny-model replicas behind one control plane
    f = sub.add_parser("fleet",
                       help="spin a local prefill/decode fleet (replicas "
                            "+ control plane, in-process) for manual "
                            "debugging")
    device_flag(f)
    f.add_argument("--topology", default="2p2d",
                   help="'<N>p<M>d' = N prefill + M decode replicas "
                        "(default 2p2d), or a bare count for a "
                        "role-less pool")
    f.add_argument("--page-size", type=int, default=8)
    f.add_argument("--max-batch", type=int, default=2)
    f.add_argument("--max-seq", type=int, default=128)
    f.add_argument("--disagg-threshold", type=int, default=16)
    f.add_argument("--autoscale", action="store_true",
                   help="run the closed-loop autoscaler (fleet/"
                        "autoscale.py) on every tier in the topology; "
                        "decisions land in GET /debug/flightrecorder")
    f.add_argument("--scale-min", type=int, default=1,
                   help="autoscaler floor per tier (default 1)")
    f.add_argument("--scale-max", type=int, default=4,
                   help="autoscaler ceiling per tier (default 4)")
    f.add_argument("--scale-high", type=float, default=4.0,
                   help="tier-mean queue_depth above which a tier "
                        "grows (default 4.0)")
    f.add_argument("--scale-low", type=float, default=0.5,
                   help="tier-mean queue_depth below which a tier "
                        "shrinks, after the hysteresis cooldown "
                        "(default 0.5)")
    f.add_argument("--host-tier-mb", type=float, default=0.0,
                   help="per-replica host-RAM KV tier budget in MiB "
                        "(see `serve --host-tier-mb`); 0 = off")
    f.add_argument("--host-tier-dir", default=None, metavar="DIR",
                   help="disk-spill directory for the replicas' host "
                        "KV tiers (see `serve --host-tier-dir`)")
    f.add_argument("--chaos", default=None, metavar="PLAN",
                   help="seeded fault-injection plan: a JSON file "
                        "(fleet/chaos.py ChaosPlan.from_file) or the "
                        "literal 'default' for the stock soak plan")
    slo_flags(f)

    # workload tooling: seeded traces, open-loop replay at a live URL,
    # and operating-point sweeps on an in-process engine
    w = sub.add_parser("workload",
                       help="stochastic workload tooling: generate a "
                            "seeded trace, replay one at a server "
                            "open-loop, or sweep scheduler operating "
                            "points")
    wsub = w.add_subparsers(dest="wcmd", required=True)

    def workload_shape_flags(sp):
        sp.add_argument("--workload", default="mixed_chat",
                        help="canned workload name (mixed_chat, uniform)")
        sp.add_argument("--n", type=int, default=32,
                        help="requests to sample")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--arrival", default="poisson:8",
                        help="arrival process: poisson:<rate>, "
                             "burst:<rate_on>:<mean_on_s>:<mean_off_s>"
                             "[:<rate_off>], ramp:<r0>:<r1>:<ramp_s>")
        sp.add_argument("--vocab", type=int, default=258,
                        help="token-id vocabulary (match the target "
                             "model; 258 = tiny)")
        sp.add_argument("--page-size", type=int, default=16,
                        help="prefix alignment unit — match the "
                             "server's --page-size")
        sp.add_argument("--prompt-lo", type=int, default=32)
        sp.add_argument("--prompt-hi", type=int, default=1024)
        sp.add_argument("--max-new-lo", type=int, default=8)
        sp.add_argument("--max-new-hi", type=int, default=256)
        sp.add_argument("--deadline-ms", type=float, default=None,
                        help="latency budget for the workload's "
                             "deadline-carrying cohort")

    wg = wsub.add_parser("generate",
                         help="sample a workload + arrival schedule "
                              "into a JSONL trace")
    workload_shape_flags(wg)
    wg.add_argument("--out", required=True, metavar="FILE",
                    help="trace output path (JSONL)")

    wr = wsub.add_parser("replay",
                         help="fire a saved trace at a live server/"
                              "router URL with absolute-time fidelity "
                              "(open loop)")
    wr.add_argument("--trace", required=True, metavar="FILE")
    wr.add_argument("--url", required=True,
                    help="target base URL, e.g. http://127.0.0.1:8000")
    wr.add_argument("--speed", type=float, default=1.0,
                    help="schedule compression: 2.0 replays twice as "
                         "fast")
    wr.add_argument("--timeout", type=float, default=120.0)
    slo_flags(wr)

    ws = wsub.add_parser("sweep",
                         help="run one workload across a "
                              "decode_steps_per_tick x inflight_blocks "
                              "grid (in-process engine) and emit the "
                              "latency/throughput table + knee")
    workload_shape_flags(ws)
    device_flag(ws)
    ws.add_argument("--model", default="tiny")
    ws.add_argument("--quant", choices=["none", "int8"], default="none")
    ws.add_argument("--kv-quant", choices=["none", "int8"], default="none",
                    help="KV-cache quantization")
    ws.add_argument("--ckpt", default=None)
    ws.add_argument("--grid", default="1,4x1,2",
                    help="'<k1>,<k2>x<d1>,<d2>' decode_steps_per_tick "
                         "x inflight_blocks values, full cross product")
    ws.add_argument("--max-batch", type=int, default=8)
    ws.add_argument("--num-pages", type=int, default=0,
                    help="KV page pool size (0 = full provisioning)")
    ws.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="arm SLO-aware admission shedding during the "
                         "sweep (sheds are counted per point)")

    # the port's static analysis (butterfly_tpu_torch/tools/staticcheck.py):
    # the lock/host-sync/determinism/generator contracts as AST rules —
    # the same walk the tier-1 test runs. Loads no model, touches no
    # device.
    li = sub.add_parser("lint",
                        help="AST lint for the port's serving contracts "
                             "(locks, host-sync, HTTP timeouts, "
                             "determinism, generator discipline); "
                             "exit 1 on any unsuppressed finding")
    li.add_argument("paths", nargs="*",
                    help="files/trees to lint (default: "
                         "butterfly_tpu_torch)")
    li.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog (id, slug, scope, "
                         "invariant) and exit")
    li.add_argument("--json", action="store_true",
                    help="machine-readable jsonl findings")
    li.add_argument("--show-suppressed", action="store_true",
                    help="also print suppressed findings")
    li.add_argument("--force", action="store_true",
                    help="ignore per-rule scopes (ad-hoc sweeps)")

    # timeseries dashboard renderer (tools/dashboard.py, stdlib): loads
    # no model and touches no device
    d = sub.add_parser("dash",
                       help="render a dumped /debug/timeseries or "
                            "/fleet/timeseries body as a static HTML "
                            "dashboard or --text sparklines")
    d.add_argument("dump", help="JSON file (the timeseries body)")
    d.add_argument("--out", default=None,
                   help="write HTML here (default: stdout)")
    d.add_argument("--text", action="store_true",
                   help="unicode sparklines for terminals instead of "
                        "HTML")
    return p


def resolve_model(args):
    from butterfly_tpu_torch.core.config import PRESETS, tiny
    from butterfly_tpu_torch.models.common import Model
    if args.model == "tiny":
        cfg = tiny("llama", dtype="float32", param_dtype="float32")
    else:
        cfg = PRESETS[args.model]()
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    if getattr(args, "expert_parallel", 1) > 1 and cfg.is_moe:
        # EP means the GShard all_to_all dispatch, not an expert-sharded
        # dense MoE where every expert still computes every token
        cfg = cfg.replace(moe_impl="ep")
    return Model(cfg, device=getattr(args, "device", None))


def load_params(model, args, mesh=None):
    """The weights on the model's device, in the compute dtype: loaded
    from --ckpt (ckpt/load.py:load_checkpoint, leaf by leaf), or random
    (demo mode). Random weights are drawn straight into the COMPUTE
    dtype: init_params draws float32 and rounds into the leaf type, so
    this is bit-identical to drawing in the float32 master dtype and
    casting — without ever holding the float32 copy (32 GB for
    Llama-3-8B). `--quant int8` quantizes every matmul weight as it is
    loaded or drawn, one layer at a time, so the compute-dtype tree is
    never held either (92.9 GB for Mixtral-8x7B, more than one card); the
    int8 demo weights are other random draws than the float ones.

    On a `mesh` whose expert axis crosses processes only this process's
    experts are read or kept (every expert is still drawn: the kept ones
    equal the whole draw's), placed on their devices
    (parallel/partition.py:place_held_experts)."""
    from butterfly_tpu_torch.parallel.partition import (held_expert_range,
                                                        place_held_experts)
    quant = getattr(args, "quant", "none") == "int8"
    experts = held_expert_range(model.cfg, mesh)
    if args.ckpt:
        from butterfly_tpu_torch.ckpt import load_checkpoint
        params = load_checkpoint(args.ckpt, model.cfg, model.device,
                                 quantize=quant, experts=experts)
    else:
        import torch
        cfg = model.cfg.replace(param_dtype=model.cfg.dtype)
        gen = torch.Generator(device=model.device)
        # btf: disable=BTF006 demo mode: no-ckpt random-init weights are deliberately identical across runs
        gen.manual_seed(0)
        if quant:
            from butterfly_tpu_torch.quant.int8 import init_params_quantized
            params = init_params_quantized(cfg, gen, model.device, experts)
        else:
            from butterfly_tpu_torch.models.common import init_params
            params = init_params(cfg, gen, model.device, experts=experts)
    return params if experts is None else place_held_experts(
        params, model.cfg, mesh)


def build_mesh(args):
    """Mesh from the CLI parallelism flags; None when all are 1.

    --device cuda takes cards cuda:0..n-1 and refuses n larger than the
    visible count; --device cpu takes n shards on the CPU. Every
    combination of the five axes builds (core/mesh.py).

    Several processes: with BUTTERFLY_NUM_PROCESSES set (and torchrun's
    MASTER_ADDR, MASTER_PORT and RANK) init_distributed runs first, and
    the mesh takes the first n of every process's devices
    (global_devices: n / P CPU devices a process of P with --device cpu,
    each process's visible cards with --device cuda); `--dcn-axes` are
    the axes that may span hosts (make_hybrid_mesh). Where they multiply
    to the process count each process counts as one slice, so those
    axes cross the processes and the others stay inside them (`--seq-
    parallel 2 --data-parallel 2 --dcn-axes seq`: data groups inside,
    seq across; `--expert-parallel 2 --tensor-parallel 2 --dcn-axes
    expert,tensor` over four processes: both across); otherwise the
    devices keep their hosts' slices. A mesh over several processes
    that core/mesh.py:check_process_mesh refuses (a data axis across
    them, a stage axis across beside tensor: the JAX package fails
    there) exits with its message."""
    import dataclasses

    from butterfly_tpu_torch.core.config import MESH_AXES, MeshConfig
    from butterfly_tpu_torch.core.mesh import (
        check_process_mesh, global_devices, init_distributed,
        make_hybrid_mesh, process_count)

    tp = getattr(args, "tensor_parallel", 1)
    pp = getattr(args, "stage_parallel", 1)
    ep = getattr(args, "expert_parallel", 1)
    dp = getattr(args, "data_parallel", 1)
    sq = getattr(args, "seq_parallel", 1)
    n = tp * pp * ep * dp * sq
    if n == 1:
        return None
    # the JAX CLI's message, checked before the single-slice fallback
    # that would never read the axes
    dcn = tuple(a for a in getattr(args, "dcn_axes", "data").split(",") if a)
    bad = [a for a in dcn if a not in MESH_AXES]
    if bad:
        raise SystemExit(f"error: unknown mesh axes {bad}")
    init_distributed()
    device = getattr(args, "device", "cuda")
    P = process_count()
    cfg = MeshConfig(data=dp, stage=pp, expert=ep, seq=sq, tensor=tp)
    if device == "cpu" and P == 1:
        devices = ["cpu"] * n
    else:
        devices = global_devices(device, per_process=max(1, n // P))
        if n > len(devices):
            raise SystemExit(
                f"error: --tensor-parallel {tp} x --stage-parallel {pp} x "
                f"--expert-parallel {ep} x --data-parallel {dp} x "
                f"--seq-parallel {sq} = {n} devices, "
                f"but only {len(devices)} are available")
        devices = devices[:n]
        sizes = dict(zip(MESH_AXES, cfg.axis_sizes))
        if P > 1 and math.prod(sizes[a] for a in dcn) == P:
            devices = [dataclasses.replace(d, slice_index=d.process_index)
                       for d in devices]
    try:
        mesh = make_hybrid_mesh(cfg, devices, dcn_axes=dcn)
        check_process_mesh(mesh)
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"error: {e}")
    return mesh


def shard_for_mesh(params, cfg, mesh):
    """The tree placed over the mesh (parallel/partition.py:shard_params:
    the expert leaves split over an expert axis, the Megatron split over
    a tensor axis, int8 leaves alike); the tree itself without a mesh."""
    if mesh is None:
        return params
    from butterfly_tpu_torch.parallel.partition import shard_params
    return shard_params(params, cfg, mesh)


def cmd_generate(args) -> int:
    """One-shot generation: the text on stdout, then the token count and
    rate on stderr, as the JAX CLI prints them."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.utils.tokenizer import load_tokenizer

    if args.seq_parallel > 1 and args.speculate > 0:
        print("error: --speculate does not compose with --seq-parallel "
              "(the long-context path has no warm multi-token verify)",
              file=sys.stderr)
        return 2
    model = resolve_model(args)
    tok = load_tokenizer(args.tokenizer or args.ckpt)
    mesh = build_mesh(args)
    engine = InferenceEngine(
        model, shard_for_mesh(load_params(model, args, mesh), model.cfg,
                              mesh),
        runtime=RuntimeConfig(max_seq_len=args.max_seq,
                              kv_quant=args.kv_quant),
        mesh=mesh)
    vocab = model.cfg.vocab_size
    stop = tok.eos_id if tok.eos_id is not None and tok.eos_id < vocab else -1
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, max_new_tokens=args.max_new,
                        stop_token=stop)
    ids = tok.encode(args.prompt)
    bad = [i for i in ids if i >= vocab]
    if bad:
        print(f"error: tokenizer produced ids {bad[:5]} outside the model's "
              f"vocab ({vocab}); pass a matching --tokenizer", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    if args.seq_parallel > 1:
        # the long-context path: sp_forward prefill + sp_decode_step loop
        # (engine.generate_long); --kv-quant int8 composes
        res = engine.generate_long(ids, sp, seed=args.seed,
                                   impl=args.seq_impl)
        dt = time.perf_counter() - t0
        n = int(res.lengths[0])
        print(tok.decode(res.tokens[0, :n].tolist()))
        print(f"[butterfly] {n} tokens in {dt:.2f}s over "
              f"{args.seq_parallel}-way sequence parallelism",
              file=sys.stderr)
        return 0
    if args.speculate > 0:
        res = engine.generate_speculative(ids, sp, gamma=args.speculate,
                                          seed=args.seed)
        dt = time.perf_counter() - t0
        print(tok.decode(res.tokens.tolist()))
        print(f"[butterfly] {len(res.tokens)} tokens in {dt:.2f}s via "
              f"{res.forwards} forwards ({res.tokens_per_forward:.2f} "
              f"tok/forward, {res.accepted_drafts} drafts accepted)",
              file=sys.stderr)
        return 0
    res = engine.generate([ids], sp, seed=args.seed)
    dt = time.perf_counter() - t0
    n = int(res.lengths[0])
    print(tok.decode(res.tokens[0, :n].tolist()))
    print(f"[butterfly] {n} tokens in {dt:.2f}s "
          f"({n / dt:.1f} tok/s incl. compile)", file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    if getattr(args, "seq_parallel_threshold", 0) > 0 \
            and args.seq_parallel <= 1:
        print("error: --seq-parallel-threshold needs a seq axis — pass "
              "--seq-parallel N (> 1) to shard long prompts over N "
              "devices", file=sys.stderr)
        return 2
    from butterfly_tpu_torch.serve.server import run_server
    return run_server(args)


def cmd_bench(args) -> int:
    """The benchmark legs (obs/benchmark.py) on one engine's weights: one
    JSON line on stdout, its metric decode tokens/s per card."""
    import json

    from butterfly_tpu_torch.obs.benchmark import (run_decode_benchmark,
                                                   run_longctx_benchmark,
                                                   run_mixed_benchmark,
                                                   run_serving_benchmark,
                                                   run_spec_benchmark)
    model = resolve_model(args)
    mesh = build_mesh(args)
    # the decode leg runs on the mesh; the serving legs are single-engine
    # (as in the JAX CLI) on the same weights, unsharded: where the shards
    # share the tree's device the sharded leaves are views of these
    params = load_params(model, args)
    stats = run_decode_benchmark(model,
                                 shard_for_mesh(params, model.cfg, mesh),
                                 batch=args.batch,
                                 prompt_len=args.prompt_len,
                                 max_new=args.max_new, mesh=mesh,
                                 kv_quant=args.kv_quant)
    serving_batch = args.max_batch or args.batch
    if args.serving:
        # the serving legs are single-engine, as in the JAX CLI
        stats.update(run_serving_benchmark(
            model, params, n_requests=2 * serving_batch,
            prompt_len=args.prompt_len, max_new=args.max_new,
            max_batch=serving_batch, kv_quant=args.kv_quant,
            inflight_blocks=args.inflight_blocks,
            isolated_decode_tok_s_chip=stats[
                "decode_tokens_per_sec_per_chip"]))
        if mesh is None:
            # builds its own seq = 4 mesh when the card count allows; with
            # fewer cards it reports longctx_supported: false plus the
            # ring microbench pair
            stats.update(run_longctx_benchmark(
                model, params, kv_quant=args.kv_quant))
    if args.mixed:
        stats.update(run_mixed_benchmark(
            model, params, n_requests=2 * serving_batch,
            max_batch=serving_batch,
            prompt_lo=max(8, args.prompt_len // 4),
            prompt_hi=args.prompt_len,
            max_new_lo=max(4, args.max_new // 4),
            max_new_hi=args.max_new,
            inflight_blocks=args.inflight_blocks,
            host_kv_tier_mb=args.host_tier_mb,
            kv_quant=args.kv_quant))
    if args.spec:
        stats.update(run_spec_benchmark(
            model, params, n_requests=serving_batch,
            prompt_len=args.prompt_len, max_new=args.max_new,
            max_batch=serving_batch, inflight_blocks=args.inflight_blocks,
            kv_quant=args.kv_quant))
    print(json.dumps({"metric": "decode_tokens_per_sec_per_chip",
                      "value": stats["decode_tokens_per_sec_per_chip"],
                      "unit": "tokens/sec/chip", **stats}))
    return 0


def cmd_route(args) -> int:
    backends = [b for b in args.backends.split(",") if b.strip()]
    if args.disaggregate:
        from butterfly_tpu_torch.fleet.controlplane import fleet_forever
        return fleet_forever(backends, host=args.host, port=args.port,
                             page_size=args.page_size,
                             affinity_blocks=args.affinity_blocks,
                             saturate_after=args.saturate_after,
                             probe_interval=args.probe_interval,
                             dead_after=args.dead_after,
                             read_timeout=args.read_timeout,
                             disagg_threshold=args.disagg_threshold,
                             slo_ttft_s=(args.slo_ttft_ms / 1e3
                                         if args.slo_ttft_ms else None),
                             slo_itl_s=(args.slo_itl_ms / 1e3
                                        if args.slo_itl_ms else None))
    if args.slo_ttft_ms or args.slo_itl_ms:
        print("[butterfly] note: --slo-ttft-ms/--slo-itl-ms apply to "
              "the control plane (--disaggregate) and to the replicas' "
              "own `serve` flags; the plain router records no SLO",
              file=sys.stderr)
    from butterfly_tpu_torch.router.proxy import route_forever
    return route_forever(backends, host=args.host, port=args.port,
                         page_size=args.page_size,
                         affinity_blocks=args.affinity_blocks,
                         saturate_after=args.saturate_after,
                         probe_interval=args.probe_interval,
                         dead_after=args.dead_after,
                         read_timeout=args.read_timeout)


def cmd_fleet(args) -> int:
    """`butterfly fleet`: the in-process fleet topology on --device,
    held open for manual poking (curl the printed control-plane URL)."""
    import threading

    from butterfly_tpu_torch.fleet.harness import parse_topology, start_fleet

    chaos = None
    if args.chaos:
        from butterfly_tpu_torch.fleet.chaos import ChaosPlan, default_plan
        chaos = default_plan() if args.chaos == "default" \
            else ChaosPlan.from_file(args.chaos)
        print(f"[butterfly] chaos plan armed: {len(chaos.rules)} rules, "
              f"seed {chaos.seed}", flush=True)
    print(f"[butterfly] starting local fleet {args.topology} on "
          f"{args.device} (tiny model, warming each replica)...",
          flush=True)
    fleet = start_fleet(args.topology, page_size=args.page_size,
                        max_batch=args.max_batch, max_seq=args.max_seq,
                        disagg_threshold=args.disagg_threshold,
                        chaos=chaos, host_kv_tier_mb=args.host_tier_mb,
                        host_kv_tier_dir=args.host_tier_dir,
                        slo_ttft_s=(args.slo_ttft_ms / 1e3
                                    if args.slo_ttft_ms else None),
                        slo_itl_s=(args.slo_itl_ms / 1e3
                                   if args.slo_itl_ms else None),
                        device=args.device)
    scaler = None
    if args.autoscale:
        from butterfly_tpu_torch.fleet.autoscale import (Autoscaler,
                                                         TierPolicy)
        policies = [TierPolicy(role, min_replicas=args.scale_min,
                               max_replicas=args.scale_max,
                               high=args.scale_high, low=args.scale_low)
                    for role in dict.fromkeys(parse_topology(args.topology))]
        scaler = Autoscaler(fleet.state, fleet.spawn, fleet.retire,
                            policies, interval_s=1.0)
        scaler.start()
        print(f"[butterfly] autoscaler live on "
              f"{[p.role for p in policies]} "
              f"(bounds {args.scale_min}..{args.scale_max}, band "
              f"{args.scale_low}..{args.scale_high}; decisions at "
              f"GET /debug/flightrecorder)", flush=True)
    print(f"[butterfly] control plane: {fleet.url}  "
          f"(GET /fleet/state, POST /generate)", flush=True)
    for r in fleet.replicas:
        print(f"[butterfly]   replica {r.rid}  role={r.role}", flush=True)
    print("[butterfly] Ctrl-C to stop", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        if scaler is not None:
            scaler.stop()
        fleet.stop()
    return 0


def cmd_workload(args) -> int:
    """`butterfly workload generate|replay|sweep`: generate and replay
    are stdlib (no engine, no device); sweep builds an in-process engine
    on --device."""
    import json

    from butterfly_tpu_torch.workload import (assign_arrivals, get_workload,
                                              parse_arrival)
    from butterfly_tpu_torch.workload import replay as replay_mod

    if args.wcmd == "generate":
        wl = get_workload(args.workload, page_size=args.page_size,
                          vocab=args.vocab, prompt_lo=args.prompt_lo,
                          prompt_hi=args.prompt_hi,
                          max_new_lo=args.max_new_lo,
                          max_new_hi=args.max_new_hi,
                          deadline_ms=args.deadline_ms)
        specs = wl.sample(args.n, args.seed)
        assign_arrivals(specs, parse_arrival(args.arrival), args.seed)
        replay_mod.save_trace(args.out, specs, workload=wl,
                              arrival=args.arrival, seed=args.seed)
        cohorts = {}
        for s in specs:
            cohorts[s.cohort] = cohorts.get(s.cohort, 0) + 1
        print(json.dumps({
            "trace": str(args.out), "workload": wl.name, "n": len(specs),
            "seed": args.seed, "arrival": args.arrival,
            "cohorts": cohorts,
            "prompt_tokens": sum(len(s.tokens) for s in specs),
            "max_new_tokens": sum(s.max_new for s in specs),
            "span_s": round(specs[-1].arrival_s, 3) if specs else 0.0}))
        return 0
    if args.wcmd == "replay":
        _, specs = replay_mod.load_trace(args.trace)
        stats = replay_mod.replay_trace(
            args.url, specs, speed=args.speed, timeout=args.timeout,
            slo_ttft_ms=args.slo_ttft_ms, slo_itl_ms=args.slo_itl_ms)
        print(json.dumps(stats, indent=2))
        # sheds / 504s are requested backpressure; only transport
        # errors and 5xx faults fail the replay
        return 0 if stats["outcomes"]["error"] == 0 else 1
    from butterfly_tpu_torch.core.config import PRESETS, tiny
    from butterfly_tpu_torch.models.common import Model
    from butterfly_tpu_torch.workload.sweep import (parse_grid,
                                                    run_operating_point_sweep)
    cfg = tiny("llama", dtype="float32", param_dtype="float32") \
        if args.model == "tiny" else PRESETS[args.model]()
    model = Model(cfg, device=args.device)
    params = load_params(model, args)
    # the sweep drives a real engine, so the workload's vocabulary is
    # the MODEL's (--vocab applies to `generate`, whose trace may
    # target any server)
    wl = get_workload(args.workload, page_size=args.page_size,
                      vocab=model.cfg.vocab_size,
                      prompt_lo=args.prompt_lo, prompt_hi=args.prompt_hi,
                      max_new_lo=args.max_new_lo,
                      max_new_hi=args.max_new_hi,
                      deadline_ms=args.deadline_ms)
    out = run_operating_point_sweep(
        model, params, workload=wl, arrival=args.arrival,
        n_requests=args.n, grid=parse_grid(args.grid),
        max_batch=args.max_batch, num_pages=args.num_pages,
        kv_quant=args.kv_quant, slo_ttft_ms=args.slo_ttft_ms,
        seed=args.seed)
    print(json.dumps(out, indent=2))
    return 0


def cmd_lint(args) -> int:
    """`butterfly lint`: the port's static analyzer
    (butterfly_tpu_torch/tools/staticcheck.py) over butterfly_tpu_torch/
    by default, with the port's rules."""
    from butterfly_tpu_torch.tools import staticcheck
    argv = list(args.paths)
    if args.list_rules:
        argv.append("--list-rules")
    if args.json:
        argv.append("--json")
    if args.show_suppressed:
        argv.append("--show-suppressed")
    if args.force:
        argv.append("--force")
    return staticcheck.main(argv)


def cmd_dash(args) -> int:
    """`butterfly dash`: the stdlib timeseries dashboard renderer, the
    repo's tools/dashboard.py loaded by path (it is not part of either
    package, so this needs a source checkout)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[2] / "tools" / "dashboard.py"
    if not path.exists():
        print("error: butterfly dash needs the repo's tools/dashboard.py "
              "(run from a source checkout)", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("butterfly_dashboard",
                                                  path)
    dashboard = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dashboard)
    argv = [args.dump]
    if args.out:
        argv += ["--out", args.out]
    if args.text:
        argv.append("--text")
    return dashboard.main(argv)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"generate": cmd_generate, "serve": cmd_serve,
            "bench": cmd_bench, "route": cmd_route, "fleet": cmd_fleet,
            "workload": cmd_workload, "lint": cmd_lint,
            "dash": cmd_dash}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
