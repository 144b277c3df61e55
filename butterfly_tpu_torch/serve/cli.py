"""`butterfly generate` and `butterfly serve` on the PyTorch/CUDA port.

    python -m butterfly_tpu_torch.serve.cli generate --model llama3-8b --prompt "hello" --max-new 32
    python -m butterfly_tpu_torch.serve.cli generate --model tiny --device cpu
    python -m butterfly_tpu_torch.serve.cli generate --model tiny --device cpu --seq-parallel 2
    python -m butterfly_tpu_torch.serve.cli serve --model llama3-8b --port 8000
    python -m butterfly_tpu_torch.serve.cli serve --model tiny --device cpu
    python -m butterfly_tpu_torch.serve.cli serve --model tiny --device cpu --seq-parallel 2 --seq-parallel-threshold 256

Both subcommands keep the JAX CLI's flags (butterfly_tpu/serve/cli.py) and
add --device (default cuda). `--seq-parallel N` builds a seq mesh of N
shards: on cuda:0..N-1 with --device cuda (N cards needed), on the CPU with
--device cpu. Flags whose path the port does not carry yet are accepted
and refused with NotImplementedError naming the ROADMAP.md item. Without
--ckpt, weights are random (demo mode).
"""
from __future__ import annotations

import argparse
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

    def common(sp):
        sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where the engine runs (default cuda; without "
                             "a card, pass cpu explicitly)")
        sp.add_argument("--model", default="tiny",
                        help="preset name (gpt2-124m, llama3-8b, "
                             "llama3-70b, mixtral-8x7b) or 'tiny'")
        sp.add_argument("--ckpt", default=None, help="checkpoint path")
        sp.add_argument("--tokenizer", default=None)
        sp.add_argument("--dtype", default=None,
                        help="override compute dtype")
        for flag in ("--tensor-parallel", "--stage-parallel",
                     "--expert-parallel", "--data-parallel"):
            sp.add_argument(flag, type=int, default=1,
                            help="(not ported yet)")
        sp.add_argument("--seq-parallel", type=int, default=1,
                        help="shard long prompts over N devices (ring "
                             "attention / Ulysses); --device cuda needs N "
                             "cards")
        sp.add_argument("--seq-impl", choices=["ring", "ulysses"],
                        default="ring",
                        help="attention across the seq shards (generate)")
        sp.add_argument("--max-seq", type=int, default=2048)
        sp.add_argument("--dcn-axes", default="data")
        sp.add_argument("--quant", choices=["none", "int8"], default="none",
                        help="weight-only quantization (not ported yet)")
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
                   help="prompt-lookup speculative decoding (not ported "
                        "yet)")

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
                   help="prefix caching (not ported yet)")
    s.add_argument("--host-tier-mb", type=float, default=0.0,
                   help="host-RAM KV tier (not ported yet)")
    s.add_argument("--host-tier-dir", default=None, metavar="DIR")
    s.add_argument("--speculate", type=int, default=0, metavar="GAMMA",
                   help="speculative serving (not ported yet)")
    s.add_argument("--draft-source", default="ngram")
    s.add_argument("--draft-layers", type=int, default=0)
    s.add_argument("--draft-ckpt", default=None)
    s.add_argument("--spec-tree", type=int, default=0, metavar="WIDTH")
    s.add_argument("--spec-tree-nodes", type=int, default=0, metavar="N")
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
    s.add_argument("--slo-ttft-ms", type=float, default=None,
                   help="declared time-to-first-token objective (ms)")
    s.add_argument("--slo-itl-ms", type=float, default=None,
                   help="declared mean inter-token-latency objective (ms)")
    s.add_argument("--profiler-port", type=int, default=0,
                   help="profiler server (not ported yet; 0 = off)")
    s.add_argument("--flightrec-dir", default=None, metavar="DIR",
                   help="write flight-recorder post-mortems here")
    s.add_argument("--inflight-blocks", type=_positive_int, default=2,
                   help="blocks kept in flight on the device "
                        "(dispatch-ahead)")
    s.add_argument("--timeseries-interval", type=float, default=1.0,
                   metavar="SECONDS",
                   help="GET /debug/timeseries sampling interval; 0 = off")
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
    return Model(cfg, device=getattr(args, "device", None))


def load_params(model, args):
    """Random-init weights on the model's device (checkpoints wait for
    their slice). The tree is drawn straight into the COMPUTE dtype:
    init_params draws float32 and rounds into the leaf type, so this is
    bit-identical to drawing in the float32 master dtype and casting —
    without ever holding the float32 copy (32 GB for Llama-3-8B)."""
    if args.ckpt:
        raise NotImplementedError(
            "--ckpt is not ported yet (ROADMAP.md, PyTorch/CUDA port "
            "queue: checkpoints)")
    from butterfly_tpu_torch.models.common import init_params
    import torch
    cfg = model.cfg.replace(param_dtype=model.cfg.dtype)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)  # demo mode: identical random weights every run
    return init_params(cfg, gen, model.device)


def build_mesh(args):
    """Mesh from the CLI parallelism flags; None when all are 1.

    --device cuda takes cards cuda:0..n-1 and refuses n larger than the
    visible count; --device cpu takes n shards on the CPU. Only the seq
    axis is ported: the other flags > 1 raise NotImplementedError
    (core/mesh.py)."""
    import torch

    from butterfly_tpu_torch.core.config import MeshConfig
    from butterfly_tpu_torch.core.mesh import make_mesh

    tp = getattr(args, "tensor_parallel", 1)
    pp = getattr(args, "stage_parallel", 1)
    ep = getattr(args, "expert_parallel", 1)
    dp = getattr(args, "data_parallel", 1)
    sq = getattr(args, "seq_parallel", 1)
    n = tp * pp * ep * dp * sq
    if n == 1:
        return None
    cfg = MeshConfig(data=dp, stage=pp, expert=ep, seq=sq, tensor=tp)
    if getattr(args, "device", "cuda") == "cpu":
        return make_mesh(cfg, ["cpu"] * n)
    ndev = torch.cuda.device_count()
    if n > ndev:
        raise SystemExit(
            f"error: --tensor-parallel {tp} x --stage-parallel {pp} x "
            f"--expert-parallel {ep} x --data-parallel {dp} x "
            f"--seq-parallel {sq} = {n} devices, "
            f"but only {ndev} are available")
    return make_mesh(cfg, [f"cuda:{i}" for i in range(n)])


def cmd_generate(args) -> int:
    """One-shot generation: the text on stdout, then the token count and
    rate on stderr, as the JAX CLI prints them."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.engine import InferenceEngine, not_ported
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.utils.tokenizer import load_tokenizer

    if args.seq_parallel > 1 and args.speculate > 0:
        print("error: --speculate does not compose with --seq-parallel "
              "(the long-context path has no warm multi-token verify)",
              file=sys.stderr)
        return 2
    if args.speculate > 0:
        raise not_ported("generate --speculate", "speculation")
    if args.quant != "none":
        raise not_ported("--quant int8 weights", "int8 weights")
    model = resolve_model(args)
    tok = load_tokenizer(args.tokenizer or args.ckpt)
    mesh = build_mesh(args)
    engine = InferenceEngine(
        model, load_params(model, args),
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"generate": cmd_generate, "serve": cmd_serve}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
