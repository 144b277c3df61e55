"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, all run every time, each printing labelled lines; any failure
raises and the script exits non-zero:

1. device    the card's name and power limit (nvidia-smi); every number
             below belongs to this card.
2. build     compiles every CUDA kernel from the sources in this checkout,
             one nvcc per source, all started together; prints ptxas'
             registers, spills and static shared memory for every kernel
             instantiation, by name; then the native page allocator
             (native/allocator.cc, g++), which must load.
3. kernel    the paged-attention kernel (split-KV + merge) against its
             plain PyTorch version and the plain version of its split
             decomposition at Llama-3-8B main-path shapes (S=8, Nq=32, Kv=8,
             H=128, page=16, max_pages=128, ragged lengths incl.
             0/1/17/2048): bf16 pool without and with the window (W=2,
             W=64), all 8 slots at 2048 tokens, int8 pool with the window,
             f32 pool. Tolerances: max abs error bf16 2e-2, f32 1e-4 (TF32
             off); per slot, max abs error over the slot's max |output|
             bf16 1e-2, f32 1e-4, so a long slot's small outputs are held
             too; a slot with nothing to attend must give exactly 0; a
             second launch must give the same bits (no atomics).
             Times: kernel (CUDA events, median, L2 flushed before each
             launch as a decode step finds it, the device kept busy while
             the host enqueues, see _time_ms), plain version, the bound
             (bytes moved / the card's memory bandwidth, or operations /
             peak, whichever is larger), and scaled_dot_product_attention
             over the pre-gathered dense K/V as a yardstick that excludes
             the page walk.
4. flash     the two flash kernels against their plain version at
             Llama-3-8B shapes (Nq=32, Kv=8, H=128): fresh B=4, T=1024 bf16
             causal, ragged T=1000, non-causal, GPT-2 heads (Nq=Kv=12,
             H=64), f32 T=256; warm B=4, T=512
             over a 2048-row prefix with prefix_len 0/17/512/1536 (rows
             past it hold large garbage), bf16 float prefix and int8
             prefix, f32 float prefix at T=256. bf16 runs the tensor-core
             kernel, f32 the CUDA-core one. Tolerances: bf16 2e-2
             absolute; per (batch row, 64-row query tile, head), max
             error over max |ref| 1e-2; and every element within
             2**-7 * (|ref| + sum_j p_j |v_j| / l), the output's rounding
             on both sides plus that of probabilities rounded to bf16.
             f32 1e-4 absolute and per tile. bf16 at H = 64 and 128 runs
             the wgmma kernels, fresh and warm. A second launch must give
             the same bits.
             Times as above; the yardstick is scaled_dot_product_attention
             (is_causal, enable_gqa) for the fresh kernel and, for the warm
             one, the same call over [live prefix ‖ chunk] with an explicit
             mask and K/V concatenated beforehand.
5. ring      the ring-attention kernels' partial stats (m, l, acc) against
             their plain version at Llama-3-8B shapes (Nq=32, Kv=8,
             H=128), bf16 on the tensor cores (T > 1 on the wgmma kernel):
             the diagonal ring block of a 4096-token prompt on 2 shards
             (T=S=2048), an earlier block (every key live), a later block
             (every key masked: exactly m=-1e30, l=0, acc=0), a ragged
             block with INVALID_POS keys over large garbage, int8 codes +
             scales; one decode token against 2048 keys (the T = 1 split
             kernel): bf16, int8, f32, and 4 batch rows at different
             positions (the split plain version too); f32 on the CUDA
             cores at T=256; the tiny preset's heads (Nq=4, Kv=2, H=16)
             on the CUDA-core routes in bf16 and f32, T=1024 and T = 1;
             f16 on the tensor-core routes (the diagonal block and a
             decode token). Tolerances (f16 as bf16): m 1e-3 absolute, l 2**-7
             relative, the finalised acc/l per element within the flash
             phase's bound and per 64-row tile 1e-2; f32 1e-4. A second
             launch must give the same bits. Times as above; the
             yardstick is scaled_dot_product_attention with the boolean
             position mask (enable_gqa), which returns the normalised
             output, not the stats.
6. serve     `butterfly serve` machinery (serve/server.build_serving) on
             full-width, full-depth Llama-3-8B with random bf16 weights
             and the CLI's serve defaults (mixed dispatch), in a thread on
             127.0.0.1; 8 concurrent greedy /generate requests (prompts of
             16-1200 bytes, 32-64 new tokens) so prefill lanes and decode
             steps share ticks. Kernel launch counts are zeroed just before
             and read just after; the paged kernel must have launched, a
             multiple of 32 times (one launch per layer per decode step).
             The scheduler must run on the native page allocator.
             These weights are built once; every later engine shares them.
7. parity    on the same engine, one decode step through all layers with
             equal carries, bf16: each layer's kernel output against the
             plain version on the same inputs (2e-2 absolute), and the
             step's logits with the kernel against the same step with the
             plain version (0.5 absolute).
8. profile   where one decode step's time goes: host wall vs device busy
             time (torch.profiler), the paged kernels' share (split +
             merge) and the top kernels by device time.
9. generate  InferenceEngine.generate on the same model: four greedy
             prompts of 16-1000 bytes, 32 new tokens, fused, then the same
             stepped (tokens must be equal), then int8 KV (the
             write-combined window loop), then one call of the CLI's
             `generate`. The fresh flash kernel must launch 32 times per
             prefill call, the warm one never. Tokens/s and prefill time.
10. alternate the alternating serving path: ServingEngine(mixed_dispatch=
             False) + Scheduler, 8 concurrent greedy requests with prompts
             up to 1200 bytes, so 512-token chunks continue warm. The
             fresh, warm and paged kernels must each launch, a multiple
             of 32 times. Tokens/s and TTFT (a smoke run, not a benchmark).
11. flashpar on that engine, one fresh 512-token prefill and one warm
             chunk after it through all 32 layers: every layer's flash
             output against the plain version on the same inputs, each
             element within the flash phase's bound (one bf16 ulp scaled
             to the output), and each pass's last-token logits against
             the all-plain pass (0.5 absolute).
12. longgen  InferenceEngine.generate_long over a seq = 2 mesh (one shard
             per card with two cards, else both on cuda:0; printed) on the
             shared weights: a 4096-token prompt, 32 greedy new tokens,
             ring with bf16 KV, ring with int8 KV, Ulysses. The ring
             kernel's launches must be exact per route (N*N per layer for
             the prefill, on the wgmma kernel; N + 1 per layer per decode
             step, on the T = 1 split kernel); the prefill's last-position
             logits within 0.5 of the dense flash prefill (int8: of the
             same prefill with the plain ring version). Tokens/s and the
             prefill time; under the profiler, the long prefill's ring
             share and the decode steps' ring time per token.
13. ringpar  one sp_forward of that prompt: every ring block's kernel stats,
             finalised, against the plain version on the same inputs
             within the ring phase's element bound; the logits against the
             all-plain pass within 0.5.
14. longserve ServingEngine(seq = 2, seq_parallel_threshold=1024,
             max_seq_len=4096) + Scheduler, mixed dispatch: 2 long prompts
             (3000 and 4000 bytes) and 4 short ones, greedy. The lane must
             prefill tokens; ring (all T > 1: the wgmma kernel) and paged
             launches multiples of 32; every request finishes. Tokens/s
             and TTFT.
15. quant    int8 weights (quant/int8.py) on the shared weights:
             quantize_int8 and the int8 tree's bytes (codes held as
             int8); one prefill + decode step's logits against the same
             step on the maybe_dequant bf16 tree (0.5 absolute, the
             parity phase's bar); generate (4 greedy prompts of 16-1000
             bytes, 32 new tokens, fused then stepped: equal tokens, the
             fresh flash kernel 32 times per prefill); 8 concurrent
             greedy requests through serve/server.build_serving with
             --quant int8 (paged launches a multiple of 32); one decode
             step's host wall and device busy time and decode tok/s,
             int8 and bf16 weights.
16. spec     speculation (ServingEngine + Scheduler) on the shared bf16
             weights, 8 greedy requests on draft-friendly prompts (32
             tokens: 8 random + the model's own greedy continuation, as
             run_spec_benchmark builds them), 32 new tokens: (a) ngram,
             gamma 4, the serve defaults (mixed dispatch, window on),
             and the same block with an oracle draft function
             registered through register_draft_source, which proposes
             the spec-off run's tokens: random weights never repeat
             themselves, so prompt lookup finds nothing to accept and
             the oracle drives the accept path;
             (b) the 8-layer draft model (the alternating fallback:
             fresh / warm flash launches multiples of 32); (c) a width-2,
             5-node token tree with that draft; (d) generate_speculative
             on one prompt; (e) (a) at temperature 0.8, which must
             finish. For (a)-(d) every request finishes, verify forwards
             happen, the oracle run accepts drafts, and a teacher-forced
             check: in
             one plain forward of prompt + output, every emitted token's
             logit is within 0.5 of that position's maximum. Prints
             tokens per forward, acceptance rate, tok/s and, against the
             spec-off run, the requests with equal tokens and the first
             divergence of the others (bf16 verify and decode take
             different attention paths, so near-ties may flip).
17. fleet    `butterfly fleet` at full width and depth: the native
             allocator is built in phase 2 (the serve phase runs on it;
             fleet replicas run the prefix-caching allocator, whose
             registry KV transfer addresses); fleet/harness.start_fleet(
             "2p2d") on the shared bf16 weights (one tree: the memory
             rise at start must stay under 8 GiB), page 16, 4 slots of
             1024 tokens, threshold 64, behind the control plane. 8
             greedy requests of 384 tokens (half share a 256-token head),
             32 new, from 4 client threads: a direct run (threshold
             10**9), then the disaggregated run (prefill leg, GET
             /kv/pages, POST /kv/import, decode leg), where every request
             must be disaggregated and pages transferred; per request the
             first divergence from the direct run (bf16 near-ties may
             flip) and a teacher-forced check (every emitted token's
             logit within 0.5 of its position's maximum in one plain
             forward). Then an export -> import -> export of a fresh
             prompt's pages (identical page bytes), a drained restart of
             one decode replica under load (nothing dropped), spawn and
             retire of a decode replica (memory back within one pool).
             Prints the legs' median seconds (control-plane tracer),
             TTFT p50/p95 of both runs, transfer bytes, the payload's
             raw and JSON bytes and each replica's tick host share; the
             paged kernel must launch.
18. bench    the benchmark legs (obs/benchmark.py) on the same weights,
             sized by request counts: decode (batch 8, prompt 128, 64
             new: tokens/s per card, hbm_util, mfu against the card's
             datasheet row), serving (16 requests, 128 + 32 tokens, 8
             slots, int8 pool; TTFT/ITL; its _alt leg on the flash
             kernels), warm prefill (6 x 640-token prompts in 256-token
             chunks, warm flash kernel vs the dense gather, one repeat:
             the smoke keeps near half its time limit), long context
             (the ring microbench pair; the serving lane needs 4 cards),
             mixed (12 mixed_chat requests in one burst on a starved pool
             of 8-token pages with prefix caching and a 512 MiB host KV
             tier, the 2x2 operating-point sweep, the _alt leg), decode
             once more on the int8 tree, speculation (spec on vs off on
             draft-friendly prompts, then the ngram, 1-layer model and
             width-2 tree rows on mixed_chat prompts; verify forwards
             must happen), the fleet (nothing dropped through the
             rolling restart, pages transferred), chaos (every request
             terminal, faults injected) and autoscale (a scale-up in the
             flight recorder) legs at their JAX defaults on tiny-model
             fleets; then `butterfly bench --model tiny
             --device cuda --serving`. Each leg's JSON on a labelled line
             with its wall seconds. Prefix hits, preemptions and tier
             revivals must be > 0, the ring microbench kernelized, and
             each of the four kernels must launch.

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without CUDA the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))



def log(label: str, **kv) -> None:
    print(f"[{label}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def figures(name: str):
    """(memory bandwidth bytes/s, dense peak op/s by type) of the card
    called `name`, from the port's datasheet table
    (butterfly_tpu_torch/obs/benchmark.py: CARDS); every bound below is
    taken against it. A card not in the table has no bound: raise."""
    from butterfly_tpu_torch.obs.benchmark import card_figures
    fig = card_figures(name)
    if fig is None:
        raise RuntimeError(f"no datasheet figures for {name!r} "
                           f"(obs/benchmark.py CARDS)")
    return fig


# -- phase 3: the kernel against its plain version ---------------------------

def _kernel_case(torch, pa, S, Nq, Kv, H, page, mp, lengths, dtype, quant,
                 W, gen):
    dev = "cuda"
    P = S * mp + 1
    q = torch.randn((S, Nq, H), generator=gen, device=dev).to(dtype)
    if quant:
        kp = torch.randint(-127, 128, (P, Kv, page, H), generator=gen,
                           device=dev, dtype=torch.int8)
        vp = torch.randint(-127, 128, (P, Kv, page, H), generator=gen,
                           device=dev, dtype=torch.int8)
        ks = torch.rand((P, Kv * page), generator=gen, device=dev) * 0.02
        vs = torch.rand((P, Kv * page), generator=gen, device=dev) * 0.02
    else:
        kp = torch.randn((P, Kv, page, H), generator=gen, device=dev) \
            .to(dtype)
        vp = torch.randn((P, Kv, page, H), generator=gen, device=dev) \
            .to(dtype)
        ks = vs = None
    # each slot owns a random set of distinct pages; the rest of its row
    # points at the null page (P - 1)
    perm = torch.randperm(P - 1, generator=gen, device=dev).to(torch.int32)
    table = torch.full((S, mp), P - 1, dtype=torch.int32, device=dev)
    for s in range(S):
        n = -(-lengths[s] // page)
        table[s, :n] = perm[s * mp:s * mp + n]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    win = {}
    wc_host = [0] * S
    if W:
        pool_dt = torch.int8 if quant else dtype
        shape = (S, Kv, W, H)
        if quant:
            win["win_k"] = torch.randint(-127, 128, shape, generator=gen,
                                         device=dev, dtype=pool_dt)
            win["win_v"] = torch.randint(-127, 128, shape, generator=gen,
                                         device=dev, dtype=pool_dt)
            win["win_k_scale"] = torch.rand(shape[:-1], generator=gen,
                                            device=dev) * 0.02
            win["win_v_scale"] = torch.rand(shape[:-1], generator=gen,
                                            device=dev) * 0.02
        else:
            win["win_k"] = torch.randn(shape, generator=gen,
                                       device=dev).to(pool_dt)
            win["win_v"] = torch.randn(shape, generator=gen,
                                       device=dev).to(pool_dt)
        # slot 0 is empty (lengths 0, win_count 0); the others stage a
        # ragged run up to the full width
        wc_host = [0] + [1 + (7 * s) % W for s in range(1, S)]
        win["win_count"] = torch.tensor(wc_host, dtype=torch.int32,
                                        device=dev)
    args = (q, kp, vp, table, lens, ks, vs)
    return args, win, wc_host


def _bytes_ops(args, win, lengths, wc, Nq, Kv, H, page, quant):
    """Bytes the function must move (each input byte it needs read once,
    the output written once) and the operations it does, for THIS data:
    the live tokens' K/V (+ scales), the table entries it walks, q, out."""
    q = args[0]
    el = 1 if quant else q.element_size()
    tok = sum(lengths) + sum(wc)
    kv_bytes = tok * Kv * H * el * 2
    scale_bytes = tok * Kv * 4 * 2 if quant else 0
    table_bytes = sum(-(-n // page) for n in lengths) * 4
    qo = q.numel() * q.element_size() * 2
    small = len(lengths) * 4 * (2 if win else 1)
    ops = tok * Nq * H * 4  # q.k and p.v, multiply-add each
    return kv_bytes + scale_bytes + table_bytes + qo + small, ops


def _time_ms(torch, fn, flush, reps=25):
    """Median device time of one call of `fn`, in ms: CUDA events around
    each call, the L2 flushed before it (a decode step or a prefill finds
    its operands cold), and the device kept busy by a spin while the host
    enqueues the call, so the wrapper's host time is not counted (for a
    kernel of tens of microseconds it can exceed the flush)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()  # evict L2: a decode step finds this layer's pages cold
        torch.cuda._sleep(1_000_000)  # ~0.5 ms: the host enqueues meanwhile
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _sdpa_yardstick(torch, args, win):
    """scaled_dot_product_attention over the pre-gathered dense K/V (the
    page walk excluded): one call computing the same attention."""
    F = torch.nn.functional
    q, kp, vp, table, lens, ks, vs = args
    S, _, H = q.shape
    _, Kv, page, _ = kp.shape
    mp = table.shape[1]

    def dense(pages, sc):
        x = pages[table.long()]
        if sc is not None:
            x = x.float() * sc[table.long()].reshape(S, mp, Kv, page)[..., None]
        return x.permute(0, 2, 1, 3, 4).reshape(S, Kv, mp * page, H)

    k, v = dense(kp, ks), dense(vp, vs)
    valid = torch.arange(mp * page, device=q.device)[None] < lens[:, None]
    if win:
        wk, wv = win["win_k"], win["win_v"]
        if "win_k_scale" in win:
            wk = wk.float() * win["win_k_scale"][..., None]
            wv = wv.float() * win["win_v_scale"][..., None]
        k = torch.cat([k, wk.to(k.dtype)], 2)
        v = torch.cat([v, wv.to(v.dtype)], 2)
        W = wk.shape[2]
        valid = torch.cat([valid, torch.arange(W, device=q.device)[None]
                           < win["win_count"][:, None]], 1)
    dt = q.dtype
    k, v = k.to(dt).contiguous(), v.to(dt).contiguous()
    qq = q[:, :, None, :]
    mask = valid[:, None, None, :]

    return lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask, enable_gqa=True)


def phase_kernel(torch, card):
    from butterfly_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_ref, paged_attention_split_ref)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    S, Nq, Kv, H, page, mp = 8, 32, 8, 128, 16, 128
    lengths = [0, 1, 17, 2048, 300, 1000, 1500, 64]
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bw, peak = figures(card)
    # (name, q dtype, int8 pool, window width, abs tol, per-slot rel tol):
    # a bf16 output rounds to within one ulp, at most 2**-7 of its
    # magnitude, so per slot 1e-2 of the slot's max |output|
    # (name, q dtype, int8 pool, window width, abs tol, per-slot rel tol,
    # slot lengths)
    cases = [("bf16", torch.bfloat16, False, 0, 2e-2, 1e-2, lengths),
             ("bf16_w2", torch.bfloat16, False, 2, 2e-2, 1e-2, lengths),
             ("bf16_w64", torch.bfloat16, False, 64, 2e-2, 1e-2, lengths),
             ("bf16_all_long", torch.bfloat16, False, 0, 2e-2, 1e-2,
              [2048] * S),
             ("int8_w64", torch.bfloat16, True, 64, 2e-2, 1e-2, lengths),
             ("f32", torch.float32, False, 0, 1e-4, 1e-4, lengths),
             ("f32_w2", torch.float32, False, 2, 1e-4, 1e-4, lengths)]
    results = {}
    for name, dt, quant, W, tol, rel_tol, lens in cases:
        args, win, wc = _kernel_case(torch, paged_attention, S, Nq, Kv, H,
                                     page, mp, lens, dt, quant, W, gen)
        out = paged_attention(*args, **win)
        again = paged_attention(*args, **win)
        torch.cuda.synchronize()
        assert torch.equal(out, again), f"{name}: two launches differ"
        ref = paged_attention_ref(*args, **win)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        split_err = (out.float() - paged_attention_split_ref(*args, **win)
                     .float()).abs().max().item()
        assert torch.isfinite(out.float()).all(), f"{name}: non-finite"
        assert err <= tol, f"{name}: max abs err {err} > {tol}"
        assert split_err <= tol, f"{name}: vs split plain {split_err}"
        # every slot but the empty slot 0, against its own output scale:
        # a page dropped or repeated in a long slot moves its small
        # outputs by far less than the short slots' absolute error
        slot_rel = (diff.amax(dim=(1, 2))[1:]
                    / ref.float().abs().amax(dim=(1, 2))[1:])
        rel = slot_rel.max().item()
        assert rel <= rel_tol, \
            f"{name}: per-slot rel err {slot_rel.tolist()} > {rel_tol}"
        # slot 0 attends nothing (lengths 0, win_count 0): exactly zero
        if lens[0] == 0:
            assert (out[0] == 0).all().item(), f"{name}: empty slot not zero"
        n0 = paged_attention.launches
        k_ms = _time_ms(torch, lambda: paged_attention(*args, **win), flush)
        assert paged_attention.launches > n0
        p_ms = _time_ms(torch, lambda: paged_attention_ref(*args, **win),
                        flush, reps=5)
        lib = _sdpa_yardstick(torch, args, win)
        l_ms = _time_ms(torch, lib, flush)
        nbytes, ops = _bytes_ops(args, win, lens, wc, Nq, Kv, H, page,
                                 quant)
        t_bytes = nbytes / bw * 1e3
        t_ops = ops / peak[str(dt).replace("torch.", "")] * 1e3
        bound = max(t_bytes, t_ops)
        results[name] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                             bound_ms=bound,
                             bound_by="bytes" if t_bytes >= t_ops
                             else "operations",
                             library_ms=l_ms, bytes=nbytes, tol=tol)
        log("kernel", case=name, max_abs_err=f"{err:.3g}", tol=tol,
            vs_split_plain=f"{split_err:.3g}",
            max_slot_rel_err=f"{rel:.3g}", rel_tol=rel_tol,
            kernel_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}",
            bytes=nbytes, bound_ms=f"{bound:.4f}",
            library_ms=f"{l_ms:.4f}(sdpa,excludes the page walk)",
            empty_slot="exact 0" if lens[0] == 0 else "none",
            relaunch="same bits")
    return results


# -- phase 4: the flash kernels against their plain version -----------------

_SP = 2048                       # prefix rows of the warm cases
_PLEN = [0, 17, 512, 1536]       # live prefix rows per batch row
_BQ = 64                         # query rows per kernel block
# (name, B, T, causal, dtype name, prefix: None | "float" | "int8",
#  abs tol, per-(row, query tile, head) rel tol): a bf16 output rounds to
# within one ulp, at most 2**-7 of its magnitude, hence 1e-2 of a block's
# max. bf16 takes the tensor-core kernel (flash_mma_kernel), f32 the
# CUDA-core one (flash_kernel).
FLASH_CASES = [
    ("fresh_bf16", 4, 1024, True, "bfloat16", None, 2e-2, 1e-2),
    ("fresh_bf16_T1000", 4, 1000, True, "bfloat16", None, 2e-2, 1e-2),
    ("fresh_bf16_noncausal", 4, 1024, False, "bfloat16", None, 2e-2, 1e-2),
    ("fresh_bf16_h64", 4, 1024, True, "bfloat16", None, 2e-2, 1e-2),
    ("fresh_f32", 4, 256, True, "float32", None, 1e-4, 1e-4),
    ("warm_bf16", 4, 512, True, "bfloat16", "float", 2e-2, 1e-2),
    ("warm_int8", 4, 512, True, "bfloat16", "int8", 2e-2, 1e-2),
    ("warm_f32", 4, 256, True, "float32", "float", 1e-4, 1e-4),
]


def _tile_rel_err(torch, diff, ref):
    """Max error over max |ref| per (batch row, tile of _BQ query rows,
    head): the block one kernel block computes, so a fault confined to
    late query tiles (whose outputs are small) is held to their scale."""
    F = torch.nn.functional
    B, T, Nq, H = ref.shape
    pad = -T % _BQ
    d = F.pad(diff, (0, 0, 0, 0, 0, pad)).reshape(B, -1, _BQ, Nq, H)
    r = F.pad(ref.float().abs(), (0, 0, 0, 0, 0, pad)) \
        .reshape(B, -1, _BQ, Nq, H)
    return (d.amax(dim=(2, 4)) / r.amax(dim=(2, 4)).clamp_min(1e-30)) \
        .max().item()


def _abs_v(args, kw):
    """The same flash call with |v| (and |prefix_v|): its plain output is
    sum_j p_j |v_j| / l for every output element."""
    args = list(args)
    args[2] = args[2].abs()
    kw = dict(kw)
    if kw.get("prefix_v") is not None:
        kw["prefix_v"] = kw["prefix_v"].abs()
    return args, kw


def _flash_bound_ratio(torch, flash_attention_ref, args, kw, diff, ref):
    """Max over elements of |kernel - plain| / bound, for a bf16 output;
    the kernel is right where this is <= 1. The bound is
    2**-7 * (|ref| + sum_j p_j |v_j| / l): both sides round the output to
    bf16 once (2**-8 of |x| each), and a kernel that rounds the
    probabilities to bf16 before P.V moves the output by at most 2**-8 of
    sum_j p_j |v_j| / l (taken twice, for slack). f32 summation order adds
    ~2**-20 of the same. It scales with each element, so it holds an
    output of magnitude 5 (ulp 0.03) and one of 0.01 alike."""
    a, k = _abs_v(args, kw)
    absv = flash_attention_ref(*a, **k).float()
    bound = 2.0 ** -7 * (ref.float().abs() + absv)
    return (diff / bound.clamp_min(1e-30)).max().item()


# (Nq, Kv, H) by case: Llama-3-8B's heads unless named here (GPT-2's)
_FLASH_HEADS = {"fresh_bf16_h64": (12, 12, 64)}


def _flash_inputs(torch, name, B, T, dt, prefix, gen):
    """q/k/v (+ the warm prefix, with large garbage past each row's
    prefix_len) on the card, and the args/kwargs of flash_attention."""
    Nq, Kv, H = _FLASH_HEADS.get(name, (32, 8, 128))
    dev = "cuda"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)
    q, k, v = randn(B, T, Nq, H), randn(B, T, Kv, H), randn(B, T, Kv, H)
    kw = {}
    if prefix == "float":
        pk, pv = randn(B, _SP, Kv, H), randn(B, _SP, Kv, H)
        for b, n in enumerate(_PLEN):
            pk[b, n:] = 30.0
            pv[b, n:] = -30.0
        kw = dict(prefix_k=pk, prefix_v=pv)
    elif prefix == "int8":
        shape = (B, Kv, _SP, H)
        pk = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        pv = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        ks = torch.rand(shape[:-1], generator=gen, device=dev) * 0.02
        vs = torch.rand(shape[:-1], generator=gen, device=dev) * 0.02
        for b, n in enumerate(_PLEN):
            ks[b, :, n:] = 1.0
            vs[b, :, n:] = 1.0
        kw = dict(prefix_k=pk, prefix_v=pv, prefix_k_scale=ks,
                  prefix_v_scale=vs)
    if prefix is not None:
        kw["prefix_len"] = torch.tensor(_PLEN, dtype=torch.int32, device=dev)
    return q, k, v, kw


def _flash_bytes_ops(q, k, causal, kw):
    """Bytes the function must move (q, k, v and the output once, plus the
    LIVE prefix rows and their scales) and the operations it does (q.k and
    p.v over the live (query, key) pairs, a multiply-add each)."""
    B, T, Nq, H = q.shape
    Kv = k.shape[2]
    el = q.element_size()
    nbytes = 2 * q.numel() * el + 2 * k.numel() * el
    pairs = T * (T + 1) // 2 if causal else T * T
    ops = 4 * B * Nq * H * pairs
    if kw:
        live = int(kw["prefix_len"].sum().item())
        quant = "prefix_k_scale" in kw
        nbytes += 2 * live * Kv * H * (1 if quant else el) + 4 * B
        if quant:
            nbytes += 2 * live * Kv * 4
        ops += 4 * Nq * H * T * live
    return nbytes, ops


def _flash_yardstick(torch, q, k, v, causal, kw):
    """One scaled_dot_product_attention call computing the same function:
    over the chunk alone, or over [live prefix ‖ chunk] with an explicit
    mask (K/V concatenated, the int8 prefix dequantized, beforehand)."""
    F = torch.nn.functional
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    if not kw:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    pk, pv = kw["prefix_k"], kw["prefix_v"]
    if "prefix_k_scale" in kw:
        pk = (pk.float() * kw["prefix_k_scale"][..., None]).to(q.dtype)
        pv = (pv.float() * kw["prefix_v_scale"][..., None]).to(q.dtype)
    else:
        pk, pv = pk.transpose(1, 2), pv.transpose(1, 2)
    B, T = q.shape[:2]
    Sp = pk.shape[2]
    kc = torch.cat([pk, kt], dim=2).contiguous()
    vc = torch.cat([pv, vt], dim=2).contiguous()
    live_p = torch.arange(Sp, device=q.device)[None] < kw["prefix_len"][:, None]
    tri = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    mask = torch.cat([live_p[:, None, :].expand(B, T, Sp),
                      tri[None].expand(B, T, T)], dim=2)[:, None]
    return lambda: F.scaled_dot_product_attention(
        qt, kc, vc, attn_mask=mask, enable_gqa=True)


def phase_flash_kernel(torch, card):
    from butterfly_tpu_torch.ops.flash_attention import (flash_attention,
                                                         flash_attention_ref)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    bw, peak = figures(card)
    results = {}
    for name, B, T, causal, dts, prefix, tol, rel_tol in FLASH_CASES:
        dt = getattr(torch, dts)
        q, k, v, kw = _flash_inputs(torch, name, B, T, dt, prefix, gen)
        out = flash_attention(q, k, v, causal, **kw)
        again = flash_attention(q, k, v, causal, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, again), f"{name}: two launches differ"
        ref = flash_attention_ref(q, k, v, causal, **kw)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        assert torch.isfinite(out.float()).all(), f"{name}: non-finite"
        assert err <= tol, f"{name}: max abs err {err} > {tol}"
        # per (batch row, query tile, head) against its own scale: a
        # dropped or repeated key tile near prefix_len or the diagonal
        # moves a few blocks only
        rel = _tile_rel_err(torch, diff, ref)
        assert rel <= rel_tol, f"{name}: per-tile rel err {rel} > {rel_tol}"
        checks = dict(max_tile_rel_err=f"{rel:.3g}", rel_tol=rel_tol)
        if dt == torch.bfloat16:
            ratio = _flash_bound_ratio(torch, flash_attention_ref,
                                       (q, k, v, causal), kw, diff, ref)
            assert ratio <= 1.0, f"{name}: element error {ratio} x bound"
            checks["max_err_over_elem_bound"] = f"{ratio:.3g}"
        entry = "launches_warm" if kw else "launches_fresh"
        n0 = getattr(flash_attention, entry)
        k_ms = _time_ms(torch, lambda: flash_attention(q, k, v, causal, **kw),
                        flush)
        assert getattr(flash_attention, entry) > n0
        p_ms = _time_ms(torch, lambda: flash_attention_ref(q, k, v, causal,
                                                           **kw),
                        flush, reps=3)
        l_ms = _time_ms(torch, _flash_yardstick(torch, q, k, v, causal, kw),
                        flush)
        nbytes, ops = _flash_bytes_ops(q, k, causal, kw)
        t_bytes = nbytes / bw * 1e3
        t_ops = ops / peak[dts] * 1e3
        bound = max(t_bytes, t_ops)
        results[name] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                             bound_ms=bound,
                             bound_by="bytes" if t_bytes >= t_ops
                             else "operations",
                             library_ms=l_ms)
        log("flash", case=name, card=card.replace(" ", "_"),
            heads="x".join(map(str, (q.shape[2], k.shape[2], q.shape[3]))),
            max_abs_err=f"{err:.3g}", tol=tol, **checks,
            kernel_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}",
            bytes=nbytes, ops=ops, bound_ms=f"{bound:.4f}",
            bound_by=results[name]["bound_by"],
            library_ms=f"{l_ms:.4f}(sdpa)")
        del q, k, v, kw, out, ref, diff
    return results


# -- phase 5: the ring kernel against its plain version ---------------------

_INVALID = 2**31 - 1
# (name, B, T, S, query start (one per batch row, or one for all), k
#  positions start, dtype name, int8 K/V, ragged): Llama-3-8B heads
# (Nq=32, Kv=8, H=128). diag is the diagonal ring block of a 4096-token
# prompt over 2 shards (each shard's own chunk), earlier a block every
# query sees whole, later a block every query must ignore, decode one
# token against a shard (the T = 1 split kernel; B4: four rows at four
# positions, one of which sees only the first split).
RING_CASES = [
    ("diag_bf16", 1, 2048, 2048, 0, 0, "bfloat16", False, False),
    ("earlier_bf16", 1, 2048, 2048, 2048, 0, "bfloat16", False, False),
    ("later_bf16", 1, 2048, 2048, 0, 2048, "bfloat16", False, False),
    ("ragged_bf16", 1, 1000, 2000, 1000, 0, "bfloat16", False, True),
    ("int8", 1, 2048, 2048, 0, 0, "bfloat16", True, False),
    ("decode_T1", 1, 1, 2048, 3000, 0, "bfloat16", False, False),
    ("decode_T1_int8", 1, 1, 2048, 3000, 0, "bfloat16", True, False),
    ("decode_T1_f32", 1, 1, 2048, 3000, 0, "float32", False, False),
    ("decode_T1_B4", 4, 1, 2048, [3000, 1000, 100, 2047], 0, "bfloat16",
     False, False),
    ("f32_T256", 1, 256, 256, 0, 0, "float32", False, False),
    # the CUDA-core routes at the tiny preset's heads (H = 16), and f16
    # on the tensor-core routes at Llama-3-8B's heads
    ("h16_bf16", 1, 1024, 1024, 0, 0, "bfloat16", False, False),
    ("h16_T1_bf16", 1, 1, 2048, 3000, 0, "bfloat16", False, False),
    ("h16_f32", 1, 1024, 1024, 0, 0, "float32", False, False),
    ("h16_T1_f32", 1, 1, 2048, 3000, 0, "float32", False, False),
    ("f16", 1, 2048, 2048, 0, 0, "float16", False, False),
    ("decode_T1_f16", 1, 1, 2048, 3000, 0, "float16", False, False),
]
#: (Nq, Kv, H) of the cases not at Llama-3-8B's heads: the tiny preset's
_RING_HEADS = {name: (4, 2, 16) for name in
               ("h16_bf16", "h16_T1_bf16", "h16_f32", "h16_T1_f32")}


def _ring_inputs(torch, B, T, S, q0, k0, dt, quant, ragged, gen,
                 heads=(32, 8, 128)):
    Nq, Kv, H = heads
    dev = "cuda"
    q = torch.randn((B, T, Nq, H), generator=gen, device=dev).to(dt)
    if quant:
        k = torch.randint(-127, 128, (B, Kv, S, H), generator=gen,
                          device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, (B, Kv, S, H), generator=gen,
                          device=dev, dtype=torch.int8)
        ks = torch.rand((B, Kv, S), generator=gen, device=dev) * 0.02
        vs = torch.rand((B, Kv, S), generator=gen, device=dev) * 0.02
    else:
        k = torch.randn((B, S, Kv, H), generator=gen, device=dev).to(dt)
        v = torch.randn((B, S, Kv, H), generator=gen, device=dev).to(dt)
        ks = vs = None
    starts = q0 if isinstance(q0, list) else [q0] * B
    qp = torch.stack([torch.arange(a, a + T, device=dev, dtype=torch.int32)
                      for a in starts])
    kp = torch.arange(k0, k0 + S, device=dev,
                      dtype=torch.int32)[None].repeat(B, 1)
    if ragged:
        # the unwritten tail and scattered holes carry INVALID_POS, and
        # their K/V rows hold large garbage that must never be attended
        bad = torch.rand((B, S), generator=gen, device=dev) < 0.1
        bad[:, 1900:] = True
        kp = torch.where(bad, torch.full_like(kp, _INVALID), kp)
        k[bad] = 30.0
        v[bad] = -30.0
    return (q, k, v, qp, kp, ks, vs)


def _ring_bytes_ops(args):
    """Bytes the block must move for THIS data (q once if any pair is
    live, the K/V rows (+ scales) some query attends, positions, the
    outputs once) and its operations (q.k and p.v on the live pairs)."""
    q, k, v, qp, kp, ks, vs = args
    B, T, Nq, H = q.shape
    quant = ks is not None
    Kv = k.shape[1] if quant else k.shape[2]
    live = kp[:, None, :] <= qp[:, :, None]               # [B, T, S]
    pairs = int(live.sum().item())
    keys = int(live.any(dim=1).sum().item())
    el = 1 if quant else k.element_size()
    nbytes = (qp.numel() + kp.numel()) * 4 + B * Nq * T * (H + 2) * 4
    if pairs:
        nbytes += q.numel() * q.element_size() \
            + 2 * keys * Kv * (H * el + (4 if quant else 0))
    return nbytes, 4 * Nq * H * pairs


def _ring_sdpa(torch, args):
    """One scaled_dot_product_attention call with the same boolean
    position mask (enable_gqa): the normalised output, not the stats."""
    F = torch.nn.functional
    q, k, v, qp, kp, ks, vs = args
    if ks is not None:      # int8 codes are already [B, Kv, S, H]
        k = (k.float() * ks[..., None]).to(q.dtype)
        v = (v.float() * vs[..., None]).to(q.dtype)
    else:
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = k.contiguous(), v.contiguous()
    mask = (kp[:, None, :] <= qp[:, :, None])[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)


def _ring_check(torch, ra, args, stats, ref, bf16):
    """Hold the kernel's stats to the plain version's: (m err, l rel err,
    finalised output abs err, its element-bound ratio (bf16) or abs err
    (f32), tile rel err)."""
    m, l, acc = stats
    m_r, l_r, acc_r = ref
    masked = l_r == 0
    # a row with nothing live: exactly m = -1e30, l = 0, acc = 0
    assert (m[masked] == ra.NEG_INF).all() and (l[masked] == 0).all() \
        and (acc[masked] == 0).all(), "masked rows not exact"
    assert torch.isfinite(m).all() and torch.isfinite(l).all() \
        and torch.isfinite(acc).all(), "non-finite stats"
    m_err = (m - m_r).abs().max().item()
    l_rel = ((l - l_r).abs() / l_r.clamp_min(1e-30)).max().item()
    out = ra.finalize_stats(stats, torch.float32)
    out_r = ra.finalize_stats(ref, torch.float32)
    diff = (out - out_r).abs()
    if bf16:
        q, k, v, qp, kp, ks, vs = args
        absv = ra.finalize_stats(ra.ring_block_stats_ref(
            q, k, v.abs(), qp, kp, ks, vs), torch.float32)
        bound = 2.0 ** -7 * (out_r.abs() + absv)
        elem = (diff / bound.clamp_min(1e-30)).max().item()
    else:
        elem = diff.max().item()
    tile = _tile_rel_err(torch, diff, out_r) if out_r.abs().max() > 0 \
        else 0.0
    return m_err, l_rel, diff.max().item(), elem, tile


def phase_ring(torch, card):
    from butterfly_tpu_torch.ops import ring_attention as ra
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    bw, peak = figures(card)
    results = {}
    for name, B, T, S, q0, k0, dts, quant, ragged in RING_CASES:
        dt = getattr(torch, dts)
        bf16 = dt != torch.float32   # 16-bit: bf16 or f16
        heads = _RING_HEADS.get(name, (32, 8, 128))
        args = _ring_inputs(torch, B, T, S, q0, k0, dt, quant, ragged, gen,
                            heads)
        stats = ra.ring_block_stats(*args)
        again = ra.ring_block_stats(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(stats, again)), \
            f"{name}: two launches differ"
        tol = dict(m=1e-3, l=2.0 ** -7, elem=1.0, tile=1e-2) if bf16 else \
            dict(m=1e-4, l=1e-4, elem=1e-4, tile=1e-4)
        refs = [ra.ring_block_stats_ref(*args)]
        if T == 1:   # the split kernel's own decomposition, in plain form
            refs.append(ra.ring_block_stats_split_ref(*args))
        # the worst of each error against either plain version
        m_err, l_rel, out_err, elem, tile = map(max, zip(*(
            _ring_check(torch, ra, args, stats, ref, bf16) for ref in refs)))
        assert m_err <= tol["m"], f"{name}: m err {m_err}"
        assert l_rel <= tol["l"], f"{name}: l rel err {l_rel}"
        assert elem <= tol["elem"], f"{name}: output err {elem}"
        assert tile <= tol["tile"], f"{name}: tile rel err {tile}"
        ref = refs[0]
        n0 = ra.launches
        k_ms = _time_ms(torch, lambda: ra.ring_block_stats(*args), flush)
        assert ra.launches > n0
        p_ms = _time_ms(torch, lambda: ra.ring_block_stats_ref(*args), flush,
                        reps=3)
        l_ms = None
        if name != "later_bf16":  # SDPA has no answer for an all-masked row
            l_ms = _time_ms(torch, _ring_sdpa(torch, args), flush)
        nbytes, ops = _ring_bytes_ops(args)
        t_bytes = nbytes / bw * 1e3
        t_ops = ops / peak[dts] * 1e3
        bound = max(t_bytes, t_ops)
        results[name] = dict(max_abs_err=out_err, ms=k_ms, plain_ms=p_ms,
                             bound_ms=bound,
                             bound_by="bytes" if t_bytes >= t_ops
                             else "operations", library_ms=l_ms)
        log("ring", case=name, card=card.replace(" ", "_"), B=B, T=T, S=S,
            heads="x".join(map(str, heads)),
            route=ra.ring_route(T, heads[2], dt),
            m_abs_err=f"{m_err:.3g}", l_rel_err=f"{l_rel:.3g}",
            out_abs_err=f"{out_err:.3g}",
            **({"max_err_over_elem_bound": f"{elem:.3g}"} if bf16 else {}),
            max_tile_rel_err=f"{tile:.3g}", kernel_ms=f"{k_ms:.4f}",
            plain_ms=f"{p_ms:.4f}", bytes=nbytes, ops=ops,
            bound_ms=f"{bound:.4f}", bound_by=results[name]["bound_by"],
            library_ms="none" if l_ms is None
            else f"{l_ms:.4f}(sdpa,normalised output)",
            relaunch="same bits")
        del args, stats, again, refs, ref
    return results


# -- phase 6: the serving path ------------------------------------------------

def _post(url, obj, timeout=600):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def phase_serve(torch):
    from http.server import ThreadingHTTPServer

    from butterfly_tpu_torch.ops.paged_attention import paged_attention
    from butterfly_tpu_torch.serve.cli import build_parser
    from butterfly_tpu_torch.serve.server import (ServerState, build_serving,
                                                  make_handler)
    args = build_parser().parse_args(
        ["serve", "--model", "llama3-8b", "--device", "cuda",
         "--host", "127.0.0.1", "--port", "0"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    sched, tok, rt = build_serving(args)
    engine = sched.engine
    cfg = engine.cfg
    # the native free list, built in the build phase (no prefix caching)
    assert type(sched.alloc).__name__ == "NativePageAllocator", \
        type(sched.alloc).__name__
    log("serve", model=args.model, layers=cfg.num_layers,
        hidden=cfg.hidden_size, dtype=cfg.dtype, slots=rt.max_batch_size,
        max_seq=rt.max_seq_len, page=rt.page_size,
        mixed_dispatch=rt.mixed_dispatch,
        kv_write_combine=rt.kv_write_combine,
        allocator=type(sched.alloc).__name__,
        setup_s=f"{time.monotonic() - t0:.1f}")
    class Server(ThreadingHTTPServer):
        # the serve entrypoint's backlog (serve/server.py:serve_forever):
        # the default of 5 can reset some of 8 simultaneous connections
        request_queue_size = 128

    state = ServerState(sched, tok)
    state.thread.start()
    httpd = Server(("127.0.0.1", 0), make_handler(state))
    srv = threading.Thread(target=httpd.serve_forever, daemon=True)
    srv.start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    sizes = [16, 64, 200, 400, 600, 800, 1000, 1200]
    news = [32, 40, 48, 56, 64, 32, 40, 64]
    prompts = [("The quick brown fox jumps over the lazy dog. " * 30)[:n]
               for n in sizes]
    results = [None] * len(sizes)

    def one(i):
        results[i] = _post(url, {"prompt": prompts[i],
                                 "max_tokens": news[i],
                                 "temperature": 0.0, "stop_token": -1})

    try:
        paged_attention.launches = 0
        t0 = time.monotonic()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(sizes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        launches = paged_attention.launches
    finally:
        state.stop.set()
        httpd.shutdown()
        httpd.server_close()
        if state.heartbeat is not None:
            state.heartbeat.stop()
        state.thread.join(timeout=30)
    for i, r in enumerate(results):
        assert r is not None, f"request {i} got no answer"
        code, body = r
        assert code == 200, f"request {i}: HTTP {code}"
        assert len(body["tokens"]) == news[i], \
            f"request {i}: {len(body['tokens'])} tokens, want {news[i]}"
        assert all(0 <= t < cfg.vocab_size for t in body["tokens"])
    gen_tokens = sum(len(b["tokens"]) for _, b in results)
    ttfts = sorted(b["ttft_s"] for _, b in results)
    assert launches > 0, "the paged kernel never launched on the main path"
    assert launches % cfg.num_layers == 0, \
        f"{launches} launches: not one per layer per decode step"
    log("serve", requests_answered=len(results), generated_tokens=gen_tokens,
        wall_s=f"{wall:.3f}", tokens_per_s=f"{gen_tokens / wall:.2f}",
        ttft_p50_s=f"{statistics.median(ttfts):.4f}",
        paged_attention_launches_before=0,
        paged_attention_launches_after=launches,
        decode_steps=launches // cfg.num_layers,
        max_memory_allocated_GiB=
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        note="smoke run, not a benchmark")
    return engine, launches, tok


# -- phase 6: the kernel inside the model, against the plain version --------

LAYER_TOL = 2e-2   # bf16 tolerance of the kernel phase, absolute
LOGITS_TOL = 0.5   # ~2x the largest kernel-vs-plain gap seen on an H100


def phase_parity(torch, engine):
    """One windowed decode step through all 32 layers on the serve
    phase's pool (real K/V written by the requests), equal carries, bf16:
    every layer's kernel output against the plain version on the same
    inputs (bf16 tolerance 2e-2), and the step's logits with the kernel
    against the same step with the plain version at every layer. The
    dense gather + attend path's logits are reported beside them: it
    rounds the probabilities to bf16 before the P.V product, the kernel
    and the plain version do not.

    Tolerances: a layer's kernel output must match the plain version to
    LAYER_TOL absolute, the bf16 tolerance of the kernel phase; on an
    H100 the two differ by one bf16 ulp at most (7.8e-3 on outputs of
    magnitude 1-2). 32 layers of random weights amplify such ulps to
    0.21-0.23 on logits of magnitude ~6, so the step's logits must agree
    to LOGITS_TOL."""
    import butterfly_tpu_torch.cache.paged as paged_mod
    from butterfly_tpu_torch.cache.paged import (init_kv_window,
                                                 paged_forward_window)
    from butterfly_tpu_torch.ops.paged_attention import (paged_attention,
                                                         paged_attention_ref)
    cache = engine.cache
    S = engine.num_slots
    mp = cache.page_table.shape[1]
    page = cache.page_size
    lengths = [5, 100, 700, 1300, 0, 33, 64, 1000][:S]
    table = torch.full((S, mp), cache.null_page, dtype=torch.int32,
                       device="cuda")
    for s in range(S):
        n = -(-lengths[s] // page)
        table[s, :n] = torch.arange(s * mp, s * mp + n, dtype=torch.int32)
    c = cache._replace(page_table=table, lengths=torch.tensor(
        lengths, dtype=torch.int32, device="cuda"))
    win = init_kv_window(c, 64)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for t in (win.k, win.v):
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda") * 0.5)
    wlen = torch.tensor([3, 0, 10, 63, 0, 1, 7, 20][:S], dtype=torch.int32,
                        device="cuda")
    active = torch.tensor([n > 0 for n in lengths], device="cuda")
    toks = torch.randint(0, engine.cfg.vocab_size, (S, 1), generator=gen,
                         device="cuda", dtype=torch.int32)
    errs = []

    def checked(*args, **kw):
        out = paged_attention(*args, **kw)
        ref = paged_attention_ref(*args, **kw)
        errs.append((out.float() - ref.float()).abs().max().item())
        return out

    def step(attn, use_kernel=True):
        paged_mod.paged_attention = attn
        try:
            logits, _ = paged_forward_window(
                engine.params, engine.cfg, toks, c, win, wlen,
                active=active, use_kernel=use_kernel)
        finally:
            paged_mod.paged_attention = paged_attention
        torch.cuda.synchronize()
        return logits[:, 0][active].float()

    kern = step(checked)
    plain = step(paged_attention_ref)
    dense = step(paged_attention, use_kernel=False)
    assert len(errs) == engine.cfg.num_layers, errs
    layer_err = max(errs)
    for x in (kern, plain, dense):
        assert torch.isfinite(x).all()
    d_plain = (kern - plain).abs().max().item()
    d_dense = (kern - dense).abs().max().item()
    agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    log("parity", layers=len(errs), max_layer_abs_err=f"{layer_err:.3g}",
        layer_tol=LAYER_TOL, max_abs_logit=f"{plain.abs().max().item():.4g}",
        logits_kernel_vs_plain=f"{d_plain:.4g}",
        logits_tol=LOGITS_TOL, argmax_agree_vs_plain=f"{agree:.3f}",
        logits_kernel_vs_dense=f"{d_dense:.4g}")
    assert layer_err <= LAYER_TOL, f"kernel vs plain in-model: {layer_err}"
    assert d_plain <= LOGITS_TOL, \
        f"kernel vs plain logits differ by {d_plain} > {LOGITS_TOL}"


# -- phase 7: where a decode step's time goes --------------------------------

def _decode_step_profile(torch, engine, steps=5):
    """Decode steps of the real engine path (mixed_block_async, k=1,
    C=1, every slot decoding at the lengths below) timed on the host
    clock with a device sync, then traced with torch.profiler. Returns
    (host ms per step, traced ms per step, device busy ms per step or
    0.0 when the trace shows none, the profiler's key averages, the
    lengths)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    S = engine.num_slots
    mp = engine.cache.page_table.shape[1]
    page = engine.cache.page_size
    lengths = [64, 200, 400, 600, 800, 1000, 1200, 1260][:S]
    for s in range(S):
        engine.set_table_row(s, list(range(s * mp, s * mp + mp)))
    engine.flush_kv_window()
    engine.cache = engine.cache._replace(lengths=torch.tensor(
        lengths, dtype=torch.int32, device="cuda"))
    cur = torch.zeros(S, dtype=torch.int32, device="cuda")
    cursor = torch.zeros(S, dtype=torch.int32, device="cuda")
    pbuf = torch.zeros((S, mp * page), dtype=torch.int32, device="cuda")
    zeros = np.zeros(S, np.int32)
    args = dict(active=np.ones(S, bool), temps=np.zeros(S, np.float32),
                stops=np.full(S, -1, np.int32),
                budgets=np.full(S, 10 ** 6, np.int32))

    def run(n):
        nonlocal cur, cursor
        for i in range(n):
            _, _, cur, cursor = engine.mixed_block_async(
                cur, cursor, pbuf, zeros, seed=i, k=1, C=1, **args)
            engine.flush_kv_window()
        torch.cuda.synchronize()

    run(2)
    t0 = time.perf_counter()
    run(steps)
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        wall = (time.perf_counter() - t0) / steps * 1e3
    ka = prof.key_averages()
    busy = sum(_dev_us(e) for e in ka if e.device_type.name == "CUDA") \
        / steps / 1e3
    return step_ms, wall, busy, ka, lengths


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def phase_profile(torch, engine, steps=5):
    """Where one decode step's time goes (_decode_step_profile): device
    busy time per step, the idle share, the paged kernels' share and the
    top kernels."""
    step_ms, wall, busy, ka, lengths = _decode_step_profile(torch, engine,
                                                            steps)
    top = sorted((e for e in ka if e.device_type.name == "CUDA"),
                 key=_dev_us, reverse=True)[:8]
    paged = [e for e in ka if e.device_type.name == "CUDA"
             and "paged_" in e.key and "kernel" in e.key]
    paged_ms = sum(_dev_us(e) for e in paged) / steps / 1e3
    log("profile", decode_step_ms=f"{step_ms:.3f}",
        traced_step_ms=f"{wall:.3f}", device_busy_ms=f"{busy:.3f}",
        idle_share=f"{1 - busy / wall:.3f}" if busy else "not measured",
        paged_ms_per_step=f"{paged_ms:.4f}",
        paged_share_of_busy=f"{paged_ms / busy:.3f}" if busy
        else "not measured",
        paged_calls_per_step="+".join(str(e.count // steps) for e in paged),
        lengths=",".join(map(str, lengths)))
    for e in top:
        log("profile", kernel=e.key[:60].replace(" ", "_"),
            ms_per_step=f"{_dev_us(e) / steps / 1e3:.4f}",
            calls_per_step=e.count // steps)


# -- phase 8: butterfly generate ---------------------------------------------

_TEXT = "The quick brown fox jumps over the lazy dog. " * 30


def _check_tokens(res, B, n, vocab, what):
    assert res.tokens.shape == (B, n), f"{what}: shape {res.tokens.shape}"
    assert ((res.tokens >= 0) & (res.tokens < vocab)).all(), what
    assert (res.lengths == n).all(), f"{what}: lengths {res.lengths}"


def _cli_params(cli, params):
    """A context in which the CLI's load_params hands back `params` (the
    weights built once) instead of drawing them again."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = cli.load_params
        cli.load_params = lambda model, args: params
        try:
            yield
        finally:
            cli.load_params = saved
    return ctx()


def phase_generate(torch, model, params, tok):
    """InferenceEngine.generate on the serve phase's weights, then the
    CLI's generate on them. Returns the fresh kernel's launches."""
    import contextlib
    import io

    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.engine import InferenceEngine, pad_prompts
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.ops.flash_attention import flash_attention
    from butterfly_tpu_torch.serve import cli
    cfg = model.cfg
    L = cfg.num_layers
    card = torch.cuda.get_device_name(0).replace(" ", "_")
    prompts = [tok.encode(_TEXT[:n]) for n in (16, 200, 600, 1000)]
    B, new = len(prompts), 32
    sp = SamplingParams(max_new_tokens=new)
    total, outs = 0, {}
    for name, kvq, fused in (("bf16_fused", "none", True),
                             ("bf16_stepped", "none", False),
                             ("int8_window", "int8", True)):
        eng = InferenceEngine(model, params, RuntimeConfig(kv_quant=kvq))
        flash_attention.launches_fresh = flash_attention.launches_warm = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.generate(prompts, sp, fused=fused)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_fresh = flash_attention.launches_fresh
        assert n_fresh == L, f"{name}: {n_fresh} fresh launches for 1 prefill"
        assert flash_attention.launches_warm == 0, name
        _check_tokens(res, B, new, cfg.vocab_size, name)
        outs[name] = res.tokens
        # the prefill alone, timed on its own cache
        toks, lens = pad_prompts(prompts)
        cache = eng.new_cache(B, 2048)
        tt = torch.as_tensor(toks, device="cuda")
        tl = torch.as_tensor(lens, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = eng.prefill(tt, tl, cache)
        torch.cuda.synchronize()
        pf_ms = (time.perf_counter() - t0) * 1e3
        assert torch.isfinite(logits).all(), f"{name}: prefill logits"
        assert flash_attention.launches_fresh == 2 * L, name
        total += n_fresh  # the timing prefill above is not the main path
        log("generate", run=name, card=card, batch=B,
            prompt_tokens=",".join(str(len(p)) for p in prompts),
            new_tokens=new,
            decode_window=eng._decode_window, wall_s=f"{wall:.3f}",
            tokens_per_s=f"{B * new / wall:.2f}", prefill_ms=f"{pf_ms:.1f}",
            fresh_launches=n_fresh, note="smoke run, not a benchmark")
        del eng, cache, logits
    assert (outs["bf16_fused"] == outs["bf16_stepped"]).all(), \
        "fused and stepped greedy tokens differ"
    # the CLI's generate, handed the weights built once
    out, err = io.StringIO(), io.StringIO()
    flash_attention.launches_fresh = 0
    with _cli_params(cli, params), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = cli.main(["generate", "--model", "llama3-8b", "--device",
                       "cuda", "--prompt", _TEXT[:300], "--max-new",
                       str(new)])
    assert rc == 0, f"cli generate rc {rc}: {err.getvalue()}"
    assert flash_attention.launches_fresh == L
    total += flash_attention.launches_fresh
    assert err.getvalue().startswith("[butterfly] ")
    log("generate", run="cli", rc=rc, text_chars=len(out.getvalue()),
        stderr=err.getvalue().strip().replace(" ", "_"))
    torch.cuda.empty_cache()
    return total


# -- phase 9: the alternating serving path ----------------------------------

def phase_alternating(torch, model, params, tok):
    """ServingEngine(mixed_dispatch=False) + Scheduler, 8 concurrent
    greedy requests. Returns (engine, {kernel: launches})."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.ops.flash_attention import flash_attention
    from butterfly_tpu_torch.ops.paged_attention import paged_attention
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    cfg = model.cfg
    L = cfg.num_layers
    rt = RuntimeConfig(max_batch_size=8, max_seq_len=2048, page_size=16,
                       mixed_dispatch=False)
    engine = ServingEngine(model, params, rt)
    sched = Scheduler(engine)
    sizes = [16, 64, 200, 400, 600, 800, 1000, 1200]
    news = [32, 40, 48, 56, 64, 32, 40, 64]
    flash_attention.launches_fresh = flash_attention.launches_warm = 0
    paged_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    reqs = [sched.submit(tok.encode(_TEXT[:n]), max_new_tokens=m)
            for n, m in zip(sizes, news)]
    sched.run_until_done()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = {"fresh": flash_attention.launches_fresh,
              "warm": flash_attention.launches_warm,
              "paged": paged_attention.launches}
    for r, m in zip(reqs, news):
        assert r.state == "finished" and len(r.output) == m, \
            f"request {r.id}: {r.state}, {len(r.output)} tokens"
        assert all(0 <= t < cfg.vocab_size for t in r.output)
    for kname, n in counts.items():
        assert n > 0, f"the {kname} kernel never launched on this path"
        assert n % L == 0, f"{kname}: {n} launches, not a multiple of {L}"
    ttfts = sorted(r.ttft for r in reqs)
    gen_tokens = sum(len(r.output) for r in reqs)
    log("alternate", card=torch.cuda.get_device_name(0).replace(" ", "_"),
        mixed_dispatch=rt.mixed_dispatch,
        prefill_chunk=rt.prefill_chunk, requests=len(reqs),
        generated_tokens=gen_tokens, wall_s=f"{wall:.3f}",
        tokens_per_s=f"{gen_tokens / wall:.2f}",
        ttft_p50_s=f"{statistics.median(ttfts):.4f}",
        ttft_max_s=f"{ttfts[-1]:.4f}",
        fresh_launches=counts["fresh"], warm_launches=counts["warm"],
        paged_launches=counts["paged"],
        barriers=json.dumps(sched.barrier_causes()).replace(" ", ""),
        note="smoke run, not a benchmark")
    return engine, counts


# -- phase 10: the flash kernels inside the model ------------------------------

def phase_flash_parity(torch, engine):
    """One fresh 512-token prefill and one 388-token warm chunk after it
    on slot 0 of the alternating engine, bf16, through all layers: each
    layer's flash output against the plain version on the same inputs,
    element by element within the bound of `_flash_bound_ratio` (one bf16
    ulp scaled to the output: an absolute LAYER_TOL would fail a right
    kernel on any output of magnitude >= 4, whose ulp is 0.031), and each
    pass's last-token logits against the same pass with the plain version
    at every layer (LOGITS_TOL)."""
    import butterfly_tpu_torch.cache.paged as paged_mod
    from butterfly_tpu_torch.ops.flash_attention import (flash_attention,
                                                         flash_attention_ref)
    L = engine.cfg.num_layers
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    toks = torch.randint(0, engine.cfg.vocab_size, (900,),
                         generator=gen).tolist()
    engine.set_table_row(0, list(range(64)))
    errs, mags, ratios = [], [], []

    def checked(*args, **kw):
        out = flash_attention(*args, **kw)
        ref = flash_attention_ref(*args, **kw)
        diff = (out.float() - ref.float()).abs()
        errs.append(diff.max().item())
        mags.append(ref.float().abs().max().item())
        ratios.append(_flash_bound_ratio(torch, flash_attention_ref, args,
                                         kw, diff, ref))
        return out

    def run(attn):
        paged_mod.flash_attention = attn
        try:
            fresh = engine.prefill_batch([0], [toks[:512]], [0])
            warm = engine.prefill_batch([0], [toks[512:]], [512])
        finally:
            paged_mod.flash_attention = flash_attention
        torch.cuda.synchronize()
        return fresh.float(), warm.float()

    kern = run(checked)
    plain = run(flash_attention_ref)
    assert len(errs) == 2 * L, errs
    gaps = []
    for a, b in zip(kern, plain):
        assert torch.isfinite(a).all() and torch.isfinite(b).all()
        gaps.append((a - b).abs().max().item())
    log("flashpar", layers=L, fresh_max_layer_abs_err=f"{max(errs[:L]):.3g}",
        warm_max_layer_abs_err=f"{max(errs[L:]):.3g}",
        fresh_max_err_over_elem_bound=f"{max(ratios[:L]):.3g}",
        warm_max_err_over_elem_bound=f"{max(ratios[L:]):.3g}",
        max_abs_attn_out=f"{max(mags):.4g}",
        max_abs_logit=f"{plain[1].abs().max().item():.4g}",
        logits_fresh_kernel_vs_plain=f"{gaps[0]:.4g}",
        logits_warm_kernel_vs_plain=f"{gaps[1]:.4g}", logits_tol=LOGITS_TOL)
    assert max(ratios) <= 1.0, \
        f"flash vs plain in-model: {max(ratios)} x the element bound"
    assert max(gaps) <= LOGITS_TOL, \
        f"flash vs plain logits differ by {max(gaps)} > {LOGITS_TOL}"


# -- phases 12-14: the seq-parallel long-context path -------------------------

_LONG = (_TEXT * 4)[:4095]   # 4096 tokens with BOS: 2 x 2048 on seq = 2


def _seq_mesh(torch):
    """seq = 2: one shard per card where there are two, else both shards
    on cuda:0. Returns (mesh, placement)."""
    from butterfly_tpu_torch.core.config import MeshConfig
    from butterfly_tpu_torch.core.mesh import make_mesh
    devs = ["cuda:0", "cuda:1"] if torch.cuda.device_count() >= 2 \
        else ["cuda:0", "cuda:0"]
    return make_mesh(MeshConfig(seq=2), devs), "+".join(devs)


def _profile(torch, run, warm_up=True):
    """Run `run` once to warm up (unless it ran already), then once under
    torch.profiler: (host wall ms, device kernel averages, device ms of
    one average)."""
    from torch.profiler import ProfilerActivity, profile
    if warm_up:
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ka = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]

    def dev_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / 1e3
    return wall, ka, dev_ms


def _profile_prefill(torch, run):
    """Where one long prefill's time goes: host wall against device busy
    time (torch.profiler), split into the ring kernel, the GEMMs and the
    rest, and the top kernels."""
    wall, ka, dev_ms = _profile(torch, run)
    busy = sum(dev_ms(e) for e in ka)
    ring = sum(dev_ms(e) for e in ka if "ring" in e.key)
    gemm = sum(dev_ms(e) for e in ka if "nvjet" in e.key or "gemm" in e.key
               or "cutlass" in e.key)
    log("longgen", profile="prefill", wall_ms=f"{wall:.1f}",
        device_busy_ms=f"{busy:.1f}",
        idle_share=f"{1 - busy / wall:.3f}" if busy else "not measured",
        ring_ms=f"{ring:.1f}",
        ring_share=f"{ring / busy:.3f}" if busy else "not measured",
        gemm_ms=f"{gemm:.1f}", other_ms=f"{busy - ring - gemm:.1f}")
    for e in sorted(ka, key=dev_ms, reverse=True)[:6]:
        log("longgen", kernel=e.key[:60].replace(" ", "_"),
            ms=f"{dev_ms(e):.2f}", calls=e.count)


def _decode_wrapper_host_ms(torch, run):
    """Host time of each T = 1 ring wrapper call (checks, the workspace
    allocation, the split and merge launches) over one `run`, unprofiled:
    the decode loop is host-bound, so this is what a call costs it.
    Returns (median ms, calls)."""
    from butterfly_tpu_torch.ops import ring_attention as ra
    orig, host = ra.ring_block_stats, []

    def timed(q, *args, **kw):
        t0 = time.perf_counter()
        out = orig(q, *args, **kw)
        if q.shape[1] == 1:
            host.append((time.perf_counter() - t0) * 1e3)
        return out
    ra.ring_block_stats = timed
    try:
        run()
        torch.cuda.synchronize()
    finally:
        ra.ring_block_stats = orig
    return statistics.median(host), len(host)


def _profile_decode(torch, run, steps):
    """One whole generate_long under the profiler: the decode steps' ring
    time (the T = 1 split and merge kernels) per generated token beside
    the device's busy time, and the T = 1 wrapper's host time per call
    from a run without the profiler."""
    host_ms, host_calls = _decode_wrapper_host_ms(torch, run)
    wall, ka, dev_ms = _profile(torch, run, warm_up=False)
    busy = sum(dev_ms(e) for e in ka)
    dec = [e for e in ka if "ring_decode" in e.key or "ring_merge" in e.key]
    ring_dec = sum(dev_ms(e) for e in dec)
    log("longgen", profile="generate_long", wall_ms=f"{wall:.1f}",
        device_busy_ms=f"{busy:.1f}",
        idle_share=f"{1 - busy / wall:.3f}" if busy else "not measured",
        decode_steps=steps, decode_ring_ms=f"{ring_dec:.2f}",
        decode_ring_ms_per_token=f"{ring_dec / steps:.3f}",
        decode_ring_calls=sum(e.count for e in dec),
        decode_ring_host_ms_per_call=f"{host_ms:.4f}",
        decode_ring_host_calls=host_calls)


def phase_longgen(torch, model, params, tok):
    """InferenceEngine.generate_long over seq = 2, 32 greedy new tokens:
    ring with bf16 KV, ring with int8 KV, Ulysses. The ring kernel's
    launches must be exact: the prefill runs N*N = 4 blocks per layer,
    each decode step N = 2 prefix blocks (one per shard) plus ONE suffix
    block per layer (the replicated suffix runs once, on the first
    device). The prefill's last-position logits are held to the dense
    prefill (the flash kernel) within LOGITS_TOL; the int8 run, whose
    attention reads quantized K/V, to the same prefill with the plain ring
    version. Returns the ring kernel's launches."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.ops import ring_attention as ra
    from butterfly_tpu_torch.parallel.sequence import sp_forward
    cfg = model.cfg
    L, N, new = cfg.num_layers, 2, 32
    mesh, where = _seq_mesh(torch)
    ids = tok.encode(_LONG)
    tokens = torch.tensor([ids], dtype=torch.int32, device="cuda")
    # the dense reference: one fresh prefill through the flash kernel
    dense = InferenceEngine(model, params)
    lens = torch.tensor([len(ids)], dtype=torch.int32, device="cuda")
    ref, _ = dense.prefill(tokens, lens, dense.new_cache(1, len(ids)))
    ref = ref[0].float()
    del dense
    torch.cuda.empty_cache()
    total = 0
    for name, kvq, impl in (("ring_bf16", "none", "ring"),
                            ("ring_int8", "int8", "ring"),
                            ("ulysses_bf16", "none", "ulysses")):
        eng = InferenceEngine(model, params,
                              RuntimeConfig(kv_quant=kvq, max_seq_len=4096),
                              mesh=mesh)
        sp = SamplingParams(max_new_tokens=new)
        ra.launches = ra.launches_decode = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.generate_long(ids, sp, impl=impl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n, n_dec = ra.launches, ra.launches_decode
        # decode steps on the T = 1 split kernel, the ring prefill on the
        # wgmma kernel (bf16 and int8 K/V alike)
        want_dec = (new - 1) * L * (N + 1)
        want = (L * N * N if impl == "ring" else 0) + want_dec
        assert n == want, f"{name}: {n} ring launches, want {want}"
        assert n_dec == want_dec, \
            f"{name}: {n_dec} T = 1 ring launches, want {want_dec}"
        _check_tokens(res, 1, new, cfg.vocab_size, name)
        total += n
        # the prefill alone, timed, and its last-position logits
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, prefix = sp_forward(eng._replicas, cfg, tokens, mesh,
                                    impl=impl, kv_quant=kvq)
        torch.cuda.synchronize()
        pf_ms = (time.perf_counter() - t0) * 1e3
        last = logits[-1][0, -1].float().to("cuda:0")
        del logits, prefix
        if name == "ring_bf16":
            _profile_prefill(torch, lambda: sp_forward(
                eng._replicas, cfg, tokens, mesh, impl=impl, kv_quant=kvq))
            _profile_decode(torch, lambda: eng.generate_long(ids, sp,
                                                             impl=impl),
                            new - 1)
        if kvq == "int8":
            plain, _ = sp_forward(eng._replicas, cfg, tokens, mesh,
                                  impl=impl, kv_quant=kvq, kernel=False)
            against, gap = "plain_ring", (last - plain[-1][0, -1].float()
                                          .to("cuda:0")).abs().max().item()
            del plain
        else:
            against, gap = "dense_flash", (last - ref).abs().max().item()
        assert torch.isfinite(last).all(), f"{name}: prefill logits"
        assert gap <= LOGITS_TOL, f"{name}: prefill logits differ by {gap}"
        log("longgen", run=name, card=torch.cuda.get_device_name(0)
            .replace(" ", "_"), shards=where, prompt_tokens=len(ids),
            new_tokens=new, wall_s=f"{wall:.3f}",
            tokens_per_s=f"{new / wall:.2f}", prefill_ms=f"{pf_ms:.1f}",
            ring_launches=n, ring_wgmma_launches=n - n_dec,
            ring_split_launches=n_dec, logits_vs=against,
            logits_gap=f"{gap:.4g}",
            logits_tol=LOGITS_TOL, note="smoke run, not a benchmark")
        del eng
        torch.cuda.empty_cache()
    return total


def phase_ring_parity(torch, model, params, tok):
    """One sp_forward of the long prompt (ring, bf16 KV) through all 32
    layers: every ring block's kernel stats, finalised, against the plain
    version on the same inputs within the ring phase's element bound
    (masked rows exact), and the logits against the all-plain pass."""
    import butterfly_tpu_torch.parallel.sequence as seq_mod
    from butterfly_tpu_torch.ops import ring_attention as ra
    from butterfly_tpu_torch.parallel.sequence import (replicate_params,
                                                       sp_forward)
    cfg = model.cfg
    mesh, where = _seq_mesh(torch)
    reps = replicate_params(params, mesh.seq_devices())
    ids = tok.encode(_LONG)
    tokens = torch.tensor([ids], dtype=torch.int32, device="cuda")
    ratios, errs = [], []

    def checked(*args, kernel=None):
        stats = ra.ring_block_stats(*args)
        ref = ra.ring_block_stats_ref(*args)
        _, _, out_err, elem, _ = _ring_check(torch, ra, args, stats, ref,
                                             True)
        errs.append(out_err)
        ratios.append(elem)
        return stats

    seq_mod.block_stats = checked
    try:
        kern, _ = sp_forward(reps, cfg, tokens, mesh)
    finally:
        seq_mod.block_stats = ra.block_stats
    plain, _ = sp_forward(reps, cfg, tokens, mesh, kernel=False)
    torch.cuda.synchronize()
    assert len(ratios) == cfg.num_layers * 4, len(ratios)
    gaps = [(a.float().to("cuda:0") - b.float().to("cuda:0")).abs().max()
            .item() for a, b in zip(kern, plain)]
    log("ringpar", shards=where, layers=cfg.num_layers, blocks=len(ratios),
        max_block_abs_err=f"{max(errs):.3g}",
        max_err_over_elem_bound=f"{max(ratios):.3g}",
        logits_kernel_vs_plain=f"{max(gaps):.4g}", logits_tol=LOGITS_TOL)
    assert max(ratios) <= 1.0, f"ring vs plain in-model: {max(ratios)} x bound"
    assert max(gaps) <= LOGITS_TOL, f"ring logits differ by {max(gaps)}"
    del kern, plain, reps
    torch.cuda.empty_cache()


def phase_longserve(torch, model, params, tok):
    """ServingEngine over seq = 2 with the long-prompt lane
    (seq_parallel_threshold 1024, max_seq_len 4096) + Scheduler, mixed
    dispatch: 2 long prompts (3000 and 4000 bytes) and 4 short ones, all
    greedy. Every lane chunk launches the ring kernel N = 2 times per layer
    over the slot's pool prefix plus N*N = 4 for the ring over the chunk,
    so ring and paged launches are multiples of 32. Returns the ring and
    paged kernels' launches."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.ops import ring_attention as ra
    from butterfly_tpu_torch.ops.paged_attention import paged_attention
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    cfg = model.cfg
    L = cfg.num_layers
    mesh, where = _seq_mesh(torch)
    rt = RuntimeConfig(max_batch_size=8, max_seq_len=4096, page_size=16,
                       seq_parallel_threshold=1024)
    engine = ServingEngine(model, params, rt, mesh=mesh)
    sched = Scheduler(engine)
    sizes = [3000, 16, 200, 4000, 600, 1000]
    news = [32, 40, 48, 32, 56, 64]
    ra.launches = ra.launches_decode = paged_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    reqs = [sched.submit(tok.encode(_LONG[:n]), max_new_tokens=m)
            for n, m in zip(sizes, news)]
    sched.run_until_done()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n_ring, n_paged = ra.launches, paged_attention.launches
    n_wg = n_ring - ra.launches_decode   # chunks: T > 1, the wgmma kernel
    assert n_wg > 0, "the lane never launched the wgmma ring kernel"
    for r, m in zip(reqs, news):
        assert r.state == "finished" and len(r.output) == m, \
            f"request {r.id}: {r.state}, {len(r.output)} tokens"
        assert all(0 <= t < cfg.vocab_size for t in r.output)
    sp_tokens = sched.metrics()["seq_parallel_prefill_tokens_total"]
    assert sp_tokens > 0, "no prompt went through the seq-parallel lane"
    for kname, n in (("ring", n_ring), ("paged", n_paged)):
        assert n > 0, f"the {kname} kernel never launched on this path"
        assert n % L == 0, f"{kname}: {n} launches, not a multiple of {L}"
    ttfts = sorted(r.ttft for r in reqs)
    gen_tokens = sum(len(r.output) for r in reqs)
    log("longserve", card=torch.cuda.get_device_name(0).replace(" ", "_"),
        shards=where, threshold=rt.seq_parallel_threshold,
        prompt_bytes=",".join(map(str, sizes)), requests=len(reqs),
        generated_tokens=gen_tokens, wall_s=f"{wall:.3f}",
        tokens_per_s=f"{gen_tokens / wall:.2f}",
        ttft_p50_s=f"{statistics.median(ttfts):.4f}",
        ttft_max_s=f"{ttfts[-1]:.4f}", sp_prefill_tokens=int(sp_tokens),
        ring_launches=n_ring, ring_wgmma_launches=n_wg,
        paged_launches=n_paged, note="smoke run, not a benchmark")
    engine.cache = engine._kv_window = None
    del engine, sched
    torch.cuda.empty_cache()
    return n_ring, n_paged


# -- phase 15: int8 weights ------------------------------------------------------

def _tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.nbytes


def _int8_leaves(tree):
    """Every {"q8", "s"} leaf of the tree."""
    if isinstance(tree, dict):
        if "q8" in tree and "s" in tree:
            return [tree]
        return [x for v in tree.values() for x in _int8_leaves(v)]
    return []


def phase_quant(torch, model, params, tok):
    """int8 weights (quant/int8.py) on the shared Llama-3-8B tree:
    quantize_int8, the int8 tree's bytes (codes held as int8), one prefill
    + decode step's logits against the same step on the maybe_dequant
    bf16 tree (0.5 absolute), generate (4 greedy prompts, 32 new,
    fused then stepped: equal tokens; the fresh flash kernel 32 times per
    prefill), 8 concurrent greedy requests through
    serve/server.build_serving with --quant int8 (paged launches a
    multiple of 32), and one decode step's host wall and device busy time
    with int8 and with bf16 weights (_decode_step_profile). Returns
    (int8 tree, {kernel: launches})."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.models.common import forward, init_cache
    from butterfly_tpu_torch.ops.flash_attention import flash_attention
    from butterfly_tpu_torch.ops.paged_attention import paged_attention
    from butterfly_tpu_torch.quant.int8 import dequant_tree, quantize_int8
    from butterfly_tpu_torch.serve import cli
    from butterfly_tpu_torch.serve.server import build_serving
    cfg = model.cfg
    L = cfg.num_layers
    card = torch.cuda.get_device_name(0).replace(" ", "_")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = quantize_int8(params, cfg)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    leaves = _int8_leaves(qparams)
    assert len(leaves) == 7 + 1, f"{len(leaves)} quantized leaves"
    for leaf in leaves:
        assert leaf["q8"].dtype == torch.int8 and leaf["q8"].is_cuda
    q_bytes = sum(leaf["q8"].nbytes for leaf in leaves)
    s_bytes = sum(leaf["s"].nbytes for leaf in leaves)
    log("quant", card=card, quantize_s=f"{quant_s:.2f}",
        bf16_tree_GB=f"{_tree_bytes(params) / 1e9:.3f}",
        int8_tree_GB=f"{_tree_bytes(qparams) / 1e9:.3f}",
        int8_codes_GB=f"{q_bytes / 1e9:.3f}",
        scales_MB=f"{s_bytes / 1e6:.2f}", quantized_leaves=len(leaves))

    # one prefill + decode step: int8 tree against its dequantized twin
    deq = dequant_tree(qparams, torch.bfloat16)
    ids = tok.encode(_TEXT[:200])
    outs = {}
    for name, tree in (("int8", qparams), ("dequant", deq)):
        cache = init_cache(cfg, 1, 256, device="cuda")
        pf, cache = forward(tree, cfg, torch.tensor([ids], device="cuda"),
                            cache, fresh=True)
        nxt = pf[:, -1].argmax(-1).to(torch.int32)
        step, _ = forward(tree, cfg, nxt[:, None], cache)
        outs[name] = (pf[0, -1].float(), step[0, -1].float(), nxt)
    del deq, cache
    torch.cuda.empty_cache()
    (pf_i, st_i, n_i), (pf_d, st_d, n_d) = outs["int8"], outs["dequant"]
    assert torch.equal(n_i, n_d), "the prefill's greedy tokens differ"
    d_pf = (pf_i - pf_d).abs().max().item()
    d_st = (st_i - st_d).abs().max().item()
    for x in (pf_i, st_i):
        assert torch.isfinite(x).all()
    log("quant", check="int8_vs_dequant_bf16", prompt_tokens=len(ids),
        prefill_logits_max_abs_diff=f"{d_pf:.4g}",
        decode_logits_max_abs_diff=f"{d_st:.4g}", tol=LOGITS_TOL,
        max_abs_logit=f"{st_d.abs().max().item():.4g}",
        argmax_equal=bool(st_i.argmax() == st_d.argmax()))
    assert d_pf <= LOGITS_TOL and d_st <= LOGITS_TOL, (d_pf, d_st)

    # generate on the int8 tree, fused then stepped
    prompts = [tok.encode(_TEXT[:n]) for n in (16, 200, 600, 1000)]
    B, new = len(prompts), 32
    eng = InferenceEngine(model, qparams, RuntimeConfig())
    assert all(leaf["q8"].dtype == torch.int8
               for leaf in _int8_leaves(eng.params))
    counts = {"fresh": 0, "paged": 0}
    toks = {}
    for fused in (True, False):
        flash_attention.launches_fresh = flash_attention.launches_warm = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.generate(prompts, SamplingParams(max_new_tokens=new),
                           fused=fused)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_fresh = flash_attention.launches_fresh
        assert n_fresh == L and flash_attention.launches_warm == 0, n_fresh
        counts["fresh"] += n_fresh
        _check_tokens(res, B, new, cfg.vocab_size, f"int8 fused={fused}")
        toks[fused] = res.tokens
        log("quant", run="generate_fused" if fused else "generate_stepped",
            batch=B, new_tokens=new, wall_s=f"{wall:.3f}",
            tokens_per_s=f"{B * new / wall:.2f}", fresh_launches=n_fresh,
            note="smoke run, not a benchmark")
    assert (toks[True] == toks[False]).all(), "fused and stepped differ"
    del eng
    torch.cuda.empty_cache()

    # serve --quant int8: 8 concurrent greedy requests
    args = cli.build_parser().parse_args(
        ["serve", "--model", "llama3-8b", "--device", "cuda", "--quant",
         "int8", "--port", "0", "--timeseries-interval", "0"])
    with _cli_params(cli, qparams):
        sched, _, rt = build_serving(args)
    engine = sched.engine
    assert all(leaf["q8"].dtype == torch.int8
               for leaf in _int8_leaves(engine.params))
    sizes = [16, 64, 200, 400, 600, 800, 1000, 1200]
    news = [32, 40, 48, 56, 64, 32, 40, 64]
    paged_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    reqs = [sched.submit(tok.encode(_TEXT[:n]), max_new_tokens=m)
            for n, m in zip(sizes, news)]
    sched.run_until_done()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n_paged = paged_attention.launches
    for r, m in zip(reqs, news):
        assert r.state == "finished" and len(r.output) == m, r.id
        assert all(0 <= t < cfg.vocab_size for t in r.output)
    assert n_paged > 0 and n_paged % L == 0, n_paged
    counts["paged"] += n_paged
    gen_tokens = sum(len(r.output) for r in reqs)
    log("quant", run="serve_int8", requests=len(reqs),
        generated_tokens=gen_tokens, wall_s=f"{wall:.3f}",
        tokens_per_s=f"{gen_tokens / wall:.2f}", paged_launches=n_paged,
        note="smoke run, not a benchmark")
    del sched

    # one decode step, int8 against bf16 weights (same engine shape)
    prof = {}
    for name, eng in (("int8", engine),
                      ("bf16", None)):
        if eng is None:
            eng = ServingEngine(model, params, rt)
        step_ms, wall_ms, busy, _, _ = _decode_step_profile(torch, eng)
        prof[name] = (step_ms, wall_ms, busy)
        log("quant", decode_step=name, card=card, slots=eng.num_slots,
            host_wall_ms=f"{step_ms:.3f}", traced_wall_ms=f"{wall_ms:.3f}",
            device_busy_ms=f"{busy:.3f}" if busy else "not measured",
            idle_share=f"{1 - busy / wall_ms:.3f}" if busy
            else "not measured",
            decode_tok_s=f"{eng.num_slots / step_ms * 1e3:.2f}")
        eng.cache = eng._kv_window = None
        del eng
        torch.cuda.empty_cache()
    engine = None
    return qparams, counts


# -- phase 16: speculative decoding ------------------------------------------------

SPEC_PROMPT_LEN = 32   # run_spec_benchmark's prompt shape
SPEC_NEW = 32


def _teacher_forced_gap(torch, params, cfg, prompt, out):
    """Prompt + output through one plain forward (fresh, dense): the
    largest gap, over the emitted positions, between that position's
    maximum logit and the emitted token's logit."""
    from butterfly_tpu_torch.models.common import forward, init_cache
    seq = list(prompt) + list(out)
    cache = init_cache(cfg, 1, len(seq), device="cuda")
    logits, _ = forward(params, cfg, torch.tensor([seq], device="cuda"),
                        cache, fresh=True)
    lg = logits[0, len(prompt) - 1:len(seq) - 1].float()
    emitted = torch.tensor(out, device="cuda", dtype=torch.long)
    gap = lg.max(-1).values - lg.gather(1, emitted[:, None])[:, 0]
    return gap.max().item()


def _divergence(a, b):
    """First position where two token lists differ (None when equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def _oracle_drafts(torch, refs):
    """A draft function (the DRAFT_SOURCES contract: hist [S, H],
    hist_len [S], gamma, ngram -> drafts [S, gamma], on the device) that
    proposes the next gamma tokens of the reference sequence whose first
    8 tokens are the slot's, zero where there is none."""
    width = max(len(r) for r in refs)
    R = torch.zeros((len(refs), width), dtype=torch.int32, device="cuda")
    for i, r in enumerate(refs):
        R[i, :len(r)] = torch.tensor(r, dtype=torch.int32)
    K = 8

    def fn(hist, hist_len, gamma, ngram):
        match = (hist[:, None, :K] == R[None, :, :K]).all(-1)   # [S, n]
        rows = R[match.to(torch.int32).argmax(1)]               # [S, W]
        pos = hist_len.long()[:, None] \
            + torch.arange(gamma, device=hist.device)[None, :]
        ok = match.any(1)[:, None] & (pos < width)
        d = torch.gather(rows, 1, pos.clamp(0, width - 1))
        return torch.where(ok, d, torch.zeros_like(d))
    return fn


def _spec_run(torch, label, rt, drive, params, cfg, prompts, off, card):
    """One spec configuration of phase_spec, with its checks and line."""
    out, m, wall, gen, n = drive(label, rt)
    assert m["spec_forwards_total"] > 0, label
    if label == "a_oracle":
        assert m["spec_drafts_accepted_total"] > 0, "no draft accepted"
    if label.startswith(("b_", "c_")):
        assert n["fresh"] > 0, f"{label}: no fresh flash launch"
    gap = max(_teacher_forced_gap(torch, params, cfg, p, o)
              for p, o in zip(prompts, out))
    div = [_divergence(o, r) for o, r in zip(out, off)]
    log("spec", run=label, card=card,
        mixed_dispatch=m.get("spec_mixed_fallback_reason") is None,
        tokens_per_forward=f"{m.get('spec_tokens_per_forward', 0):.3f}",
        accept_rate=f"{m.get('spec_accept_rate', 0):.3f}",
        spec_forwards=int(m["spec_forwards_total"]),
        drafts_accepted=int(m["spec_drafts_accepted_total"]),
        tokens_per_s=f"{gen / wall:.2f}", wall_s=f"{wall:.3f}",
        teacher_forced_max_gap=f"{gap:.4g}", tol=LOGITS_TOL,
        equal_to_spec_off=sum(d is None for d in div),
        first_divergence=",".join("-" if d is None else str(d)
                                  for d in div),
        fresh_launches=n["fresh"], warm_launches=n["warm"],
        paged_launches=n["paged"], note="smoke run, not a benchmark")
    assert gap <= LOGITS_TOL, f"{label}: teacher-forced gap {gap}"


def phase_spec(torch, model, params, tok):
    """ServingEngine + Scheduler with speculation on the shared weights:
    8 greedy requests on draft-friendly prompts (obs/benchmark.py
    draft_friendly_prompts), 32 new tokens each: (a) ngram, gamma 4,
    the serve CLI's defaults (mixed dispatch, window on), and the same
    with the oracle draft function (_oracle_drafts: the spec-off run's
    tokens), which must have drafts accepted; (b) the draft model of 8
    layers (the alternating fallback: fresh / warm flash launches
    multiples of 32); (c) a width-2, 5-node token tree with that draft;
    (d) generate_speculative on one prompt; (e) (a) at temperature 0.8
    (must finish). For (a)-(d): every request finishes, verify forwards
    happen, and every emitted token's logit in one plain forward of
    prompt + output is within LOGITS_TOL of that position's maximum.
    Returns {kernel: launches}."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.engine.serving import (
        DRAFT_SOURCES, ServingEngine, register_draft_source)
    from butterfly_tpu_torch.obs.benchmark import draft_friendly_prompts
    from butterfly_tpu_torch.ops.flash_attention import flash_attention
    from butterfly_tpu_torch.ops.paged_attention import paged_attention
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    cfg = model.cfg
    L = cfg.num_layers
    card = torch.cuda.get_device_name(0).replace(" ", "_")
    base = RuntimeConfig(max_batch_size=8, max_seq_len=2048, page_size=16)
    t0 = time.monotonic()
    prompts = draft_friendly_prompts(
        Scheduler(ServingEngine(model, params, base)), 8, SPEC_PROMPT_LEN)
    log("spec", prompts=len(prompts), prompt_tokens=len(prompts[0]),
        new_tokens=SPEC_NEW, harvest_s=f"{time.monotonic() - t0:.1f}")
    counts = {"fresh": 0, "warm": 0, "paged": 0}

    def drive(label, rt, temperature=0.0):
        engine = ServingEngine(model, params, rt)
        sched = Scheduler(engine)
        flash_attention.launches_fresh = flash_attention.launches_warm = 0
        paged_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        reqs = [sched.submit(p, max_new_tokens=SPEC_NEW,
                             temperature=temperature) for p in prompts]
        sched.run_until_done()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        n = {"fresh": flash_attention.launches_fresh,
             "warm": flash_attention.launches_warm,
             "paged": paged_attention.launches}
        for r in reqs:
            assert r.state == "finished" and len(r.output) == SPEC_NEW, \
                f"{label}: request {r.id} {r.state} {len(r.output)}"
            assert all(0 <= t < cfg.vocab_size for t in r.output), label
        for k, v in n.items():
            assert v % L == 0, f"{label}: {k} {v} launches"
            counts[k] += v
        m = sched.metrics()
        gen = sum(len(r.output) for r in reqs)
        out = [r.output for r in reqs]
        engine.cache = engine._kv_window = None
        del engine, sched
        torch.cuda.empty_cache()
        return out, m, wall, gen, n

    off, _, wall_off, gen_off, _ = drive("off", base)
    log("spec", run="off", tokens_per_s=f"{gen_off / wall_off:.2f}",
        wall_s=f"{wall_off:.3f}")
    # Random Llama-3-8B weights never repeat themselves (a probe of 300
    # greedy tokens gave 299 distinct), so prompt lookup finds no draft
    # the verify accepts. The accept path is driven by (a_oracle): the
    # same mixed spec block with a draft function, registered through
    # register_draft_source, that proposes the spec-off run's tokens.
    register_draft_source("oracle", _oracle_drafts(
        torch, [p + o for p, o in zip(prompts, off)]))
    runs = [
        ("a_ngram", base.replace(speculative_gamma=4)),
        ("a_oracle", base.replace(speculative_gamma=4,
                                  draft_model="oracle")),
        ("b_model8", base.replace(speculative_gamma=4, draft_model="model",
                                  draft_layers=8)),
        ("c_tree_w2_n5", base.replace(speculative_gamma=4,
                                      draft_model="model", draft_layers=8,
                                      spec_tree_width=2, spec_tree_nodes=5)),
    ]
    try:
        for label, rt in runs:
            _spec_run(torch, label, rt, drive, params, cfg, prompts, off,
                      card)
    finally:
        DRAFT_SOURCES.pop("oracle", None)

    # (d) generate_speculative on one prompt
    eng = InferenceEngine(model, params, RuntimeConfig())
    sp = SamplingParams(max_new_tokens=SPEC_NEW)
    flash_attention.launches_fresh = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate_speculative(prompts[0], sp, gamma=4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert flash_attention.launches_fresh == L
    counts["fresh"] += L
    out = res.tokens.tolist()
    assert len(out) == SPEC_NEW and res.forwards > 1
    gap = _teacher_forced_gap(torch, params, cfg, prompts[0], out)
    log("spec", run="d_generate_speculative",
        tokens_per_forward=f"{res.tokens_per_forward:.3f}",
        forwards=res.forwards, drafts_accepted=res.accepted_drafts,
        tokens_per_s=f"{len(out) / wall:.2f}",
        teacher_forced_max_gap=f"{gap:.4g}",
        first_divergence_vs_serving_off=_divergence(out, off[0]))
    assert gap <= LOGITS_TOL, f"generate_speculative: gap {gap}"
    del eng
    torch.cuda.empty_cache()

    # (e) (a) at temperature 0.8
    _, m, wall, gen, _ = drive("e_ngram_t0.8",
                               base.replace(speculative_gamma=4), 0.8)
    log("spec", run="e_ngram_t0.8",
        tokens_per_forward=f"{m.get('spec_tokens_per_forward', 0):.3f}",
        accept_rate=f"{m.get('spec_accept_rate', 0):.3f}",
        tokens_per_s=f"{gen / wall:.2f}")
    return counts


# -- phase 17: the disaggregated fleet ----------------------------------------

#: the fleet phase's shape: 2 prefill + 2 decode replicas of the shared
#: Llama-3-8B tree, 4 slots of 1024 tokens each in 16-token pages
FLEET = dict(page_size=16, max_batch=4, max_seq=1024, disagg_threshold=64)
FLEET_PROMPT, FLEET_SHARED, FLEET_NEW, FLEET_REQUESTS = 384, 256, 32, 8


def _fleet_prompts(vocab):
    """8 token prompts of 384 tokens from a seed; the even ones share a
    256-token head, the odd ones are private."""
    import numpy as np
    rng = np.random.default_rng(0)
    shared = rng.integers(1, vocab, FLEET_SHARED).tolist()
    return [shared + rng.integers(1, vocab,
                                  FLEET_PROMPT - FLEET_SHARED).tolist()
            if i % 2 == 0 else rng.integers(1, vocab, FLEET_PROMPT).tolist()
            for i in range(FLEET_REQUESTS)]


def _fleet_run(url, prompts, tag):
    """The prompts through the control plane's /generate from 4 client
    threads (2 requests each), greedy, FLEET_NEW tokens. Returns
    ([(status, body)] in prompt order, wall seconds)."""
    results = [None] * len(prompts)

    def client(c):
        for i in range(c, len(prompts), 4):
            results[i] = _post(url, {"tokens": prompts[i],
                                     "max_tokens": FLEET_NEW,
                                     "temperature": 0.0, "stop_token": -1,
                                     "request_id": f"{tag}-{i}"})
    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    for i, r in enumerate(results):
        assert r is not None, f"{tag} request {i} got no answer"
        code, body = r
        assert code == 200, f"{tag} request {i}: HTTP {code}"
        assert len(body["tokens"]) == FLEET_NEW, \
            f"{tag} request {i}: {len(body['tokens'])} tokens"
    return [b for _, b in results], wall


def _legs(tracer, tag):
    """Median seconds of each control-plane leg span of the requests
    whose id starts with `tag`, and each leg's count by status ("ok",
    or the HTTP code of a failed leg, "None" for a transport failure)."""
    legs, status = {}, {}
    for tl in tracer.timelines():
        if not (tl["request_id"] or "").startswith(tag):
            continue
        for ev in tl["events"]:
            if "dur_s" in ev:
                legs.setdefault(ev["name"], []).append(ev["dur_s"])
                by = status.setdefault(ev["name"], {})
                st = str(ev.get("status", "ok"))
                by[st] = by.get(st, 0) + 1
    return ({k: statistics.median(v) for k, v in sorted(legs.items())},
            {k: "+".join(f"{n}x{st}" for st, n in sorted(v.items()))
             for k, v in sorted(status.items())})


def _pool_bytes(engine):
    c = engine.cache
    return sum(t.numel() * t.element_size()
               for t in (c.k_pages, c.v_pages, c.k_scale_pages,
                         c.v_scale_pages) if t is not None)


def phase_fleet(torch, model, params):
    """`butterfly fleet` on the card: fleet/harness.start_fleet("2p2d")
    over the shared Llama-3-8B weights (full width and depth, one tree for
    all four replicas), the control plane in front, on cuda. A direct run
    (disaggregation off) and a disaggregated run of the same 8 requests;
    the page bytes of an export -> import -> export; a drained restart of
    one decode replica under load with nothing dropped; spawn and retire
    of a decode replica, its pool's memory given back. Returns {kernel:
    launches} (the paged kernel's count over the phase)."""
    import gc

    import numpy as np

    from butterfly_tpu_torch.cache.prefix import (PrefixCachingAllocator,
                                                  chain_block_hashes)
    from butterfly_tpu_torch.fleet.harness import start_fleet
    from butterfly_tpu_torch.ops.paged_attention import paged_attention
    from butterfly_tpu_torch.workload import loadgen as lg
    card = torch.cuda.get_device_name(0).replace(" ", "_")
    cfg = model.cfg
    paged_attention.launches = 0
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    fleet = start_fleet("2p2d", model=model, params=params, device="cuda",
                        **FLEET)
    try:
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        pool = _pool_bytes(fleet.replicas[0].sched.engine)
        log("fleet", card=card, topology="2p2d", layers=cfg.num_layers,
            hidden=cfg.hidden_size, dtype=cfg.dtype,
            start_s=f"{time.monotonic() - t0:.1f}",
            memory_allocated_GiB_before=f"{mem0 / 2**30:.3f}",
            memory_allocated_GiB_after=f"{mem1 / 2**30:.3f}",
            pool_GiB=f"{pool / 2**30:.3f}",
            allocators=",".join(type(r.sched.alloc).__name__
                                for r in fleet.replicas))
        assert mem1 - mem0 < 8 * 2**30, "the weights were copied"
        # KV transfer addresses pages through the prefix registry, so a
        # fleet replica always runs the prefix-caching allocator
        assert all(isinstance(r.sched.alloc, PrefixCachingAllocator)
                   for r in fleet.replicas)

        prompts = _fleet_prompts(cfg.vocab_size)
        c0 = fleet.state.fleet_counters()
        fleet.state.disagg_threshold = 10 ** 9
        direct, wall_direct = _fleet_run(fleet.url, prompts, "direct")
        c1 = fleet.state.fleet_counters()
        fleet.state.disagg_threshold = FLEET["disagg_threshold"]
        disagg, wall_disagg = _fleet_run(fleet.url, prompts, "disagg")
        c2 = fleet.state.fleet_counters()
        n_disagg = c2["disagg_requests"] - c1["disagg_requests"]
        pages = c2["kv_transfer_pages"] - c1["kv_transfer_pages"]
        xbytes = c2["kv_transfer_bytes"] - c1["kv_transfer_bytes"]
        assert c1["disagg_requests"] == c0["disagg_requests"]
        assert n_disagg == FLEET_REQUESTS, f"{n_disagg} disaggregated"
        assert all(b.get("disaggregated") for b in disagg)
        assert pages > 0, "no KV page transferred"
        div = [_divergence(d["tokens"], r["tokens"])
               for d, r in zip(disagg, direct)]
        gap = max(_teacher_forced_gap(torch, params, cfg, p, b["tokens"])
                  for p, b in zip(prompts, disagg))
        legs, legs_status = _legs(fleet.state.tracer, "disagg")
        legs_direct, _ = _legs(fleet.state.tracer, "direct")
        n_tokens = FLEET_REQUESTS * FLEET_NEW
        ttft_d = sorted(b["ttft_s"] for b in direct)
        ttft_x = sorted(b["ttft_s"] for b in disagg)

        def p95(xs):
            return xs[min(len(xs) - 1, int(round(0.95 * (len(xs) - 1))))]
        log("fleet", run="direct_vs_disagg", card=card,
            equal_to_direct=sum(d is None for d in div),
            first_divergence=",".join("-" if d is None else str(d)
                                      for d in div),
            teacher_forced_max_gap=f"{gap:.4g}", tol=LOGITS_TOL,
            fleet_disaggregated=int(n_disagg), kv_transfer_pages=int(pages),
            kv_transfer_bytes=int(xbytes),
            ttft_direct_p50_s=f"{statistics.median(ttft_d):.4f}",
            ttft_direct_p95_s=f"{p95(ttft_d):.4f}",
            ttft_disagg_p50_s=f"{statistics.median(ttft_x):.4f}",
            ttft_disagg_p95_s=f"{p95(ttft_x):.4f}",
            wall_direct_s=f"{wall_direct:.3f}",
            wall_disagg_s=f"{wall_disagg:.3f}",
            tokens_per_s_direct=f"{n_tokens / wall_direct:.2f}",
            tokens_per_s_disagg=f"{n_tokens / wall_disagg:.2f}",
            note="smoke run, not a benchmark")
        log("fleet", run="leg_medians_s", card=card,
            **{f"disagg_{k}": f"{v:.4f}" for k, v in legs.items()},
            **{f"direct_{k}": f"{v:.4f}" for k, v in legs_direct.items()})
        # the /kv legs take the replica's serving lock with a 2 s bound:
        # a longer tick answers 503 and the decode replica prefills the
        # prompt itself
        log("fleet", run="leg_status", card=card,
            **{f"disagg_{k}": v for k, v in legs_status.items()})
        log("fleet", run="tick_host_frac", card=card,
            **{f"{r.role}_{r.port}":
               "{:.4f}".format(r.sched.metrics().get("tick_host_frac", -1))
               for r in fleet.replicas})
        assert gap <= LOGITS_TOL, f"teacher-forced gap {gap}"

        # payload bytes: export -> import -> export
        pre, dec = fleet.replicas[0], fleet.replicas[2]
        probe = np.random.default_rng(1).integers(
            1, cfg.vocab_size, FLEET_PROMPT).tolist()
        lg._post_json(pre.url, "/generate", {"tokens": probe,
                                             "max_tokens": 1,
                                             "stop_token": -1}, timeout=600)
        path = "/kv/pages?hashes=" + ",".join(
            h.hex() for h in chain_block_hashes(probe, FLEET["page_size"]))
        t0 = time.monotonic()
        a = lg._get_json(pre.url, path, timeout=600)
        t_export = time.monotonic() - t0
        t0 = time.monotonic()
        res = lg._post_json(dec.url, "/kv/import", a, timeout=600)
        t_import = time.monotonic() - t0
        b = lg._get_json(dec.url, path, timeout=600)
        assert len(a["pages"]) == FLEET_PROMPT // FLEET["page_size"]
        assert res["imported"] + res["skipped"] == len(a["pages"])
        assert b["pages"] == a["pages"], "page bytes changed in transit"
        log("fleet", run="payload", card=card, pages=len(a["pages"]),
            raw_bytes=a["bytes"],
            json_bytes=len(json.dumps(a).encode()),
            export_s=f"{t_export:.3f}", import_s=f"{t_import:.3f}",
            identical_after_roundtrip=True)

        # a drained restart of one decode replica under load
        soak = lg.run_fleet_soak(
            fleet.url, clients=4, requests_per_client=2, prefix_share=0.5,
            shared_len=FLEET_SHARED, tail_len=FLEET_PROMPT - FLEET_SHARED,
            max_tokens=FLEET_NEW, seed=1, vocab=cfg.vocab_size,
            timeout=600.0, replicas=[dec.rid],
            restart_hook=lambda rid: fleet.by_rid[rid].restart())
        log("fleet", run="restart", card=card, replica=dec.rid,
            sent=soak["sent"], failed=soak["failed"],
            cycles=len(soak["rolling_cycles"]),
            drained=soak["rolling_cycles"][0].get("drained"))
        assert soak["sent"] == 8 and soak["failed"] == 0, soak
        assert soak["rolling_cycles"][0].get("restarted")

        # spawn and retire a decode replica: its pool must go away
        gc.collect()
        torch.cuda.synchronize()
        m_before = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        handle = fleet.spawn("decode")
        t_spawn = time.monotonic() - t0
        r = lg._post_json(handle.url, "/generate",
                          {"tokens": prompts[0][:64], "max_tokens": 4,
                           "stop_token": -1}, timeout=600)
        assert len(r["tokens"]) == 4
        torch.cuda.synchronize()
        m_spawned = torch.cuda.memory_allocated()
        rid = handle.rid
        del handle, r
        t0 = time.monotonic()
        assert fleet.retire(rid)
        t_retire = time.monotonic() - t0
        torch.cuda.synchronize()
        m_after = torch.cuda.memory_allocated()
        log("fleet", run="spawn_retire", card=card,
            spawn_s=f"{t_spawn:.2f}", retire_s=f"{t_retire:.2f}",
            memory_allocated_GiB_before=f"{m_before / 2**30:.3f}",
            memory_allocated_GiB_spawned=f"{m_spawned / 2**30:.3f}",
            memory_allocated_GiB_after=f"{m_after / 2**30:.3f}",
            pool_GiB=f"{pool / 2**30:.3f}")
        assert abs(m_after - m_before) < pool, \
            "the retired replica's pool is still allocated"
    finally:
        fleet.stop()
    launches = paged_attention.launches
    assert launches > 0, "the paged kernel never launched in the fleet"
    log("fleet", card=card, paged_attention_launches=launches)
    del fleet
    gc.collect()
    torch.cuda.empty_cache()
    return {"paged": launches}


# -- phase 18: the benchmark legs ---------------------------------------------

#: the mixed leg's shape: the JAX package's CPU bench round (12
#: mixed_chat requests, 8-48 prompt and 16-48 new tokens, 8-token pages,
#: 4 slots, the pool at 0.35 of worst-case demand, one burst), with TTFT
#: shedding off (the card's TTFT exceeds the leg's 1 s default SLO, so it
#: would shed instead of contend) and a host tier of 512 MiB (a
#: Llama-3-8B page of 8 tokens holds 1 MiB of K/V: 512 pages)
BENCH_MIXED = dict(n_requests=12, max_batch=4, prompt_lo=8, prompt_hi=48,
                   max_new_lo=16, max_new_hi=48, page_size=8,
                   pool_fraction=0.35, arrival="burst:2000:0.5:0.1",
                   slo_ttft_ms=None, host_kv_tier_mb=512.0,
                   max_seconds=180.0)


def phase_bench(torch, model, params, qparams):
    """The benchmark legs of obs/benchmark.py called directly on the
    shared Llama-3-8B weights (not built a second time), sized by request
    counts and max_seconds, never by width or depth; each leg's JSON on a
    labelled line with its wall seconds. The decode leg runs once more on
    the int8 tree `qparams`, and the speculation leg (spec on vs off, the
    ngram / model / tree rows) on the bf16 weights, then the fleet, chaos
    and autoscale legs at their defaults (in-process tiny-model fleets on
    the card). Then one `butterfly bench --model tiny --device cuda
    --serving` (head_dim 16 in f32: the ring kernel's CUDA-core route at
    the tiny heads). The four kernels' counts
    are zeroed just before and read just after; each must have launched.
    Returns {kernel: launches}."""
    import contextlib
    import io

    from butterfly_tpu_torch.obs import benchmark as bm
    from butterfly_tpu_torch.ops import ring_attention as ra
    from butterfly_tpu_torch.ops.flash_attention import flash_attention
    from butterfly_tpu_torch.ops.paged_attention import paged_attention
    from butterfly_tpu_torch.serve.cli import main as cli_main
    card = torch.cuda.get_device_name(0).replace(" ", "_")
    legs = [
        ("decode", lambda: bm.run_decode_benchmark(
            model, params, batch=8, prompt_len=128, max_new=64)),
        ("serving", lambda: bm.run_serving_benchmark(
            model, params, n_requests=16, prompt_len=128, max_new=32,
            max_batch=8)),
        ("warm_prefill", lambda: bm.run_warm_prefill_benchmark(
            model, params, repeats=1)),
        ("longctx", lambda: bm.run_longctx_benchmark(model, params)),
        ("mixed", lambda: bm.run_mixed_benchmark(model, params,
                                                 **BENCH_MIXED)),
        ("decode_int8", lambda: bm.run_decode_benchmark(
            model, qparams, batch=8, prompt_len=128, max_new=64)),
        ("spec", lambda: bm.run_spec_benchmark(
            model, params, n_requests=8, prompt_len=SPEC_PROMPT_LEN,
            max_new=SPEC_NEW, max_batch=8, gamma=4, draft_layers=1)),
        # the fleet legs at the JAX defaults: tiny-model replicas, since
        # they measure the control plane, not the model
        ("fleet", lambda: bm.run_fleet_benchmark("2p2d", device="cuda")),
        ("chaos", lambda: bm.run_chaos_benchmark("2p2d", device="cuda")),
        ("autoscale", lambda: bm.run_autoscale_benchmark(
            "1p1d", device="cuda")),
    ]
    ra.launches = ra.launches_decode = paged_attention.launches = 0
    flash_attention.launches_fresh = flash_attention.launches_warm = 0
    torch.cuda.synchronize()
    res = {}
    for name, run in legs:
        t0 = time.monotonic()
        res[name] = run()
        torch.cuda.synchronize()
        print(f"[bench] leg={name} card={card} "
              f"wall_s={time.monotonic() - t0:.1f} "
              + json.dumps(res[name], sort_keys=True), flush=True)
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["bench", "--model", "tiny", "--device", "cuda",
                       "--serving", "--batch", "8", "--prompt-len", "64",
                       "--max-new", "32"])
    torch.cuda.synchronize()
    lines = buf.getvalue().strip().splitlines()
    print(f"[bench] leg=cli_tiny card={card} "
          f"wall_s={time.monotonic() - t0:.1f} rc={rc} "
          + (lines[-1] if lines else "no output"), flush=True)
    counts = {"paged": paged_attention.launches,
              "fresh": flash_attention.launches_fresh,
              "warm": flash_attention.launches_warm,
              "ring": ra.launches}

    assert rc == 0 and len(lines) == 1, "bench CLI: not one JSON line"
    cli = json.loads(lines[0])
    assert cli["metric"] == "decode_tokens_per_sec_per_chip" \
        and cli["value"] > 0
    assert cli["longctx_ring_kernelized"] is True
    dec, mixed = res["decode"], res["mixed"]
    for k in ("decode_tokens_per_sec_per_chip", "hbm_util", "mfu"):
        assert dec[k] is not None and 0 < dec[k] < float("inf"), (k, dec[k])
    assert dec["hbm_util"] < 1 and dec["mfu"] < 1
    assert res["serving"]["serving_tokens_per_sec_per_chip"] > 0
    assert res["warm_prefill"]["warm_prefill_kernelized"] is True
    assert res["longctx"]["longctx_ring_kernelized"] is True
    assert mixed["mixed_prefix_cache_hit_tokens"] > 0, "no prefix hit"
    assert mixed["mixed_serving_preemptions"] > 0, "pool never contested"
    assert mixed["kv_tier_pages_restored_total"] > 0, "no tier revival"
    dq, spec = res["decode_int8"], res["spec"]
    assert 0 < dq["hbm_util"] < 1 and dq["decode_tokens_per_sec_per_chip"] > 0
    assert spec["spec_forwards_total"] > 0
    fl, ch, au = res["fleet"], res["chaos"], res["autoscale"]
    assert fl["fleet_dropped"] == 0 and fl["kv_transfer_pages"] > 0, fl
    assert ch["chaos_unterminal"] == 0 and ch["chaos_injected"] > 0, ch
    assert au["autoscale_scale_ups"] >= 1 \
        and au["autoscale_flightrec_scale_events"] >= 1, au
    for kname, n in counts.items():
        assert n > 0, f"the {kname} kernel never launched in the bench legs"
    log("bench", card=card, **{f"{k}_launches": n for k, n in counts.items()},
        decode_tok_s_per_card=f"{dec['decode_tokens_per_sec_per_chip']:.2f}",
        hbm_util=f"{dec['hbm_util']:.4f}", mfu=f"{dec['mfu']:.4f}",
        serving_tok_s="{:.2f}".format(
            res["serving"]["serving_tokens_per_sec_per_chip"]),
        mixed_tok_s=mixed["mixed_serving_tokens_per_sec"],
        mixed_preemptions=mixed["mixed_serving_preemptions"],
        mixed_prefix_hit_tokens=mixed["mixed_prefix_cache_hit_tokens"],
        tier_saved=mixed["kv_tier_pages_saved_total"],
        tier_restored=mixed["kv_tier_pages_restored_total"])
    log("bench", decode_int8_tok_s_per_card="{:.2f}".format(
            dq["decode_tokens_per_sec_per_chip"]),
        decode_int8_hbm_util=f"{dq['hbm_util']:.4f}",
        spec_tok_s=f"{spec['serving_spec_tokens_per_sec']:.2f}",
        spec_off_tok_s=f"{spec['serving_spec_off_tokens_per_sec']:.2f}",
        spec_tokens_per_forward=f"{spec['spec_tokens_per_forward']:.3f}",
        spec_accept_rate=f"{spec['spec_accept_rate']:.3f}",
        **{f"spec_accept_rate_{k}": f"{spec['spec_accept_rate_' + k]:.3f}"
           for k in ("ngram", "model", "tree")})
    return counts


def _demangle(names):
    """Kernel names as C++ would print them (c++filt, when the toolkit's
    machine has it), with the namespaces and type spellings shortened."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True,
                             timeout=60).stdout.splitlines()
    except OSError:
        out = []
    if len(out) != len(names):
        return names
    short = {"(anonymous namespace)::": "", "bt::wg::": "", "bt::": "",
             "__nv_bfloat16": "bf16", "__half": "f16", "signed char": "i8",
             "(bool)1": "1", "(bool)0": "0", " ": ""}
    res = []
    for n in out:
        n = n.removeprefix("void ")
        for a, b in short.items():
            n = n.replace(a, b)
        res.append(n.split("(")[0] if "(" in n else n)
    return res


def _ptxas_kernels(err):
    """(kernel, registers, spill bytes, static smem bytes) for every entry
    function in ptxas' -v report."""
    rows, name, spill = [], None, "0"
    for line in err.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], "0"
        elif "spill stores" in line and name:
            spill = line.split("bytes spill stores")[0].split(",")[-1] \
                .strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used")[1].split("registers")[0].strip()
            smem = "0"
            for part in line.split(","):
                if "smem" in part:
                    smem = part.strip().split()[0]
            rows.append([name, regs, spill, smem])
            name = None
    for row, dem in zip(rows, _demangle([r[0] for r in rows])):
        row[0] = dem
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from butterfly_tpu_torch import native
    from butterfly_tpu_torch.native import build as native_build
    from butterfly_tpu_torch.ops import build
    from butterfly_tpu_torch.ops.paged_attention import paged_attention

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi gave no answer"
    log("device", name=name, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        bandwidth_TBps=figures(name)[0] / 1e12)
    print(smi_line, flush=True)

    t0 = time.monotonic()
    built = build.build_all()
    log("build", seconds=f"{time.monotonic() - t0:.1f}",
        built=",".join(built) or "cached")
    t0 = time.monotonic()
    lib = native_build.build(verbose=False)
    assert native.native_available(), "the native allocator did not load"
    log("build", source="native/allocator.cc", lib=os.path.relpath(lib, ROOT),
        gxx_s=f"{time.monotonic() - t0:.1f}")
    for k, (secs, err) in build.build_log.items():
        log("build", source=k, nvcc_s=f"{secs:.1f}")
        for kern, regs, spill, smem in _ptxas_kernels(err):
            print(f"[build] {k}: {kern}: {regs} registers, spill {spill}, "
                  f"static smem {smem} bytes", flush=True)

    kres = phase_kernel(torch, name)
    fres = phase_flash_kernel(torch, name)
    rres = phase_ring(torch, name)
    engine, serve_launches, tok = phase_serve(torch)
    phase_parity(torch, engine)
    phase_profile(torch, engine)
    model, params = engine.model, engine.params
    # the serve engine's pool and window go; its weights stay shared
    engine.cache = engine._kv_window = None
    del engine
    torch.cuda.empty_cache()
    gen_fresh = phase_generate(torch, model, params, tok)
    alt_engine, alt = phase_alternating(torch, model, params, tok)
    phase_flash_parity(torch, alt_engine)
    alt_engine.cache = alt_engine._kv_window = None
    del alt_engine
    torch.cuda.empty_cache()
    long_ring = phase_longgen(torch, model, params, tok)
    phase_ring_parity(torch, model, params, tok)
    serve_ring, long_paged = phase_longserve(torch, model, params, tok)
    long_ring += serve_ring
    qparams, quant = phase_quant(torch, model, params, tok)
    spec = phase_spec(torch, model, params, tok)
    fleet = phase_fleet(torch, model, params)
    bench = phase_bench(torch, model, params, qparams)
    del qparams

    def entry(kname, source, replaces, launches, cases, main_case):
        e = {"name": kname, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": max(r["max_abs_err"] for k, r in cases.items()
                                if not k.startswith("f32")
                                and not k.endswith("f32"))}
        for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
            e[key] = cases[main_case][key]
        return e

    flash_src = "butterfly_tpu_torch/ops/csrc/flash_attention.cu"
    fresh_cases = {k: r for k, r in fres.items() if k.startswith("fresh")}
    warm_cases = {k: r for k, r in fres.items() if k.startswith("warm")}
    kernels = [
        entry("paged_attention",
              "butterfly_tpu_torch/ops/csrc/paged_attention.cu",
              "butterfly_tpu/ops/paged_attention.py:65",
              serve_launches + alt["paged"] + long_paged + quant["paged"]
              + spec["paged"] + fleet["paged"] + bench["paged"], kres,
              "bf16_w64"),
        entry("flash_attention_fresh", flash_src,
              "butterfly_tpu/ops/flash_attention.py:66",
              gen_fresh + alt["fresh"] + quant["fresh"] + spec["fresh"]
              + bench["fresh"], fresh_cases, "fresh_bf16"),
        entry("flash_attention_warm", flash_src,
              "butterfly_tpu/ops/flash_attention.py:97",
              alt["warm"] + spec["warm"] + bench["warm"], warm_cases,
              "warm_bf16"),
        entry("ring_attention",
              "butterfly_tpu_torch/ops/csrc/ring_attention.cu",
              "butterfly_tpu/ops/ring_attention.py:158",
              long_ring + bench["ring"], rres, "diag_bf16"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    assert paged_attention.launches > 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
