"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, all run every time, each printing labelled lines; any failure
raises and the script exits non-zero:

1. device    the card's name and power limit (nvidia-smi); every number
             below belongs to this card.
2. build     compiles every CUDA kernel from the sources in this checkout,
             one nvcc per source, all started together; prints ptxas'
             registers, spills and static shared memory for every kernel
             instantiation, by name.
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
             cores at T=256. Tolerances: m 1e-3 absolute, l 2**-7
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

# datasheet memory bandwidth (bytes/s) by part; dense peak (op/s) by type
_BW = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}
_PEAK = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
         "int8": 1979e12}


def log(label: str, **kv) -> None:
    print(f"[{label}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def bandwidth(name: str) -> float:
    for part in ("PCIe", "NVL"):
        if part in name:
            return _BW[part]
    return _BW["SXM"]


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
    bw = bandwidth(card)
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
        t_ops = ops / _PEAK[str(dt).replace("torch.", "")] * 1e3
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
    bw = bandwidth(card)
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
        t_ops = ops / _PEAK[dts] * 1e3
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
]


def _ring_inputs(torch, B, T, S, q0, k0, dt, quant, ragged, gen):
    Nq, Kv, H = 32, 8, 128
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
    bw = bandwidth(card)
    results = {}
    for name, B, T, S, q0, k0, dts, quant, ragged in RING_CASES:
        dt = getattr(torch, dts)
        bf16 = dt == torch.bfloat16
        args = _ring_inputs(torch, B, T, S, q0, k0, dt, quant, ragged, gen)
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
        t_ops = ops / _PEAK[dts] * 1e3
        bound = max(t_bytes, t_ops)
        results[name] = dict(max_abs_err=out_err, ms=k_ms, plain_ms=p_ms,
                             bound_ms=bound,
                             bound_by="bytes" if t_bytes >= t_ops
                             else "operations", library_ms=l_ms)
        log("ring", case=name, card=card.replace(" ", "_"), B=B, T=T, S=S,
            route="split" if T == 1 else ("wgmma" if bf16 else "cuda_cores"),
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
    log("serve", model=args.model, layers=cfg.num_layers,
        hidden=cfg.hidden_size, dtype=cfg.dtype, slots=rt.max_batch_size,
        max_seq=rt.max_seq_len, page=rt.page_size,
        mixed_dispatch=rt.mixed_dispatch,
        kv_write_combine=rt.kv_write_combine,
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

def phase_profile(torch, engine, steps=5):
    """Decode steps of the real engine path (mixed_block_async, k=1,
    C=1, every slot decoding at the lengths below) timed on the host
    clock with a device sync, then traced with torch.profiler: device
    busy time per step, the idle share, and the top kernels."""
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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy = sum(dev_us(e) for e in ka if e.device_type.name == "CUDA") \
        / steps / 1e3
    top = sorted((e for e in ka if e.device_type.name == "CUDA"),
                 key=dev_us, reverse=True)[:8]
    paged = [e for e in ka if e.device_type.name == "CUDA"
             and "paged_" in e.key and "kernel" in e.key]
    paged_ms = sum(dev_us(e) for e in paged) / steps / 1e3
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
            ms_per_step=f"{dev_us(e) / steps / 1e3:.4f}",
            calls_per_step=e.count // steps)


# -- phase 8: butterfly generate ---------------------------------------------

_TEXT = "The quick brown fox jumps over the lazy dog. " * 30


def _check_tokens(res, B, n, vocab, what):
    assert res.tokens.shape == (B, n), f"{what}: shape {res.tokens.shape}"
    assert ((res.tokens >= 0) & (res.tokens < vocab)).all(), what
    assert (res.lengths == n).all(), f"{what}: lengths {res.lengths}"


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
    saved = cli.load_params
    cli.load_params = lambda model, args: params
    out, err = io.StringIO(), io.StringIO()
    flash_attention.launches_fresh = 0
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(["generate", "--model", "llama3-8b", "--device",
                           "cuda", "--prompt", _TEXT[:300], "--max-new",
                           str(new)])
    finally:
        cli.load_params = saved
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
        bandwidth_TBps=bandwidth(name) / 1e12)
    print(smi_line, flush=True)

    t0 = time.monotonic()
    built = build.build_all()
    log("build", seconds=f"{time.monotonic() - t0:.1f}",
        built=",".join(built) or "cached")
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
              serve_launches + alt["paged"] + long_paged, kres,
              "bf16_w64"),
        entry("flash_attention_fresh", flash_src,
              "butterfly_tpu/ops/flash_attention.py:66",
              gen_fresh + alt["fresh"], fresh_cases, "fresh_bf16"),
        entry("flash_attention_warm", flash_src,
              "butterfly_tpu/ops/flash_attention.py:97",
              alt["warm"], warm_cases, "warm_bf16"),
        entry("ring_attention",
              "butterfly_tpu_torch/ops/csrc/ring_attention.cu",
              "butterfly_tpu/ops/ring_attention.py:158", long_ring, rres,
              "diag_bf16"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    assert paged_attention.launches > 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
