"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, all run every time, each printing labelled lines; any failure
raises and the script exits non-zero:

1. device  the card's name and power limit (nvidia-smi); every number
           below belongs to this card.
2. build   compiles every CUDA kernel of the serving path from the
           sources in this checkout (one nvcc per source).
3. kernel  the paged-attention kernel against its plain PyTorch version
           at Llama-3-8B main-path shapes (S=8, Nq=32, Kv=8, H=128,
           page=16, max_pages=128, ragged lengths incl. 0/1/17/2048):
           bf16 pool without and with the window (W=2, W=64), int8 pool
           with the window, f32 pool. Tolerances: max abs error bf16
           2e-2, f32 1e-4 (TF32 off); per slot, max abs error over the
           slot's max |output| bf16 1e-2, f32 1e-4, so a long slot's small
           outputs are held too; a slot with nothing to attend must give
           exactly 0.
           Times: kernel (CUDA events, median, L2 flushed before each
           launch as a decode step finds it), plain version, the bound
           (bytes moved / the card's memory bandwidth, or operations /
           peak, whichever is larger), and scaled_dot_product_attention
           over the pre-gathered dense K/V as a yardstick that excludes
           the page walk.
4. serve   `butterfly serve` machinery (serve/server.build_serving) on
           full-width, full-depth Llama-3-8B with random bf16 weights
           and the CLI's serve defaults, in a thread on 127.0.0.1; 8
           concurrent greedy /generate requests (prompts of 16-1200
           bytes, 32-64 new tokens) so prefill lanes and decode steps
           share ticks. Kernel launch counts are zeroed just before and
           read just after; the paged kernel must have launched, a
           multiple of 32 times (one launch per layer per decode step).
5. parity  on the same engine, one decode step through all layers with
           equal carries, bf16: each layer's kernel output against the
           plain version on the same inputs (2e-2 absolute), and the
           step's logits with the kernel against the same step with the
           plain version (0.5 absolute).
6. profile where one decode step's time goes: host wall vs device busy
           time (torch.profiler) and the top kernels by device time.

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
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()  # evict L2: a decode step finds this layer's pages cold
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _sdpa_yardstick(torch, args, win, lengths, wc):
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
    from butterfly_tpu_torch.ops.paged_attention import (paged_attention,
                                                         paged_attention_ref)
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
    cases = [("bf16", torch.bfloat16, False, 0, 2e-2, 1e-2),
             ("bf16_w2", torch.bfloat16, False, 2, 2e-2, 1e-2),
             ("bf16_w64", torch.bfloat16, False, 64, 2e-2, 1e-2),
             ("int8_w64", torch.bfloat16, True, 64, 2e-2, 1e-2),
             ("f32", torch.float32, False, 0, 1e-4, 1e-4),
             ("f32_w2", torch.float32, False, 2, 1e-4, 1e-4)]
    results = {}
    for name, dt, quant, W, tol, rel_tol in cases:
        args, win, wc = _kernel_case(torch, paged_attention, S, Nq, Kv, H,
                                     page, mp, lengths, dt, quant, W, gen)
        out = paged_attention(*args, **win)
        torch.cuda.synchronize()
        ref = paged_attention_ref(*args, **win)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        assert torch.isfinite(out.float()).all(), f"{name}: non-finite"
        assert err <= tol, f"{name}: max abs err {err} > {tol}"
        # every slot but the empty slot 0, against its own output scale:
        # a page dropped or repeated in a long slot moves its small
        # outputs by far less than the short slots' absolute error
        slot_rel = (diff.amax(dim=(1, 2))[1:]
                    / ref.float().abs().amax(dim=(1, 2))[1:])
        rel = slot_rel.max().item()
        assert rel <= rel_tol, \
            f"{name}: per-slot rel err {slot_rel.tolist()} > {rel_tol}"
        # slot 0 attends nothing (lengths 0, win_count 0): exactly zero
        assert (out[0] == 0).all().item(), f"{name}: empty slot not zero"
        n0 = paged_attention.launches
        k_ms = _time_ms(torch, lambda: paged_attention(*args, **win), flush)
        assert paged_attention.launches > n0
        p_ms = _time_ms(torch, lambda: paged_attention_ref(*args, **win),
                        flush, reps=5)
        lib = _sdpa_yardstick(torch, args, win, lengths, wc)
        l_ms = _time_ms(torch, lib, flush)
        nbytes, ops = _bytes_ops(args, win, lengths, wc, Nq, Kv, H, page,
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
            max_slot_rel_err=f"{rel:.3g}", rel_tol=rel_tol,
            kernel_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}",
            bytes=nbytes, bound_ms=f"{bound:.4f}",
            library_ms=f"{l_ms:.4f}(sdpa,excludes the page walk)",
            empty_slot="exact 0")
    return results


# -- phase 4: the serving path ------------------------------------------------

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
    state = ServerState(sched, tok)
    state.thread.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
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
    return engine, launches


# -- phase 5: the kernel inside the model, against the plain version --------

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


# -- phase 6: where a decode step's time goes --------------------------------

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
    log("profile", decode_step_ms=f"{step_ms:.3f}",
        traced_step_ms=f"{wall:.3f}", device_busy_ms=f"{busy:.3f}",
        idle_share=f"{1 - busy / wall:.3f}" if busy else "not measured",
        lengths=",".join(map(str, lengths)))
    for e in top:
        log("profile", kernel=e.key[:60].replace(" ", "_"),
            ms_per_step=f"{dev_us(e) / steps / 1e3:.4f}",
            calls_per_step=e.count // steps)


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
        for line in err.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {k}: {line.strip()}", flush=True)

    kres = phase_kernel(torch, name)
    engine, launches = phase_serve(torch)
    phase_parity(torch, engine)
    phase_profile(torch, engine)
    main_case = kres["bf16_w64"]
    entry = {"name": "paged_attention", "route": "cuda",
             "source": "butterfly_tpu_torch/ops/csrc/paged_attention.cu",
             "replaces": "butterfly_tpu/ops/paged_attention.py:65",
             "launches": launches,
             "max_abs_err": max((r["max_abs_err"] for k, r in kres.items()
                                 if k.startswith(("bf16", "int8"))))}
    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
        entry[key] = main_case[key]
    print(json.dumps({"kernels": [entry]}), flush=True)
    assert paged_attention.launches > 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
