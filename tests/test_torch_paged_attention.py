"""PyTorch port: paged decode attention's plain versions (the one-softmax
version the wrapper runs on CPU tensors, and the split-and-merge version
of the kernel's decomposition) against the JAX package's Pallas kernel,
which runs in interpret mode off-TPU. f32 at 2e-5, the tolerance of
tests/test_kernels.py's paged-attention checks: they sum in different
orders over at most a few hundred keys. The kernel itself runs only on a
card (tests marked `cuda`)."""
import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

import butterfly_tpu_torch.ops.paged_attention as PA
from butterfly_tpu.ops.paged_attention import paged_attention as jax_pa
from butterfly_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_ref, paged_attention_split_ref,
    split_columns, split_plan)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls

TOL = 2e-5
S, NQ, KV, H, PAGE, MP = 4, 4, 2, 16, 4, 6


def _inputs(seed, quant=False, window=0, empty=False, garbage=False,
            null_tail=True):
    rng = np.random.default_rng(seed)
    P = S * MP + 1
    q = rng.standard_normal((S, NQ, H)).astype(np.float32)
    if quant:
        kp = rng.integers(-127, 128, (P, KV, PAGE, H)).astype(np.int8)
        vp = rng.integers(-127, 128, (P, KV, PAGE, H)).astype(np.int8)
        ks = (rng.random((P, KV * PAGE)) * 0.02).astype(np.float32)
        vs = (rng.random((P, KV * PAGE)) * 0.02).astype(np.float32)
    else:
        kp = rng.standard_normal((P, KV, PAGE, H)).astype(np.float32)
        vp = rng.standard_normal((P, KV, PAGE, H)).astype(np.float32)
        ks = vs = None
    lengths = np.array([9, 1, MP * PAGE, 14], np.int32)
    if empty:
        lengths[1] = 0
    # distinct pages per slot; the unused tail points at the null page
    perm = rng.permutation(P - 1).astype(np.int32)
    table = np.full((S, MP), P - 1, np.int32)
    for s in range(S):
        n = -(-int(lengths[s]) // PAGE) if null_tail else MP
        table[s, :n] = perm[s * MP:s * MP + n]
    if garbage:
        # large finite values at every position past each slot's length
        for s in range(S):
            for j in range(MP):
                for t in range(PAGE):
                    if j * PAGE + t >= lengths[s] and table[s, j] != P - 1:
                        pid = table[s, j]
                        if quant:
                            kp[pid, :, t] = 127
                            vp[pid, :, t] = 127
                            ks[pid, np.arange(KV) * PAGE + t] = 1e4
                        else:
                            kp[pid, :, t] = 1e4
                            vp[pid, :, t] = 1e4
    win = {}
    if window:
        W = window
        shape = (S, KV, W, H)
        if quant:
            win["win_k"] = rng.integers(-127, 128, shape).astype(np.int8)
            win["win_v"] = rng.integers(-127, 128, shape).astype(np.int8)
            win["win_k_scale"] = (rng.random(shape[:-1]) * 0.02) \
                .astype(np.float32)
            win["win_v_scale"] = (rng.random(shape[:-1]) * 0.02) \
                .astype(np.float32)
        else:
            win["win_k"] = rng.standard_normal(shape).astype(np.float32)
            win["win_v"] = rng.standard_normal(shape).astype(np.float32)
        wc = np.array([2, 0 if empty else 1, W, 3 % (W + 1)], np.int32)
        win["win_count"] = wc
        if garbage:
            for s in range(S):
                for key in ("win_k", "win_v"):
                    win[key][s, :, wc[s]:] = 127 if quant else 1e4
    return (q, kp, vp, table, lengths, ks, vs), win


CASES = {
    "float": dict(),
    "int8": dict(quant=True),
    "window_float": dict(window=5),
    "window_int8": dict(quant=True, window=5),
    "empty_slot": dict(empty=True),
    "empty_slot_window": dict(empty=True, window=3),
    "garbage_past_lengths": dict(garbage=True, window=4),
    "garbage_past_lengths_int8": dict(quant=True, garbage=True, window=4),
    "null_page_tables": dict(null_tail=True),
    "full_tables": dict(null_tail=False, window=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_jax_kernel(case):
    kw = CASES[case]
    args, win = _inputs(sorted(CASES).index(case), **kw)
    want = np.asarray(jax_pa(*args, **win))
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    twin = {k: torch.from_numpy(v) for k, v in win.items()}
    got = paged_attention(*targs, **twin)        # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (S, NQ, H)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    assert np.isfinite(got.numpy()).all()
    if kw.get("empty"):
        # nothing to attend: exactly zero, never NaN
        assert (got[1] == 0).all()
    if kw.get("garbage"):
        assert np.abs(got.numpy()).max() < 100.0
    # the wrapper's CPU branch IS the plain version
    ref = paged_attention_ref(*targs, **twin)
    assert torch.equal(got, ref)


def test_cpu_wrapper_launches_no_kernel():
    args, win = _inputs(3, window=2)
    before = paged_attention.launches
    paged_attention(*[None if a is None else torch.from_numpy(a)
                      for a in args],
                    **{k: torch.from_numpy(v) for k, v in win.items()})
    assert paged_attention.launches == before


def test_bf16_plain_version_close_to_jax():
    """bf16 q and pools: both sides accumulate in f32 and round the
    output to bf16, so they agree to bf16 resolution (2e-2, the bf16
    tolerance of tests/test_kernels.py)."""
    args, win = _inputs(5, window=3)
    jargs = [None if a is None else jax.numpy.asarray(a) for a in args]
    jargs[:3] = [a.astype(jax.numpy.bfloat16) for a in jargs[:3]]
    jwin = {k: (jax.numpy.asarray(v).astype(jax.numpy.bfloat16)
                if v.dtype == np.float32 else v) for k, v in win.items()}
    want = np.asarray(jax_pa(*jargs, **jwin).astype(jax.numpy.float32))
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    targs[:3] = [a.to(torch.bfloat16) for a in targs[:3]]
    twin = {k: (torch.from_numpy(v).to(torch.bfloat16)
                if v.dtype == np.float32 else torch.from_numpy(v))
            for k, v in win.items()}
    got = paged_attention(*targs, **twin)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=0)


# -- the kernel's split-KV decomposition ---------------------------------------

# 8 tokens a split at page 4: 2 pages, so MP = 6 pages make 3 page splits
# and the slot lengths of `_inputs` (9, 1, 24, 14) end mid-page and
# mid-split, fill the table, or are 0 (empty=True)
SMALL_SPLIT = 8

SPLIT_CASES = {
    "float": dict(),
    "int8": dict(quant=True),
    "window_float": dict(window=5),
    "window_int8": dict(quant=True, window=5),
    "empty_slot_window": dict(empty=True, window=3),
    "garbage_past_lengths": dict(garbage=True, window=4),
    "garbage_past_lengths_int8": dict(quant=True, garbage=True, window=4),
    "full_tables": dict(null_tail=False, window=2),
    "window_only_slot": dict(window=4, window_only=True),
}


def _split_inputs(seed, window_only=False, **kw):
    args, win = _inputs(seed, **kw)
    if window_only:   # slot 3: nothing flushed, three rows in its window
        args[4][3] = 0
        win["win_count"][3] = 3
    return args, win


def _torch(args, win):
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    return targs, {k: torch.from_numpy(v) for k, v in win.items()}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_version_matches_jax_and_plain(case, monkeypatch):
    """The split-and-merge plain version against JAX's Pallas kernel
    (interpret mode) and against the one-softmax plain version, f32 at
    2e-5; every split with no live key holds exactly the empty partial."""
    monkeypatch.setattr(PA, "SPLIT_TOKENS", SMALL_SPLIT)
    args, win = _split_inputs(40 + sorted(SPLIT_CASES).index(case),
                              **SPLIT_CASES[case])
    want = np.asarray(jax_pa(*args, **win))
    targs, twin = _torch(args, win)
    got, (m, l, acc) = paged_attention_split_ref(*targs, **twin,
                                                 return_partials=True)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(),
                               paged_attention_ref(*targs, **twin).numpy(),
                               atol=TOL, rtol=0)
    window = bool(win)
    plan = split_plan(PAGE, MP, window)
    assert m.shape == (S, KV, plan[2], NQ // KV)
    lengths = args[4]
    wc = win["win_count"] if window else np.zeros(S, np.int32)
    n_empty = 0
    for s in range(S):
        for i in range(plan[2]):
            c0, c1 = split_columns(i, plan, PAGE, MP)
            if i == plan[1]:
                live = wc[s] > 0
            else:
                live = c0 < min(c1, lengths[s])
            if not live:
                n_empty += 1
                assert (m[s, :, i] == PA.NEG_INF).all()
                assert (l[s, :, i] == 0).all() and (acc[s, :, i] == 0).all()
            else:
                assert (l[s, :, i] > 0).all()
    assert n_empty > 0
    if SPLIT_CASES[case].get("empty"):
        assert (got[1] == 0).all()


def test_split_version_bf16_close_to_jax(monkeypatch):
    monkeypatch.setattr(PA, "SPLIT_TOKENS", SMALL_SPLIT)
    args, win = _split_inputs(60, window=3)
    jargs = [None if a is None else jax.numpy.asarray(a) for a in args]
    jargs[:3] = [a.astype(jax.numpy.bfloat16) for a in jargs[:3]]
    jwin = {k: (jax.numpy.asarray(v).astype(jax.numpy.bfloat16)
                if v.dtype == np.float32 else v) for k, v in win.items()}
    want = np.asarray(jax_pa(*jargs, **jwin).astype(jax.numpy.float32))
    targs, twin = _torch(args, win)
    targs[:3] = [a.to(torch.bfloat16) for a in targs[:3]]
    twin = {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
            for k, v in twin.items()}
    got = paged_attention_split_ref(*targs, **twin)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("page,max_pages,window,want", [
    (16, 128, True, (16, 8, 9)),     # Llama-3-8B serve: 2048 tokens, W
    (16, 128, False, (16, 8, 8)),
    (16, 129, False, (16, 9, 9)),    # a partial last split
    (4, 6, False, (64, 1, 1)),
    (512, 3, True, (1, 3, 4)),       # a page wider than a split
    (16, 0, False, (16, 1, 1)),      # no pages: one (empty) split
])
def test_split_plan_comes_from_static_sizes(page, max_pages, window, want):
    assert split_plan(page, max_pages, window) == want
    plan = split_plan(page, max_pages, window)
    # the page splits tile the run; the window split starts past it
    edges = [split_columns(i, plan, page, max_pages) for i in range(plan[1])]
    assert edges[0][0] == 0 and edges[-1][1] == max_pages * page
    assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))
    if window:
        assert split_columns(plan[1], plan, page, max_pages) == \
            (max_pages * page, None)


def test_wrapper_reads_nothing_back_from_the_card():
    """The launch is sized from the table's width: no line of the module
    brings a tensor to the host (a sync per decode step would end the
    scheduler's dispatch-ahead)."""
    src = pathlib.Path(PA.__file__).read_text()
    calls = {n.func.attr for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert not calls & {"item", "cpu", "tolist", "numpy", "synchronize"}


def _card_case(S_, Nq, Kv, H_, page, mp, lengths, dtype, quant, W, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    dev = "cuda"
    P = S_ * mp + 1
    q = torch.randn((S_, Nq, H_), generator=gen, device=dev).to(dtype)
    if quant:
        kp, vp = (torch.randint(-127, 128, (P, Kv, page, H_), generator=gen,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand((P, Kv * page), generator=gen, device=dev)
                  * 0.02 for _ in range(2))
    else:
        kp, vp = (torch.randn((P, Kv, page, H_), generator=gen,
                              device=dev).to(dtype) for _ in range(2))
        ks = vs = None
    perm = torch.randperm(P - 1, generator=gen, device=dev).to(torch.int32)
    table = torch.full((S_, mp), P - 1, dtype=torch.int32, device=dev)
    for s in range(S_):
        n = -(-lengths[s] // page)
        table[s, :n] = perm[s * mp:s * mp + n]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    win = {}
    if W:
        pool_dt = torch.int8 if quant else dtype
        shape = (S_, Kv, W, H_)
        if quant:
            win["win_k"], win["win_v"] = (
                torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=pool_dt) for _ in range(2))
            win["win_k_scale"], win["win_v_scale"] = (
                torch.rand(shape[:-1], generator=gen, device=dev) * 0.02
                for _ in range(2))
        else:
            win["win_k"], win["win_v"] = (
                torch.randn(shape, generator=gen, device=dev).to(pool_dt)
                for _ in range(2))
        win["win_count"] = torch.tensor(
            [0] + [1 + (7 * s) % W for s in range(1, S_)],
            dtype=torch.int32, device=dev)
    return (q, kp, vp, table, lens, ks, vs), win


# (name, S, Nq, Kv, H, page, max_pages, lengths, dtype, int8, W, tol):
# bf16/f16 with G <= 8 take the tensor-core kernel, f32 and G = 16 the
# CUDA-core one; slot 0 is empty in every case
CARD_CASES = [
    ("bf16_w64", 8, 32, 8, 128, 16, 128,
     [0, 1, 17, 2048, 300, 1000, 1500, 64], torch.bfloat16, False, 64, 2e-2),
    ("bf16_all_long", 8, 32, 8, 128, 16, 128, [0] + [2048] * 7,
     torch.bfloat16, False, 0, 2e-2),
    ("f16_w2", 4, 32, 8, 128, 16, 40, [0, 255, 257, 640], torch.float16,
     False, 2, 2e-2),
    ("int8_w64", 8, 32, 8, 128, 16, 128,
     [0, 1, 17, 2048, 300, 1000, 1500, 64], torch.bfloat16, True, 64, 2e-2),
    ("bf16_h64_gpt2", 4, 12, 12, 64, 16, 64, [0, 5, 700, 1024],
     torch.bfloat16, False, 16, 2e-2),
    ("bf16_h16_page4", 4, 4, 2, 16, 4, 100, [0, 3, 257, 400],
     torch.bfloat16, False, 5, 2e-2),
    ("bf16_h256_int8", 4, 16, 2, 256, 32, 20, [0, 31, 33, 640],
     torch.bfloat16, True, 3, 2e-2),
    ("bf16_g16", 4, 32, 2, 128, 16, 40, [0, 100, 300, 640],
     torch.bfloat16, False, 4, 2e-2),
    ("f32_w2", 4, 32, 8, 128, 16, 40, [0, 255, 257, 640], torch.float32,
     False, 2, 1e-4),
    ("f32_int8", 4, 8, 2, 64, 16, 40, [0, 255, 257, 640], torch.float32,
     True, 2, 1e-4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_split_kernel_matches_plain_on_the_card(case):
    """The sm_90a split-KV kernel against both plain versions, the same
    bits on a second launch (no atomics), exact zeros for the empty slot,
    and one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    name, S_, Nq, Kv, H_, page, mp, lengths, dt, quant, W, tol = case
    args, win = _card_case(S_, Nq, Kv, H_, page, mp, lengths, dt, quant, W,
                           seed=len(name))
    n0 = paged_attention.launches
    out = paged_attention(*args, **win)
    again = paged_attention(*args, **win)
    torch.cuda.synchronize()
    assert paged_attention.launches == n0 + 2
    assert torch.equal(out, again), f"{name}: not deterministic"
    assert (out[0] == 0).all(), f"{name}: empty slot not zero"
    assert torch.isfinite(out.float()).all()
    for ref in (paged_attention_ref(*args, **win),
                paged_attention_split_ref(*args, **win)):
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= tol, f"{name}: max abs err {err} > {tol}"
