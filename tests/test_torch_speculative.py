"""PyTorch port: speculative decoding against the JAX package on tiny
llama, float32.

Held token for token (greedy): the device n-gram drafter, the tree
K/V permutes (byte for byte), one spec block's (toks, valid) stack and
carries, the scheduler over a grid (window on/off x mixed dispatch on/off
x int8 KV x gamma 2/4, plus the stop token, the per-request opt-out and
preemption pressure), and `generate_speculative`. Greedy speculative
output is plain greedy decode's by construction, so the JAX plain
scheduler is the reference for the grid; the JAX spec scheduler pins the
spec counters at two points. Sampling is held elsewhere by its
distribution (tests/test_torch_spec_sampling.py); here it must finish and
reproduce under one seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butterfly_tpu.cache import paged as JP
from butterfly_tpu.core.config import RuntimeConfig as JRuntime
from butterfly_tpu.core.config import tiny
from butterfly_tpu.engine.engine import InferenceEngine as JInference
from butterfly_tpu.engine.sampling import SamplingParams as JSP
from butterfly_tpu.engine.serving import ServingEngine as JEngine
from butterfly_tpu.engine.serving import _ngram_drafts as jax_ngram
from butterfly_tpu.models.common import Model as JModel
from butterfly_tpu.sched.scheduler import Scheduler as JScheduler
from butterfly_tpu_torch.cache import paged as TP
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.engine.engine import (
    InferenceEngine, _ngram_draft)
from butterfly_tpu_torch.engine.sampling import SamplingParams
from butterfly_tpu_torch.engine.serving import ServingEngine, _ngram_drafts
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.models.common import Model
from butterfly_tpu_torch.sched.scheduler import Scheduler
from butterfly_tpu_torch.serve import cli

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls

CFG = tiny("llama", dtype="float32", param_dtype="float32")
TCFG = tconfig.tiny("llama", dtype="float32", param_dtype="float32")
_TREES = {}


def trees():
    if not _TREES:
        jp = JModel(CFG).init(jax.random.PRNGKey(42))
        _TREES["jax"] = jp
        _TREES["torch"] = params_from_numpy(jax.tree.map(np.asarray, jp),
                                            device="cpu")
    return _TREES["jax"], _TREES["torch"]


def _rt(mod, **kw):
    base = dict(max_batch_size=4, max_seq_len=64, page_size=8,
                prefill_chunk=8, prefill_inline_budget=8)
    base.update(kw)
    return mod.RuntimeConfig(**base)


class _J:
    RuntimeConfig = JRuntime


def jax_sched(**kw):
    return JScheduler(JEngine(JModel(CFG), trees()[0], _rt(_J, **kw),
                              use_kernels=False))


def port_sched(seed=0, **kw):
    return Scheduler(ServingEngine(Model(TCFG, device="cpu"), trees()[1],
                                   _rt(tconfig, **kw)), seed=seed)


def _run(sched, prompts, max_new=12, **kw):
    reqs = [sched.submit(p, max_new_tokens=max_new, **kw) for p in prompts]
    sched.run_until_done()
    assert all(r.state == "finished" for r in reqs)
    return [r.output for r in reqs]


PROMPTS = [[5, 7, 11], [3, 3, 3, 3, 3], [2],
           [5, 7, 11, 5, 7, 11, 5, 7, 11, 5, 7]]
_REFS = {}


def reference(kv_quant="none"):
    """The JAX plain scheduler's greedy outputs (spec off)."""
    if kv_quant not in _REFS:
        _REFS[kv_quant] = _run(jax_sched(kv_quant=kv_quant), PROMPTS)
    return _REFS[kv_quant]


# -- the drafter and the permutes -------------------------------------------------

def test_ngram_drafts_match_jax():
    rng = np.random.RandomState(0)
    for trial in range(6):
        S, H = 5, 40
        hist = rng.randint(0, 4 if trial % 2 else 9, (S, H)).astype(np.int32)
        hlen = rng.randint(0, H + 1, (S,)).astype(np.int32)
        for gamma, ngram in ((3, 2), (4, 1), (2, 3)):
            want = np.asarray(jax_ngram(jnp.asarray(hist), jnp.asarray(hlen),
                                        gamma, ngram))
            got = _ngram_drafts(torch.from_numpy(hist),
                                torch.from_numpy(hlen), gamma, ngram)
            assert got.dtype == torch.int32
            assert got.numpy().tolist() == want.tolist(), (trial, gamma)
            # the batched drafter and the host drafter share one rule
            for s in range(S):
                h = hist[s, :hlen[s]].tolist()
                assert got[s].tolist() == _ngram_draft(h, gamma, ngram)


def _window(quant, S=3, W=12):
    rng = np.random.RandomState(1)
    shape = (2, S, 2, W, 4)
    if quant:
        k = rng.randint(-127, 128, shape).astype(np.int8)
        v = rng.randint(-127, 128, shape).astype(np.int8)
        ks = rng.rand(*shape[:-1]).astype(np.float32)
        vs = rng.rand(*shape[:-1]).astype(np.float32)
        return (k, v, ks, vs)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_permute_window_tail_matches_jax(quant):
    parts = _window(quant)
    win_len = np.array([0, 3, 9], np.int32)
    perm = np.array([[0, 2, 3], [0, 1, 4], [0, 2, 0]], np.int32)
    jw = JP.permute_window_tail(JP.KVWindow(*map(jnp.asarray, parts)),
                                jnp.asarray(win_len), jnp.asarray(perm))
    tw = TP.permute_window_tail(
        TP.KVWindow(*(torch.from_numpy(p.copy()) for p in parts)),
        torch.from_numpy(win_len), torch.from_numpy(perm))
    for j, t in zip(jw, tw):
        if j is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_permute_paged_tail_matches_jax(quant):
    rng = np.random.RandomState(2)
    L, P, Kv, page, H = 2, 9, 2, 4, 4
    dt = np.int8 if quant else np.float32
    kp = (rng.randint(-127, 128, (L, P, Kv, page, H)) if quant
          else rng.randn(L, P, Kv, page, H)).astype(dt)
    vp = (rng.randint(-127, 128, (L, P, Kv, page, H)) if quant
          else rng.randn(L, P, Kv, page, H)).astype(dt)
    table = np.array([[0, 1, 8], [2, 3, 4], [5, 6, 7]], np.int32)
    lengths = np.array([2, 5, 10], np.int32)      # slot 2 runs off its row
    perm = np.array([[0, 2, 4], [0, 1, 3], [0, 2, 1]], np.int32)
    active = np.array([True, True, False])
    sc = [rng.rand(L, P, Kv * page).astype(np.float32) for _ in range(2)] \
        if quant else [None, None]
    jc = JP.PagedKVCache(jnp.asarray(kp), jnp.asarray(vp),
                         jnp.asarray(table), jnp.asarray(lengths),
                         *(None if s is None else jnp.asarray(s)
                           for s in sc))
    tc = TP.PagedKVCache(torch.from_numpy(kp.copy()),
                         torch.from_numpy(vp.copy()),
                         torch.from_numpy(table), torch.from_numpy(lengths),
                         *(None if s is None else torch.from_numpy(s.copy())
                           for s in sc))
    jo = JP.permute_paged_tail(jc, jnp.asarray(perm), jnp.asarray(active))
    to = TP.permute_paged_tail(tc, torch.from_numpy(perm),
                               torch.from_numpy(active))
    live = [p for p in range(P) if p != P - 1]    # the null page is scratch
    for name in ("k_pages", "v_pages") + (
            ("k_scale_pages", "v_scale_pages") if quant else ()):
        np.testing.assert_array_equal(
            getattr(to, name).numpy()[:, live],
            np.asarray(getattr(jo, name))[:, live], err_msg=name)


# -- one spec block ----------------------------------------------------------------

@pytest.mark.parametrize("combine", [True, False], ids=["window", "no_window"])
def test_spec_block_matches_jax(combine):
    """Two chained spec blocks (3 rounds, gamma 3) on three slots with
    seeded histories and table rows: toks, valid, history, lengths and
    the remaining budgets equal the JAX block's."""
    je = JEngine(JModel(CFG), trees()[0],
                 _rt(_J, speculative_gamma=3, kv_write_combine=combine,
                     max_batch_size=3), use_kernels=False)
    te = ServingEngine(Model(TCFG, device="cpu"), trees()[1],
                       _rt(tconfig, speculative_gamma=3,
                           kv_write_combine=combine, max_batch_size=3))
    H = je.cache.max_seq
    hist = np.zeros((3, H), np.int32)
    prompts = [[5, 7, 11, 5, 7, 11, 5], [3, 1, 4, 1, 5], [2, 9]]
    jh = jnp.asarray(hist)
    for slot, p in enumerate(prompts):
        for e in (je, te):
            e.set_table_row(slot, list(range(slot * 3, slot * 3 + 3)))
        # prefill every prompt but its last token, the chain token
        jlog = je.prefill_chunk(slot, p[:-1], 0)
        tlog = te.prefill_chunk(slot, p[:-1], 0)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=2e-5, rtol=0)
        hist[slot, :len(p)] = p
    hlen = np.array([len(p) for p in prompts], np.int32)
    jh, jl = jnp.asarray(hist), jnp.asarray(hlen)
    th, tl = torch.from_numpy(hist.copy()), torch.from_numpy(hlen)
    active = np.array([True, True, True])
    temps = np.zeros((3,), np.float32)
    stops = np.array([-1, -1, 9], np.int32)
    budgets = np.array([20, 5, 20], np.int32)
    mask = np.array([True, True, False])
    jrem, trem = budgets, budgets
    for blk in range(2):
        jt, jv, jh, jl, jrem = je.spec_block_async(
            jh, jl, active, temps, stops, jrem, mask,
            jax.random.PRNGKey(blk), 3)
        tt, tv, th, tl, trem = te.spec_block_async(
            th, tl, active, temps, stops, trem, mask, blk, 3)
        assert tv.numpy().tolist() == np.asarray(jv).tolist(), blk
        assert np.where(tv.numpy(), tt.numpy(), -1).tolist() == \
            np.where(np.asarray(jv), np.asarray(jt), -1).tolist(), blk
        assert th.numpy().tolist() == np.asarray(jh).tolist(), blk
        assert tl.numpy().tolist() == np.asarray(jl).tolist(), blk
        assert trem.numpy().tolist() == np.asarray(jrem).tolist(), blk
    assert np.asarray(jv)[:, 0].sum(-1).max() > 1  # drafts were accepted
    if combine:
        assert int(te.flush_kv_window()) == int(je.flush_kv_window())
    assert te.cache.lengths.tolist() == np.asarray(je.cache.lengths).tolist()


def test_engine_properties_match_jax():
    for kw in (dict(speculative_gamma=3),
               dict(speculative_gamma=4, draft_model="model",
                    draft_layers=1),
               dict(speculative_gamma=4, draft_model="model",
                    draft_layers=1, spec_tree_width=2),
               dict(speculative_gamma=3, mixed_dispatch=False)):
        je = JEngine(JModel(CFG), trees()[0], _rt(_J, **kw),
                     use_kernels=False)
        te = ServingEngine(Model(TCFG, device="cpu"), trees()[1],
                           _rt(tconfig, **kw))
        for prop in ("spec_tree_mode", "spec_tree_geometry",
                     "spec_emit_width", "mixed_dispatch_ready",
                     "mixed_fallback_reason"):
            assert getattr(te, prop) == getattr(je, prop), (kw, prop)


# -- the scheduler -----------------------------------------------------------------

GRID = [(win, mixed, kvq, gamma) for win in (True, False)
        for mixed in (True, False) for kvq in ("none", "int8")
        for gamma in (2, 4)]


@pytest.mark.parametrize(
    "win,mixed,kvq,gamma", GRID,
    ids=[f"{'win' if w else 'nowin'}-{'mixed' if m else 'alt'}-{q}-g{g}"
         for w, m, q, g in GRID])
def test_scheduler_spec_greedy_parity_grid(win, mixed, kvq, gamma):
    got = _run(port_sched(speculative_gamma=gamma, kv_write_combine=win,
                          mixed_dispatch=mixed, kv_quant=kvq,
                          decode_steps_per_tick=2), PROMPTS)
    assert got == reference(kvq)


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "alt"])
def test_scheduler_spec_counters_match_jax(mixed):
    """The spec counters (forwards, accepted drafts, emitted tokens) of
    the JAX spec scheduler, at the CLI default and on the alternating
    path with the window off."""
    kw = dict(speculative_gamma=3, mixed_dispatch=mixed,
              kv_write_combine=mixed)
    js, ts = jax_sched(**kw), port_sched(**kw)
    assert _run(ts, PROMPTS) == _run(js, PROMPTS)
    jm, tm = js.metrics(), ts.metrics()
    for key in ("spec_forwards_total", "spec_drafts_accepted_total",
                "spec_block_tokens_total", "tokens_generated_total"):
        assert tm[key] == jm[key], key
    assert tm["spec_drafts_accepted_total"] > 0


def test_scheduler_spec_stop_token():
    base = reference()[3]
    stop = base[6]
    want = _run(jax_sched(), [PROMPTS[3]], stop_token=stop)
    got = _run(port_sched(speculative_gamma=3), [PROMPTS[3]],
               stop_token=stop)
    assert got == want and got[0][-1] == stop and len(got[0]) <= 7


def test_scheduler_spec_per_request_opt_out():
    """speculative=False rides the spec block but ignores drafts: still
    plain greedy output."""
    sched = port_sched(speculative_gamma=3)
    r1 = sched.submit(PROMPTS[3], max_new_tokens=12, speculative=False)
    r2 = sched.submit(PROMPTS[1], max_new_tokens=12)
    sched.run_until_done()
    assert r1.output == reference()[3] and r2.output == reference()[1]


def test_scheduler_spec_parity_under_preemption_pressure():
    kw = dict(max_batch_size=2, max_seq_len=32, page_size=4, num_pages=6)
    prompts = [[5, 7, 11], [2, 4]]
    want = _run(jax_sched(**kw), prompts, max_new=10)
    sched = port_sched(speculative_gamma=3, **kw)
    assert _run(sched, prompts, max_new=10) == want
    assert sched.metrics()["preemptions_total"] > 0


def test_scheduler_spec_sampling_finishes_and_reproduces():
    outs = []
    for _ in range(2):
        sched = port_sched(seed=7, speculative_gamma=2)
        r1 = sched.submit([5, 7], max_new_tokens=8, temperature=0.8)
        r2 = sched.submit([3, 1, 4], max_new_tokens=6)
        sched.run_until_done()
        assert len(r1.output) == 8 and len(r2.output) == 6
        outs.append((r1.output, r2.output))
    assert outs[0] == outs[1]


def test_spec_rejections_never_reach_the_pool():
    """With the window on, a rejected draft's K/V is never flushed: pool
    bytes past each slot's length stay zero; window off, the verify
    writes them and only the rollback hides them."""
    def stale(sched, slot):
        c = sched.engine.cache
        length = int(c.lengths[slot])
        worst = 0.0
        for j, pid in enumerate(sched.alloc.pages_of(slot)):
            lo = max(0, length - j * c.page_size)
            if lo < c.page_size:
                worst = max(worst, float(c.k_pages[:, pid, :, lo:]
                                         .abs().max()))
        return worst
    runs = {}
    for wc in (True, False):
        sched = port_sched(speculative_gamma=3, kv_write_combine=wc,
                           max_batch_size=1)
        req = sched.submit([5, 7, 5, 7, 5], max_new_tokens=40)
        for _ in range(4):
            sched.tick()
        sched._drain_inflight()
        assert not req.done and sched.metrics()["spec_forwards_total"] > 0
        runs[wc] = stale(sched, req.slot)
    assert runs[True] == 0.0 and runs[False] > 0.0


# -- generate_speculative ------------------------------------------------------------

def _jax_spec(prompt, sp, kv_quant="none", gamma=3):
    eng = JInference(JModel(CFG), trees()[0],
                     JRuntime(max_seq_len=64, kv_quant=kv_quant))
    return eng.generate_speculative(prompt, sp, gamma=gamma)


def _port_spec(prompt, sp, kv_quant="none", gamma=3):
    eng = InferenceEngine(Model(TCFG, device="cpu"), trees()[1],
                          tconfig.RuntimeConfig(max_seq_len=64,
                                                kv_quant=kv_quant))
    return eng.generate_speculative(prompt, sp, gamma=gamma)


@pytest.mark.parametrize("kvq", ["none", "int8"])
def test_generate_speculative_matches_jax(kvq):
    prompt = PROMPTS[3]
    want = _jax_spec(prompt, JSP(max_new_tokens=20), kvq)
    got = _port_spec(prompt, SamplingParams(max_new_tokens=20), kvq)
    assert got.tokens.tolist() == np.asarray(want.tokens).tolist()
    assert (got.forwards, got.accepted_drafts) == \
        (want.forwards, want.accepted_drafts)
    assert got.accepted_drafts > 0 and got.tokens_per_forward > 1.0


def test_generate_speculative_stop_token_and_plain_parity():
    prompt = PROMPTS[3]
    eng = InferenceEngine(Model(TCFG, device="cpu"), trees()[1],
                          tconfig.RuntimeConfig(max_seq_len=64))
    plain = eng.generate([prompt], SamplingParams(max_new_tokens=16))
    toks = plain.tokens[0].tolist()
    assert eng.generate_speculative(
        prompt, SamplingParams(max_new_tokens=16)).tokens.tolist() == toks
    stop = toks[5]
    want = _jax_spec(prompt, JSP(max_new_tokens=16, stop_token=stop))
    got = _port_spec(prompt, SamplingParams(max_new_tokens=16,
                                            stop_token=stop))
    assert got.tokens.tolist() == np.asarray(want.tokens).tolist()
    assert got.tokens[-1] == stop
    with pytest.raises(ValueError, match="gamma"):
        eng.generate_speculative(prompt, gamma=0)


def test_generate_speculative_sampling_supported():
    sp = SamplingParams(max_new_tokens=12, temperature=0.9)
    a = _port_spec(PROMPTS[0], sp)
    b = _port_spec(PROMPTS[0], sp)
    assert len(a.tokens) == 12 and a.tokens.tolist() == b.tokens.tolist()


def test_cli_generate_speculate(capsys):
    rc = cli.main(["generate", "--device", "cpu", "--model", "tiny",
                   "--prompt", "abcabcabcabc", "--max-new", "12",
                   "--speculate", "3"])
    out, err = capsys.readouterr()
    assert rc == 0 and "tok/forward" in err and "drafts accepted" in err
