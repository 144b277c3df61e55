"""PyTorch port: the alternating serving path (mixed_dispatch=False and
scheduler="static") against the JAX package on tiny llama, float32:
gang prefills through the flash kernels' plain versions (fresh gangs and
warm chunk continuations), fused decode blocks, and the scheduler's
alternating branches, greedy token for token.

The JAX references of the scheduler grid are computed once per numeric
class (kv_quant x kernels): the JAX package pins greedy tokens equal
across the window, the static scheduler and the dense warm program
(tests/test_sched.py, tests/test_warm_prefill.py), so those switches
change the port's path, not the expected tokens.
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_serving import TCFG, _trace, jax_engine, port_engine

from butterfly_tpu.sched.scheduler import Scheduler as JScheduler
from butterfly_tpu_torch.sched.scheduler import Scheduler

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls

@pytest.mark.parametrize("kernels", [False, True], ids=["dense", "kernels"])
def test_prefill_batch_fresh_then_warm_logits_match_jax(kernels):
    """A fresh gang of two (ragged chunks, padded to a batch bucket of
    2 and a length bucket of 16), then one warm continuation of slot 0
    and a fresh admission of slot 2 in one warm-program dispatch."""
    je, te = jax_engine(use_kernels=kernels), port_engine(use_kernels=kernels)
    for e in (je, te):
        e.set_table_row(0, [0, 1, 2, 3])
        e.set_table_row(1, [4, 5])
        e.set_table_row(2, [6, 7])
    rng = np.random.default_rng(3)
    a, b, c = (rng.integers(1, 250, n).tolist() for n in (21, 9, 5))
    for slots, chunks, starts in (([0, 1], [a[:13], b], [0, 0]),
                                  ([0, 2], [a[13:], c], [13, 0])):
        jl = je.prefill_batch(slots, chunks, starts)
        tl = te.prefill_batch(slots, chunks, starts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        assert te.cache.lengths.tolist() == \
            np.asarray(je.cache.lengths).tolist()
    assert te.warm_prefill_flash == je.warm_prefill_flash == kernels


@pytest.mark.parametrize("combine", [True, False], ids=["window", "no_window"])
def test_decode_block_tokens_match_jax(combine):
    """Two chained k=3 decode blocks after a gang prefill: slot 1 sits
    out, slot 2 spends its budget mid-block."""
    je = jax_engine(kv_write_combine=combine)
    te = port_engine(kv_write_combine=combine)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 250, n).tolist() for n in (11, 6)]
    for e in (je, te):
        e.set_table_row(0, [0, 1, 2])
        e.set_table_row(2, [3, 4])
        e.prefill_batch([0, 2], prompts, [0, 0])
    active = np.array([True, False, True])
    temps = np.zeros((3,), np.float32)
    stops = np.full((3,), -1, np.int32)
    budgets = np.array([6, 0, 2], np.int32)
    jtok = ttok = np.array([7, 0, 9], np.int32)
    for blk in range(2):
        jb, jtok = je.decode_block_async(jtok, active, temps, stops, budgets,
                                         jax.random.PRNGKey(blk), 3)
        tb, ttok = te.decode_block_async(ttok, active, temps, stops, budgets,
                                         blk, 3)
        assert tb.numpy().tolist() == np.asarray(jb).tolist(), blk
        budgets = np.maximum(budgets - 3, 0)
    if combine:
        assert int(te.flush_kv_window()) == int(je.flush_kv_window())
    assert te.cache.lengths.tolist() == np.asarray(je.cache.lengths).tolist()


_JAX_TRACES = {}


def _jax_trace(kv_quant, kernels):
    key = (kv_quant, kernels)
    if key not in _JAX_TRACES:
        _JAX_TRACES[key] = _trace(JScheduler(jax_engine(
            use_kernels=kernels, mixed_dispatch=False, kv_quant=kv_quant)))
    return _JAX_TRACES[key]


ALT = [
    ("window", dict(kv_write_combine=True), False),
    ("no_window", dict(kv_write_combine=False), False),
    ("window_kernels", dict(kv_write_combine=True), True),
    ("no_window_kernels", dict(kv_write_combine=False), True),
    ("int8_kernels", dict(kv_quant="int8"), True),
    ("static_kernels", dict(scheduler="static"), True),
    ("dense_warm_kernels", dict(prefill_flash_warm=False), True),
]


@pytest.mark.parametrize("name,kw,kernels", ALT, ids=[g[0] for g in ALT])
def test_alternating_scheduler_greedy_tokens_match_jax(name, kw, kernels):
    """mixed_dispatch=False: gang prefills of 8-token chunks (so the
    longer prompts continue warm) between fused decode blocks, two of
    them in flight. With kernels the port's flash and paged wrappers take
    their plain versions; the JAX engine runs its Pallas kernels in
    interpret mode."""
    kw = dict(kw, mixed_dispatch=False)
    want = _jax_trace(kw.get("kv_quant", "none"), kernels)
    sched = Scheduler(port_engine(use_kernels=kernels, **kw))
    assert not sched._mixed_mode
    got = _trace(sched)
    assert got == want
    assert [len(o) for o in got] == [8, 6, 5, 4]


def test_alternating_prefills_route_through_the_flash_wrapper(monkeypatch):
    """With kernels on, a fresh gang calls the fresh flash entry and a
    chunk continuation the warm one (prefix_len = the chunk's start)."""
    import butterfly_tpu_torch.ops.flash_attention as fa_mod
    from butterfly_tpu_torch.ops.flash_attention import flash_attention
    calls = []

    def spy(q, k, v, causal=True, prefix_k=None, prefix_v=None,
            prefix_len=None, **kw):
        calls.append(None if prefix_len is None else prefix_len.tolist())
        return flash_attention(q, k, v, causal, prefix_k, prefix_v,
                               prefix_len, **kw)
    # the layers call it through flash_attention_sharded
    monkeypatch.setattr(fa_mod, "flash_attention", spy)
    sched = Scheduler(port_engine(use_kernels=True, mixed_dispatch=False))
    r = sched.submit(list(range(1, 20)), max_new_tokens=3)
    sched.run_until_done()
    assert len(r.output) == 3
    L = TCFG.num_layers
    # 19 tokens in chunks of 8: fresh [0, 8), warm at 8, warm at 16
    assert calls == [None] * L + [[8]] * L + [[16]] * L


def _recording_prefills(engine):
    """Wrap engine.prefill_batch to record each gang dispatch as
    [(slot, chunk length, start) per member]."""
    calls, inner = [], engine.prefill_batch

    def record(slots, chunks, starts):
        calls.append([(int(s), len(c), int(p))
                      for s, c, p in zip(slots, chunks, starts)])
        return inner(slots, chunks, starts)
    engine.prefill_batch = record
    return calls


@pytest.mark.parametrize("static", [False, True], ids=["chunk8", "static"])
def test_alternating_gang_prefill_chunks_match_jax(static):
    """The alternating path's gang prefills dispatch the same chunks as
    the JAX package's: each member's chunk runs from its prefilled count
    to the end of its prompt or as far as the tick's budget (8 tokens)
    lets it, never shorter; the static scheduler (no budget) prefills
    each prompt whole, in one chunk from position 0."""
    kw = dict(mixed_dispatch=False, prefill_chunk=8)
    if static:
        kw["scheduler"] = "static"
    je, te = jax_engine(**kw), port_engine(**kw)
    want, got = _recording_prefills(je), _recording_prefills(te)
    assert _trace(Scheduler(te)) == _trace(JScheduler(je))
    assert got == want and got
    if static:
        assert all(p == 0 for call in got for _, _, p in call)
