"""PyTorch port: the on-device draft model (models/draft.py) and token-tree
speculation against the JAX package on tiny llama, float32.

Held: the truncated-layer derivation (layer leaves sliced, embed / final
norm / LM head the same objects, float and int8 trees), the draft
prefill's padding rows dropped (and its K/V against the JAX step's), the
draft rollback invariant draft_len == hist_len - 1, and greedy tokens
token for token against the JAX scheduler for model drafts and width-2
trees with the window on and off (int8 weights: tests/test_torch_quant.py),
and against plain greedy decode with int8 KV and other tree shapes. An
independent draft checkpoint in another vocabulary is refused with the
JAX loader's message.
"""
import jax
import numpy as np
import pytest
import torch

from butterfly_tpu.core.config import RuntimeConfig as JRuntime
from butterfly_tpu.core.config import tiny
from butterfly_tpu.engine.serving import ServingEngine as JEngine
from butterfly_tpu.models import draft as JD
from butterfly_tpu.models.common import Model as JModel
from butterfly_tpu.quant.int8 import quantize_int8 as jax_quantize
from butterfly_tpu.sched.scheduler import Scheduler as JScheduler
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.engine import serving as TS
from butterfly_tpu_torch.engine.serving import ServingEngine
from butterfly_tpu_torch.models import draft as TD
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.models.common import Model
from butterfly_tpu_torch.sched.scheduler import Scheduler

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls

CFG = tiny("llama", dtype="float32", param_dtype="float32")
TCFG = tconfig.tiny("llama", dtype="float32", param_dtype="float32")
_TREES = {}


def trees(quant=False):
    """(JAX tree, port tree bridged from it), float or int8 weights."""
    if quant not in _TREES:
        jp = JModel(CFG).init(jax.random.PRNGKey(42))
        if quant:
            jp = jax_quantize(jp, CFG)
        _TREES[quant] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                               device="cpu"))
    return _TREES[quant]


def _rt(mod, **kw):
    base = dict(max_batch_size=4, max_seq_len=64, page_size=8,
                prefill_chunk=8, prefill_inline_budget=8)
    base.update(kw)
    return mod.RuntimeConfig(**base)


class _J:
    RuntimeConfig = JRuntime


def _run(sched, prompts, max_new=12, **kw):
    reqs = [sched.submit(p, max_new_tokens=max_new, **kw) for p in prompts]
    sched.run_until_done()
    assert all(r.state == "finished" for r in reqs)
    return [r.output for r in reqs]


def jax_sched(quant=False, **kw):
    return JScheduler(JEngine(JModel(CFG), trees(quant)[0], _rt(_J, **kw),
                              use_kernels=False))


def port_sched(quant=False, seed=0, **kw):
    return Scheduler(ServingEngine(Model(TCFG, device="cpu"),
                                   trees(quant)[1], _rt(tconfig, **kw)),
                     seed=seed)


PROMPTS = [[5, 7, 11], [3, 3, 3, 3, 3], [2], list(range(1, 9))]
MODEL = dict(draft_model="model", draft_layers=1)


# -- derivation ---------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_derivation_truncates_and_shares_leaves(quant):
    tp = trees(quant)[1]
    dcfg, dp = TD.derive_draft_params(tp, TCFG, 1)
    assert dcfg.num_layers == 1 and dcfg.vocab_size == TCFG.vocab_size
    for key in ("embed", "final_norm", "lm_head"):
        assert dp[key] is tp[key]              # shared, not copied

    def pairs(a, b):
        if isinstance(a, dict):
            for k in a:
                yield from pairs(a[k], b[k])
        else:
            yield a, b
    n = 0
    for full, cut in pairs(tp["layers"], dp["layers"]):
        assert cut.shape == (1,) + full.shape[1:] and cut.dtype == full.dtype
        assert cut.data_ptr() == full.data_ptr()   # a view of layer 0
        n += 1
    assert n > 0
    if quant:
        assert dp["layers"]["attn"]["wq"]["q8"].dtype == torch.int8


def test_derivation_depth_matches_jax():
    for n in (0, 1):
        assert TD.resolve_draft_layers(TCFG, n) == \
            JD.resolve_draft_layers(CFG, n)
    for bad in (-1, 2, 5):
        with pytest.raises(ValueError):
            TD.resolve_draft_layers(TCFG, bad)


def test_draft_ckpt_refused_naming_the_roadmap_item(tmp_path):
    """An independent draft checkpoint is loaded now: one whose vocabulary
    is not the target's is refused when the engine builds, with the JAX
    loader's message."""
    import json

    from butterfly_tpu.ckpt.load import load_draft_checkpoint
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": 100, "hidden_size": 16,
        "num_hidden_layers": 1, "num_attention_heads": 2,
        "intermediate_size": 32}))
    with pytest.raises(ValueError) as want:
        load_draft_checkpoint(str(tmp_path), CFG)
    with pytest.raises(ValueError, match="vocab 100 != target vocab") as got:
        port_sched(speculative_gamma=2, draft_model="model",
                   draft_ckpt=str(tmp_path))
    assert str(got.value) == str(want.value)


def test_unknown_draft_source_fails_at_build():
    with pytest.raises(ValueError, match="draft source"):
        port_sched(speculative_gamma=2, draft_model="nope")


def test_tree_geometry_validated():
    with pytest.raises(ValueError, match="spec_tree_nodes"):
        port_sched(speculative_gamma=3, spec_tree_width=2, **MODEL)
    with pytest.raises(ValueError, match="tree_draft"):
        port_sched(speculative_gamma=4, spec_tree_width=2)


def test_registered_draft_function_plugs_in():
    TS.register_draft_source("ngram_twin", TS._ngram_drafts)
    try:
        want = _run(port_sched(speculative_gamma=3), PROMPTS[:2])
        got = _run(port_sched(speculative_gamma=3, draft_model="ngram_twin"),
                   PROMPTS[:2])
        assert got == want
    finally:
        del TS.DRAFT_SOURCES["ngram_twin"]


# -- draft prefill and rollback ---------------------------------------------------

def test_draft_prefill_pads_and_drops():
    """Member rows seed exactly their prompt length and the JAX step's
    K/V; padding rows (out-of-range slot ids) write nowhere."""
    jdcfg, jdp = JD.derive_draft_params(trees()[0], CFG, 1)
    tdcfg, tdp = TD.derive_draft_params(trees()[1], TCFG, 1)
    jsrc = JD.ModelDraftSource(jdcfg, jdp, num_slots=4, width=32)
    tsrc = TD.ModelDraftSource(tdcfg, tdp, num_slots=4, width=32)
    js, ts = jsrc.init_state(), tsrc.init_state()
    js = js._replace(length=js.length.at[3].set(9))
    ts.length[3] = 9
    ts.k[:, 3] = 7.0                            # poison: must survive
    rows = np.zeros((3, 32), np.int32)
    rows[0, :5] = [5, 7, 11, 2, 4]
    rows[1, :3] = [3, 1, 4]
    rows[2, :2] = [6, 6]
    slots = np.asarray([0, 2, 1], np.int32)     # 3 members -> 4-row bucket
    lens = np.asarray([5, 3, 2], np.int32)
    js = jsrc.prefill(js, slots, rows, lens)
    ts = tsrc.prefill(ts, torch.from_numpy(slots), rows, lens)
    assert ts.length.tolist() == [5, 2, 3, 9] == np.asarray(js.length).tolist()
    assert (ts.k[:, 3] == 7.0).all()
    for slot, n in zip(slots, lens):
        np.testing.assert_allclose(ts.k[:, slot, :n].numpy(),
                                   np.asarray(js.k)[:, slot, :n],
                                   atol=2e-5, rtol=0)


def test_draft_kv_rollback_exact():
    """At a drain barrier a live slot's draft length is hist_len - 1:
    rollback by the ACCEPTED count, with rejections happening."""
    rng = np.random.RandomState(0)
    sched = port_sched(max_batch_size=2, speculative_gamma=3, **MODEL)
    req = sched.submit(rng.randint(1, TCFG.vocab_size, (12,)).tolist(),
                       max_new_tokens=30)
    for _ in range(200):
        if req.state == "running":
            break
        sched.tick()
    for _ in range(3):
        sched.tick()
    sched._drain_inflight()
    assert req.state == "running"
    hl = int(sched._hist_len_dev[req.slot])
    dl = int(sched.engine._draft_state.length[req.slot])
    assert dl > 0 and dl == hl - 1, (dl, hl)
    assert sched.metrics()["spec_accept_rate"] < 1.0
    sched.run_until_done()


# -- model drafts and trees against the JAX scheduler -------------------------------

#: held against the JAX scheduler, counters included
CASES = {
    "model-win": dict(speculative_gamma=3, **MODEL),
    "model-nowin": dict(speculative_gamma=3, kv_write_combine=False,
                        decode_steps_per_tick=4, **MODEL),
    "tree-win": dict(speculative_gamma=4, spec_tree_width=2, **MODEL),
    "tree-nowin": dict(speculative_gamma=4, spec_tree_width=2,
                       kv_write_combine=False, **MODEL),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_draft_spec_tokens_match_jax(case):
    kw = CASES[case]
    js, ts = jax_sched(**kw), port_sched(**kw)
    assert _run(ts, PROMPTS) == _run(js, PROMPTS)
    jm, tm = js.metrics(), ts.metrics()
    for key in ("spec_forwards_total", "spec_drafts_accepted_total"):
        assert tm[key] == jm[key], key
    assert tm["spec_mixed_fallback_reason"] == jm["spec_mixed_fallback_reason"]
    assert tm["spec_drafts_accepted_total"] > 0


#: held against the port's plain greedy scheduler (itself held against
#: the JAX scheduler in tests/test_torch_serving.py and test_torch_quant.py)
PLAIN_CASES = {
    "model-int8kv": dict(speculative_gamma=3, kv_quant="int8", **MODEL),
    "tree-w3-nodes7": dict(speculative_gamma=2, spec_tree_width=3,
                           spec_tree_nodes=7, **MODEL),
    "tree-int8kv-k4": dict(speculative_gamma=4, spec_tree_width=2,
                           kv_quant="int8", decode_steps_per_tick=4,
                           **MODEL),
}


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_draft_spec_equals_plain_greedy_grid(case):
    kw = PLAIN_CASES[case]
    plain = _run(port_sched(kv_quant=kw.get("kv_quant", "none")), PROMPTS)
    sched = port_sched(**kw)
    assert _run(sched, PROMPTS) == plain
    assert sched.metrics()["spec_forwards_total"] > 0
    if kw.get("kv_quant") == "int8":
        assert sched.engine._draft_state.quantized
        assert sched.engine._draft_state.k.dtype == torch.int8


def test_draft_spec_equals_plain_greedy():
    plain = _run(port_sched(), PROMPTS)
    assert _run(port_sched(speculative_gamma=3, decode_steps_per_tick=8,
                           inflight_blocks=1, **MODEL), PROMPTS) == plain


def test_draft_sampling_finishes_and_reproduces():
    outs = []
    for _ in range(2):
        sched = port_sched(seed=7, speculative_gamma=4, spec_tree_width=2,
                           **MODEL)
        r1 = sched.submit([5, 7], max_new_tokens=8, temperature=0.8)
        r2 = sched.submit([3, 1, 4], max_new_tokens=6)
        sched.run_until_done()
        assert len(r1.output) == 8 and len(r2.output) == 6
        outs.append((r1.output, r2.output))
    assert outs[0] == outs[1]
