"""PyTorch port: Mixtral's MoE FFN (models/common.py route_tokens,
moe_block and the MoE leaves of init_params) and the MoE model through
every engine, against the JAX package on tiny("mixtral") (4 experts, top
2), float32 unless a test says otherwise.

Tolerances: routing indices exactly and gates within 1e-6; moe_block at
2e-5 in float32 (the same products summed in another order by ATen's and
XLA's CPU kernels) and 2e-2 in bfloat16 (a bf16 rounding of outputs of
order 1); logits at 2e-5; int8 codes and scales byte for byte; greedy
tokens exactly. The JAX side runs its Pallas flash kernels in interpret
mode; the port's wrappers take their plain versions on CPU tensors.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butterfly_tpu.core.config import MeshConfig as JMeshConfig
from butterfly_tpu.core.config import RuntimeConfig as JRuntime
from butterfly_tpu.core.config import tiny
from butterfly_tpu.core.mesh import make_mesh as jmake_mesh
from butterfly_tpu.engine.engine import InferenceEngine as JEngine
from butterfly_tpu.engine.sampling import SamplingParams as JSP
from butterfly_tpu.engine.serving import ServingEngine as JServing
from butterfly_tpu.models import common as J
from butterfly_tpu.models import draft as JD
from butterfly_tpu.quant import int8 as JQ
from butterfly_tpu.sched.scheduler import Scheduler as JScheduler
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.core.mesh import make_mesh
from butterfly_tpu_torch.engine.engine import InferenceEngine
from butterfly_tpu_torch.engine.sampling import SamplingParams
from butterfly_tpu_torch.engine.serving import ServingEngine
from butterfly_tpu_torch.models import common as T
from butterfly_tpu_torch.models import draft as TD
from butterfly_tpu_torch.models import mixtral
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.quant import int8 as TQ
from butterfly_tpu_torch.sched.scheduler import Scheduler

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls

TOL = 2e-5
F32 = dict(dtype="float32", param_dtype="float32")
CFG = tiny("mixtral", **F32)
TCFG = tconfig.tiny("mixtral", **F32)
_TREES = {}


def trees():
    """(JAX tree, the port's tree bridged from it)."""
    if not _TREES:
        jp = J.Model(CFG).init(jax.random.PRNGKey(7))
        _TREES["t"] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             device="cpu"))
    return _TREES["t"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.float() if x.dtype == torch.bfloat16 else x
        return x.numpy()
    return np.asarray(x, np.float32) if np.asarray(x).dtype.name == \
        "bfloat16" else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def _layer_moe(tree):
    return {k: v[0] for k, v in tree["layers"]["moe"].items()}


def _x(seed, B=2, Tn=6, D=64):
    return np.random.default_rng(seed).standard_normal((B, Tn, D)) \
        .astype(np.float32)


# -- the leaves -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_init_params_leaves_match_jax(kind):
    """Keys, shapes and dtypes of the MoE tree: init_params in both
    parameter dtypes, and init_params_quantized (router float, experts
    {"q8", "s"})."""
    pdt = "float32" if kind == "int8" else kind
    cfg = tiny("mixtral", dtype="bfloat16", param_dtype=pdt)
    tcfg = tconfig.tiny("mixtral", dtype="bfloat16", param_dtype=pdt)
    key = jax.random.PRNGKey(0)
    if kind == "int8":
        want = jax.eval_shape(partial(JQ.init_params_quantized, cfg), key)
        got = TQ.init_params_quantized(tcfg, device="cpu")
    else:
        want = jax.eval_shape(partial(J.init_params, cfg), key)
        got = T.init_params(tcfg, device="cpu")
    want, got = _flat(want), _flat(got)
    assert sorted(got) == sorted(want)
    assert "/layers/moe/router" in got and "/layers/mlp/w_up" not in got
    for name, w in want.items():
        assert tuple(got[name].shape) == tuple(w.shape), name
        assert str(got[name].dtype).removeprefix("torch.") == \
            str(w.dtype), name


def test_mixtral_model_handle():
    m = mixtral.model(device="cpu")
    assert m.cfg.is_moe and m.cfg.num_experts == 8 and \
        m.cfg.num_experts_per_tok == 2 and m.cfg.hidden_size == 4096
    assert m.device.type == "cpu"


# -- the MoE math ---------------------------------------------------------------

def test_route_tokens_matches_jax():
    jp, tp = trees()
    x = _x(1, Tn=9)
    jg, ji = J.route_tokens(jnp.asarray(x), jp["layers"]["moe"]["router"][0],
                            CFG.num_experts_per_tok)
    tg, ti = T.route_tokens(_t(x), tp["layers"]["moe"]["router"][0],
                            TCFG.num_experts_per_tok)
    assert _np(ti).tolist() == np.asarray(ji).tolist()
    np.testing.assert_allclose(_np(tg), np.asarray(jg), atol=1e-6, rtol=0)
    assert tg.dtype == torch.float32
    np.testing.assert_allclose(_np(tg).sum(-1), 1.0, atol=1e-6)


def test_route_tokens_ties_keep_the_lower_expert():
    """Equal logits route as lax.top_k orders them: lower index first."""
    router = np.zeros((4, 4), np.float32)
    router[0] = [1.0, 2.0, 2.0, 2.0]
    x = np.zeros((1, 1, 4), np.float32)
    x[0, 0, 0] = 1.0
    jg, ji = J.route_tokens(jnp.asarray(x), jnp.asarray(router), 2)
    tg, ti = T.route_tokens(_t(x), _t(router), 2)
    assert _np(ti).tolist() == np.asarray(ji).tolist() == [[[1, 2]]]
    np.testing.assert_allclose(_np(tg), np.asarray(jg), atol=1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", 2e-2)])
def test_moe_block_matches_jax(dtype, tol):
    jp, tp = trees()
    x = _x(2)
    jdt = jnp.dtype(dtype)
    tdt = T.torch_dtype(dtype)
    jl = jax.tree.map(lambda a: a.astype(jdt), _layer_moe(jp))
    tl = {k: v.to(tdt) for k, v in _layer_moe(tp).items()}
    want = J.moe_block(jnp.asarray(x).astype(jdt), jl, CFG.replace(
        dtype=dtype))
    got = T.moe_block(_t(x).to(tdt), tl, TCFG.replace(dtype=dtype))
    assert got.dtype == tdt and got.shape == (2, 6, 64)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)


def test_forward_logits_match_jax():
    """A fresh prefill, a warm chunk and a decode step on one cache, dense
    attention: every layer runs the MoE FFN."""
    jp, tp = trees()
    jc = J.init_cache(CFG, 2, 24)
    tc = T.init_cache(TCFG, 2, 24, device="cpu")
    toks = np.random.default_rng(3).integers(1, 250, (2, 9)).astype(np.int32)
    pos = np.broadcast_to(np.arange(9)[None], (2, 9)).astype(np.int32)
    jl, jc = J.forward(jp, CFG, jnp.asarray(toks), jc, jnp.asarray(pos),
                       fresh=True)
    tl, tc = T.forward(tp, TCFG, _t(toks), tc, _t(pos), fresh=True)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=TOL, rtol=0)
    for chunk in (toks[:, :4] + 1, toks[:, :1] + 2):
        jl, jc = J.forward(jp, CFG, jnp.asarray(chunk), jc)
        tl, tc = T.forward(tp, TCFG, _t(chunk), tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=TOL,
                                   rtol=0)


# -- greedy tokens through the engines -------------------------------------------

PROMPTS = [[5, 7, 11, 2, 9], list(range(1, 12)), [8, 8]]
GEN = [("none", True), ("none", False), ("int8", True)]


@pytest.mark.parametrize("kvq,fused", GEN, ids=["fused", "stepped",
                                                "int8_kv"])
def test_generate_greedy_tokens_match_jax(kvq, fused):
    jp, tp = trees()
    window = 3 if kvq == "int8" else 0  # int8 KV: the window loop
    want = JEngine(J.Model(CFG), jp,
                   runtime=JRuntime(max_seq_len=16, kv_quant=kvq,
                                    decode_window=window),
                   use_flash_prefill=True).generate(
        PROMPTS, JSP(max_new_tokens=9))
    got = InferenceEngine(T.Model(TCFG, device="cpu"), tp,
                          runtime=tconfig.RuntimeConfig(
                              max_seq_len=16, kv_quant=kvq,
                              decode_window=window),
                          use_flash_prefill=True).generate(
        PROMPTS, SamplingParams(max_new_tokens=9), fused=fused)
    assert got.tokens.tolist() == np.asarray(want.tokens).tolist()
    assert got.lengths.tolist() == np.asarray(want.lengths).tolist()


def _rt(cls, **kw):
    base = dict(max_batch_size=3, max_seq_len=96, page_size=8,
                prefill_chunk=8, prefill_inline_budget=8)
    base.update(kw)
    return cls(**base)


def _trace(sched):
    """Staggered admissions with prompts longer than the inline budget,
    so prefill chunks and decode steps share blocks."""
    r1 = sched.submit([5, 7, 11], max_new_tokens=8)
    sched.tick()
    r2 = sched.submit(list(range(1, 30)), max_new_tokens=6)
    r3 = sched.submit([9, 2, 4] * 5, max_new_tokens=5)
    sched.run_until_done()
    return [r.output for r in (r1, r2, r3)]


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed",
                                                      "alternating"])
def test_scheduler_greedy_tokens_match_jax(mixed):
    jp, tp = trees()
    want = _trace(JScheduler(JServing(J.Model(CFG), jp,
                                      _rt(JRuntime, mixed_dispatch=mixed))))
    sched = Scheduler(ServingEngine(T.Model(TCFG, device="cpu"), tp,
                                    _rt(tconfig.RuntimeConfig, mixed_dispatch=mixed)))
    assert sched._mixed_mode == mixed
    got = _trace(sched)
    assert got == want and [len(o) for o in got] == [8, 6, 5]


def test_generate_long_seq2_matches_jax():
    """MoE on a seq = 2 mesh: the sequence-parallel forward picks the MoE
    FFN up from the shared ffn_block."""
    jp, tp = trees()
    prompt = list(range(3, 22))
    jmesh = jmake_mesh(JMeshConfig(seq=2), devices=jax.devices()[:2])
    tmesh = make_mesh(tconfig.MeshConfig(seq=2), ["cpu"] * 2)
    want = JEngine(J.Model(CFG), jp, JRuntime(), mesh=jmesh).generate_long(
        prompt, JSP(max_new_tokens=6))
    got = InferenceEngine(T.Model(TCFG, device="cpu"), tp,
                          mesh=tmesh).generate_long(
        prompt, SamplingParams(max_new_tokens=6))
    assert got.tokens.tolist() == np.asarray(want.tokens).tolist()


# -- int8 weights ---------------------------------------------------------------

def test_int8_codes_and_scales_match_jax_on_the_moe_tree():
    jp, tp = trees()
    want = _flat(JQ.quantize_int8(jp, CFG))
    got = _flat(TQ.quantize_int8(tp, TCFG))
    assert sorted(got) == sorted(want)
    for name in ("/layers/moe/w_gate/q8", "/layers/moe/w_down/s",
                 "/layers/moe/router"):
        assert name in got, name
    for name, w in want.items():
        assert np.array_equal(_np(got[name]), np.asarray(w)), name


def test_int8_forward_matches_jax():
    jp, _ = trees()
    jq = JQ.quantize_int8(jp, CFG)
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    toks = np.random.default_rng(4).integers(1, 250, (2, 7)).astype(np.int32)
    jl, _ = J.forward(jq, CFG, jnp.asarray(toks), J.init_cache(CFG, 2, 8))
    tl, _ = T.forward(tq, TCFG, _t(toks),
                      T.init_cache(TCFG, 2, 8, device="cpu"))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=TOL, rtol=0)


# -- the draft model --------------------------------------------------------------

def test_draft_from_a_moe_target_keeps_its_moe_leaves():
    jp, tp = trees()
    jcfg, jd = JD.derive_draft_params(jp, CFG, 1)
    tcfg, td = TD.derive_draft_params(tp, TCFG, 1)
    assert tcfg.num_layers == jcfg.num_layers == 1 and tcfg.is_moe
    want, got = _flat(jd), _flat(td)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert np.array_equal(_np(got[name]), np.asarray(w)), name
    moe = td["layers"]["moe"]["w_gate"]
    assert moe.data_ptr() == tp["layers"]["moe"]["w_gate"].data_ptr()
