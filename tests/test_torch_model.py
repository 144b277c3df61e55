"""PyTorch port: the weight bridge and the layer math, function by
function, against the JAX package on the same numpy inputs. f32 at 2e-5:
the functions are the same arithmetic, summed in another order by
ATen's and XLA's CPU kernels."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butterfly_tpu.core.config import tiny
from butterfly_tpu.models import common as J
from butterfly_tpu.models.common import Model as JModel
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.models import common as T
from butterfly_tpu_torch.models.bridge import params_from_numpy

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls

TOL = 2e-5
CFG = tiny("llama", dtype="float32", param_dtype="float32")
TCFG = tconfig.tiny("llama", dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module")
def trees():
    jp = JModel(CFG).init(jax.random.PRNGKey(7))
    npt = jax.tree.map(np.asarray, jp)
    return jp, params_from_numpy(npt, device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_bridge_is_element_for_element(trees):
    jp, tp = trees
    jf, tf = _flat(jax.tree.map(np.asarray, jp)), _flat(tp)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        assert tuple(tf[k].shape) == jf[k].shape, k
        assert np.array_equal(tf[k].numpy(), jf[k]), k


def test_bridge_carries_bfloat16_bits():
    a = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)),
                    jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(a)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(),
                          np.asarray(a.astype(jnp.float32)))


def test_port_init_fills_the_same_tree(trees):
    jp, _ = trees
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = T.init_params(TCFG, gen, "cpu")
    jf, tf = _flat(jax.tree.map(np.asarray, jp)), _flat(tp)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        assert tuple(tf[k].shape) == jf[k].shape
        assert tf[k].dtype == torch.float32
    # bf16 leaves are the float32 draws rounded, bit for bit
    bcfg = TCFG.replace(param_dtype="bfloat16")
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(3)
    g2.manual_seed(3)
    f32 = T.init_params(TCFG, g1, "cpu")
    b16 = T.init_params(bcfg, g2, "cpu")
    for k, v in _flat(f32).items():
        assert torch.equal(v.to(torch.bfloat16), _flat(b16)[k]), k


def test_quantize_kv_codes_byte_identical():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 2, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0                       # zero vector -> scale 1
    x[1, 1, 1, :4] = [0.5, -0.5, 1.5, 2.5]  # round-half-even ties
    jc, js = J.quantize_kv(jnp.asarray(x))
    tc, ts = T.quantize_kv(_t(x))
    assert tc.dtype == torch.int8
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(ts.numpy(), np.asarray(js))


def test_rms_norm_and_rope():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    sc = rng.standard_normal((64,)).astype(np.float32)
    _close(T.rms_norm(_t(x), _t(sc), 1e-5),
           J.rms_norm(jnp.asarray(x), jnp.asarray(sc), 1e-5))
    pos = np.array([[0, 1, 2], [7, 40, 127]], np.int32)
    jc, js = J.rope_freqs(CFG, jnp.asarray(pos))
    tc, ts = T.rope_freqs(TCFG, _t(pos))
    _close(tc, jc)
    _close(ts, js)
    xq = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    _close(T.apply_rope(_t(xq), tc, ts),
           J.apply_rope(jnp.asarray(xq), jc, js))


def test_qkv_proj_ffn_and_output(trees):
    jp, tp = trees
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    pos = np.array([[0, 1, 2], [5, 6, 7]], np.int32)
    jc, js = J.rope_freqs(CFG, jnp.asarray(pos))
    tc, ts = T.rope_freqs(TCFG, _t(pos))
    jl = jax.tree.map(lambda a: a[1], jp["layers"])
    tl = T.layer_params(tp, 1)
    for got, want in zip(T.qkv_proj(_t(x), tl["attn"], TCFG, tc, ts),
                         J.qkv_proj(jnp.asarray(x), jl["attn"], CFG, jc,
                                    js)):
        _close(got, want)
    _close(T.ffn_block(_t(x), tl, TCFG), J.ffn_block(jnp.asarray(x), jl,
                                                      CFG))
    out = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    _close(T.attn_output(_t(out), tl["attn"], TCFG),
           J.attn_output(jnp.asarray(out), jl["attn"], CFG))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_attend(quant):
    rng = np.random.default_rng(4)
    B, Tq, S = 2, 3, 10
    q = rng.standard_normal((B, Tq, 4, 16)).astype(np.float32)
    pos = np.array([[3, 4, 5], [0, 1, 2]], np.int32)
    mask = np.asarray(J.make_mask(jnp.asarray(pos), S))
    assert np.array_equal(T.make_mask(_t(pos), S).numpy(), mask)
    if quant:
        k = rng.integers(-127, 128, (B, 2, S, 16)).astype(np.int8)
        v = rng.integers(-127, 128, (B, 2, S, 16)).astype(np.int8)
        ks = (rng.random((B, 2, S)) * 0.02).astype(np.float32)
        vs = (rng.random((B, 2, S)) * 0.02).astype(np.float32)
        want = J.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(mask), CFG, jnp.asarray(ks),
                        jnp.asarray(vs))
        got = T.attend(_t(q), _t(k), _t(v), _t(mask), TCFG, _t(ks), _t(vs))
    else:
        k = rng.standard_normal((B, S, 2, 16)).astype(np.float32)
        v = rng.standard_normal((B, S, 2, 16)).astype(np.float32)
        want = J.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(mask), CFG)
        got = T.attend(_t(q), _t(k), _t(v), _t(mask), TCFG)
    _close(got, want)


def test_embed_and_final_logits(trees):
    jp, tp = trees
    toks = np.array([[1, 200, 257], [0, 5, 9]], np.int32)
    pos = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    jx, jc, js = J.embed_tokens(jp, CFG, jnp.asarray(toks), jnp.asarray(pos))
    tx, tc, ts = T.embed_tokens(tp, TCFG, _t(toks).long(), _t(pos))
    _close(tx, jx)
    _close(tc, jc)
    _close(ts, js)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    got = T.final_logits(tp, TCFG, _t(x))
    assert got.dtype == torch.float32
    _close(got, J.final_logits(jp, CFG, jnp.asarray(x)))


def test_model_handle_init_cache_and_call(trees):
    """The Model handle's init_cache and call match the module-level
    functions and the JAX handle's `__call__` (logits and cache) on the
    same weights and tokens: a prompt, then one appended token."""
    jp, tp = trees
    jm, tm = JModel(CFG), T.Model(TCFG, device="cpu")
    tc = tm.init_cache(2, 32)
    ref = T.init_cache(TCFG, 2, 32, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tc, ref) if a is not None)
    jc = jm.init_cache(2, 32)
    assert tuple(tc.k.shape) == jc.k.shape and tc.k.dtype == torch.float32
    toks = np.random.RandomState(3).randint(1, CFG.vocab_size, (2, 7))
    for step in (toks, toks[:, :1]):
        jl, jc = jm(jp, jnp.asarray(step, jnp.int32), jc)
        tl, tc = tm(tp, _t(step.astype(np.int32)), tc)
        rl, ref = T.forward(tp, TCFG, _t(step.astype(np.int32)), ref)
        _close(tl, jl)
        assert torch.equal(tl, rl)
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)
        assert np.array_equal(tc.length.numpy(), np.asarray(jc.length))
