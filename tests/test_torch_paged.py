"""PyTorch port: the paged cache and the paged forward against the JAX
package on tiny llama (2 layers, D=64, Nq=4, Kv=2, H=16), float32.

* logits of paged_forward / paged_forward_window at 1e-4: the same
  arithmetic, but XLA and ATen sum the matmuls in other orders and the
  differences compound over two layers;
* window staging, paged writes and the window flush move bytes, so
  given the same K/V they must leave the window and pool BYTE-identical
  to JAX's, float and int8 alike (int8 codes come from the same
  round-half-even quantization).

The JAX side runs its decode steps with use_kernel=True (the Pallas
kernel in interpret mode) and with use_kernel=False (dense gather); the
port's CPU side runs the plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butterfly_tpu.cache import paged as JP
from butterfly_tpu.core.config import RuntimeConfig, tiny
from butterfly_tpu.models.common import Model as JModel
from butterfly_tpu_torch.cache import paged as TP
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.models.bridge import params_from_numpy

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls

TOL = 1e-4
CFG = tiny("llama", dtype="float32", param_dtype="float32")
TCFG = tconfig.tiny("llama", dtype="float32", param_dtype="float32")
RT = dict(max_batch_size=3, max_seq_len=32, page_size=4)


@pytest.fixture(scope="module")
def params():
    jp = JModel(CFG).init(jax.random.PRNGKey(11))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _caches(quant: bool):
    kvq = "int8" if quant else "none"
    jc = JP.init_paged_cache(CFG, RuntimeConfig(**RT, kv_quant=kvq))
    tc = TP.init_paged_cache(TCFG, tconfig.RuntimeConfig(**RT, kv_quant=kvq),
                             device="cpu")
    # slot 0 owns pages 0-3, slot 1 pages 4-6, slot 2 nothing (null rows)
    table = np.full((3, 8), jc.null_page, np.int32)
    table[0, :4] = [0, 1, 2, 3]
    table[1, :3] = [4, 5, 6]
    jc = jc._replace(page_table=jnp.asarray(table))
    tc = tc._replace(page_table=torch.from_numpy(table.copy()))
    return jc, tc


def _t(a):
    return torch.from_numpy(np.array(a))


def _pools_equal(jc, tc, skip_null=True):
    names = ["k_pages", "v_pages"]
    if jc.k_scale_pages is not None:
        names += ["k_scale_pages", "v_scale_pages"]
    for n in names:
        a, b = np.asarray(getattr(jc, n)), getattr(tc, n).numpy()
        if skip_null:  # duplicate writes to the null page land in any order
            a, b = a[:, :-1], b[:, :-1]
        assert a.dtype == b.dtype, n
        assert np.array_equal(a, b), n


def _prefill(jp, tp, jc, tc):
    toks = np.array([[5, 9, 2, 7, 1, 3], [8, 8, 4, 0, 0, 0],
                     [1, 1, 1, 1, 1, 1]], np.int32)
    active = np.array([True, True, False])
    jl, jc = JP.paged_forward(jp, CFG, jnp.asarray(toks), jc,
                              active=jnp.asarray(active))
    tl, tc = TP.paged_forward(tp, TCFG, _t(toks).long(), tc,
                              active=_t(active))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    assert np.array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    return jc, tc


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("jax_kernel", [True, False],
                         ids=["jax_kernel", "jax_dense"])
def test_paged_forward_decode_matches_jax(params, quant, jax_kernel):
    jp, tp = params
    jc, tc = _prefill(jp, tp, *_caches(quant))
    for step, tok in enumerate(([3, 6, 0], [7, 1, 0])):
        tok = np.array(tok, np.int32)[:, None]
        active = np.array([True, True, False])
        jl, jc = JP.paged_forward(jp, CFG, jnp.asarray(tok), jc,
                                  active=jnp.asarray(active),
                                  use_kernel=jax_kernel)
        tl, tc = TP.paged_forward(tp, TCFG, _t(tok).long(), tc,
                                  active=_t(active), use_kernel=True)
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   atol=TOL, rtol=0, err_msg=f"step {step}")
    assert np.array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("jax_kernel", [True, False],
                         ids=["jax_kernel", "jax_dense"])
def test_paged_forward_window_matches_jax(params, quant, jax_kernel):
    jp, tp = params
    jc, tc = _prefill(jp, tp, *_caches(quant))
    jw, tw = JP.init_kv_window(jc, 4), TP.init_kv_window(tc, 4)
    jwl = jnp.zeros((3,), jnp.int32)
    twl = torch.zeros((3,), dtype=torch.int32)
    active = np.array([True, True, False])
    # a 2-token chunk (dense insert path on both sides), then decode
    # steps through the kernel path
    for tok in ([[3, 4], [6, 2], [0, 0]], [[7], [1], [0]], [[2], [5], [0]]):
        tok = np.array(tok, np.int32)
        T = tok.shape[1]
        jl, jw = JP.paged_forward_window(
            jp, CFG, jnp.asarray(tok), jc, jw, jwl,
            active=jnp.asarray(active), use_kernel=jax_kernel)
        tl, tw = TP.paged_forward_window(
            tp, TCFG, _t(tok).long(), tc, tw, twl, active=_t(active),
            use_kernel=True)
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   atol=TOL, rtol=0)
        jwl = jwl + jnp.asarray(active * T, jnp.int32)
        twl = twl + _t(active * T).int()
    # flushing moves the staged K/V into the pool: the model's K/V
    # differ from JAX's by rounding, so compare against the port's own
    # window bytes landing at the right pool positions
    staged = {n: getattr(tw, n).clone() for n in ("k", "v")}
    tc2, twl2, flushed = TP.flush_paged_window(tc, tw, twl)
    assert int(flushed) == 8 and twl2.tolist() == [0, 0, 0]
    assert tc2.lengths.tolist() == [10, 10, 0]
    # slot 0's staged entry 0 sits at position 6 -> page 1, offset 2
    assert torch.equal(tc2.k_pages[:, 1, :, 2], staged["k"][:, 0, :, 0])
    # slot 1's staged entry 3 sits at position 9 -> page 6, offset 1
    assert torch.equal(tc2.v_pages[:, 6, :, 1], staged["v"][:, 1, :, 3])


def _kv(seed, B, T):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, 2, 16)).astype(np.float32) * 2
            for _ in range(2)]


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_stage_write_and_flush_bytes_match_jax(quant):
    jc, tc = _caches(quant)
    # window-off writes: the same K/V into the pool at per-slot starts
    k, v = _kv(1, 3, 3)
    start = np.array([0, 2, 0], np.int32)
    active = np.array([True, True, False])
    for layer in range(CFG.num_layers):
        js = (jc.k_scale_pages[layer], jc.v_scale_pages[layer]) if quant \
            else (None, None)
        out = JP.write_paged_layer(jc.k_pages[layer], jc.v_pages[layer],
                                   jc.page_table, jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(start),
                                   jnp.asarray(active), *js)
        jc = jc._replace(
            k_pages=jc.k_pages.at[layer].set(out[0]),
            v_pages=jc.v_pages.at[layer].set(out[1]),
            **({"k_scale_pages": jc.k_scale_pages.at[layer].set(out[2]),
                "v_scale_pages": jc.v_scale_pages.at[layer].set(out[3])}
               if quant else {}))
        ts = (tc.k_scale_pages[layer], tc.v_scale_pages[layer]) if quant \
            else (None, None)
        TP.write_paged_layer(tc.k_pages[layer], tc.v_pages[layer],
                             tc.page_table, _t(k), _t(v), _t(start),
                             _t(active), *ts)
    _pools_equal(jc, tc)
    jc = jc._replace(lengths=jnp.asarray([3, 5, 0], jnp.int32))
    tc = tc._replace(lengths=torch.tensor([3, 5, 0], dtype=torch.int32))
    # window staging: two staging calls per layer, then ONE flush
    W = 6
    jw, tw = JP.init_kv_window(jc, W), TP.init_kv_window(tc, W)
    jwl = np.array([0, 1, 0], np.int32)
    new_w = {n: [] for n in ("k", "v", "k_scale", "v_scale")}
    for call, T in enumerate((2, 3)):
        k, v = _kv(10 + call, 3, T)
        for layer in range(CFG.num_layers):
            jsc = (jw.k_scale[layer], jw.v_scale[layer]) if quant \
                else (None, None)
            out = JP.stage_window_layer(jw.k[layer], jw.v[layer],
                                        jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(jwl), *jsc)
            new_w["k"].append(out[0])
            new_w["v"].append(out[1])
            if quant:
                new_w["k_scale"].append(out[2])
                new_w["v_scale"].append(out[3])
            tsc = (tw.k_scale[layer], tw.v_scale[layer]) if quant \
                else (None, None)
            TP.stage_window_layer(tw.k[layer], tw.v[layer], _t(k), _t(v),
                                  _t(jwl), *tsc)
        jw = JP.KVWindow(*[jnp.stack(new_w[n]) if new_w[n] else None
                           for n in ("k", "v", "k_scale", "v_scale")])
        new_w = {n: [] for n in new_w}
        for n in ("k", "v") + (("k_scale", "v_scale") if quant else ()):
            assert np.array_equal(getattr(tw, n).numpy(),
                                  np.asarray(getattr(jw, n))), n
        jwl = jwl + np.array([T, T, 0], np.int32)
    jc2, jwl2, jn = JP.flush_paged_window(jc, jw, jnp.asarray(jwl))
    tc2, twl2, tn = TP.flush_paged_window(tc, tw, _t(jwl))
    _pools_equal(jc2, tc2)
    assert np.array_equal(tc2.lengths.numpy(), np.asarray(jc2.lengths))
    assert int(tn) == int(jn) and twl2.tolist() == [0, 0, 0]


def test_window_staging_past_width_drops():
    """Entries past the window width are dropped (JAX mode="drop"),
    never clamped onto a valid entry."""
    W = 4
    rng = np.random.default_rng(3)
    wk = rng.standard_normal((3, 2, W, 16)).astype(np.float32)
    wv = wk.copy()
    k, v = _kv(4, 3, 3)
    wl = np.array([2, 4, 0], np.int32)   # slot 0 overflows by 1, slot 1 by 3
    jk, jv, _, _ = JP.stage_window_layer(jnp.asarray(wk), jnp.asarray(wv),
                                         jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(wl))
    tk, tv = _t(wk), _t(wv)
    TP.stage_window_layer(tk, tv, _t(k), _t(v), _t(wl))
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
