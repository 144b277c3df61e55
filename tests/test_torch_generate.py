"""PyTorch port: the contiguous KV cache, the forwards `generate` runs, the
InferenceEngine and the `generate` CLI against the JAX package on tiny
models, float32.

Tolerances: cache writes are compared byte for byte (int8 codes too);
logits at 2e-5 (the same arithmetic summed in another order by ATen's and
XLA's CPU kernels over two layers); greedy tokens exactly. The JAX side
runs its Pallas flash kernels in interpret mode (use_flash_prefill=True);
the port's flash wrapper takes its plain version on CPU tensors. Sampling
at temperature > 0 is held by its distribution: torch.Generator and
jax.random draw different numbers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butterfly_tpu.core.config import RuntimeConfig as JRuntime
from butterfly_tpu.core.config import tiny
from butterfly_tpu.engine.engine import InferenceEngine as JEngine
from butterfly_tpu.engine.sampling import SamplingParams as JSP
from butterfly_tpu.engine.sampling import _filter_logits as jax_filter
from butterfly_tpu.models import common as J
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.core.mesh import Mesh
from butterfly_tpu_torch.engine.engine import InferenceEngine
from butterfly_tpu_torch.engine.sampling import SamplingParams, sample
from butterfly_tpu_torch.models import common as T
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.serve import cli

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls

TOL = 2e-5
F32 = dict(dtype="float32", param_dtype="float32")
_TREES = {}


def trees(arch="llama"):
    if arch not in _TREES:
        jp = J.Model(tiny(arch, **F32)).init(jax.random.PRNGKey(3))
        _TREES[arch] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                              device="cpu"))
    return _TREES[arch]


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


def _same_cache(tc, jc):
    for name in ("k", "v", "length", "k_scale", "v_scale"):
        a, b = getattr(tc, name), getattr(jc, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.array_equal(_np(a), np.asarray(b)), name


# -- the contiguous cache ------------------------------------------------------

@pytest.mark.parametrize("quant", ["none", "int8"])
def test_init_cache_matches_jax(quant):
    cfg, tcfg = tiny("llama", **F32), tconfig.tiny("llama", **F32)
    _same_cache(T.init_cache(tcfg, 3, 20, quant=quant, device="cpu"),
                J.init_cache(cfg, 3, 20, quant=quant))


# starts per row: inside, exactly at the end, and past the end (the
# dynamic_update_slice clamp: a 5-token write at start 18 of a 20-long
# buffer lands at 15)
STARTS = np.array([2, 15, 18], np.int32)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_update_cache_layer_matches_jax_with_the_clamp(quant):
    rng = np.random.default_rng(0)
    B, S, Tn, Kv, H = 3, 20, 5, 2, 16
    k = rng.standard_normal((B, Tn, Kv, H)).astype(np.float32)
    v = rng.standard_normal((B, Tn, Kv, H)).astype(np.float32)
    if quant:
        ck0 = rng.integers(-9, 9, (B, Kv, S, H)).astype(np.int8)
        ks0 = rng.random((B, Kv, S)).astype(np.float32)
        want = J.update_cache_layer_q(jnp.asarray(ck0), jnp.asarray(ck0),
                                      jnp.asarray(ks0), jnp.asarray(ks0),
                                      jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(STARTS))
        got = T.update_cache_layer_q(_t(ck0), _t(ck0), _t(ks0), _t(ks0),
                                     _t(k), _t(v), _t(STARTS))
    else:
        ck0 = rng.standard_normal((B, S, Kv, H)).astype(np.float32)
        want = J.update_cache_layer(jnp.asarray(ck0), jnp.asarray(ck0),
                                    jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(STARTS))
        got = T.update_cache_layer(_t(ck0), _t(ck0), _t(k), _t(v),
                                   _t(STARTS))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))
    # the clamped row wrote its run at S - T, not at its start
    col = got[0][2, :, 15] if quant else got[0][2, 15]
    assert not np.array_equal(_np(col), ck0[2, :, 15] if quant
                              else ck0[2, 15])


# -- forwards -------------------------------------------------------------------

def _prompt(seed, B, Tn):
    return np.random.default_rng(seed).integers(1, 250, (B, Tn)) \
        .astype(np.int32)


def _pair(quant, S=40, B=2):
    cfg, tcfg = tiny("llama", **F32), tconfig.tiny("llama", **F32)
    q = "int8" if quant else "none"
    return (cfg, tcfg, J.init_cache(cfg, B, S, quant=q),
            T.init_cache(tcfg, B, S, quant=q, device="cpu"))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_forward_fresh_warm_and_single_token_match_jax(impl, quant):
    """A fresh prefill (last-index head), a warm 7-token chunk and a
    single-token decode step, chained on one cache."""
    jp, tp = trees()
    cfg, tcfg, jc, tc = _pair(quant)
    cfg, tcfg = cfg.replace(attn_impl=impl), tcfg.replace(attn_impl=impl)
    toks = _prompt(1, 2, 11)
    pos = np.broadcast_to(np.arange(11)[None], (2, 11)).astype(np.int32)
    li = np.array([10, 6], np.int32)
    jl, jc = J.forward(jp, cfg, jnp.asarray(toks), jc, jnp.asarray(pos),
                       fresh=True, last_index=jnp.asarray(li))
    tl, tc = T.forward(tp, tcfg, _t(toks), tc, _t(pos), fresh=True,
                       last_index=_t(li))
    _close(tl, jl)
    chunk = _prompt(2, 2, 7)
    jl, jc = J.forward(jp, cfg, jnp.asarray(chunk), jc)
    tl, tc = T.forward(tp, tcfg, _t(chunk), tc)
    _close(tl, jl)
    one = _prompt(3, 2, 1)
    jl, jc = J.forward(jp, cfg, jnp.asarray(one), jc)
    tl, tc = T.forward(tp, tcfg, _t(one), tc)
    _close(tl, jl)
    assert _np(tc.length).tolist() == np.asarray(jc.length).tolist()
    for name in ("k", "v"):
        _close(getattr(tc, name).float(),
               np.asarray(getattr(jc, name), np.float32), tol=1 if quant
               else TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("uniform", [False, True], ids=["ragged", "uniform"])
def test_decode_window_and_flush_match_jax(quant, uniform):
    """Three window steps over a prefilled cache, then one flush into a
    12-long buffer: uniform rows at 9 land flush against its end; ragged
    row 0 at 11 would run past it, so the write clamps back to 9 as
    dynamic_update_slice clamps it."""
    jp, tp = trees()
    cfg, tcfg, jc, _ = _pair(quant, S=12)
    toks = _prompt(4, 2, 9)
    lens = np.array([9, 9], np.int32) if uniform else np.array([11, 6],
                                                                np.int32)
    pos = np.broadcast_to(np.arange(9)[None], (2, 9)).astype(np.int32)
    _, jc = J.forward(jp, cfg, jnp.asarray(toks), jc, jnp.asarray(pos),
                      fresh=True)
    jc = jc._replace(length=jnp.asarray(lens))
    # the same cache bytes on both sides, so the flush compares exactly
    tc = T.KVCache(*(None if x is None else _t(np.asarray(x)) for x in jc))
    jwin, twin = [], []
    for j in range(3):
        cur = _prompt(5 + j, 2, 1)
        jl, jkv = J.decode_step_win(jp, cfg, jnp.asarray(cur), jc, jwin, j)
        tl, tkv = T.decode_step_win(tp, tcfg, _t(cur), tc, twin, j)
        _close(tl, jl)
        for a, b in zip(tkv, jkv):
            if a.dtype == torch.int8:
                assert np.array_equal(_np(a), np.asarray(b))
            else:
                _close(a, b)
        jwin.append(jkv)
        twin.append(tkv)
    jc = J.flush_window(jc, jwin, uniform=uniform)
    tc = T.flush_window(tc, [tuple(_t(np.asarray(x)) for x in s)
                             for s in jwin], uniform=uniform)
    _same_cache(tc, jc)


# -- generate --------------------------------------------------------------------

PROMPTS = [[5, 7, 11, 2, 9], list(range(1, 12)), [8, 8]]
_JAX_OUT = {}


def _window(kvq):
    """int8 runs the write-combined window loop (auto picks 16 there);
    3 keeps the JAX side's unrolled program small and still leaves a
    tail: 8 steps round up to 9."""
    return 3 if kvq == "int8" else 0


def _jax_generate(arch, kvq, max_seq, stop=-1):
    key = (arch, kvq, max_seq, stop)
    if key not in _JAX_OUT:
        eng = JEngine(J.Model(tiny(arch, **F32)), trees(arch)[0],
                      runtime=JRuntime(max_seq_len=max_seq, kv_quant=kvq,
                                       decode_window=_window(kvq)),
                      use_flash_prefill=True)
        res = eng.generate(PROMPTS, JSP(max_new_tokens=9, stop_token=stop))
        _JAX_OUT[key] = (res.tokens, res.lengths)
    return _JAX_OUT[key]


def _port_generate(arch, kvq, max_seq, fused, stop=-1):
    eng = InferenceEngine(T.Model(tconfig.tiny(arch, **F32), device="cpu"),
                          trees(arch)[1],
                          runtime=tconfig.RuntimeConfig(
                              max_seq_len=max_seq, kv_quant=kvq,
                              decode_window=_window(kvq)),
                          use_flash_prefill=True)
    res = eng.generate(PROMPTS, SamplingParams(max_new_tokens=9,
                                               stop_token=stop),
                       fused=fused)
    return res.tokens, res.lengths


# max_seq 16: generate sizes the cache exactly (prompt 11 + the window's
# rounded-up steps), so the int8 window's tail step lands at its end
GRID = [(arch, kvq, fused) for arch in ("llama", "gpt2")
        for kvq in ("none", "int8") for fused in (True, False)]


@pytest.mark.parametrize("arch,kvq,fused", GRID,
                         ids=[f"{a}-{q}-{'fused' if f else 'stepped'}"
                              for a, q, f in GRID])
def test_generate_greedy_tokens_match_jax(arch, kvq, fused):
    want = _jax_generate(arch, kvq, 16)
    got = _port_generate(arch, kvq, 16, fused)
    assert got[0].tolist() == np.asarray(want[0]).tolist()
    assert got[1].tolist() == np.asarray(want[1]).tolist()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepped"])
def test_generate_stop_token_matches_jax(fused):
    toks, _ = _jax_generate("llama", "none", 16)
    stop = int(np.asarray(toks)[0, 3])  # a token row 0 really emits
    want = _jax_generate("llama", "none", 16, stop)
    got = _port_generate("llama", "none", 16, fused, stop)
    assert got[0].tolist() == np.asarray(want[0]).tolist()
    assert got[1].tolist() == np.asarray(want[1]).tolist()
    assert got[1][0] <= 4


def test_engine_refuses_what_is_not_ported():
    eng = InferenceEngine(T.Model(tconfig.tiny("llama", **F32),
                                  device="cpu"), trees()[1])
    assert eng.device.type == "cpu" and eng._prefill_cfg.attn_impl == "dense"
    # generate_long is ported: without a seq axis it refuses as JAX does
    with pytest.raises(ValueError, match="seq axis"):
        eng.generate_long([1, 2, 3])
    # the stage axis (pipeline parallelism) runs: the plain engine's
    # tokens; stage with seq too (seq a replica), and there generate_long
    # refuses in the JAX engine's words
    devs = np.empty(2, dtype=object)
    devs[:] = [torch.device("cpu")] * 2
    staged = InferenceEngine(T.Model(tconfig.tiny("llama", **F32),
                                     device="cpu"), trees()[1],
                             mesh=Mesh(devs.reshape(1, 2, 1, 1, 1)))
    sp = SamplingParams(max_new_tokens=4)
    np.testing.assert_array_equal(staged.generate([[1, 2, 3]], sp).tokens,
                                  eng.generate([[1, 2, 3]], sp).tokens)
    devs = np.empty(4, dtype=object)
    devs[:] = [torch.device("cpu")] * 4
    staged_seq = InferenceEngine(T.Model(tconfig.tiny("llama", **F32),
                                         device="cpu"), trees()[1],
                                 mesh=Mesh(devs.reshape(1, 2, 1, 2, 1)))
    np.testing.assert_array_equal(
        staged_seq.generate([[1, 2, 3]], sp).tokens,
        eng.generate([[1, 2, 3]], sp).tokens)
    with pytest.raises(NotImplementedError,
                       match=r"does not compose with pipeline stages "
                             r"\(stage > 1\)"):
        staged_seq.generate_long([1, 2, 3])


# -- sampling held by its distribution ----------------------------------------------

@pytest.mark.parametrize("temp,top_k,top_p", [(0.7, 0, 1.0), (1.3, 3, 1.0),
                                              (0.9, 0, 0.8)],
                         ids=["plain", "top_k", "top_p"])
def test_sample_matches_softmax(temp, top_k, top_p):
    V, N = 8, 40000
    row = np.random.RandomState(2).randn(V).astype(np.float32) * 2.0
    gen = torch.Generator()
    gen.manual_seed(0)
    draws = sample(torch.from_numpy(np.tile(row, (N, 1))), gen,
                   SamplingParams(temperature=temp, top_k=top_k, top_p=top_p))
    emp = np.bincount(draws.numpy(), minlength=V) / N
    tgt = np.asarray(jax.nn.softmax(jax_filter(jnp.asarray(row) / temp,
                                               top_k, top_p)))
    assert np.abs(emp - tgt).max() < 0.015, (emp, tgt)
    assert (emp[tgt == 0] == 0).all()


def test_sample_greedy_is_argmax():
    logits = torch.from_numpy(np.random.RandomState(3).randn(5, 11)
                              .astype(np.float32))
    got = sample(logits, None, SamplingParams())
    assert got.dtype == torch.int32
    assert torch.equal(got, logits.argmax(-1).to(torch.int32))


# -- the CLI -------------------------------------------------------------------------

def test_cli_generate_on_cpu(capsys):
    rc = cli.main(["generate", "--device", "cpu", "--model", "tiny",
                   "--prompt", "hi there", "--max-new", "6"])
    out, err = capsys.readouterr()
    assert rc == 0
    assert out.endswith("\n") and len(out) > 1
    assert err.startswith("[butterfly] ") and " tokens in " in err


@pytest.mark.parametrize("flags,item", [(["--seq-parallel", "2",
                                          "--expert-parallel", "2"],
                                         "does not compose with pipeline "
                                         "stages")],
                         ids=["seq_parallel"])
def test_cli_generate_refuses_unported_flags(capsys, flags, item):
    """--seq-parallel with --expert-parallel runs generate_long (the text
    of the run without flags); the one mesh generate refuses is the JAX
    CLI's: --seq-parallel with --stage-parallel, in the engine's words."""
    base = ["generate", "--device", "cpu", "--model", "tiny", "--max-new",
            "4"]
    assert cli.main(base) == 0
    want = capsys.readouterr().out
    assert cli.main(base + flags) == 0
    assert capsys.readouterr().out == want
    with pytest.raises(NotImplementedError, match=item):
        cli.main(base + ["--seq-parallel", "2", "--stage-parallel", "2"])
