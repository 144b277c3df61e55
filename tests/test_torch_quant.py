"""PyTorch port: int8 weight-only quantization (quant/int8.py) against the
JAX package on tiny models.

Codes and scales are compared byte for byte (round half to even and the
same float32 division on both sides), in float32 and bfloat16. qeinsum
outputs are held at 2e-5 in float32 (the same products summed in another
order by ATen's and XLA's CPU kernels). Greedy tokens on an int8 tree are
held exactly against the JAX InferenceEngine and the JAX scheduler, with
mixed dispatch on and off. The JAX side runs its Pallas flash kernels in
interpret mode.
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
from butterfly_tpu.engine.serving import ServingEngine as JServing
from butterfly_tpu.models import common as J
from butterfly_tpu.quant import int8 as JQ
from butterfly_tpu.sched.scheduler import Scheduler as JScheduler
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.engine.engine import InferenceEngine, cast_params
from butterfly_tpu_torch.engine.sampling import SamplingParams
from butterfly_tpu_torch.engine.serving import ServingEngine
from butterfly_tpu_torch.models import common as T
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.quant import int8 as TQ
from butterfly_tpu_torch.sched.scheduler import Scheduler
from butterfly_tpu_torch.serve import cli

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls

TOL = 2e-5
F32 = dict(dtype="float32", param_dtype="float32")
_TREES = {}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def trees(arch="llama"):
    """(JAX float tree, JAX int8 tree, port int8 tree bridged from it)."""
    if arch not in _TREES:
        cfg = tiny(arch, **F32)
        jp = J.Model(cfg).init(jax.random.PRNGKey(5))
        jq = JQ.quantize_int8(jp, cfg)
        _TREES[arch] = (jp, jq, params_from_numpy(_np_tree(jq),
                                                  device="cpu"))
    return _TREES[arch]


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict, quantized leaves split into .q8/.s."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def _bytes(a):
    """A leaf's raw bytes as numpy (bf16 through a uint16 view)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# -- the quantized tree ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama", "gpt2"])
def test_codes_and_scales_byte_identical(arch, dtype):
    jp = trees(arch)[0]
    cfg = tiny(arch, dtype=dtype, param_dtype=dtype)
    jin = jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)), jp)
    want = _flat(_np_tree(JQ.quantize_int8(jin, cfg)))
    got = _flat(TQ.quantize_int8(params_from_numpy(_np_tree(jin),
                                                   device="cpu"),
                                 tconfig.tiny(arch, dtype=dtype,
                                              param_dtype=dtype)))
    assert got.keys() == want.keys()
    n_q = 0
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == w.dtype.name, path
        np.testing.assert_array_equal(_bytes(g), _bytes(w), err_msg=path)
        n_q += path.endswith("/q8")
    assert n_q >= 6     # every attention and MLP matmul, and lm_head


def test_quantized_leaves_are_int8_and_bounded():
    jp, _, tq = trees()
    leaf = tq["layers"]["attn"]["wq"]
    assert leaf["q8"].dtype == torch.int8
    assert leaf["s"].shape == (2, 1, 4, 16)        # [L, 1(D), N, H]
    w = torch.from_numpy(np.array(jp["layers"]["attn"]["wq"]))
    deq = TQ.maybe_dequant(leaf, torch.float32)
    assert (deq - w).abs().le(0.5 * leaf["s"] + 1e-7).all()
    # numerically delicate leaves stay float
    assert tq["embed"]["tok"].dtype == torch.float32
    assert tq["layers"]["ln1"]["scale"].dtype == torch.float32
    assert TQ.tree_is_quantized(tq) and not TQ.tree_is_quantized(
        params_from_numpy(_np_tree(jp), device="cpu"))
    assert TQ.is_quantized_leaf(leaf) and not TQ.is_quantized_leaf(w)
    assert TQ.maybe_dequant(w, torch.float32) is w


def test_bridge_keeps_int8_leaves():
    """params_from_numpy walks the nested {"q8", "s"} dicts and keeps the
    integer leaves as they are, also when asked to cast the floats."""
    jq = trees()[1]
    t = params_from_numpy(_np_tree(jq), device="cpu", dtype=torch.bfloat16)
    leaf = t["lm_head"]
    assert leaf["q8"].dtype == torch.int8 and leaf["s"].dtype == torch.bfloat16
    np.testing.assert_array_equal(leaf["q8"].numpy(),
                                  np.asarray(jq["lm_head"]["q8"]))


SPECS = [("btd,dnh->btnh", "wq"), ("btd,dkh->btkh", "wk"),
         ("btd,dkh->btkh", "wv"), ("btnh,nhd->btd", "wo"),
         ("btd,df->btf", "w_gate"), ("btd,df->btf", "w_up"),
         ("btf,fd->btd", "w_down"), ("btd,dv->btv", "lm_head")]


@pytest.mark.parametrize("spec,name", SPECS, ids=[n for _, n in SPECS])
def test_qeinsum_matches_jax(spec, name):
    _, jq, tq = trees()
    if name == "lm_head":
        jl, tl = jq["lm_head"], tq["lm_head"]
    else:
        grp = "attn" if name.startswith("w") and len(name) == 2 else "mlp"
        jl = jax.tree.map(lambda a: a[1], jq["layers"][grp][name])
        tl = {k: v[1] for k, v in tq["layers"][grp][name].items()}
    lhs, rhs = spec.split("->")[0].split(",")
    dims = {"b": 2, "t": 3}
    for ch, n in zip(rhs, jl["q8"].shape):
        dims[ch] = n
    xshape = [dims[c] for c in lhs]
    x = np.random.RandomState(1).randn(*xshape).astype(np.float32)
    want = JQ.qeinsum(spec, jnp.asarray(x), jl)
    got = TQ.qeinsum(spec, torch.from_numpy(x), tl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    # float weights take the plain einsum, cast to the compute dtype
    w = TQ.maybe_dequant(tl, torch.float64)
    got = TQ.qeinsum(spec, torch.from_numpy(x), w)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("arch", ["llama", "gpt2"])
def test_init_params_quantized_matches_jax_structure(arch):
    cfg = tiny(arch, dtype="bfloat16", param_dtype="float32")
    want = _flat(jax.eval_shape(lambda k: JQ.init_params_quantized(cfg, k),
                                jax.random.PRNGKey(0)))
    gen = torch.Generator()
    gen.manual_seed(0)
    got = _flat(TQ.init_params_quantized(
        tconfig.tiny(arch, dtype="bfloat16", param_dtype="float32"), gen,
        device="cpu"))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert str(got[path].dtype).split(".")[-1] == w.dtype.name, path
    q = got["/layers/attn/wq/q8"].float() * got["/layers/attn/wq/s"].float()
    assert 0.015 < q.std().item() < 0.025     # N(0, 0.02) weights
    assert (got["/layers/ln1/scale"] == 1).all()


def test_init_params_quantized_chunks_like_one_draw(monkeypatch):
    """Chunked init is per-output-channel independent: every chunk's
    scale is its own columns' absmax, whatever the chunk size."""
    monkeypatch.setattr(TQ, "_INIT_CHUNK_ELEMS", 1000)
    cfg = tconfig.tiny("llama", **F32)
    t = TQ.init_params_quantized(cfg, None, device="cpu")
    leaf = t["lm_head"]                            # [D, V], chunked on V
    amax = leaf["q8"].abs().amax(dim=0)
    assert (amax == 127).all()                     # each column hits 127
    assert leaf["s"].shape == (1, cfg.vocab_size)


# -- the engines on an int8 tree ------------------------------------------------

def _jax_generate(fused, prompts, max_new=10):
    eng = JEngine(J.Model(tiny("llama", **F32)), trees()[1],
                  JRuntime(max_seq_len=64), use_flash_prefill=True)
    res = eng.generate(prompts, JSP(max_new_tokens=max_new), fused=fused)
    return np.asarray(res.tokens), np.asarray(res.lengths)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepped"])
def test_generate_int8_tokens_match_jax(fused):
    prompts = [[5, 7, 11, 13], [2, 4, 6, 8, 10, 12, 14]]
    want = _jax_generate(fused, prompts)
    eng = InferenceEngine(T.Model(tconfig.tiny("llama", **F32),
                                  device="cpu"), trees()[2],
                          tconfig.RuntimeConfig(max_seq_len=64))
    got = eng.generate(prompts, SamplingParams(max_new_tokens=10),
                       fused=fused)
    assert got.tokens.tolist() == want[0].tolist()
    assert got.lengths.tolist() == want[1].tolist()
    # the engine holds the codes as int8, not a quietly cast copy
    assert eng.params["layers"]["mlp"]["w_up"]["q8"].dtype == torch.int8


def test_int8_logits_match_the_dequantized_tree():
    """One forward on the int8 tree against the same forward on the
    maybe_dequant float tree: the scale on the output is the scale on
    the weight."""
    tq = trees()[2]
    cfg = tconfig.tiny("llama", **F32)
    deq = TQ.dequant_tree(tq, torch.float32)
    toks = torch.tensor([[5, 7, 11, 13, 2, 4]])
    a, _ = T.forward(tq, cfg, toks, T.init_cache(cfg, 1, 16, device="cpu"))
    b, _ = T.forward(deq, cfg, toks, T.init_cache(cfg, 1, 16, device="cpu"))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=0)


def test_cast_params_keeps_codes():
    """cast_params leaves q8 int8 and takes the scales to the compute
    dtype with the rest of the floats."""
    tq = trees()[2]
    bf = cast_params(tq, tconfig.tiny("llama", dtype="bfloat16"))
    assert bf["layers"]["attn"]["wo"]["q8"].dtype == torch.int8
    assert bf["layers"]["attn"]["wo"]["s"].dtype == torch.bfloat16
    assert bf["layers"]["attn"]["wo"]["q8"] is tq["layers"]["attn"]["wo"]["q8"]


def _rt(mod, **kw):
    base = dict(max_batch_size=3, max_seq_len=96, page_size=8,
                prefill_chunk=8, prefill_inline_budget=8)
    base.update(kw)
    return mod.RuntimeConfig(**base)


class _JR:
    RuntimeConfig = JRuntime


PROMPTS = [[5, 7, 11], [3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3], [2, 9]]


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "alternating"])
def test_scheduler_int8_tokens_match_jax(mixed):
    js = JScheduler(JServing(J.Model(tiny("llama", **F32)), trees()[1],
                             _rt(_JR, mixed_dispatch=mixed),
                             use_kernels=False))
    want = [js.submit(p, max_new_tokens=9) for p in PROMPTS]
    js.run_until_done()
    eng = ServingEngine(T.Model(tconfig.tiny("llama", **F32), device="cpu"),
                        trees()[2], _rt(tconfig, mixed_dispatch=mixed))
    ts = Scheduler(eng)
    got = [ts.submit(p, max_new_tokens=9) for p in PROMPTS]
    ts.run_until_done()
    assert [r.output for r in got] == [r.output for r in want]
    for leaf in ("wq", "wk", "wv", "wo"):
        assert eng.params["layers"]["attn"][leaf]["q8"].dtype == torch.int8
    assert eng.params["lm_head"]["q8"].dtype == torch.int8


def test_draft_model_spec_on_int8_weights_matches_jax():
    """The draft model slices the int8 tree (codes stay int8, lm_head
    shared) and a width-2 token tree over it gives the JAX scheduler's
    greedy tokens on the same quantized weights."""
    kw = dict(speculative_gamma=4, spec_tree_width=2, draft_model="model",
              draft_layers=1)
    js = JScheduler(JServing(J.Model(tiny("llama", **F32)), trees()[1],
                             _rt(_JR, **kw), use_kernels=False))
    want = [js.submit(p, max_new_tokens=9) for p in PROMPTS]
    js.run_until_done()
    ts = Scheduler(ServingEngine(T.Model(tconfig.tiny("llama", **F32),
                                         device="cpu"), trees()[2],
                                 _rt(tconfig, **kw)))
    got = [ts.submit(p, max_new_tokens=9) for p in PROMPTS]
    ts.run_until_done()
    assert [r.output for r in got] == [r.output for r in want]
    src = ts.engine._draft_src
    assert src.params["layers"]["mlp"]["w_down"]["q8"].dtype == torch.int8
    assert src.params["lm_head"] is ts.engine.params["lm_head"]
    assert ts.metrics()["spec_forwards_total"] > 0


def test_cli_quant_flag_quantizes():
    args = cli.build_parser().parse_args(
        ["generate", "--model", "tiny", "--device", "cpu", "--quant",
         "int8"])
    model = cli.resolve_model(args)
    params = cli.load_params(model, args)
    assert TQ.tree_is_quantized(params)
    assert params["layers"]["attn"]["wq"]["q8"].dtype == torch.int8
