"""PyTorch port: pipeline stages (parallel/pipeline.py, the stage axis of
core/mesh.py and parallel/partition.py, the engines' pipeline hooks, the
CLI's --stage-parallel) against the JAX package, float32.

The JAX side runs its GPipe and interleaved schedules (shard_map over
`stage`) on the harness's fake CPU devices; the port's single-controller
mesh puts every shard on `cpu` and runs the schedule as a host loop.
Logits and caches agree within 2e-5 (tests/test_pipeline.py's bound),
greedy tokens are identical, int8 pools byte-identical, and the
validation errors carry the JAX messages word for word. The engine and
scheduler runs are held against the JAX package's unmeshed tokens, which
its own stage tests hold equal to its stage-meshed runs.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butterfly_tpu.core import config as jconfig
from butterfly_tpu.core.mesh import make_mesh as jmake_mesh
from butterfly_tpu.engine.engine import InferenceEngine as JInference
from butterfly_tpu.engine.sampling import SamplingParams as JSampling
from butterfly_tpu.engine.serving import ServingEngine as JServing
from butterfly_tpu.models import common as JC
from butterfly_tpu.parallel import partition as JP
from butterfly_tpu.parallel import pipeline as JPP
from butterfly_tpu.sched.scheduler import Scheduler as JScheduler
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.core.mesh import (make_mesh, stage_degree,
                                           stage_devices)
from butterfly_tpu_torch.engine.engine import InferenceEngine
from butterfly_tpu_torch.engine.sampling import SamplingParams
from butterfly_tpu_torch.engine.serving import ServingEngine
from butterfly_tpu_torch.models import common as TC
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.obs import benchmark as bm
from butterfly_tpu_torch.parallel import partition as TP
from butterfly_tpu_torch.parallel import pipeline as TPP
from butterfly_tpu_torch.parallel.partition import Shards, axis_parts
from butterfly_tpu_torch.sched.scheduler import Scheduler
from butterfly_tpu_torch.serve import cli

torch.set_num_threads(1)

TOL = 2e-5
PP = dict(vocab_size=256, hidden_size=64, num_heads=8, num_kv_heads=8,
          head_dim=8, intermediate_size=128, dtype="float32",
          param_dtype="float32")
# tests/test_serving_mesh.py's shape: kv heads divide tensor = 4
SERVE = dict(num_heads=8, num_kv_heads=4, head_dim=8, dtype="float32",
             param_dtype="float32")
PROMPTS = [[5, 7, 11], [3, 1], [2, 4, 6, 8], [9]]


def pp_cfg(mod, num_layers=4, **kw):
    """test_pipeline.py's pp_cfg, in either package's config module."""
    return mod.tiny("llama", num_layers=num_layers, **{**PP, **kw})


def meshes(**axes):
    """(JAX mesh over the fake CPU devices, port mesh over `cpu`)."""
    n = int(np.prod(list(axes.values())))
    return (jmake_mesh(jconfig.MeshConfig(**axes), jax.devices()[:n]),
            make_mesh(tconfig.MeshConfig(**axes), ["cpu"] * n))


_TREES = {}


def trees(seed, num_layers=4, shape=None):
    """(JAX Model.init tree, the port's tree bridged from it)."""
    shape = shape or PP
    key = (seed, num_layers, tuple(sorted(shape.items())))
    if key not in _TREES:
        jp = JC.Model(jconfig.tiny("llama", num_layers=num_layers,
                                   **shape)).init(jax.random.PRNGKey(seed))
        _TREES[key] = (jp, params_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return _TREES[key]


def full(x):
    """A placed leaf gathered into one tensor (stage parts over L, tensor
    parts over their split dim, the first of replicated data parts)."""
    if isinstance(x, Shards):
        parts = [full(p) for p in x.parts]
        if x.split is None:
            return parts[0]
        return torch.cat(parts, dim=x.split)
    return x


def jax_ref(cfg, params, tokens, max_seq=32):
    cache = JC.init_cache(cfg, batch=tokens.shape[0], max_seq=max_seq)
    return jax.jit(lambda p, t, c: JC.forward(p, cfg, t, c))(
        params, tokens, cache)


def jax_pipeline(cfg, params, tokens, mesh, mb, V=1, max_seq=32):
    sp = JP.shard_params(params, cfg, mesh)
    cache = JP.shard_cache(JC.init_cache(cfg, batch=tokens.shape[0],
                                         max_seq=max_seq), cfg, mesh)
    with jax.set_mesh(mesh):
        return jax.jit(lambda p, t, c: JPP.pipeline_forward(
            p, cfg, t, c, mesh, num_microbatches=mb, virtual_stages=V))(
                sp, tokens, cache)


def port_pipeline(cfg, tree, tokens, mesh, mb, V=1, max_seq=32):
    sp = TP.shard_params(tree, cfg, mesh)
    cache = TP.shard_cache(TC.init_cache(cfg, tokens.shape[0], max_seq,
                                         device="cpu"), cfg, mesh)
    logits, cache = TPP.pipeline_forward(sp, cfg, torch.as_tensor(tokens),
                                         cache, mesh, num_microbatches=mb,
                                         virtual_stages=V)
    return logits, cache, sp


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


# -- the forward: GPipe, the fallback, the interleaved schedule -----------------

@pytest.mark.parametrize("axes,mb", [
    (dict(stage=4, data=2), 2), (dict(stage=2, tensor=4), 4),
    (dict(stage=4, tensor=2), 1)], ids=["s4d2", "s2t4", "s4t2"])
def test_pipeline_prefill_parity(axes, mb):
    """test_pipeline.py:34-60: the prefill's logits and cache on each
    mesh equal the JAX pipeline's and its plain forward's."""
    jcfg, tcfg = pp_cfg(jconfig), pp_cfg(tconfig)
    jp, tp = trees(0)
    jmesh, tmesh = meshes(**axes)
    tokens = np.random.RandomState(0).randint(0, 256, (4, 10))
    ref_logits, ref_cache = jax_ref(jcfg, jp, jnp.asarray(tokens))
    jl, _ = jax_pipeline(jcfg, jp, jnp.asarray(tokens), jmesh, mb)
    logits, cache, _ = port_pipeline(tcfg, tp, tokens, tmesh, mb)
    close(logits, jl)
    close(logits, ref_logits)
    close(full(cache.k), ref_cache.k)
    close(full(cache.v), ref_cache.v)
    assert cache.length.tolist() == np.asarray(ref_cache.length).tolist()
    kp = cache.k
    assert kp.axis == "stage" and len(kp.parts) == axes["stage"]


def test_pipeline_decode_parity():
    """test_pipeline.py:63: a prefill, then three decode steps through
    the pipeline on stage 4 x data 2 (M 2), each step's logits within
    2e-5 of the JAX plain forward's, the greedy tokens equal."""
    jcfg, tcfg = pp_cfg(jconfig), pp_cfg(tconfig)
    jp, tp = trees(1)
    _, tmesh = meshes(stage=4, data=2)
    tokens = np.random.RandomState(1).randint(0, 256, (4, 6))
    ref_logits, ref_cache = jax_ref(jcfg, jp, jnp.asarray(tokens))
    logits, cache, sp = port_pipeline(tcfg, tp, tokens, tmesh, 2)
    close(logits, ref_logits)
    step = jax.jit(lambda p, t, c: JC.forward(p, jcfg, t, c))
    for _ in range(3):
        nxt = jnp.argmax(ref_logits[:, -1, :], axis=-1)[:, None]
        assert torch.argmax(logits[:, -1], -1).tolist() == \
            np.asarray(nxt[:, 0]).tolist()
        ref_logits, ref_cache = step(jp, nxt, ref_cache)
        logits, cache = TPP.pipeline_forward(
            sp, tcfg, torch.tensor(np.asarray(nxt)), cache, tmesh,
            num_microbatches=2)
        close(logits, ref_logits)
    close(full(cache.k), ref_cache.k)


def test_pipeline_stage1_fallback():
    """test_pipeline.py:93: a mesh without stages (tensor 8) runs the
    plain forward."""
    jcfg, tcfg = pp_cfg(jconfig, 2), pp_cfg(tconfig, 2)
    jp, tp = trees(2, 2)
    _, tmesh = meshes(tensor=8)
    tokens = np.random.RandomState(2).randint(0, 256, (2, 5))
    ref_logits, _ = jax_ref(jcfg, jp, jnp.asarray(tokens))
    logits, _, _ = port_pipeline(tcfg, tp, tokens, tmesh, None)
    close(logits, ref_logits)


def test_interleave_layers_order_leaf_by_leaf():
    """The interleaved order of every stacked leaf equals JAX's, and the
    inverse undoes it."""
    jp, tp = trees(4, 8)
    jint = JPP.interleave_layers(jp["layers"], 8, 2, 2)
    tint = TPP.interleave_layers(tp["layers"], 8, 2, 2)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jint),
                            jax.tree_util.tree_leaves(tint)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=str(path))
    back = TPP.interleave_layers(tint, 8, 2, 2, inverse=True)
    assert torch.equal(back["attn"]["wq"], tp["layers"]["attn"]["wq"])
    ar = torch.arange(8)
    assert TPP.interleave_layers(ar, 8, 2, 2).tolist() == \
        np.asarray(JPP.interleave_layers(jnp.arange(8), 8, 2, 2)).tolist()


def test_interleaved_pipeline_parity():
    """test_pipeline.py:111: S 2 x V 2 chunks on stage 2 x tensor 4 (M 2):
    logits and the cache (back out of interleaved order) equal the JAX
    schedule's and the plain forward's; then two decode steps."""
    jcfg, tcfg = pp_cfg(jconfig, 8), pp_cfg(tconfig, 8)
    jp, tp = trees(4, 8)
    jmesh, tmesh = meshes(stage=2, tensor=4)
    tokens = np.random.RandomState(4).randint(0, 256, (4, 10))
    ref_logits, ref_cache = jax_ref(jcfg, jp, jnp.asarray(tokens))
    jip = dict(jp, layers=JPP.interleave_layers(jp["layers"], 8, 2, 2))
    jl, _ = jax_pipeline(jcfg, jip, jnp.asarray(tokens), jmesh, 2, V=2)
    tip = dict(tp, layers=TPP.interleave_layers(tp["layers"], 8, 2, 2))
    logits, cache, sp = port_pipeline(tcfg, tip, tokens, tmesh, 2, V=2)
    close(logits, jl)
    close(logits, ref_logits)
    k_back = TPP.interleave_layers(full(cache.k), 8, 2, 2, inverse=True)
    close(k_back, ref_cache.k)
    step = jax.jit(lambda p, t, c: JC.forward(p, jcfg, t, c))
    for _ in range(2):
        nxt = jnp.argmax(ref_logits[:, -1, :], axis=-1)[:, None]
        ref_logits, ref_cache = step(jp, nxt, ref_cache)
        logits, cache = TPP.pipeline_forward(
            sp, tcfg, torch.tensor(np.asarray(nxt)), cache, tmesh,
            num_microbatches=2, virtual_stages=2)
        close(logits, ref_logits)


VALIDATION = {
    # (layers of the tree, of the cfg, axes, microbatches, virtual stages)
    "batch_microbatches": (4, 4, dict(stage=4, data=2), 3, 1),
    "layers_stages": (4, 6, dict(stage=4, data=2), 2, 1),
    "interleaved_microbatches": (8, 8, dict(stage=2, tensor=4), 1, 2),
    "interleaved_chunks": (8, 6, dict(stage=2, tensor=4), 2, 2),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_pipeline_validation_messages(case):
    """test_pipeline.py:151, :214: each refusal raises ValueError with
    the JAX message word for word."""
    n_tree, n_cfg, axes, mb, V = VALIDATION[case]
    jmesh, tmesh = meshes(**axes)
    jp, tp = trees(0, n_tree)
    jcfg, tcfg = pp_cfg(jconfig, n_cfg), pp_cfg(tconfig, n_cfg)
    jtree = JP.shard_params(jp, pp_cfg(jconfig, n_tree), jmesh)
    jcache = JP.shard_cache(JC.init_cache(pp_cfg(jconfig, n_tree), 4, 16),
                            pp_cfg(jconfig, n_tree), jmesh)
    with pytest.raises(ValueError) as want:
        JPP.pipeline_forward(jtree, jcfg, jnp.zeros((4, 4), jnp.int32),
                             jcache, jmesh, num_microbatches=mb,
                             virtual_stages=V)
    ttree = TP.shard_params(tp, pp_cfg(tconfig, n_tree), tmesh)
    tcache = TP.shard_cache(TC.init_cache(pp_cfg(tconfig, n_tree), 4, 16,
                                          device="cpu"),
                            pp_cfg(tconfig, n_tree), tmesh)
    with pytest.raises(ValueError) as got:
        TPP.pipeline_forward(ttree, tcfg, torch.zeros((4, 4),
                                                      dtype=torch.int32),
                             tcache, tmesh, num_microbatches=mb,
                             virtual_stages=V)
    assert str(got.value) == str(want.value)


def test_paged_pipeline_validation_messages():
    """The paged pipeline's refusals, JAX's messages word for word."""
    from butterfly_tpu.cache import paged as JPG
    from butterfly_tpu_torch.cache import paged as TPG
    jmesh, tmesh = meshes(stage=4, data=2)
    jcfg, tcfg = pp_cfg(jconfig, 6), pp_cfg(tconfig, 6)
    rt = dict(max_batch_size=4, max_seq_len=32, page_size=8)
    jp, tp = trees(0, 4)
    jcache = JPG.init_paged_cache(jcfg, jconfig.RuntimeConfig(**rt))
    tcache = TPG.init_paged_cache(tcfg, tconfig.RuntimeConfig(**rt),
                                  device="cpu")
    for cfgs, mb in (((pp_cfg(jconfig), pp_cfg(tconfig)), 3),
                     ((jcfg, tcfg), 2)):
        with pytest.raises(ValueError) as want:
            JPP.paged_pipeline_forward(jp, cfgs[0], jnp.zeros((4, 1),
                                                              jnp.int32),
                                       jcache, mesh=jmesh,
                                       num_microbatches=mb)
        with pytest.raises(ValueError) as got:
            TPP.paged_pipeline_forward(tp, cfgs[1], torch.zeros(
                (4, 1), dtype=torch.int32), tcache, mesh=tmesh,
                num_microbatches=mb)
        assert str(got.value) == str(want.value)


def test_default_microbatches_as_jax():
    for B in range(1, 17):
        for S in (1, 2, 3, 4):
            assert TPP._default_microbatches(B, S) == \
                JPP._default_microbatches(B, S)


# -- placement ---------------------------------------------------------------------

def test_stage_placement_allocates_nothing():
    """shard_params on stage 2 x tensor 2 of one device: every stage's
    part is a view of the stacked leaf (the layer rows [s*L/S, ...)),
    the int8 tree too; the pools and caches hold [L/S, ...] per stage."""
    from butterfly_tpu_torch.quant.int8 import (quantize_int8,
                                                shard_quantized_params)
    tcfg = pp_cfg(tconfig)
    _, tp = trees(0)
    _, tmesh = meshes(stage=2, tensor=2)
    sp = TP.shard_params(tp, tcfg, tmesh)
    wq = sp["layers"]["attn"]["wq"]
    assert wq.axis == "stage" and [p.axis for p in wq.parts] == \
        ["tensor", "tensor"]
    base = tp["layers"]["attn"]["wq"]
    for s, part in enumerate(wq.parts):
        for i, t in enumerate(part.parts):
            assert t.untyped_storage().data_ptr() == \
                base.untyped_storage().data_ptr()
            assert torch.equal(t, base[2 * s:2 * s + 2, :, 4 * i:4 * i + 4])
    assert isinstance(sp["embed"]["tok"], Shards)   # stage 0's tensor axis
    qp = quantize_int8(tp, tcfg)
    qs = shard_quantized_params(qp, tcfg, tmesh)
    q8 = qs["layers"]["attn"]["wq"]["q8"]
    assert q8.axis == "stage" and torch.equal(
        full(q8), qp["layers"]["attn"]["wq"]["q8"])
    cache = TC.init_cache(tcfg, 4, 16, device="cpu", mesh=tmesh)
    assert [full(p).shape[0] for p in cache.k.parts] == [2, 2]
    assert stage_degree(tmesh) == 2 and stage_devices(tmesh) == \
        [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="not divisible"):
        TP.shard_params(trees(0, 2)[1], pp_cfg(tconfig, 2),
                        meshes(stage=4)[1])


def test_mesh_refuses_stage_with_seq_or_expert():
    """Stage with seq or expert builds (no stage mesh is refused any
    more): a stage's own mesh keeps the other axis whole, and the
    prefill through the pipeline on each mesh (seq a replica; the dense
    model's expert axis idle) gives the JAX pipeline's logits on the
    same mesh."""
    jcfg, tcfg = pp_cfg(jconfig), pp_cfg(tconfig)
    jp, tp = trees(0)
    tokens = np.random.RandomState(0).randint(0, 256, (4, 10))
    for axes in (dict(stage=2, seq=2), dict(stage=2, expert=2)):
        jmesh, tmesh = meshes(**axes)
        other = "seq" if "seq" in axes else "expert"
        sub = tmesh.stage_mesh(1)
        assert sub.shape["stage"] == 1 and sub.shape[other] == 2
        jl, _ = jax_pipeline(jcfg, jp, jnp.asarray(tokens), jmesh, 2)
        tl, _, _ = port_pipeline(tcfg, tp, tokens, tmesh, 2)
        close(tl, jl)
    m = make_mesh(tconfig.MeshConfig(stage=2, data=2), ["cpu"] * 4)
    sub = m.stage_mesh(1)
    assert sub.shape["stage"] == 1 and sub.shape["data"] == 2


# -- the inference engine -----------------------------------------------------------

def _jax_generate(seed, num_layers, prompts, n, kv_quant="none", cfg=None):
    jcfg = cfg or pp_cfg(jconfig, num_layers)
    jp = trees(seed, num_layers, None if cfg is None else SERVE)[0]
    return JInference(JC.Model(jcfg), jp, jconfig.RuntimeConfig(
        kv_quant=kv_quant)).generate(prompts, JSampling(
            max_new_tokens=n)).tokens


def test_engine_generate_interleaved_stages():
    """test_pipeline.py:228: virtual_stages 2 on stage 2 x tensor 4 (M 2):
    the stack placed once as interleaved chunk views (nothing copied),
    the tokens of the JAX engine."""
    tcfg = pp_cfg(tconfig, 8)
    jp, tp = trees(5, 8)
    _, tmesh = meshes(stage=2, tensor=4)
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [2]]
    want = _jax_generate(5, 8, prompts, 5)
    eng = InferenceEngine(TC.Model(tcfg, device="cpu"), tp, mesh=tmesh,
                          num_microbatches=2, virtual_stages=2)
    wq = eng.params["layers"]["attn"]["wq"]
    assert wq.axis == "stage" and len(wq.parts) == 4
    # chunk v of stage s is layer block v*S + s of the stack, a view
    base = tp["layers"]["attn"]["wq"]
    for c, g in enumerate((0, 2, 1, 3)):
        assert torch.equal(full(wq.parts[c]), base[2 * g:2 * g + 2])
        assert wq.parts[c].parts[0].untyped_storage().data_ptr() == \
            base.untyped_storage().data_ptr()
    got = eng.generate(prompts, SamplingParams(max_new_tokens=5)).tokens
    np.testing.assert_array_equal(got, want)
    # a tree shard_params placed in natural order takes the same path
    eng2 = InferenceEngine(TC.Model(tcfg, device="cpu"),
                           TP.shard_params(tp, tcfg, tmesh), mesh=tmesh,
                           num_microbatches=2, virtual_stages=2)
    np.testing.assert_array_equal(eng2.generate(
        prompts, SamplingParams(max_new_tokens=5)).tokens, want)


def test_engine_generate_on_pp_mesh_odd_batch():
    """test_pipeline.py:245: 3 prompts on data 2 x stage 2 x tensor 2
    (batch padded, dummy rows stripped), fused and stepped."""
    tcfg = pp_cfg(tconfig)
    _, tp = trees(3)
    _, tmesh = meshes(data=2, stage=2, tensor=2)
    prompts = [[1, 2, 3], [4, 5], [6]]
    want = _jax_generate(3, 4, prompts, 4)
    eng = InferenceEngine(TC.Model(tcfg, device="cpu"), tp, mesh=tmesh)
    for fused in (True, False):
        res = eng.generate(prompts, SamplingParams(max_new_tokens=4),
                           fused=fused)
        assert res.tokens.shape == (3, 4) and res.lengths.shape == (3,)
        np.testing.assert_array_equal(res.tokens, want)


def test_kv_quant_pipeline_mesh_token_parity():
    """tests/test_kv_quant.py:148-175: int8 K/V through GPipe and the
    interleaved schedule on stage 2 x data 2, the scale leaves split over
    stage with the codes: the tokens of the unmeshed int8 JAX engine."""
    cfg = tconfig.tiny("llama", dtype="float32", param_dtype="float32",
                       num_layers=4)
    jcfg = jconfig.tiny("llama", dtype="float32", param_dtype="float32",
                        num_layers=4)
    jp = JC.Model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    prompts = [[5, 7, 11, 2], [3, 1, 4, 1]]
    want = JInference(JC.Model(jcfg), jp, jconfig.RuntimeConfig(
        kv_quant="int8")).generate(prompts, JSampling(max_new_tokens=8))
    _, tmesh = meshes(stage=2, data=2)
    rt = tconfig.RuntimeConfig(kv_quant="int8")
    for V in (1, 2):
        eng = InferenceEngine(TC.Model(cfg, device="cpu"), tp, rt,
                              mesh=tmesh, num_microbatches=2,
                              virtual_stages=V)
        assert eng._decode_window == 1
        got = eng.generate(prompts, SamplingParams(max_new_tokens=8))
        np.testing.assert_array_equal(got.tokens, want.tokens)


# -- serving ---------------------------------------------------------------------

def _rt(mod, **kw):
    return mod.RuntimeConfig(**{**dict(max_batch_size=4, max_seq_len=64,
                                       page_size=8), **kw})


@pytest.fixture(scope="module")
def jax_serve_tokens():
    """The unmeshed JAX scheduler's greedy tokens (test_serving_mesh.py
    holds its stage 2 x tensor 4 and stage 2 x data 4 runs equal)."""
    jp, _ = trees(42, 2, SERVE)
    out = {}
    for kvq in ("none", "int8"):
        s = JScheduler(JServing(JC.Model(jconfig.tiny("llama", **SERVE)),
                                jp, _rt(jconfig, kv_quant=kvq)))
        reqs = [s.submit(p, max_new_tokens=6) for p in PROMPTS]
        s.run_until_done()
        out[kvq] = [r.output for r in reqs]
    return out


def _port_sched(mesh=None, **kw):
    _, tp = trees(42, 2, SERVE)
    return Scheduler(ServingEngine(
        TC.Model(tconfig.tiny("llama", **SERVE), device="cpu"), tp,
        _rt(tconfig, **kw), mesh=mesh))


def _drive(sched, n=6):
    reqs = [sched.submit(p, max_new_tokens=n) for p in PROMPTS]
    sched.run_until_done()
    return [r.output for r in reqs]


@pytest.mark.parametrize("axes", [dict(stage=2, tensor=4),
                                  dict(stage=2, data=4)],
                         ids=["s2t4", "s2d4"])
def test_stage_parallel_scheduler_token_parity(jax_serve_tokens, axes):
    """tests/test_serving_mesh.py:119-150: mixed dispatch (the window off
    under stage) and the alternating path, every program through the
    GPipe schedule; the kernels' path (plain versions on the CPU) too."""
    _, tmesh = meshes(**axes)
    for kw in ({}, dict(mixed_dispatch=False)):
        sched = _port_sched(tmesh, **kw)
        assert not sched.engine._window_mode
        assert not sched.engine.supports_seq_parallel
        assert _drive(sched) == jax_serve_tokens["none"], kw
    eng = _port_sched(tmesh).engine
    eng._use_kernels = True
    assert _drive(Scheduler(eng)) == jax_serve_tokens["none"]


def test_stage_pool_is_stage_sharded():
    """test_serving_mesh.py:152: each stage's pool holds only its layers
    (and its tensor shard's kv heads)."""
    _, tmesh = meshes(stage=2, tensor=4)
    kp = _port_sched(tmesh).engine.cache.k_pages
    assert kp.axis == "stage" and len(kp.parts) == 2
    for p in kp.parts:
        assert p.axis == "tensor" and p.shape[0] == 1
        assert all(t.shape[2] == 1 for t in p.parts)


def test_stage_indivisible_layers_rejected():
    """test_serving_mesh.py:162: 2 layers over 4 stages."""
    _, tmesh = meshes(stage=4, data=2)
    with pytest.raises(ValueError, match="not divisible"):
        _port_sched(tmesh)


def test_serving_int8_under_stage_mesh_matches_unmeshed(jax_serve_tokens):
    """tests/test_kv_quant.py:255-266: the int8 pool through the paged
    pipeline at stage 2, against the unmeshed pool on the same per-token
    write path (the window is off under stage), layer by layer. 4 slots
    (M 4): greedy tokens equal JAX's and every code byte equal; the f32
    scales come from projections of one slot's rows, not four, so they
    may round differently in the last bit. 1 slot (M 1, the same
    products): every byte equal, codes and scales."""
    _, tmesh = meshes(stage=2)
    names = ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages")
    for slots in (4, 1):
        meshed = _port_sched(tmesh, kv_quant="int8", max_batch_size=slots)
        plain = _port_sched(kv_quant="int8", kv_write_combine=False,
                            max_batch_size=slots)
        got_tokens = _drive(meshed)
        assert got_tokens == _drive(plain)
        if slots == 4:
            assert got_tokens == jax_serve_tokens["int8"]
        for name in names if slots == 1 else names[:2]:
            got = getattr(meshed.engine.cache, name)
            want = getattr(plain.engine.cache, name)
            assert got.axis == "stage"
            for s, part in enumerate(got.parts):
                assert torch.equal(part, want[s:s + 1]), (slots, name, s)
    pids = list(range(4))
    for a, b in zip(meshed.engine.read_pages(pids),
                    plain.engine.read_pages(pids)):
        assert torch.equal(a, b)
    meshed.engine.write_pages([5], *[t[:, :1] for t in
                                      plain.engine.read_pages([0])])
    assert torch.equal(meshed.engine.read_pages([5])[0],
                       plain.engine.read_pages([0])[0])


def test_tree_speculation_refused_under_stage():
    _, tmesh = meshes(stage=2)
    with pytest.raises(ValueError, match="tree speculation does not "
                                         "compose with pipeline"):
        _port_sched(tmesh, speculative_gamma=4, draft_model="model",
                    draft_layers=1, spec_tree_width=2)


def test_ngram_speculation_under_stage(jax_serve_tokens):
    """Linear spec blocks run through the pipeline: greedy output is the
    plain greedy decode's."""
    _, tmesh = meshes(stage=2)
    assert _drive(_port_sched(tmesh, speculative_gamma=2)) == \
        jax_serve_tokens["none"]


def test_draft_deeper_than_a_stage_under_stage_mesh():
    """A 2-layer draft model over 4 stages of 1 layer (the reference's
    _build_model_draft_source runs any n < L on the stage-split tree):
    the draft's layers come from the first two stages' slices, views of
    the one tree, and the greedy tokens equal JAX's stage = 4 run and the
    port's unmeshed run."""
    shape = dict(SERVE, num_layers=4)
    spec = dict(speculative_gamma=2, draft_model="model", draft_layers=2)
    jp, tp = trees(42, 4, SERVE)
    jmesh, tmesh = meshes(stage=4)
    js = JScheduler(JServing(JC.Model(jconfig.tiny("llama", **shape)), jp,
                             _rt(jconfig, **spec), mesh=jmesh))
    jreqs = [js.submit(p, max_new_tokens=6) for p in PROMPTS]
    js.run_until_done()
    want = [r.output for r in jreqs]

    def port(mesh):
        return Scheduler(ServingEngine(
            TC.Model(tconfig.tiny("llama", **shape), device="cpu"), tp,
            _rt(tconfig, **spec), mesh=mesh))
    meshed = port(tmesh)
    dlayers = meshed.engine._draft_src.params["layers"]
    for leaf, src in ((dlayers["attn"]["wq"], tp["layers"]["attn"]["wq"]),
                      (dlayers["mlp"]["w_down"],
                       tp["layers"]["mlp"]["w_down"])):
        assert leaf.shape[0] == 2
        assert leaf.untyped_storage().data_ptr() == \
            src.untyped_storage().data_ptr()
        assert torch.equal(leaf, src[:2])
    assert _drive(meshed) == want
    assert _drive(port(None)) == want


def test_scheduler_warns_seq_lane_off_under_stage():
    """sched/scheduler.py (JAX :256): a seq-parallel threshold on an
    engine that cannot run the lane warns and serves on."""
    _, tmesh = meshes(stage=2)
    with pytest.warns(RuntimeWarning, match="stage == 1"):
        sched = _port_sched(tmesh, seq_parallel_threshold=16)
    assert _drive(sched, n=2)


# -- the CLI and the bench ------------------------------------------------------

def _cli(capsys, *argv):
    rc = cli.main(list(argv))
    out, err = capsys.readouterr()
    return rc, out, err


def test_cli_stage_parallel_gives_the_same_text(capsys):
    """generate | serve | bench --device cpu --stage-parallel 2: the text
    and tokens of the run without it; the decode leg counts one card."""
    from butterfly_tpu_torch.serve.server import build_serving
    base = ["generate", "--model", "tiny", "--device", "cpu", "--prompt",
            "hello", "--max-new", "6"]
    rc0, want, _ = _cli(capsys, *base)
    rc1, got, _ = _cli(capsys, *base, "--stage-parallel", "2")
    assert rc0 == rc1 == 0 and got == want
    args = cli.build_parser().parse_args(base + ["--stage-parallel", "2",
                                                 "--tensor-parallel", "2"])
    mesh = cli.build_mesh(args)
    assert mesh.shape["stage"] == 2 and mesh.shape["tensor"] == 2
    texts = []
    for extra in ([], ["--stage-parallel", "2"]):
        args = cli.build_parser().parse_args(
            ["serve", "--model", "tiny", "--device", "cpu", "--max-seq",
             "128", "--port", "0", "--timeseries-interval", "0"] + extra)
        sched, tok, _ = build_serving(args)
        r = sched.submit(tok.encode("hello"), max_new_tokens=6,
                         temperature=0.0)
        sched.run_until_done()
        texts.append(tok.decode(r.output))
    assert texts[0] == texts[1]
    capsys.readouterr()
    rc, out, _ = _cli(capsys, "bench", "--model", "tiny", "--device", "cpu",
                      "--stage-parallel", "2", "--batch", "2",
                      "--prompt-len", "16", "--max-new", "4")
    line = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and line["value"] > 0 and line["n_chips"] == 1


def test_decode_leg_on_a_stage_mesh_counts_one_tree():
    """obs/benchmark.py: on a stage mesh the decode leg streams the tree
    once (each stage's layers) and counts the mesh's distinct devices."""
    tcfg = pp_cfg(tconfig)
    _, tp = trees(0)
    _, tmesh = meshes(stage=2, data=2)
    model = TC.Model(tcfg, device="cpu")
    res = bm.run_decode_benchmark(model, tp, batch=2, prompt_len=8,
                                  max_new=3, mesh=tmesh)
    plain = bm.run_decode_benchmark(model, tp, batch=2, prompt_len=8,
                                    max_new=3)
    assert res["n_chips"] == plain["n_chips"] == 1
    want = sum(t.nbytes for t in bm._leaves(tp))
    assert sum(t.nbytes for t in bm._leaves(
        InferenceEngine(model, tp, mesh=tmesh).params)) == want
    assert axis_parts(InferenceEngine(model, tp, mesh=tmesh).params[
        "layers"]["ln1"]["scale"], "stage") is not None
