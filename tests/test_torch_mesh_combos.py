"""PyTorch port: the meshes that combine seq with expert and stage with
seq or expert, against the JAX package's own runs of them, float32.

The JAX side runs on the harness's 8 fake CPU devices: its seq body is
manual over `seq` alone and its pipeline body over `stage` alone, the
expert axis automatic inside, so an MoE under an expert axis takes the
a2a path on a chunk the expert axis divides (each seq shard's chunk, or
a stage's prefill microbatch) and the einsum path at decode. Under
`stage` the seq axis is a replica, and seq-parallel generation is
refused in the JAX engine's words. The port's single-controller mesh
puts every shard on `cpu`. Tolerances are tests/test_torch_combined.py's:
logits 3e-5, caches 2e-5, greedy tokens identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_combined import (CACHE, LOGITS, _close, _jax_sp_forward,
                                 _tokens, cfgs, meshes, trees)
from butterfly_tpu.core import compat
from butterfly_tpu.core import config as jconfig
from butterfly_tpu.engine.engine import InferenceEngine as JEngine
from butterfly_tpu.engine.sampling import SamplingParams as JSP
from butterfly_tpu.engine.serving import ServingEngine as JServing
from butterfly_tpu.models import common as JC
from butterfly_tpu.parallel import expert as JE
from butterfly_tpu.parallel import partition as JP
from butterfly_tpu.sched.scheduler import Scheduler as JScheduler
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.core.mesh import (active_mesh, make_mesh, mesh_ctx,
                                           seq_degree)
from butterfly_tpu_torch.engine.engine import InferenceEngine
from butterfly_tpu_torch.engine.sampling import SamplingParams
from butterfly_tpu_torch.engine.serving import ServingEngine
from butterfly_tpu_torch.models import common as TC
from butterfly_tpu_torch.parallel import expert as TE
from butterfly_tpu_torch.parallel import partition as TP
from butterfly_tpu_torch.parallel import sequence as TS
from butterfly_tpu_torch.parallel.partition import Shards
from butterfly_tpu_torch.parallel.tensor import data_groups, run_groups
from butterfly_tpu_torch.sched.scheduler import Scheduler

torch.set_num_threads(1)

MOE = dict(moe_impl="ep")
SEQ_EXPERT = [dict(seq=2, expert=2), dict(seq=2, expert=2, data=2),
              dict(seq=2, expert=2, tensor=2)]
STAGE_EXPERT = [dict(stage=2, expert=2), dict(stage=2, expert=2, data=2)]
STAGE_SEQ = [dict(stage=2, seq=2), dict(stage=2, seq=2, tensor=2)]


def _ids(axes_list):
    return ["-".join(f"{a}{n}" for a, n in axes.items())
            for axes in axes_list]


def _paths(monkeypatch):
    """Record each expert-parallel MoE call of the port: (path, x shape,
    the seq size of the active mesh: 1 inside a seq shard's own mesh)."""
    calls = []
    a2a, einsum = TE._moe_ep_a2a, TE._moe_ep_einsum

    def on_a2a(x, *a, **k):
        calls.append(("a2a", tuple(x.shape), seq_degree(active_mesh())))
        return a2a(x, *a, **k)

    def on_einsum(x, *a, **k):
        calls.append(("einsum", tuple(x.shape), seq_degree(active_mesh())))
        return einsum(x, *a, **k)
    monkeypatch.setattr(TE, "_moe_ep_a2a", on_a2a)
    monkeypatch.setattr(TE, "_moe_ep_einsum", on_einsum)
    return calls


def _views_of(tree, base) -> int:
    """How many leaves of a placed tree are not views of `base`'s
    storage (bytes the placement allocated, counted by leaf)."""
    if isinstance(tree, dict):
        return sum(_views_of(tree[k], base[k]) for k in tree)
    if isinstance(tree, Shards):
        return sum(_views_of(p, base) for p in tree.parts)
    if tree is None:
        return 0
    return int(tree.untyped_storage().data_ptr()
               != base.untyped_storage().data_ptr())


def _jax_counting_sort_drops(idx, n_chunks, C, E):
    """The (token, k) assignments JAX's a2a drops: per source chunk of
    T/n_chunks tokens over the whole batch, in (b, t, k) order, each
    expert taking C."""
    T = idx.shape[1]
    Tl = T // n_chunks
    drops = 0
    for c in range(n_chunks):
        seen = np.zeros(E, int)
        for e in idx[:, c * Tl:(c + 1) * Tl].reshape(-1):
            drops += seen[e] >= C
            seen[e] += 1
    return int(drops)


# -- seq x expert --------------------------------------------------------------

@pytest.mark.parametrize("cf", [4.0, 0.5], ids=["no-drop", "dropping"])
@pytest.mark.parametrize("axes", SEQ_EXPERT, ids=_ids(SEQ_EXPERT))
def test_sp_forward_seq_expert_matches_jax(monkeypatch, axes, cf):
    """sp_forward on seq x expert: each seq shard's MoE takes the a2a
    path over its own expert shards on its chunk (16 tokens, seq 2: a
    chunk of 8), its capacity pooled over the chunk (and the whole batch
    under data); logits and cache against JAX's, at a capacity that drops
    nothing and at one that drops (the same assignments drop, else the
    logits part)."""
    jcfg, tcfg = cfgs("mixtral", moe_capacity_factor=cf, **MOE)
    jp, tp = trees("mixtral", moe_capacity_factor=cf, **MOE)
    jmesh, tmesh = meshes(**axes)
    toks = _tokens(0, 2, 16)
    want, wcache = _jax_sp_forward(JP.shard_params(jp, jcfg, jmesh), jcfg,
                                   toks, jmesh)
    calls = _paths(monkeypatch)
    tree = TP.shard_params(tp, tcfg, tmesh)
    logits, cache = TS.sp_forward(tree, tcfg, torch.as_tensor(toks), tmesh)
    _close(TS.gather_shards(logits), want, LOGITS)
    whole = cache.gather()
    _close(whole.k, wcache.k, CACHE)
    _close(whole.v, wcache.v, CACHE)
    rows = 1 if "data" in axes else 2
    assert calls == [("a2a", (rows, 8, 64), 1)] * (
        tcfg.num_layers * 2 * (2 // rows))
    if cf < 1:
        # the dropping capacity does drop: no-drop logits differ
        full_cfg = tcfg.replace(moe_capacity_factor=4.0)
        nodrop, _ = TS.sp_forward(tree, full_cfg, torch.as_tensor(toks),
                                  tmesh)
        assert (TS.gather_shards(nodrop)
                - TS.gather_shards(logits)).abs().max() > 1e-3


@pytest.mark.parametrize("axes", SEQ_EXPERT, ids=_ids(SEQ_EXPERT))
def test_moe_block_dropped_counts_under_seq_expert(axes):
    """One MoE block at capacity 1 inside a body manual over `seq`: the
    port's per-seq-shard dispatch (seq shard i's own mesh active, the
    data groups one GroupRun) equals JAX's, and dropped_assignments over
    seq*expert chunks equals the count of JAX's counting sort, each
    (seq, expert) source chunk pooled over the whole batch."""
    jcfg, tcfg = cfgs("mixtral", **MOE)
    jp, tp = trees("mixtral", **MOE)
    jmesh, tmesh = meshes(**axes)
    Ns, Ne = axes["seq"], axes["expert"]
    x = np.random.default_rng(4).standard_normal((2, 16, 64)).astype(
        np.float32)
    p_j = jax.tree.map(lambda a: a[0], JP.shard_params(
        jp, jcfg, jmesh)["layers"]["moe"])
    P = jax.sharding.PartitionSpec
    body = compat.shard_map(
        lambda x, p: JE.moe_block_ep(x, p, jcfg, 1), jmesh,
        in_specs=(P(None, "seq", None), P()), out_specs=P(None, "seq", None),
        axis_names={"seq"})
    with compat.mesh_ctx(jmesh):
        want = np.asarray(jax.jit(body)(jnp.asarray(x), p_j))
    tree = TP.shard_params(tp, tcfg, tmesh)
    reps = TS.replicate_params(tree, tmesh)
    xt = torch.from_numpy(x)
    Tl = 16 // Ns
    outs = []
    for i in range(Ns):
        xi = xt[:, i * Tl:(i + 1) * Tl]
        with mesh_ctx(tmesh.seq_mesh(i)):
            groups = data_groups(2) or [None]

            def group(g):
                rows = slice(0, 2) if g is None else g.rows
                lp = TC.layer_params(reps.trees[0 if g is None
                                                else g.index][i], 0)
                return TE.moe_block_ep(xi[rows], lp["moe"], tcfg, 1)
            outs.append(torch.cat(run_groups(groups, group, 2)))
    _close(torch.cat(outs, dim=1), want, LOGITS)
    _, idx = JC.route_tokens(jnp.asarray(x), p_j["router"], 2)
    C = min(1 * 2, 2 * 2 * (16 // (Ns * Ne)))
    want_drop = _jax_counting_sort_drops(np.asarray(idx), Ns * Ne, C, 4)
    got_drop = int(TE.dropped_assignments(
        xt, tp["layers"]["moe"]["router"][0], tcfg, Ns * Ne, 1))
    assert got_drop == want_drop > 0


def test_seq_expert_replicas_place_each_shard_on_its_devices():
    """replicate_params on seq 2 x expert 2 x tensor 2: seq shard i's
    expert part e holds its tensor parts on the devices at coordinates
    (seq i, expert e); on one device every part is a view of the tree
    (0 bytes placed)."""
    jcfg, tcfg = cfgs("mixtral", **MOE)
    _, tp = trees("mixtral", **MOE)
    names = [f"cpu:{i}" for i in range(8)]
    named = make_mesh(tconfig.MeshConfig(seq=2, expert=2, tensor=2), names)
    # mesh order (data, stage, expert, seq, tensor)
    assert named.expert_devices(seq_index=1, tensor_index=1) == \
        [torch.device("cpu:3"), torch.device("cpu:7")]
    assert named.seq_mesh(1).devices.reshape(-1).tolist() == \
        [torch.device(f"cpu:{i}") for i in (2, 3, 6, 7)]
    _, tmesh = meshes(seq=2, expert=2, tensor=2)
    tree = TP.shard_params(tp, tcfg, tmesh)
    reps = TS.replicate_params(tree, tmesh)
    assert reps.trees[0][0] is reps.trees[0][1]   # one card: one tree
    wg = reps.trees[0][1]["layers"]["moe"]["w_gate"]
    assert wg.axis == "expert" and [p.axis for p in wg.parts] == \
        ["tensor", "tensor"]
    assert _views_of(reps.trees[0][1], tp) == 0


def test_generate_long_seq_expert_matches_jax():
    """engine.generate_long on seq 2 x expert 2 (an 11-token prompt
    padded to 12: the seq body's 6-token chunks take the a2a path over
    the expert shards, the decode steps the einsum path): JAX's tokens,
    and the unmeshed run's."""
    kw = dict(dtype="float32", param_dtype="float32", num_heads=8,
              num_kv_heads=8, head_dim=8, moe_capacity_factor=4.0, **MOE)
    jcfg, tcfg = jconfig.tiny("mixtral", **kw), tconfig.tiny("mixtral", **kw)
    jp = JC.Model(jcfg).init(jax.random.PRNGKey(5))
    from butterfly_tpu_torch.models.bridge import params_from_numpy
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jmesh, tmesh = meshes(seq=2, expert=2)
    prompt = list(range(1, 12))
    want = JEngine(JC.Model(jcfg), jp, mesh=jmesh).generate_long(
        prompt, JSP(max_new_tokens=6))
    got = InferenceEngine(TC.Model(tcfg, device="cpu"), tp,
                          mesh=tmesh).generate_long(
        prompt, SamplingParams(max_new_tokens=6))
    assert np.array_equal(got.tokens, want.tokens)
    plain = InferenceEngine(TC.Model(tcfg, device="cpu"), tp).generate(
        [prompt], SamplingParams(max_new_tokens=6))
    assert np.array_equal(got.tokens, plain.tokens)


# -- the serving lane on seq x expert ------------------------------------------

LANE = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=8,
            num_kv_heads=2, head_dim=8, intermediate_size=128,
            max_seq_len=256, dtype="float32", param_dtype="float32",
            moe_capacity_factor=4.0, **MOE)
LONG = [int(t) for t in (np.arange(100) * 7 + 3) % 256]
SHORT = [int(t) for t in (np.arange(12) * 5 + 1) % 256]
_MODELS = {}


def lane_models():
    """(JAX model, JAX tree, port model, port tree) of a tiny Mixtral
    with the lane test's shape (tests/test_torch_combined.py:LCFG)."""
    if "lane" not in _MODELS:
        from butterfly_tpu_torch.models.bridge import params_from_numpy
        jm = JC.Model(jconfig.tiny("mixtral", **LANE))
        jp = jm.init(jax.random.PRNGKey(0))
        _MODELS["lane"] = (jm, jp, TC.Model(tconfig.tiny("mixtral", **LANE),
                                            device="cpu"),
                           params_from_numpy(jax.tree.map(np.asarray, jp),
                                             device="cpu"))
    return _MODELS["lane"]


def test_scheduler_lane_seq_expert_matches_jax(monkeypatch):
    """The scheduler's long-prompt lane on seq 2 x expert 2: a long
    prompt through sp_chunk_body (each seq shard's MoE on its expert
    shards, the a2a path on its chunk) beside a short one through the
    paged programs, token for token JAX's, and the lane's token count
    equal."""
    jm, jp, tm, tp = lane_models()
    jmesh, tmesh = meshes(seq=2, expert=2)
    rt = dict(max_batch_size=2, page_size=16, max_seq_len=160,
              prefill_chunk=16, seq_parallel_threshold=64)
    js = JScheduler(JServing(jm, jp, jconfig.RuntimeConfig(**rt),
                             mesh=jmesh), seed=0)
    ts = Scheduler(ServingEngine(tm, tp, tconfig.RuntimeConfig(**rt),
                                 mesh=tmesh), seed=0)
    calls = _paths(monkeypatch)
    outs = []
    for s in (js, ts):
        r = s.submit(list(LONG), max_new_tokens=8, temperature=0.0)
        q = s.submit(list(SHORT), max_new_tokens=8, temperature=0.0)
        s.run_until_done()
        outs.append((r.output, q.output))
    assert outs[0] == outs[1]
    assert ts._c_sp_tokens.value == js._c_sp_tokens.value == len(LONG)
    # the lane's 32-token chunks: 16 per seq shard, a2a over 2 experts
    # inside the shard's own mesh; decode steps einsum on the whole mesh
    assert ("a2a", (1, 16, 64), 1) in calls
    assert ("einsum", (2, 1, 64), 2) in calls


# -- stage x expert ----------------------------------------------------------------

def pp_cfgs(num_layers=4, **kw):
    return cfgs("mixtral", num_layers=num_layers,
                **{**MOE, "moe_capacity_factor": 4.0, **kw})


def pp_trees(seed=0, num_layers=4, **kw):
    return trees("mixtral", seed=seed, num_layers=num_layers,
                 **{**MOE, "moe_capacity_factor": 4.0, **kw})


PIPE = [(STAGE_EXPERT[0], 2, 4.0), (STAGE_EXPERT[1], 2, 4.0),
        (STAGE_EXPERT[1], 1, 0.5)]


@pytest.mark.parametrize("axes,mb,cf", PIPE, ids=[
    "stage2-expert2", "stage2-expert2-data2",
    "stage2-expert2-data2-m1-dropping"])
def test_pipeline_forward_stage_expert_matches_jax(monkeypatch, axes, mb,
                                                   cf):
    """pipeline_forward on stage x expert: each stage's MoE, with the
    stage's own mesh active, takes the a2a path on its prefill
    microbatch, as the JAX stage body does; logits and cache against the
    JAX pipeline's. With one microbatch over both data groups at a
    dropping capacity, the groups' a2a pools the microbatch's budget (one
    GroupRun), else other assignments would drop."""
    from butterfly_tpu.parallel import pipeline as JPP
    from butterfly_tpu_torch.parallel import pipeline as TPP
    jcfg, tcfg = pp_cfgs(moe_capacity_factor=cf)
    jp, tp = pp_trees(moe_capacity_factor=cf)
    jmesh, tmesh = meshes(**axes)
    toks = _tokens(0, 4, 8)
    jsp = JP.shard_params(jp, jcfg, jmesh)
    jcache = JP.shard_cache(JC.init_cache(jcfg, batch=4, max_seq=32), jcfg,
                            jmesh)
    with jax.set_mesh(jmesh):
        want, wcache = jax.jit(lambda p, t, c: JPP.pipeline_forward(
            p, jcfg, t, c, jmesh, num_microbatches=mb))(
                jsp, jnp.asarray(toks), jcache)
    calls = _paths(monkeypatch)
    sp = TP.shard_params(tp, tcfg, tmesh)
    cache = TP.shard_cache(TC.init_cache(tcfg, 4, 32, device="cpu"), tcfg,
                           tmesh)
    with mesh_ctx(tmesh):
        got, cache = TPP.pipeline_forward(sp, tcfg, torch.as_tensor(toks),
                                          cache, tmesh, num_microbatches=mb)
    _close(got, want, LOGITS)
    # microbatch m is rows [2m, 2m + 2) at M 2: one data group's under
    # data 2; at M 1 each data group runs its 2 rows of the 4
    assert set(calls) == {("a2a", (2, 8, 64), 1)}
    k = torch.cat([torch.cat(list(p.parts), dim=1)
                   if isinstance(p, Shards) else p for p in cache.k.parts])
    _close(k, wcache.k, CACHE)


def test_stage_expert_specs_and_views_match_jax():
    """param_specs on stage 2 x expert 2 equal JAX's (the expert leaves
    P('stage', 'expert', None, None)); the placement is a stage Shards of
    expert Shards, every part a view of the tree (0 bytes), stage s's
    experts on its own expert devices."""
    jcfg, tcfg = pp_cfgs()
    jp, tp = pp_trees()
    jmesh, tmesh = meshes(stage=2, expert=2)
    jspec = JP.param_specs(jcfg, jmesh)
    tspec = TP.param_specs(tcfg, tmesh)
    flat = jax.tree_util.tree_flatten_with_path(
        jspec, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    for path, spec in flat:
        node = tspec
        for key in path:
            node = node[key.key]
        assert tuple(spec) + (None,) * (len(node) - len(spec)) == \
            tuple(node), path
    assert tuple(jspec["layers"]["moe"]["w_gate"]) == \
        ("stage", "expert", None, None)
    sp = TP.shard_params(tp, tcfg, tmesh)
    wg = sp["layers"]["moe"]["w_gate"]
    assert wg.axis == "stage" and [p.axis for p in wg.parts] == \
        ["expert", "expert"]
    assert [tuple(e.shape) for e in wg.parts[1].parts] == [(2, 2, 64, 128)] * 2
    assert torch.equal(wg.parts[1].parts[1], tp["layers"]["moe"]["w_gate"][
        2:4, 2:4])
    assert _views_of(sp, tp) == 0
    names = [f"cpu:{i}" for i in range(4)]
    named = make_mesh(tconfig.MeshConfig(stage=2, expert=2), names)
    assert named.stage_mesh(1).expert_devices() == \
        [torch.device("cpu:2"), torch.device("cpu:3")]
    assert named.expert_devices(stage_index=1) == \
        named.stage_mesh(1).expert_devices()


def _jax_generate(jcfg, jp, prompts, n, mesh=None, **kw):
    return JEngine(JC.Model(jcfg), jp, mesh=mesh, **kw).generate(
        prompts, JSP(max_new_tokens=n)).tokens


PROMPTS = [[1, 2, 3, 4], [4, 5, 6, 7], [6, 7, 8, 9], [2, 3, 5, 7]]


@pytest.mark.parametrize("axes", STAGE_EXPERT, ids=_ids(STAGE_EXPERT))
def test_generate_stage_expert_matches_jax(axes):
    """InferenceEngine.generate on stage x expert, GPipe (M 2) and the
    interleaved schedule (V 2): the JAX engine's tokens on the same
    mesh, and its unmeshed ones."""
    jcfg, tcfg = pp_cfgs()
    jp, tp = pp_trees(seed=3)
    jmesh, tmesh = meshes(**axes)
    want = _jax_generate(jcfg, jp, PROMPTS, 5, jmesh, num_microbatches=2)
    assert np.array_equal(want, _jax_generate(jcfg, jp, PROMPTS, 5))
    for V in (1, 2):
        eng = InferenceEngine(TC.Model(tcfg, device="cpu"), tp, mesh=tmesh,
                              num_microbatches=2, virtual_stages=V)
        got = eng.generate(PROMPTS, SamplingParams(max_new_tokens=5))
        np.testing.assert_array_equal(got.tokens, want)
        assert _views_of(eng.params["layers"], tp["layers"]) == 0


SERVE = dict(num_heads=8, num_kv_heads=4, head_dim=8, dtype="float32",
             param_dtype="float32", num_layers=2, moe_capacity_factor=4.0,
             **MOE)
SPROMPTS = [[5, 7, 11], [3, 1], [2, 4, 6, 8], [9]]


def _sched_rt(mod, **kw):
    return mod.RuntimeConfig(**{**dict(max_batch_size=4, max_seq_len=64,
                                       page_size=8), **kw})


@pytest.mark.parametrize("axes", STAGE_EXPERT, ids=_ids(STAGE_EXPERT))
def test_scheduler_stage_expert_matches_jax(axes):
    """Paged serving through the Scheduler on stage x expert: every
    program through the GPipe schedule, each stage's paged attention and
    MoE over its own mesh; JAX's tokens on the same mesh."""
    jcfg, tcfg = jconfig.tiny("mixtral", **SERVE), \
        tconfig.tiny("mixtral", **SERVE)
    from butterfly_tpu_torch.models.bridge import params_from_numpy
    jp = JC.Model(jcfg).init(jax.random.PRNGKey(42))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jmesh, tmesh = meshes(**axes)
    js = JScheduler(JServing(JC.Model(jcfg), jp, _sched_rt(jconfig),
                             mesh=jmesh))
    ts = Scheduler(ServingEngine(TC.Model(tcfg, device="cpu"), tp,
                                 _sched_rt(tconfig), mesh=tmesh))
    outs = []
    for s in (js, ts):
        reqs = [s.submit(p, max_new_tokens=6) for p in SPROMPTS]
        s.run_until_done()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert not ts.engine.supports_seq_parallel


# -- stage x seq ---------------------------------------------------------------------

DENSE = dict(vocab_size=256, hidden_size=64, num_heads=8, num_kv_heads=4,
             head_dim=8, intermediate_size=128, dtype="float32",
             param_dtype="float32", num_layers=4)


@pytest.mark.parametrize("axes", STAGE_SEQ, ids=_ids(STAGE_SEQ))
def test_generate_stage_seq_matches_jax(axes):
    """InferenceEngine.generate on stage x seq: the seq axis is a
    replica (no ring inside a stage), the placement views of the tree;
    JAX's tokens on the same mesh and its unmeshed ones. generate_long
    raises the JAX engine's NotImplementedError, word for word."""
    jcfg, tcfg = jconfig.tiny("llama", **DENSE), tconfig.tiny("llama",
                                                               **DENSE)
    from butterfly_tpu_torch.models.bridge import params_from_numpy
    jp = JC.Model(jcfg).init(jax.random.PRNGKey(7))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jmesh, tmesh = meshes(**axes)
    jeng = JEngine(JC.Model(jcfg), jp, mesh=jmesh)
    want = jeng.generate(PROMPTS, JSP(max_new_tokens=5)).tokens
    assert np.array_equal(want, _jax_generate(jcfg, jp, PROMPTS, 5))
    eng = InferenceEngine(TC.Model(tcfg, device="cpu"), tp, mesh=tmesh)
    assert eng._replicas is None
    assert _views_of(eng.params["layers"], tp["layers"]) == 0
    for fused in (True, False):
        got = eng.generate(PROMPTS, SamplingParams(max_new_tokens=5),
                           fused=fused)
        np.testing.assert_array_equal(got.tokens, want)
    with pytest.raises(NotImplementedError) as jerr:
        jeng.generate_long([1, 2, 3, 4])
    with pytest.raises(NotImplementedError) as terr:
        eng.generate_long([1, 2, 3, 4])
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("axes", STAGE_SEQ, ids=_ids(STAGE_SEQ))
def test_scheduler_stage_seq_matches_jax(axes):
    """Serving on stage x seq with a seq-parallel threshold: both
    schedulers warn that the lane is off (it runs the whole layer stack
    on every seq shard) and serve on; JAX's tokens, the long prompt
    through the paged programs (no lane tokens)."""
    jcfg, tcfg = jconfig.tiny("llama", **DENSE), tconfig.tiny("llama",
                                                               **DENSE)
    from butterfly_tpu_torch.models.bridge import params_from_numpy
    jp = JC.Model(jcfg).init(jax.random.PRNGKey(42))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jmesh, tmesh = meshes(**axes)
    kw = dict(seq_parallel_threshold=16, max_seq_len=96)
    outs, msgs = [], []
    for sched, eng, rt in ((JScheduler, JServing, _sched_rt(jconfig, **kw)),
                           (Scheduler, ServingEngine,
                            _sched_rt(tconfig, **kw))):
        model = JC.Model(jcfg) if eng is JServing else \
            TC.Model(tcfg, device="cpu")
        with pytest.warns(RuntimeWarning, match="stage == 1") as rec:
            s = sched(eng(model, jp if eng is JServing else tp, rt,
                          mesh=jmesh if eng is JServing else tmesh))
        msgs.append(str(rec[0].message))
        reqs = [s.submit(p, max_new_tokens=6)
                for p in SPROMPTS + [list(range(3, 40))]]
        s.run_until_done()
        outs.append([r.output for r in reqs])
        assert s._c_sp_tokens.value == 0
    assert outs[0] == outs[1] and msgs[0] == msgs[1]
    assert _views_of(s.engine.params["layers"], tp["layers"]) == 0


# -- the CLI ----------------------------------------------------------------

def _cli(capsys, *argv):
    from butterfly_tpu_torch.serve import cli
    rc = cli.main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


PAIRS = [["--seq-parallel", "2", "--expert-parallel", "2"],
         ["--stage-parallel", "2", "--expert-parallel", "2"],
         ["--stage-parallel", "2", "--seq-parallel", "2"]]


@pytest.mark.parametrize("flags", PAIRS, ids=["seq-expert", "stage-expert",
                                              "stage-seq"])
def test_cli_flag_pairs_print_the_unmeshed_text(capsys, flags):
    """`butterfly generate` and `serve` on the CPU with each new flag
    pair give the text of the run without a mesh (seq with expert
    through generate_long); `generate --stage-parallel 2 --seq-parallel
    2` raises the engine's NotImplementedError, as the JAX CLI does,
    and `serve` runs with its long-prompt lane off."""
    import warnings

    from butterfly_tpu_torch.serve import cli
    from butterfly_tpu_torch.serve.server import build_serving
    base = ["generate", "--model", "tiny", "--device", "cpu", "--prompt",
            "hello", "--max-new", "6"]
    rc0, want, _ = _cli(capsys, *base)
    assert rc0 == 0
    if "--stage-parallel" in flags and "--seq-parallel" in flags:
        with pytest.raises(NotImplementedError,
                           match="does not compose with pipeline stages"):
            cli.main(base + flags)
    else:
        rc1, got, err = _cli(capsys, *base, *flags)
        assert rc1 == 0 and got == want
        assert ("sequence parallelism" in err) == ("--seq-parallel" in flags)
    texts = []
    for extra in ([], flags):
        args = cli.build_parser().parse_args(
            ["serve", "--model", "tiny", "--device", "cpu", "--max-seq",
             "128", "--port", "0", "--timeseries-interval", "0"] + extra)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            sched, tok, _ = build_serving(args)
        r = sched.submit(tok.encode("hello"), max_new_tokens=6,
                         temperature=0.0)
        sched.run_until_done()
        texts.append(tok.decode(r.output))
    assert texts[0] == texts[1]
