"""PyTorch port: meshes that combine axes (seq x data, seq x tensor,
expert x data, expert x tensor, and three-axis meshes) against the JAX
package's meshed runs, float32.

The JAX side runs on the harness's 8 fake CPU devices (its shard_maps
manual over `seq` or `expert` alone, the other axes automatic inside);
the port's single-controller mesh puts every shard on `cpu`. Both run
the same init_params weights (models/bridge.py) on the same numpy-seeded
inputs. Tolerances are JAX's own: logits 3e-5 and caches 2e-5, greedy
tokens identical; the serving lane's chunk logits 3e-4 (JAX's bound for
its seq-parallel chunk).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from butterfly_tpu.core import compat
from butterfly_tpu.core import config as jconfig
from butterfly_tpu.core.mesh import make_mesh as jmake_mesh
from butterfly_tpu.engine.engine import InferenceEngine as JEngine
from butterfly_tpu.engine.sampling import SamplingParams as JSP
from butterfly_tpu.engine.serving import ServingEngine as JServing
from butterfly_tpu.models import common as JC
from butterfly_tpu.parallel import expert as JE
from butterfly_tpu.parallel import partition as JP
from butterfly_tpu.parallel import sequence as JS
from butterfly_tpu.sched.scheduler import Scheduler as JScheduler
from butterfly_tpu_torch.cache.paged import (init_paged_cache,
                                             pool_replicas)
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.core.mesh import make_mesh, mesh_ctx
from butterfly_tpu_torch.engine.engine import InferenceEngine
from butterfly_tpu_torch.engine.sampling import SamplingParams
from butterfly_tpu_torch.engine.serving import ServingEngine
from butterfly_tpu_torch.models import common as TC
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.obs.health import all_hosts_probe
from butterfly_tpu_torch.parallel import expert as TE
from butterfly_tpu_torch.parallel import partition as TP
from butterfly_tpu_torch.parallel import sequence as TS
from butterfly_tpu_torch.parallel.partition import Shards
from butterfly_tpu_torch.parallel.tensor import data_groups, run_groups
from butterfly_tpu_torch.sched.scheduler import Scheduler
from butterfly_tpu_torch.serve import cli

torch.set_num_threads(1)

LOGITS, CACHE, LANE = 3e-5, 2e-5, 3e-4
SHAPE = dict(vocab_size=256, hidden_size=64, num_heads=8, num_kv_heads=8,
             head_dim=8, intermediate_size=128, dtype="float32",
             param_dtype="float32")
_TREES = {}


def cfgs(arch="llama", **kw):
    """(JAX config, port config) of the JAX tests' shape."""
    return (jconfig.tiny(arch, **{**SHAPE, **kw}),
            tconfig.tiny(arch, **{**SHAPE, **kw}))


def trees(arch="llama", seed=0, **kw):
    """(JAX tree, bridged port tree): one init."""
    key = (arch, seed, tuple(sorted(kw.items())))
    if key not in _TREES:
        jp = JC.Model(cfgs(arch, **kw)[0]).init(jax.random.PRNGKey(seed))
        _TREES[key] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             device="cpu"))
    return _TREES[key]


def meshes(**axes):
    """(JAX mesh over the fake CPU devices, port mesh over `cpu`)."""
    n = int(np.prod(list(axes.values())))
    return (jmake_mesh(jconfig.MeshConfig(**axes), jax.devices()[:n]),
            make_mesh(tconfig.MeshConfig(**axes), ["cpu"] * n))


def _tokens(seed, B, T, V=256):
    return np.random.RandomState(seed).randint(0, V, (B, T))


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


def _jax_sp_forward(jp, jcfg, toks, jmesh, impl="ring", kvq="none"):
    with compat.mesh_ctx(jmesh):
        return jax.jit(lambda p, t: JS.sp_forward(
            p, jcfg, t, jmesh, impl=impl, kv_quant=kvq))(jp, jnp.asarray(toks))


# -- seq x data ------------------------------------------------------------------

SP = [("ring", "llama", None), ("ulysses", "llama", None),
      ("ring", "mixtral", "dense"), ("ring", "mixtral", "ep")]


@pytest.mark.parametrize("impl,arch,moe_impl", SP,
                         ids=[f"{a}-{i}-{m}" for i, a, m in SP])
def test_sp_forward_seq_data_matches_jax(impl, arch, moe_impl):
    """test_sequence.py:106's cases on seq = 4 x data = 2: each data
    group runs its own ring; logits and the cache against JAX's."""
    kw = dict(moe_impl=moe_impl, moe_capacity_factor=4.0) if moe_impl \
        else {}
    jcfg, tcfg = cfgs(arch, **kw)
    jp, tp = trees(arch, **kw)
    jmesh, tmesh = meshes(seq=4, data=2)
    toks = _tokens(0, 2, 24)
    want, wcache = _jax_sp_forward(jp, jcfg, toks, jmesh, impl)
    logits, cache = TS.sp_forward(tp, tcfg, torch.as_tensor(toks), tmesh,
                                  impl=impl)
    assert isinstance(cache.k[0], Shards) and cache.k[0].axis == "data"
    _close(TS.gather_shards(logits), want, LOGITS)
    whole = cache.gather()
    _close(whole.k, wcache.k, CACHE)
    _close(whole.v, wcache.v, CACHE)
    assert np.array_equal(_np(whole.length), np.asarray(wcache.length))


def test_sp_forward_seq_data_divisibility():
    jcfg, tcfg = cfgs()
    jp, tp = trees()
    jmesh, tmesh = meshes(seq=4, data=2)
    with pytest.raises(ValueError, match="not divisible"):
        JS.sp_forward(jp, jcfg, jnp.zeros((2, 10), jnp.int32), jmesh)
    with pytest.raises(ValueError, match="not divisible"):
        TS.sp_forward(tp, tcfg, torch.zeros((2, 10), dtype=torch.long),
                      tmesh)


def _decode_run(sp_forward, sp_decode, init_cache, toks, n_new, as_t):
    """Greedy decode over a seq-parallel prefill: (tokens, last logits,
    suffix length)."""
    B, T = toks.shape
    logits, prefix = sp_forward(as_t(toks))
    nxt = logits
    out = []
    suffix = init_cache(B, n_new)
    for i in range(n_new):
        nxt = np.argmax(nxt, axis=-1)[:, None]
        out.append(nxt[:, 0])
        last, suffix = sp_decode(as_t(nxt), as_t(np.full((B, 1), T + i,
                                                          np.int32)),
                                 prefix, suffix)
        nxt = _np(last)
    return np.stack(out), nxt, _np(suffix.length)


DECODE = [("llama", 8, "seq=4,data=2"), ("llama", 2, "seq=4,data=2"),
          ("gpt2", 8, "seq=4,data=2"), ("llama", 8, "seq=2,tensor=4"),
          ("llama", 2, "seq=2,tensor=4"),
          ("llama", 2, "seq=2,tensor=2,data=2")]


@pytest.mark.parametrize("arch,kv,axes", DECODE,
                         ids=[f"{a}-kv{k}-{m}" for a, k, m in DECODE])
def test_sp_decode_matches_jax(arch, kv, axes):
    """test_sequence.py:174 on combined meshes: sp_forward then greedy
    sp_decode_step over the still-sharded prefix, tokens identical and
    the last logits within 3e-5 of JAX's."""
    axes = {k: int(v) for k, v in (a.split("=") for a in axes.split(","))}
    jcfg, tcfg = cfgs(arch, num_kv_heads=kv)
    jp, tp = trees(arch, seed=2, num_kv_heads=kv)
    jmesh, tmesh = meshes(**axes)
    toks = _tokens(2, 2, 24)
    n_new = 5

    def jfwd(t):
        lg, pre = _jax_sp_forward(jp, jcfg, t, jmesh)
        return np.asarray(lg)[:, -1, :], pre
    jstep = jax.jit(lambda p, t, pos, pre, suf: JS.sp_decode_step(
        p, jcfg, t, pos, pre, suf, jmesh))
    with compat.mesh_ctx(jmesh):
        want = _decode_run(
            jfwd, lambda t, pos, pre, suf: jstep(jp, t, pos, pre, suf),
            lambda B, n: JC.init_cache(jcfg, batch=B, max_seq=n), toks,
            n_new, jnp.asarray)
    tree = TP.shard_params(tp, tcfg, tmesh)
    reps = TS.replicate_params(tree, tmesh)

    def tfwd(t):
        lg, pre = TS.sp_forward(reps, tcfg, t, tmesh)
        return _np(lg[-1])[:, -1, :], pre
    got = _decode_run(
        tfwd, lambda t, pos, pre, suf: TS.sp_decode_step(
            reps, tcfg, t, pos, pre, suf, tmesh),
        lambda B, n: TC.init_cache(tcfg, B, n, device="cpu", mesh=tmesh),
        toks, n_new, torch.as_tensor)
    assert np.array_equal(got[0], want[0])
    _close(got[1], want[1], LOGITS)
    assert np.array_equal(got[2], want[2])


@pytest.mark.parametrize("axes", [dict(seq=4, data=2), dict(seq=2, tensor=4)],
                         ids=["seq4-data2", "seq2-tensor4"])
def test_generate_long_matches_jax(axes):
    """test_sequence.py:224: engine.generate_long over the combined mesh
    (an 11-token prompt padded to the seq size) equals JAX's tokens."""
    cfg = dict(dtype="float32", param_dtype="float32", num_heads=8,
               num_kv_heads=8, head_dim=8)
    jcfg, tcfg = jconfig.tiny("llama", **cfg), tconfig.tiny("llama", **cfg)
    jp = JC.Model(jcfg).init(jax.random.PRNGKey(5))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jmesh, tmesh = meshes(**axes)
    prompt = list(range(1, 12))
    want = JEngine(JC.Model(jcfg), jp, mesh=jmesh).generate_long(
        prompt, JSP(max_new_tokens=6))
    got = InferenceEngine(TC.Model(tcfg, device="cpu"), tp,
                          mesh=tmesh).generate_long(
        prompt, SamplingParams(max_new_tokens=6))
    assert np.array_equal(got.tokens, want.tokens)


# -- the serving lane under seq x data -----------------------------------------

LCFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=8,
            num_kv_heads=2, head_dim=8, intermediate_size=128,
            max_seq_len=256, dtype="float32")


def lane_models():
    """(JAX model, JAX tree, port model, port tree) of test_longctx's
    tiny model."""
    if "lane" not in _TREES:
        jm = JC.Model(jconfig.ModelConfig(**LCFG))
        jp = jm.init(jax.random.PRNGKey(0))
        _TREES["lane"] = (jm, jp, TC.Model(tconfig.ModelConfig(**LCFG),
                                           device="cpu"),
                          params_from_numpy(jax.tree.map(np.asarray, jp),
                                            device="cpu"))
    return _TREES["lane"]


def test_sp_chunk_int8_seq_data_matches_jax():
    """test_longctx.py:150 on seq = 4 x data = 2: a 40-token prompt in
    two int8 chunks on slot 1 (data group 1's ring), logits chunk by
    chunk against JAX's; the port's pool replicated per data group (one
    copy each) holds the lane's pages in every replica, bytes equal."""
    jm, jp, tm, tp = lane_models()
    jmesh, tmesh = meshes(seq=4, data=2)
    rt = dict(max_batch_size=2, page_size=16, max_seq_len=128,
              kv_quant="int8")
    je = JServing(jm, jp, runtime=jconfig.RuntimeConfig(**rt), mesh=jmesh)
    te = ServingEngine(tm, tp, runtime=tconfig.RuntimeConfig(**rt),
                       mesh=tmesh)
    te.cache = TP.shard_paged_cache(
        init_paged_cache(tm.cfg, te.runtime, device="cpu"), tm.cfg, tmesh,
        copy=True)
    assert len(pool_replicas(te.cache)) == 2
    prompt = [int(t) for t in (np.arange(40) * 11 + 5) % 256]
    pages = [3, 0, 5]
    je.set_table_row(1, pages)
    te.set_table_row(1, pages)
    for lo, hi in ((0, 24), (24, 40)):
        want = je.sp_prefill_chunk(1, prompt[lo:hi], lo)
        got = te.sp_prefill_chunk(1, prompt[lo:hi], lo)
        _close(got, np.asarray(want), LANE)
    a, b = pool_replicas(te.cache)
    for name in ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    jc = jax.device_get(je.cache)
    d = np.abs(_np(a.k_pages)[:, pages].astype(np.int32)
               - np.asarray(jc.k_pages)[:, pages].astype(np.int32))
    assert d.max() <= 1


LONG = [int(t) for t in (np.arange(100) * 7 + 3) % 256]
SHORT = [int(t) for t in (np.arange(12) * 5 + 1) % 256]


@pytest.mark.parametrize("mode,kvq", [
    ("alternating", "none"), ("alternating", "int8"), ("mixed", "none"),
], ids=["alt-float", "alt-int8", "mixed-float"])
def test_scheduler_lane_seq_data_matches_jax(mode, kvq):
    """test_longctx.py:177 on seq = 4 x data = 2: a long prompt through
    the lane beside a short one, token for token JAX's, and the lane's
    long-prefill token count equal."""
    jm, jp, tm, tp = lane_models()
    jmesh, tmesh = meshes(seq=4, data=2)
    rt = dict(max_batch_size=2, page_size=16, max_seq_len=160, kv_quant=kvq,
              prefill_chunk=16, seq_parallel_threshold=64,
              mixed_dispatch=(mode == "mixed"))
    js = JScheduler(JServing(jm, jp, jconfig.RuntimeConfig(**rt),
                             mesh=jmesh), seed=0)
    ts = Scheduler(ServingEngine(tm, tp, tconfig.RuntimeConfig(**rt),
                                 mesh=tmesh), seed=0)
    outs = []
    for s in (js, ts):
        r = s.submit(list(LONG), max_new_tokens=8, temperature=0.0)
        q = s.submit(list(SHORT), max_new_tokens=8, temperature=0.0)
        s.run_until_done()
        outs.append((r.output, q.output))
    assert outs[0] == outs[1]
    assert ts._c_sp_tokens.value == js._c_sp_tokens.value == len(LONG)


def test_prefix_hit_after_long_prefill_on_seq_data():
    """test_longctx.py:204: the lane's K/V lands in the paged pool like
    any prefill, so the long prompt resubmitted hits the prefix registry
    and decodes the same tokens, as JAX's does (seq = 4 x data = 2)."""
    jm, jp, tm, tp = lane_models()
    jmesh, tmesh = meshes(seq=4, data=2)
    rt = dict(max_batch_size=2, page_size=16, max_seq_len=160,
              prefill_chunk=16, seq_parallel_threshold=64,
              prefix_caching=True)
    js = JScheduler(JServing(jm, jp, jconfig.RuntimeConfig(**rt),
                             mesh=jmesh), seed=0)
    ts = Scheduler(ServingEngine(tm, tp, tconfig.RuntimeConfig(**rt),
                                 mesh=tmesh), seed=0)
    runs = []
    for s in (js, ts):
        a = s.submit(list(LONG), max_new_tokens=4, temperature=0.0)
        s.run_until_done()
        b = s.submit(list(LONG), max_new_tokens=4, temperature=0.0)
        s.run_until_done()
        assert b.cached_at_admit > 0 and a.output == b.output
        runs.append((a.output, b.cached_at_admit))
    assert ts._c_sp_tokens.value > 0
    assert runs[0] == runs[1]


# -- seq x tensor ----------------------------------------------------------------

@pytest.mark.parametrize("nq,kv,tensor", [(8, 8, 4), (8, 2, 4), (12, 4, 3)],
                         ids=["kv8", "kv2-replicated", "nq12-kv4-tensor3"])
def test_sp_forward_seq_tp_compose(nq, kv, tensor):
    """test_sequence.py:143 (seq = 2 x tensor = 4): each seq shard's
    projections split over the heads, the ring per tensor shard; at
    Kv 2 < tensor 4 the K/V stay replicated (wk/wv unsplit), and at 12
    heads over tensor = 3 with Kv 4 a shard's q heads span two kv
    heads."""
    jcfg, tcfg = cfgs(num_heads=nq, num_kv_heads=kv)
    jp, tp = trees(seed=1, num_heads=nq, num_kv_heads=kv)
    jmesh, tmesh = meshes(seq=2, tensor=tensor)
    toks = _tokens(1, 2, 16)
    want, wcache = _jax_sp_forward(JP.shard_params(jp, jcfg, jmesh), jcfg,
                                   toks, jmesh)
    tree = TP.shard_params(tp, tcfg, tmesh)
    assert isinstance(tree["layers"]["attn"]["wq"], Shards)
    assert isinstance(tree["layers"]["attn"]["wk"], Shards) == \
        (kv % tensor == 0)
    logits, cache = TS.sp_forward(tree, tcfg, torch.as_tensor(toks), tmesh)
    _close(TS.gather_shards(logits), want, LOGITS)
    _close(cache.gather().k, wcache.k, CACHE)


def test_ulysses_under_tensor_as_jax_runs_it():
    """JAX's sp_forward(impl="ulysses") on seq = 2 x tensor = 4: the port
    gives what JAX gives, or raises what JAX raises."""
    jcfg, tcfg = cfgs()
    jp, tp = trees(seed=1)
    jmesh, tmesh = meshes(seq=2, tensor=4)
    toks = _tokens(1, 2, 16)
    try:
        want, _ = _jax_sp_forward(JP.shard_params(jp, jcfg, jmesh), jcfg,
                                  toks, jmesh, impl="ulysses")
    except Exception as e:   # noqa: BLE001 - the port must raise alike
        with pytest.raises(type(e)):
            TS.sp_forward(TP.shard_params(tp, tcfg, tmesh), tcfg,
                          torch.as_tensor(toks), tmesh, impl="ulysses")
        return
    logits, _ = TS.sp_forward(TP.shard_params(tp, tcfg, tmesh), tcfg,
                              torch.as_tensor(toks), tmesh, impl="ulysses")
    _close(TS.gather_shards(logits), want, LOGITS)


# -- expert x data ----------------------------------------------------------------

def _jax_forward(jcfg, jp, toks, jmesh):
    """The JAX forward over a fresh cache, params, cache and tokens
    sharded over `jmesh` (test_expert.py:65)."""
    sp = JP.shard_params(jp, jcfg, jmesh)
    cache = JP.shard_cache(JC.init_cache(jcfg, batch=toks.shape[0],
                                         max_seq=32), jcfg, jmesh)
    t = jax.device_put(jnp.asarray(toks),
                       NamedSharding(jmesh, P("data", None)))
    with jax.set_mesh(jmesh):
        out, _ = jax.jit(lambda p, t, c: JC.forward(p, jcfg, t, c))(sp, t,
                                                                     cache)
    return np.asarray(out)


def _port_forward(tcfg, tp, toks, tmesh):
    tree = TP.shard_params(tp, tcfg, tmesh)
    with mesh_ctx(tmesh):
        cache = TC.init_cache(tcfg, toks.shape[0], 32, device="cpu",
                              mesh=tmesh)
        out, _ = TC.forward(tree, tcfg, torch.as_tensor(toks), cache)
    return out, tree


EPF = [(dict(data=2, expert=4), 4.0), (dict(data=2, expert=4), 0.5),
       (dict(expert=2, tensor=4), 4.0),
       (dict(expert=2, tensor=2, data=2), 4.0)]


@pytest.mark.parametrize("axes,cf", EPF, ids=[
    "data2-expert4", "data2-expert4-dropping", "expert2-tensor4",
    "expert2-tensor2-data2"])
def test_ep_forward_on_combined_mesh_matches_jax(axes, cf):
    """test_expert.py:65 (data = 2 x expert = 4), at JAX's no-drop
    capacity and at a dropping one (each data group's a2a continues the
    whole batch's counting sort at the whole batch's capacity), and on
    expert x tensor meshes: logits against JAX's meshed forward."""
    jcfg, tcfg = cfgs("mixtral", moe_impl="ep", moe_capacity_factor=cf)
    jp, tp = trees("mixtral", moe_impl="ep", moe_capacity_factor=cf)
    jmesh, tmesh = meshes(**axes)
    toks = _tokens(0, 4, 8)
    want = _jax_forward(jcfg, jp, toks, jmesh)
    got, tree = _port_forward(tcfg, tp, toks, tmesh)
    _close(got, want, LOGITS)
    w = tree["layers"]["moe"]["w_gate"]
    w = w.parts[0] if axes.get("data", 1) > 1 and w.axis == "data" else w
    assert w.axis == "expert"
    assert isinstance(w.parts[0], Shards) == ("tensor" in axes)


def test_ep_a2a_dropped_assignments_match_jax_under_data():
    """One MoE block at capacity 1 over data = 2 x expert = 4: run as the
    port's forwards run it, one data group after the other, it equals
    JAX's whole-batch a2a, and the dropped count equals the count of
    JAX's counting sort over the whole batch (a per-group capacity
    would drop others)."""
    jcfg, tcfg = cfgs("mixtral")
    jp, tp = trees("mixtral")
    jmesh, tmesh = meshes(data=2, expert=4)
    x = np.random.default_rng(3).standard_normal((4, 8, 64)).astype(
        np.float32)
    p_j = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    with jax.set_mesh(jmesh):
        xs = jax.device_put(jnp.asarray(x),
                            NamedSharding(jmesh, P("data", None, None)))
        want = np.asarray(jax.jit(lambda x, p: JE.moe_block_ep(
            x, p, jcfg, 1))(xs, p_j))
    tree = TP.shard_params(tp, tcfg, tmesh)
    p_t = {k: v[0] for k, v in tree["layers"]["moe"].items()}
    xt = torch.from_numpy(x)
    with mesh_ctx(tmesh):
        groups = data_groups(4)
        outs = run_groups(groups, lambda g: TE.moe_block_ep(
            xt[g.rows], p_t, tcfg, 1), 4)
    _close(torch.cat(outs), want, LOGITS)
    # JAX's counting sort over the whole batch, per source shard
    N, E, k = 4, 4, 2
    _, idx = JC.route_tokens(jnp.asarray(x), p_j["router"], k)
    idx = np.asarray(idx)
    C = min(1 * 4, k * 4 * 2)
    want_drop = 0
    for i in range(N):
        a = idx[:, 2 * i:2 * i + 2].reshape(-1)
        seen = np.zeros(E, int)
        for e in a:
            want_drop += seen[e] >= C
            seen[e] += 1
    got_drop = int(TE.dropped_assignments(xt, p_t["router"], tcfg, N, 1))
    assert got_drop == want_drop > 0


def test_ep_einsum_decode_step_on_data_expert_matches_jax():
    """test_expert.py:126: T = 1 takes the einsum path on data = 2 x
    expert = 4, against JAX's."""
    jcfg, tcfg = cfgs("mixtral", moe_capacity_factor=4.0)
    jp, tp = trees("mixtral", seed=5, moe_capacity_factor=4.0)
    jmesh, tmesh = meshes(data=2, expert=4)
    x = np.random.default_rng(6).standard_normal((2, 1, 64)).astype(
        np.float32)
    p_j = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    with jax.set_mesh(jmesh):
        want = np.asarray(jax.jit(lambda x, p: JE.moe_block_ep(
            x, p, jcfg))(jnp.asarray(x), p_j))
    tree = TP.shard_params(tp, tcfg, tmesh)
    p_t = {k: v[0] for k, v in tree["layers"]["moe"].items()}
    with mesh_ctx(tmesh):
        assert not TE.takes_a2a(torch.from_numpy(x), tcfg)
        got = TE.moe_block_ep(torch.from_numpy(x), p_t, tcfg)
    _close(got, want, LOGITS)


# -- expert x tensor: the specs and the placement ------------------------------------

def test_expert_tensor_specs_and_views_match_jax():
    """param_specs at expert = 2 x tensor = 4 equal JAX's (the MoE
    leaves over `expert` and F over `tensor`: partition.py:91-96), and
    the placement is views of the tree: 0 bytes allocated."""
    jcfg, tcfg = cfgs("mixtral", moe_impl="ep")
    jp, tp = trees("mixtral", moe_impl="ep")
    jmesh, tmesh = meshes(expert=2, tensor=4)
    jspec = JP.param_specs(jcfg, jmesh)
    tspec = TP.param_specs(tcfg, tmesh)
    flat_j = jax.tree_util.tree_flatten_with_path(
        jspec, is_leaf=lambda x: isinstance(x, P))[0]
    assert len(flat_j) > 10
    for path, spec in flat_j:
        node = tspec
        for key in path:
            node = node[key.key]
        assert tuple(spec) == tuple(node), path
    assert tspec["layers"]["moe"]["w_gate"] == (None, "expert", None,
                                                "tensor")
    tree = TP.shard_params(tp, tcfg, tmesh)
    ptrs = []

    def walk(s, t):
        if isinstance(s, dict):
            for k in s:
                walk(s[k], t[k])
        elif isinstance(s, Shards):
            for part in s.parts:
                walk(part, t)
        else:
            ptrs.append(s.untyped_storage().data_ptr()
                        == t.untyped_storage().data_ptr())
    walk(tree, tp)
    assert all(ptrs) and len(ptrs) > 20
    wg = tree["layers"]["moe"]["w_gate"]
    assert [tuple(p.shape) for p in wg.parts[1].parts] == [(2, 2, 64, 32)] * 4


# -- three axes ---------------------------------------------------------------

def test_sp_forward_seq_tensor_data_matches_jax():
    """seq = 2 x tensor = 2 x data = 2: each data group's ring, per
    tensor shard, against JAX's sp_forward on that mesh."""
    jcfg, tcfg = cfgs(num_kv_heads=4)
    jp, tp = trees(seed=3, num_kv_heads=4)
    jmesh, tmesh = meshes(seq=2, tensor=2, data=2)
    toks = _tokens(3, 4, 16)
    want, wcache = _jax_sp_forward(JP.shard_params(jp, jcfg, jmesh), jcfg,
                                   toks, jmesh)
    logits, cache = TS.sp_forward(TP.shard_params(tp, tcfg, tmesh), tcfg,
                                  torch.as_tensor(toks), tmesh)
    _close(TS.gather_shards(logits), want, LOGITS)
    _close(cache.gather().v, wcache.v, CACHE)


# -- the CLI --------------------------------------------------------------------

def _cli(capsys, *argv):
    rc = cli.main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("flags", [["--seq-parallel", "2",
                                    "--tensor-parallel", "2"],
                                   ["--expert-parallel", "2",
                                    "--data-parallel", "2"]],
                         ids=["seq2-tensor2", "expert2-data2"])
def test_cli_generate_and_serve_print_the_same_text(capsys, flags):
    """`butterfly generate` and `serve` on the CPU with combined flags
    give the text of the run without a mesh; so does `--expert-parallel
    2 --seq-parallel 2` (generate_long over seq x expert)."""
    from butterfly_tpu_torch.serve.server import build_serving
    base = ["generate", "--model", "tiny", "--device", "cpu", "--prompt",
            "hello", "--max-new", "6"]
    rc0, want, _ = _cli(capsys, *base)
    rc1, got, _ = _cli(capsys, *base, *flags)
    assert rc0 == rc1 == 0 and got == want
    texts = []
    for extra in ([], flags):
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
    rc2, got2, _ = _cli(capsys, *base, "--expert-parallel", "2",
                        "--seq-parallel", "2")
    assert rc2 == 0 and got2 == want


# -- the probe ---------------------------------------------------------------

def test_all_hosts_probe_in_one_process(monkeypatch):
    """tests/test_health.py:32's counterpart: the sum of one per device
    over 8 CPU shards equals 8; in a job of several processes the probe
    all-reduces that sum over the group (here the other process's 8
    devices, added by a stand-in all-reduce) and compares it with the
    global device count (tests/test_torch_distributed.py runs it across
    two real processes)."""
    assert all_hosts_probe(["cpu"] * 8)
    from butterfly_tpu_torch.core import mesh as TM
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(TM, "global_devices", lambda device: [None] * 16)
    reduced = []

    def other_process(t, *a, **kw):
        reduced.append(float(t.item()))
        t += 8
    monkeypatch.setattr(torch.distributed, "all_reduce", other_process)
    assert all_hosts_probe(["cpu"] * 8)
    assert reduced == [8.0]
