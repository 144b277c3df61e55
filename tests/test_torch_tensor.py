"""PyTorch port: tensor and data parallelism (parallel/partition.py,
parallel/tensor.py, the sharded kernel wrappers, the layer math of
models/common.py and cache/paged.py per shard) against the JAX package,
float32.

The JAX side runs on the harness's fake CPU devices (GSPMD and the
shard_map kernel wrappers in interpret mode); the port's single-
controller mesh puts every shard on `cpu`. The split axis of every leaf
must equal the JAX spec (param_specs, quant_specs_like, the cache specs),
logits agree within 2e-5 (test_partition.py's bound), and a placement
where the shards share the tree's device allocates nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butterfly_tpu.core import config as jconfig
from butterfly_tpu.core.mesh import make_mesh as jmake_mesh
from butterfly_tpu.models import common as JC
from butterfly_tpu.parallel import partition as JP
from butterfly_tpu.quant import int8 as JQ
from butterfly_tpu_torch.cache import paged as TPG
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.core.mesh import make_mesh, mesh_ctx
from butterfly_tpu_torch.models import common as TC
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.ops.flash_attention import (
    flash_attention_sharded, shardable_axes)
from butterfly_tpu_torch.ops.paged_attention import paged_attention_sharded
from butterfly_tpu_torch.parallel import partition as TP
from butterfly_tpu_torch.parallel.partition import Shards
from butterfly_tpu_torch.parallel.tensor import all_reduce, gather
from butterfly_tpu_torch.quant import int8 as TQ

torch.set_num_threads(1)

TOL = 2e-5
SHAPE = dict(vocab_size=256, hidden_size=64, num_heads=8, num_kv_heads=8,
             head_dim=8, intermediate_size=128, dtype="float32",
             param_dtype="float32")


def tp_cfg(mod, arch="llama", **kw):
    """test_partition.py's tp_cfg (dims divide tensor = 8), in either
    package's config module."""
    return mod.tiny(arch, **{**SHAPE, **kw})


def meshes(**axes):
    """(JAX mesh over the fake CPU devices, port mesh over `cpu`)."""
    n = int(np.prod(list(axes.values())))
    return (jmake_mesh(jconfig.MeshConfig(**axes), jax.devices()[:n]),
            make_mesh(tconfig.MeshConfig(**axes), ["cpu"] * n))


_TREES = {}


def trees(arch="llama", **kw):
    """(JAX tree, bridged port tree) of tp_cfg(arch, **kw)."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _TREES:
        jp = JC.Model(tp_cfg(jconfig, arch, **kw)).init(jax.random.PRNGKey(0))
        _TREES[key] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             device="cpu"))
    return _TREES[key]


def _tokens(seed, B, T, V=256):
    return np.random.RandomState(seed).randint(0, V, (B, T))


def jax_logits(cfg, params, toks, mesh=None):
    """The JAX forward over a fresh contiguous cache (test_partition.py's
    run_single; over `mesh` with the params and cache sharded)."""
    cache = JC.init_cache(cfg, batch=toks.shape[0], max_seq=32)
    if mesh is not None:
        params = JP.shard_params(params, cfg, mesh)
        cache = JP.shard_cache(cache, cfg, mesh)
        with mesh:
            out, _ = jax.jit(lambda p, t, c: JC.forward(p, cfg, t, c))(
                params, jnp.asarray(toks), cache)
        return np.asarray(out)
    out, _ = jax.jit(lambda p, t, c: JC.forward(p, cfg, t, c))(
        params, jnp.asarray(toks), cache)
    return np.asarray(out)


def port_logits(cfg, params, toks, mesh, copy=False):
    """The port's forward over `mesh` (params and cache placed over it),
    then one decode step; returns (prefill logits, step logits, cache)."""
    sp = TP.shard_params(params, cfg, mesh, copy=copy)
    with mesh_ctx(mesh):
        cache = TC.init_cache(cfg, toks.shape[0], 32, device="cpu",
                              mesh=mesh)
        out, cache = TC.forward(sp, cfg, torch.as_tensor(toks), cache)
        step, cache = TC.forward(sp, cfg, torch.as_tensor(toks[:, :1]),
                                 cache)
    return out.numpy(), step.numpy(), cache


def _spec(p):
    return tuple(p)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


# -- the specs ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama", "gpt2", "mixtral"])
def test_specs_and_placement_match_jax(arch):
    """param_specs / quant_specs_like / the cache specs equal the JAX
    package's entry for entry (no compile), on tensor = 8 and on data = 2
    x tensor = 4; every placed leaf is split exactly where its spec says,
    over the tensor shards."""
    for axes in (dict(tensor=8), dict(data=2, tensor=4)):
        jm, tm = meshes(**axes)
        jcfg, tcfg = tp_cfg(jconfig, arch), tp_cfg(tconfig, arch)
        want = dict(_flat(jax.tree.map(
            _spec, JP.param_specs(jcfg, jm),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
        got = dict(_flat(TP.param_specs(tcfg, tm)))
        assert got == want
        jp, tp = trees(arch)
        jq, tq = JQ.quantize_int8(jp, jcfg), TQ.quantize_int8(tp, tcfg)
        wq = dict(_flat(jax.tree.map(
            _spec, JQ.quant_specs_like(jq, JP.param_specs(jcfg, jm)),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
        specs = TQ.quant_specs_like(tq, TP.param_specs(tcfg, tm))
        assert dict(_flat(specs)) == wq
        for quant in (False, True):
            jc = JP.paged_cache_specs(jcfg, jm, 4, quant)
            tc = TP.paged_cache_specs(tcfg, tm, 4, quant)
            assert {k: _spec(v) if v is not None else None
                    for k, v in jc._asdict().items()} == tc
            jc = JP.cache_specs(jcfg, jm, quant)
            tc = TP.cache_specs(tcfg, tm, quant)
            assert {k: _spec(v) if v is not None else None
                    for k, v in jc._asdict().items()} == tc
            jw = JP.kv_window_specs(jcfg, jm, 4, quant)
            assert {k: _spec(v) if v is not None else None for k, v in
                    jw._asdict().items()} == \
                TP.kv_window_specs(tcfg, tm, 4, quant)
        T = axes["tensor"]
        for tree, spec_tree in ((tp, got), (tq, dict(_flat(specs)))):
            placed = dict(_flat(TP.shard_params(tree, tcfg, tm)))
            for path, leaf in placed.items():
                spec = spec_tree[path]
                if "tensor" in spec:
                    assert isinstance(leaf, Shards) and \
                        leaf.axis == "tensor" and len(leaf.parts) == T \
                        and leaf.split == spec.index("tensor"), path
                else:
                    assert isinstance(leaf, torch.Tensor), path


def test_shardable_axes_match_jax():
    """The kernel wrappers' eligibility rule, under a data = 2 x
    tensor = 4 mesh and without one (test_kernels.py's cases)."""
    jm, tm = meshes(data=2, tensor=4)
    cases = [(4, 8, 4), (3, 8, 4), (4, 6, 3), (4, 8, 2)]
    from butterfly_tpu.ops.flash_attention import shardable_axes as jaxes
    with jax.set_mesh(jm):
        want = [jaxes(*c) for c in cases]
    with mesh_ctx(tm):
        assert [shardable_axes(*c) for c in cases] == want
    assert shardable_axes(4, 8, 4) == (None, None)


# -- the forward -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama", "gpt2", "mixtral"])
def test_tp8_parity(arch):
    """tensor = 8 logits (prefill and one decode step) against JAX: the
    llama case against the JAX meshed run, the others against the
    unmeshed one (test_partition.py holds the two equal)."""
    jcfg, tcfg = tp_cfg(jconfig, arch), tp_cfg(tconfig, arch)
    jp, tp = trees(arch)
    toks = _tokens(0, 2, 12)
    jm, tm = meshes(tensor=8)
    want = jax_logits(jcfg, jp, toks, jm if arch == "llama" else None)
    got, step, cache = port_logits(tcfg, tp, toks, tm)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    ref = TC.init_cache(tcfg, 2, 32, device="cpu")
    _, ref = TC.forward(tp, tcfg, torch.as_tensor(toks), ref)
    want_step, _ = TC.forward(tp, tcfg, torch.as_tensor(toks[:, :1]), ref)
    np.testing.assert_allclose(step, want_step.numpy(), rtol=TOL, atol=TOL)
    # the cache's kv heads really are split over the 8 shards
    assert isinstance(cache.k, Shards) and len(cache.k.parts) == 8
    assert cache.k.parts[0].shape[3] == 1


def test_uneven_dims_replicate():
    """4 heads over tensor = 8: wq/wk/wv/wo replicated (attention runs
    once), the MLP still split; logits equal JAX's."""
    jcfg = jconfig.tiny("llama", dtype="float32", param_dtype="float32")
    tcfg = tconfig.tiny("llama", dtype="float32", param_dtype="float32")
    jm, tm = meshes(tensor=8)
    specs = TP.param_specs(tcfg, tm)
    assert specs["layers"]["attn"]["wq"] == (None, None, None, None)
    assert specs["layers"]["mlp"]["w_up"] == (None, None, "tensor")
    jp = JC.Model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = _tokens(1, 2, 6, jcfg.vocab_size)
    want = jax_logits(jcfg, jp, toks)
    got, _, _ = port_logits(tcfg, tp, toks, tm)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_dp_tp_compose():
    """data = 2 x tensor = 4: batch rows over data groups, weights over
    tensor; logits against the JAX meshed run, both placements."""
    jcfg, tcfg = tp_cfg(jconfig), tp_cfg(tconfig)
    jp, tp = trees()
    toks = _tokens(2, 4, 10)
    jm, tm = meshes(data=2, tensor=4)
    want = jax_logits(jcfg, jp, toks, jm)
    for copy in (False, True):
        got, _, cache = port_logits(tcfg, tp, toks, tm, copy=copy)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        assert cache.k.axis == "data" and len(cache.k.parts) == 2
        assert cache.k.parts[0].axis == "tensor"


def test_int8_weights_under_tensor4():
    """The JAX int8 tree (codes byte-identical to the port's) placed by
    shard_quantized_params over tensor = 4: logits against the JAX
    unmeshed int8 forward; the scales split only where they are > 1."""
    jcfg, tcfg = tp_cfg(jconfig), tp_cfg(tconfig)
    jp, _ = trees()
    jq = JQ.quantize_int8(jp, jcfg)
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    _, tm = meshes(tensor=4)
    sq = TQ.shard_quantized_params(tq, tcfg, tm)
    wq = sq["layers"]["attn"]["wq"]
    assert wq["q8"].axis == "tensor" and wq["s"].axis == "tensor"
    wo = sq["layers"]["attn"]["wo"]
    assert wo["q8"].axis == "tensor" and isinstance(wo["s"], torch.Tensor)
    toks = _tokens(3, 2, 9)
    want = jax_logits(jcfg, jq, toks)
    with mesh_ctx(tm):
        cache = TC.init_cache(tcfg, 2, 32, device="cpu", mesh=tm)
        got, _ = TC.forward(sq, tcfg, torch.as_tensor(toks), cache)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


# -- placement -----------------------------------------------------------------

def _storages(tree):
    return {t.untyped_storage().data_ptr() for _, t in _flat(tree)}


def _parts(leaf):
    if isinstance(leaf, Shards):
        return [p for part in leaf.parts for p in _parts(part)]
    return [leaf]


@pytest.mark.parametrize("axes", [dict(tensor=4), dict(data=2, tensor=4)],
                         ids=["tensor4", "data2_tensor4"])
def test_views_allocate_nothing_copies_do(axes):
    """Shards that share the tree's device hold views of its leaves (no
    storage outside the tree); copy=True places separate storage, one
    replica per data group, with the same values."""
    tcfg = tp_cfg(tconfig)
    _, tp = trees()
    _, tm = meshes(**axes)
    src = _storages(tp)
    views = TP.shard_params(tp, tcfg, tm)
    leaves = [p for _, leaf in _flat(views) for p in _parts(leaf)]
    assert {p.untyped_storage().data_ptr() for p in leaves} <= src
    copies = TP.shard_params(tp, tcfg, tm, copy=True)
    cparts = [p for _, leaf in _flat(copies) for p in _parts(leaf)]
    groups = [g for _, leaf in _flat(copies) for g in
              (leaf.parts if getattr(leaf, "axis", None) == "data"
               else [leaf])]
    split = [p for g in groups if isinstance(g, Shards) for p in g.parts]
    assert split and \
        not {p.untyped_storage().data_ptr() for p in split} & src
    if "data" in axes:
        wq = copies["layers"]["attn"]["wq"]
        assert wq.axis == "data" and len(wq.parts) == 2
        for a, b in zip(wq.parts[0].parts, wq.parts[1].parts):
            assert torch.equal(a, b) and \
                a.untyped_storage().data_ptr() != \
                b.untyped_storage().data_ptr()
    assert sum(p.nbytes for p in cparts) >= \
        sum(t.nbytes for _, t in _flat(tp))


def test_pool_replicas_receive_every_write():
    """data = 2 x tensor = 4 with the pool copied per data group: after a
    prefill, window-off decode steps, windowed steps and a flush, both
    replicas hold the same bytes, and each shard's pool is its kv heads
    of the unsharded engine's pool."""
    tcfg = tp_cfg(tconfig, num_kv_heads=4)
    jp = JC.Model(tp_cfg(jconfig, num_kv_heads=4)).init(
        jax.random.PRNGKey(4))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    _, tm = meshes(data=2, tensor=4)
    rt = tconfig.RuntimeConfig(max_batch_size=4, max_seq_len=32,
                               page_size=8, kv_quant="int8")

    def run(params, cache, mesh):
        S, mp = 4, cache.page_table.shape[1]
        cache = cache._replace(page_table=torch.arange(
            S * mp, dtype=torch.int32).reshape(S, mp))
        toks = torch.as_tensor(_tokens(5, S, 9))
        outs = []
        with mesh_ctx(mesh):
            lg, cache = TPG.paged_forward(params, tcfg, toks, cache,
                                          fresh=True)
            outs.append(lg)
            for _ in range(2):
                lg, cache = TPG.paged_forward(params, tcfg, toks[:, :1],
                                              cache, use_kernel=True)
                outs.append(lg)
            win = TPG.init_kv_window(cache, 4, mesh)
            wl = torch.zeros(S, dtype=torch.int32)
            for _ in range(2):
                lg, win = TPG.paged_forward_window(params, tcfg, toks[:, :1],
                                                   cache, win, wl,
                                                   use_kernel=True)
                outs.append(lg)
                wl = wl + 1
            cache, _, _ = TPG.flush_paged_window(cache, win, wl)
        return outs, cache

    ref_outs, ref = run(tp, TPG.init_paged_cache(tcfg, rt, device="cpu"),
                        None)
    sp = TP.shard_params(tp, tcfg, tm, copy=True)
    sc = TP.shard_paged_cache(TPG.init_paged_cache(tcfg, rt, device="cpu"),
                              tcfg, tm, copy=True)
    assert sc.k_pages.axis == "data" and len(sc.k_pages.parts) == 2
    outs, sc = run(sp, sc, tm)
    for a, b in zip(outs, ref_outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)
    for name in ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages"):
        r0, r1 = getattr(sc, name).parts
        for a, b in zip(r0.parts, r1.parts):
            assert torch.equal(a, b), name
        want = getattr(ref, name)
        got = gather(r0, 2)
        if name.startswith("k_pages") or name.startswith("v_pages"):
            assert torch.equal(got, want), name   # int8 codes: exact
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                                       atol=1e-7)


# -- the sharded kernel wrappers --------------------------------------------------

@pytest.mark.parametrize("kv", [4, 2], ids=["kv4_split", "kv2_replicated"])
def test_paged_attention_sharded_matches_jax(kv):
    """The port's per-shard paged wrapper (q split over the heads, a pool
    per shard, or one replicated pool where Kv = 2 < tensor = 4) against
    the JAX shard_map wrapper on its data x tensor mesh (kv = 4) or the
    plain JAX kernel (kv = 2, where JAX takes the dense gather path)."""
    from butterfly_tpu.ops.paged_attention import (
        paged_attention as jpa, paged_attention_sharded as jpas)
    S, Nq, H, page, P = 4, 8, 16, 4, 12
    rng = np.random.RandomState(9)
    q = rng.randn(S, Nq, H).astype(np.float32)
    kp = rng.randn(P, kv, page, H).astype(np.float32)
    vp = rng.randn(P, kv, page, H).astype(np.float32)
    table = np.asarray([[0, 2, 11], [3, 1, 11], [5, 6, 7], [8, 9, 10]],
                       np.int32)
    lengths = np.asarray([6, 3, 12, 9], np.int32)
    jm, tm = meshes(data=2, tensor=4)
    args = [jnp.asarray(a) for a in (q, kp, vp, table, lengths)]
    if kv == 4:
        with jax.set_mesh(jm):
            want = np.asarray(jax.jit(jpas)(*args))
    else:
        want = np.asarray(jpa(*args))
    tq = Shards(list(torch.as_tensor(q).chunk(4, dim=1)), "tensor", 1)
    pools = [torch.as_tensor(a) for a in (kp, vp)]
    if kv == 4:
        pools = [Shards([c.contiguous() for c in p.chunk(4, dim=1)],
                        "tensor", 1) for p in pools]
    with mesh_ctx(tm):
        out = paged_attention_sharded(tq, *pools, torch.as_tensor(table),
                                      torch.as_tensor(lengths))
    assert isinstance(out, Shards) and len(out.parts) == 4
    np.testing.assert_allclose(gather(out, 1).numpy(), want, rtol=TOL,
                               atol=TOL)
    with mesh_ctx(tm), pytest.raises(ValueError, match="mesh rule"):
        bad = [p if kv == 2 else gather(p, 1) for p in pools]
        if kv == 2:
            bad = [Shards(list(p.chunk(2, dim=1)), "tensor", 1)
                   for p in bad]
        paged_attention_sharded(tq, *bad, torch.as_tensor(table),
                                torch.as_tensor(lengths))


def test_flash_attention_sharded_matches_jax():
    """The per-shard flash wrapper, fresh and warm (prefix split with the
    kv heads), against the JAX shard_map wrapper on data = 2 x tensor =
    4."""
    from butterfly_tpu.ops.flash_attention import (
        flash_attention_sharded as jfas)
    B, T, Nq, Kv, H, Sp = 4, 16, 8, 4, 16, 24
    rng = np.random.RandomState(6)
    q = rng.randn(B, T, Nq, H).astype(np.float32)
    k = rng.randn(B, T, Kv, H).astype(np.float32)
    v = rng.randn(B, T, Kv, H).astype(np.float32)
    pk = rng.randn(B, Sp, Kv, H).astype(np.float32)
    pv = rng.randn(B, Sp, Kv, H).astype(np.float32)
    plen = np.asarray([0, 5, 24, 13], np.int32)
    jm, tm = meshes(data=2, tensor=4)
    with jax.set_mesh(jm):
        fresh = np.asarray(jax.jit(jfas)(*map(jnp.asarray, (q, k, v))))
        warm = np.asarray(jax.jit(
            lambda *a: jfas(a[0], a[1], a[2], prefix_k=a[3], prefix_v=a[4],
                            prefix_len=a[5]))(
            *map(jnp.asarray, (q, k, v, pk, pv, plen))))

    def split(a, dim=2):
        return Shards(list(torch.as_tensor(a).chunk(4, dim=dim)), "tensor",
                      dim)
    with mesh_ctx(tm):
        got = flash_attention_sharded(split(q), split(k), split(v))
        got_w = flash_attention_sharded(
            split(q), split(k), split(v), prefix_k=split(pk),
            prefix_v=split(pv), prefix_len=torch.as_tensor(plen))
    np.testing.assert_allclose(gather(got, 2).numpy(), fresh, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(gather(got_w, 2).numpy(), warm, rtol=TOL,
                               atol=TOL)


def test_all_reduce_is_fixed_order_f32():
    """The reduction sums in shard order in float32 and rounds once: two
    bf16 partials whose bf16 sum would round differently keep the f32
    sum's rounding, and a relaunch gives the same bits."""
    a = torch.tensor([1.0, 256.0], dtype=torch.bfloat16)
    b = torch.tensor([2 ** -8, 1.0], dtype=torch.bfloat16)
    c = torch.tensor([2 ** -8, 1.0], dtype=torch.bfloat16)
    got = all_reduce([a, b, c])
    want = (a.float() + b.float() + c.float()).to(torch.bfloat16)
    assert torch.equal(got, want) and torch.equal(all_reduce([a, b, c]), got)
    assert not torch.equal(got, a + b + c)
