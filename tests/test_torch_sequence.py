"""PyTorch port: core/mesh.py (the single-controller mesh) and
parallel/sequence.py (ring attention, Ulysses, sp_forward,
sp_decode_step) against the JAX package under shard_map, f32.

The JAX side runs on the test harness's fake CPU devices
(make_mesh(MeshConfig(seq=N), jax.devices()[:N])); the port's mesh puts
all N shards on `cpu`, which is what one card does with N = 2 on cuda:0.
Inputs are made from numpy seeds. Tolerances: attention outputs and
logits 2e-5 (the same arithmetic, summed in another order by ATen's and
XLA's CPU kernels); float K/V caches 1e-5; int8 codes within 1 and scales
1e-6 relative (a value on a rounding boundary may round the other way).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from butterfly_tpu.core import compat
from butterfly_tpu.core.config import MeshConfig as JMeshConfig
from butterfly_tpu.core.config import tiny
from butterfly_tpu.core.mesh import make_mesh as jmake_mesh
from butterfly_tpu.models import common as J
from butterfly_tpu.parallel import sequence as JS
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.core.config import MeshConfig
from butterfly_tpu_torch.core.mesh import (local_mesh, make_mesh, mesh_for,
                                           seq_degree)
from butterfly_tpu_torch.models import common as T
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.ops.ring_attention import INVALID_POS
from butterfly_tpu_torch.parallel import sequence as TS

torch.set_num_threads(1)

TOL = 2e-5
_TREES = {}


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


def _meshes(N):
    return (jmake_mesh(JMeshConfig(seq=N), devices=jax.devices()[:N]),
            make_mesh(MeshConfig(seq=N), ["cpu"] * N))


# -- the mesh ------------------------------------------------------------------

def test_mesh_maps_coordinates_to_devices():
    m = make_mesh(MeshConfig(seq=4), ["cpu"] * 4)
    assert m.shape == {"data": 1, "stage": 1, "expert": 1, "seq": 4,
                       "tensor": 1}
    assert m.devices.shape == (1, 1, 1, 4, 1)
    assert m.seq_devices() == [torch.device("cpu")] * 4
    assert seq_degree(m) == 4 and seq_degree(None) == 1
    assert local_mesh("cpu").shape["seq"] == 1
    assert mesh_for(2, tensor=1, seq=2, devices=["cpu"] * 2).shape["seq"] == 2
    with pytest.raises(ValueError, match="wants 4 devices"):
        make_mesh(MeshConfig(seq=4), ["cpu"] * 3)


@pytest.mark.parametrize("axis", ["tensor", "data", "stage", "expert"])
def test_mesh_refuses_unported_axes(axis):
    """Every axis combines with seq as the JAX make_mesh combines it (no
    mesh is refused any more): the device grid of `axis` x seq is the
    JAX mesh's, device for device, and the seq rings are found by
    coordinate; a stage's own mesh keeps the seq axis whole (seq is a
    replica there), and seq shard i's own mesh keeps the expert axis
    whole (where its expert dispatch runs)."""
    names = [f"cpu:{i}" for i in range(4)]
    m = make_mesh(MeshConfig(**{axis: 2, "seq": 2}), names)
    jm = jmake_mesh(JMeshConfig(**{axis: 2, "seq": 2}),
                    devices=jax.devices()[:4])
    assert m.axis_names == tuple(jm.axis_names)
    assert np.array_equal(np.vectorize(lambda d: d.index)(m.devices),
                          np.vectorize(lambda d: d.id)(jm.devices))
    assert seq_degree(m) == 2 and m.shape[axis] == 2
    if axis == "stage":
        sub = m.stage_mesh(1)
        assert sub.shape["stage"] == 1 and sub.shape["seq"] == 2
        assert sub.seq_devices() == [torch.device("cpu:2"),
                                     torch.device("cpu:3")]
        return
    if axis == "expert":
        sub = m.seq_mesh(1)
        assert sub.shape["seq"] == 1 and sub.shape["expert"] == 2
        assert sub.expert_devices() == m.expert_devices(seq_index=1) == \
            [torch.device("cpu:1"), torch.device("cpu:3")]
        return
    # mesh order (data, stage, expert, seq, tensor): seq is the outer of
    # the two axes under tensor, the inner one under data
    stride = 2 if axis == "tensor" else 1
    for c in range(2):
        kw = {"data_index": c} if axis == "data" else {"tensor_index": c}
        want = [torch.device(names[(c if axis == "tensor" else 2 * c)
                                   + stride * i]) for i in range(2)]
        assert m.seq_devices(**kw) == want


def test_mesh_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(MeshConfig(seq=2), ["cuda:0", "cuda:0"])


# -- ring and Ulysses attention --------------------------------------------------

def _qkv(nq, kv, seed, B=2, Tn=32, Hd=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Tn, nq, Hd)).astype(np.float32),
            rng.standard_normal((B, Tn, kv, Hd)).astype(np.float32),
            rng.standard_normal((B, Tn, kv, Hd)).astype(np.float32),
            np.broadcast_to(np.arange(Tn)[None], (B, Tn)).astype(np.int32))


def _jax_seq(mesh, fn, *arrays):
    """fn under shard_map over seq, every operand sharded on dim 1."""
    specs = tuple(P(None, "seq") for _ in arrays)
    f = compat.shard_map(fn, mesh, in_specs=specs, out_specs=P(None, "seq"),
                         axis_names={"seq"})
    with compat.mesh_ctx(mesh):
        args = [jax.device_put(jnp.asarray(a),
                               NamedSharding(mesh, P(None, "seq")))
                for a in arrays]
        return np.asarray(jax.jit(f)(*args))


def _split(a, N):
    return [torch.from_numpy(np.ascontiguousarray(c))
            for c in np.split(a, N, axis=1)]


@pytest.mark.parametrize("nq,kv", [(8, 8), (8, 2)])
def test_ring_attention_matches_jax(nq, kv):
    jm, tm = _meshes(4)
    q, k, v, pos = _qkv(nq, kv, 0)
    want = _jax_seq(jm, lambda q, k, v, p: JS.ring_attention(q, k, v, p, p),
                    q, k, v, pos)
    got = TS.ring_attention(_split(q, 4), _split(k, 4), _split(v, 4),
                            _split(pos, 4), _split(pos, 4))
    _close(TS.gather_shards(got), want)


def test_ring_attention_int8_matches_jax():
    """int8 codes + scales ride the ring (kv-major layout)."""
    jm, _ = _meshes(4)
    q, k, v, pos = _qkv(8, 2, 1)
    kq, ks = (np.asarray(a) for a in J.quantize_kv(jnp.moveaxis(k, 2, 1)))
    vq, vs = (np.asarray(a) for a in J.quantize_kv(jnp.moveaxis(v, 2, 1)))

    def body(q, kq, vq, ks, vs, p):
        return JS.ring_attention(q, kq, vq, p, p, k_scale=ks, v_scale=vs)
    specs = (P(None, "seq"), P(None, None, "seq"), P(None, None, "seq"),
             P(None, None, "seq"), P(None, None, "seq"), P(None, "seq"))
    f = compat.shard_map(body, jm, in_specs=specs, out_specs=P(None, "seq"),
                         axis_names={"seq"})
    with compat.mesh_ctx(jm):
        want = np.asarray(jax.jit(f)(q, kq, vq, ks, vs, pos))

    def sp(a, d):
        return [torch.from_numpy(np.ascontiguousarray(c))
                for c in np.split(a, 4, axis=d)]
    got = TS.ring_attention(sp(q, 1), sp(kq, 2), sp(vq, 2), sp(pos, 1),
                            sp(pos, 1), sp(ks, 2), sp(vs, 2))
    _close(TS.gather_shards(got), want)


@pytest.mark.parametrize("kv", [4, 2], ids=["scatter", "replicate"])
def test_ulysses_attention_matches_jax(kv):
    """Kv=4 on 4 shards scatters heads; Kv=2 replicates each kv head
    N/Kv = 2 times first."""
    jm, _ = _meshes(4)
    q, k, v, pos = _qkv(8, kv, 2)
    want = _jax_seq(jm, lambda q, k, v, p: JS.ulysses_attention(q, k, v, p),
                    q, k, v, pos)
    got = TS.ulysses_attention(_split(q, 4), _split(k, 4), _split(v, 4),
                               _split(pos, 4))
    _close(TS.gather_shards(got), want)


def test_ulysses_refuses_heads_that_do_not_divide():
    q, k, v, pos = _qkv(8, 3, 3)
    with pytest.raises(ValueError, match="ulysses needs"):
        TS.ulysses_attention(_split(q, 4), _split(k, 4), _split(v, 4),
                             _split(pos, 4))


# -- whole-model prefill and decode ----------------------------------------------

CFG_KW = dict(vocab_size=256, hidden_size=64, num_heads=8, num_kv_heads=2,
              head_dim=8, intermediate_size=128, dtype="float32",
              param_dtype="float32")


def _trees():
    if "llama" not in _TREES:
        jp = J.Model(tiny("llama", **CFG_KW)).init(jax.random.PRNGKey(2))
        _TREES["llama"] = (jp, params_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return _TREES["llama"]


def _same_codes(got, want):
    """int8 codes within 1 (a value on a rounding boundary)."""
    d = np.abs(_np(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    assert d.max() <= 1


def _same_scales(got, want):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=0)


def _check_cache(tc: TS.ShardedKVCache, jc, quant):
    g = tc.gather()
    if quant:
        _same_codes(g.k, jc.k)
        _same_codes(g.v, jc.v)
        _same_scales(g.k_scale, jc.k_scale)
        _same_scales(g.v_scale, jc.v_scale)
    else:
        _close(g.k, jc.k, 1e-5)
        _close(g.v, jc.v, 1e-5)
    assert np.array_equal(_np(g.length), np.asarray(jc.length))


def _jax_sp_forward(jp, cfg, tokens, jm, impl, kvq):
    with compat.mesh_ctx(jm):
        return jax.jit(lambda p, t: JS.sp_forward(
            p, cfg, t, jm, impl=impl, kv_quant=kvq))(jp, jnp.asarray(tokens))


@pytest.mark.parametrize("N,impl,kvq", [
    (2, "ring", "none"), (4, "ring", "none"), (2, "ring", "int8"),
    (4, "ring", "int8"), (4, "ulysses", "none"), (2, "ulysses", "int8"),
])
def test_sp_forward_matches_jax(N, impl, kvq):
    jp, tp = _trees()
    cfg, tcfg = tiny("llama", **CFG_KW), tconfig.tiny("llama", **CFG_KW)
    jm, tm = _meshes(N)
    tokens = np.random.default_rng(4).integers(0, 256, (2, 24)) \
        .astype(np.int32)
    jl, jc = _jax_sp_forward(jp, cfg, tokens, jm, impl, kvq)
    tl, tc = TS.sp_forward(tp, tcfg, torch.from_numpy(tokens), tm,
                           impl=impl, kv_quant=kvq)
    assert len(tl) == N and tl[0].shape == (2, 24 // N, 256)
    _close(TS.gather_shards(tl), jl)
    _check_cache(tc, jc, kvq == "int8")


def test_sp_forward_validation():
    _, tp = _trees()
    tcfg = tconfig.tiny("llama", **CFG_KW)
    tm = make_mesh(MeshConfig(seq=4), ["cpu"] * 4)
    with pytest.raises(ValueError, match="not divisible"):
        TS.sp_forward(tp, tcfg, torch.zeros((2, 10), dtype=torch.int32), tm)
    with pytest.raises(ValueError, match="kv quant"):
        TS.sp_forward(tp, tcfg, torch.zeros((2, 8), dtype=torch.int32), tm,
                      kv_quant="fp8")


@pytest.mark.parametrize("N,kvq", [(2, "none"), (4, "none"), (4, "int8")])
def test_sp_decode_step_matches_jax(N, kvq):
    """Decode over the sharded prefix of an 11-token prompt padded to 12
    (prefix_len masks the pad slot), steps chained on both sides with the
    same tokens: logits and the suffix cache."""
    jp, tp = _trees()
    cfg, tcfg = tiny("llama", **CFG_KW), tconfig.tiny("llama", **CFG_KW)
    jm, tm = _meshes(N)
    B, Tn, true_len, steps = 1, 12, 11, 4
    tokens = np.random.default_rng(5).integers(1, 256, (B, Tn)) \
        .astype(np.int32)
    tokens[:, true_len:] = 0
    _, jpre = _jax_sp_forward(jp, cfg, tokens, jm, "ring", kvq)
    _, tpre = TS.sp_forward(tp, tcfg, torch.from_numpy(tokens), tm,
                            kv_quant=kvq)
    jsuf = J.init_cache(cfg, B, steps, quant=kvq)
    tsuf = T.init_cache(tcfg, B, steps, quant=kvq, device="cpu")
    plen = np.full((B,), true_len, np.int32)
    step = jax.jit(lambda p, t, pos, pre, suf, pl: JS.sp_decode_step(
        p, cfg, t, pos, pre, suf, jm, prefix_len=pl))
    feed = np.random.default_rng(6).integers(1, 256, (steps, B, 1)) \
        .astype(np.int32)
    for i in range(steps):
        pos = np.full((B, 1), true_len + i, np.int32)
        with compat.mesh_ctx(jm):
            jl, jsuf = step(jp, jnp.asarray(feed[i]), jnp.asarray(pos), jpre,
                            jsuf, jnp.asarray(plen))
        tl, tsuf = TS.sp_decode_step(
            tp, tcfg, torch.from_numpy(feed[i]), torch.from_numpy(pos), tpre,
            tsuf, tm, prefix_len=torch.from_numpy(plen))
        _close(tl, jl)
    assert np.array_equal(_np(tsuf.length), np.asarray(jsuf.length))
    if kvq == "int8":
        _same_codes(tsuf.k, jsuf.k)
        _same_scales(tsuf.k_scale, jsuf.k_scale)
    else:
        _close(tsuf.k, jsuf.k, 1e-5)
        _close(tsuf.v, jsuf.v, 1e-5)
    # the capacity contract: a step past the suffix's end raises
    with pytest.raises(ValueError, match="suffix cache full"):
        TS.sp_decode_step(tp, tcfg, torch.from_numpy(feed[0]),
                          torch.from_numpy(pos), tpre, tsuf, tm)


def test_sp_chunk_body_prefix_positions_and_shards():
    """sp_chunk_body: only prefix positions < start are attendable (the
    rest of the gathered prefix, garbage here, changes nothing), and the
    chunk's K/V comes back per shard in the pool's representation."""
    _, tp = _trees()
    tcfg = tconfig.tiny("llama", **CFG_KW)
    tm = make_mesh(MeshConfig(seq=2), ["cpu"] * 2)
    L, S, Kv, Hd = tcfg.num_layers, 32, 2, 8
    rng = np.random.default_rng(7)
    pk = torch.from_numpy(rng.standard_normal((L, 1, S, Kv, Hd))
                          .astype(np.float32))
    pv = torch.from_numpy(rng.standard_normal((L, 1, S, Kv, Hd))
                          .astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 256, (1, 8)).astype(np.int32))
    lg, kv = TS.sp_chunk_body(tp, tcfg, tokens, 20, (pk, pv), tm)
    junk = pk.clone(), pv.clone()
    for t in junk:
        t[:, :, 20:] = 1e4
    lg2, _ = TS.sp_chunk_body(tp, tcfg, tokens, 20, junk, tm)
    _close(TS.gather_shards(lg2), _np(TS.gather_shards(lg)), 0)
    assert len(kv) == 2 and kv[0][0].shape == (L, 1, 4, Kv, Hd)
    assert INVALID_POS == 2**31 - 1
