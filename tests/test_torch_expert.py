"""PyTorch port: expert parallelism (parallel/expert.py, the expert-sharded
weight placement of parallel/partition.py and the expert mesh of
core/mesh.py) against the JAX package, float32.

The JAX side runs moe_block_ep on expert = 2 and 4 meshes of the
harness's fake CPU devices; the port's single-controller mesh puts every
shard on `cpu`. Outputs within 1e-5 (JAX's own bound for the expert
paths against the dense block), with the no-drop capacity and with
capacity 1, where both sides must drop the same assignments. Greedy
tokens on an expert = 2 mesh equal the dense run's exactly (no-drop).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butterfly_tpu.core import config as jconfig
from butterfly_tpu.core.config import MeshConfig as JMeshConfig
from butterfly_tpu.core.mesh import make_mesh as jmake_mesh
from butterfly_tpu.models.common import Model as JModel
from butterfly_tpu.parallel import expert as JE
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.core.mesh import active_mesh, make_mesh, mesh_ctx
from butterfly_tpu_torch.engine.engine import InferenceEngine
from butterfly_tpu_torch.engine.sampling import SamplingParams
from butterfly_tpu_torch.engine.serving import ServingEngine
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.models.common import (Model, init_params, moe_block,
                                               route_tokens)
from butterfly_tpu_torch.parallel import expert as TE
from butterfly_tpu_torch.parallel.partition import (Shards,
                                                    expert_parts,
                                                    shard_params)
from butterfly_tpu_torch.quant.int8 import quantize_int8
from butterfly_tpu_torch.sched.scheduler import Scheduler
from butterfly_tpu_torch.serve import cli

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls

TOL = 1e-5
SHAPE = dict(vocab_size=256, hidden_size=64, num_heads=8, num_kv_heads=8,
             head_dim=8, intermediate_size=128, dtype="float32",
             param_dtype="float32")


def moe_cfg(mod, **kw):
    """test_expert.py's moe_cfg (4 experts, top 2, cf 2.0), in either
    package's config module."""
    return mod.tiny("mixtral", **SHAPE, **kw)


_TREES = {}


def trees(E=4):
    """(JAX tree, bridged port tree) of moe_cfg with E experts."""
    if E not in _TREES:
        jp = JModel(moe_cfg(jconfig, num_experts=E)).init(
            jax.random.PRNGKey(E))
        _TREES[E] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                           device="cpu"))
    return _TREES[E]


def _layer0(tree):
    return {k: v[0] for k, v in tree["layers"]["moe"].items()}


def _x(seed, B, Tn, D=64):
    return np.random.default_rng(seed).standard_normal((B, Tn, D)) \
        .astype(np.float32)


def _meshes(N):
    return (jmake_mesh(JMeshConfig(expert=N), devices=jax.devices()[:N]),
            make_mesh(tconfig.MeshConfig(expert=N), ["cpu"] * N))


def _jax_ep(x, p, cfg, jmesh, capacity):
    with jax.set_mesh(jmesh):
        return np.asarray(jax.jit(lambda x, p: JE.moe_block_ep(
            x, p, cfg, capacity))(jnp.asarray(x), p))


# -- capacity --------------------------------------------------------------------

CAPS = [(dict(), 16, 16), (dict(moe_capacity_factor=0.001), 16, 1),
        (dict(moe_capacity_factor=100.0), 4, 8)]


@pytest.mark.parametrize("kw,tokens,want", CAPS,
                         ids=["formula", "floor_1", "clamped_k_t"])
def test_expert_capacity_matches_jax(kw, tokens, want):
    assert JE.expert_capacity(moe_cfg(jconfig, **kw), tokens) == want
    assert TE.expert_capacity(moe_cfg(tconfig, **kw), tokens) == want


# -- the two dispatch paths against JAX ------------------------------------------

EP = [(N, cap, sharded) for N in (2, 4) for cap in ("no_drop", 1)
      for sharded in (False, True)]


@pytest.mark.parametrize("N,cap,sharded", EP,
                         ids=[f"expert{n}-{c}-{'sharded' if s else 'plain'}"
                              for n, c, s in EP])
def test_moe_block_ep_a2a_matches_jax(N, cap, sharded):
    """T = 8 divides over N: the counting-sort + all_to_all path on both
    sides; with capacity 1 most assignments drop, the same ones."""
    jp, tp = trees()
    cfg, tcfg = moe_cfg(jconfig), moe_cfg(tconfig)
    B, Tn = 2, 8
    capacity = cfg.num_experts_per_tok * Tn if cap == "no_drop" else cap
    x = _x(N, B, Tn)
    jmesh, tmesh = _meshes(N)
    want = _jax_ep(x, _layer0(jp), cfg, jmesh, capacity)
    tree = shard_params(tp, tcfg, tmesh) if sharded else tp
    with mesh_ctx(tmesh):
        assert TE.takes_a2a(torch.from_numpy(x), tcfg)
        got = TE.moe_block_ep(torch.from_numpy(x), _layer0(tree), tcfg,
                              capacity)
    assert active_mesh() is None
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    dense = moe_block(torch.from_numpy(x), _layer0(tp), tcfg).numpy()
    dropped = int(TE.dropped_assignments(torch.from_numpy(x),
                                         _layer0(tp)["router"], tcfg, N,
                                         capacity))
    if cap == "no_drop":
        assert dropped == 0
        np.testing.assert_allclose(got.numpy(), dense, atol=TOL, rtol=0)
    else:
        assert dropped > 0 and not np.allclose(got.numpy(), dense)


@pytest.mark.parametrize("Tn,cap", [(1, "no_drop"), (1, 1), (6, "no_drop"),
                                    (6, 1)],
                         ids=["T1-no_drop", "T1-cap1", "T6-no_drop",
                              "T6-cap1"])
def test_moe_block_ep_einsum_path_matches_jax(Tn, cap):
    """A decode step (T = 1) and a T that N = 4 does not divide take the
    one-hot einsum path, on both sides, sharded weights included."""
    jp, tp = trees()
    cfg, tcfg = moe_cfg(jconfig), moe_cfg(tconfig)
    capacity = cfg.num_experts_per_tok * Tn if cap == "no_drop" else cap
    x = _x(10 + Tn, 3, Tn)
    jmesh, tmesh = _meshes(4)
    want = _jax_ep(x, _layer0(jp), cfg, jmesh, capacity)
    with mesh_ctx(tmesh):
        assert not TE.takes_a2a(torch.from_numpy(x), tcfg)
        got = TE.moe_block_ep(torch.from_numpy(x),
                              _layer0(shard_params(tp, tcfg, tmesh)), tcfg,
                              capacity)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_moe_block_ep_without_a_mesh_is_the_einsum_path():
    jp, tp = trees()
    cfg, tcfg = moe_cfg(jconfig), moe_cfg(tconfig)
    x = _x(5, 2, 8)
    want = np.asarray(JE.moe_block_ep(jnp.asarray(x), _layer0(jp), cfg))
    assert not TE.takes_a2a(torch.from_numpy(x), tcfg)
    got = TE.moe_block_ep(torch.from_numpy(x), _layer0(tp), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_dropped_assignments_counts_the_overflow():
    """Against a direct count: per source shard, each expert keeps at
    most C of its assignments."""
    _, tp = trees()
    tcfg = moe_cfg(tconfig)
    x = _x(7, 2, 8)
    for N, cap in ((2, 1), (4, 1), (2, 3)):
        Tl = 8 // N
        C = min(cap * 2, tcfg.num_experts_per_tok * 2 * Tl)
        want = 0
        for i in range(N):
            chunk = torch.from_numpy(x[:, i * Tl:(i + 1) * Tl])
            _, idx = route_tokens(chunk, _layer0(tp)["router"], 2)
            counts = np.bincount(idx.numpy().ravel(), minlength=4)
            want += int(np.maximum(counts - C, 0).sum())
        got = TE.dropped_assignments(torch.from_numpy(x),
                                     _layer0(tp)["router"], tcfg, N, cap)
        assert int(got) == want and (want > 0 or cap > 1)


# -- placement -------------------------------------------------------------------

def test_shard_params_places_views_of_one_tree():
    _, tp = trees()
    tcfg = moe_cfg(tconfig)
    _, tmesh = _meshes(2)
    for tree in (tp, quantize_int8(tp, tcfg)):
        sp = shard_params(tree, tcfg, tmesh)
        assert sp["layers"]["moe"]["router"] is tree["layers"]["moe"][
            "router"]
        assert sp["embed"]["tok"] is tree["embed"]["tok"]
        for name in ("w_gate", "w_up", "w_down"):
            leaf, src = sp["layers"]["moe"][name], tree["layers"]["moe"][name]
            pairs = [(leaf, src)] if not isinstance(src, dict) else \
                [(leaf[k], src[k]) for k in ("q8", "s")]
            for sh, full in pairs:
                assert isinstance(sh, Shards) and sh.axis == "expert" \
                    and len(sh.parts) == 2
                for i, part in enumerate(sh.parts):
                    assert part._base is full       # a view: no copy
                    assert torch.equal(part, full[:, 2 * i:2 * i + 2])
                assert sh.nbytes == full.nbytes
                layer = sh[1]
                assert [tuple(p.shape) for p in expert_parts(layer, 2)] == \
                    [tuple(full[1, :2].shape)] * 2
        assert shard_params(sp, tcfg, tmesh)["layers"]["moe"]["w_up"] is \
            not None  # sharding a sharded tree is a no-op per leaf
    with pytest.raises(ValueError, match="do not split"):
        shard_params(tp, tcfg, make_mesh(tconfig.MeshConfig(expert=3),
                                         ["cpu"] * 3))


# -- the engines on an expert = 2 mesh -------------------------------------------

E8 = dict(moe_capacity_factor=4.0)   # cf = E: nothing drops
PROMPTS = [[5, 7, 11, 2, 9, 4], list(range(1, 13)), [8, 8]]


def _engine_pair():
    _, tp = trees()
    dense = moe_cfg(tconfig, **E8)
    return tp, Model(dense, device="cpu"), \
        Model(dense.replace(moe_impl="ep"), device="cpu"), _meshes(2)[1]


@pytest.mark.parametrize("kvq,fused", [("none", True), ("none", False),
                                       ("int8", True)],
                         ids=["fused", "stepped", "int8_kv"])
def test_inference_engine_on_an_expert_mesh_matches_dense(kvq, fused):
    tp, dm, em, mesh = _engine_pair()
    rt = tconfig.RuntimeConfig(max_seq_len=32, kv_quant=kvq)
    sp = SamplingParams(max_new_tokens=8)
    want = InferenceEngine(dm, tp, rt).generate(PROMPTS, sp, fused=fused)
    eng = InferenceEngine(em, tp, rt, mesh=mesh)
    w_gate = eng.params["layers"]["moe"]["w_gate"]
    assert isinstance(w_gate, Shards) and w_gate.axis == "expert"
    got = eng.generate(PROMPTS, sp, fused=fused)
    assert got.tokens.tolist() == want.tokens.tolist()
    spec = eng.generate_speculative(PROMPTS[1], sp, gamma=3)
    assert spec.tokens.tolist() == want.tokens[1].tolist()


def _trace(sched):
    r1 = sched.submit([5, 7, 11], max_new_tokens=8)
    sched.tick()
    r2 = sched.submit(list(range(1, 30)), max_new_tokens=6)
    r3 = sched.submit([9, 2, 4] * 5, max_new_tokens=5)
    sched.run_until_done()
    return [r.output for r in (r1, r2, r3)]


SERVE = [("mixed_window", dict()),
         ("mixed_no_window", dict(kv_write_combine=False)),
         ("alternating", dict(mixed_dispatch=False)),
         ("spec_ngram", dict(speculative_gamma=2))]


@pytest.mark.parametrize("name,kw", SERVE, ids=[s[0] for s in SERVE])
def test_serving_engine_on_an_expert_mesh_matches_dense(name, kw):
    """Mixed dispatch with the window on and off, the alternating path
    and a spec block: the prefill chunks (T = 8) take the a2a path, the
    decode steps the einsum path."""
    tp, dm, em, mesh = _engine_pair()
    rt = tconfig.RuntimeConfig(max_batch_size=3, max_seq_len=96,
                               page_size=8, prefill_chunk=8,
                               prefill_inline_budget=8, **kw)
    want = _trace(Scheduler(ServingEngine(dm, tp, rt)))
    eng = ServingEngine(em, tp, rt, mesh=mesh)
    assert eng.cache.k_pages.device.type == "cpu"   # the first device
    got = _trace(Scheduler(eng))
    assert got == want and [len(o) for o in got] == [8, 6, 5]


# -- the mesh and the CLI --------------------------------------------------------

def test_expert_mesh_devices_and_refusals():
    m = make_mesh(tconfig.MeshConfig(expert=4), ["cpu"] * 4)
    assert m.expert_devices() == [torch.device("cpu")] * 4
    assert m.first_device == torch.device("cpu")
    # expert x seq builds as the JAX mesh does, device for device; seq
    # shard i's own mesh holds its expert shards
    names = [f"cpu:{i}" for i in range(4)]
    m = make_mesh(tconfig.MeshConfig(expert=2, seq=2), names)
    jm = jmake_mesh(JMeshConfig(expert=2, seq=2), devices=jax.devices()[:4])
    assert np.array_equal(np.vectorize(lambda d: d.index)(m.devices),
                          np.vectorize(lambda d: d.id)(jm.devices))
    assert [m.seq_mesh(i).expert_devices() for i in range(2)] == \
        [[torch.device("cpu:0"), torch.device("cpu:2")],
         [torch.device("cpu:1"), torch.device("cpu:3")]]
    # expert x tensor builds: expert shard e's tensor devices, and the
    # expert shards at each tensor coordinate
    m = make_mesh(tconfig.MeshConfig(expert=2, tensor=2), names)
    assert m.tensor_devices(expert_index=1) == \
        [torch.device("cpu:2"), torch.device("cpu:3")]
    assert m.expert_devices(tensor_index=1) == \
        [torch.device("cpu:1"), torch.device("cpu:3")]


def _cli(capsys, *argv):
    rc = cli.main(list(argv))
    out, err = capsys.readouterr()
    return rc, out, err


def test_cli_generate_expert_parallel_prints_the_same_text(capsys):
    base = ["generate", "--model", "tiny", "--device", "cpu", "--prompt",
            "hello", "--max-new", "8"]
    rc0, want, _ = _cli(capsys, *base)
    rc1, got, _ = _cli(capsys, *base, "--expert-parallel", "2")
    assert rc0 == rc1 == 0 and got == want
    args = cli.build_parser().parse_args(
        ["serve", "--model", "mixtral-8x7b", "--device", "cpu",
         "--expert-parallel", "2"])
    assert cli.resolve_model(args).cfg.moe_impl == "ep"
    assert cli.build_mesh(args).shape["expert"] == 2
    # with --seq-parallel: generate_long over seq x expert, the same text
    rc2, got2, err = _cli(capsys, *base, "--expert-parallel", "2",
                          "--seq-parallel", "2")
    assert rc2 == 0 and got2 == want and "sequence parallelism" in err


def test_cli_quant_draws_int8_without_the_float_tree():
    args = cli.build_parser().parse_args(
        ["generate", "--model", "tiny", "--device", "cpu", "--quant",
         "int8"])
    model = cli.resolve_model(args)
    params = cli.load_params(model, args)
    w = params["layers"]["mlp"]["w_up"]
    assert w["q8"].dtype == torch.int8 and w["s"].dtype == torch.float32
    ref = init_params(model.cfg, device="cpu")
    assert sorted(params["layers"]["mlp"]) == sorted(ref["layers"]["mlp"])
