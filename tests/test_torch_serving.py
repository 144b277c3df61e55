"""PyTorch port: the serving engine and the scheduler against the JAX
package on tiny llama, float32 (greedy: token for token), plus sampling
held by its distribution and the configurations the port once refused. The
alternating path is held in tests/test_torch_alternating.py.

Greedy parity is exact: both sides take argmax over logits that agree
to ~1e-6 on a float32 model, so the first token that differs would need
a near-tie the traces below do not contain. Sampling at temperature > 0
cannot match bits (torch.Generator and jax.random draw different
numbers): the port is held to softmax(logits / T) empirically, at N
large enough that a biased sampler fails deterministically.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butterfly_tpu.core.config import RuntimeConfig, tiny
from butterfly_tpu.engine.sampling import _filter_logits as jax_filter
from butterfly_tpu.engine.serving import ServingEngine as JEngine
from butterfly_tpu.models.common import Model as JModel
from butterfly_tpu.sched.scheduler import Scheduler as JScheduler
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.core.mesh import Mesh
from butterfly_tpu_torch.engine.serving import ServingEngine, sample_batched
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.models.common import Model, init_params
from butterfly_tpu_torch.sched.scheduler import Scheduler

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls

CFG = tiny("llama", dtype="float32", param_dtype="float32")
TCFG = tconfig.tiny("llama", dtype="float32", param_dtype="float32")
_TREES = {}


def trees():
    if not _TREES:
        jp = JModel(CFG).init(jax.random.PRNGKey(42))
        _TREES["jax"] = jp
        _TREES["torch"] = params_from_numpy(jax.tree.map(np.asarray, jp),
                                            device="cpu")
    return _TREES["jax"], _TREES["torch"]


def _rt(mod, **kw):
    base = dict(max_batch_size=3, max_seq_len=96, page_size=8,
                prefill_chunk=8, prefill_inline_budget=8)
    base.update(kw)
    return mod.RuntimeConfig(**base)


class _M:
    RuntimeConfig = RuntimeConfig


def jax_engine(use_kernels=False, **kw):
    return JEngine(JModel(CFG), trees()[0], _rt(_M, **kw),
                   use_kernels=use_kernels)


def port_engine(use_kernels=False, **kw):
    return ServingEngine(Model(TCFG, device="cpu"), trees()[1],
                         _rt(tconfig, **kw), use_kernels=use_kernels)


# -- one mixed block, same carries -------------------------------------------

@pytest.mark.parametrize("combine", [True, False], ids=["window", "no_window"])
def test_mixed_block_tokens_match_jax(combine):
    """Two chained mixed blocks (k=3, C=8): slot 0 chews a 13-token
    prompt in two chunks then decodes, slot 1 sits out, slot 2 finishes
    a 5-token prompt in its first step and decodes — prefill lanes and
    decode steps in the same block."""
    je = jax_engine(kv_write_combine=combine)
    te = port_engine(kv_write_combine=combine)
    for e in (je, te):
        e.set_table_row(0, [0, 1, 2])
        e.set_table_row(2, [3, 4])
    rng = np.random.default_rng(0)
    pbuf = np.zeros((3, je.cache.max_seq), np.int32)
    pbuf[0, :13] = rng.integers(1, 250, 13)
    pbuf[2, :5] = rng.integers(1, 250, 5)
    plen = np.array([13, 0, 5], np.int32)
    active = np.array([True, False, True])
    temps = np.zeros((3,), np.float32)
    stops = np.full((3,), -1, np.int32)
    budgets = np.array([10, 0, 10], np.int32)
    jtok, jcur = jnp.zeros((3,), jnp.int32), jnp.zeros((3,), jnp.int32)
    ttok, tcur = torch.zeros(3, dtype=torch.int32), \
        torch.zeros(3, dtype=torch.int32)
    jpb, tpb = jnp.asarray(pbuf), torch.from_numpy(pbuf.copy())
    for blk in range(2):
        jb, jv, jtok, jcur = je.mixed_block_async(
            jtok, jcur, jpb, plen, active, temps, stops, budgets,
            jax.random.PRNGKey(blk), 3, 8)
        tb, tv, ttok, tcur = te.mixed_block_async(
            ttok, tcur, tpb, plen, active, temps, stops, budgets, blk, 3, 8)
        assert tb.numpy().tolist() == np.asarray(jb).tolist(), blk
        assert tv.numpy().tolist() == np.asarray(jv).tolist(), blk
        assert tcur.numpy().tolist() == np.asarray(jcur).tolist(), blk
        assert ttok.numpy().tolist() == np.asarray(jtok).tolist(), blk
        budgets = budgets - np.asarray(jv).sum(0).astype(np.int32)
    assert np.asarray(jv).any()  # decode emissions happened
    if combine:
        jf, tf = je.flush_kv_window(), te.flush_kv_window()
        assert int(tf) == int(jf)
    assert te.cache.lengths.tolist() == np.asarray(je.cache.lengths).tolist()


# -- the scheduler over one ragged trace --------------------------------------

def _trace(sched):
    """Staggered admissions while blocks are in flight; prompts longer
    than prefill_inline_budget (8) so prefill lanes and decode steps
    share blocks."""
    r1 = sched.submit([5, 7, 11], max_new_tokens=8)
    for _ in range(2):
        sched.tick()
    r2 = sched.submit(list(range(1, 40)), max_new_tokens=6)
    r3 = sched.submit([9, 2, 4] * 7, max_new_tokens=5)
    sched.tick()
    r4 = sched.submit([3] * 17, max_new_tokens=4)
    sched.run_until_done()
    return [r.output for r in (r1, r2, r3, r4)]


GRID = [
    ("window", dict(kv_write_combine=True), False),
    ("no_window", dict(kv_write_combine=False), False),
    ("window_int8", dict(kv_write_combine=True, kv_quant="int8"), False),
    ("no_window_int8", dict(kv_write_combine=False, kv_quant="int8"), False),
    ("window_kernels", dict(kv_write_combine=True), True),
]


@pytest.mark.parametrize("name,kw,kernels", GRID, ids=[g[0] for g in GRID])
def test_scheduler_greedy_tokens_match_jax(name, kw, kernels):
    """use_kernels=True: the port's kernel wrapper takes its CPU branch
    (the plain version) on every decode step; the JAX engine runs its
    Pallas kernel in interpret mode."""
    want = _trace(JScheduler(jax_engine(use_kernels=kernels, **kw)))
    sched = Scheduler(port_engine(use_kernels=kernels, **kw))
    assert sched._mixed_mode
    got = _trace(sched)
    assert got == want
    assert [len(o) for o in got] == [8, 6, 5, 4]
    assert sched.barrier_causes().get("admission", 0) == 0


def test_scheduler_seeded_sampling_reproducible():
    def run(seed):
        sched = Scheduler(port_engine(), seed=seed)
        r1 = sched.submit([5, 7, 11], max_new_tokens=8, temperature=0.8)
        sched.tick()
        r2 = sched.submit(list(range(1, 14)), max_new_tokens=6,
                          temperature=0.8)
        sched.run_until_done()
        return [r1.output, r2.output]
    assert run(0) == run(0)
    assert run(0) != run(7)


# -- sampling held by its distribution ----------------------------------------

def _target(row, temp, top_k=0, top_p=1.0):
    scaled = jax_filter(jnp.asarray(row) / temp, top_k, top_p)
    return np.asarray(jax.nn.softmax(scaled))


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (3, 1.0), (0, 0.8)],
                         ids=["plain", "top_k", "top_p"])
def test_sample_batched_matches_softmax(top_k, top_p):
    V, N, temp = 8, 40000, 0.7
    row = np.random.RandomState(0).randn(V).astype(np.float32) * 2.0
    logits = torch.from_numpy(np.tile(row, (N, 1)))
    gen = torch.Generator()
    gen.manual_seed(0)
    temps = torch.full((N,), temp)
    draws = sample_batched(logits, gen, temps, top_k, top_p)
    emp = np.bincount(draws.numpy(), minlength=V) / N
    tgt = _target(row, temp, top_k, top_p)
    assert np.abs(emp - tgt).max() < 0.015, (emp, tgt)
    assert (emp[tgt == 0] == 0).all()  # filtered tokens never drawn


def test_sample_batched_greedy_rows_and_seeding():
    rng = np.random.RandomState(1)
    logits = torch.from_numpy(rng.randn(6, 10).astype(np.float32))
    temps = torch.tensor([0.0, 1.0, 0.0, 0.5, 0.0, 2.0])

    def draw(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return sample_batched(logits, g, temps, 0, 1.0)
    a, b = draw(3), draw(3)
    assert torch.equal(a, b)
    greedy = logits.argmax(-1).to(torch.int32)
    assert torch.equal(a[temps == 0], greedy[temps == 0])
    assert any(not torch.equal(draw(3), draw(s)) for s in range(4, 12))


# -- configurations the port once refused ---------------------------------------

REFUSED = {
    # the seq-parallel lane over a seq x expert mesh (ported with the
    # seq x expert mesh itself)
    "seq_parallel": dict(seq_parallel_threshold=16),
}


def _cpu_mesh(*shape):
    """A mesh of `cpu` devices in MESH_AXES order."""
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = [torch.device("cpu")] * devs.size
    return Mesh(devs.reshape(shape))


@pytest.mark.parametrize("name", sorted(REFUSED) + ["mesh", "moe"])
def test_unported_configurations_refused(name):
    """No configuration is refused any more; the ones that were serve the
    unmeshed JAX scheduler's tokens: the lane on seq 2 x expert 2 (a
    20-token prompt over threshold 16 through it), stage 2 x seq 2 (seq
    a replica, the lane off as in JAX). MoE is ported: a Mixtral engine
    builds and serves."""
    cfg, params, mesh, rt = TCFG, trees()[1], None, _rt(tconfig)
    if name == "moe":
        cfg = tconfig.tiny("mixtral", dtype="float32")
        sched = Scheduler(ServingEngine(
            Model(cfg, device="cpu"), init_params(cfg, device="cpu"), rt))
        req = sched.submit([5, 7, 11], max_new_tokens=3)
        sched.run_until_done()
        assert len(req.output) == 3
        return
    if name in REFUSED:
        rt = _rt(tconfig, **REFUSED[name])
        mesh = _cpu_mesh(1, 1, 2, 2, 1)     # seq x expert
    elif name == "mesh":
        mesh = _cpu_mesh(1, 2, 1, 2, 1)     # stage x seq
    prompts = [list(range(3, 23)), [5, 7, 11]]
    outs = []
    for sched in (JScheduler(jax_engine()), Scheduler(ServingEngine(
            Model(cfg, device="cpu"), params, rt, mesh=mesh))):
        reqs = [sched.submit(p, max_new_tokens=5) for p in prompts]
        sched.run_until_done()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert sched.engine.supports_seq_parallel == (name in REFUSED)
    assert (sched._c_sp_tokens.value > 0) == (name in REFUSED)


def test_engine_defaults():
    e = port_engine()
    assert e.device.type == "cpu" and not e._use_kernels
    assert e.mixed_dispatch_ready and e.mixed_fallback_reason is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Model(TCFG)  # no device given means CUDA, which is absent
