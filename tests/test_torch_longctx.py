"""PyTorch port: the seq-parallel long-context path end to end against the
JAX package, f32 — InferenceEngine.generate_long, the serving lane's
ServingEngine.sp_prefill_chunk, the scheduler's long-prompt lane in mixed
and alternating dispatch, and the CLI.

The JAX side runs on the harness's fake CPU devices
(make_mesh(MeshConfig(seq=N), jax.devices()[:N])), the port's mesh puts
the N shards on `cpu`. Greedy tokens must be identical; lane logits
within 3e-4 chunk by chunk (JAX's own bound for its seq-parallel chunk
against the dense chunk); float pool pages within 1e-5, int8 codes within
1 and scales 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butterfly_tpu.core.config import MeshConfig as JMeshConfig
from butterfly_tpu.core.config import ModelConfig as JModelConfig
from butterfly_tpu.core.config import RuntimeConfig as JRuntime
from butterfly_tpu.core.mesh import make_mesh as jmake_mesh
from butterfly_tpu.engine.engine import InferenceEngine as JEngine
from butterfly_tpu.engine.sampling import SamplingParams as JSP
from butterfly_tpu.engine.serving import ServingEngine as JServing
from butterfly_tpu.models.common import Model as JModel
from butterfly_tpu.sched.scheduler import Scheduler as JScheduler
from butterfly_tpu_torch.core.config import MeshConfig, ModelConfig
from butterfly_tpu_torch.core.config import RuntimeConfig
from butterfly_tpu_torch.core.mesh import make_mesh
from butterfly_tpu_torch.engine.engine import InferenceEngine
from butterfly_tpu_torch.engine.sampling import SamplingParams
from butterfly_tpu_torch.engine.serving import ServingEngine
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.models.common import Model
from butterfly_tpu_torch.sched.scheduler import Scheduler
from butterfly_tpu_torch.serve import cli

torch.set_num_threads(1)

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=8,
           num_kv_heads=2, head_dim=8, intermediate_size=128,
           max_seq_len=256, dtype="float32")
_MODELS = {}


def models():
    """(JAX model, JAX tree, port model, port tree): one init, bridged."""
    if not _MODELS:
        jm = JModel(JModelConfig(**CFG))
        jp = jm.init(jax.random.PRNGKey(0))
        _MODELS["m"] = (jm, jp, Model(ModelConfig(**CFG), device="cpu"),
                        params_from_numpy(jax.tree.map(np.asarray, jp),
                                          device="cpu"))
    return _MODELS["m"]


def _meshes(N):
    return (jmake_mesh(JMeshConfig(seq=N), devices=jax.devices()[:N]),
            make_mesh(MeshConfig(seq=N), ["cpu"] * N))


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


PROMPT = [int(t) for t in (np.arange(1, 12) * 13 + 7) % 256]  # 11 tokens


# -- generate_long ---------------------------------------------------------------

@pytest.mark.parametrize("N,impl,kvq", [
    (4, "ring", "none"), (2, "ring", "int8"), (4, "ulysses", "none"),
    (2, "ulysses", "int8"),
])
def test_generate_long_greedy_matches_jax(N, impl, kvq):
    """An 11-token prompt (padded to a multiple of N, the pad masked out
    of every decode step), 6 greedy tokens: identical to JAX's."""
    jm, jp, tm, tp = models()
    jmesh, tmesh = _meshes(N)
    want = JEngine(jm, jp, JRuntime(kv_quant=kvq), mesh=jmesh).generate_long(
        PROMPT, JSP(max_new_tokens=6), impl=impl)
    got = InferenceEngine(tm, tp, RuntimeConfig(kv_quant=kvq),
                          mesh=tmesh).generate_long(
        PROMPT, SamplingParams(max_new_tokens=6), impl=impl)
    assert np.array_equal(got.tokens, want.tokens)
    assert np.array_equal(got.lengths, want.lengths)
    assert np.array_equal(got.prompt_lengths, want.prompt_lengths)


def test_generate_long_matches_unmeshed_generate_and_refuses():
    """The long path decodes what plain generate decodes; without a seq
    axis, or past max_seq_len, it raises as JAX's does."""
    _, _, tm, tp = models()
    _, tmesh = _meshes(2)
    sp = SamplingParams(max_new_tokens=6)
    ref = InferenceEngine(tm, tp).generate([PROMPT], sp)
    got = InferenceEngine(tm, tp, mesh=tmesh).generate_long(PROMPT, sp)
    assert np.array_equal(got.tokens[0], ref.tokens[0])
    with pytest.raises(ValueError, match="seq axis"):
        InferenceEngine(tm, tp).generate_long(PROMPT, sp)
    with pytest.raises(ValueError, match="max_seq_len"):
        InferenceEngine(tm, tp, mesh=tmesh).generate_long(
            PROMPT, SamplingParams(max_new_tokens=250))


def test_generate_long_stops_at_the_stop_token():
    """Tokens dispatched past a stop are discarded; lengths and the
    masked tail follow generate's rules."""
    _, _, tm, tp = models()
    _, tmesh = _meshes(2)
    eng = InferenceEngine(tm, tp, mesh=tmesh)
    free = eng.generate_long(PROMPT, SamplingParams(max_new_tokens=6))
    stop = int(free.tokens[0, 2])
    first = list(free.tokens[0]).index(stop)
    got = eng.generate_long(PROMPT, SamplingParams(max_new_tokens=6,
                                                   stop_token=stop))
    assert int(got.lengths[0]) == first + 1
    assert (got.tokens[0, first:] == stop).all()


# -- the serving lane ---------------------------------------------------------------

@pytest.mark.parametrize("kvq", ["none", "int8"])
def test_sp_prefill_chunk_matches_jax(kvq):
    """A 40-token prompt in two seq-parallel chunks (the second attends
    the pool prefix the first wrote): logits chunk by chunk, pool pages
    and lengths against JAX's engine."""
    jm, jp, tm, tp = models()
    jmesh, tmesh = _meshes(4)
    rt = dict(max_batch_size=2, page_size=16, max_seq_len=128, kv_quant=kvq)
    je = JServing(jm, jp, runtime=JRuntime(**rt), mesh=jmesh)
    te = ServingEngine(tm, tp, runtime=RuntimeConfig(**rt), mesh=tmesh)
    assert te.supports_seq_parallel and te.sp_degree == 4
    prompt = [int(t) for t in (np.arange(40) * 11 + 5) % 256]
    pages = [3, 0, 5]
    je.set_table_row(0, pages)
    te.set_table_row(0, pages)
    for lo, hi in ((0, 24), (24, 40)):
        want = je.sp_prefill_chunk(0, prompt[lo:hi], lo)
        got = te.sp_prefill_chunk(0, prompt[lo:hi], lo)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=3e-4,
                                   rtol=0)
    assert int(te.cache.lengths[0]) == 40
    jc = jax.device_get(je.cache)
    live = np.asarray(pages)
    if kvq == "int8":
        for a, b in ((te.cache.k_pages, jc.k_pages),
                     (te.cache.v_pages, jc.v_pages)):
            d = np.abs(_np(a)[:, live].astype(np.int32)
                       - np.asarray(b)[:, live].astype(np.int32))
            assert d.max() <= 1
        for a, b in ((te.cache.k_scale_pages, jc.k_scale_pages),
                     (te.cache.v_scale_pages, jc.v_scale_pages)):
            np.testing.assert_allclose(_np(a)[:, live], np.asarray(b)[:, live],
                                       rtol=1e-6, atol=0)
    else:
        for a, b in ((te.cache.k_pages, jc.k_pages),
                     (te.cache.v_pages, jc.v_pages)):
            np.testing.assert_allclose(_np(a)[:, live], np.asarray(b)[:, live],
                                       atol=1e-5, rtol=0)


LONG = [int(t) for t in (np.arange(100) * 7 + 3) % 256]
SHORT = [int(t) for t in (np.arange(12) * 5 + 1) % 256]


@pytest.mark.parametrize("mode,kvq", [
    ("alternating", "none"), ("alternating", "int8"), ("mixed", "none"),
    ("mixed", "int8"),
], ids=["alt-float", "alt-int8", "mixed-float", "mixed-int8"])
def test_scheduler_lane_matches_jax(mode, kvq):
    """A long prompt (above seq_parallel_threshold) through the
    scheduler's seq-parallel lane and a short one on the normal path,
    concurrently: token for token what the JAX scheduler with the lane
    emits, and the lane really prefilled."""
    jm, jp, tm, tp = models()
    jmesh, tmesh = _meshes(4)
    rt = dict(max_batch_size=2, page_size=16, max_seq_len=160, kv_quant=kvq,
              prefill_chunk=16, seq_parallel_threshold=64,
              mixed_dispatch=(mode == "mixed"))
    js = JScheduler(JServing(jm, jp, JRuntime(**rt), mesh=jmesh), seed=0)
    ts = Scheduler(ServingEngine(tm, tp, RuntimeConfig(**rt), mesh=tmesh),
                   seed=0)
    assert ts._sp_enabled and js._sp_enabled
    outs = []
    for s in (js, ts):
        r = s.submit(list(LONG), max_new_tokens=8, temperature=0.0)
        q = s.submit(list(SHORT), max_new_tokens=8, temperature=0.0)
        s.run_until_done()
        outs.append((r.output, q.output))
    assert outs[0] == outs[1]
    assert ts._c_sp_tokens.value == js._c_sp_tokens.value == len(LONG)
    assert ts.metrics()["seq_parallel_prefill_tokens_total"] == len(LONG)


def test_scheduler_threshold_without_mesh_warns_and_runs_dense():
    """As in JAX: a threshold with no seq axis warns and the long prompt
    takes the single-device chunk path."""
    _, _, tm, tp = models()
    rt = RuntimeConfig(max_batch_size=2, page_size=16, max_seq_len=160,
                       prefill_chunk=16, seq_parallel_threshold=64)
    eng = ServingEngine(tm, tp, rt)
    assert not eng.supports_seq_parallel and eng.sp_degree == 1
    with pytest.warns(RuntimeWarning, match="seq_parallel_threshold"):
        s = Scheduler(eng, seed=0)
    r = s.submit(list(LONG), max_new_tokens=4, temperature=0.0)
    s.run_until_done()
    assert len(r.output) == 4 and s._c_sp_tokens.value == 0


def test_engines_refuse_a_device_off_the_mesh():
    _, _, tm, tp = models()
    _, tmesh = _meshes(2)
    with pytest.raises(ValueError, match="first device"):
        ServingEngine(tm, tp, mesh=tmesh, device="cuda:1")


# -- the CLI ----------------------------------------------------------------------

def _cli(capsys, *argv):
    rc = cli.main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_generate_seq_parallel(capsys):
    """`generate --seq-parallel 2` (ring and Ulysses) prints what plain
    generate prints for the same random weights, and reports the degree."""
    base = ["generate", "--device", "cpu", "--prompt", "hello world",
            "--max-new", "6"]
    rc, ref, _ = _cli(capsys, *base)
    assert rc == 0
    for extra in (["--seq-parallel", "2"],
                  ["--seq-parallel", "2", "--seq-impl", "ulysses"]):
        rc, out, err = _cli(capsys, *base, *extra)
        assert rc == 0 and out == ref
        assert err.startswith("[butterfly] ") \
            and "over 2-way sequence parallelism" in err


def test_cli_refusals(capsys):
    rc, _, err = _cli(capsys, "generate", "--device", "cpu",
                      "--seq-parallel", "2", "--speculate", "2")
    assert rc == 2 and "--speculate does not compose" in err
    rc, _, err = _cli(capsys, "serve", "--device", "cpu",
                      "--seq-parallel-threshold", "64")
    assert rc == 2 and "needs a seq axis" in err
    with pytest.raises(NotImplementedError, match="tensor"):
        cli.main(["generate", "--device", "cpu", "--tensor-parallel", "2"])
    args = cli.build_parser().parse_args(
        ["generate", "--device", "cpu", "--seq-parallel", "3"])
    mesh = cli.build_mesh(args)
    assert mesh.shape["seq"] == 3 and mesh.seq_devices() == \
        [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        args = cli.build_parser().parse_args(["generate", "--seq-parallel",
                                              "2"])
        with pytest.raises(SystemExit, match="only 0 are available"):
            cli.build_mesh(args)
