"""PyTorch port: mesh-aware serving (tests/test_serving_mesh.py's
counterparts; the stage tests are tests/test_torch_pipeline.py's) against
the JAX package, float32.

A Scheduler over a ServingEngine on a tensor = 4 x data = 2 mesh (every
shard on `cpu`) must produce the JAX package's greedy tokens exactly,
end to end through HTTP: its scheduler's on the same mesh of fake CPU
devices, or its unmeshed run's (tests/test_serving_mesh.py holds the
two equal). The pools split over the kv heads, the block table stays on
the host; prefix caching, the kernels' path (their plain versions on the
CPU), n-gram speculation, Kv = 2 < tensor = 4 and flash prefill in
`generate` ride the mesh. Pages read from a tensor-sharded
engine come back in the unsharded layout, byte for byte, so replicas
with and without --tensor-parallel exchange KV.
"""
import argparse
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from butterfly_tpu.cache.prefix import chain_block_hashes
from butterfly_tpu.core.config import RuntimeConfig as JRuntime, tiny
from butterfly_tpu.engine.engine import InferenceEngine as JInference
from butterfly_tpu.engine.sampling import SamplingParams as JSampling
from butterfly_tpu.engine.serving import ServingEngine as JEngine
from butterfly_tpu.models.common import Model as JModel
from butterfly_tpu.sched.scheduler import Scheduler as JScheduler
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.core.mesh import make_mesh
from butterfly_tpu_torch.engine.engine import InferenceEngine
from butterfly_tpu_torch.engine.sampling import SamplingParams
from butterfly_tpu_torch.engine.serving import ServingEngine
from butterfly_tpu_torch.fleet import kvtransfer as TK
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.models.common import Model
from butterfly_tpu_torch.parallel.partition import Shards
from butterfly_tpu_torch.sched.scheduler import Scheduler
from butterfly_tpu_torch.serve import cli

torch.set_num_threads(1)

F32 = dict(dtype="float32", param_dtype="float32")
# kv-heads divisible by tensor = 4 so the pool actually splits
SHAPE = dict(num_heads=8, num_kv_heads=4, head_dim=8, **F32)
PROMPTS = [[5, 7, 11], [3, 1], [2, 4, 6, 8], [9]]


def _rt(mod, **kw):
    return mod(**{**dict(max_batch_size=4, max_seq_len=64, page_size=8),
                  **kw})


def _mesh(**axes):
    mc = tconfig.MeshConfig(**axes)
    return make_mesh(mc, ["cpu"] * mc.num_devices)


_W = {}


def weights(seed=42, **kw):
    """(JAX tree, bridged port tree) of tiny llama with SHAPE + kw."""
    key = (seed, tuple(sorted(kw.items())))
    if key not in _W:
        jp = JModel(tiny("llama", **{**SHAPE, **kw})).init(
            jax.random.PRNGKey(seed))
        _W[key] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu"))
    return _W[key]


def _cfg(**kw):
    return tconfig.tiny("llama", **{**SHAPE, **kw})


def _port_sched(tp, mesh=None, cfg=None, **kw):
    cfg = cfg or _cfg()
    use_kernels = kw.pop("use_kernels", None)
    return Scheduler(ServingEngine(Model(cfg, device="cpu"), tp,
                                   _rt(tconfig.RuntimeConfig, **kw),
                                   mesh=mesh, use_kernels=use_kernels))


def _drive(sched, prompts=PROMPTS, n=6):
    reqs = [sched.submit(p, max_new_tokens=n) for p in prompts]
    sched.run_until_done()
    return [r.output for r in reqs]


@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX scheduler's greedy tokens on its data = 2 x tensor = 4 mesh
    of fake CPU devices (test_serving_mesh.py holds them equal to its
    unmeshed run)."""
    from butterfly_tpu.core.config import MeshConfig as JMeshConfig
    from butterfly_tpu.core.mesh import make_mesh as jmake_mesh
    jp, _ = weights()
    mesh = jmake_mesh(JMeshConfig(data=2, tensor=4), jax.devices()[:8])
    sched = JScheduler(JEngine(JModel(tiny("llama", **SHAPE)), jp,
                               _rt(JRuntime), mesh=mesh))
    return _drive(sched)


def test_meshed_scheduler_token_parity(jax_tokens):
    _, tp = weights()
    sched = _port_sched(tp, _mesh(data=2, tensor=4))
    assert _drive(sched) == jax_tokens


def test_meshed_scheduler_kernels_token_parity(jax_tokens):
    """The kernels' path (use_kernels: the sharded wrappers, each shard's
    plain version on the CPU), mixed and alternating dispatch."""
    _, tp = weights()
    for mixed in (True, False):
        sched = _port_sched(tp, _mesh(data=2, tensor=4), use_kernels=True,
                            mixed_dispatch=mixed)
        assert _drive(sched) == jax_tokens, mixed


def test_meshed_kernels_gqa_kv_smaller_than_tensor():
    """num_kv_heads = 2 < tensor = 4 (page 8 IS tensor-divisible): the
    pool stays replicated, the kernels run once over every head, and the
    tokens equal the unmeshed JAX engine's."""
    jp, tp = weights(7, num_kv_heads=2)
    jsched = JScheduler(JEngine(JModel(tiny("llama", **{**SHAPE,
                                                        "num_kv_heads": 2})),
                                jp, _rt(JRuntime)))
    want = _drive(jsched)
    sched = _port_sched(tp, _mesh(data=2, tensor=4),
                        cfg=_cfg(num_kv_heads=2), use_kernels=True)
    assert isinstance(sched.engine.cache.k_pages, torch.Tensor)
    assert isinstance(sched.engine.params["layers"]["attn"]["wq"], Shards)
    assert _drive(sched) == want


def test_meshed_engine_flash_prefill_token_parity():
    """InferenceEngine.generate, flash prefill per shard on the mesh (the
    fused loop, the stepped loop, the int8 KV window loop), against the
    unmeshed JAX engine."""
    jp, tp = weights()
    sp = JSampling(max_new_tokens=6)
    want = JInference(JModel(tiny("llama", **SHAPE)), jp,
                      use_flash_prefill=False).generate(PROMPTS, sp).tokens
    mesh = _mesh(data=2, tensor=4)
    for kvq, fused in (("none", True), ("none", False), ("int8", True)):
        eng = InferenceEngine(Model(_cfg(), device="cpu"), tp,
                              tconfig.RuntimeConfig(kv_quant=kvq), mesh=mesh,
                              use_flash_prefill=True)
        got = eng.generate(PROMPTS[:3], SamplingParams(max_new_tokens=6),
                           fused=fused).tokens
        if kvq == "none":
            np.testing.assert_array_equal(got, np.asarray(want)[:3])
        else:
            ref = InferenceEngine(Model(_cfg(), device="cpu"), tp,
                                  tconfig.RuntimeConfig(kv_quant=kvq))
            np.testing.assert_array_equal(got, ref.generate(
                PROMPTS[:3], SamplingParams(max_new_tokens=6)).tokens)


def test_meshed_pool_is_sharded():
    _, tp = weights()
    eng = ServingEngine(Model(_cfg(), device="cpu"), tp,
                        _rt(tconfig.RuntimeConfig),
                        mesh=_mesh(data=2, tensor=4))
    kp = eng.cache.k_pages
    assert isinstance(kp, Shards) and kp.axis == "tensor" and kp.split == 2
    assert len(kp.parts) == 4 and all(p.shape[2] == 1 for p in kp.parts)
    assert all(p.is_contiguous() for p in kp.parts)
    # the block table stays on the host (and one device tensor)
    assert isinstance(eng.cache.page_table, torch.Tensor)
    eng._ensure_window(4)
    w = eng._kv_window.k
    assert w.axis == "data" and w.split == 1 and len(w.parts) == 2
    assert w.parts[0].axis == "tensor" and w.parts[0].parts[0].shape[1] == 2


def test_http_generate_on_mesh(jax_tokens):
    from http.server import ThreadingHTTPServer

    from butterfly_tpu_torch.serve.server import ServerState, make_handler
    from butterfly_tpu_torch.utils.tokenizer import ByteTokenizer
    _, tp = weights()
    state = ServerState(_port_sched(tp, _mesh(data=2, tensor=4)),
                        ByteTokenizer())
    state.thread.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    try:
        req = urllib.request.Request(
            url + "/generate",
            data=json.dumps({"tokens": PROMPTS[0], "max_tokens": 5,
                             "stop_token": -1}).encode(),
            headers={"Content-Type": "application/json"})
        out = json.loads(urllib.request.urlopen(req, timeout=300).read())
        assert out["tokens"] == jax_tokens[0][:5]
    finally:
        state.stop.set()
        httpd.shutdown()
        httpd.server_close()


def test_cli_build_mesh_flags(capsys):
    args = argparse.Namespace(tensor_parallel=4, stage_parallel=1,
                              expert_parallel=1, data_parallel=2,
                              device="cpu")
    mesh = cli.build_mesh(args)
    assert mesh.shape["tensor"] == 4 and mesh.shape["data"] == 2
    assert mesh.tensor_devices(1) == [torch.device("cpu")] * 4
    args1 = argparse.Namespace(tensor_parallel=1, stage_parallel=1,
                               expert_parallel=1, data_parallel=1,
                               device="cpu")
    assert cli.build_mesh(args1) is None
    # generate and bench take the flags on the CPU; the text is the
    # unmeshed run's
    base = ["generate", "--model", "tiny", "--device", "cpu", "--prompt",
            "hello", "--max-new", "6"]
    assert cli.main(base) == 0
    want = capsys.readouterr().out
    assert cli.main(base + ["--tensor-parallel", "2",
                            "--data-parallel", "2"]) == 0
    assert capsys.readouterr().out == want
    assert cli.main(["bench", "--model", "tiny", "--device", "cpu",
                     "--tensor-parallel", "2", "--batch", "2",
                     "--prompt-len", "16", "--max-new", "4"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] > 0 and line["n_chips"] == 1


def test_stage_parallel_still_refused(capsys):
    """--stage-parallel runs (the text of the unmeshed run, with tensor
    and data inside the stages too), and with expert inside them: no
    stage mesh is refused any more."""
    base = ["generate", "--model", "tiny", "--device", "cpu", "--prompt",
            "hello", "--max-new", "6"]
    assert cli.main(base) == 0
    want = capsys.readouterr().out
    assert cli.main(base + ["--stage-parallel", "2", "--tensor-parallel",
                            "2", "--data-parallel", "2"]) == 0
    assert capsys.readouterr().out == want
    assert cli.main(base + ["--stage-parallel", "2", "--expert-parallel",
                            "2", "--data-parallel", "2"]) == 0
    assert capsys.readouterr().out == want


def test_prefix_hits_on_data_tensor_mesh():
    """Shared prefix pages + split pools and data groups compose: a
    cache-hitting admission on the meshed engine is token-exact with
    cold admission on the unmeshed JAX one (the port's counterpart of
    test_prefix.py::test_prefix_caching_on_data_tensor_mesh)."""
    jp, tp = weights(0)
    prompt = list(range(1, 20))
    seqs = (prompt, prompt, prompt[:9])

    def run_one(s, p):
        r = s.submit(p, max_new_tokens=4)
        s.run_until_done()
        return r.output
    rt = dict(max_seq_len=128, prefix_caching=True)
    plain = JScheduler(JEngine(JModel(tiny("llama", **SHAPE)), jp,
                               _rt(JRuntime, max_seq_len=128)))
    want = [run_one(plain, p) for p in seqs]
    s = _port_sched(tp, _mesh(data=2, tensor=4), **rt)
    assert [run_one(s, p) for p in seqs] == want
    assert s.alloc.hit_tokens >= 16
    assert isinstance(s.engine.cache.k_pages, Shards)


def _hexes(prompt, page=8):
    return [h.hex() for h in chain_block_hashes(prompt, page)]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_pages_cross_between_sharded_and_unsharded(kv_quant):
    """read_pages / write_pages and the /kv/pages payload of a tensor = 2
    engine are the unsharded engine's bytes: pages exported by an
    unsharded replica, imported into a tensor = 2 one and exported again
    come out byte for byte; pages a tensor = 2 replica computed import
    into an unsharded one, which reads the same bytes and continues
    token-exact."""
    _, tp = weights()
    prompt = list(range(1, 33))                    # 4 full pages
    hexes = _hexes(prompt)
    kw = dict(max_seq_len=128, prefix_caching=True, kv_quant=kv_quant)
    a = _port_sched(tp, **kw)
    first = _drive(a, [prompt], 1)[0]
    pa = TK.export_payload(a, hexes)
    b = _port_sched(tp, _mesh(tensor=2), **kw)
    assert TK.import_payload(b, pa)["imported"] == 4
    pb = TK.export_payload(b, hexes)
    assert json.dumps(pb, sort_keys=True) == json.dumps(pa, sort_keys=True)
    pids_a = [a.alloc.lookup(bytes.fromhex(h)) for h in hexes]
    pids_b = [b.alloc.lookup(bytes.fromhex(h)) for h in hexes]
    for x, y in zip(a.engine.read_pages(pids_a),
                    b.engine.read_pages(pids_b)):
        assert (x is None and y is None) or torch.equal(x, y)
    # each shard's pool holds its kv heads of the page
    k_a = a.engine.read_pages(pids_a)[0]
    for t, part in enumerate(b.engine.cache.k_pages.parts):
        assert torch.equal(part[:, pids_b], k_a[:, :, 2 * t:2 * t + 2])
    # the other way: the sharded replica computes, the unsharded imports
    c = _port_sched(tp, _mesh(tensor=2), **kw)
    first_c = _drive(c, [prompt], 1)[0]
    assert first_c == first
    pc = TK.export_payload(c, hexes)
    d = _port_sched(tp, **kw)
    assert TK.import_payload(d, pc)["imported"] == 4
    pids_c = [c.alloc.lookup(bytes.fromhex(h)) for h in hexes]
    pids_d = [d.alloc.lookup(bytes.fromhex(h)) for h in hexes]
    for x, y in zip(c.engine.read_pages(pids_c),
                    d.engine.read_pages(pids_d)):
        assert (x is None and y is None) or torch.equal(x, y)
    rest = _drive(d, [prompt + first_c], 5)[0]
    assert d.alloc.hit_tokens == 32
    assert first + rest == _drive(_port_sched(tp, **kw), [prompt], 6)[0]


def test_ngram_speculation_on_tensor_mesh(jax_tokens):
    """Prompt-lookup speculation (the spec blocks' verify forwards) on a
    tensor = 4 mesh, and generate_speculative on it: the greedy tokens of
    plain decoding; a data axis refuses generate_speculative, as in
    JAX."""
    _, tp = weights()
    sched = _port_sched(tp, _mesh(tensor=4), speculative_gamma=3)
    assert _drive(sched) == jax_tokens
    eng = InferenceEngine(Model(_cfg(), device="cpu"), tp,
                          mesh=_mesh(tensor=4))
    res = eng.generate_speculative(PROMPTS[2] * 3, SamplingParams(
        max_new_tokens=6), gamma=3)
    ref = InferenceEngine(Model(_cfg(), device="cpu"), tp).generate(
        [PROMPTS[2] * 3], SamplingParams(max_new_tokens=6)).tokens[0]
    assert res.tokens.tolist() == ref.tolist()
    with pytest.raises(NotImplementedError, match="tensor/expert"):
        InferenceEngine(Model(_cfg(), device="cpu"), tp,
                        mesh=_mesh(data=2)).generate_speculative([1, 2, 3])
