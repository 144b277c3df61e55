"""PyTorch port: checkpoints against the JAX package on tiny models, f32.

Held exactly: the HF converters (`params_from_hf_state_dict`) of Llama
(untied and tied), GPT-2 and Mixtral against JAX's converted by the
bridge, leaf for leaf, and one forward's logits at 2e-5; `load_checkpoint`
from written directories (safetensors F32 and F16, two files,
pytorch_model.bin) against JAX's loader; BF16 files against JAX's loader
and against the same values stored as F32; the port's safetensors reader and writer against the `safetensors`
package; `config_from_hf_dir` field for field; the draft's vocabulary
check; `generate --ckpt` greedy tokens and `--quant int8 --ckpt` codes and
scales against the JAX CLI's `load_params`; `serve --ckpt --speculate 4
--draft-source model --draft-ckpt` against JAX's greedy scheduler;
`save_checkpoint` / `load_sharded` round trips, with and without a CPU
mesh (each shard as `shard_params` places it); serving snapshots (JSON
against JAX's, the continuation against the uninterrupted run, and a
worker process killed with SIGKILL after writing one).
"""
import contextlib
import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from butterfly_tpu.ckpt import load as JL
from butterfly_tpu.ckpt.sharded import save_serving_snapshot as jax_snapshot
from butterfly_tpu.core.config import RuntimeConfig as JRuntime
from butterfly_tpu.core.config import tiny
from butterfly_tpu.engine.engine import InferenceEngine as JInference
from butterfly_tpu.engine.sampling import SamplingParams as JSP
from butterfly_tpu.engine.serving import ServingEngine as JServing
from butterfly_tpu.models import common as J
from butterfly_tpu.sched.scheduler import Scheduler as JScheduler
from butterfly_tpu.serve import cli as jcli
from butterfly_tpu_torch.ckpt import load as TL
from butterfly_tpu_torch.ckpt import sharded as TS
from butterfly_tpu_torch.ckpt.safetensors_io import SafetensorsDir, save_file
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.core.config import MeshConfig
from butterfly_tpu_torch.core.mesh import make_mesh
from butterfly_tpu_torch.engine.engine import InferenceEngine
from butterfly_tpu_torch.engine.sampling import SamplingParams
from butterfly_tpu_torch.engine.serving import ServingEngine
from butterfly_tpu_torch.models import common as T
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.parallel.partition import Shards, shard_params
from butterfly_tpu_torch.quant.int8 import quantize_int8
from butterfly_tpu_torch.sched.scheduler import Scheduler
from butterfly_tpu_torch.serve import cli

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls

REPO = Path(__file__).resolve().parent.parent
TOL = 2e-5
F32 = dict(dtype="float32", param_dtype="float32")
ARCHS = ["llama", "llama_tied", "gpt2", "mixtral"]


def _cfgs(arch, **kw):
    fam = "llama" if arch == "llama_tied" else arch
    extra = dict(tie_embeddings=True) if arch == "llama_tied" else {}
    return (tiny(fam, **F32, **extra, **kw),
            tconfig.tiny(fam, **F32, **extra, **kw))


def hf_state_dict(cfg, seed=0, tied=False):
    """A seeded HF-layout state dict (numpy f32) for `cfg`'s family, at
    init-like scales so f32 logits stay small."""
    rng = np.random.RandomState(seed)
    D, Nq, Kv, H = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    F, V, L = cfg.intermediate_size, cfg.vocab_size, cfg.num_layers

    def w(*shape):
        return (0.05 * rng.randn(*shape)).astype(np.float32)

    def scale(n):
        return (1.0 + 0.1 * rng.randn(n)).astype(np.float32)

    if cfg.arch == "gpt2":
        sd = {"transformer.wte.weight": w(V, D),
              "transformer.wpe.weight": w(cfg.max_seq_len, D),
              "transformer.ln_f.weight": scale(D),
              "transformer.ln_f.bias": w(D)}
        for i in range(L):
            h = f"transformer.h.{i}."
            sd.update({h + "ln_1.weight": scale(D), h + "ln_1.bias": w(D),
                       h + "ln_2.weight": scale(D), h + "ln_2.bias": w(D),
                       h + "attn.c_attn.weight": w(D, 3 * D),
                       h + "attn.c_attn.bias": w(3 * D),
                       h + "attn.c_proj.weight": w(D, D),
                       h + "attn.c_proj.bias": w(D),
                       h + "mlp.c_fc.weight": w(D, F),
                       h + "mlp.c_fc.bias": w(F),
                       h + "mlp.c_proj.weight": w(F, D),
                       h + "mlp.c_proj.bias": w(D)})
        return sd
    sd = {"model.embed_tokens.weight": w(V, D), "model.norm.weight": scale(D)}
    if not tied:
        sd["lm_head.weight"] = w(V, D)
    for i in range(L):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": scale(D),
                   p + "post_attention_layernorm.weight": scale(D),
                   p + "self_attn.q_proj.weight": w(Nq * H, D),
                   p + "self_attn.k_proj.weight": w(Kv * H, D),
                   p + "self_attn.v_proj.weight": w(Kv * H, D),
                   p + "self_attn.o_proj.weight": w(D, Nq * H)})
        if cfg.arch == "mixtral":
            m = p + "block_sparse_moe."
            sd[m + "gate.weight"] = w(cfg.num_experts, D)
            for e in range(cfg.num_experts):
                sd.update({f"{m}experts.{e}.w1.weight": w(F, D),
                           f"{m}experts.{e}.w2.weight": w(D, F),
                           f"{m}experts.{e}.w3.weight": w(F, D)})
        else:
            sd.update({p + "mlp.gate_proj.weight": w(F, D),
                       p + "mlp.up_proj.weight": w(F, D),
                       p + "mlp.down_proj.weight": w(D, F)})
    return sd


def hf_config(cfg):
    """config.json for `cfg` in HF's keys (config_from_hf_dir's inverse)."""
    if cfg.arch == "gpt2":
        return {"model_type": "gpt2", "vocab_size": cfg.vocab_size,
                "n_embd": cfg.hidden_size, "n_layer": cfg.num_layers,
                "n_head": cfg.num_heads, "n_inner": cfg.intermediate_size,
                "n_positions": cfg.max_seq_len,
                "layer_norm_epsilon": cfg.norm_eps}
    out = {"model_type": cfg.arch, "vocab_size": cfg.vocab_size,
           "hidden_size": cfg.hidden_size,
           "num_hidden_layers": cfg.num_layers,
           "num_attention_heads": cfg.num_heads,
           "num_key_value_heads": cfg.num_kv_heads,
           "head_dim": cfg.head_dim,
           "intermediate_size": cfg.intermediate_size,
           "max_position_embeddings": cfg.max_seq_len,
           "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
           "tie_word_embeddings": cfg.tie_embeddings}
    if cfg.arch == "mixtral":
        out.update(num_local_experts=cfg.num_experts,
                   num_experts_per_tok=cfg.num_experts_per_tok)
    return out


def write_hf_dir(d, cfg, sd, fmt="f32"):
    """`sd` written as an HF checkpoint dir in format `fmt`."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(hf_config(cfg)))
    keys = sorted(sd)
    if fmt == "bin":
        torch.save({k: torch.from_numpy(sd[k]) for k in keys},
                   d / "pytorch_model.bin")
    elif fmt == "two_files":
        half = len(keys) // 2
        np_save_file({k: sd[k] for k in keys[:half]},
                     str(d / "model-00001-of-00002.safetensors"))
        np_save_file({k: sd[k] for k in keys[half:]},
                     str(d / "model-00002-of-00002.safetensors"))
    else:
        dt = {"f32": np.float32, "f16": np.float16}[fmt]
        np_save_file({k: sd[k].astype(dt) for k in keys},
                     str(d / "model.safetensors"))
    return str(d)


@contextlib.contextmanager
def listening(sched):
    """The scheduler behind an HTTP server on a free local port."""
    from http.server import ThreadingHTTPServer

    from butterfly_tpu_torch.serve.server import ServerState, make_handler
    from butterfly_tpu_torch.utils.tokenizer import ByteTokenizer
    state = ServerState(sched, ByteTokenizer())
    state.thread.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_port}"
    finally:
        state.stop.set()
        httpd.shutdown()
        httpd.server_close()
        state.thread.join(timeout=30)


def _bridge(jtree):
    return params_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")


def assert_same_tree(got, want, path=""):
    """Same keys, shapes, dtypes, devices and values, Shards alike."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, Shards):
        assert isinstance(got, Shards), path
        assert (got.axis, got.split, len(got.parts)) == \
            (want.axis, want.split, len(want.parts)), path
        for a, b in zip(got.parts, want.parts):
            assert_same_tree(a, b, path)
    else:
        assert tuple(got.shape) == tuple(want.shape), path
        assert got.dtype == want.dtype and got.device == want.device, path
        assert torch.equal(got, want), path


# -- the HF converters ------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_hf_import_matches_jax(arch):
    cfg, tcfg = _cfgs(arch)
    sd = hf_state_dict(cfg, seed=1, tied=arch == "llama_tied")
    if cfg.arch == "gpt2":
        from butterfly_tpu.models.gpt2 import params_from_hf_state_dict as jf
        from butterfly_tpu_torch.models.gpt2 import \
            params_from_hf_state_dict as tf
    elif cfg.arch == "mixtral":
        from butterfly_tpu.models.mixtral import \
            params_from_hf_state_dict as jf
        from butterfly_tpu_torch.models.mixtral import \
            params_from_hf_state_dict as tf
    else:
        from butterfly_tpu.models.llama import params_from_hf_state_dict as jf
        from butterfly_tpu_torch.models.llama import \
            params_from_hf_state_dict as tf
    jp = jf(sd, cfg)
    tp = tf({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg,
            device="cpu")
    assert_same_tree(tp, _bridge(jp))
    toks = np.random.RandomState(2).randint(1, cfg.vocab_size, (2, 6))
    jl, _ = J.forward(jp, cfg, jnp.asarray(toks, jnp.int32),
                      J.init_cache(cfg, batch=2, max_seq=16))
    tl, _ = T.forward(tp, tcfg, torch.from_numpy(toks.astype(np.int32)),
                      T.init_cache(tcfg, 2, 16, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)


# -- load_checkpoint from a directory --------------------------------------------

@pytest.mark.parametrize("arch,fmt", [("llama", "f32"), ("llama", "f16"),
                                      ("llama", "two_files"),
                                      ("llama", "bin"), ("gpt2", "two_files"),
                                      ("mixtral", "two_files")])
def test_load_checkpoint_matches_jax_loader(tmp_path, arch, fmt):
    cfg, tcfg = _cfgs(arch)
    d = write_hf_dir(tmp_path / "ck", cfg, hf_state_dict(cfg, seed=3), fmt)
    assert_same_tree(TL.load_checkpoint(d, tcfg, device="cpu"),
                     _bridge(JL.load_checkpoint(d, cfg)))


def test_bf16_files_load_as_the_reference_and_as_f32(tmp_path):
    """BF16 safetensors (every published Llama-3 / Mixtral checkpoint) load
    to the JAX loader's leaves (its numpy reader takes bfloat16 because
    importing the JAX package registers ml_dtypes' bfloat16 with numpy),
    and to the same leaves as the same values stored as F32, in f32 and
    in bf16 compute."""
    from safetensors.torch import save_file as torch_save_file
    cfg, tcfg = _cfgs("llama")
    sd = {k: torch.from_numpy(v).to(torch.bfloat16)
          for k, v in hf_state_dict(cfg, seed=4).items()}
    for name, conv in (("bf16", lambda t: t), ("f32", lambda t: t.float())):
        (tmp_path / name).mkdir()
        (tmp_path / name / "config.json").write_text(json.dumps(hf_config(cfg)))
        torch_save_file({k: conv(v) for k, v in sd.items()},
                        str(tmp_path / name / "model.safetensors"))
    bf16_dir = str(tmp_path / "bf16")
    assert_same_tree(TL.load_checkpoint(bf16_dir, tcfg, device="cpu"),
                     _bridge(JL.load_checkpoint(bf16_dir, cfg)))
    for c in (tcfg, tcfg.replace(dtype="bfloat16")):
        a = TL.load_checkpoint(bf16_dir, c, device="cpu")
        assert_same_tree(a, TL.load_checkpoint(str(tmp_path / "f32"), c,
                                               device="cpu"))
    assert a["layers"]["attn"]["wq"].dtype == torch.bfloat16


def test_missing_checkpoint_raises_as_the_reference(tmp_path):
    _, tcfg = _cfgs("llama")
    with pytest.raises(FileNotFoundError, match="checkpoint dir not found"):
        TL.load_checkpoint(str(tmp_path / "nope"), tcfg, device="cpu")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no \\*.safetensors"):
        TL.load_checkpoint(str(tmp_path / "empty"), tcfg, device="cpu")


# -- the safetensors reader and writer --------------------------------------------

def _mixed_tensors(seed):
    rng = np.random.RandomState(seed)
    return {"f32": torch.from_numpy(rng.randn(3, 5).astype(np.float32)),
            "f16": torch.from_numpy(rng.randn(7).astype(np.float16)),
            "bf16": torch.from_numpy(rng.randn(2, 3, 4).astype(np.float32))
            .to(torch.bfloat16),
            "i8": torch.from_numpy(rng.randint(-127, 128, (4, 4))
                                   .astype(np.int8)),
            "u8": torch.from_numpy(rng.randint(0, 256, (5,)).astype(np.uint8)),
            "scalar": torch.tensor(1.5),
            "empty": torch.zeros(0, 3)}


def test_reader_matches_the_safetensors_package(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import load_file, save_file as torch_save_file
    a = _mixed_tensors(0)
    b = {"second." + k: v for k, v in _mixed_tensors(1).items()}
    torch_save_file(a, str(tmp_path / "model-00001-of-00002.safetensors"),
                    metadata={"format": "pt", "note": "one"})
    torch_save_file(b, str(tmp_path / "model-00002-of-00002.safetensors"))
    files = sorted(tmp_path.glob("*.safetensors"))
    got = SafetensorsDir(files)
    want = {}
    for f in files:
        want.update(load_file(str(f)))
    assert sorted(got) == sorted(want) and len(got) == len(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    with safe_open(str(files[0]), framework="np") as h:
        assert h.metadata()["note"] == "one"   # a header the reader skips
    # and the package's numpy reader (bfloat16 compared by its bits)
    from safetensors.numpy import load_file as np_load_file
    for k, v in np_load_file(str(files[1])).items():
        g = got[k]
        if g.dtype == torch.bfloat16:
            g, v = g.view(torch.int16), v.view(np.int16)
        assert np.array_equal(g.numpy(), v), k


def test_writer_is_read_by_the_safetensors_package(tmp_path):
    from safetensors.torch import load_file
    t = _mixed_tensors(2)
    save_file(t, tmp_path / "w.safetensors")
    back = load_file(str(tmp_path / "w.safetensors"))
    assert sorted(back) == sorted(t)
    for k, v in t.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


# -- config.json and the draft --------------------------------------------------

@pytest.mark.parametrize("arch", ["llama", "gpt2", "mixtral", "defaults"])
def test_config_from_hf_dir_matches_jax(tmp_path, arch):
    if arch == "defaults":   # only the required keys: every default applies
        cj = {"vocab_size": 300, "hidden_size": 64, "num_hidden_layers": 3,
              "num_attention_heads": 8, "intermediate_size": 96}
    else:
        cj = hf_config(_cfgs(arch)[0])
    (tmp_path / "config.json").write_text(json.dumps(cj))
    assert dataclasses.asdict(TL.config_from_hf_dir(str(tmp_path))) == \
        dataclasses.asdict(JL.config_from_hf_dir(str(tmp_path)))


def test_draft_vocabulary_check_matches_jax(tmp_path):
    cfg, tcfg = _cfgs("llama")
    dcfg = tiny("llama", vocab_size=100, num_layers=1, **F32)
    d = write_hf_dir(tmp_path, dcfg, hf_state_dict(dcfg))
    with pytest.raises(ValueError) as want:
        JL.load_draft_checkpoint(d, cfg)
    with pytest.raises(ValueError) as got:
        TL.load_draft_checkpoint(d, tcfg, device="cpu")
    assert str(got.value) == str(want.value)
    assert "vocab 100 != target vocab 258" in str(got.value)
    ok = write_hf_dir(tmp_path / "ok", dcfg.replace(vocab_size=258),
                      hf_state_dict(dcfg.replace(vocab_size=258)))
    c, p = TL.load_draft_checkpoint(ok, tcfg, device="cpu")
    jc, jp = JL.load_draft_checkpoint(ok, cfg)
    assert dataclasses.asdict(c) == dataclasses.asdict(jc)
    assert_same_tree(p, params_from_numpy(jax.tree.map(np.asarray, jp),
                                          device="cpu", dtype=torch.bfloat16))


# -- the CLI on a checkpoint ------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A tiny-llama HF dir (the CLI's --model tiny geometry)."""
    cfg, _ = _cfgs("llama")
    return write_hf_dir(tmp_path_factory.mktemp("tiny_ckpt"), cfg,
                        hf_state_dict(cfg, seed=5), "two_files")


def test_generate_ckpt_matches_the_jax_cli(tiny_ckpt, capsys):
    argv = ["generate", "--model", "tiny", "--ckpt", tiny_ckpt,
            "--prompt", "hello", "--max-new", "10"]
    jargs = jcli.build_parser().parse_args(argv)
    jmodel = jcli.resolve_model(jargs)
    ids = [256] + list(b"hello")
    want = JInference(jmodel, jcli.load_params(jmodel, jargs)).generate(
        [ids], JSP(max_new_tokens=10, stop_token=-1)).tokens[0].tolist()
    args = cli.build_parser().parse_args(argv + ["--device", "cpu"])
    model = cli.resolve_model(args)
    got = InferenceEngine(model, cli.load_params(model, args)).generate(
        [ids], SamplingParams(max_new_tokens=10, stop_token=-1))
    assert np.asarray(got.tokens)[0].tolist() == want
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    # the CLI stops at the tokenizer's EOS (257): the text is the bytes
    # of the greedy tokens up to it
    n = want.index(257) if 257 in want else len(want)
    assert out.rstrip("\n") == bytes(t for t in want[:n] if t < 256) \
        .decode("utf-8", errors="replace")


def test_quant_int8_ckpt_codes_match_jax(tiny_ckpt):
    argv = ["generate", "--model", "tiny", "--ckpt", tiny_ckpt,
            "--quant", "int8"]
    jargs = jcli.build_parser().parse_args(argv)
    jq = jcli.load_params(jcli.resolve_model(jargs), jargs)
    args = cli.build_parser().parse_args(argv + ["--device", "cpu"])
    model = cli.resolve_model(args)
    got = cli.load_params(model, args)
    assert got["layers"]["attn"]["wq"]["q8"].dtype == torch.int8
    assert_same_tree(got, _bridge(jq))
    assert_same_tree(got, quantize_int8(
        TL.load_checkpoint(tiny_ckpt, model.cfg, device="cpu"), model.cfg))


@pytest.mark.parametrize("mesh", [[], ["--tensor-parallel", "2"]],
                         ids=["one-device", "tensor2"])
def test_serve_ckpt_with_draft_ckpt_answers_as_jax(tiny_ckpt, tmp_path, mesh):
    """`serve --ckpt T --speculate 4 --draft-source model --draft-ckpt D`
    builds and answers, unsharded and on a tensor = 2 CPU mesh (the draft
    placed like the target); greedy speculation emits the target's greedy
    tokens, which are JAX's scheduler's on the same checkpoint."""
    from butterfly_tpu_torch.serve.server import build_serving
    from butterfly_tpu_torch.utils.tokenizer import ByteTokenizer
    dcfg = tiny("llama", num_layers=1, hidden_size=32, num_heads=2,
                num_kv_heads=1, intermediate_size=64, **F32)
    draft = write_hf_dir(tmp_path / "draft", dcfg, hf_state_dict(dcfg, 6))
    args = cli.build_parser().parse_args(
        ["serve", "--model", "tiny", "--device", "cpu", "--max-seq", "128",
         "--port", "0", "--timeseries-interval", "0", "--ckpt", tiny_ckpt,
         "--speculate", "4", "--draft-source", "model", "--draft-ckpt",
         draft] + mesh)
    sched, tok, rt = build_serving(args)
    src = sched.engine._draft_src
    assert src.cfg.num_layers == 1 and src.cfg.hidden_size == 32
    assert src.params["final_norm"]["scale"].dtype == torch.bfloat16
    with listening(sched) as url:
        req = urllib.request.Request(
            url + "/generate", data=json.dumps(
                {"prompt": "abcabcabc", "max_tokens": 12,
                 "stop_token": -1}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
    assert sched.metrics()["spec_forwards_total"] > 0
    cfg, _ = _cfgs("llama")
    js = JScheduler(JServing(J.Model(cfg), JL.load_checkpoint(tiny_ckpt, cfg),
                             JRuntime(max_batch_size=2, max_seq_len=128,
                                      page_size=16), use_kernels=False))
    req = js.submit(ByteTokenizer().encode("abcabcabc"), max_new_tokens=12,
                    stop_token=-1)
    js.run_until_done()
    assert out["tokens"] == req.output and tok.decode(req.output) == \
        out["text"]


# -- the port's own checkpoints ---------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_save_load_round_trip(tmp_path, quant):
    _, tcfg = _cfgs("llama")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = T.init_params(tcfg, gen, "cpu")
    if quant:
        params = quantize_int8(params, tcfg)
    TS.save_checkpoint(str(tmp_path / "ck"), params, tcfg, step=7)
    cfg2, step = TS.load_config(str(tmp_path / "ck"))
    assert step == 7 and cfg2 == tcfg
    assert_same_tree(TS.load_sharded(str(tmp_path / "ck"), cfg2,
                                     device="cpu"), params)


@pytest.mark.parametrize("arch,axes", [("llama", dict(tensor=2)),
                                       ("llama", dict(tensor=2, data=2)),
                                       ("mixtral", dict(expert=2)),
                                       ("mixtral", dict(tensor=2))],
                         ids=["llama-t2", "llama-t2d2", "mixtral-e2",
                              "mixtral-t2"])
def test_load_sharded_places_as_shard_params(tmp_path, arch, axes):
    _, tcfg = _cfgs(arch)
    gen = torch.Generator()
    gen.manual_seed(1)
    params = T.init_params(tcfg, gen, "cpu")
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(MeshConfig(**axes), ["cpu"] * n)
    sharded = shard_params(params, tcfg, mesh)
    # a tree saved from its mesh placement is the whole tree
    TS.save_checkpoint(str(tmp_path / "ck"), sharded, tcfg)
    assert_same_tree(TS.load_sharded(str(tmp_path / "ck"), tcfg,
                                     device="cpu"), params)
    got = TS.load_sharded(str(tmp_path / "ck"), tcfg, mesh)
    assert_same_tree(got, sharded)


# -- serving snapshots ------------------------------------------------------------

SNAP_RT = dict(max_batch_size=2, max_seq_len=64, page_size=8)


def test_serving_snapshot_matches_jax_and_continues(tmp_path):
    cfg, tcfg = _cfgs("llama")
    jp = J.Model(cfg).init(jax.random.PRNGKey(42))
    tp = _bridge(jp)
    jsched = JScheduler(JServing(J.Model(cfg), jp, JRuntime(**SNAP_RT),
                                 use_kernels=False))
    tsched = Scheduler(ServingEngine(T.Model(tcfg, device="cpu"), tp,
                                     tconfig.RuntimeConfig(**SNAP_RT)))
    reqs = []
    for s in (jsched, tsched):
        r1 = s.submit([5, 7, 11], max_new_tokens=8)
        s.submit([3, 1, 4, 1, 5], max_new_tokens=6, temperature=0.0,
                 stop_token=9)
        for _ in range(3):
            s.tick()
        reqs.append(r1)
    n_done = len(reqs[1].output)
    assert 0 < n_done < 8
    jax_snapshot(str(tmp_path / "jax.json"), jsched)
    TS.save_serving_snapshot(str(tmp_path / "port.json"), tsched)
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "jax.json").read_text())

    # a "crashed" server: a fresh scheduler on the same weights
    fresh = Scheduler(ServingEngine(T.Model(tcfg, device="cpu"), tp,
                                    tconfig.RuntimeConfig(**SNAP_RT)))
    assert TS.restore_serving_snapshot(str(tmp_path / "port.json"),
                                       fresh) == 2
    req = fresh.waiting[0]
    fresh.run_until_done()
    full = InferenceEngine(T.Model(tcfg, device="cpu"), tp).generate(
        [[5, 7, 11]], SamplingParams(max_new_tokens=8)).tokens[0].tolist()
    assert reqs[1].output + req.output == full


WORKER = r"""
import os, sys, time
import torch
from butterfly_tpu_torch.ckpt.sharded import save_serving_snapshot
from butterfly_tpu_torch.core.config import RuntimeConfig, tiny
from butterfly_tpu_torch.engine.serving import ServingEngine
from butterfly_tpu_torch.models.common import Model, init_params
from butterfly_tpu_torch.sched.scheduler import Scheduler

torch.set_num_threads(1)
cfg = tiny("llama", dtype="float32", param_dtype="float32")
gen = torch.Generator()
gen.manual_seed(42)
rt = RuntimeConfig(max_batch_size=2, max_seq_len=64, page_size=8,
                   prefill_chunk=2)  # a request mid-chunked-prefill too
sched = Scheduler(ServingEngine(Model(cfg, device="cpu"),
                                init_params(cfg, gen, "cpu"), rt))
for prompt, n in ([5, 7, 11], 12), ([3, 1], 10), ([2, 4, 6, 8, 10, 12], 8):
    sched.submit(prompt, max_new_tokens=n)
for _ in range(4):
    sched.tick()
assert sched.has_work, "drained before the crash point"
save_serving_snapshot(sys.argv[1] + ".tmp", sched)
os.replace(sys.argv[1] + ".tmp", sys.argv[1])  # atomic publish
while True:  # the parent kills this process here, mid-flight
    time.sleep(0.1)
"""


def test_killed_process_recovers_from_its_snapshot(tmp_path):
    """SIGKILL a serving process after it wrote a snapshot; a fresh
    scheduler restored from it finishes every request with the tokens of
    an uninterrupted run."""
    snap = tmp_path / "serving_snapshot.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-c", WORKER, str(snap)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            env=env, text=True)
    try:
        deadline = time.monotonic() + 120
        while not snap.exists():
            assert proc.poll() is None, \
                f"worker died early:\n{proc.communicate()[0]}"
            assert time.monotonic() < deadline, "snapshot never appeared"
            time.sleep(0.1)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    assert proc.returncode == -signal.SIGKILL

    data = json.loads(snap.read_text())
    assert len(data["requests"]) == 3
    partial = {tuple(r["prompt"]): r["output"] for r in data["requests"]}
    _, tcfg = _cfgs("llama")
    gen = torch.Generator()
    gen.manual_seed(42)
    params = T.init_params(tcfg, gen, "cpu")
    rt = tconfig.RuntimeConfig(**SNAP_RT)
    sched = Scheduler(ServingEngine(T.Model(tcfg, device="cpu"), params, rt))
    assert TS.restore_serving_snapshot(str(snap), sched) == 3
    recovered = {tuple(r.prompt): r for r in sched.waiting}
    sched.run_until_done()
    ref = Scheduler(ServingEngine(T.Model(tcfg, device="cpu"), params, rt))
    specs = [([5, 7, 11], 12), ([3, 1], 10), ([2, 4, 6, 8, 10, 12], 8)]
    ref_reqs = [ref.submit(p, max_new_tokens=m) for p, m in specs]
    ref.run_until_done()
    for (prompt, _), want in zip(specs, ref_reqs):
        pre = partial[tuple(prompt)]
        rec = recovered[tuple(prompt) + tuple(pre)]
        assert rec.state == "finished"
        assert pre + rec.output == want.output, prompt
