"""PyTorch port: the benchmark legs (obs/benchmark.py) and `butterfly
bench` on tiny llama on the CPU.

The decode, serving and warm-prefill legs return the JAX package's key
sets letter for letter at the same tiny sizes; the mixed leg at the
shape of the JAX package's bench-phase smoke satisfies its assertions,
with prefix-cache hits and the host tier's keys; the long-context leg on
the CPU reports the plain microbench pair; the speculation leg returns
the JAX leg's keys and accepts drafts on its draft-friendly prompts;
`bench --serving --mixed` and `bench --spec --quant int8` print one JSON
line. On the CPU no device figure exists, so hbm_util
and mfu are None: those numbers come only from a card."""
import json

import jax
import numpy as np
import pytest
import torch

from butterfly_tpu.core.config import tiny
from butterfly_tpu.models.common import Model as JModel
from butterfly_tpu.obs import benchmark as JB
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.models.common import Model
from butterfly_tpu_torch.obs import benchmark as TB

torch.set_num_threads(1)

CFG = tiny("llama", dtype="float32", param_dtype="float32")
TCFG = tconfig.tiny("llama", dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module")
def models():
    jp = JModel(CFG).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return (JModel(CFG), jp), (Model(TCFG, device="cpu"), tp)


def _keys(out):
    """Top-level keys, plus the signal names of the series summaries but
    the per-cause barrier rates, which a recorder emits only for the
    causes it observed (timing decides which do)."""
    keys = set(out)
    for k, v in out.items():
        if k.endswith("series_summary"):
            keys |= {f"{k}.{s}" for s in v
                     if not (s.startswith("barrier_")
                             and s.endswith("_per_sec"))}
    return keys


LEGS = {
    "decode": ("run_decode_benchmark",
               dict(batch=2, prompt_len=8, max_new=4)),
    "serving": ("run_serving_benchmark",
                dict(n_requests=4, prompt_len=8, max_new=6, max_batch=2,
                     kv_quant="none")),
    "warm_prefill": ("run_warm_prefill_benchmark",
                     dict(n_requests=2, prompt_len=40, prefill_chunk=16,
                          max_batch=2, repeats=1)),
}


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_leg_keys_match_the_jax_package(models, leg):
    (jm, jp), (tm, tp) = models
    name, kw = LEGS[leg]
    want = getattr(JB, name)(jm, jp, **kw)
    got = getattr(TB, name)(tm, tp, **kw)
    assert _keys(got) == _keys(want)
    for k, v in got.items():
        if k in ("hbm_util", "mfu"):
            assert v is None            # the CPU has no device figures
        elif k.endswith("tokens_per_sec") or k.endswith("per_chip"):
            assert v > 0, k
    if leg == "warm_prefill":
        assert got["warm_prefill_kernelized"] is False


def test_mixed_leg_contested_with_prefix_hits_and_host_tier(models):
    """The JAX package's bench-phase smoke shape (tests/test_workload.py,
    test_mixed_bench_phase_smoke) and its assertions, plus prefix-cache
    hits and the host tier's demotions under the starved pool."""
    _, (tm, tp) = models
    out = TB.run_mixed_benchmark(
        tm, tp, n_requests=10, max_batch=4,
        prompt_lo=8, prompt_hi=40, max_new_lo=16, max_new_hi=40,
        page_size=8, pool_fraction=0.3, decode_steps_per_tick=2,
        inflight_blocks=2, prefill_max_batch=4, kv_quant="none",
        arrival="burst:2000:0.5:0.1", grid=[(1, 1), (1, 2), (2, 1), (2, 2)],
        host_kv_tier_mb=1.0)
    assert out["mixed_serving_preemptions"] > 0
    assert out["mixed_serving_tokens_per_sec"] > 0
    assert out["mixed_prefix_cache_hit_tokens"] > 0
    for k in ("mixed_ttft_p50", "mixed_ttft_p95",
              "mixed_itl_req_mean_p50", "mixed_shed_total",
              "mixed_deadline_expired_total",
              "mixed_serving_tokens_per_sec_alt", "mixed_host_kv_tier_mb",
              "kv_tier_pages_restored_total", "kv_tier_hit_rate"):
        assert k in out, k
    assert out["kv_tier_pages_saved_total"] > 0
    pts = out["operating_points"]
    assert {(p["decode_steps_per_tick"], p["inflight_blocks"])
            for p in pts} == {(1, 1), (1, 2), (2, 1), (2, 2)}
    for p in pts:
        assert p["ok"] + p["shed_429"] + p["expired_504"] \
            + p["skipped_too_long"] == 10
        assert p["tokens_per_sec"] > 0 and "ttft_p95" in p
    knee = out["operating_point_knee"]
    assert (knee["decode_steps_per_tick"], knee["inflight_blocks"]) \
        in {(1, 1), (1, 2), (2, 1), (2, 2)}


def test_longctx_leg_on_the_cpu_reports_the_plain_pair(models):
    _, (tm, tp) = models
    out = TB.run_longctx_benchmark(tm, tp, prompt_len=64, repeats=1)
    assert set(out) == {"longctx_prompt_len", "longctx_prefill_chunk",
                        "longctx_kv_quant", "longctx_ring_kernelized",
                        "longctx_ring_block_ms", "longctx_ring_block_ms_jnp",
                        "longctx_supported"}
    assert out["longctx_ring_kernelized"] is False
    assert out["longctx_supported"] is False
    assert out["longctx_ring_block_ms"] > 0
    assert out["longctx_ring_block_ms_jnp"] > 0


#: butterfly_tpu/obs/benchmark.py:run_spec_benchmark's keys with an even
#: gamma (the tree row runs): the JAX leg takes ~40 s to compile on this
#: CPU, so its key set is written out here rather than recomputed
JAX_SPEC_KEYS = {
    "serving_spec_draft_layers", "serving_spec_gamma",
    "serving_spec_model_tokens_per_sec", "serving_spec_ngram_tokens_per_sec",
    "serving_spec_off_tokens_per_sec", "serving_spec_speedup",
    "serving_spec_tokens_per_sec", "serving_spec_tree_tokens_per_sec",
    "spec_accept_rate", "spec_accept_rate_model", "spec_accept_rate_ngram",
    "spec_accept_rate_tree", "spec_drafts_accepted_total",
    "spec_drain_barriers_per_forward", "spec_forwards_total",
    "spec_tokens_per_forward", "spec_tokens_per_forward_model",
    "spec_tokens_per_forward_ngram", "spec_tokens_per_forward_tree"}


def test_spec_leg_on_tiny(models):
    (_, _), (tm, tp) = models
    out = TB.run_spec_benchmark(tm, tp, n_requests=4, prompt_len=16,
                                max_new=8, max_batch=2, gamma=2,
                                decode_steps_per_tick=2)
    assert set(out) == JAX_SPEC_KEYS
    assert out["spec_forwards_total"] > 0
    assert out["spec_drafts_accepted_total"] > 0   # draft-friendly prompts
    for k, v in out.items():
        if k.endswith("tokens_per_sec"):
            assert v > 0, k
    assert out["spec_tokens_per_forward_tree"] >= 1.0


@pytest.mark.parametrize("leg", ["run_fleet_benchmark",
                                 "run_autoscale_benchmark",
                                 "run_chaos_benchmark"])
def test_unported_legs_raise(leg):
    """The fleet legs are ported (tests/test_torch_fleet.py, _chaos.py and
    _autoscale.py run them on the CPU). Called with no device they take
    the card, as every entry point of the port does, so without one they
    raise before any replica starts."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(TB, leg)()


def test_card_figures_from_the_device_name():
    sxm = TB.card_figures("NVIDIA H100 80GB HBM3")
    assert sxm == (3.35e12, sxm[1]) and sxm[1]["bfloat16"] == 989e12
    assert TB.card_figures("NVIDIA H100 PCIe")[0] == 2.0e12
    assert TB.card_figures("NVIDIA H100 PCIe")[1]["bfloat16"] == 756e12
    assert TB.card_figures("NVIDIA H100 NVL")[0] == 3.9e12
    assert TB.card_figures("NVIDIA H100 NVL")[1]["bfloat16"] == 835e12
    for other in ("NVIDIA A100-SXM4-80GB", "TPU v5 lite", "", None):
        assert TB.card_figures(other) is None


def test_cli_bench_prints_one_json_line(capsys):
    from butterfly_tpu_torch.serve.cli import main
    assert main(["bench", "--model", "tiny", "--device", "cpu", "--serving",
                 "--mixed", "--batch", "2", "--max-batch", "8",
                 "--prompt-len", "16", "--max-new", "8",
                 "--host-tier-mb", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "decode_tokens_per_sec_per_chip"
    assert out["value"] == out["decode_tokens_per_sec_per_chip"] > 0
    assert out["unit"] == "tokens/sec/chip"
    assert out["mfu"] is None and out["hbm_util"] is None
    for k in ("serving_tokens_per_sec_per_chip", "longctx_supported",
              "mixed_serving_tokens_per_sec", "operating_points",
              "mixed_host_kv_tier_mb"):
        assert k in out, k


def test_cli_bench_spec_int8_prints_one_json_line(capsys):
    from butterfly_tpu_torch.serve.cli import main
    assert main(["bench", "--model", "tiny", "--device", "cpu", "--spec",
                 "--quant", "int8", "--batch", "2", "--prompt-len", "16",
                 "--max-new", "8"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["decode_tokens_per_sec_per_chip"] > 0
    assert JAX_SPEC_KEYS <= set(out) and out["serving_spec_gamma"] == 4
