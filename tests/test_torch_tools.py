"""PyTorch port: the root-level scripts as modules of the port
(butterfly_tpu_torch/tools/profile_decode.py, tools/tp_scaling.py and
butterfly_tpu_torch/bench.py), on the CPU at the tiny preset.

Held: every profiler mode exits 0, writes a Chrome trace that is valid
JSON and reports at least one op, and its trace window holds exactly the
programs the JAX script's holds (counted by wrapping the engine methods
while the window is open); tp_scaling's reductions per layer, and outside
the layers, equal in number and in elements the all-reduces that XLA
inserts into the JAX package's decode step on the harness's CPU devices
(the HLO of tools/tp_scaling.py's `measure`, read with its own line
parser); the port's bench.py lint preflight is clean on this tree, a
finding makes it exit 2 before any leg runs, and its CPU line carries the
keys of the JAX package's bench.py.
"""
import contextlib
import importlib
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from butterfly_tpu.core import config as jconfig
from butterfly_tpu.core.mesh import make_mesh as jmake_mesh
from butterfly_tpu.models import common as JC
from butterfly_tpu.parallel import partition as JP
from butterfly_tpu_torch import bench
from butterfly_tpu_torch.engine import engine as TE
from butterfly_tpu_torch.engine.serving import ServingEngine
from butterfly_tpu_torch.obs import benchmark as bm
from butterfly_tpu_torch.sched.scheduler import Scheduler
from butterfly_tpu_torch.tools import profile_decode as pd
from butterfly_tpu_torch.tools import tp_scaling as ts

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

# -- the profiler -------------------------------------------------------------

#: the engine and scheduler methods a trace window is held by, and the
#: module functions of the offline engine's loop
_METHODS = {
    ServingEngine: ("mixed_block_async", "decode_block_async",
                    "spec_block_async", "mixed_spec_block_async",
                    "prefill_batch", "sp_prefill_chunk"),
    Scheduler: ("_drain_inflight", "_drain_oldest", "_drain_blocks"),
    TE.InferenceEngine: ("prefill",),
}
_FUNCS = (TE, ("_generate_fused", "_generate_fused_win"))

#: (mode, flags, every tracked call the trace window holds): one block a
#: tick dispatches (mixed dispatch; the tree's draft model takes the
#: alternating path), no drain, no prefill in the decode loop's window
_MODES = [
    ("decode", [], {"_generate_fused": 1}),
    ("serving", ["--serving"], {"mixed_block_async": 1}),
    ("pipeline", ["--pipeline"], {"mixed_block_async": 2}),
    ("spec", ["--spec"], {"mixed_spec_block_async": 1}),
    ("spec_tree", ["--spec", "--draft-source", "model", "--tree-width",
                   "2"], {"spec_block_async": 1}),
    ("prefill", ["--prefill"], {"prefill_batch": 1}),
    ("long_context", ["--long-context"],
     {"sp_prefill_chunk": 1, "mixed_block_async": 1}),
]


def _counted(monkeypatch):
    """Counts of the _METHODS / _FUNCS calls made while a trace window is
    open."""
    n, open_ = {}, [False]

    def wrap(owner, name):
        fn = getattr(owner, name)

        def counted(*a, **kw):
            if open_[0]:
                n[name] = n.get(name, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(owner, name, counted)
    for cls, names in _METHODS.items():
        for name in names:
            wrap(cls, name)
    for name in _FUNCS[1]:
        wrap(_FUNCS[0], name)
    capture = pd.capture

    @contextlib.contextmanager
    def window(device):
        with capture(device) as w:
            open_[0] = True
            try:
                yield w
            finally:
                open_[0] = False
    monkeypatch.setattr(pd, "capture", window)
    return n


@pytest.mark.parametrize("mode,flags,want", _MODES,
                         ids=[m[0] for m in _MODES])
def test_profile_mode_window(monkeypatch, tmp_path, capsys, mode, flags,
                             want):
    n = _counted(monkeypatch)
    rc = pd.main(["--device", "cpu", "--out", str(tmp_path), "--top", "5",
                  *flags])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    head = json.loads(out[-1])
    with open(head["trace"]) as f:
        assert json.load(f)["traceEvents"]
    table = [ln for ln in out if "host op" in ln or "kernel" in ln]
    assert table, out
    assert head["wall_ms"] > 0 and head["device_busy_ms"] is None
    assert {k: v for k, v in n.items() if v} == want


# -- tp_scaling ---------------------------------------------------------------

def _jax_all_reduces(tp, layers=2, batch=8, seq=128):
    """(in the layer loop, outside it): the element counts of the
    all-reduces XLA inserts into the JAX package's decode step (the HLO
    of tools/tp_scaling.py's `measure`) over tp of the harness's CPU
    devices. The layers are a scan, so the loop body's all-reduces run
    once a layer; the entry computation's run once a step."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        jts = importlib.import_module("tp_scaling")
    finally:
        sys.path.remove(str(REPO / "tools"))
    cfg = jconfig.tiny("llama", num_layers=layers, **ts.TINY_TP)
    params = JC.Model(cfg).init(jax.random.PRNGKey(0))
    mesh = jmake_mesh(jconfig.MeshConfig(tensor=tp), jax.devices()[:tp])
    params = JP.shard_params(params, cfg, mesh)
    cache = JP.shard_cache(JC.init_cache(cfg, batch, seq), cfg, mesh)
    hlo = JP.compiled_hlo(lambda p, t, c: JC.forward(p, cfg, t, c), params,
                          jnp.zeros((batch, 1), jnp.int32), cache, mesh=mesh)
    loop, entry, in_entry = [], [], False
    for line in hlo.splitlines():
        if line and not line[0].isspace():
            in_entry = line.startswith("ENTRY")
        got = jts.collective_bytes(line)
        if got["all-reduce"]:
            dt = re.search(r"=\s*\(?([a-z0-9]+)\[", line).group(1)
            (entry if in_entry else loop).append(
                got["all-reduce"] // jts.DTYPE_BYTES[dt])
    return loop, entry


@pytest.fixture(scope="module")
def tiny_tp():
    return ts.build_model("cpu", 2)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_tp_scaling_counts_match_xla(tiny_tp, tp):
    """Per layer and outside the layers, the port's reductions equal
    XLA's all-reduces in number and elements: two [B, 1, D] a layer (the
    attention output and the FFN down projection), one outside (the
    vocab-split embedding). Both reduce in float32 here (the f32 config),
    so the bytes agree too. The port also gathers the vocab-split logits
    once a step, where the JAX step returns them split."""
    model, params = tiny_tp
    pl = ts.per_layer(ts.measure(model, params, tp, batch=8, seq=128))
    loop, entry = _jax_all_reduces(tp)
    ar = [r for r in pl["layer"] if r["kind"] == "all_reduce"]
    out = [r for r in pl["outside"] if r["kind"] == "all_reduce"]
    assert pl["layers"] == 2
    assert sorted(r["elements"] for r in ar) == sorted(loop) == [512, 512]
    assert sorted(r["elements"] for r in out) == sorted(entry) == [512]
    assert all(r["shape"] == (8, 1, 64) and r["dtype"] == "torch.float32"
               and r["bytes"] == 512 * 4 for r in ar + out)
    assert [(r["kind"], r["shape"]) for r in pl["outside"]
            if r["kind"] == "gather"] == [("gather", (8, 1, 256))]


def test_tp_scaling_cli(capsys):
    assert ts.main(["--device", "cpu", "--tp", "2"]) == 0
    out = capsys.readouterr().out
    assert "| 2 | 2 | 512/512 |" in out
    assert "not NVLink traffic" in out and "datasheet" in out


def test_tp_scaling_counts_nothing_outside_its_step(tiny_tp):
    """The counters live only inside `measure`: the module functions are
    the originals again after it."""
    from butterfly_tpu_torch.models import common
    from butterfly_tpu_torch.parallel import tensor
    before = (tensor.all_reduce, tensor.gather, common.gather,
              common._decode_layer_body)
    ts.measure(*tiny_tp, 2, batch=2, seq=16)
    assert (tensor.all_reduce, tensor.gather, common.gather,
            common._decode_layer_body) == before


# -- bench.py -----------------------------------------------------------------

#: the keys of the JAX bench.py's CPU line: one run of `python bench.py` on
#: the CPU (JAX_PLATFORMS=cpu) while this test was written
JAX_CPU_KEYS = [
    "autoscale_arrival", "autoscale_dropped",
    "autoscale_flightrec_scale_events", "autoscale_peak_replicas",
    "autoscale_replica_seconds", "autoscale_replica_seconds_saved_frac",
    "autoscale_requests", "autoscale_scale_downs", "autoscale_scale_ups",
    "autoscale_slo_attainment", "autoscale_slo_itl_ms",
    "autoscale_slo_ttft_ms", "autoscale_static_peak_replica_seconds",
    "autoscale_topology", "autoscale_ttft_p95_s", "breaker_open_total",
    "chaos_deadline_504", "chaos_errors", "chaos_fallbacks",
    "chaos_flightrec_dumps", "chaos_flightrec_events",
    "chaos_flightrec_reasons", "chaos_flightrec_sources", "chaos_injected",
    "chaos_leg_failures", "chaos_requests", "chaos_seed", "chaos_shed_429",
    "chaos_terminal", "chaos_topology", "chaos_unterminal",
    "deadline_expired_total", "decode_isolated_tokens_per_sec_per_chip",
    "device_bubble_p50", "device_bubble_p95", "drain_barriers_by_cause",
    "fleet_arrival", "fleet_disaggregated", "fleet_dropped",
    "fleet_outcomes", "fleet_requests", "fleet_rolling_cycles", "fleet_rps",
    "fleet_slo_attainment", "fleet_slo_itl_ms", "fleet_slo_ttft_ms",
    "fleet_topology", "fleet_ttft_direct_p50", "fleet_ttft_direct_p95",
    "fleet_ttft_p50", "fleet_ttft_p95", "hbm_util", "itl_p50_tick_burst",
    "itl_p95_tick_burst", "itl_req_mean_p50", "itl_req_mean_p50_alt",
    "itl_req_mean_p95", "itl_req_mean_p95_alt", "kv_flush_p50",
    "kv_flush_p95", "kv_quant", "kv_tier_hit_rate", "kv_tier_misses_total",
    "kv_tier_pages_restored_total", "kv_tier_pages_saved_total",
    "kv_tier_restore_seconds_p50", "kv_tier_restore_seconds_p95",
    "kv_tier_spills_total", "kv_transfer_bytes", "kv_transfer_hit_rate",
    "kv_transfer_pages", "kv_window_tokens_flushed_total",
    "longctx_itl_budget_s", "longctx_itl_p95_alone",
    "longctx_itl_within_budget", "longctx_kv_quant",
    "longctx_mixed_itl_p95", "longctx_prefill_chunk",
    "longctx_prefill_tokens_per_sec", "longctx_prompt_len",
    "longctx_ring_block_ms", "longctx_ring_block_ms_jnp",
    "longctx_ring_kernelized", "longctx_sp_chunk",
    "longctx_sp_prefill_tokens", "longctx_supported", "longctx_ttft_p50",
    "longctx_ttft_p95", "metric", "mfu", "mixed_admission_barriers",
    "mixed_admission_barriers_alt", "mixed_admission_barriers_delta",
    "mixed_admitted", "mixed_arrival", "mixed_deadline_expired_total",
    "mixed_dispatch_prefill_tokens_inline", "mixed_drain_barriers_by_cause",
    "mixed_host_kv_tier_mb", "mixed_itl_p95_delta", "mixed_itl_req_mean_p50",
    "mixed_itl_req_mean_p50_alt", "mixed_itl_req_mean_p95",
    "mixed_itl_req_mean_p95_alt", "mixed_kv_quant", "mixed_max_batch",
    "mixed_max_new_range", "mixed_num_pages", "mixed_ok",
    "mixed_pool_fraction", "mixed_prefix_cache_hit_tokens",
    "mixed_prompt_range", "mixed_requests", "mixed_series_summary",
    "mixed_serving_preemptions", "mixed_serving_tokens_per_sec",
    "mixed_serving_tokens_per_sec_alt", "mixed_shed_total",
    "mixed_slo_ttft_ms", "mixed_tick_device_frac", "mixed_tick_host_frac",
    "mixed_tick_phase_admit_p50", "mixed_tick_phase_admit_p95",
    "mixed_tick_phase_assemble_p50", "mixed_tick_phase_assemble_p95",
    "mixed_tick_phase_dispatch_p50", "mixed_tick_phase_dispatch_p95",
    "mixed_tick_phase_drain_p50", "mixed_tick_phase_drain_p95",
    "mixed_tick_phase_mixed_p50", "mixed_tick_phase_mixed_p95",
    "mixed_ttft_p50", "mixed_ttft_p50_alt", "mixed_ttft_p95",
    "mixed_ttft_p95_alt", "mixed_workload", "model",
    "operating_point_knee", "operating_points", "prefill_tokens_per_sec",
    "quant", "serving_admission_barriers", "serving_admission_barriers_alt",
    "serving_admission_barriers_delta", "serving_capacity_tokens_per_sec",
    "serving_capacity_tokens_per_sec_nowin",
    "serving_capacity_tokens_per_sec_sync", "serving_gap",
    "serving_gap_nowin", "serving_gap_sync", "serving_inflight_blocks",
    "serving_itl_p95_delta", "serving_kv_quant", "serving_kv_write_combine",
    "serving_max_batch", "serving_max_new", "serving_mixed_dispatch",
    "serving_offered_utilization", "serving_preemptions",
    "serving_prefill_max_batch", "serving_prompt_len", "serving_requests",
    "serving_series_summary", "serving_shed_total",
    "serving_spec_draft_layers", "serving_spec_gamma",
    "serving_spec_model_tokens_per_sec", "serving_spec_ngram_tokens_per_sec",
    "serving_spec_off_tokens_per_sec", "serving_spec_speedup",
    "serving_spec_tokens_per_sec", "serving_spec_tree_tokens_per_sec",
    "serving_tokens_per_sec_per_chip", "serving_tokens_per_sec_per_chip_alt",
    "serving_tokens_per_sec_per_chip_nowin",
    "serving_tokens_per_sec_per_chip_sync", "spec_accept_rate",
    "spec_accept_rate_model", "spec_accept_rate_ngram",
    "spec_accept_rate_tree", "spec_drafts_accepted_total",
    "spec_drain_barriers_per_forward", "spec_forwards_total",
    "spec_tokens_per_forward", "spec_tokens_per_forward_model",
    "spec_tokens_per_forward_ngram", "spec_tokens_per_forward_tree",
    "staticcheck_findings_total", "tick_device_frac", "tick_host_frac",
    "tick_phase_admit_p50", "tick_phase_admit_p95",
    "tick_phase_assemble_p50", "tick_phase_assemble_p95",
    "tick_phase_dispatch_p50", "tick_phase_dispatch_p95",
    "tick_phase_drain_p50", "tick_phase_drain_p95", "tick_phase_mixed_p50",
    "tick_phase_mixed_p95", "ttft_p50", "ttft_p50_alt", "ttft_p95",
    "ttft_p95_alt", "unit", "value", "vs_baseline", "warm_prefill_chunk",
    "warm_prefill_kernelized", "warm_prefill_kv_quant",
    "warm_prefill_prompt_len", "warm_prefill_requests",
    "warm_prefill_tokens_per_sec", "warm_prefill_tokens_per_sec_dense",
    "warm_prefill_ttft_p50", "warm_prefill_ttft_p50_dense",
    "warm_prefill_ttft_p95", "warm_prefill_ttft_p95_dense",
]

#: the legs at their smallest request counts (bench.py's CPU sizes take
#: minutes here); the keys do not depend on the counts
_SMALL = {
    "run_decode_benchmark": dict(batch=2, max_new=4),
    "run_serving_benchmark": dict(n_requests=4, max_new=8, max_batch=2),
    "run_warm_prefill_benchmark": dict(n_requests=1, repeats=1),
    "run_longctx_benchmark": dict(repeats=1, n_decoders=1, decode_new=4),
    "run_spec_benchmark": dict(n_requests=2, max_new=8, max_batch=2),
    "run_mixed_benchmark": dict(grid=[(1, 1)]),
    "run_fleet_benchmark": dict(clients=1, requests_per_client=2),
    "run_chaos_benchmark": dict(clients=1, requests_per_client=2),
    "run_autoscale_benchmark": dict(clients=1, requests_per_client=2,
                                    settle_s=0.5),
}


def test_bench_preflight_clean():
    """tests/test_staticcheck.py:186 for the port's bench.py: the same
    default walk, clean on this tree."""
    assert bench.lint_preflight() == []


def test_bench_refuses_a_dirty_tree(monkeypatch, capsys):
    class Finding:
        def render(self):
            return "x.py:1: BTF999 planted finding"
    monkeypatch.setattr(bench, "lint_preflight", lambda: [Finding()])
    for name in _SMALL:
        monkeypatch.setattr(bm, name, lambda *a, **kw: pytest.fail(
            "a leg ran on a dirty tree"))
    assert bench.main(["--device", "cpu"]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "BTF999 planted finding" in captured.err


def test_bench_cpu_line_has_the_jax_keys(monkeypatch, capsys):
    for name, small in _SMALL.items():
        fn = getattr(bm, name)
        monkeypatch.setattr(bm, name, lambda *a, _fn=fn, _small=small, **kw:
                            _fn(*a, **{**kw, **_small}))
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert sorted(line) == JAX_CPU_KEYS
    assert line["metric"] == "decode_tokens_per_sec_per_chip"
    assert line["value"] > 0 and line["vs_baseline"] is None
    assert line["model"] == "tiny" and line["kv_quant"] == "none"
    assert line["staticcheck_findings_total"] == 0
