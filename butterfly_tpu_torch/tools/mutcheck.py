"""Mutation check of the port: prove its tests KILL planted bugs.

    python -m butterfly_tpu_torch.tools.mutcheck           # CPU catalogue
    python -m butterfly_tpu_torch.tools.mutcheck --list
    python -m butterfly_tpu_torch.tools.mutcheck --cuda    # on the card

The counterpart of the repo's tools/mutcheck.py for butterfly_tpu_torch/:
a curated set of single-site mutations in numerically load-bearing code,
each of which MUST make its covering tests (from tests/test_torch_*.py
only) fail. A mutant that survives means those tests have a blind spot:
the tool names it and exits 1. So does a mutant whose run ends in any
other way than a failed test (an import or collection error says
nothing of the mutant), and an unmutated baseline run of the covering
tests that does not pass, in a copy made as the mutants' are.

`MUTANTS` (the CPU catalogue) puts one mutation on the port's
counterpart of each of the JAX tool's mutants but its donation one
(torch has no donate_argnums); where the JAX mutant targets a Pallas
kernel body, this one targets the port's plain version of that kernel,
which the parity tests against the JAX package must catch. The rule
mutants weaken the port's own checker (tools/staticrules/).
`CUDA_MUTANTS` (`--cuda`) mutate the hand-written sm_90a kernel sources;
their covering tests are the card-only kernel tests (marker `cuda`), so
that catalogue runs only where a card is.

Unlike the JAX tool this one never touches the working tree: each mutant
runs in its own copy of the trees its tests need (`COPIED`) in a
temporary directory, so a mutated kernel builds into that copy's own
build directory and never leaves a stale library in the repo's.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

REPO = Path(__file__).resolve().parents[2]


class Mutant(NamedTuple):
    file: str               # repo-relative, under butterfly_tpu_torch/
    original: str           # occurs exactly once in `file`
    mutated: str
    tests: List[str]        # tests/test_torch_*.py files or node ids
    env: Dict[str, str] = {}


#: The CPU catalogue: the port's counterpart of each tools/mutcheck.py
#: mutant (in its order) but the BTF002 (donation) one.
MUTANTS: List[Mutant] = [
    # rms_norm: the epsilon swamps the mean square
    Mutant("butterfly_tpu_torch/models/common.py",
           "x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)",
           "x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + 1.0)",
           ["tests/test_torch_model.py::test_rms_norm_and_rope"]),
    # causal mask off by one: attend to the next position
    Mutant("butterfly_tpu_torch/models/common.py",
           "return j <= positions[:, :, None]",
           "return j <= positions[:, :, None] + 1",
           ["tests/test_torch_model.py::test_attend"]),
    # decode fast path: the self term dropped from the merged softmax
    Mutant("butterfly_tpu_torch/models/common.py",
           "out = out + p[..., -1:].to(v_new.dtype) * v_new.reshape(B, Kv, 1, H)",
           "out = out + 0 * p[..., -1:].to(v_new.dtype) * v_new.reshape(B, Kv, 1, H)",
           ["tests/test_torch_generate.py"]),
    # int8 KV quantizer: the wrong scale denominator (codes clip hard)
    Mutant("butterfly_tpu_torch/models/common.py",
           "scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))",
           "scale = torch.where(amax > 0, amax / 64.0, torch.ones_like(amax))",
           ["tests/test_torch_model.py::test_quantize_kv_codes_byte_identical"]),
    # decode window: the window's K scales dropped from the merged
    # softmax (quantized window scores would be raw code dots)
    Mutant("butterfly_tpu_torch/models/common.py",
           "s_w = s_w * wk_s.permute(1, 2, 0)[:, :, None, :]",
           "s_w = s_w * 1.0",
           ["tests/test_torch_generate.py"]),
    # decode window flush (uniform fast path): the group lands one slot
    # late, orphaning slot `start`
    Mutant("butterfly_tpu_torch/models/common.py",
           "start = start[:1].expand(B)",
           "start = (start[:1] + 1).expand(B)",
           ["tests/test_torch_generate.py::"
            "test_uniform_flush_inside_the_buffer_matches_jax"]),
    # prefix cache: the chain digest forgets the parent
    Mutant("butterfly_tpu_torch/cache/prefix.py",
           "m = hashlib.sha256(h)",
           "m = hashlib.sha256()",
           ["tests/test_torch_prefix.py::"
            "test_chain_block_hashes_equal_the_reference"]),
    # prefix cache: the refcount never increments
    Mutant("butterfly_tpu_torch/cache/prefix.py",
           "self._ref[pid] += 1",
           "self._ref[pid] += 0",
           ["tests/test_torch_prefix.py::"
            "test_allocator_follows_the_reference_op_for_op"]),
    # prefix cache: register the last sampled (never written) token's
    # page as reusable content
    Mutant("butterfly_tpu_torch/sched/scheduler.py",
           "return len(req.all_tokens) - 1",
           "return len(req.all_tokens)",
           ["tests/test_torch_prefix.py::"
            "test_prefix_caching_matches_jax_scheduler"]),
    # stop sequences: leak the first byte of the stop text
    Mutant("butterfly_tpu_torch/serve/server.py",
           "out = self.text[self.released:cut]",
           "out = self.text[self.released:cut + 1]",
           ["tests/test_torch_server.py::test_stop_text_matches_jax"]),
    # speculative generate: accept mismatched drafts in the host loop
    Mutant("butterfly_tpu_torch/engine/engine.py",
           "if d != int(greedy[i]):",
           "if False and d != int(greedy[i]):",
           ["tests/test_torch_speculative.py::"
            "test_generate_speculative_matches_jax"]),
    # speculative serving: accept mismatched drafts on greedy rows
    Mutant("butterfly_tpu_torch/engine/sampling.py",
           "drafts.to(torch.int32) == greedy_tok[:, :gamma])",
           "torch.ones_like(drafts, dtype=torch.bool))",
           ["tests/test_torch_spec_sampling.py::"
            "test_greedy_rows_match_jax_and_accept_drafts"]),
    # allocator: one page fewer than needed (the Python allocator: the
    # native one would hide a Python-side mutation)
    Mutant("butterfly_tpu_torch/cache/allocator.py",
           "want = -(-new_length // self.page_size)",
           "want = new_length // self.page_size",
           ["tests/test_torch_serving.py::"
            "test_scheduler_greedy_tokens_match_jax"],
           {"BUTTERFLY_NATIVE": "0"}),
    # chunked gang prefill (the alternating path) skips the final prompt
    # token
    Mutant("butterfly_tpu_torch/sched/scheduler.py",
           "chunk = prefix[req.prefilled:end]",
           "chunk = prefix[req.prefilled:max(req.prefilled + 1, end - 1)]",
           ["tests/test_torch_alternating.py::"
            "test_alternating_gang_prefill_chunks_match_jax"]),
    # paged write: every token to page offset 0
    Mutant("butterfly_tpu_torch/cache/paged.py",
           "return pid.reshape(-1), torch.remainder(pos, page).reshape(-1)",
           "return pid.reshape(-1), (0 * torch.remainder(pos, page)).reshape(-1)",
           ["tests/test_torch_paged.py::test_paged_forward_decode_matches_jax"]),
    # the paged kernel's plain version: attend one not yet written slot
    # past each sequence's length
    Mutant("butterfly_tpu_torch/ops/paged_attention.py",
           "valid = torch.arange(mp * page, device=q.device)[None, :] \\\n"
           "        < lengths.long()[:, None]",
           "valid = torch.arange(mp * page, device=q.device)[None, :] \\\n"
           "        <= lengths.long()[:, None]",
           ["tests/test_torch_paged_attention.py::"
            "test_plain_version_matches_jax_kernel"]),
    # the paged kernel's plain version: K scales dropped (int8 scores =
    # raw code dots)
    Mutant("butterfly_tpu_torch/ops/paged_attention.py",
           "k = gather(k_pages, k_scale_pages)",
           "k = gather(k_pages, None)",
           ["tests/test_torch_paged_attention.py::"
            "test_plain_version_matches_jax_kernel"]),
    # contiguous int8 attend: the V scale not folded into the probs
    Mutant("butterfly_tpu_torch/models/common.py",
           "probs = probs * v_scale[:, :, None, None, :]",
           "probs = probs * 1.0",
           ["tests/test_torch_model.py::test_attend"]),
    # ring attention: one rotation short (each shard misses one
    # neighbour's K/V block)
    Mutant("butterfly_tpu_torch/parallel/sequence.py",
           "for step in range(N):",
           "for step in range(N - 1):",
           ["tests/test_torch_sequence.py::test_ring_attention_matches_jax"]),
    # the ring kernel's plain merge: the a-leg's running-max correction
    # dropped
    Mutant("butterfly_tpu_torch/ops/ring_attention.py",
           "c_a = torch.exp(m_a - m)",
           "c_a = torch.exp(m_a - m_a)",
           ["tests/test_torch_ring_attention.py::"
            "test_four_shard_merge_matches_dense_and_jax"]),
    # sp decode's partial-softmax combine: each shard keeps its own shift
    # (the global max skipped)
    Mutant("butterfly_tpu_torch/parallel/sequence.py",
           "corr = torch.exp(m_i - m_g)",
           "corr = torch.exp(m_i - m_i)",
           ["tests/test_torch_sequence.py::test_sp_decode_step_matches_jax"]),
    # EP all-to-all dispatch: the counting sort ignores the running count
    Mutant("butterfly_tpu_torch/parallel/expert.py",
           "ranks = torch.cumsum(onehot, dim=0) - 1",
           "ranks = 0 * (torch.cumsum(onehot, dim=0) - 1)",
           ["tests/test_torch_expert.py::test_moe_block_ep_a2a_matches_jax"]),
    # speculative serving (window off): the length rollback off by one
    Mutant("butterfly_tpu_torch/engine/serving.py",
           "                                           valid, stops, has_stop)\n"
           "        cache = cache._replace(\n"
           "            lengths=torch.where(live, W + m, W).to(torch.int32))",
           "                                           valid, stops, has_stop)\n"
           "        cache = cache._replace(\n"
           "            lengths=torch.where(live, W + m + 1, W).to(torch.int32))",
           ["tests/test_torch_speculative.py::test_spec_block_matches_jax"]),
    # tree speculation: the ancestor mask collapsed to all ones
    Mutant("butterfly_tpu_torch/engine/serving.py",
           "& tree_bits.permute(1, 0, 2))",
           "& torch.ones_like(tree_bits.permute(1, 0, 2)))",
           ["tests/test_torch_draft.py::test_draft_spec_tokens_match_jax",
            "tests/test_torch_draft.py::"
            "test_draft_spec_equals_plain_greedy_grid"]),
    # write-combined KV window: the flush's K-pool scatter writes back
    # what the pool held
    Mutant("butterfly_tpu_torch/cache/paged.py",
           "kp[:, flat_pages, :, flat_off] = \\\n"
           "        wk.permute(1, 3, 0, 2, 4)",
           "kp[:, flat_pages, :, flat_off] = kp[:, flat_pages, :, flat_off] "
           "+ 0 * \\\n"
           "        wk.permute(1, 3, 0, 2, 4)",
           ["tests/test_torch_paged.py::"
            "test_stage_write_and_flush_bytes_match_jax"]),
    # write-combined window under speculation: win_len advances by the
    # verify width, not the accepted count
    Mutant("butterfly_tpu_torch/engine/serving.py",
           "                                           valid, stops, has_stop)\n"
           "        wlen = torch.where(live, wlen + m, wlen).to(torch.int32)",
           "                                           valid, stops, has_stop)\n"
           "        wlen = torch.where(live, wlen + C, wlen).to(torch.int32)",
           ["tests/test_torch_speculative.py::"
            "test_scheduler_spec_greedy_parity_grid"]),
    # draft-model speculation: the draft length keeps the drafted count
    Mutant("butterfly_tpu_torch/engine/serving.py",
           "    return dstate._replace(\n"
           "        length=torch.where(live, dlen0 + m, dlen0).to(torch.int32))",
           "    return dstate",
           ["tests/test_torch_draft.py::test_draft_kv_rollback_exact"]),
    # the warm flash kernel's plain version: the prefix-length mask
    # dropped (every row attends the whole cached run)
    Mutant("butterfly_tpu_torch/ops/flash_attention.py",
           "live_p = torch.arange(Sp, device=dev)[None, :] \\\n"
           "            < prefix_len.long()[:, None]",
           "live_p = torch.arange(Sp, device=dev)[None, :] \\\n"
           "            >= 0 * prefix_len.long()[:, None]",
           ["tests/test_torch_flash_attention.py::"
            "test_warm_float_prefix_matches_jax"]),
    # flight recorder: the SLO-burn trigger never fires
    Mutant("butterfly_tpu_torch/obs/ticklog.py",
           "if burn >= self.slo_burn_threshold and burn > 0.0:",
           'if burn >= float("inf") and burn > 0.0:',
           ["tests/test_torch_obs.py::test_slo_burn_trigger_matches_jax"]),
    # alert rules: fire on a single above-threshold sample
    Mutant("butterfly_tpu_torch/obs/timeseries.py",
           "if len(tail) < rule.window:",
           "if len(tail) < 1:",
           ["tests/test_torch_obs.py::test_alert_rules_match_jax"]),
    # workload generator: the Poisson process ignores its rate
    Mutant("butterfly_tpu_torch/workload/arrivals.py",
           "dt = rng.expovariate(self.rate)",
           "dt = rng.expovariate(1.0)",
           ["tests/test_torch_workload.py::test_trace_text_matches_reference"]),
    # -- the port's checker: one weakened predicate per rule; the exact
    # counts on the positive fixtures must fail
    # BTF001: any keyword list counts as a timeout
    Mutant("butterfly_tpu_torch/tools/staticrules/http_timeout.py",
           'if any(kw.arg == "timeout" for kw in node.keywords):',
           "if node.keywords or not node.keywords:",
           ["tests/test_torch_lint.py::test_rule_on_its_fixtures"]),
    # BTF003: .item() dropped from the sync markers
    Mutant("butterfly_tpu_torch/tools/staticrules/host_sync.py",
           'if name in ("item", "tolist", "cpu", "numpy",',
           'if name in ("tolist", "cpu", "numpy",',
           ["tests/test_torch_lint.py::test_rule_on_its_fixtures"]),
    # BTF004: every .acquire() counts as bounded
    Mutant("butterfly_tpu_torch/tools/staticrules/locks.py",
           'if any(kw.arg == "timeout" for kw in node.keywords) or \\',
           "if (node.keywords is not None) or \\",
           ["tests/test_torch_lint.py::test_rule_on_its_fixtures"]),
    # BTF005: wall-clock reads allowed
    Mutant("butterfly_tpu_torch/tools/staticrules/determinism.py",
           'if dotted == "time.time":',
           'if dotted == "time.time_never":',
           ["tests/test_torch_lint.py::test_rule_on_its_fixtures"]),
    # BTF006: constant seeds never flagged
    Mutant("butterfly_tpu_torch/tools/staticrules/prng.py",
           'if name == "manual_seed" and node.args and \\',
           'if name == "manual_seed_never" and node.args and \\',
           ["tests/test_torch_lint.py::test_rule_on_its_fixtures"]),
    # mixed dispatch: the prefill_inline_budget bound dropped
    Mutant("butterfly_tpu_torch/sched/scheduler.py",
           "self._mixed_max_pf = max(1, rt.prefill_inline_budget "
           "// self._mixed_chunk)",
           "self._mixed_max_pf = engine.num_slots",
           ["tests/test_torch_serving.py::test_inline_budget_caps_prefill_lanes"]),
    # autoscaler: the scale-down hysteresis guard inverted
    Mutant("butterfly_tpu_torch/fleet/autoscale.py",
           "if now - last < pol.cooldown_down_s:",
           "if now - last >= pol.cooldown_down_s:",
           ["tests/test_torch_autoscale.py::test_decision_log_matches_reference"]),
]

#: The card-only catalogue (--cuda): one mutant in each hand-written
#: kernel source, covered by the kernel's `cuda`-marked tests.
CUDA_MUTANTS: List[Mutant] = [
    # paged (tensor-core path, int8 pools): the window segment's K scores
    # scaled by its V scales, its K scales lost
    Mutant("butterfly_tpu_torch/ops/csrc/paged_attention.cu",
           "const float* src = (lane < CH ? kss : vss) + sr;",
           "const float* src = (lane < CH && !seg.win ? kss : vss) + sr;",
           ["tests/test_torch_paged_attention.py::"
            "test_split_kernel_matches_plain_on_the_card"]),
    # fresh flash (wgmma): the causal limit off by one (each row sees the
    # next position)
    Mutant("butterfly_tpu_torch/ops/csrc/flash_wgmma.cuh",
           "col <= row",
           "col <= row + 1",
           ["tests/test_torch_flash_attention.py::"
            "test_fresh_kernel_matches_plain_on_the_card"]),
    # warm flash (wgmma): the prefix length off by one (one column past
    # the cached prefix counts)
    Mutant("butterfly_tpu_torch/ops/csrc/flash_warm_wgmma.cuh",
           ">= plen) s[i] = NEG;",
           ">= plen + 1) s[i] = NEG;",
           ["tests/test_torch_flash_attention.py::"
            "test_warm_kernel_matches_plain_on_the_card"]),
    # ring (wgmma stats kernel): the running max not updated, so every
    # tile's correction rescales from the first max
    Mutant("butterfly_tpu_torch/ops/csrc/ring_attention.cu",
           "        m[h] = m_new;\n        ms[h] = m_new * scale2;",
           "        ms[h] = m_new * scale2;",
           ["tests/test_torch_ring_attention.py::"
            "test_wgmma_kernel_matches_plain_on_the_card"]),
]


#: What a mutant's copy of the repo holds: the port, its tests, the JAX
#: package they are held against, the repo's tools/ (one test reads its
#: loadgen) and native/ (the allocator's C++ source), and the pytest
#: settings. Nothing else, so nothing built or downloaded beside them is
#: copied.
COPIED = ("butterfly_tpu_torch", "butterfly_tpu", "tests", "tools", "native",
          "pyproject.toml")

#: Mutants (and baselines) run at once, each in its own copy.
JOBS = max(1, min(4, (os.cpu_count() or 2) // 2))


def check_catalogue(mutants: List[Mutant]) -> List[str]:
    """What is wrong with `mutants`: an original that does not occur
    exactly once in its file, a file outside butterfly_tpu_torch/, a
    covering test outside tests/test_torch_*.py or missing."""
    bad = []
    for i, m in enumerate(mutants):
        path = REPO / m.file
        if not m.file.startswith("butterfly_tpu_torch/") or not path.exists():
            bad.append(f"#{i}: {m.file} is not a file of butterfly_tpu_torch/")
            continue
        n = path.read_text().count(m.original)
        if n != 1:
            bad.append(f"#{i}: {m.file}: the original occurs {n} times")
        for t in m.tests:
            f = t.split("::")[0]
            if not re.fullmatch(r"tests/test_torch_\w+\.py", f) or \
                    not (REPO / f).exists():
                bad.append(f"#{i}: covering test {t} is not a "
                           "tests/test_torch_*.py file")
    return bad


def verdict(returncode: int, output: str) -> str:
    """What one pytest run says of its mutant: "killed" (an assertion
    failed: rc 1 and a FAILED line), "survived" (rc 0, tests passed),
    "not run" (every covering test skipped: a card's tests without one)
    or "error" (anything else: a collection or import error, an error in
    a fixture, a usage error; it says nothing of the mutant)."""
    if returncode == 1 and re.search(r"^FAILED ", output, re.M):
        return "killed"
    if returncode == 0 and re.search(r"\d+ passed", output):
        return "survived"
    if returncode in (0, 5):
        return "not run"
    return "error"


def run_tests(tests: List[str], env: Dict[str, str], mutant: Optional[Mutant]
              = None, cuda: bool = False, timeout: float = 1200.0) -> dict:
    """Run `tests` in a fresh copy of the repo (`COPIED`), with `mutant`
    applied there if one is given (`cuda`: only the tests marked cuda):
    {"verdict": see `verdict`, or "timeout"; "seconds"; "failed": the
    first FAILED line of a kill, the output's end of an error}."""
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="mutcheck-") as tmp:
        root = Path(tmp) / "repo"
        for name in COPIED:
            if (REPO / name).is_dir():
                shutil.copytree(REPO / name, root / name,
                                ignore=shutil.ignore_patterns(
                                    "__pycache__", "*.pyc"))
            else:
                root.mkdir(exist_ok=True)
                shutil.copy2(REPO / name, root / name)
        if mutant is not None:
            path = root / mutant.file
            src = path.read_text()
            assert src.count(mutant.original) == 1, \
                f"ambiguous site in {mutant.file}"
            path.write_text(src.replace(mutant.original, mutant.mutated))
        env = dict(os.environ, **env)
        env.setdefault("JAX_PLATFORMS", "cpu")
        env["PYTHONPATH"] = str(root)
        # -q once (the repo's addopts would make it -qq, which drops the
        # "N passed" summary)
        cmd = [sys.executable, "-m", "pytest", "-x", "-q", "-o", "addopts=",
               "-p", "no:cacheprovider", "-p", "no:randomly"]
        if cuda:
            cmd += ["-m", "cuda"]
        try:
            r = subprocess.run(cmd + list(tests), cwd=root, env=env,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True,
                               timeout=timeout)
        except subprocess.TimeoutExpired:
            return {"verdict": "timeout", "failed": "",
                    "seconds": round(time.monotonic() - t0, 1)}
    v = verdict(r.returncode, r.stdout)
    failed = [ln for ln in r.stdout.splitlines() if ln.startswith("FAILED ")]
    return {"verdict": v, "seconds": round(time.monotonic() - t0, 1),
            "failed": failed[0] if v == "killed" else
            f"rc {r.returncode}: {r.stdout.strip()[-300:]}"
            if v == "error" else ""}


def run_mutant(m: Mutant, cuda: bool = False,
               timeout: float = 1200.0) -> dict:
    """Apply `m` in a fresh copy of the repo and run its covering tests
    there (see `run_tests`)."""
    return run_tests(m.tests, m.env, m, cuda, timeout)


def baselines(mutants: List[Mutant]) -> List[tuple]:
    """One unmutated run for each environment the catalogue sets: the
    covering tests of every mutant with that environment, as
    (tests, env) pairs. Each must pass (or, for card tests without a
    card, skip) in its copy, or no kill of the catalogue means
    anything."""
    groups: Dict[tuple, List[str]] = {}
    for m in mutants:
        tests = groups.setdefault(tuple(sorted(m.env.items())), [])
        tests += [t for t in m.tests if t not in tests]
    return [(tests, dict(env)) for env, tests in groups.items()]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m butterfly_tpu_torch.tools."
                                 "mutcheck", description=__doc__.split(
                                     "\n\n")[0])
    ap.add_argument("--list", action="store_true",
                    help="print the catalogue and exit")
    ap.add_argument("--cuda", action="store_true",
                    help="the kernel-source catalogue (needs the card)")
    args = ap.parse_args(argv)
    catalogue = CUDA_MUTANTS if args.cuda else MUTANTS
    if args.list:
        for i, m in enumerate(catalogue):
            print(f"{i}: {m.file}: {m.original!r} -> {m.mutated!r}  "
                  f"[{' '.join(m.tests)}] {m.env or ''}")
        return 0
    bad = check_catalogue(catalogue)
    if bad:
        print("malformed catalogue:\n  " + "\n  ".join(bad))
        return 2
    bases = baselines(catalogue)
    t0 = time.monotonic()

    def one(job):
        kind, i = job
        if kind == "base":
            tests, env = bases[i]
            res = run_tests(tests, env, cuda=args.cuda)
            said = {"survived": "passed"}.get(res["verdict"], res["verdict"])
            print(f"[baseline {i}] {said} {res['seconds']} s  "
                  f"{len(tests)} covering tests {env or ''}"
                  + (f"  ({res['failed']})" if res["failed"] else ""),
                  flush=True)
            return job, res
        m = catalogue[i]
        res = run_mutant(m, cuda=args.cuda)
        print(f"[{i}] {res['verdict']} {res['seconds']} s  {m.file}: "
              f"{m.original.splitlines()[0][:60]!r}"
              + (f"  ({res['failed']})" if res["failed"] else ""),
              flush=True)
        return job, res
    jobs = [("base", i) for i in range(len(bases))] + \
        [("mutant", i) for i in range(len(catalogue))]
    with ThreadPoolExecutor(JOBS) as pool:
        results = dict(pool.map(one, jobs))
    total = round(time.monotonic() - t0, 1)
    broken = [i for i in range(len(bases))
              if results["base", i]["verdict"] not in ("survived", "not run")]
    left = [i for i in range(len(catalogue))
            if results["mutant", i]["verdict"] != "killed"]
    print(f"\n{len(catalogue) - len(left)} of {len(catalogue)} mutants "
          f"killed in {total} s")
    for i in broken:
        print(f"  [baseline {i}] {results['base', i]['verdict']}: the "
              "unmutated copy does not pass, so no kill counts")
    for i in left:
        print(f"  [{i}] {results['mutant', i]['verdict']}: "
              f"{catalogue[i].file}: {catalogue[i].original.splitlines()[0]!r}")
    return 1 if left or broken else 0


if __name__ == "__main__":
    sys.exit(main())
