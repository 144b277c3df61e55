"""PyTorch port: its mutation check (butterfly_tpu_torch/tools/
mutcheck.py), on the CPU.

Held: both catalogues are well formed (each original occurs exactly once
in a file of butterfly_tpu_torch/, each covering test is a
tests/test_torch_*.py file that exists; the CPU catalogue has a mutant
for each of the JAX tool's 38 but its donation one, the CUDA catalogue
one in each kernel source); one cheap CPU mutant (the workload
generator's rate) runs end to end in its own copy of the repo and is
killed; a mutant that breaks its covering tests' import is an error,
never a kill; a kernel mutant's card-only tests skip here and count as
not run, never as survived; the working tree is byte-identical
afterwards.
The whole CPU catalogue is not run here (`python -m
butterfly_tpu_torch.tools.mutcheck`).
"""
import hashlib
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from butterfly_tpu_torch.tools import mutcheck as M

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "butterfly_tpu_torch" / "ops" / "csrc"


def _tree_digest():
    """{path: sha256} of every file of the port and the tests."""
    out = {}
    for top in ("butterfly_tpu_torch", "tests"):
        for f in sorted((REPO / top).rglob("*")):
            if f.is_file() and "__pycache__" not in f.parts:
                out[str(f.relative_to(REPO))] = hashlib.sha256(
                    f.read_bytes()).hexdigest()
    return out


def test_catalogues_well_formed():
    assert M.check_catalogue(M.MUTANTS) == []
    assert M.check_catalogue(M.CUDA_MUTANTS) == []
    # the JAX tool's 39 mutants less its BTF002 (donation) one
    assert len(M.MUTANTS) == 38
    assert not any("donation" in m.file for m in M.MUTANTS)
    kernel_sources = {"paged_attention.cu", "flash_wgmma.cuh",
                      "flash_warm_wgmma.cuh", "ring_attention.cu"}
    assert {Path(m.file).name for m in M.CUDA_MUTANTS} == kernel_sources
    assert all((CSRC / k).exists() for k in kernel_sources)


def test_list_prints_each_catalogue():
    for flag, n in (([], 38), (["--cuda"], len(M.CUDA_MUTANTS))):
        r = subprocess.run([sys.executable, "-m",
                            "butterfly_tpu_torch.tools.mutcheck", "--list",
                            *flag], cwd=REPO, capture_output=True,
                           text=True, timeout=60)
        assert r.returncode == 0, r.stderr
        assert len(r.stdout.strip().splitlines()) == n


def test_baselines_cover_every_mutant():
    """The unmutated runs: one for each environment the catalogue sets,
    holding every covering test of each mutant with that environment."""
    for catalogue in (M.MUTANTS, M.CUDA_MUTANTS):
        bases = M.baselines(catalogue)
        assert len({tuple(sorted(env.items())) for _, env in bases}) == \
            len(bases)
        for m in catalogue:
            assert any(env == m.env and set(m.tests) <= set(tests)
                       for tests, env in bases)


_PASSED = "..\n2 passed in 1.0s\n"
_FAILED = ("F\nFAILED tests/test_torch_x.py::test_a - AssertionError\n"
           "1 failed in 1.0s\n")


@pytest.mark.parametrize("rc, out, want", [
    (1, _FAILED, "killed"),
    (0, _PASSED, "survived"),
    (5, "no tests ran in 0.1s\n", "not run"),
    (0, "ss\n2 skipped in 0.1s\n", "not run"),
    # a failure with no FAILED line: an error in a fixture's set-up
    (1, "E\nERROR tests/test_torch_x.py::test_a - RuntimeError\n",
     "error"),
    # collection / import errors, an internal error, a usage error
    (2, "ERROR tests/test_torch_x.py - SyntaxError\n"
        "Interrupted: 1 error during collection\n", "error"),
    (3, "INTERNALERROR> Traceback\n", "error"),
    (4, "ERROR: file or directory not found: tests/nope.py\n", "error"),
], ids=["killed", "survived", "none-collected", "all-skipped",
        "setup-error", "collection-error", "internal-error", "usage-error"])
def test_verdict_counts_only_failed_tests_as_kills(rc, out, want):
    assert M.verdict(rc, out) == want


def test_cpu_mutant_killed_in_a_copy_and_broken_import_is_an_error():
    """The arrivals mutant (the Poisson process ignores its rate) is
    killed by its covering test in a copy of the repo; the same site
    made a syntax error stops the tests at collection, which is an
    error, not a kill. Without a card the paged kernel's mutant has only
    card tests, which skip: not run (with one, the --cuda catalogue runs
    it). The working tree does not change."""
    before = _tree_digest()
    arrivals = [m for m in M.MUTANTS
                if m.file.endswith("workload/arrivals.py")]
    assert len(arrivals) == 1
    res = M.run_mutant(arrivals[0], timeout=120)
    assert res["verdict"] == "killed", res
    assert res["failed"].startswith("FAILED tests/test_torch_workload.py")
    broken = arrivals[0]._replace(mutated="dt = rng.expovariate(self.rate")
    res = M.run_mutant(broken, timeout=120)
    assert res["verdict"] == "error", res
    if not torch.cuda.is_available():
        res = M.run_mutant(M.CUDA_MUTANTS[0], cuda=True, timeout=120)
        assert res["verdict"] == "not run", res
    assert _tree_digest() == before
