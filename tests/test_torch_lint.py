"""PyTorch port: its own static analyzer (butterfly_tpu_torch/tools/
staticcheck.py and staticrules/), the copy of the repo's tools/ checker
that walks butterfly_tpu_torch/ with each rule scoped to the port's
paths.

Held: each rule fires on its positive fixture with an exact count and is
silent on its negative one (tests/staticcheck_fixtures/torch/); the
port's tree carries no unsuppressed finding, no bare suppression, and
no generator-discipline (BTF006) suppression but the two constant demo
seeds the JAX package suppresses too; the checker imports neither jax,
butterfly_tpu nor tools/; `butterfly lint` and the bench preflight run
it (exit 0 on the tree, 1 on a positive fixture).
"""
import subprocess
import sys
from pathlib import Path

import pytest

from butterfly_tpu_torch import bench
from butterfly_tpu_torch.serve import cli
from butterfly_tpu_torch.tools import staticcheck, staticrules

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "staticcheck_fixtures" / "torch"

#: rule -> (slug, findings on its positive fixture). Exact counts, so a
#: weakened predicate that still catches some sites (the mutcheck
#: mutants of butterfly_tpu_torch/tools/mutcheck.py) fails loudly.
RULES = {
    "BTF001": ("outbound-http-timeout", 4),
    "BTF003": ("host-sync-in-hot-path", 12),
    "BTF004": ("lock-discipline", 7),
    "BTF005": ("workload-determinism", 12),
    "BTF006": ("prng-key-discipline", 7),
}


def _lint_fixture(name, rid):
    """Exactly one rule over one fixture (force: fixtures lie outside
    every rule's scope on purpose)."""
    return [f for f in staticrules.check_file(
        FIXTURES / name, rules=[staticrules.RULES[rid]], force=True)
        if f.rule == rid]


def test_rule_catalog():
    """The port registers the JAX checker's rules but BTF002 (torch has
    no donate_argnums), each with its invariant and a scope inside
    butterfly_tpu_torch/."""
    assert sorted(staticrules.RULES) == sorted(RULES)
    for rid, (slug, _) in RULES.items():
        rule = staticrules.RULES[rid]
        assert rule.name == slug and rule.invariant and rule.scope
        assert all(s == "butterfly_tpu_torch"
                   or s.startswith("butterfly_tpu_torch/")
                   for s in rule.scope)
    assert "BTF002" in staticcheck.list_rules()
    assert "not ported" in staticcheck.list_rules()


@pytest.mark.parametrize("kind", ["pos", "neg"])
@pytest.mark.parametrize("rid", sorted(RULES))
def test_rule_on_its_fixtures(rid, kind):
    """Each rule fires exactly its count on its positive fixture and
    never on its negative one."""
    found = _lint_fixture(f"btf{rid[3:]}_{kind}.py", rid)
    want = RULES[rid][1] if kind == "pos" else 0
    assert len(found) == want, "\n".join(f.render() for f in found)
    assert not any(f.suppressed for f in found)


def test_suppression_mechanics():
    """A reasoned disable suppresses; a bare one does not and is itself a
    BTF000 finding; a standalone comment covers the next statement."""
    found = staticrules.check_file(FIXTURES / "suppression.py",
                                   rules=[staticrules.RULES["BTF001"]],
                                   force=True)
    reasoned, bare, multiline = sorted(
        (f for f in found if f.rule == "BTF001"), key=lambda f: f.line)
    assert reasoned.suppressed and "reasoned suppression" in reasoned.reason
    assert not bare.suppressed
    assert multiline.suppressed
    assert [f.line for f in found if f.rule == "BTF000"] == [bare.line]


def test_port_tree_lints_clean():
    """butterfly_tpu_torch/ carries no unsuppressed finding."""
    findings = staticcheck.run_default()
    assert not findings, "\n".join(f.render() for f in findings)


def test_port_suppressions_reasoned_and_no_generator_reuse():
    """Every `# btf: disable=` in the port carries a reason, and the only
    suppressed findings are BTF006's two constant demo seeds, the JAX
    package's own two suppressions (serve/cli.py demo weights,
    fleet/harness.py's shared replica tree): no torch.Generator drawn
    from many times is suppressed, because the rule no longer flags
    one."""
    bare = []
    for f in staticcheck.iter_py_files(
            [REPO / t for t in staticcheck.DEFAULT_TREES]):
        for s in staticrules.parse_suppressions(f.read_text()):
            if not s.reason:
                bare.append(f"{f.relative_to(REPO)}:{s.line}")
    assert not bare, bare
    suppressed = [f for f in staticcheck.run_paths(
        [REPO / t for t in staticcheck.DEFAULT_TREES]) if f.suppressed]
    assert sorted((f.rule, f.path) for f in suppressed) == [
        ("BTF006", "butterfly_tpu_torch/fleet/harness.py"),
        ("BTF006", "butterfly_tpu_torch/serve/cli.py")]
    assert all("constant seed manual_seed(0)" in f.message
               for f in suppressed)


def test_checker_imports_nothing_of_jax_or_tools():
    """The checker, the CLI's lint and the bench preflight import
    neither jax, butterfly_tpu nor the repo's tools/ package."""
    code = ("import sys\n"
            "from butterfly_tpu_torch.tools import staticcheck\n"
            "assert staticcheck.run_default() == []\n"
            "bad = [m for m in sys.modules if m in ('jax', 'tools', "
            "'staticcheck', 'staticrules') or m.startswith(('jax.', "
            "'butterfly_tpu.', 'tools.')) or m == 'butterfly_tpu']\n"
            "print(bad)\n"
            "assert not bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_butterfly_lint_exit_codes(capsys):
    """`butterfly lint` exits 0 on the port's tree and 1 on a positive
    fixture (with --force: the fixture lies outside every scope); the
    bench preflight agrees with it on the tree."""
    assert cli.main(["lint"]) == 0
    assert cli.main(["lint", "--force",
                     str(FIXTURES / "btf003_pos.py")]) == 1
    assert "BTF003" in capsys.readouterr().out
    assert bench.lint_preflight() == []


def test_module_cli(tmp_path):
    """`python -m butterfly_tpu_torch.tools.staticcheck` walks the port
    by default (exit 0), refuses a missing path (exit 2) and reports a
    positive fixture (exit 1)."""
    run = [sys.executable, "-m", "butterfly_tpu_torch.tools.staticcheck"]
    r = subprocess.run(run, cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    r = subprocess.run(run + [str(tmp_path / "missing.py")], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2
    r = subprocess.run(run + ["--force", str(FIXTURES / "btf006_pos.py")],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 1 and r.stdout.count("BTF006") == 7
