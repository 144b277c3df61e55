"""The port's static analysis entry point: `butterfly lint`.

    python -m butterfly_tpu_torch.tools.staticcheck              # the port
    python -m butterfly_tpu_torch.tools.staticcheck butterfly_tpu_torch/sched
    python -m butterfly_tpu_torch.tools.staticcheck --list-rules
    python -m butterfly_tpu_torch.tools.staticcheck --json

A copy of the repo's tools/staticcheck.py that walks
butterfly_tpu_torch/ with the port's own rules (staticrules/: HTTP
timeouts, host syncs in the hot path, lock discipline, workload
determinism, generator discipline), so the port lints itself without
reading tools/. tests/ stay with the JAX package's gate
(tests/test_staticcheck.py walks them). Findings print one per line::

    butterfly_tpu_torch/foo.py:123:4: BTF001 outbound HTTP call urlopen(...) ...

Exit status: 0 = clean (suppressed findings don't count), 1 = at least
one unsuppressed finding, 2 = usage/parse error.

Suppression syntax (reason MANDATORY — a bare disable is itself a
BTF000 finding):
    something_flagged()  # btf: disable=BTF001 one-line reason

The same engine runs as the tier-1 test (tests/test_torch_lint.py), as
the port's `butterfly lint` (serve/cli.py) and as its bench's preflight
(bench.py).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Iterable, List, Optional

from butterfly_tpu_torch.tools import staticrules
from butterfly_tpu_torch.tools.staticrules import (Finding, check_context,
                                                   make_context)

REPO = Path(__file__).resolve().parents[2]

#: the tree `butterfly lint` / the tier-1 test walk by default
DEFAULT_TREES = ("butterfly_tpu_torch",)

#: never walked by default: the fixture snippets VIOLATE the rules by
#: design (each rule's positive example), and caches aren't source
DEFAULT_EXCLUDES = ("tests/staticcheck_fixtures/torch", "__pycache__",
                    ".git", ".eggs", "build")


#: why the catalogue skips BTF002 (--list-rules prints it in its place)
BTF002_ABSENT = ("BTF002  use-after-donation  (not ported) torch has no "
                 "donate_argnums: no call of the port gives its argument's "
                 "buffer away, so there is no read after donation to flag")


def _excluded(rel: str, excludes: Iterable[str]) -> bool:
    parts = rel.split("/")
    for e in excludes:
        if rel == e or rel.startswith(e.rstrip("/") + "/") or e in parts:
            return True
    return False


def iter_py_files(paths: Iterable[Path],
                  excludes: Iterable[str] = DEFAULT_EXCLUDES):
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            yield p
            continue
        if not p.is_dir():
            continue
        for f in sorted(p.rglob("*.py")):
            rel = f.relative_to(REPO).as_posix() if f.is_relative_to(REPO) \
                else f.as_posix()
            if _excluded(rel, excludes):
                continue
            yield f


def run_paths(paths: Iterable[Path],
              excludes: Iterable[str] = DEFAULT_EXCLUDES,
              rules=None, force: bool = False) -> List[Finding]:
    """Lint files/trees; returns ALL findings (suppressed ones marked).
    ``force=True`` runs every rule regardless of its scope (ad-hoc
    sweeps and fixture linting)."""
    findings: List[Finding] = []
    for f in iter_py_files(paths, excludes=excludes):
        rel = f.relative_to(REPO).as_posix() if f.is_relative_to(REPO) \
            else f.as_posix()
        try:
            ctx = make_context(f, rel)
        except SyntaxError as e:
            findings.append(Finding(
                rule="BTF000", path=rel, line=e.lineno or 1, col=0,
                message=f"file does not parse: {e.msg}"))
            continue
        findings.extend(check_context(ctx, rules=rules, force=force))
    return findings


def run_default(root: Optional[Path] = None) -> List[Finding]:
    """The canonical walk (tier-1 test, `butterfly lint`, bench
    preflight): butterfly_tpu_torch/. Returns only the UNSUPPRESSED
    findings."""
    base = root or REPO
    found = run_paths([base / t for t in DEFAULT_TREES])
    return [f for f in found if not f.suppressed]


def list_rules() -> str:
    lines = ["BTF000  bare-suppression  (framework) a '# btf: disable=' "
             "comment without a reason"]
    for rid in sorted(staticrules.RULES):
        r = staticrules.RULES[rid]
        lines.append(f"{r.id}  {r.name}  [{', '.join(r.scope)}]\n"
                     f"        {r.invariant}")
    lines.append(BTF002_ABSENT)
    return "\n".join(sorted(lines))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="staticcheck",
        description="AST lint for the port's serving contracts "
                    "(locks, host-sync, determinism, generators)")
    ap.add_argument("paths", nargs="*",
                    help=f"files/trees to lint (default: "
                         f"{' '.join(DEFAULT_TREES)})")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--json", action="store_true",
                    help="one JSON object per finding (jsonl)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print suppressed findings (never affect "
                         "the exit status)")
    ap.add_argument("--force", action="store_true",
                    help="run every rule on every given path, ignoring "
                         "per-rule scopes (ad-hoc sweeps)")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(list_rules())
        return 0

    paths = [Path(p) for p in args.paths] if args.paths \
        else [REPO / t for t in DEFAULT_TREES]
    for p in paths:
        if not p.exists():
            print(f"staticcheck: no such path: {p}", file=sys.stderr)
            return 2
    findings = run_paths(paths, force=args.force)
    unsuppressed = [f for f in findings if not f.suppressed]
    shown = findings if args.show_suppressed else unsuppressed
    for f in shown:
        if args.json:
            print(json.dumps(vars(f), sort_keys=True))
        else:
            print(f.render())
    n_sup = sum(1 for f in findings if f.suppressed)
    if not args.json:
        print(f"staticcheck: {len(unsuppressed)} finding(s), "
              f"{n_sup} suppressed", file=sys.stderr)
    return 1 if unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
