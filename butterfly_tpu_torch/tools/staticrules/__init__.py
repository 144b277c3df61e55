"""The port's static analysis: the rule framework.

A copy of the repo's tools/staticrules/__init__.py (the JAX package's
checker), so that the port lints itself without reading tools/: the
same Finding, suppressions, FileContext and @register, with the rules
scoped to butterfly_tpu_torch/ paths. A rule is a class with:

* ``id``        — "BTF0xx" (stable, referenced by suppressions)
* ``name``      — kebab-case slug
* ``invariant`` — the one-line contract the rule enforces
* ``scope``     — repo-relative path prefixes (or exact files) the rule
  applies to. Scoping is deliberate: host-sync is a hot-path contract,
  determinism a workload/chaos contract — flagging them tree-wide would
  drown the real signal in intentional uses.
* ``check(ctx)`` — yield ``Finding``s for one parsed file.

Suppressions are inline comments::

    urlopen(url)  # btf: disable=BTF001 <one-line reason>
    # btf: disable=BTF003,BTF006 <one-line reason>   (covers next line)

A reason is MANDATORY: a reason-less disable is itself reported as
BTF000 (and BTF000 cannot be suppressed).

BTF002 (use after donation) has no counterpart: torch has no
``donate_argnums``, so no call of the port gives its argument's buffer
away. The checker is mutation-tested like the rest of the port
(butterfly_tpu_torch/tools/mutcheck.py: one weakened predicate per rule,
killed by the fixtures in tests/staticcheck_fixtures/torch/).
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

#: ``# btf: disable=BTF001[,BTF003] reason...`` — the reason group is
#: everything after the id list; empty means a bare (illegal) suppression.
_SUPPRESS_RE = re.compile(
    r"#\s*btf:\s*disable=(?P<ids>BTF\d{3}(?:\s*,\s*BTF\d{3})*)"
    r"[ \t]*(?P<reason>[^\n]*)")

#: The framework's own rule id: a suppression without a reason. Not
#: registered as a Rule (it has no check method) and never suppressible.
BARE_SUPPRESSION_ID = "BTF000"


@dataclass
class Finding:
    rule: str          # "BTF001"
    path: str          # repo-relative posix path
    line: int          # 1-based
    col: int           # 0-based
    message: str
    suppressed: bool = False
    reason: str = ""   # the suppression's reason when suppressed

    def render(self) -> str:
        tag = " (suppressed: %s)" % self.reason if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: " \
               f"{self.rule} {self.message}{tag}"


@dataclass
class Suppression:
    line: int          # line the comment sits on
    ids: Tuple[str, ...]
    reason: str
    standalone: bool   # comment-only line: also covers the next line
    used: bool = False


@dataclass
class FileContext:
    """One parsed file, shared by every rule that applies to it."""
    path: Path
    relpath: str       # repo-relative posix
    source: str
    tree: ast.AST
    suppressions: List[Suppression] = field(default_factory=list)


def parse_suppressions(source: str) -> List[Suppression]:
    out = []
    for i, raw in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(raw)
        if not m:
            continue
        ids = tuple(s.strip() for s in m.group("ids").split(","))
        out.append(Suppression(
            line=i, ids=ids, reason=m.group("reason").strip(),
            standalone=raw.lstrip().startswith("#")))
    return out


def make_context(path: Path, relpath: str) -> FileContext:
    source = path.read_text(encoding="utf-8")
    tree = ast.parse(source, filename=str(path))
    return FileContext(path=path, relpath=relpath, source=source,
                       tree=tree, suppressions=parse_suppressions(source))


class Rule:
    id: str = "BTF0xx"
    name: str = "unnamed"
    invariant: str = ""
    #: repo-relative path prefixes / exact files this rule walks
    scope: Tuple[str, ...] = ()

    def applies(self, relpath: str) -> bool:
        return any(relpath == p or relpath.startswith(p.rstrip("/") + "/")
                   for p in self.scope)

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: FileContext, node: ast.AST,
                message: str) -> Finding:
        return Finding(rule=self.id, path=ctx.relpath,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0),
                       message=message)


#: id -> rule instance. Populated by @register at import time; the
#: checker, the tier-1 test, and the mutcheck mutants all read this one
#: registry, so a rule cannot be silently dropped from one surface.
RULES: Dict[str, Rule] = {}


def register(cls):
    rule = cls()
    if rule.id in RULES:
        raise ValueError(f"duplicate rule id {rule.id}")
    RULES[rule.id] = rule
    return cls


def _statement_spans(tree: ast.AST) -> List[Tuple[int, int]]:
    return [(n.lineno, n.end_lineno or n.lineno)
            for n in ast.walk(tree)
            if isinstance(n, ast.stmt) and hasattr(n, "lineno")]


def suppression_lines(ctx: FileContext, s: Suppression) -> range:
    """The line range a suppression covers: the innermost statement
    containing its line (a trailing comment anywhere in a multi-line
    call covers the whole call), or — for a standalone comment line —
    the whole next statement (skipping further comment/blank lines)."""
    lines = ctx.source.splitlines()
    target = s.line
    if s.standalone:
        target = s.line + 1
        while target <= len(lines) and (
                not lines[target - 1].strip()
                or lines[target - 1].lstrip().startswith("#")):
            target += 1
    best: Optional[Tuple[int, int]] = None
    for lo, hi in _statement_spans(ctx.tree):
        if lo <= target <= hi:
            if best is None or (hi - lo) < (best[1] - best[0]):
                best = (lo, hi)
    if best is None:
        return range(target, target + 1)
    return range(best[0], best[1] + 1)


def apply_suppressions(ctx: FileContext,
                       findings: List[Finding]) -> List[Finding]:
    """Mark findings covered by a same-statement (or preceding
    standalone-comment) suppression; append a BTF000 finding per
    reason-less suppression. Returns the full (marked) finding list."""
    by_line: Dict[int, List[Suppression]] = {}
    for s in ctx.suppressions:
        for line in suppression_lines(ctx, s):
            by_line.setdefault(line, []).append(s)
    for f in findings:
        for s in by_line.get(f.line, ()):
            if f.rule in s.ids and s.reason:
                f.suppressed, f.reason = True, s.reason
                s.used = True
    out = list(findings)
    for s in ctx.suppressions:
        if not s.reason:
            out.append(Finding(
                rule=BARE_SUPPRESSION_ID, path=ctx.relpath, line=s.line,
                col=0,
                message="bare suppression: '# btf: disable=' needs a "
                        "one-line reason after the rule id(s)"))
    return out


def check_context(ctx: FileContext, rules: Optional[Iterable[Rule]] = None,
                  force: bool = False) -> List[Finding]:
    """Run rules over one parsed file. ``force=True`` skips scope
    filtering (fixture tests drive rules at out-of-scope paths)."""
    active = list(rules) if rules is not None else list(RULES.values())
    findings: List[Finding] = []
    for rule in active:
        if force or rule.applies(ctx.relpath):
            findings.extend(rule.check(ctx))
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return apply_suppressions(ctx, findings)


def check_file(path: Path, relpath: Optional[str] = None,
               rules: Optional[Iterable[Rule]] = None,
               force: bool = False) -> List[Finding]:
    rel = relpath if relpath is not None else path.as_posix()
    return check_context(make_context(path, rel), rules=rules, force=force)


# -- shared AST helpers -------------------------------------------------------

def call_name(func: ast.AST) -> str:
    """Last segment of a call target: urlopen, HTTPConnection, ..."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def dotted_name(node: ast.AST) -> str:
    """'urllib.request.urlopen' for a Name/Attribute chain, '' if the
    chain bottoms out in anything else (a call, a subscript, ...)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


# -- rule modules (import order = catalog order) -----------------------------
# Imported for the @register side effect; the names also give callers a
# stable module path per rule (mutcheck mutates these files).
from . import http_timeout   # noqa: E402,F401  BTF001
from . import host_sync      # noqa: E402,F401  BTF003
from . import locks          # noqa: E402,F401  BTF004
from . import determinism    # noqa: E402,F401  BTF005
from . import prng           # noqa: E402,F401  BTF006
