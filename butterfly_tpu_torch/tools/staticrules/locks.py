"""BTF004 — serving-lock discipline.

The port's copy of tools/staticrules/locks.py, scoped to the port's
serve, router, fleet, sched, obs and cache trees. HTTP handler threads
must not pin themselves on ``state.lock`` while a slow or hung tick
holds it (the bounded ``ServerState.acquire_lock`` / ``_locked``
contract answers 503 with LockTimeout instead), and no lock holder may
block on network work. The scheduler thread itself may hold the lock
unboundedly (it OWNS the device); the contract binds the *other*
threads.

Four checks, scoped to the serving/router/fleet HTTP tier:

* **unbounded acquire** — ``<lockish>.acquire()`` without a ``timeout=``
  anywhere in scope. A hung tick holds the serving lock forever; an
  unbounded acquire on any thread but the scheduler loop pins that
  thread with it. (The one blessed unbounded form is the ``with lock:``
  statement on the scheduler thread — handler classes are denied even
  that, next check.)
* **raw lock in a handler class** — ``with <x>.lock:`` or
  ``<x>.lock.acquire(...)`` inside a ``*Handler`` class:
  handler threads must go through the bounded
  ``ServerState.acquire_lock``/``_locked`` contract so they 503 instead
  of hanging.
* **network I/O under a lock** — an outbound HTTP call (urlopen /
  HTTPConnection) lexically inside any ``with <lock-ish>:`` block: a
  lock holder waiting on a peer couples every local waiter to that
  peer's latency.
* **unlocked shared-counter write in a handler class** — handler
  threads are multi-writer, so instrument updates
  (``<x>._c_*/._g_*/._h_* .inc()/.set()/.observe()`` or ``+=`` on such
  an attribute) must sit inside a ``with <lock-ish>:`` block (the
  single-writer scheduler-thread registry contract does not apply to
  handlers).
"""
from __future__ import annotations

import ast
from typing import Iterator, List

from . import FileContext, Finding, Rule, call_name, dotted_name, register

_HTTP_CALLS = {"urlopen", "HTTPConnection", "HTTPSConnection",
               "create_connection"}

#: instrument naming convention (scheduler/router/fleet registries):
#: counters _c_*, gauges _g_*, histograms _h_*
_INSTRUMENT_PREFIXES = ("_c_", "_g_", "_h_")

_INSTRUMENT_METHODS = {"inc", "set", "observe", "dec"}


def _is_lockish(expr: ast.AST) -> bool:
    """Does this with-context expression look like a lock acquisition?
    `with self.lock:`, `with state._mlock:`, `with self._locked():`."""
    if isinstance(expr, ast.Call):
        name = call_name(expr.func)
        return "lock" in name.lower()
    name = dotted_name(expr)
    return "lock" in name.rsplit(".", 1)[-1].lower() if name else False


def _is_handler_class(cls: ast.ClassDef) -> bool:
    if cls.name.endswith("Handler"):
        return True
    for base in cls.bases:
        base_name = dotted_name(base)
        if "Handler" in base_name or "handler" in base_name:
            return True
    return False


def _mentions_instrument(expr: ast.AST) -> bool:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Attribute) and \
                sub.attr.startswith(_INSTRUMENT_PREFIXES):
            return True
    return False


@register
class LockDisciplineRule(Rule):
    id = "BTF004"
    name = "lock-discipline"
    invariant = ("handler threads use the bounded acquire contract, no "
                 "lock holder does network I/O, and handler-thread "
                 "instrument writes are locked")
    scope = ("butterfly_tpu_torch/serve", "butterfly_tpu_torch/router",
             "butterfly_tpu_torch/fleet", "butterfly_tpu_torch/sched",
             "butterfly_tpu_torch/obs", "butterfly_tpu_torch/cache")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        yield from self._check_acquires(ctx)
        yield from self._check_under_locks(ctx)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef) and _is_handler_class(node):
                yield from self._check_handler_class(ctx, node)

    # -- unbounded .acquire() ------------------------------------------------

    def _check_acquires(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not (isinstance(func, ast.Attribute)
                    and func.attr == "acquire"):
                continue
            owner = dotted_name(func.value)
            if "lock" not in owner.rsplit(".", 1)[-1].lower():
                continue
            if any(kw.arg == "timeout" for kw in node.keywords) or \
                    any(kw.arg is None for kw in node.keywords) or \
                    node.args:
                continue
            yield self.finding(
                ctx, node,
                f"unbounded {owner}.acquire(): a hung tick holds the "
                f"serving lock forever — pass timeout= (or use "
                f"ServerState.acquire_lock / _locked)")

    # -- blocking work while holding a lock ----------------------------------

    def _check_under_locks(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            if not any(_is_lockish(i.context_expr) for i in node.items):
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and \
                        call_name(sub.func) in _HTTP_CALLS:
                    yield self.finding(
                        ctx, sub,
                        f"network I/O ({call_name(sub.func)}) while "
                        f"holding a lock: every waiter on this lock now "
                        f"shares the peer's latency/timeout — move the "
                        f"call outside the critical section")

    # -- handler-class checks ------------------------------------------------

    def _check_handler_class(self, ctx: FileContext,
                             cls: ast.ClassDef) -> Iterator[Finding]:
        # raw lock use: with <x>.lock / <x>.lock.acquire
        for node in ast.walk(cls):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    name = dotted_name(item.context_expr)
                    if name.endswith(".lock"):
                        yield self.finding(
                            ctx, item.context_expr,
                            f"raw 'with {name}:' in handler class "
                            f"{cls.name}: handler threads must use the "
                            f"bounded ServerState.acquire_lock/_locked "
                            f"contract (503 + Retry-After, never a hang)")
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "acquire":
                owner = dotted_name(node.func.value)
                if owner.endswith(".lock"):
                    yield self.finding(
                        ctx, node,
                        f"raw {owner}.acquire(...) in handler class "
                        f"{cls.name}: use the bounded "
                        f"ServerState.acquire_lock/_locked contract")
        # unlocked instrument writes
        locked_spans: List[ast.AST] = [
            n for n in ast.walk(cls)
            if isinstance(n, (ast.With, ast.AsyncWith))
            and any(_is_lockish(i.context_expr) for i in n.items)]

        def under_lock(node: ast.AST) -> bool:
            return any(node in set(ast.walk(w)) for w in locked_spans)

        for node in ast.walk(cls):
            hit = None
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _INSTRUMENT_METHODS and \
                    _mentions_instrument(node.func.value):
                hit = node
            elif isinstance(node, ast.AugAssign) and \
                    _mentions_instrument(node.target):
                hit = node
            if hit is not None and not under_lock(hit):
                yield self.finding(
                    ctx, hit,
                    f"unlocked shared-instrument write in handler class "
                    f"{cls.name}: handler threads are multi-writer — "
                    f"take the metrics lock (the state.inc/state.count "
                    f"pattern) or lose increments under concurrency")
