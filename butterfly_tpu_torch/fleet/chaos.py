"""Seeded fault injection for the serving fleet (the chaos harness).

The fleet's failure matrix (docs/fleet.md) was hand-tested: kill a
replica here, wedge one there, eyeball the fallback. This module makes
those faults *injectable, deterministic, and countable* so a soak can
assert the system-level property — every submitted request reaches a
terminal outcome (tokens, 429, or 504) — instead of hoping the right
failure happened to fire.

A ``ChaosPlan`` is a seeded list of fault rules. Each rule scopes a
fault to a *target* (replica role, ``role:index``, exact ``host:port``
rid, or ``*``), an *endpoint* (path, or ``*`` for any path except
``/health`` — liveness probing stays honest unless a rule names
``/health`` explicitly), an injection *probability*, and a *count*
budget. Rules draw from their OWN ``random.Random(seed, rule index)``
stream, so the decision sequence is a pure function of (plan JSON,
seed, sequence of matching calls) — the determinism test replays a
call sequence and gets byte-identical injections.

Fault kinds:

=============  =============================================================
``delay``      sleep ``delay_s`` before serving normally (slow replica)
``error``      respond 500 with a JSON error body (application fault)
``wedge``      respond 503 (the heartbeat-latch shape the router retries
               and degrades on)
``drop``       close the socket before any response byte (SIGKILL between
               accept and response — the proxy's refused/garbled path)
``truncate``   send a 200 status claiming a longer body than is written,
               then close mid-body (replica death mid-response; the
               proxy's buffer-before-first-client-byte path)
``slow_stream``serve normally but throttle every response write by
               ``delay_s`` (stuck-but-alive replica; read-timeout path)
=============  =============================================================

Hook points:

* the in-process harness (fleet/harness.py) wraps each replica's HTTP
  handler in :func:`make_chaos_handler` (``where="replica"``);
* the control plane's ``_call`` consults the plan before every handoff
  leg (``where="call"`` — the "network between control plane and
  replica" faults: ``delay`` sleeps, ``drop`` fails the leg as a
  transport error, feeding the same pool/breaker accounting a real
  refused connect would).

Driven by ``butterfly fleet --chaos plan.json`` and the chaos soak in
tests/test_torch_chaos.py / obs/benchmark.py:run_chaos_benchmark.

stdlib-only (importable without torch, like the rest of the router
tier). A copy of butterfly_tpu/fleet/chaos.py.
"""
from __future__ import annotations

import json
import random
import threading
import time
from typing import Dict, List, Optional

KINDS = ("delay", "error", "wedge", "drop", "truncate", "slow_stream")
WHERES = ("replica", "call")


class ChaosIdent:
    """Who a fault-plan target matches against: one replica's identity
    as the harness knows it (role + index within the role + bound rid).
    The rid is only known after the port binds, so plans usually target
    roles ('prefill', 'decode:1') which are stable across runs."""

    __slots__ = ("rid", "role", "index")

    def __init__(self, rid: str = "", role: str = "both", index: int = 0):
        self.rid = rid
        self.role = role
        self.index = index

    def matches(self, target: str) -> bool:
        return target in ("*", self.role, f"{self.role}:{self.index}",
                          self.rid)


class FaultRule:
    """One scoped fault. Draws come from a per-rule seeded stream so
    adding/removing one rule never perturbs another's decisions."""

    __slots__ = ("kind", "target", "endpoint", "where", "p", "count",
                 "delay_s", "rng", "injected")

    def __init__(self, kind: str, target: str = "*", endpoint: str = "*",
                 where: str = "replica", p: float = 1.0,
                 count: Optional[int] = None, delay_s: float = 0.05,
                 seed: int = 0, index: int = 0):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(expected one of {KINDS})")
        if where not in WHERES:
            raise ValueError(f"unknown fault scope {where!r} "
                             f"(expected one of {WHERES})")
        if not 0.0 <= float(p) <= 1.0:
            raise ValueError(f"fault probability must be in [0, 1], got {p}")
        if count is not None and int(count) < 1:
            raise ValueError(f"fault count must be >= 1, got {count}")
        self.kind = kind
        self.target = str(target)
        self.endpoint = str(endpoint)
        self.where = where
        self.p = float(p)
        self.count = None if count is None else int(count)
        self.delay_s = float(delay_s)
        # Independent stream per rule: (seed, index) — deterministic
        # regardless of how other rules draw.
        self.rng = random.Random((int(seed) << 16) ^ index)
        self.injected = 0

    def spec(self) -> Dict:
        return {"kind": self.kind, "target": self.target,
                "endpoint": self.endpoint, "where": self.where,
                "p": self.p, "count": self.count, "delay_s": self.delay_s,
                "injected": self.injected}


class Injection:
    """One decided fault (what a hook applies)."""

    __slots__ = ("kind", "delay_s", "rule")

    def __init__(self, rule: FaultRule):
        self.kind = rule.kind
        self.delay_s = rule.delay_s
        self.rule = rule


class ChaosPlan:
    """A seeded, deterministic fault plan.

    ``decide(ident, endpoint, where)`` is the single decision point:
    first matching rule with remaining budget draws from its stream;
    a draw below ``p`` consumes one count and returns an Injection.
    Thread-safe (one lock around the draw + budget), and the decision
    sequence per rule is deterministic given the same sequence of
    matching calls — concurrent soaks inject the same fault *set* up
    to arrival-order interleaving; the determinism test drives calls
    sequentially for byte-identical replay.
    """

    def __init__(self, rules: List[Dict], seed: int = 0):
        self.seed = int(seed)
        self.rules = [FaultRule(seed=self.seed, index=i, **r)
                      for i, r in enumerate(rules)]
        self._lock = threading.Lock()
        self.log: List[Dict] = []  # bounded injection log (tests/state)

    @classmethod
    def from_json(cls, obj: Dict) -> "ChaosPlan":
        if not isinstance(obj, dict) or "faults" not in obj:
            raise ValueError('chaos plan must be {"seed": int, '
                             '"faults": [{...}, ...]}')
        return cls(list(obj["faults"]), seed=int(obj.get("seed", 0)))

    @classmethod
    def from_file(cls, path: str) -> "ChaosPlan":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_json(json.load(f))

    def decide(self, ident: ChaosIdent, endpoint: str,
               where: str = "replica") -> Optional[Injection]:
        path = endpoint.split("?")[0]
        with self._lock:
            for rule in self.rules:
                if rule.where != where:
                    continue
                if not ident.matches(rule.target):
                    continue
                if rule.endpoint == "*":
                    # '*' never matches /health: a plan that silently
                    # wedged liveness probing would fail the pool, not
                    # the path under test. Name /health to chaos it.
                    if path == "/health":
                        continue
                elif path != rule.endpoint:
                    continue
                if rule.count is not None and rule.injected >= rule.count:
                    continue
                if rule.rng.random() >= rule.p:
                    # the draw is consumed either way (determinism), the
                    # budget only on injection
                    continue
                rule.injected += 1
                if len(self.log) < 4096:
                    self.log.append({"target": ident.rid or ident.role,
                                     "endpoint": path, "kind": rule.kind,
                                     "where": where})
                return Injection(rule)
        return None

    @property
    def total_injected(self) -> int:
        with self._lock:
            return sum(r.injected for r in self.rules)

    def summary(self) -> Dict:
        """The /fleet/state chaos block: per-rule specs + totals."""
        with self._lock:
            return {"seed": self.seed,
                    "rules": [r.spec() for r in self.rules],
                    "total_injected": sum(r.injected for r in self.rules)}


def default_plan(seed: int = 0) -> ChaosPlan:
    """The stock soak plan (bench + `butterfly fleet --chaos default`):
    a slow replica, an application 500, a wedged 503 burst long enough
    to trip the control plane's circuit breaker, a mid-accept drop, a
    truncated body, and a dropped control-plane leg — every row of the
    docs/fleet.md failure matrix that can fire without killing a
    process.

    The envelope deliberately leaves each tier a healthy member: every
    decode-tier fault is confined to decode:0 (decode:1 absorbs), and
    prefill-tier faults only cost a handoff fallback. That is the
    chaos contract under test — with a routable quorum, every client
    request must still reach a terminal outcome (tokens, 429, or 504);
    fault BOTH members of a tier at once and the honest answer becomes
    a 502, which is the rolling-drain soak's one-at-a-time rule, not a
    bug."""
    return ChaosPlan([
        {"kind": "delay", "target": "prefill", "endpoint": "/generate",
         "p": 0.3, "count": 4, "delay_s": 0.05},
        {"kind": "error", "target": "prefill:0", "endpoint": "/generate",
         "p": 0.3, "count": 2},
        {"kind": "wedge", "target": "decode:0", "endpoint": "/generate",
         "p": 1.0, "count": 4},
        {"kind": "drop", "target": "prefill", "endpoint": "/generate",
         "p": 0.2, "count": 2},
        {"kind": "truncate", "target": "prefill:0",
         "endpoint": "/generate", "p": 0.2, "count": 1},
        {"kind": "drop", "target": "prefill", "endpoint": "/generate",
         "where": "call", "p": 0.5, "count": 2},
    ], seed=seed)


# -- the replica-side hook ---------------------------------------------------

class _ThrottledWriter:
    """wfile wrapper: sleep before every write (the slow_stream fault).
    Headers and body alike — a stuck-but-alive replica is slow at
    everything. Unknown attributes (closed, fileno, ...) delegate to
    the real file: the http.server plumbing touches more than write()."""

    def __init__(self, wfile, delay_s: float):
        self._w = wfile
        self._delay = delay_s

    def write(self, data):
        time.sleep(self._delay)
        return self._w.write(data)

    def __getattr__(self, name):
        return getattr(self._w, name)


def make_chaos_handler(base_handler_cls, plan: ChaosPlan,
                       ident: ChaosIdent):
    """Wrap a serve-replica handler class: every GET/POST first asks the
    plan for an injection. Faults that replace the response (error /
    wedge / drop / truncate) short-circuit; delay / slow_stream fall
    through to the real handler."""

    class ChaosHandler(base_handler_cls):

        def _chaos(self) -> bool:
            """Apply any decided injection. True = request consumed."""
            inj = plan.decide(ident, self.path, where="replica")
            if inj is None:
                return False
            if inj.kind == "delay":
                time.sleep(inj.delay_s)
                return False
            if inj.kind == "slow_stream":
                self.wfile = _ThrottledWriter(self.wfile, inj.delay_s)
                return False
            if inj.kind in ("error", "wedge"):
                code = 500 if inj.kind == "error" else 503
                body = json.dumps(
                    {"error": f"chaos: injected {inj.kind}"}).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return True
            if inj.kind == "drop":
                # no status line at all: the client's HTTP layer sees a
                # reset/garbled connect — the proxy's refused path
                self.close_connection = True
                try:
                    self.connection.close()
                except OSError:
                    pass
                return True
            # truncate: a plausible 200 whose body dies mid-write. The
            # canned body stands in for the real one — from the peer's
            # side the failure is identical (Content-Length underrun).
            claimed = 4096
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(claimed))
            self.end_headers()
            try:
                self.wfile.write(b'{"tokens": [')
                self.wfile.flush()
            except OSError:
                pass
            self.close_connection = True
            try:
                self.connection.close()
            except OSError:
                pass
            return True

        def do_POST(self):
            if not self._chaos():
                base_handler_cls.do_POST(self)

        def do_GET(self):
            if not self._chaos():
                base_handler_cls.do_GET(self)

    return ChaosHandler
