"""BTF005 — workload/chaos determinism: no unseeded randomness, no
wall-clock reads.

The port's copy of tools/staticrules/determinism.py, scoped to the
port's trace-feeding code. The workload contract is byte-identical
traces: ``sample(n, seed)`` / ``times(n, seed)`` are per-request
substreamed so replay, the mixed bench and the chaos soak reproduce
exactly. One bare ``random.random()`` (module-global PRNG, process
seeded), ``torch.rand(...)`` without a generator (torch's global
generator) or ``time.time()`` (wall clock) in that path silently breaks
replay while every test still passes on its own machine. The chaos plan
carries the same contract (same plan + seed + call sequence => identical
injections).

Flags, in the trace-feeding scope (workload/ with its loadgen and
replay, fleet/chaos.py, and the obs time-series ring, whose ordering
contract is seq + monotonic only — wall stamps are caller-supplied):

* module-global PRNG draws: ``random.<fn>()`` for any fn except the
  ``Random``/``SystemRandom`` constructors; ``np.random.<fn>()`` except
  the seedable constructor forms;
* torch draws from the global generator: ``torch.rand``, ``randn``,
  ``randint``, ``randperm``, ``multinomial``, ``bernoulli``, ``normal``
  and the in-place ``Tensor.uniform_`` / ``exponential_`` /
  ``normal_`` / ``bernoulli_`` / ``random_`` without
  ``generator=``, and ``torch.manual_seed(...)`` (it reseeds the global
  generator every other module draws from);
* unseeded constructors: ``random.Random()`` / ``np.random.default_rng()``
  with no arguments;
* wall-clock reads: ``time.time()`` (``time.monotonic`` /
  ``perf_counter`` measure elapsed time and stay legal — open-loop
  pacing needs them);
* entropy sources: ``os.urandom``, ``uuid.uuid4``, ``secrets.*``.
"""
from __future__ import annotations

import ast
from typing import Iterator

from . import FileContext, Finding, Rule, dotted_name, register

_SEEDED_CONSTRUCTORS = {"Random", "SystemRandom"}
_NP_SEEDED = {"default_rng", "RandomState", "Generator", "SeedSequence",
              "PCG64", "Philox"}

#: torch's drawing functions (``torch.<fn>(...)``) and in-place Tensor
#: draws (``x.<fn>(...)``): each takes ``generator=``; without one it
#: draws from torch's process-global generator
TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "multinomial",
               "bernoulli", "normal"}
TENSOR_DRAWS = {"uniform_", "exponential_", "normal_", "bernoulli_",
                "random_"}


def has_generator(node: ast.Call) -> bool:
    """Does this draw name its generator (a ``generator=`` keyword that
    is not the literal None, or a ``**kwargs`` splat)?"""
    for kw in node.keywords:
        if kw.arg is None:
            return True
        if kw.arg == "generator":
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value is None)
    return False


@register
class DeterminismRule(Rule):
    id = "BTF005"
    name = "workload-determinism"
    invariant = ("trace-feeding code draws only from seeded generators "
                 "and never reads the wall clock")
    scope = ("butterfly_tpu_torch/workload",
             "butterfly_tpu_torch/fleet/chaos.py",
             "butterfly_tpu_torch/obs/timeseries.py")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in TENSOR_DRAWS and \
                    not has_generator(node):
                yield self.finding(
                    ctx, node,
                    f"Tensor.{node.func.attr}() without generator= draws "
                    f"from torch's global generator — pass a "
                    f"torch.Generator seeded from the workload seed")
                continue
            dotted = dotted_name(node.func)
            if not dotted:
                continue
            yield from self._check_call(ctx, node, dotted)

    def _check_call(self, ctx: FileContext, node: ast.Call,
                    dotted: str) -> Iterator[Finding]:
        parts = dotted.split(".")
        # torch.<draw> — the process-global torch generator
        if parts[0] == "torch" and len(parts) == 2:
            fn = parts[1]
            if fn in TORCH_DRAWS and not has_generator(node):
                yield self.finding(
                    ctx, node,
                    f"torch.{fn}() without generator= draws from torch's "
                    f"global generator — pass a torch.Generator seeded "
                    f"from the workload seed")
            elif fn == "manual_seed":
                yield self.finding(
                    ctx, node,
                    "torch.manual_seed() reseeds the process-global "
                    "generator under every other module — seed a "
                    "torch.Generator of this trace instead")
            return
        # random.<fn> — the module-global, process-seeded PRNG. The
        # constructors are the blessed path (they take the seed).
        if parts[0] == "random" and len(parts) == 2:
            fn = parts[1]
            if fn in _SEEDED_CONSTRUCTORS:
                if fn == "Random" and not node.args:
                    yield self.finding(
                        ctx, node,
                        "random.Random() without a seed draws from OS "
                        "entropy — pass the workload/plan seed so the "
                        "trace replays byte-identically")
            else:
                yield self.finding(
                    ctx, node,
                    f"module-global random.{fn}() breaks trace "
                    f"determinism — draw from a seeded random.Random "
                    f"substream instead")
            return
        # np.random.* — same contract for the numpy global state
        if len(parts) >= 3 and parts[-3] in ("np", "numpy") and \
                parts[-2] == "random":
            fn = parts[-1]
            if fn in _NP_SEEDED:
                if fn == "default_rng" and not node.args:
                    yield self.finding(
                        ctx, node,
                        "np.random.default_rng() without a seed draws "
                        "from OS entropy — pass the workload seed")
            else:
                yield self.finding(
                    ctx, node,
                    f"np.random.{fn}() uses numpy's global PRNG state — "
                    f"use a seeded default_rng(seed)")
            return
        if dotted == "time.time":
            yield self.finding(
                ctx, node,
                "time.time() is a wall-clock read: traces recorded "
                "against it never replay identically — use "
                "time.monotonic() for pacing/elapsed measurement")
            return
        if dotted == "os.urandom" or dotted == "uuid.uuid4" or \
                parts[0] == "secrets":
            yield self.finding(
                ctx, node,
                f"{dotted}() is an OS entropy source — trace-feeding "
                f"code must derive everything from the recorded seed")
