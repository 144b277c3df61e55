"""BTF006 — generator discipline in the sampling paths, settled for
torch.

The port's counterpart of tools/staticrules/prng.py. The serving
sampler's correctness contract (tests/test_torch_spec_sampling.py holds
its distributions to the JAX package's) holds only if every draw comes
from a generator the engine seeded from the request or scheduler seed.
The JAX rule's first check, one key consumed by two draws, does not
carry over: a ``torch.Generator`` advances its state at every draw, so
drawing from one generator many times gives independent samples, as
the JAX package's ``split`` does. What does carry over:

* **global draw** — a draw with no generator: ``torch.rand``, ``randn``,
  ``randint``, ``randperm``, ``multinomial``, ``bernoulli``, ``normal``
  and the in-place ``Tensor.uniform_`` / ``exponential_`` / ... without
  ``generator=`` (or with ``generator=None``), and the project's own
  sampling wrappers (``sample``, ``sample_batched``,
  ``speculative_accept``, ``speculative_tree_accept``,
  ``gumbel_argmax``) called without their generator argument or with a
  literal None: each then draws from torch's process-global generator,
  which any module may reseed or advance, so no request's stream is its
  own;
* **constant seed** — ``<generator>.manual_seed(<literal>)`` or
  ``torch.manual_seed(<literal>)`` in serving-path code, the JAX rule's
  "no constant PRNGKey": every call draws the identical stream. A
  constant seed is only legitimate for deliberately deterministic demo
  weight init, which carries an inline suppression explaining exactly
  that.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator

from . import FileContext, Finding, Rule, call_name, dotted_name, register
from .determinism import TENSOR_DRAWS, TORCH_DRAWS, has_generator

#: project sampling wrappers: callable name -> generator argument position
PROJECT_CONSUMERS: Dict[str, int] = {
    "sample": 1,                    # sample(logits, generator, sp)
    "sample_batched": 1,            # sample_batched(logits, generator, ...)
    "gumbel_argmax": 1,             # gumbel_argmax(scaled, generator)
    "speculative_accept": 2,        # (logits, drafts, generator, ...)
    "speculative_tree_accept": 2,
}


def _is_none(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value is None


def _wrapper_without_generator(node: ast.Call) -> bool:
    """A project wrapper called with no generator (or a literal None)."""
    if not isinstance(node.func, ast.Name) or \
            node.func.id not in PROJECT_CONSUMERS:
        return False
    pos = PROJECT_CONSUMERS[node.func.id]
    if pos < len(node.args):
        return _is_none(node.args[pos])
    for kw in node.keywords:
        if kw.arg is None:
            return False              # **kwargs splat: cannot see inside
        if kw.arg == "generator":
            return _is_none(kw.value)
    return True


@register
class PrngDisciplineRule(Rule):
    id = "BTF006"
    name = "prng-key-discipline"
    invariant = ("every sampling draw names a generator seeded from the "
                 "request/scheduler seed; no constant seed in the "
                 "serving path")
    scope = ("butterfly_tpu_torch/engine", "butterfly_tpu_torch/sched",
             "butterfly_tpu_torch/serve",
             "butterfly_tpu_torch/fleet/harness.py",
             "butterfly_tpu_torch/ckpt")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node.func)
            if name == "manual_seed" and node.args and \
                    isinstance(node.args[0], ast.Constant):
                yield self.finding(
                    ctx, node,
                    f"constant seed manual_seed({node.args[0].value!r}) in "
                    f"the serving path: every call draws the identical "
                    f"stream — derive the seed from the request/scheduler "
                    f"seed")
            elif self._global_draw(node):
                yield self.finding(
                    ctx, node,
                    f"{name}(...) without a generator draws from torch's "
                    f"process-global generator: no request owns its "
                    f"stream — pass the engine's seeded torch.Generator")

    @staticmethod
    def _global_draw(node: ast.Call) -> bool:
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in TENSOR_DRAWS:
            return not has_generator(node)
        parts = dotted_name(func).split(".")
        if len(parts) == 2 and parts[0] == "torch" and \
                parts[1] in TORCH_DRAWS:
            return not has_generator(node)
        return _wrapper_without_generator(node)
