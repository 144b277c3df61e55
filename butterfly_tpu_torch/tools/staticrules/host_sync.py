"""BTF003 — no host synchronization inside the dispatch hot path.

The port's copy of tools/staticrules/host_sync.py, scoped to the port's
serving engine, scheduler, tick log and time-series ring, and taught
torch's host syncs. The serving tick runs dispatch-ahead: the HOT
functions (tick, operand assembly, block dispatch, and in the port the
eager Python loops that replace the JAX package's jitted scans) never
materialize a device value, so the host enqueues block t+1 while the
card runs block t. Draining is where synchronization is *intended*; the
drain functions are deliberately outside this rule's hot set.

The rule flags, inside the configured hot functions only:

* ``.item()`` / ``.tolist()`` calls — the unambiguous sync markers
  (the JAX package's ``.block_until_ready()`` / ``jax.device_get`` have
  no torch spelling);
* torch's copies to the host and waits: ``.cpu()``, ``.numpy()``,
  ``.to("cpu")`` / ``.to(device="cpu")``, and ``.synchronize()`` on
  anything (``torch.cuda.synchronize()``, a Stream's, an Event's);
* ``np.asarray(x)`` / ``np.array(x)`` where ``x`` is not host-side by
  construction (a list/tuple/comprehension/constant, or a parameter
  annotated as a host container like ``slots: list[int]``, is
  host->host and fine — the operand-assembly pattern);
* ``int()`` / ``float()`` / ``bool()`` whose argument mentions a
  device-carry name (``*_dev``, or one of the conventional
  device-resident names below) — the exact ``int(logits[...])`` shape
  of a per-token readback.
"""
from __future__ import annotations

import ast
from typing import Iterator, Set

from . import FileContext, Finding, Rule, call_name, dotted_name, register

#: functions whose bodies must stay sync-free. Drain/emit functions are
#: intentionally absent: the stacked drain is the one blessed fetch. The
#: JAX package's set (every name exists in the port's scheduler and
#: serving engine), plus the port's own: the mixed and mixed-spec block
#: dispatches, and the eager per-step loops that stand in for the JAX
#: package's jitted lax.scan bodies (a sync there would run once per
#: step of every block).
HOT_FUNCTIONS: Set[str] = {
    "tick", "_decode_block", "_spec_block", "_assemble", "_admit",
    "_admit_round", "_finish_prefill", "_note_bubble",
    "decode_block_async", "spec_block_async", "decode_active_async",
    "prefill_batch", "_sync_table",
    # the seq-parallel long-prompt lane — one chunk dispatch per tick
    "_sp_prefill_step", "sp_prefill_chunk",
    "_phase_add", "_drain_accrued", "_record_tick",
    "record", "note", "poll",
    # the signal recorder samples inside _record_tick
    "sample", "evaluate_rules",
    # the port's own hot functions
    "_mixed_block", "mixed_block_async", "mixed_spec_block_async",
    "_decode_all", "_decode_scan", "_decode_scan_win", "_mixed_scan",
    "_mixed_scan_win", "_spec_scan", "_spec_scan_win", "_spec_tree_scan",
    "_spec_tree_scan_win", "_mixed_spec_scan", "_mixed_spec_scan_win",
}

#: conventional device-resident value names in the hot path (plus any
#: name suffixed _dev): int()/float()/bool() over these is a readback
DEVICE_NAMES: Set[str] = {"logits", "final", "firsts", "block", "carry",
                          "toks3", "valid3"}

_LITERALS = (ast.List, ast.Tuple, ast.ListComp, ast.GeneratorExp,
             ast.Constant, ast.Dict, ast.Set, ast.SetComp, ast.DictComp)

#: annotation heads marking a parameter as a host-side container —
#: np.asarray over one is host->host operand assembly, not a device sync
_HOST_CONTAINER_ANNOTATIONS = {"list", "List", "tuple", "Tuple",
                               "Sequence", "Iterable", "dict", "Dict"}


def _host_container_params(fn: ast.FunctionDef):
    """Parameter names whose annotation is a host container type."""
    out = set()
    for arg in (list(fn.args.posonlyargs) + list(fn.args.args)
                + list(fn.args.kwonlyargs)):
        ann = arg.annotation
        if ann is None:
            continue
        head = ann.value if isinstance(ann, ast.Subscript) else ann
        if isinstance(head, ast.Name) and \
                head.id in _HOST_CONTAINER_ANNOTATIONS:
            out.add(arg.arg)
    return out


def _mentions_device_name(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            if sub.id in DEVICE_NAMES or sub.id.endswith("_dev"):
                return True
        if isinstance(sub, ast.Attribute):
            if sub.attr in DEVICE_NAMES or sub.attr.endswith("_dev"):
                return True
    return False


def _is_cpu(node: ast.AST) -> bool:
    """The literal "cpu" device ("cpu", torch.device("cpu"))."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return isinstance(node, ast.Call) and \
        dotted_name(node.func) in ("torch.device", "device") and \
        bool(node.args) and _is_cpu(node.args[0])


def _to_cpu(node: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` (a copy to the host)."""
    if node.args and _is_cpu(node.args[0]):
        return True
    return any(kw.arg == "device" and _is_cpu(kw.value)
               for kw in node.keywords)


@register
class HostSyncRule(Rule):
    id = "BTF003"
    name = "host-sync-in-hot-path"
    invariant = ("tick/dispatch hot functions never materialize a "
                 "device value on the host (sync belongs to the "
                 "stacked drain)")
    scope = ("butterfly_tpu_torch/engine/serving.py",
             "butterfly_tpu_torch/sched/scheduler.py",
             "butterfly_tpu_torch/obs/ticklog.py",
             "butterfly_tpu_torch/obs/timeseries.py")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in HOT_FUNCTIONS:
                yield from self._check_hot(ctx, node)

    def _check_hot(self, ctx: FileContext,
                   fn: ast.FunctionDef) -> Iterator[Finding]:
        host_params = _host_container_params(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node.func)
            where = f"in hot function {fn.name}()"
            is_method = isinstance(node.func, ast.Attribute)
            if name in ("item", "tolist", "cpu", "numpy",
                        "synchronize") and is_method:
                yield self.finding(
                    ctx, node,
                    f".{name}() {where} synchronously materializes a "
                    f"device value — move it to the stacked drain")
                continue
            if name == "to" and is_method and _to_cpu(node):
                yield self.finding(
                    ctx, node,
                    f".to(\"cpu\") {where} copies a device value to the "
                    f"host and waits for it — move it to the stacked "
                    f"drain")
                continue
            dotted = dotted_name(node.func)
            if dotted in ("np.asarray", "np.array", "numpy.asarray",
                          "numpy.array"):
                arg0 = node.args[0] if node.args else None
                is_host_param = (isinstance(arg0, ast.Name)
                                 and arg0.id in host_params)
                if arg0 is not None and not is_host_param and \
                        not isinstance(arg0, _LITERALS):
                    yield self.finding(
                        ctx, node,
                        f"{dotted}(...) on a non-literal {where} may "
                        f"fetch a device array to the host — convert at "
                        f"the drain, or build from host lists")
                continue
            if name in ("int", "float", "bool") and \
                    isinstance(node.func, ast.Name) and node.args and \
                    _mentions_device_name(node.args[0]):
                yield self.finding(
                    ctx, node,
                    f"{name}() over a device-carry value {where} is a "
                    f"per-token host readback — keep the value "
                    f"device-resident")
