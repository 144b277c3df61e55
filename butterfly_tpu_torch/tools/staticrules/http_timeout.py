"""BTF001 — every outbound HTTP call carries an explicit timeout.

The port's copy of tools/staticrules/http_timeout.py, scoped to
butterfly_tpu_torch/ (its router, fleet, workload and command-line
tools).
A ``urlopen(...)`` riding the OS default socket timeout (minutes to
forever) lets one wedged peer pin a control-plane thread invisibly. The
rule sees through multi-line calls, aliased imports and keyword order,
and accepts the timeout positionally where the stdlib signature defines
one.
"""
from __future__ import annotations

import ast
from typing import Iterator

from . import FileContext, Finding, Rule, call_name, register

#: call-name -> index of the positional ``timeout`` parameter in the
#: stdlib signature (urlopen(url, data=None, timeout=...),
#: HTTPConnection(host, port=None, timeout=...)).
TIMEOUT_ARG_INDEX = {
    "urlopen": 2,
    "HTTPConnection": 2,
    "HTTPSConnection": 2,
}


@register
class HttpTimeoutRule(Rule):
    id = "BTF001"
    name = "outbound-http-timeout"
    invariant = ("every urlopen/HTTPConnection/HTTPSConnection call "
                 "passes an explicit timeout")
    scope = ("butterfly_tpu_torch",)

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node.func)
            if name not in TIMEOUT_ARG_INDEX:
                continue
            if any(kw.arg == "timeout" for kw in node.keywords):
                continue
            if any(kw.arg is None for kw in node.keywords):
                continue  # **kwargs splat: cannot see inside, accept
            if len(node.args) > TIMEOUT_ARG_INDEX[name]:
                continue  # timeout passed positionally
            yield self.finding(
                ctx, node,
                f"outbound HTTP call {name}(...) without an explicit "
                f"timeout= waits on the OS default (minutes to forever); "
                f"one wedged peer then pins this thread invisibly")
