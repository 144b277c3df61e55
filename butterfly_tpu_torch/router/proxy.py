"""Streaming-safe HTTP proxy tier over the replica pool.

Forwards ``POST /generate`` and ``POST /v1/completions`` verbatim to a
replica chosen by the routing policy, with exactly one failover rule:

    A request may be retried on the next-best replica IFF no response
    byte has been sent to the client.

Concretely (the failure matrix, see docs/serving.md):

* connection refused / reset at connect, or a malformed status line
  (replica SIGKILLed between accept and response)  -> retry next-best,
  and tell the pool so subsequent requests skip the corpse immediately.
* wedged-503 (the replica's heartbeat latch answers every request 503)
  -> retry next-best; the pool degrades the member until /health
  recovers.
* dead-pool member -> never attempted at all (the policy's candidate
  list excludes it); its arc of the hash ring fails over deterministically.
* backend died MID-STREAM (SSE bytes already forwarded) -> NO retry: a
  re-run would duplicate tokens the client already consumed. The
  truncation is propagated by closing the chunked response WITHOUT the
  terminating 0-chunk, so the client's HTTP layer reports an incomplete
  body instead of silently ending the stream.
* non-stream responses are fully buffered from the replica BEFORE the
  first client byte, so even a mid-body replica death stays retryable.
* 429 queue-full and 4xx are forwarded verbatim (Retry-After included):
  saturation is the client's backpressure signal, not a router fault.

SSE streaming passes through with incremental flush (`read1` +
re-chunk), so router-fronted streams deliver tokens with the same
cadence as direct ones; after de-chunking the bytes are identical.

Admin surface: ``GET /router/replicas`` (pool snapshot),
``POST /router/drain`` / ``/router/undrain`` with ``{"replica":
"host:port"}``, and the router's own ``GET /metrics`` — a second
obs/registry.py instance, so a fleet dashboard reads
``butterfly_router_*`` families without touching any replica.

stdlib-only (ThreadingHTTPServer + http.client), like serve/server.py.
A copy of butterfly_tpu/router/proxy.py.
"""
from __future__ import annotations

import http.client
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from butterfly_tpu_torch.obs.registry import MetricsRegistry
from butterfly_tpu_torch.router.policy import PrefixAffinityPolicy
from butterfly_tpu_torch.router.pool import Replica, ReplicaPool

_RETRY = "retry"   # attempt failed before any client byte: try next
_SENT = "sent"     # a response (possibly truncated) reached the client

PROXIED_PATHS = ("/generate", "/v1/completions")


def extract_route_tokens(raw: bytes) -> Optional[List[int]]:
    """Best-effort token view of a request body for affinity hashing.

    Token-id requests (`tokens` / OpenAI list-form `prompt`) hash the
    ids themselves — bit-identical to what the replica's
    PrefixCachingAllocator will hash, so affinity lines up exactly with
    page reuse. String prompts hash their UTF-8 bytes: not the
    replica's exact token blocks (tokenizers may add BOS etc.), but
    self-consistent — same string -> same key -> same replica, which is
    all page reuse needs, since that replica hashes its own tokens
    consistently. Unparseable bodies return None — the replica will 400
    them; routing by load is fine."""
    try:
        obj = json.loads(raw or b"{}")
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(obj, dict):
        return None
    toks = obj.get("tokens")
    if toks is None:
        p = obj.get("prompt")
        if isinstance(p, str):
            return list(p.encode("utf-8"))
        toks = p
    if not isinstance(toks, list):
        return None
    try:
        return [int(t) for t in toks]
    except (ValueError, TypeError):
        return None


class RouterState:
    """Shared state for router handler threads: pool + policy + the
    router's own metrics registry (instruments are multi-writer here —
    handler threads — so updates go through one small lock, unlike the
    scheduler registry's single-writer contract)."""

    def __init__(self, pool: ReplicaPool, policy: PrefixAffinityPolicy,
                 registry: Optional[MetricsRegistry] = None,
                 read_timeout: float = 300.0):
        self.pool = pool
        self.policy = policy
        self.read_timeout = read_timeout
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.t_start = time.monotonic()
        self._mlock = threading.Lock()
        reg = self.registry
        self._c_req = reg.counter_family(
            "router_requests_total",
            "Proxy attempts by replica and outcome (ok/deadline/"
            "upstream_error/refused/wedged/truncated/client_gone)",
            ("replica", "outcome"))
        self._c_retry = reg.counter(
            "router_retries_total",
            "Requests re-dispatched to another replica before any "
            "response byte was sent")
        self._c_aff = reg.counter(
            "router_affinity_hits_total",
            "Requests dispatched to their prefix-affinity ring target")
        self._c_unroutable = reg.counter(
            "router_unroutable_total",
            "Requests refused outright: no routable replica")
        self._g_uptime = reg.gauge("router_uptime_seconds",
                                   "Router uptime")

    def count(self, replica: str, outcome: str) -> None:
        with self._mlock:
            self._c_req.labels(replica, outcome).inc()

    def inc(self, counter) -> None:
        with self._mlock:
            counter.inc()

    def metrics_text(self) -> str:
        self._g_uptime.set(time.monotonic() - self.t_start)
        return self.registry.render()


def make_router_handler(state: RouterState):
    class RouterHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, obj, headers=None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        # -- read-only surface ----------------------------------------------

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/router/replicas":
                self._json(200, {"replicas": state.pool.snapshot()})
            elif path == "/metrics":
                body = state.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/health":
                snaps = state.pool.snapshot()
                live = sum(1 for s in snaps if s["state"] == "live")
                code = 200 if live else 503
                self._json(code, {"status": "ok" if live else "error",
                                  "replicas_live": live,
                                  "replicas_total": len(snaps)})
            else:
                self._json(404, {"error": "not found"})

        # -- admin + proxy dispatch ------------------------------------------

        def do_POST(self):
            if self.path in PROXIED_PATHS:
                self._proxy(self.path)
            elif self.path in ("/router/drain", "/router/undrain"):
                self._admin(draining=self.path.endswith("/drain"))
            else:
                self._json(404, {"error": "not found"})

        def _admin(self, draining: bool) -> None:
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                rid = body.get("replica")
            except (ValueError, TypeError):
                rid = None
            if not rid:
                self._json(400, {"error": 'body must be {"replica": '
                                          '"host:port"}'})
                return
            snap = state.pool.set_drain(str(rid), draining)
            if snap is None:
                self._json(404, {"error": f"unknown replica {rid}"})
            else:
                self._json(200, snap)

        # -- the proxy path ---------------------------------------------------

        def _proxy(self, path: str) -> None:
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
            except (ValueError, OSError):
                self._json(400, {"error": "unreadable body"})
                return
            self._dispatch(path, body)

        def _dispatch(self, path: str, body: bytes,
                      candidates=None, affinity_rid=None) -> Optional[str]:
            """Plan (unless the caller — e.g. the fleet control plane's
            classifier — already planned) and walk the candidate list
            with the single failover rule. Returns the rid of the
            replica that produced the client's response (the fleet
            control plane's trace records it), or None when nothing
            could serve (an error response was sent instead)."""
            if candidates is None:
                candidates, affinity_rid = state.policy.plan(
                    extract_route_tokens(body))
            if not candidates:
                state.inc(state._c_unroutable)
                self._json(503, {"error": "no live replicas"},
                           headers={"Retry-After": "1"})
                return None
            last = ""
            for i, rep in enumerate(candidates):
                if i > 0:
                    state.inc(state._c_retry)
                elif rep.rid == affinity_rid:
                    state.inc(state._c_aff)
                state.pool.note_dispatch(rep.rid)
                try:
                    result = self._attempt(rep, path, body)
                finally:
                    state.pool.note_done(rep.rid)
                if result == _SENT:
                    return rep.rid
                last = rep.rid
            self._json(502, {"error": "all replicas failed "
                                      f"(last tried: {last})"},
                       headers={"Retry-After": "1"})
            return None

        def _attempt(self, rep: Replica, path: str, body: bytes) -> str:
            """One forwarding attempt. Returns _SENT once ANY response
            byte has reached the client (success, forwarded error, or
            propagated truncation) — _RETRY strictly before that."""
            conn = http.client.HTTPConnection(
                rep.host, rep.port, timeout=state.read_timeout)
            try:
                headers = {"Content-Type": self.headers.get(
                    "Content-Type", "application/json")}
                # X-Deadline-Ms rides through: the replica re-anchors
                # the remaining budget at ITS arrival (forwarding is
                # fast relative to any real deadline)
                for k in ("X-Request-Id", "X-Deadline-Ms", "X-Priority"):
                    v = self.headers.get(k)
                    if v:
                        headers[k] = v
                try:
                    conn.request("POST", path, body=body, headers=headers)
                    resp = conn.getresponse()
                except (OSError, http.client.HTTPException) as e:
                    # refused/reset/garbled before a status line: the
                    # replica is gone — fail it fast so the NEXT request
                    # skips it without waiting for the prober
                    state.pool.note_connect_failure(rep.rid, str(e))
                    state.pool.note_leg_failure(rep.rid, str(e))
                    state.count(rep.rid, "refused")
                    return _RETRY
                if resp.status == 503:
                    # wedged replica: every response is 503 until its
                    # operator intervenes; degraded (not dead — the
                    # process answers) and retryable (no client bytes)
                    try:
                        resp.read()
                    except OSError:
                        pass
                    state.pool.note_wedged(rep.rid, "wedged-503")
                    state.pool.note_leg_failure(rep.rid, "wedged-503")
                    state.count(rep.rid, "wedged")
                    return _RETRY
                if resp.status >= 500 and resp.status != 504:
                    # replica-side fault (500/502/...): no client byte
                    # has been sent, so the single failover rule says
                    # retry next-best rather than forward the fault.
                    # 504 is EXEMPT — it is the request's own deadline
                    # verdict (terminal), not replica health, and a
                    # retry would burn compute for a blown budget.
                    try:
                        resp.read()
                    except OSError:
                        pass
                    state.pool.note_leg_failure(rep.rid,
                                                f"http {resp.status}")
                    state.count(rep.rid, "upstream_error")
                    return _RETRY
                ctype = resp.getheader("Content-Type", "")
                if resp.status == 200 and \
                        ctype.startswith("text/event-stream"):
                    return self._stream_through(rep, resp)
                # non-stream: buffer the WHOLE body before the first
                # client byte, so a mid-body replica death is retryable
                try:
                    data = resp.read()
                except (OSError, http.client.HTTPException) as e:
                    state.pool.note_connect_failure(rep.rid, str(e))
                    state.pool.note_leg_failure(rep.rid, str(e))
                    state.count(rep.rid, "refused")
                    return _RETRY
                state.pool.note_leg_ok(rep.rid)
                fwd = {"X-Routed-To": rep.rid}
                for k in ("X-Request-Id", "Retry-After"):
                    v = resp.getheader(k)
                    if v:
                        fwd[k] = v
                self.send_response(resp.status)
                self.send_header("Content-Type",
                                 ctype or "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in fwd.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)
                # >= 500 was retried above; the only 5xx that lands
                # here is 504 — the request's own deadline verdict
                state.count(rep.rid, "deadline" if resp.status == 504
                            else "ok")
                return _SENT
            finally:
                conn.close()

        def _stream_through(self, rep: Replica, resp) -> str:
            """SSE passthrough with incremental flush: re-chunk whatever
            the replica has ready (`read1` returns per-chunk data
            without waiting to fill the buffer), so tokens reach the
            client at the replica's cadence."""
            self.send_response(200)
            self.send_header("Content-Type",
                             resp.getheader("Content-Type"))
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            rid = resp.getheader("X-Request-Id")
            if rid:
                self.send_header("X-Request-Id", rid)
            self.send_header("X-Routed-To", rep.rid)
            self.end_headers()
            while True:
                try:
                    data = resp.read1(65536)
                except (OSError, http.client.HTTPException) as e:
                    # replica died mid-stream: bytes are already with
                    # the client, so a retry would duplicate tokens.
                    # Propagate the truncation: close WITHOUT the
                    # terminating 0-chunk so the client's HTTP layer
                    # sees an incomplete body.
                    state.pool.note_connect_failure(rep.rid,
                                                    f"mid-stream: {e}")
                    state.pool.note_leg_failure(rep.rid,
                                                f"mid-stream: {e}")
                    state.count(rep.rid, "truncated")
                    self.close_connection = True
                    return _SENT
                if not data:
                    break
                try:
                    self.wfile.write(f"{len(data):X}\r\n".encode()
                                     + data + b"\r\n")
                    self.wfile.flush()
                except OSError:
                    # CLIENT went away — the replica is fine; just stop
                    # forwarding (the replica notices its own dead
                    # socket via the handler's disconnect cancel)
                    state.count(rep.rid, "client_gone")
                    self.close_connection = True
                    return _SENT
            try:
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass
            state.pool.note_leg_ok(rep.rid)
            state.count(rep.rid, "ok")
            return _SENT

    return RouterHandler


def route_forever(backends: List[str], host: str = "0.0.0.0",
                  port: int = 8100, page_size: int = 16,
                  affinity_blocks: int = 4, saturate_after: int = 8,
                  probe_interval: float = 0.5, probe_timeout: float = 2.0,
                  dead_after: int = 3, read_timeout: float = 300.0,
                  ready_event: Optional[threading.Event] = None):
    """Blocking router loop (the `butterfly route` entrypoint).

    `page_size` and `affinity_blocks` should match the replicas'
    --page-size so affinity keys align with their prefix-cache blocks.
    """
    registry = MetricsRegistry()
    pool = ReplicaPool(backends, probe_interval=probe_interval,
                       probe_timeout=probe_timeout, dead_after=dead_after,
                       registry=registry)
    policy = PrefixAffinityPolicy(pool, page_size=page_size,
                                  affinity_blocks=affinity_blocks,
                                  saturate_after=saturate_after)
    state = RouterState(pool, policy, registry=registry,
                        read_timeout=read_timeout)
    pool.probe_all()   # one synchronous round: accurate states at bind
    pool.start()

    class _Server(ThreadingHTTPServer):
        request_queue_size = 128  # match serve/server.py's burst sizing

    httpd = _Server((host, port), make_router_handler(state))
    state.httpd = httpd
    if ready_event is not None:
        ready_event.set()
    n_live = len(pool.routable())
    print(f"[butterfly] routing on {host}:{port} across "
          f"{len(pool.replicas)} replicas ({n_live} live)", flush=True)
    try:
        httpd.serve_forever()
    finally:
        pool.stop()
        httpd.server_close()
    return 0
