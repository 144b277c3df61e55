"""HTTP serving over the continuous-batching scheduler: the port of
butterfly_tpu/serve/server.py, serving the PyTorch engine.

stdlib-only (ThreadingHTTPServer — no web framework dependencies, per the
zero-egress environment):

* POST /generate  {"prompt": str | "tokens": [int], "max_tokens"
                   (alias "max_new_tokens"), "temperature", "stop_token",
                   "stream": bool, "speculative": bool (default true —
                   set false to opt one request out of draft acceptance
                   on a --speculate server; composes with temperature)}
  -> {"text", "tokens", "ttft_s", "total_s"}; with "stream": true the
  response is SSE (`data: {"token": id, "text": piece}` per token,
  terminated by `data: [DONE]`).
* POST /v1/completions  OpenAI-completions-compatible (single choice):
  {"prompt": str | [int], "max_tokens", "temperature", "stop" (string or
  up to 4 strings, matched on decoded text with streaming holdback),
  "stream"} -> {"id", "object": "text_completion", "choices": [{"text",
  "finish_reason"}], "usage"}; streaming sends OpenAI-style SSE chunks.
* GET /metrics    Prometheus text (obs/metrics.py + the typed registry's
  histogram series — obs/registry.py)
* GET /health     {"status": "ok", "role", "queue_depth", "active",
  "free_pages", "inflight_depth"} — one cheap JSON probe carrying every
  load/placement signal the router AND the fleet control plane read
  (queue depth + page headroom + pipeline depth + replica role; no
  Prometheus text scrape, no second poll path); 503 with a detail
  string when wedged.
* GET /kv/pages?hashes=h1,h2,...   export registered prefix-cache KV
  pages by chain hash (fleet/kvtransfer.py payload: base64 page bytes +
  geometry; the leading registered run ships, the rest come back
  "missing"). Needs --prefix-caching: 501 with the reason without it.
* POST /kv/import   land an exported payload into the local pool +
  prefix registry as warm pages (409 on a geometry mismatch).
* POST /debug/profile   a torch.profiler capture of the live loop: 501
  until that slice (ROADMAP.md).
* GET /debug/requests[?n=K]   recent per-request trace timelines as JSON
  (obs/trace.py; requires the scheduler to be built with a Tracer —
  returns {"enabled": false} otherwise). Clients may tag requests with
  an `X-Request-Id` header or a `request_id` body field; the id rides
  the trace verbatim so client logs join server timelines, and is
  echoed back as an `X-Request-Id` response header on every response
  (JSON and SSE) so clients/routers correlate without parsing bodies.

One scheduler thread owns all device work (ticks); HTTP handler threads
only enqueue requests and wait on per-request queues — device work never
runs on more than one host thread.
"""
from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

from butterfly_tpu_torch.obs.metrics import ThroughputWindow, render_prometheus


class LockTimeout(RuntimeError):
    """A handler-thread path timed out acquiring the serving lock (a
    slow or hung tick holds it). Every HTTP path that can raise this
    answers 503 + Retry-After instead of pinning the handler thread —
    and the timeout is counted (server_lock_timeouts_total)."""


class ProfilerUnavailable(RuntimeError):
    """The profiler capture could not start. The port has no capture yet
    (torch.profiler waits for its slice), so POST /debug/profile always
    answers 501 with the reason — never a crash."""


class ProfilerBusy(RuntimeError):
    """A capture is already in flight: one at a time (the profiler is
    process-global). POST /debug/profile answers 409."""


class StopSequenceMatcher:
    """Incremental stop-sequence detection over streamed text.

    OpenAI's `stop` parameter is a string (or up to 4 strings) that ends
    generation, with the matched text EXCLUDED from the output. Matching
    is on decoded text, not token ids, so a stop sequence split across
    token boundaries still hits. `feed` returns the text that is safe to
    release now: everything except the longest trailing run that could
    still grow into a stop sequence (the holdback keeps streaming from
    ever emitting a byte of the stop text).
    """

    def __init__(self, stops):
        self.stops = [s for s in stops if s]
        self._maxlen = max((len(s) for s in self.stops), default=0)
        self.text = ""       # everything fed so far
        self.released = 0    # chars already returned to the caller
        self.hit = False

    def feed(self, piece: str) -> str:
        if self.hit:
            return ""
        prev_len = len(self.text)
        self.text += piece
        # A match cannot start in already-released text (it would have
        # hit or been held back when that text arrived), so only scan
        # from maxlen-1 chars before the new piece — O(piece), not
        # O(total generation), per token.
        scan_from = max(self.released, prev_len - self._maxlen + 1, 0)
        cut = min((i for i in (self.text.find(s, scan_from)
                               for s in self.stops) if i >= 0), default=-1)
        if cut >= 0:
            self.hit = True
            out = self.text[self.released:cut]
            self.released = cut
            return out
        hold = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(self.text)), 0, -1):
                if self.text.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        safe_to = len(self.text) - hold
        out = self.text[self.released:safe_to] \
            if safe_to > self.released else ""
        self.released = max(self.released, safe_to)
        return out

    def flush(self) -> str:
        """Release the holdback (generation ended without a hit)."""
        if self.hit:
            return ""
        out = self.text[self.released:]
        self.released = len(self.text)
        return out


class ServerState:
    def __init__(self, scheduler, tokenizer, max_queue: int = 256,
                 heartbeat=None, model_name: str = "butterfly",
                 role: str = "both"):
        self.sched = scheduler
        self.tok = tokenizer
        self.model_name = model_name  # echoed by /v1/completions
        # fleet placement advertisement (prefill | decode | both):
        # carried on /health so the control plane learns the tier from
        # the same probe the router pool already runs. Advisory only —
        # a prefill replica still decodes if asked (the control plane
        # just stops sending decodes there).
        if role not in ("prefill", "decode", "both"):
            raise ValueError(f"unknown replica role {role!r}")
        self.role = role
        self.lock = threading.Lock()       # guards scheduler state
        self.wake = threading.Event()      # new work signal
        self.stop = threading.Event()
        self.max_queue = max_queue
        self.throughput = ThroughputWindow()
        self.t_start = time.monotonic()
        self.error: str = ""               # set => serving is wedged: 503s
        # lock-acquire timeouts are multi-writer (any handler thread),
        # unlike the scheduler registry's single-writer instruments —
        # guard the counter with its own tiny lock
        self._c_lock_timeout = scheduler.registry.counter(
            "server_lock_timeouts_total",
            "HTTP paths that timed out acquiring the serving lock (a "
            "slow or hung tick held it) and answered 503 + Retry-After "
            "instead of pinning a handler thread")
        self._mlock = threading.Lock()
        # Admission tolerates a much longer lock wait than the
        # read-only surfaces: the scheduler thread legitimately holds
        # the lock for SECONDS when a tick builds a kernel at first
        # use, and 503ing arrivals through a build
        # would turn every unwarmed bucket's first burst into spurious
        # errors. A truly HUNG tick is caught by the heartbeat latch
        # (which wedges the server and fails submit fast), so this
        # bound is a backstop, not the primary hang defense.
        self.submit_lock_timeout = 30.0
        # -- live on-demand profiling -----------------------------
        # POST /debug/profile hands the LOOP THREAD a (duration, logdir)
        # request; the loop starts/stops the profiler trace BETWEEN
        # its lock-holding tick sections, so the capture brackets live
        # ticks without the handler (or the capture) ever holding the
        # serving lock — admission proceeds normally for the whole
        # capture window. _profile_guard (its own tiny mutex, never
        # self.lock) only serializes concurrent capture requests.
        self._profile_guard = threading.Lock()
        self._profile_pending: Optional[tuple] = None
        self._profile_active: Optional[tuple] = None
        self._profile_result: Optional[dict] = None
        self._profile_done = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        # Optional HeartbeatMonitor (obs/health.py): the scheduler
        # thread beats after every tick and runs the probe in-thread
        # when idle (device work stays on ONE host thread); the monitor's
        # watchdog thread only watches wall-clock staleness, so a HUNG
        # tick latches too. On latch: wedge serving (503s) and drain
        # host-side only (abort_all never touches the dead device).
        self.heartbeat = heartbeat
        if heartbeat is not None:
            prev = heartbeat.on_failure
            if prev is None:
                heartbeat.on_failure = self._on_heartbeat_failure
            else:  # chain a caller-provided hook, don't discard it
                def chained(exc, _prev=prev):
                    self._on_heartbeat_failure(exc)
                    _prev(exc)
                heartbeat.on_failure = chained
            if not heartbeat._thread.is_alive():
                heartbeat.start()
            if not heartbeat.healthy:  # latched before we were handed it
                self._on_heartbeat_failure(None)

    def _on_heartbeat_failure(self, exc) -> None:
        # Runs on the watchdog thread: host-only bookkeeping, no device work.
        # In the hung-tick scenario the scheduler thread HOLDS self.lock
        # (stuck inside a device call) — waiting would deadlock the
        # recovery. Try briefly; on timeout set the error ONLY: the
        # watchdog cannot distinguish hung from slow, and draining
        # concurrently with a slow-but-alive tick would corrupt
        # scheduler state. The scheduler loop drains itself at its next
        # iteration (error check in _loop); a truly hung tick never
        # reaches it, but then its host state is frozen and 503s flow.
        self.error = f"heartbeat failed: {self.heartbeat.last_error}"
        # wedge latch -> flight-recorder post-mortem: freeze the event
        # ring NOW (the tick loop may be the thing that died, so the
        # per-tick trigger poll can't be relied on to fire)
        fr = getattr(self.sched, "flightrec", None)
        if fr is not None:
            fr.note("wedge", error=self.error)
            fr.trigger("wedge", {"error": self.error})
        if self.acquire_lock():
            try:
                self.sched.abort_all()
            finally:
                self.lock.release()

    def acquire_lock(self, timeout: float = 2.0) -> bool:
        """Bounded serving-lock acquire for handler/watchdog threads:
        a hung tick may hold the lock forever, and no HTTP path may pin
        its thread on it. False = timed out (counted); the HTTP paths
        then answer 503 + Retry-After via LockTimeout."""
        if self.lock.acquire(timeout=timeout):
            return True
        with self._mlock:
            self._c_lock_timeout.inc()
        return False

    def _locked(self, timeout: float = 2.0):
        """Context manager: bounded acquire or LockTimeout."""
        import contextlib

        @contextlib.contextmanager
        def cm():
            if not self.acquire_lock(timeout=timeout):
                raise LockTimeout(
                    "serving lock busy (slow or hung tick); retry")
            try:
                yield
            finally:
                self.lock.release()
        return cm()

    # -- scheduler thread ----------------------------------------------------

    def _loop(self) -> None:
        while not self.stop.is_set():
            self._maybe_profile()
            if self.error:
                # wedged (in-tick exception, or the watchdog latched
                # while we were mid-tick): drain remaining work under
                # the lock — the single host-only drain path — and
                # idle. Beat the heartbeat: this loop is alive and
                # wedged-by-design; re-latching on staleness would
                # clobber the real root cause in self.error.
                with self.lock:
                    if self.sched.has_work:
                        self.sched.abort_all()
                if self.heartbeat is not None:
                    self.heartbeat.beat()
                self.wake.wait(timeout=0.2)
                self.wake.clear()
                continue
            try:
                with self.lock:
                    has_work = self.sched.has_work
                    made = self.sched.tick() if has_work else 0
            except Exception as e:  # device/OOM errors must not wedge:
                # set the error; the wedged branch above drains on the
                # next iteration (one drain path, not two)
                self.error = f"{type(e).__name__}: {e}"
                continue
            if has_work:
                if made:
                    self.throughput.record(made)
                if self.heartbeat is not None:
                    self.heartbeat.beat()  # a completed tick IS liveness
            else:
                if self.heartbeat is not None:
                    self.heartbeat.maybe_probe()  # idle: probe in-thread
                self.wake.wait(timeout=0.05)
                self.wake.clear()

    # -- live on-demand profiling (loop thread + handler threads) -------------

    @staticmethod
    def _profiler_start(logdir: str) -> None:
        """Start the process-global profiler trace: not ported yet."""
        raise ProfilerUnavailable(
            "profiling needs torch.profiler, not ported yet (ROADMAP.md, "
            "PyTorch/CUDA port queue: torch.profiler)")

    @staticmethod
    def _profiler_stop() -> None:
        pass

    def _maybe_profile(self) -> None:
        """Runs on the scheduler loop thread, OUTSIDE the serving lock:
        start a pending capture, stop an expired one. The capture
        therefore brackets whole ticks of the live loop and never
        blocks admission — the serving lock is untouched on this path
        (the BTF004 contract; pinned by test)."""
        req = self._profile_pending
        if req is not None and self._profile_active is None:
            self._profile_pending = None
            dur_s, logdir = req
            t0 = time.monotonic()
            try:
                self._profiler_start(logdir)
            except Exception as e:  # no profiler plugin / busy / bad dir
                self._profile_result = {
                    "error": f"{type(e).__name__}: {e}"}
                self._profile_done.set()
                return
            self._profile_active = (t0 + dur_s, logdir, t0)
        act = self._profile_active
        if act is not None and time.monotonic() >= act[0]:
            self._profile_active = None
            deadline, logdir, t0 = act
            result = {"logdir": logdir,
                      "duration_s": time.monotonic() - t0}
            try:
                self._profiler_stop()
            except Exception as e:
                result["error"] = f"{type(e).__name__}: {e}"
            self._profile_result = result
            self._profile_done.set()

    def request_profile(self, duration_ms: float,
                        logdir: Optional[str] = None) -> dict:
        """POST /debug/profile body -> result. Blocks the HANDLER
        thread (bounded: duration + slack) while the loop thread
        captures; never touches the serving lock, so admission and
        every other endpoint proceed normally through the capture."""
        import glob
        import tempfile
        duration_ms = min(max(float(duration_ms), 10.0), 60000.0)
        if not self._profile_guard.acquire(blocking=False):
            raise ProfilerBusy("a profile capture is already running")
        try:
            if logdir is None:
                logdir = tempfile.mkdtemp(prefix="butterfly_profile_")
            self._profile_result = None
            self._profile_done.clear()
            self._profile_pending = (duration_ms / 1e3, str(logdir))
            self.wake.set()  # an idle loop wakes to start the capture
            if not self._profile_done.wait(timeout=duration_ms / 1e3 + 30.0):
                # a truly hung tick never reaches _maybe_profile: drop
                # the request so a later loop iteration doesn't start a
                # stale capture, and tell the client
                self._profile_pending = None
                raise ProfilerUnavailable(
                    "capture did not complete (tick loop stalled?)")
            res = dict(self._profile_result or {})
        finally:
            self._profile_guard.release()
        if "error" in res:
            raise ProfilerUnavailable(res["error"])
        res["duration_ms"] = duration_ms
        res["files"] = sorted(
            str(Path(p).relative_to(res["logdir"])) for p in glob.glob(
                res["logdir"] + "/**/*", recursive=True)
            if Path(p).is_file())
        return res

    def debug_ticks(self, n: Optional[int] = None,
                    since: Optional[int] = None) -> dict:
        """GET /debug/ticks body: the bounded per-tick timeline ring
        (obs/ticklog.py). Reads only the ring's own lock — a wedged
        scheduler can still be inspected. `since` pages by tick seq
        (tick_report --follow's incremental poll)."""
        log = getattr(self.sched, "ticklog", None)
        if log is None:
            return {"enabled": False, "ticks": []}
        return {"enabled": True, **log.dump(n, since=since)}

    def debug_flightrecorder(self, n: Optional[int] = None) -> dict:
        """GET /debug/flightrecorder body: the anomaly event ring +
        retained trigger artifacts ({"enabled": false} when the
        scheduler was built without a recorder)."""
        fr = getattr(self.sched, "flightrec", None)
        if fr is None:
            return {"enabled": False, "events": [], "dumps": []}
        return fr.dump(n)

    def debug_timeseries(self, since: Optional[int] = None,
                         signals=None) -> dict:
        """GET /debug/timeseries body: the periodic signal-history ring
        (obs/timeseries.py SignalRecorder). Reads only the ring's own
        lock — the /debug/ticks wedge-readability contract.
        ({"enabled": false} when serving with --timeseries-interval 0.)
        """
        rec = getattr(self.sched, "timeseries", None)
        if rec is None:
            return {"enabled": False, "samples": [], "alerts": []}
        return rec.dump(since=since, signals=signals)

    # -- handler-thread API ---------------------------------------------------

    def submit(self, tokens, max_tokens, temperature, stop_token,
               request_id=None, priority="interactive", deadline_s=None,
               speculative=True):
        """Admit one request. Returns (req, queue); (None, retry_after
        float) when SLO-aware admission SHED it (predicted TTFT busts
        the declared objective — the handler answers 429 with the
        computed Retry-After); (None, None) when the waiting queue is
        full. Raises LockTimeout when the serving lock is held by a
        slow/hung tick."""
        q: queue.Queue = queue.Queue()

        def on_token(req, token):
            q.put(token)

        def on_finish(req):
            q.put(None)  # completion sentinel (after the last on_token)

        with self._locked(timeout=self.submit_lock_timeout):
            # re-check under the lock: the heartbeat may have wedged the
            # server between the handler's check and this admission
            if self.error:
                raise RuntimeError("server wedged: " + self.error)
            retry_after = self.sched.shed_decision(len(tokens), priority)
            if retry_after is not None:
                return None, retry_after
            if len(self.sched.waiting) >= self.max_queue:
                return None, None
            req = self.sched.submit(tokens, max_new_tokens=max_tokens,
                                    temperature=temperature,
                                    stop_token=stop_token,
                                    on_token=on_token, on_finish=on_finish,
                                    request_id=request_id,
                                    priority=priority,
                                    deadline_s=deadline_s,
                                    speculative=speculative)
        self.wake.set()
        return req, q

    def metrics_text(self) -> str:
        with self._locked():
            vals = self.sched.metrics()
        vals["tokens_per_sec"] = self.throughput.rate()
        vals["uptime_seconds"] = time.monotonic() - self.t_start
        return render_prometheus(vals,
                                 registry=getattr(self.sched, "registry",
                                                  None))

    def export_kv(self, hex_hashes) -> dict:
        """GET /kv/pages body: export registered pages by chain hash.
        Under the serving lock — the scheduler thread must not dispatch
        onto the pools while the export gather reads page bytes out."""
        from butterfly_tpu_torch.fleet.kvtransfer import export_payload
        with self._locked():
            if self.error:
                raise RuntimeError("server wedged: " + self.error)
            # full reconcile (cause="flush") before page bytes leave
            # the process: drains every in-flight block and flushes the
            # write-combined KV window, so the exported pool bytes are
            # never missing staged-but-unflushed K/V
            self.sched._drain_inflight("flush")
            return export_payload(self.sched, hex_hashes)

    def import_kv(self, payload: dict) -> dict:
        """POST /kv/import body -> result. Under the serving lock: the
        import claims pages from the same free/evictable lists
        admissions allocate from."""
        from butterfly_tpu_torch.fleet.kvtransfer import import_payload
        with self._locked():
            if self.error:
                raise RuntimeError("server wedged: " + self.error)
            return import_payload(self.sched, payload)

    def count_deadline(self, where: str) -> None:
        """Handler-thread deadline accounting (requests 504ed before
        they ever reached the scheduler): the scheduler's counter
        family is single-writer, so go through the metrics lock."""
        with self._mlock:
            self.sched._c_deadline.labels(where).inc()

    def debug_requests(self, n: Optional[int] = None,
                       request_id: Optional[str] = None) -> dict:
        """Recent per-request trace timelines (the /debug/requests
        body). Reads only the tracer's own lock — a wedged scheduler
        (hung tick holding self.lock) can still be inspected.
        `request_id` filters to one client id's timelines and drops the
        global ring (the fleet trace merge wants exactly one request's
        events, not every tick in the window)."""
        tracer = getattr(self.sched, "trace", None)
        if tracer is None:
            return {"enabled": False, "requests": []}
        dump = tracer.dump(n_requests=n, request_id=request_id,
                           n_global=0 if request_id is not None else None)
        dump["enabled"] = True
        return dump


def make_handler(state: ServerState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        # client correlation id for the in-flight request: set from the
        # X-Request-Id header at dispatch, refined by _parse_request when
        # the id arrives as a body field instead. Echoed back as a
        # response header on every response (JSON and SSE) so clients —
        # and the multi-replica router — can correlate without parsing
        # bodies.
        _rid: Optional[str] = None

        def _json(self, code: int, obj, headers=None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if self._rid:
                self.send_header("X-Request-Id", self._rid)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._rid = self._header_rid()
            if self.path == "/health":
                if state.error:  # incl. heartbeat latch (on_failure sets it)
                    self._json(503, {"status": "error",
                                     "detail": state.error})
                else:
                    # every field is deliberately read WITHOUT
                    # state.lock: len() on the scheduler's deque/list
                    # and the allocator's free-list length are atomic
                    # enough for a load probe (one update stale at
                    # worst), and /health must stay responsive even when
                    # a slow tick holds the lock — the router's prober
                    # times out a hanging probe into "degraded". One
                    # probe carries the full control-plane signal set
                    # (role, page headroom, pipeline depth): the fleet
                    # tier needs no second poll path.
                    body = {"status": "ok",
                            "role": state.role,
                            "queue_depth": len(state.sched.waiting),
                            "active": len(state.sched._all_live),
                            "free_pages": state.sched.alloc.free_pages,
                            "inflight_depth":
                                len(state.sched._inflight),
                            # wall-clock stamp for the prober's clock-
                            # offset estimate (router/pool.py): the
                            # fleet trace merge places this replica's
                            # monotonic events on the control plane's
                            # clock via offset = now_wall - probe RTT
                            # midpoint
                            "now_wall": time.time()}
                    if state.heartbeat is not None:
                        body["heartbeats"] = state.heartbeat.beats
                    self._json(200, body)
            elif self.path.split("?")[0] == "/kv/pages":
                self._handle_kv_export()
            elif self.path == "/metrics":
                try:
                    body = state.metrics_text().encode()
                except LockTimeout as e:
                    self._json(503, {"error": str(e)},
                               headers={"Retry-After": "1"})
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.split("?")[0] == "/debug/requests":
                q = self._query_debug()
                self._json(200, state.debug_requests(
                    q["n"], q["request_id"]))
            elif self.path.split("?")[0] == "/debug/ticks":
                q = self._query_debug()
                self._json(200, state.debug_ticks(q["n"], q["since"]))
            elif self.path.split("?")[0] == "/debug/flightrecorder":
                q = self._query_debug()
                self._json(200, state.debug_flightrecorder(q["n"]))
            elif self.path.split("?")[0] == "/debug/timeseries":
                q = self._query_debug()
                self._json(200, state.debug_timeseries(
                    q["since"], q["signals"]))
            else:
                self._json(404, {"error": "not found"})

        def _header_rid(self) -> Optional[str]:
            rid = self.headers.get("X-Request-Id")
            return str(rid)[:128] if rid is not None else None

        def _query_debug(self):
            """Shared /debug/* query parsing: ?n=K limit, ?request_id=
            client-id filter, ?since=SEQ incremental pagination
            (ticks/timeseries), ?signals=a,b signal-name filter
            (timeseries). Absent/bad fields parse as None — a bad query
            degrades to the full dump, never a 500."""
            from urllib.parse import parse_qs, urlparse
            out = {"n": None, "request_id": None, "since": None,
                   "signals": None}
            try:
                qs = parse_qs(urlparse(self.path).query)
                if "n" in qs:
                    out["n"] = int(qs["n"][0])
                if "request_id" in qs:
                    out["request_id"] = str(qs["request_id"][0])[:128]
                if "since" in qs:
                    out["since"] = int(qs["since"][0])
                if "signals" in qs:
                    out["signals"] = [s for s in
                                      ",".join(qs["signals"]).split(",")
                                      if s]
            except (ValueError, TypeError, IndexError):
                pass
            return out

        def do_POST(self):
            self._rid = self._header_rid()
            if self.path == "/generate":
                self._handle_generate()
            elif self.path == "/v1/completions":
                self._handle_completions()
            elif self.path == "/kv/import":
                self._handle_kv_import()
            elif self.path == "/debug/profile":
                self._handle_profile()
            else:
                self._json(404, {"error": "not found"})

        def _handle_kv_export(self):
            from urllib.parse import parse_qs, urlparse
            try:
                qs = parse_qs(urlparse(self.path).query)
                hashes = [h for h in
                          ",".join(qs.get("hashes", [])).split(",") if h]
                for h in hashes:  # validate before touching the lock
                    bytes.fromhex(h)
            except (ValueError, TypeError):
                self._json(400, {"error": "hashes must be comma-separated "
                                          "hex chain digests"})
                return
            if not hashes:
                self._json(400, self._kv_err("missing ?hashes= query"))
                return
            try:
                self._json(200, state.export_kv(hashes))
            except LookupError as e:  # no prefix registry on this replica
                self._json(501, self._kv_err(str(e)))
            except LockTimeout as e:  # tick holds the lock: back off
                self._json(503, self._kv_err(str(e)),
                           headers={"Retry-After": "1"})
            except RuntimeError as e:  # wedged
                self._json(503, self._kv_err(str(e)))

        def _kv_err(self, msg: str) -> dict:
            """KV-transfer error body: carries the request id (when the
            control plane forwarded one) so a failed handoff leg is
            attributable to its distributed request from logs alone —
            the header echo alone doesn't survive into log lines."""
            body = {"error": msg}
            if self._rid:
                body["request_id"] = self._rid
            return body

        def _handle_profile(self):
            """POST /debug/profile {duration_ms, logdir}: a
            duration-bounded profiler capture of the LIVE tick
            loop (501 until torch.profiler is ported). The capture runs on the scheduler loop thread and
            never holds the serving lock — only this handler thread
            blocks (bounded) waiting for the artifact. 501 = no profiler
            in this build (graceful fallback, with reason); 409 = a
            capture is already in flight."""
            try:
                body = self._read_body()
                duration_ms = float(body.get("duration_ms", 1000.0))
                logdir = body.get("logdir")
                if logdir is not None:
                    logdir = str(logdir)
            except (ValueError, TypeError) as e:
                self._json(400, {"error": str(e)})
                return
            try:
                self._json(200, state.request_profile(duration_ms, logdir))
            except ProfilerBusy as e:
                self._json(409, {"error": str(e)})
            except ProfilerUnavailable as e:
                self._json(501, {"error": str(e),
                                 "reason": "no profiler in the port yet"})

        def _handle_kv_import(self):
            try:
                payload = self._read_body()
            except (ValueError, TypeError) as e:
                self._json(400, {"error": str(e)})
                return
            try:
                self._json(200, state.import_kv(payload))
            except LookupError as e:
                self._json(501, self._kv_err(str(e)))
            except (ValueError, KeyError, TypeError) as e:
                # geometry mismatch / malformed page entries: refusing
                # is the safety property — a mismatched import would
                # alias garbage K/V under a valid-looking chain hash
                self._json(409, self._kv_err(f"{e}"))
            except LockTimeout as e:  # tick holds the lock: back off
                self._json(503, self._kv_err(str(e)),
                           headers={"Retry-After": "1"})
            except RuntimeError as e:  # wedged
                self._json(503, self._kv_err(str(e)))

        def _read_body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            return body

        def _parse_request(self, body: dict):
            """Shared validation -> (tokens, max_tokens, temperature,
            stop, rid, priority, deadline_ms, speculative).

            Accepts our native schema and the OpenAI-completions field
            names (`prompt` may be a string OR a token-id list there;
            `max_new_tokens` is accepted as a `max_tokens` alias).
            `deadline_ms` (body) / `X-Deadline-Ms` (header, wins) is
            the REMAINING latency budget at arrival — routers and the
            fleet control plane decrement it per hop; `priority` /
            `X-Priority` selects the admission class. `speculative`
            (default true) composes with the sampling params: false
            opts this request's slot out of draft acceptance on a
            --speculate server (it still rides the batched verify,
            emitting one exact plain-decode sample per round); ignored
            when the server runs without --speculate."""
            if "tokens" in body:
                tokens = [int(t) for t in body["tokens"]]
            else:
                prompt = body.get("prompt", "")
                if isinstance(prompt, list):  # OpenAI token-id form
                    tokens = [int(t) for t in prompt]
                else:
                    tokens = state.tok.encode(str(prompt))
            vocab = state.sched.engine.cfg.vocab_size
            if any(t >= vocab or t < 0 for t in tokens):
                raise ValueError("token id out of range")
            if not tokens:
                raise ValueError("empty prompt")
            max_seq = state.sched.engine.cache.max_seq
            max_tokens = int(body.get("max_tokens",
                                      body.get("max_new_tokens", 64)))
            if max_tokens < 1:
                raise ValueError("max_tokens must be >= 1")
            if len(tokens) + max_tokens > max_seq:
                raise ValueError(
                    f"prompt+max_tokens exceeds max_seq {max_seq}")
            temperature = float(body.get("temperature", 0.0))
            stop = int(body.get("stop_token",
                                -1 if state.tok.eos_id is None
                                else state.tok.eos_id))
            # client trace-correlation id: header wins over body field
            rid = self.headers.get("X-Request-Id") \
                or body.get("request_id")
            rid = str(rid)[:128] if rid is not None else None
            self._rid = rid  # echoed on the response (incl. SSE headers)
            priority = str(self.headers.get("X-Priority")
                           or body.get("priority") or "interactive")
            if priority not in ("interactive", "batch"):
                raise ValueError(f"unknown priority {priority!r}: "
                                 "expected 'interactive' or 'batch'")
            dl = self.headers.get("X-Deadline-Ms")
            if dl is None:
                dl = body.get("deadline_ms")
            deadline_ms = float(dl) if dl is not None else None
            if deadline_ms is not None and not deadline_ms == deadline_ms:
                raise ValueError("deadline_ms must be a number")  # NaN
            speculative = body.get("speculative", True)
            if not isinstance(speculative, bool):
                raise ValueError("speculative must be a boolean")
            return (tokens, max_tokens, temperature, stop, rid,
                    priority, deadline_ms, speculative)

        def _deadline_504(self, where: str, deadline_ms,
                          elapsed_s: float, openai: bool,
                          partial=None) -> None:
            """The deadline-exceeded terminal response: 504 with enough
            detail (where it died, elapsed vs budget) that a client or
            the fleet trace can attribute the miss without guessing."""
            detail = {"where": where,
                      "deadline_ms": deadline_ms,
                      "elapsed_ms": elapsed_s * 1e3}
            if openai:
                body = {"error": {"message": "deadline exceeded "
                                             f"({where})",
                                  "type": "timeout_error", **detail}}
            else:
                body = {"error": "deadline exceeded", **detail}
                if partial is not None:
                    body["partial_tokens"] = partial
            self._json(504, body)

        def _admit(self, body: dict, openai: bool = False):
            """Parse + submit; handles every error response (in the
            OpenAI error-envelope shape when `openai`). Returns
            (req, queue, deadline_ms) or None if a response was already
            sent."""
            def err(code: int, msg: str, etype: str,
                    headers=None) -> None:
                if openai:
                    self._json(code, {"error": {"message": msg,
                                                "type": etype}},
                               headers=headers)
                else:
                    self._json(code, {"error": msg}, headers=headers)

            try:
                (tokens, max_tokens, temperature, stop, rid, priority,
                 deadline_ms, speculative) = self._parse_request(body)
            except (ValueError, TypeError, KeyError) as e:
                err(400, str(e), "invalid_request_error")
                return None
            if state.error:
                err(503, "server wedged: " + state.error, "server_error")
                return None
            now = time.monotonic()
            deadline_s = None
            if deadline_ms is not None:
                if deadline_ms <= 0:
                    # arrived already expired: terminal 504, never a
                    # queue slot (the scheduler would only scrub it)
                    state.count_deadline("admission")
                    self._deadline_504("admission", deadline_ms, 0.0,
                                       openai)
                    return None
                deadline_s = now + deadline_ms / 1e3
            try:
                req, q = state.submit(tokens, max_tokens, temperature, stop,
                                      request_id=rid, priority=priority,
                                      deadline_s=deadline_s,
                                      speculative=speculative)
            except ValueError as e:  # can never fit the page pool
                err(400, str(e), "invalid_request_error")
                return None
            except LockTimeout as e:  # slow/hung tick holds the lock
                err(503, str(e), "server_error",
                    headers={"Retry-After": "1"})
                return None
            except RuntimeError as e:  # wedged while we were admitting
                err(503, str(e), "server_error")
                return None
            if req is None:
                # explicit backoff signal: the router (and well-behaved
                # clients) should stop hammering a saturated replica
                # instead of retry-spinning on 429s. q carries the
                # computed Retry-After when SLO-aware admission SHED
                # the request (predicted TTFT busts the objective).
                if q is not None:
                    err(429, "shed: predicted TTFT exceeds the declared "
                        "objective", "rate_limit_error",
                        headers={"Retry-After": str(int(-(-q // 1)))})
                else:
                    err(429, "queue full", "rate_limit_error",
                        headers={"Retry-After": "1"})
                return None
            return req, q, deadline_ms

        def _cancel_request(self, req) -> None:
            """Best-effort cancel from a handler thread: a hung tick may
            hold the lock forever — leaking the request is better than
            pinning this thread on acquire (the timeout is counted in
            server_lock_timeouts_total either way)."""
            if state.acquire_lock():
                try:
                    state.sched.cancel(req)
                finally:
                    state.lock.release()

        def _collect(self, req, q, matcher=None):
            """Drain q until the finish sentinel. Returns (tokens,
            aborted) — or None if the client vanished (cancelled, no
            response owed). `matcher` (StopSequenceMatcher) ends
            generation early when a stop sequence appears in the text."""
            toks = []
            while True:
                try:
                    tok = q.get(timeout=0.5)
                except queue.Empty:
                    if req.done or state.error:
                        break  # wedged/hung: answer with partials
                    if not self._client_alive():
                        self._cancel_request(req)
                        return None
                    continue
                if tok is None:
                    break
                toks.append(tok)
                if matcher is not None and not matcher.hit \
                        and not (req.stop_token >= 0
                                 and tok == req.stop_token):
                    matcher.feed(state.tok.decode([tok]))
                    if matcher.hit:
                        self._cancel_request(req)
            stop_hit = matcher is not None and matcher.hit
            aborted = (req.state == "cancelled" and not stop_hit) \
                or (state.error and not req.done)
            return toks, aborted

        def _handle_generate(self):
            try:
                body = self._read_body()
            except (ValueError, TypeError) as e:
                self._json(400, {"error": str(e)})
                return
            t0 = time.monotonic()
            admitted = self._admit(body)
            if admitted is None:
                return
            req, q, deadline_ms = admitted
            if body.get("stream"):
                self._stream(req, q, t0)
                return
            got = self._collect(req, q)
            if got is None:
                return
            toks, aborted = got
            if req.state == "expired":
                # the scheduler scrubbed/cancelled it at the deadline:
                # terminal 504 with where-it-died + elapsed detail
                self._deadline_504(req.expired_where or "running",
                                   deadline_ms, time.monotonic() - t0,
                                   openai=False, partial=toks)
                return
            if aborted:
                self._json(503, {"error": "generation aborted: "
                                 + (state.error or "cancelled"),
                                 "partial_tokens": toks})
                return
            self._json(200, {
                "tokens": toks,
                "text": state.tok.decode(toks),
                "ttft_s": req.ttft,
                "total_s": time.monotonic() - t0,
                # stop-token finish vs budget finish: the disaggregated
                # control plane's prefill leg (max_tokens=1) reads this
                # to know whether generation already ended — it cannot
                # infer the replica's default EOS id itself
                "stopped": bool(req.stop_token >= 0 and toks
                                and toks[-1] == req.stop_token),
            })

        def _handle_completions(self):
            """OpenAI-compatible /v1/completions (single choice)."""
            try:
                body = self._read_body()
                n_choices = int(body.get("n", 1))
                stops = body.get("stop") or []
                if isinstance(stops, str):
                    stops = [stops]
                if not (isinstance(stops, list)
                        and all(isinstance(s, str) for s in stops)):
                    raise ValueError("stop must be a string or a list "
                                     "of strings")
                if len(stops) > 4:
                    raise ValueError("at most 4 stop sequences")
            except (ValueError, TypeError) as e:
                self._json(400, {"error": {"message": str(e),
                                           "type": "invalid_request_error"}})
                return
            if n_choices != 1:
                self._json(400, {"error": {"message": "only n=1 supported",
                                           "type": "invalid_request_error"}})
                return
            admitted = self._admit(body, openai=True)
            if admitted is None:
                return
            req, q, deadline_ms = admitted
            matcher = StopSequenceMatcher(stops) if stops else None
            meta = {"id": f"cmpl-{req.id}", "object": "text_completion",
                    "created": int(time.time()), "model": state.model_name}
            t0 = time.monotonic()
            if body.get("stream"):
                self._stream_completions(req, q, meta, matcher)
                return
            got = self._collect(req, q, matcher)
            if got is None:
                return
            toks, aborted = got
            if req.state == "expired":
                self._deadline_504(req.expired_where or "running",
                                   deadline_ms, time.monotonic() - t0,
                                   openai=True)
                return
            if aborted:
                self._json(503, {"error": {
                    "message": "generation aborted: "
                               + (state.error or "cancelled"),
                    "type": "server_error"}})
                return
            token_stop = (req.stop_token >= 0 and toks
                          and toks[-1] == req.stop_token)
            if matcher is not None:
                # text comes from the matcher: everything before the
                # stop sequence (or everything fed, if none hit)
                matcher.flush()
                text = matcher.text[:matcher.released]
                finish = "stop" if (matcher.hit or token_stop) else "length"
            else:
                # OpenAI semantics: the stop marker is excluded from the
                # text (usage still counts it — it was generated)
                finish = "stop" if token_stop else "length"
                text = state.tok.decode(
                    toks[:-1] if token_stop else toks)
            self._json(200, {
                **meta,
                "choices": [{"text": text, "index": 0,
                             "logprobs": None, "finish_reason": finish}],
                "usage": {"prompt_tokens": len(req.prompt),
                          "completion_tokens": len(toks),
                          "total_tokens": len(req.prompt) + len(toks)},
            })

        def _client_alive(self) -> bool:
            """Peek the socket: a closed peer reads as EOF (b'')."""
            import socket
            try:
                data = self.connection.recv(1, socket.MSG_PEEK
                                            | socket.MSG_DONTWAIT)
                return data != b""
            except (BlockingIOError, InterruptedError):
                return True          # no data pending = still connected
            except OSError:
                return False

        def _sse(self, req, q, render_token, finish_payloads,
                 render_error, natural_cancel=lambda: False) -> None:
            """Shared SSE drain: headers, chunked framing, bounded-wait
            queue loop, wedge/cancel detection, disconnect cancel.

            render_token(tok) -> payload str or None (skip the chunk);
            finish_payloads(last_tok) -> payload strs on normal finish;
            render_error(msg) -> payload str for the abort event;
            natural_cancel() -> True when a handler-initiated cancel is
            a normal finish (stop-sequence hit), not an abort.
            """
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            if self._rid:
                self.send_header("X-Request-Id", self._rid)
            self.end_headers()

            def chunk(data: bytes) -> None:
                self.wfile.write(f"{len(data):X}\r\n".encode() + data
                                 + b"\r\n")

            try:
                last_tok = None
                while True:
                    try:
                        # bounded wait: a hung device must not pin this
                        # handler thread forever — bail once the request
                        # is drained OR the server wedged (a truly hung
                        # tick never delivers the sentinel)
                        tok = q.get(timeout=0.5)
                    except queue.Empty:
                        if req.done or state.error:
                            break
                        continue
                    if tok is None:
                        break
                    last_tok = tok
                    payload = render_token(tok)
                    if payload is not None:
                        chunk(f"data: {payload}\n\n".encode())
                if req.state == "expired":
                    # deadline fired mid-stream: terminal error event —
                    # already-streamed tokens stand, the client learns
                    # the stream died on its own latency budget
                    err = render_error("deadline exceeded "
                                       f"({req.expired_where or 'running'})")
                    chunk(f"data: {err}\n\n".encode())
                elif (req.state == "cancelled" and not natural_cancel()) \
                        or (state.error and not req.done):
                    err = render_error("generation aborted: "
                                       + (state.error or "cancelled"))
                    chunk(f"data: {err}\n\n".encode())
                else:
                    for payload in finish_payloads(last_tok):
                        chunk(f"data: {payload}\n\n".encode())
                chunk(b"")  # terminating chunk
            except (BrokenPipeError, ConnectionResetError):
                # client went away: stop generating for a dead socket
                self._cancel_request(req)

        def _stream(self, req, q, t0) -> None:
            self._sse(
                req, q,
                lambda tok: json.dumps({"token": tok,
                                        "text": state.tok.decode([tok])}),
                lambda last: ["[DONE]"],
                lambda msg: json.dumps({"error": msg}))

        def _stream_completions(self, req, q, meta, matcher=None) -> None:
            """SSE in the OpenAI streaming-chunk shape. With a stop-
            sequence matcher, only text provably before any stop
            sequence streams out (holdback), and a hit cancels the
            request as a NORMAL finish."""
            def content(text):
                return json.dumps({**meta, "choices": [
                    {"text": text, "index": 0, "logprobs": None,
                     "finish_reason": None}]})

            def render_token(tok):
                if req.stop_token >= 0 and tok == req.stop_token:
                    return None  # stop marker is excluded from the text
                piece = state.tok.decode([tok])
                if matcher is not None:
                    if matcher.hit:
                        return None  # tokens racing in after the hit
                    piece = matcher.feed(piece)
                    if matcher.hit:
                        self._cancel_request(req)
                    if not piece:
                        return None
                return content(piece)

            def finish_payloads(last_tok):
                msgs = []
                stop_hit = matcher is not None and matcher.hit
                if matcher is not None and not stop_hit:
                    tail = matcher.flush()
                    if tail:
                        msgs.append(content(tail))
                finish = "stop" if (stop_hit or (req.stop_token >= 0
                                                 and last_tok
                                                 == req.stop_token)) \
                    else "length"
                msgs.append(json.dumps({**meta, "choices": [
                    {"text": "", "index": 0, "logprobs": None,
                     "finish_reason": finish}]}))
                msgs.append("[DONE]")
                return msgs

            self._sse(req, q, render_token, finish_payloads,
                      lambda msg: json.dumps({"error": {
                          "message": msg, "type": "server_error"}}),
                      natural_cancel=lambda: (matcher is not None
                                              and matcher.hit))

    return Handler


def serve_forever(scheduler, tokenizer, host: str = "0.0.0.0",
                  port: int = 8000, max_queue: int = 256,
                  ready_event: Optional[threading.Event] = None,
                  heartbeat=None, model_name: str = "butterfly",
                  role: str = "both"):
    """Blocking serve loop. `ready_event` is set once listening (tests).

    `heartbeat`: a HeartbeatMonitor to use (callers may tune interval /
    misses / probe); defaults to the LOCAL device probe. Deliberately so
    even multi-host: an idle-timer collective probe would be issued in
    unsynchronized order across hosts and desync the SPMD program
    stream — on a pod each host watchdogs its own chip, and a dead PEER
    surfaces as the next real tick stalling on its collective, which
    the staleness latch catches.
    """
    from functools import partial

    from butterfly_tpu_torch.obs.health import HeartbeatMonitor, device_probe
    if heartbeat is None:
        heartbeat = HeartbeatMonitor(
            probe=partial(device_probe, scheduler.engine.device))
    state = ServerState(scheduler, tokenizer, max_queue,
                        heartbeat=heartbeat, model_name=model_name,
                        role=role)
    state.thread.start()
    # stdlib default listen backlog is 5: a burst of concurrent clients
    # gets connection resets before the accept loop ever sees them
    # (observed at 50 simultaneous connects in the r5 soak). Size it
    # with the admission queue — excess load should get a 503/429 from
    # US, not a TCP reset from the kernel. Local subclass so the bump
    # stays per-server instead of mutating the shared stdlib class.
    class _Server(ThreadingHTTPServer):
        request_queue_size = max(128, max_queue)

    httpd = _Server((host, port), make_handler(state))
    state.httpd = httpd
    if ready_event is not None:
        ready_event.set()
    try:
        httpd.serve_forever()
    finally:
        state.stop.set()
        if state.heartbeat is not None:
            state.heartbeat.stop()
        httpd.server_close()
    return 0


def build_serving(args):
    """Everything `butterfly serve` does before it listens: model, random
    or loaded weights, engine on args.device, scheduler with tracing /
    flight recorder / timeseries, and the startup warm-up (which first
    launches the kernels). Returns (scheduler, tokenizer, runtime)."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    from butterfly_tpu_torch.serve.cli import (build_mesh, load_params,
                                               resolve_model)
    from butterfly_tpu_torch.utils.tokenizer import load_tokenizer

    if getattr(args, "profiler_port", 0):
        raise NotImplementedError(
            "--profiler-port needs torch.profiler, not ported yet "
            "(ROADMAP.md, PyTorch/CUDA port queue: torch.profiler)")
    model = resolve_model(args)
    tok = load_tokenizer(args.tokenizer or args.ckpt)
    mesh = build_mesh(args)
    rt = RuntimeConfig(max_batch_size=args.max_batch,
                       max_seq_len=args.max_seq, page_size=args.page_size,
                       top_k=args.top_k, top_p=args.top_p,
                       max_queue=args.max_queue,
                       prefix_caching=getattr(args, "prefix_caching", False),
                       host_kv_tier_mb=getattr(args, "host_tier_mb", 0.0),
                       host_kv_tier_dir=getattr(args, "host_tier_dir", None),
                       kv_quant=getattr(args, "kv_quant", "none"),
                       speculative_gamma=getattr(args, "speculate", 0),
                       draft_model=getattr(args, "draft_source", "ngram"),
                       draft_layers=getattr(args, "draft_layers", 0),
                       draft_ckpt=getattr(args, "draft_ckpt", None),
                       spec_tree_width=getattr(args, "spec_tree", 0),
                       spec_tree_nodes=getattr(args, "spec_tree_nodes", 0),
                       decode_steps_per_tick=getattr(
                           args, "decode_steps_per_tick", 1),
                       prefill_max_batch=getattr(
                           args, "prefill_max_batch", 8),
                       inflight_blocks=getattr(
                           args, "inflight_blocks", 2),
                       seq_parallel_threshold=getattr(
                           args, "seq_parallel_threshold", 0),
                       seq_parallel_chunk=getattr(
                           args, "seq_parallel_chunk", 0))
    if getattr(args, "quant", "none") != "none":
        raise NotImplementedError(
            "--quant int8 weights are not ported yet (ROADMAP.md, "
            "PyTorch/CUDA port queue: int8 weights)")
    params = load_params(model, args)
    engine = ServingEngine(model, params, rt, mesh=mesh,
                           device=getattr(args, "device", None))
    # Tracing defaults ON for the serve entrypoint (/debug/requests is
    # the production debugging surface); --no-trace turns it off for
    # benchmarking the bare hot path.
    tracer = None
    if not getattr(args, "no_trace", False):
        from butterfly_tpu_torch.obs.trace import Tracer
        tracer = Tracer()
    # Declared latency objectives (ms on the CLI, seconds internally)
    slo_ttft = getattr(args, "slo_ttft_ms", None)
    slo_itl = getattr(args, "slo_itl_ms", None)
    # Anomaly flight recorder: always on for the serve entrypoint
    from butterfly_tpu_torch.obs.ticklog import FlightRecorder
    flightrec = FlightRecorder(
        dump_dir=getattr(args, "flightrec_dir", None))
    # Periodic signal-history recorder (GET /debug/timeseries), 1 Hz by
    # default; --timeseries-interval 0 disables it
    ts_interval = getattr(args, "timeseries_interval", 1.0)
    timeseries = None
    if ts_interval and ts_interval > 0:
        from butterfly_tpu_torch.obs.timeseries import (SignalRecorder,
                                                        default_rules)
        timeseries = SignalRecorder(interval_s=ts_interval,
                                    rules=default_rules(),
                                    flightrec=flightrec)
    sched = Scheduler(engine, tracer=tracer,
                      slo_ttft_s=slo_ttft / 1e3 if slo_ttft else None,
                      slo_itl_s=slo_itl / 1e3 if slo_itl else None,
                      flightrec=flightrec, timeseries=timeseries)
    # Warm the serving path before listening: the first user does not
    # pay the kernel build, and the heartbeat watchdog never mistakes
    # the startup build for a dead device.
    print("[butterfly] warming serving programs...", flush=True)
    warm_len = min(2 * rt.prefill_chunk, rt.max_seq_len - 4)
    gang = max(1, min(rt.prefill_max_batch, rt.max_batch_size))
    warms = [sched.submit([1], max_new_tokens=2) for _ in range(gang)]
    warms.append(sched.submit([1] * max(1, warm_len), max_new_tokens=2))
    sched.run_until_done()
    assert all(w.done for w in warms)
    return sched, tok, rt


def run_server(args) -> int:
    """`butterfly serve` entrypoint (serve/cli.py)."""
    sched, tok, rt = build_serving(args)
    engine = sched.engine
    print(f"[butterfly] serving {args.model} on {args.host}:{args.port} "
          f"(device={engine.device}, slots={rt.max_batch_size}, "
          f"pages={engine.cache.num_pages - 1}x{rt.page_size}tok)",
          flush=True)
    return serve_forever(sched, tok, args.host, args.port,
                         max_queue=rt.max_queue, model_name=args.model,
                         role=getattr(args, "role", "both"))
