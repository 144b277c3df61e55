"""Profiling hooks on torch.profiler: the counterpart of
butterfly_tpu/obs/profile.py.

* `trace(logdir)` captures the enclosed region (CPU ops, and CUDA
  kernels where there is a card) and writes a Chrome trace
  (`trace_<pid>_<ns>.json`, loadable in Perfetto or chrome://tracing)
  into `logdir`.
* `start_capture` / `stop_capture` are the same capture split in two, for
  a caller that starts and stops it from a loop (serve/server.py's
  POST /debug/profile). The profiler is process-global, so one capture
  runs at a time: a second start raises `ProfilerBusy`.
* `start_profiler_server(port, capture)` serves on-demand captures of a
  live serve loop over HTTP: `POST /profile {"duration_ms", "logdir"}`
  answers with the trace's path. torch has no XProf-style profiler
  server, so this is the port's equivalent of `jax.profiler.start_server`.
* `annotate(name)` names a region in the trace
  (torch.profiler.record_function), and `StepTimer` is a host-side ring
  buffer of step latencies.

CPU ops are recorded for the thread that starts the capture; CUDA
kernels for the whole process. The serve loop therefore starts its own
captures (serve/server.py hands both endpoints' requests to it).
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterator, Optional

import numpy as np


class ProfilerUnavailable(RuntimeError):
    """The capture could not start or complete (no profiler, a stalled
    loop): the HTTP surfaces answer 501 with the reason."""


class ProfilerBusy(RuntimeError):
    """A capture is already in flight (the profiler is process-global):
    the HTTP surfaces answer 409."""


#: the process-global capture: (torch profiler, logdir), or None
_CAPTURE: Optional[tuple] = None
_CAPTURE_LOCK = threading.Lock()


def _activities():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_capture(logdir: str) -> None:
    """Start the process-global capture; its trace goes into `logdir`."""
    global _CAPTURE
    import torch
    with _CAPTURE_LOCK:
        if _CAPTURE is not None:
            raise ProfilerBusy("a profile capture is already running")
        os.makedirs(logdir, exist_ok=True)
        prof = torch.profiler.profile(activities=_activities())
        prof.start()
        _CAPTURE = (prof, logdir)


def stop_capture() -> str:
    """Stop the running capture and write its Chrome trace; returns the
    trace's path."""
    global _CAPTURE
    with _CAPTURE_LOCK:
        if _CAPTURE is None:
            raise RuntimeError("no profile capture is running")
        prof, logdir = _CAPTURE
        _CAPTURE = None
    prof.stop()
    path = os.path.join(logdir, f"trace_{os.getpid()}_"
                                f"{time.monotonic_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture the enclosed region into a Chrome trace under `logdir`."""
    start_capture(logdir)
    try:
        yield
    finally:
        stop_capture()


def _no_loop(duration_ms: float, logdir: Optional[str]) -> Dict:
    """The profiler server's capture where no serve loop supplies one: a
    capture started here would record this server thread's CPU ops, not
    the loop's, so it answers 501."""
    raise ProfilerUnavailable("no serve loop takes this server's captures")


#: the live profiler server (one per process, like jax's)
_PROFILER_SERVER: Optional[ThreadingHTTPServer] = None


def _handler(capture: Callable[[float, Optional[str]], Dict]):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # keep the serving log clean
            pass

        def _json(self, code, obj):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self):
            if self.path != "/profile":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n) or b"{}")
                duration_ms = min(max(float(body.get("duration_ms", 1000.0)),
                                      10.0), 60000.0)
                logdir = body.get("logdir")
                logdir = None if logdir is None else str(logdir)
            except (ValueError, TypeError, AttributeError) as e:
                self._json(400, {"error": str(e)})
                return
            try:
                self._json(200, capture(duration_ms, logdir))
            except ProfilerBusy as e:
                self._json(409, {"error": str(e)})
            except ProfilerUnavailable as e:
                self._json(501, {"error": str(e)})
    return Handler


def start_profiler_server(port: int = 9999,
                          capture: Optional[Callable] = None) -> bool:
    """On-demand profiling for live servers: `POST /profile
    {"duration_ms", "logdir"}` on `port` runs `capture(duration_ms,
    logdir)` and answers its result: 409 while another capture runs, 501
    when the capture cannot start or no `capture` was given (the serve
    loop supplies one, so the trace holds its CPU ops). Returns True when listening. Failure — a
    profiler without CUDA tracing on a CUDA process (no CUPTI), the port
    already bound, a second start in one process — logs a warning and
    returns False instead of raising (`serve --profiler-port` is an
    observability convenience, never worth taking the replica down)."""
    global _PROFILER_SERVER
    try:
        import torch
        if _PROFILER_SERVER is not None:
            raise RuntimeError("a profiler server is already running in "
                               "this process")
        if torch.cuda.is_available() and torch.profiler.ProfilerActivity.CUDA \
                not in torch.profiler.supported_activities():
            print("[butterfly] profiler server unavailable: this torch "
                  "cannot trace CUDA (no CUPTI)", file=sys.stderr, flush=True)
            return False
        srv = ThreadingHTTPServer(("", port), _handler(capture or _no_loop))
    except Exception as e:  # port in use / double start / profiler quirk
        print(f"[butterfly] profiler server failed to start on :{port}: "
              f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
        return False
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="profiler-server").start()
    _PROFILER_SERVER = srv
    return True


def stop_profiler_server() -> None:
    """Close the profiler server, if one runs (the serve loop's exit)."""
    global _PROFILER_SERVER
    srv, _PROFILER_SERVER = _PROFILER_SERVER, None
    if srv is not None:
        srv.shutdown()
        srv.server_close()


def annotate(name: str):
    """Named region: shows up in the trace (torch.profiler.record_function)."""
    import torch
    return torch.profiler.record_function(name)


class StepTimer:
    """Host-side ring buffer of step latencies -> percentiles."""

    def __init__(self, capacity: int = 1024):
        self._lat = deque(maxlen=capacity)

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._lat.append(time.perf_counter() - t0)

    def percentiles(self) -> Dict[str, float]:
        if not self._lat:
            return {}
        a = np.asarray(self._lat)
        return {"step_p50_s": float(np.percentile(a, 50)),
                "step_p95_s": float(np.percentile(a, 95)),
                "step_p99_s": float(np.percentile(a, 99)),
                "steps_recorded": float(len(a))}
