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
* `device_kernels(prof)`, `op_kernels(prof, name)` and
  `range_device_us(prof, name)` read a finished capture's device time
  straight from its raw kineto events. `prof.key_averages()` and
  `prof.events()` first build a Python event for every op, each linked
  to its parent and children: over a minute on a long trace, and
  hundreds of thousands of objects in reference cycles that every full
  collection scans until one frees them.

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
from typing import Callable, Dict, Iterator, List, Optional, Tuple

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


class KernelTotal:
    """One device kernel's totals over a trace: what key_averages() gives
    for a CUDA row (key, count, self_device_time_total in us)."""
    __slots__ = ("key", "count", "self_device_time_total")

    def __init__(self, key: str):
        self.key, self.count, self.self_device_time_total = key, 0, 0.0


def _raw_events(prof):
    return prof.profiler.kineto_results.events()


def _is_kernel(e) -> bool:
    """A device activity that key_averages() counts as a CUDA row (not a
    range annotation mirrored onto the device timeline)."""
    from torch.autograd import DeviceType
    return (e.device_type() == DeviceType.CUDA and not e.is_async()
            and e.start_thread_id() == e.end_thread_id()
            and not getattr(e, "is_hidden_event", lambda: False)()
            and not e.is_user_annotation())


def _is_host_op(e) -> bool:
    """A host-side op or range (not a runtime call linked to one)."""
    from torch.autograd import DeviceType
    return (e.device_type() == DeviceType.CPU and not e.is_async()
            and e.linked_correlation_id() == 0)


def device_kernels(prof) -> List[KernelTotal]:
    """The capture's device kernels grouped by name, with the filters
    key_averages() applies."""
    by: Dict[str, KernelTotal] = {}
    for e in _raw_events(prof):
        if not _is_kernel(e):
            continue
        k = by.get(e.name())
        if k is None:
            k = by[e.name()] = KernelTotal(e.name())
        k.count += 1
        k.self_device_time_total += (e.end_ns() - e.start_ns()) / 1e3
    return list(by.values())


def host_ops(prof) -> List[Tuple[str, int, float]]:
    """(name, count, inclusive host us) of the capture's host ops and
    ranges, grouped by name: the report where no kernel ran."""
    by: Dict[str, List] = {}
    for e in _raw_events(prof):
        if _is_host_op(e):
            row = by.setdefault(e.name(), [0, 0.0])
            row[0] += 1
            row[1] += (e.end_ns() - e.start_ns()) / 1e3
    return [(name, n, us) for name, (n, us) in by.items()]


def op_kernels(prof, name: str) -> List[Tuple[list, float]]:
    """(input shapes, device us) of every host op called `name`: the
    device time of the kernels it launched itself, linked by correlation
    id (what FunctionEvent.device_time_total gives a leaf op such as
    aten::copy_). Shapes need a capture with record_shapes."""
    events = _raw_events(prof)
    ops = {e.correlation_id(): [e.shapes(), 0.0] for e in events
           if e.name() == name and _is_host_op(e)}
    for e in events:
        if _is_kernel(e):
            op = ops.get(e.linked_correlation_id())
            if op is not None:
                op[1] += (e.end_ns() - e.start_ns()) / 1e3
    return [(shapes, us) for shapes, us in ops.values()]


def range_device_us(prof, name: str) -> float:
    """Device us of the kernels launched inside host ranges called `name`
    (`annotate(name)` around a call): a kernel counts when the op that
    launched it starts inside such a range on the range's thread."""
    import bisect
    events = _raw_events(prof)
    ops, ranges = {}, {}
    for e in events:
        if _is_host_op(e):
            ops[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
            if e.name() == name:
                ranges.setdefault(e.start_thread_id(), []).append(
                    (e.start_ns(), e.end_ns()))
    for spans in ranges.values():
        spans.sort()
    starts = {t: [s for s, _ in spans] for t, spans in ranges.items()}
    us = 0.0
    for e in events:
        if not _is_kernel(e):
            continue
        at = ops.get(e.linked_correlation_id())
        if at is None or at[1] not in ranges:
            continue
        i = bisect.bisect_right(starts[at[1]], at[0]) - 1
        if i >= 0 and at[0] <= ranges[at[1]][i][1]:
            us += (e.end_ns() - e.start_ns()) / 1e3
    return us


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
