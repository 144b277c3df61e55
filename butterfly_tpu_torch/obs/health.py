"""Heartbeat / failure detection (SURVEY.md §5 failure-detection row).

The reference planned failure detection but has no implementation
(SURVEY.md §0). Design constraint (serve/server.py's invariant): device
work runs on exactly ONE host thread — so the monitor is a pure WATCHDOG
that never touches the device. The owning (device) thread reports
liveness:

* `beat()` after successful device work (a serving tick), or
* `maybe_probe()` when idle — runs the probe IN the calling thread at
  most once per interval and beats on success.

The watchdog thread only compares wall-clock against the last beat:
if no beat lands within `interval * max_misses` seconds it latches
unhealthy and fires `on_failure` once. That catches HANGS (a stalled
collective stops the beats — the probe never returns, and the watchdog
doesn't care) as well as raising probes (counted as misses by
`check_now`, latching at `max_misses`).

Probes: `device_probe` proves the local card completes a program (one
tiny op and a read-back); `all_hosts_probe` proves every device of the
job takes part in a sum over all of them (across processes, an
all-reduce over the torch.distributed group, so a dead peer stalls it).

Recovery after the latch is deliberately NOT automatic: a chip that
flapped is not trustworthy; restart serving (checkpoint/resume path).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

def device_probe(device="cuda") -> bool:
    """Prove `device` still completes a program: one tiny op, read back."""
    import torch
    return (torch.ones(8, device=device) + 1).sum().item() == 16.0


def all_hosts_probe(devices=None) -> bool:
    """Prove every process in the job still participates in collectives.

    In a job of several processes (an initialised torch.distributed
    group larger than 1) each process all-reduces a ones(1) per local
    device (`devices`; None = its visible cards) over the group, and the
    total must equal the global device count. This IS a collective: every
    process must invoke it at the same point in its program stream, so it
    belongs in COORDINATED contexts (startup bringup checks, synchronized
    drain points, test harnesses), never in per-host idle timers, where
    unsynchronized issue order would desync the job and wedge it (the
    serving loop uses device_probe per host instead; a dead peer surfaces
    as the next tick stalling -> staleness latch).

    Single process: one ones(1) per device (None = the visible cards,
    CPU shards when the caller passes them), summed in device order on
    the first device, read back and compared with the device count."""
    import torch
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise RuntimeError("all_hosts_probe: no device to probe (no card "
                           "is visible; pass CPU devices to probe those)")
    total = torch.zeros(1, device=devs[0])
    for d in devs:
        total = total + torch.ones(1, device=d).to(devs[0])
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        from butterfly_tpu_torch.core.mesh import global_devices
        want = len(global_devices(devs[0].type))
        dist.all_reduce(total)
        return int(total.item()) == want
    return int(total.item()) == len(devs)


class HeartbeatMonitor:
    """Watchdog over a liveness timestamp + in-caller-thread probes."""

    def __init__(self, probe: Optional[Callable[[], bool]] = None,
                 interval: float = 10.0, max_misses: int = 6,
                 on_failure: Optional[Callable[[Exception], None]] = None):
        # Default timeout 60s: must exceed any legitimate beat gap. The
        # serving layer warms its programs before starting the monitor,
        # but an uncommon prompt-length bucket can still trigger a
        # mid-tick kernel build of tens of seconds on a large model —
        # that must read as slow, not dead.
        self.probe = probe or device_probe
        self.interval = interval
        self.max_misses = max_misses
        self.on_failure = on_failure
        self.misses = 0
        self.beats = 0
        self.last_error: str = ""
        self._failed = False
        self._latch_lock = threading.Lock()  # owner + watchdog race
        self._last_beat = time.monotonic()
        # -inf, not 0.0: monotonic() is time-since-boot, so on a freshly
        # booted host 0.0 can be within `interval` of now and the first
        # maybe_probe() would silently skip.
        self._last_probe = float("-inf")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watchdog, daemon=True)

    @property
    def healthy(self) -> bool:
        return not self._failed

    @property
    def timeout(self) -> float:
        return self.interval * self.max_misses

    # -- owner (device) thread API ---------------------------------------------

    def beat(self) -> None:
        """Record liveness (call after successful device work)."""
        self._last_beat = time.monotonic()
        self.misses = 0
        self.beats += 1

    def check_now(self) -> bool:
        """Run the probe in THIS thread; beat on success, miss on
        failure (latching at max_misses — raising probes fail faster
        than the staleness timeout)."""
        try:
            ok = bool(self.probe())
            err: Optional[Exception] = None if ok else RuntimeError(
                "heartbeat probe returned falsy")
        except Exception as e:  # noqa: BLE001 — any probe failure counts
            ok, err = False, e
        self._last_probe = time.monotonic()
        if ok:
            self.beat()
            return True
        self.misses += 1
        self.last_error = f"{type(err).__name__}: {err}"
        if self.misses >= self.max_misses:
            self._latch(err)
        return False

    def maybe_probe(self) -> None:
        """check_now() at most once per interval (idle-loop cadence)."""
        if time.monotonic() - self._last_probe >= self.interval:
            self.check_now()

    # -- watchdog thread -----------------------------------------------------

    def start(self) -> "HeartbeatMonitor":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=self.interval + 1.0)

    def _latch(self, err: Optional[Exception]) -> None:
        # one-shot across BOTH callers (owner thread at max_misses and
        # the watchdog on staleness): check-and-set under a lock so a
        # chained alerting hook can never double-fire
        with self._latch_lock:
            if self._failed:
                return
            self._failed = True
        if self.on_failure is not None:
            try:
                self.on_failure(err)
            except Exception:
                pass

    def _watchdog(self) -> None:
        # pure wall-clock staleness check: no device work from this thread
        while not self._stop.wait(self.interval):
            stale = time.monotonic() - self._last_beat
            if stale > self.timeout and not self._failed:
                self.last_error = (f"no heartbeat for {stale:.1f}s "
                                   f"(timeout {self.timeout:.1f}s)")
                self._latch(RuntimeError(self.last_error))
