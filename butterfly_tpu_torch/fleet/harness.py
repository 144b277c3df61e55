"""In-process fleet topologies: N prefill + M decode replicas behind
one disaggregated control plane, all in this process.

The local twin of a real deployment (`butterfly serve --role ...` x N
behind `butterfly route --disaggregate`): each replica is a full
Scheduler + ServingEngine + HTTP front on a loopback port, the control
plane is the real ControlPlaneState/FleetHandler — only the network is
loopback. Used by `butterfly fleet --topology 2p2d` (manual
debugging), tests/test_fleet.py (the soak), and the fleet benchmark
(obs/benchmark.py). All replicas share ONE param tree (same weights,
as a real fleet would load from one checkpoint), which is also what
makes cross-replica KV bytes interchangeable: on the card the tree is
held once, whatever the replica count.

``ReplicaHandle.restart()`` bounces the replica's HTTP front (the
listener drops mid-fleet and comes back on the same port) — the
rolling-restart half of the soak's drain/restart cycle; the drain half
goes through the control plane's inherited /router/drain admin
surface.

The port of butterfly_tpu/fleet/harness.py. Replicas run on `device`
(None = CUDA, as every entry point of the port; the tests pass "cpu"),
each with its own scheduler thread and HTTP threads; on the card their
device work shares the default stream, so replicas interleave rather
than run in parallel. A stopped replica's scheduler thread is joined, and
a retired one's KV pool is released before `retire` returns.
"""
from __future__ import annotations

import gc
import re
import threading
import time
from http.server import ThreadingHTTPServer
from typing import List, Optional, Tuple

from butterfly_tpu_torch.core.config import RuntimeConfig, tiny
from butterfly_tpu_torch.fleet.controlplane import (
    ControlPlaneState, make_fleet_handler)
from butterfly_tpu_torch.obs.registry import MetricsRegistry
from butterfly_tpu_torch.router.policy import PrefixAffinityPolicy
from butterfly_tpu_torch.router.pool import ReplicaPool


def parse_topology(spec: str) -> List[str]:
    """Topology spec -> per-replica role list. Arbitrary 'NpMd' shapes
    ('2p2d', '3p5d', '0p4d' — a zero side means that tier starts empty,
    the elastic-fleet starting shapes; '0p0d' is meaningless) plus the
    bare-digit shorthand '4' for a role-less 4x'both' pool."""
    m = re.fullmatch(r"(\d+)p(\d+)d", spec.strip().lower())
    if m:
        n_pre, n_dec = int(m.group(1)), int(m.group(2))
        if n_pre + n_dec < 1:
            raise ValueError(f"topology {spec!r} needs >=1 replica")
        return ["prefill"] * n_pre + ["decode"] * n_dec
    if spec.strip().isdigit() and int(spec) >= 1:
        return ["both"] * int(spec)  # role-less pool
    raise ValueError(f"unparseable topology {spec!r} (want e.g. '2p2d')")


class ReplicaHandle:
    def __init__(self, state, httpd, sched, role: str, host: str,
                 handler_cls=None):
        self.state = state
        self.httpd = httpd
        self.sched = sched
        self.role = role
        self.host = host
        self.port = httpd.server_port
        self.rid = f"{host}:{self.port}"
        self.url = f"http://{self.rid}"
        # the handler class the front was built with (incl. any chaos
        # wrapper) so a restart keeps injecting the same fault plan
        self.handler_cls = handler_cls

    def restart(self) -> None:
        """Bounce the HTTP front on the same port (connects fail for
        the gap, exactly like a rolling binary restart of the serving
        tier; scheduler + KV state survive, as they would behind a
        real graceful-restart supervisor)."""
        from butterfly_tpu_torch.serve.server import make_handler
        handler = self.handler_cls or make_handler(self.state)
        self.httpd.shutdown()
        self.httpd.server_close()
        self.httpd = ThreadingHTTPServer((self.host, self.port), handler)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def stop(self) -> None:
        self.state.stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        # no tick may still be running on the pools once stop returns
        self.state.thread.join(timeout=30.0)


class FleetHandle:
    def __init__(self, replicas: List[ReplicaHandle], cp_state, cp_httpd,
                 spawn_ctx: Optional[dict] = None):
        self.replicas = replicas
        self.state = cp_state
        self.httpd = cp_httpd
        self.url = f"http://127.0.0.1:{cp_httpd.server_port}"
        self.by_rid = {r.rid: r for r in replicas}
        # runtime spawn context (model + shared param tree + replica
        # kwargs) captured by start_fleet: what makes a spawned
        # replica's KV bytes interchangeable with the incumbents'
        self._spawn_ctx = spawn_ctx
        self._lock = threading.Lock()
        self._tier_index: dict = {}
        for r in replicas:
            self._tier_index[r.role] = self._tier_index.get(r.role, 0) + 1

    @property
    def rids(self) -> List[str]:
        return [r.rid for r in self.replicas]

    def spawn(self, role: str) -> ReplicaHandle:
        """Grow one tier at runtime: start a replica on the SHARED
        param tree, warm it (start_replica warms BEFORE its HTTP front
        binds — warm-before-join is structural, a joining replica can
        never serve a build-cold request), then attach it to the
        pool, probe it so its role is known before anything routes,
        and remap the affinity ring."""
        if self._spawn_ctx is None:
            raise RuntimeError("this fleet was started without a spawn "
                               "context (start_fleet builds one)")
        with self._lock:
            idx = self._tier_index.get(role, 0)
            self._tier_index[role] = idx + 1
        ctx = self._spawn_ctx
        handle = start_replica(ctx["model"], ctx["params"], role,
                               chaos_index=idx, **ctx["replica_kw"])
        pool = self.state.pool
        pool.add(handle.rid)
        rep = pool.get(handle.rid)
        if rep is not None:
            pool.probe_one(rep)  # learn role/load before routing
        self.state.policy.rebuild_ring()
        with self._lock:
            self.replicas.append(handle)
            self.by_rid[handle.rid] = handle
        return handle

    def retire(self, rid: str, timeout: float = 30.0) -> bool:
        """Shrink a tier at runtime, drain-before-retire: mark the
        member draining (no NEW requests route to it), wait for its
        proxied legs AND its own queue/runners to empty, then stop its
        front, detach it from the pool, and remap the affinity ring.
        On timeout the replica is retired anyway — bounded shrink beats
        a wedged runner pinning capacity forever. False if unknown."""
        handle = self.by_rid.get(rid)
        if handle is None:
            return False
        pool = self.state.pool
        if len(pool.replicas) <= 1:
            raise ValueError("cannot retire the last replica")
        pool.set_drain(rid, True)
        deadline = time.monotonic() + timeout
        sched = handle.sched
        while time.monotonic() < deadline:
            rep = pool.get(rid)
            outstanding = rep.outstanding if rep is not None else 0
            # cross-thread reads of the scheduler's queues are racy but
            # monotone-enough for a drain check: a request in flight is
            # visible in at least one of these until its finish callback
            if outstanding == 0 and not sched.waiting \
                    and not sched.running and not sched._prefill_group:
                break
            time.sleep(0.02)
        handle.stop()
        pool.remove(rid)
        self.state.policy.rebuild_ring()
        with self._lock:
            self.replicas.remove(handle)
            self.by_rid.pop(rid, None)
        # The replica's HTTP handler class closes over its ServerState,
        # and a class is always in a reference cycle, so its KV pool
        # would wait for the cycle collector: collect now, so a retire
        # gives the pool's device memory back before a later spawn.
        del handle, sched
        gc.collect()
        return True

    def stop(self) -> None:
        self.state.pool.stop()
        self.httpd.shutdown()
        self.httpd.server_close()
        for r in self.replicas:
            r.stop()


def start_replica(model, params, role: str, *, page_size: int = 8,
                  max_batch: int = 2, max_seq: int = 128,
                  num_pages: Optional[int] = None,
                  host: str = "127.0.0.1", warm: bool = True,
                  warm_len: Optional[int] = None,
                  slo_ttft_s: Optional[float] = None,
                  slo_itl_s: Optional[float] = None,
                  host_kv_tier_mb: float = 0.0,
                  host_kv_tier_dir: Optional[str] = None,
                  chaos=None, chaos_index: int = 0,
                  device=None) -> ReplicaHandle:
    """One in-process serve replica on a fresh loopback port. Prefix
    caching is always on — it is the registry KV transfer addresses
    pages through. Tracing is always on — the fleet trace merge
    (GET /fleet/trace) joins each replica's /debug/requests timeline
    into the cross-replica waterfall, exactly like a real `butterfly
    serve` replica (which traces by default). Warming runs BEFORE the
    scheduler loop thread starts (one thread ticks a scheduler, ever).
    `chaos` (fleet/chaos.py ChaosPlan) wraps the HTTP handler in the
    seeded fault-injection hook; `chaos_index` is this replica's index
    within its role tier (plans target e.g. 'decode:0'). `device` (None =
    the model's device) is where the engine runs; `params` are used as
    they are when already there (no copy per replica)."""
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.obs.trace import Tracer
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    from butterfly_tpu_torch.serve.server import ServerState, make_handler
    from butterfly_tpu_torch.utils.tokenizer import ByteTokenizer

    from butterfly_tpu_torch.obs.ticklog import FlightRecorder

    rt = RuntimeConfig(max_batch_size=max_batch, max_seq_len=max_seq,
                       page_size=page_size, num_pages=num_pages,
                       prefix_caching=True,
                       host_kv_tier_mb=host_kv_tier_mb,
                       host_kv_tier_dir=host_kv_tier_dir)
    # flight recorder always on, like tracing: the fleet rollup
    # (GET /fleet/flightrecorder) merges every replica's ring
    sched = Scheduler(ServingEngine(model, params, rt, device=device),
                      tracer=Tracer(),
                      slo_ttft_s=slo_ttft_s, slo_itl_s=slo_itl_s,
                      flightrec=FlightRecorder())
    if warm:
        # first launches off any measured clock, BOTH prefill flavors:
        # the first warm prompt runs the fresh path, the repeat
        # prefix-hits its registered pages and runs the warm
        # continuation the transfer handoff's tail prefill uses. On the
        # card this builds the kernels (under ops/build.py's lock)
        # before the scheduler thread starts and before any measured
        # request.
        wl = min(warm_len or page_size * 2, max_seq - 4)
        for _ in range(2):
            w = sched.submit([1] * wl, max_new_tokens=2)
            sched.run_until_done()
            assert w.done
    state = ServerState(sched, ByteTokenizer(), role=role)
    state.thread.start()
    handler_cls = make_handler(state)
    ident = None
    if chaos is not None:
        from butterfly_tpu_torch.fleet.chaos import (ChaosIdent,
                                                     make_chaos_handler)
        ident = ChaosIdent(role=role, index=chaos_index)
        handler_cls = make_chaos_handler(handler_cls, chaos, ident)
    httpd = ThreadingHTTPServer((host, 0), handler_cls)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    handle = ReplicaHandle(state, httpd, sched, role, host,
                           handler_cls=handler_cls)
    if ident is not None:
        ident.rid = handle.rid  # known only after the port binds
    return handle


def start_fleet(topology: str = "2p2d", *, page_size: int = 8,
                max_batch: int = 2, max_seq: int = 128,
                num_pages: Optional[int] = None,
                disagg_threshold: int = 16, affinity_blocks: int = 4,
                probe_interval: float = 0.2, model=None, params=None,
                warm: bool = True,
                warm_len: Optional[int] = None,
                slo_ttft_s: Optional[float] = None,
                slo_itl_s: Optional[float] = None,
                host_kv_tier_mb: float = 0.0,
                host_kv_tier_dir: Optional[str] = None,
                chaos=None, device=None) -> FleetHandle:
    """Spin the whole topology: replicas (one shared tiny-model param
    tree unless the caller provides model+params) + control plane, and
    optionally warm every replica's serving path so the first measured
    request doesn't pay the kernel build. `chaos` (a fleet/chaos.py
    ChaosPlan) installs the seeded fault hooks on every replica front
    AND the control plane's handoff legs. `device` (None = the model's
    device, CUDA for the default model) is where every replica runs."""
    import torch

    from butterfly_tpu_torch.core.device import resolve_device
    from butterfly_tpu_torch.models.common import Model, init_params

    roles = parse_topology(topology)
    if model is None:
        dev = resolve_device(device)
        model = Model(tiny("llama", dtype="float32", param_dtype="float32"),
                      device=dev)
        gen = torch.Generator(device=dev)
        # btf: disable=BTF006 replicas must share one identical param tree (KV bytes interchangeable)
        gen.manual_seed(0)
        params = init_params(model.cfg, gen, dev)
    replica_kw = dict(page_size=page_size, max_batch=max_batch,
                      max_seq=max_seq, num_pages=num_pages, warm=warm,
                      warm_len=warm_len, slo_ttft_s=slo_ttft_s,
                      slo_itl_s=slo_itl_s,
                      host_kv_tier_mb=host_kv_tier_mb,
                      host_kv_tier_dir=host_kv_tier_dir, chaos=chaos,
                      device=device)
    tier_index: dict = {}
    replicas = []
    for role in roles:
        idx = tier_index.get(role, 0)
        tier_index[role] = idx + 1
        replicas.append(start_replica(
            model, params, role, chaos_index=idx, **replica_kw))
    registry = MetricsRegistry()
    pool = ReplicaPool([r.rid for r in replicas],
                       probe_interval=probe_interval, registry=registry,
                       scrape_metrics=True)
    policy = PrefixAffinityPolicy(pool, page_size=page_size,
                                  affinity_blocks=affinity_blocks)
    cp_state = ControlPlaneState(pool, policy, registry=registry,
                                 read_timeout=120.0,
                                 disagg_threshold=disagg_threshold,
                                 slo_ttft_s=slo_ttft_s,
                                 slo_itl_s=slo_itl_s,
                                 chaos=chaos)
    pool.probe_all()  # learn roles before the first request routes
    pool.start()
    cp_httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                   make_fleet_handler(cp_state))
    threading.Thread(target=cp_httpd.serve_forever, daemon=True).start()
    spawn_ctx = {"model": model, "params": params, "replica_kw": replica_kw}
    return FleetHandle(replicas, cp_state, cp_httpd, spawn_ctx=spawn_ctx)
