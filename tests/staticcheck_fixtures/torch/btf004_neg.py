"""BTF004 negative fixture: the blessed locking patterns — bounded
acquire, the scheduler thread's own `with self.lock:`, network I/O
outside the critical section, and handler instrument writes under the
metrics lock. Expected findings: 0."""
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler


class State:
    def __init__(self):
        self.lock = threading.Lock()
        self._mlock = threading.Lock()

    def acquire_lock(self, timeout=2.0):
        return self.lock.acquire(timeout=timeout)     # bounded

    def _loop(self):
        # the scheduler thread owns the device: unbounded `with` is its
        # blessed form (State is not a handler class)
        with self.lock:
            self.tick()

    def fetch_then_record(self, url):
        body = urllib.request.urlopen(url, timeout=5.0).read()
        with self._mlock:
            self._c_requests.inc()                    # locked write
        return body


def make_handler(state):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if state.acquire_lock():                  # bounded contract
                try:
                    n = len(state.waiting)
                finally:
                    state.lock.release()
            with state._mlock:
                state._c_requests.inc()               # locked write
                state._g_depth.set(1)

    return Handler


class HostTier:
    """The host-KV-tier idiom: the tier lock guards pure in-memory
    dict/array bookkeeping only; any peer fetch happens BEFORE taking
    it, so allocator threads never wait on a remote."""

    def __init__(self):
        self._lock = threading.Lock()
        self._chains = {}

    def pull_from_peer(self, url, chain):
        body = urllib.request.urlopen(url, timeout=5.0).read()
        with self._lock:                              # memory-only span
            self._chains[chain] = body


def make_kv_handler(state):
    class KvHandler(BaseHTTPRequestHandler):
        def do_POST(self):
            with state._mlock:
                state._h_restore.observe(0.01)        # locked observe

    return KvHandler
