"""BTF004 positive fixture (the port's copy of the rule): lock-discipline violations.

Expected findings: 7 — an unbounded .acquire(), network I/O under a
lock, a raw `with state.lock:` in a handler class, two unlocked
instrument writes in a handler class, a host-tier pull that fetches
pages from a peer while holding the tier lock (every allocator waiting
on that lock inherits the peer's latency), and an unlocked histogram
observe in a handler class.
"""
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler


class State:
    def __init__(self):
        self.lock = threading.Lock()

    def bad_acquire(self):
        self.lock.acquire()                                  # 1

    def bad_io(self, url):
        with self.lock:
            urllib.request.urlopen(url, timeout=1.0)         # 2


def make_handler(state):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            with state.lock:                                 # 3
                n = len(state.waiting)
            state._c_requests.inc()                          # 4
            state._g_depth.set(n)                            # 5

    return Handler


class HostTier:
    def __init__(self):
        self._lock = threading.Lock()
        self._chains = {}

    def pull_from_peer(self, url, chain):
        with self._lock:
            body = urllib.request.urlopen(url, timeout=5.0)  # 6
            self._chains[chain] = body.read()


def make_kv_handler(state):
    class KvHandler(BaseHTTPRequestHandler):
        def do_POST(self):
            state._h_restore.observe(0.01)                   # 7

    return KvHandler
