"""BTF001 negative fixture (the port's copy of the rule): every call
carries a timeout — keyword,
positional (the stdlib signature position), or an opaque **kwargs splat
(accepted: the analyzer cannot see inside). Expected findings: 0."""
import http.client
from urllib.request import urlopen


def probe(url, host, port, kw):
    a = urlopen(url, None, 5.0)                        # positional
    b = urlopen(url, timeout=2.0)                      # keyword
    c = http.client.HTTPConnection(host, port, timeout=1.0)
    d = http.client.HTTPSConnection(host, timeout=1.0)
    e = urlopen(url, **kw)                             # splat: accepted
    with urlopen(url,
                 timeout=30) as resp:                  # multi-line kw
        resp.read()
    f = urlopen(url + "/debug/flightrecorder",
                timeout=10.0)                          # control-loop pull
    return a, b, c, d, e, f
