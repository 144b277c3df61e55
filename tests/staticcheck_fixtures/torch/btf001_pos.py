"""BTF001 positive fixture (the port's copy of the rule): outbound HTTP
calls with no timeout.

Expected findings: 4 (urlopen, HTTPConnection, HTTPSConnection —
including a multi-line call the old string-span grep handled only via
a hand-rolled paren scan — and a Request-object urlopen in a control
loop, the shape the autoscaler uses to pull a replica's flight
recorder: a hung replica would wedge every subsequent scale decision).
"""
import http.client
import urllib.request


def probe(url, host, port, headers):
    resp = urllib.request.urlopen(url)                       # 1
    conn = http.client.HTTPConnection(host, port)            # 2
    conn2 = http.client.HTTPSConnection(
        host,
        port,
    )                                                        # 3
    return resp, conn, conn2


def pull_flightrecorder(base):
    req = urllib.request.Request(base + "/debug/flightrecorder")
    with urllib.request.urlopen(
            req) as resp:                                    # 4
        return resp.read()
