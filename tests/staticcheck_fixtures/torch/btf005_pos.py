"""BTF005 positive fixture (the port's rule): nondeterminism in
trace-feeding code.

Expected findings: 12 — a module-global random draw, an unseeded
random.Random(), a wall-clock read, uuid4, os.urandom, a numpy
global-state draw, a time-series ring append stamped from the wall
clock, and torch's global generator: torch.rand and torch.randint
without generator=, torch.multinomial with generator=None, an in-place
Tensor.exponential_() without one, and torch.manual_seed (it reseeds
the generator every other module draws from).
"""
import os
import random
import time
import uuid

import numpy as np
import torch


def jittered_arrival(rate):
    dt = random.expovariate(rate)            # 1: global PRNG
    rng = random.Random()                    # 2: unseeded
    t0 = time.time()                         # 3: wall clock
    rid = uuid.uuid4()                       # 4: entropy
    salt = os.urandom(8)                     # 5: entropy
    noise = np.random.normal()               # 6: numpy global state
    return dt, rng, t0, rid, salt, noise


def ring_sample(ring, signals):
    # a time-series ring ordered by wall stamps is non-replayable: NTP
    # steps reorder it (the recorder orders by seq + monotonic instead)
    ring.append({"t": time.time(), "signals": signals})   # 7: wall clock


def torch_arrivals(n, weights):
    u = torch.rand(n)                                     # 8: global
    lens = torch.randint(1, 64, (n,))                     # 9: global
    pick = torch.multinomial(weights, n, generator=None)  # 10: None
    gaps = torch.empty(n).exponential_(2.0)               # 11: in place
    torch.manual_seed(n)                                  # 12: global reseed
    return u, lens, pick, gaps
