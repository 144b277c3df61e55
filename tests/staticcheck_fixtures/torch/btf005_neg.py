"""BTF005 negative fixture (the port's rule): the seeded-substream
discipline the workload subsystem uses, with numpy's and torch's own
seeded generators. Expected findings: 0."""
import random
import time

import numpy as np
import torch


def seeded_arrivals(seed, n):
    rng = random.Random((seed << 1) ^ 0xA55A)    # seeded constructor
    times = [rng.expovariate(8.0) for _ in range(n)]  # instance draws
    gen = np.random.default_rng(seed)            # seeded numpy
    t0 = time.monotonic()                        # elapsed, not wall
    time.sleep(0.0)
    return times, gen.normal(), time.monotonic() - t0


def ring_sample(ring, seq, signals, t_wall=0.0):
    # the recorder discipline: ordering from seq + monotonic; the wall
    # stamp is caller-supplied display metadata, never read here
    ring.append({"seq": seq, "t_mono": time.monotonic(),
                 "t_wall": t_wall, "signals": signals})
    return seq + 1


def torch_arrivals(seed, n, weights, **kw):
    g = torch.Generator().manual_seed(seed)      # a seeded generator
    u = torch.rand(n, generator=g)
    lens = torch.randint(1, 64, (n,), generator=g)
    pick = torch.multinomial(weights, n, generator=g)
    gaps = torch.empty(n).exponential_(2.0, generator=g)
    more = torch.randn(n, **kw)                  # splat: accepted
    return u, lens, pick, gaps, more
