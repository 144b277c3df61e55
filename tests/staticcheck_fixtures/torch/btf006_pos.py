"""BTF006 positive fixture (the port's rule, settled for torch): draws
from torch's process-global generator and constant seeds in the serving
path.

Expected findings: 7 — a generator seeded from a literal, a chained
Generator().manual_seed(literal), a torch.randn without generator=, an
in-place Tensor.uniform_() without one, and the project's sampling
wrappers without their generator: sample() with a literal None,
speculative_accept() with generator=None, and gumbel_argmax() with its
generator left out.
"""
import torch

from butterfly_tpu_torch.engine.sampling import (gumbel_argmax, sample,
                                                 speculative_accept)


def step(logits, drafts, temps, sp, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(1234)                                 # 1: constant
    g2 = torch.Generator().manual_seed(0)                 # 2: constant
    noise = torch.randn(logits.shape)                     # 3: global
    u = torch.empty(4).uniform_()                         # 4: global
    tok = sample(logits, None, sp)                        # 5: global
    em, n = speculative_accept(logits, drafts, generator=None,
                               temps=temps, top_k=0, top_p=1.0)  # 6
    pick = gumbel_argmax(logits)                          # 7: missing
    return gen, g2, noise, u, tok, em, n, pick
