"""BTF006 negative fixture (the port's rule): one seeded torch.Generator
drawn from many times — each draw advances its state, so the draws are
independent (the JAX rule's key reuse does not apply) — seeded from the
request or scheduler seed, and passed to every draw. Expected findings:
0."""
import torch

from butterfly_tpu_torch.engine.sampling import (sample, speculative_accept,
                                                 speculative_tree_accept)


def decode(logits, drafts, temps, sp, seed, steps, **kw):
    gen = torch.Generator(device=logits.device)
    gen.manual_seed(int(seed))                  # the request's seed
    toks = []
    for _ in range(steps):
        toks.append(sample(logits, gen, sp))    # the same generator again
    em, n = speculative_accept(logits, drafts, gen, temps, 0, 1.0)
    em2, n2, perm = speculative_tree_accept(logits, drafts, generator=gen,
                                            temps=temps, top_k=0, top_p=1.0,
                                            width=2, nodes=7)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    v = torch.empty(4).uniform_(generator=gen)
    w = sample(logits, **kw)                    # splat: accepted
    return toks, em, n, em2, n2, perm, u, v, w
