"""Logit filters for sampling: the counterparts of
butterfly_tpu/engine/sampling.py's `_apply_top_k`, `_apply_top_p` and
`_filter_logits` (speculative acceptance waits for its slice)."""
from __future__ import annotations

import torch


def _apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
    return torch.where(logits < kth, torch.full_like(logits, -float("inf")),
                       logits)


def _apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens until cumulative prob exceeds p (always keep the first)
    inf = torch.full_like(sorted_logits, float("inf"))
    cutoff = torch.where(cum - probs > p, -inf, sorted_logits)
    threshold = torch.where(torch.isfinite(cutoff), cutoff, inf) \
        .amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, -inf, logits)


def _filter_logits(scaled: torch.Tensor, top_k: int,
                   top_p: float) -> torch.Tensor:
    """The temperature-scaled logits after the static top-k/top-p
    filters."""
    if top_k > 0:
        scaled = _apply_top_k(scaled, top_k)
    if top_p < 1.0:
        scaled = _apply_top_p(scaled, top_p)
    return scaled
