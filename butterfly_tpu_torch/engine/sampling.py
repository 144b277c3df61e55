"""Token samplers: greedy, temperature, top-k, top-p.

The counterparts of butterfly_tpu/engine/sampling.py's `SamplingParams`,
`sample` and logit filters (speculative acceptance waits for its slice).
A sampled draw is Gumbel-max over the filtered, temperature-scaled logits
with uniforms from a `torch.Generator` on the logits' device — the
categorical draw jax.random.categorical makes, from other random bits —
so sampling never syncs with the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0   # 0 => greedy
    top_k: int = 0             # 0 => disabled
    top_p: float = 1.0         # 1.0 => disabled
    max_new_tokens: int = 128
    stop_token: int = -1       # -1 => none

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0


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


def gumbel_argmax(scaled: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """One categorical draw per row of softmax(scaled) [..., V] -> [...]
    int32, by Gumbel-max with uniforms from `generator`."""
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    return torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1) \
        .to(torch.int32)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           sp: SamplingParams) -> torch.Tensor:
    """logits [B,V] float32 -> token ids [B] int32: argmax when greedy,
    else a draw from the temperature-scaled, top-k/top-p filtered
    distribution."""
    if sp.is_greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = _filter_logits(logits / sp.temperature, sp.top_k, sp.top_p)
    return gumbel_argmax(scaled, generator)
