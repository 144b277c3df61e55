"""Mixtral-8x7B MoE family: Llama-style attention (GQA + RoPE) with a
top-2-of-8 expert SwiGLU FFN, expressed via ModelConfig over the shared
layer math in models/common.py (route_tokens, moe_block), with the
expert-parallel dispatch in parallel/expert.py (cfg.moe_impl="ep"). The
counterpart of butterfly_tpu/models/mixtral.py.

Its HF checkpoint converter, `params_from_hf_state_dict`, waits for the
checkpoint loader (ROADMAP.md, PyTorch/CUDA port queue: Checkpoints)."""
from __future__ import annotations

from butterfly_tpu_torch.core.config import ModelConfig, mixtral_8x7b  # noqa: F401
from butterfly_tpu_torch.models.common import Model


def model(cfg: ModelConfig | None = None, device=None) -> Model:
    return Model(cfg or mixtral_8x7b(), device=device)
