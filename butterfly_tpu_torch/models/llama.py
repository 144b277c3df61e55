"""Llama-3 model family: RMSNorm, RoPE (rotate-half), GQA, SwiGLU, untied
lm_head — all expressed via ModelConfig over the shared layer math in
models/common.py. The counterpart of butterfly_tpu/models/llama.py
(its HF checkpoint converter waits for the checkpoint slice)."""
from __future__ import annotations

from butterfly_tpu_torch.core.config import ModelConfig, llama3_8b, llama3_70b  # noqa: F401
from butterfly_tpu_torch.models.common import Model


def model(cfg: ModelConfig | None = None, device=None) -> Model:
    return Model(cfg or llama3_8b(), device=device)
