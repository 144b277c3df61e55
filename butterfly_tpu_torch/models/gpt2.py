"""GPT-2 model family: LayerNorm + bias, learned positions, gelu_new, tied
lm_head — all expressed through ModelConfig over the shared layer math in
models/common.py. The counterpart of butterfly_tpu/models/gpt2.py (its HF
checkpoint converter waits for the checkpoint slice; a JAX parameter tree
crosses over through models/bridge.py like Llama's)."""
from __future__ import annotations

from butterfly_tpu_torch.core.config import ModelConfig, gpt2_124m  # noqa: F401
from butterfly_tpu_torch.models.common import Model


def model(cfg: ModelConfig | None = None, device=None) -> Model:
    return Model(cfg or gpt2_124m(), device=device)
