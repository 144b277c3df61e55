"""Weight preparation shared by the engines: the counterpart of
butterfly_tpu/engine/engine.py's `cast_params` (its InferenceEngine
waits for the `generate` slice)."""
from __future__ import annotations

from butterfly_tpu_torch.core.config import ModelConfig
from butterfly_tpu_torch.models.common import torch_dtype


def cast_params(params, cfg: ModelConfig):
    """One-time cast of the weight tree to the compute dtype.

    Floating leaves already in the compute dtype are returned as they
    are (no copy); integer leaves are left alone."""
    target = torch_dtype(cfg.dtype)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if node.is_floating_point() and node.dtype != target:
            return node.to(target)
        return node
    return walk(params)
