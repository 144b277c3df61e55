"""Weight bridge: a JAX parameter tree, as numpy, into the port's tree.

`params_from_numpy` takes the tree after `jax.tree.map(np.asarray,
params)` and returns the same nested dict of torch tensors: same keys,
same [L, ...] layouts, element for element. bfloat16 leaves (numpy's
ml_dtypes bfloat16) cross bit for bit through a uint16 view.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from butterfly_tpu_torch.core.device import resolve_device


def _leaf(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Any, device=None, dtype=None) -> Any:
    """Nested dict of numpy arrays -> the same dict of torch tensors on
    `device` (None = CUDA). `dtype` optionally casts the floating leaves;
    integer leaves keep their type."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _leaf(node, dev, dtype)
    return walk(tree)
