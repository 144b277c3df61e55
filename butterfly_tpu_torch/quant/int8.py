"""Int8 weight-only quantization, in PyTorch.

The counterpart of butterfly_tpu/quant/int8.py, with the same scheme and
the same tree layout. For each matmul weight W with contraction axes C,

    scale = max(absmax(W, over C), 1e-8) / 127     (keepdims, float32)
    q8    = round(W / scale)                       (int8, half to even)
    W    ~= q8 * scale

and the quantized leaf `{"q8": int8, "s": scale in the compute dtype}`
replaces the float array. Embeddings, norms, biases and the MoE router
stay float. XLA compiles the JAX division by the constant 127 into a
product with float32(1/127), and the port computes the scale that way;
torch.round and jnp.round both round half to even, so the codes and
scales are the JAX tree's byte for byte.

`qeinsum` contracts x against the codes converted to the compute dtype
and applies the per-output-channel scale to the matmul OUTPUT (the scale
has size-1 contraction dims, so it commutes with the contraction). On the
card the convert materialises a compute-dtype copy of the weight for each
call; a fused W8A16 GEMM that reads the codes directly is on the ROADMAP's
performance list.

The MoE expert leaves (`layers.moe.w_*`, [L, E, D, F] / [L, E, F, D])
quantize over their D / F axis like the dense MLP's; `qeinsum` takes the
MoE specs of models/common.py and parallel/expert.py as it takes the
dense ones. Under a mesh the {"q8", "s"} leaves split with the float
ones (`shard_quantized_params`): the codes take the weight's spec, the
scale keeps it only on its dims still > 1 (`quant_specs_like`), so a
tensor shard's codes and scales are the same output channels.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, Any]

#: Elements per random-init chunk: one f32 chunk plus its quantization
#: temporaries stay a few hundred MiB however large the leaf.
_INIT_CHUNK_ELEMS = 128 * 2**20

_INV127 = float(np.float32(1.0 / 127.0))


def is_quantized_leaf(x: Any) -> bool:
    return isinstance(x, dict) and "q8" in x and "s" in x


def tree_is_quantized(params: Params) -> bool:
    """True if any leaf of the nested dict is a `{"q8", "s"}` leaf."""
    if is_quantized_leaf(params):
        return True
    if isinstance(params, dict):
        return any(tree_is_quantized(v) for v in params.values())
    return False


def maybe_dequant(w: Any, dtype) -> torch.Tensor:
    """Dequantize a `{"q8", "s"}` leaf to `dtype`; pass tensors through.
    Matmul call sites use `qeinsum` instead (no dequantized operand)."""
    if is_quantized_leaf(w):
        return w["q8"].to(dtype) * w["s"].to(dtype)
    return w


def dequant_tree(params: Params, dtype) -> Params:
    """The whole tree with every quantized leaf dequantized to `dtype`."""
    if is_quantized_leaf(params):
        return maybe_dequant(params, dtype)
    if isinstance(params, dict):
        return {k: dequant_tree(v, dtype) for k, v in params.items()}
    return params


def qeinsum(spec: str, x: torch.Tensor, w: Any,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """einsum(spec, x, W) for a possibly-quantized right operand W.

    Float W is cast to `dtype` (default x's). Quantized W: x contracts
    against the codes in `dtype`, and the scale, brought to the output's
    shape by the same spec over an all-ones x of rank x.ndim, multiplies
    the result (x @ (q8 * s) == (x @ q8) * s)."""
    dtype = dtype or x.dtype
    if not is_quantized_leaf(w):
        if w.is_floating_point() and w.dtype != dtype:
            w = w.to(dtype)
        return torch.einsum(spec, x, w)
    y = torch.einsum(spec, x, w["q8"].to(dtype))
    ones = torch.ones((1,) * x.ndim, dtype=dtype, device=x.device)
    s_out = torch.einsum(spec, ones, w["s"].to(dtype))
    return y * s_out


def _quant(w: torch.Tensor, axes: Tuple[int, ...],
           dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    wf = w.float()
    amax = wf.abs().amax(dim=axes, keepdim=True)
    # float32(1/127): the product XLA makes of the JAX `/ 127.0`
    scale = torch.clamp(amax, min=1e-8) * _INV127
    q8 = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    # the scale lives in the compute dtype, so cast_params leaves a
    # quantized tree as it is
    return {"q8": q8, "s": scale.to(dtype)}


#: Contraction axes of each quantized matmul weight, by (parent, name):
#: wq/wk/wv [L,D,N,H] -> D; wo [L,N,H,D] -> (N,H); mlp w_gate/w_up
#: [L,D,F] -> D, w_down [L,F,D] -> F; moe [L,E,D,F]/[L,E,F,D] -> the D/F
#: axis; lm_head [D,V] -> D.
def _axes(parent: str, name: str) -> Optional[Tuple[int, ...]]:
    if name in ("wq", "wk", "wv"):
        return (1,)
    if name == "wo":
        return (1, 2)
    if parent == "moe" and name in ("w_gate", "w_up", "w_down"):
        return (2,)
    if parent == "mlp" and name in ("w_gate", "w_up", "w_down"):
        return (1,)
    if name == "lm_head":
        return (0,)
    return None


def _compute_dtype(cfg) -> torch.dtype:
    from butterfly_tpu_torch.models.common import torch_dtype
    return torch_dtype(cfg.dtype)


def quantize_int8(params: Params, cfg) -> Params:
    """Quantize every matmul weight of an init_params-shaped tree (the
    contraction axes of `_axes`). Stacked [L, ...] leaves quantize one
    layer at a time, so the float32 temporaries stay one layer's size;
    the input tree is not modified."""
    dt = _compute_dtype(cfg)

    def leaf(a, axes):
        if a.dim() > 1 and 0 not in axes and a.shape[0] > 1:
            # per-layer slices: the scale of a layer never reads another
            parts = [_quant(a[i:i + 1], axes, dt) for i in range(a.shape[0])]
            return {k: torch.cat([p[k] for p in parts]) for k in ("q8", "s")}
        return _quant(a, axes, dt)

    def walk(node, parent):
        out = {}
        for name, v in node.items():
            axes = _axes(parent, name)
            if isinstance(v, dict):
                out[name] = walk(v, name)
            elif axes is not None and (parent in ("attn", "mlp", "moe")
                                       or name == "lm_head"):
                out[name] = leaf(v, axes)
            else:
                out[name] = v
        return out
    return walk(params, "")


def _shape_tree(cfg) -> Params:
    """init_params' tree as fake tensors (shapes and dtypes, no storage),
    so init_params_quantized follows the real initializer's structure."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from butterfly_tpu_torch.models.common import init_params
    with FakeTensorMode():
        return init_params(cfg, None, device="cpu")


def _chunk_spans(n: int, size: int):
    """[(start, length)] splitting an axis of n entries so each chunk of a
    `size`-element tensor stays near _INIT_CHUNK_ELEMS."""
    nchunks = min(n, -(-size // _INIT_CHUNK_ELEMS))
    csize = -(-n // max(1, nchunks))
    return [(lo, min(csize, n - lo)) for lo in range(0, n, csize)]


def _init_quant_leaf(gen, shape, axes, dt, device, keep=None):
    """N(0, 0.02) weights drawn chunk by chunk along the largest
    non-contracted axis (per-output-channel scales make the chunks
    independent) and quantized as they are drawn. `keep` = [lo, hi)
    keeps only those entries of dim 1 (the experts of an MoE leaf), each
    chunk still drawn whole."""
    ax = max((d for d in range(len(shape)) if d not in axes),
             key=lambda d: shape[d])
    assert keep is None or ax != 1, (shape, axes)
    kept = shape if keep is None else \
        (shape[0], keep[1] - keep[0]) + tuple(shape[2:])
    sshape = tuple(1 if d in axes else s for d, s in enumerate(kept))
    q8 = torch.empty(kept, dtype=torch.int8, device=device)
    s = torch.empty(sshape, dtype=dt, device=device)
    numel = 1
    for n in shape:
        numel *= n
    for lo, ln in _chunk_spans(shape[ax], numel):
        cshape = tuple(ln if d == ax else n for d, n in enumerate(shape))
        w = torch.randn(cshape, generator=gen, dtype=torch.float32,
                        device=device) * 0.02
        part = _quant(w, axes, dt)
        if keep is not None:
            part = {k: v[:, keep[0]:keep[1]] for k, v in part.items()}
        q8.narrow(ax, lo, ln).copy_(part["q8"])
        s.narrow(ax, lo, ln).copy_(part["s"])
    return {"q8": q8, "s": s}


def _init_plain_leaf(gen, shape, dtype, kind, device):
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    out = torch.empty(shape, dtype=dtype, device=device)
    numel = out.numel()
    for lo, ln in (_chunk_spans(shape[0], numel) if shape else [(0, 0)]):
        dst = out.narrow(0, lo, ln) if shape else out
        dst.copy_(torch.randn(dst.shape, generator=gen, dtype=torch.float32,
                              device=device) * 0.02)
    return out


def init_params_quantized(cfg, generator: Optional[torch.Generator] = None,
                          device=None, experts: Optional[Tuple[int, int]]
                          = None) -> Params:
    """Random-init an already-int8-quantized tree without ever holding
    the float tree: each matmul leaf is drawn in float32 chunks and
    quantized chunk by chunk (peak = the int8 tree + one chunk). Leaf
    roles come from init_params' own structure (`_shape_tree`): matmul
    weights quantize with quantize_int8's axes, norm scales are ones,
    biases zeros, everything else N(0, 0.02) in cfg.param_dtype.
    `generator` must live on `device` (None = CUDA; a seed-0 generator
    when None). Draws differ from jax.random's; keys, shapes and dtypes
    are the JAX tree's. `experts` = [lo, hi) keeps only those experts of
    the MoE expert leaves, as models/common.py:init_params does."""
    from butterfly_tpu_torch.core.device import resolve_device
    dev = resolve_device(device)
    dt = _compute_dtype(cfg)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)

    def walk(node, parent):
        out = {}
        for name, sd in node.items():
            if isinstance(sd, dict):
                out[name] = walk(sd, name)
                continue
            shape = tuple(sd.shape)
            axes = _axes(parent, name)
            if axes is not None and (parent in ("attn", "mlp", "moe")
                                     or name == "lm_head"):
                keep = experts if parent == "moe" else None
                out[name] = _init_quant_leaf(generator, shape, axes, dt, dev,
                                             keep)
            else:
                kind = "ones" if name == "scale" else \
                    "zeros" if name.startswith("b") else "normal"
                out[name] = _init_plain_leaf(generator, shape, sd.dtype,
                                             kind, dev)
        return out
    return walk(_shape_tree(cfg), "")


def quant_specs_like(qparams: Any, specs: Any) -> Any:
    """Mirror a param_specs (sub)tree (parallel/partition.py) onto a
    quantized one: q8 takes the weight's spec; the scale keeps an axis
    only on its dims still > 1 (a contraction dim collapsed to 1 by
    keepdims must not be split)."""
    if is_quantized_leaf(qparams) and not isinstance(specs, dict):
        s_spec = tuple(specs[i] if i < len(specs) and
                       qparams["s"].shape[i] > 1 else None
                       for i in range(len(qparams["s"].shape)))
        return {"q8": specs, "s": s_spec}
    if isinstance(qparams, dict):
        return {k: quant_specs_like(qparams[k], specs[k]) for k in qparams}
    return specs


def shard_quantized_params(qparams: Params, cfg, mesh,
                           copy: bool = False) -> Params:
    """A quantized tree placed over `mesh` (tensor, expert, data, stage):
    the placement of parallel/partition.py:shard_params under the specs
    of `quant_specs_like` (under stage, each stage's [L/S] slice of the
    codes and the scales over its own mesh)."""
    from butterfly_tpu_torch.parallel.partition import shard_params
    return shard_params(qparams, cfg, mesh, copy=copy)
