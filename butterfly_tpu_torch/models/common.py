"""Transformer layer math shared by the paged serving path, in PyTorch.

The counterpart of butterfly_tpu/models/common.py, restricted to what the
paged serving forward runs. Params are the JAX package's nested dict in
its exact key names and stacked [L, ...] layout, holding torch tensors;
a forward loops over layers with `params["layers"][...][i]`, a view.

Numerics follow the JAX functions: norms and softmax in float32, masked
scores at the finite -1e30, int8 K/V codes that are never dequantized
into a copy (the K scale multiplies the scores, the V scale folds into
the probabilities), and round-half-to-even int8 quantization, so int8
codes come out byte-identical to the JAX package's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from butterfly_tpu_torch.core.config import ModelConfig
from butterfly_tpu_torch.core.device import resolve_device

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """A config dtype string ("bfloat16", ...) as a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}: expected one of "
                         f"{sorted(_DTYPES)}") from None


def _cast_float(a: torch.Tensor, dtype) -> torch.Tensor:
    """Cast to the compute dtype, leaving integer (e.g. int8) leaves alone."""
    return a.to(dtype) if a.is_floating_point() else a


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector int8 quantization over the last (head_dim) axis.

    x [..., H] float -> (codes [..., H] int8, scale [...] f32) with
    x ~= codes * scale. Zero vectors get scale 1 (codes all 0).
    torch.round rounds half to even, as jnp.round does.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.round(xf / scale[..., None])
    return codes.clamp(-127, 127).to(torch.int8), scale


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """GPT-2's tanh-approximated GELU."""
    c = torch.tensor((2.0 / torch.pi) ** 0.5, dtype=x.dtype, device=x.device)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


ACTIVATIONS = {
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_new": gelu_new,
    "relu": F.relu,
}


def rope_freqs(cfg: ModelConfig, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for positions [..., T] -> [..., T, head_dim/2], f32."""
    half = cfg.head_dim // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (cfg.rope_theta ** (ar / half))
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half convention (matches HF Llama).

    x: [B, T, N, H]; cos/sin: [B, T, half] (or [T, half]).
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[..., None, :].to(x.dtype)  # broadcast over heads
    sin = sin[..., None, :].to(x.dtype)
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.cat([r1, r2], dim=-1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor, cfg: ModelConfig,
           k_scale: Optional[torch.Tensor] = None,
           v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped-query attention over the (cached) key/value sequence.

    q: [B, T, Nq, H]; k/v: [B, S, Kv, H]; mask: [B, T, S] bool (True =
    attend). Returns [B, T, Nq, H] in q's dtype. Scores accumulate in
    f32 (the JAX einsum's preferred_element_type), softmax in f32.

    int8 cache: k/v are codes in [B, Kv, S, H] order and k_scale/v_scale
    [B, Kv, S] their per-vector scales; the K scale applies to the
    scores, the V scale folds into the probs.
    """
    B, T, Nq, H = q.shape
    quant = k_scale is not None
    Kv = k.shape[1] if quant else k.shape[2]
    G = Nq // Kv
    compute = q.dtype
    qf = q.reshape(B, T, Kv, G, H).float()
    k_eq = "bksh" if quant else "bskh"
    scores = torch.einsum(f"btkgh,{k_eq}->bktgs", qf,
                          k.to(compute).float())
    if quant:
        scores = scores * k_scale[:, :, None, None, :]
    scores = scores * (1.0 / torch.sqrt(torch.tensor(H, dtype=torch.float32)))
    scores = torch.where(mask[:, None, :, None, :], scores,
                         torch.tensor(-1e30, dtype=torch.float32,
                                      device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    if quant:
        probs = probs * v_scale[:, :, None, None, :]
    out = torch.einsum(f"bktgs,{k_eq}->btkgh", probs.to(compute),
                       v.to(compute))
    return out.reshape(B, T, Nq, H)


# ---------------------------------------------------------------------------
# Layer bodies
# ---------------------------------------------------------------------------

def _proj(spec: str, x: torch.Tensor, w, dtype) -> torch.Tensor:
    """einsum(spec, x, W) with W cast to the compute dtype (the JAX
    qeinsum for float weights; int8 weight trees are refused upstream)."""
    if isinstance(w, dict):
        raise NotImplementedError(
            "int8 weight trees are not ported yet (ROADMAP.md, PyTorch/CUDA "
            "port queue: int8 weights)")
    if w.dtype != dtype:
        w = w.to(dtype)
    return torch.einsum(spec, x, w)


def qkv_proj(x: torch.Tensor, p: Params, cfg: ModelConfig,
             cos: torch.Tensor, sin: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """QKV projections (+bias, +rope). x: [B,T,D] -> q [B,T,Nq,H],
    k/v [B,T,Kv,H]."""
    dt = x.dtype
    q = _proj("btd,dnh->btnh", x, p["wq"], dt)
    k = _proj("btd,dkh->btkh", x, p["wk"], dt)
    v = _proj("btd,dkh->btkh", x, p["wv"], dt)
    if cfg.use_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def attn_output(out: torch.Tensor, p: Params, cfg: ModelConfig
                ) -> torch.Tensor:
    """Output projection of the attention sublayer. out: [B,T,Nq,H]."""
    out = _proj("btnh,nhd->btd", out, p["wo"], out.dtype)
    if cfg.use_bias:
        out = out + p["bo"]
    return out


def mlp_block(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    act = ACTIVATIONS[cfg.act]
    dt = x.dtype
    if cfg.arch == "gpt2":
        h = _proj("btd,df->btf", x, p["w_up"], dt)
        h = act(h + p["b_up"])
        out = _proj("btf,fd->btd", h, p["w_down"], dt)
        return out + p["b_down"]
    # llama-style gated SwiGLU
    g = _proj("btd,df->btf", x, p["w_gate"], dt)
    u = _proj("btd,df->btf", x, p["w_up"], dt)
    return _proj("btf,fd->btd", act(g) * u, p["w_down"], dt)


def pre_norm(x: torch.Tensor, norm_p: Params, cfg: ModelConfig
             ) -> torch.Tensor:
    """The arch's norm (LayerNorm for gpt2, RMSNorm otherwise)."""
    if cfg.arch == "gpt2":
        return layer_norm(x, norm_p["scale"], norm_p["bias"], cfg.norm_eps)
    return rms_norm(x, norm_p["scale"], cfg.norm_eps)


def ffn_block(h: torch.Tensor, lp: Params, cfg: ModelConfig) -> torch.Tensor:
    """Dense MLP. MoE configs are not ported yet."""
    if cfg.is_moe:
        raise NotImplementedError(
            "MoE FFN is not ported yet (ROADMAP.md, PyTorch/CUDA port "
            "queue: Mixtral / expert parallelism)")
    return mlp_block(h, lp["mlp"], cfg)


# ---------------------------------------------------------------------------
# Forward helpers
# ---------------------------------------------------------------------------

def make_mask(positions: torch.Tensor, S: int) -> torch.Tensor:
    """Causal mask over the cache: [B,T,S], True where query may attend."""
    j = torch.arange(S, device=positions.device)[None, None, :]
    return j <= positions[:, :, None]


def embed_tokens(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token (+pos) embedding. Returns (x [B,T,D], cos, sin)."""
    B, T = tokens.shape
    compute = torch_dtype(cfg.dtype)
    x = params["embed"]["tok"].to(compute)[tokens]
    if cfg.pos_embedding == "learned":
        x = x + params["embed"]["pos"].to(compute)[positions]
        cos = sin = torch.zeros((B, T, cfg.head_dim // 2),
                                dtype=torch.float32, device=tokens.device)
    else:
        cos, sin = rope_freqs(cfg, positions)
    return x, cos, sin


def final_logits(params: Params, cfg: ModelConfig,
                 x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head. Returns logits [B,T,V] float32."""
    compute = torch_dtype(cfg.dtype)
    if cfg.arch == "gpt2":
        x = layer_norm(x, params["final_norm"]["scale"],
                       params["final_norm"]["bias"], cfg.norm_eps)
    else:
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("btd,vd->btv", x,
                              params["embed"]["tok"].to(compute))
    else:
        logits = _proj("btd,dv->btv", x, params["lm_head"], compute)
    return logits.float()


def layer_params(params: Params, i: int) -> Params:
    """Layer i's slice of the stacked [L, ...] leaves (views, no copy)."""
    def take(node):
        if isinstance(node, dict):
            return {k: take(v) for k, v in node.items()}
        return node[i]
    return take(params["layers"])


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """Random init (normal, 0.02 std) in cfg.param_dtype, on `device`.

    Each stacked [L, ...] leaf is allocated once in the parameter dtype
    and filled layer by layer from float32 draws, so a large model never
    holds a float32 copy of the whole tree. `generator` must live on
    `device` (a seed-0 one is made when it is None). Draws differ from
    jax.random's; the JAX tree crosses over through models/bridge.py.
    """
    dev = resolve_device(device)
    pdt = torch_dtype(cfg.param_dtype)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    L, D, Nq, Kv, H, F_, V = (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                              cfg.num_kv_heads, cfg.head_dim,
                              cfg.intermediate_size, cfg.vocab_size)

    def draw(shape, std=0.02):
        out = torch.empty(shape, dtype=pdt, device=dev)
        f32 = torch.float32
        if len(shape) > 1 and shape[0] == L:
            for i in range(L):
                out[i].copy_(torch.randn(shape[1:], generator=generator,
                                         dtype=f32, device=dev) * std)
        else:
            out.copy_(torch.randn(shape, generator=generator, dtype=f32,
                                  device=dev) * std)
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=pdt, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=pdt, device=dev)

    layers: Params = {
        "ln1": {"scale": ones(L, D)},
        "ln2": {"scale": ones(L, D)},
        "attn": {
            "wq": draw((L, D, Nq, H)),
            "wk": draw((L, D, Kv, H)),
            "wv": draw((L, D, Kv, H)),
            "wo": draw((L, Nq, H, D)),
        },
    }
    if cfg.use_bias:
        layers["ln1"]["bias"] = zeros(L, D)
        layers["ln2"]["bias"] = zeros(L, D)
        layers["attn"].update(bq=zeros(L, Nq, H), bk=zeros(L, Kv, H),
                              bv=zeros(L, Kv, H), bo=zeros(L, D))
    if cfg.is_moe:
        raise NotImplementedError(
            "MoE params are not ported yet (ROADMAP.md, PyTorch/CUDA port "
            "queue: Mixtral / expert parallelism)")
    if cfg.arch == "gpt2":
        layers["mlp"] = {"w_up": draw((L, D, F_)), "b_up": zeros(L, F_),
                         "w_down": draw((L, F_, D)), "b_down": zeros(L, D)}
    else:
        layers["mlp"] = {"w_gate": draw((L, D, F_)),
                         "w_up": draw((L, D, F_)),
                         "w_down": draw((L, F_, D))}
    params: Params = {
        "embed": {"tok": draw((V, D))},
        "layers": layers,
        "final_norm": {"scale": ones(D)},
    }
    if cfg.pos_embedding == "learned":
        params["embed"]["pos"] = draw((cfg.max_seq_len, D))
    if cfg.arch == "gpt2":
        params["final_norm"]["bias"] = zeros(D)
    if not cfg.tie_embeddings:
        params["lm_head"] = draw((D, V))
    return params


class Model(torch.nn.Module):
    """Handle bundling a config with the device it runs on.

    The weights stay a plain dict of tensors (the JAX tree's keys and
    layout) that the serving engine holds; `init` fills one."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, generator: Optional[torch.Generator] = None) -> Params:
        return init_params(self.cfg, generator, self.device)
