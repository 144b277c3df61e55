"""Transformer layer math shared by every forward, in PyTorch.

The counterpart of butterfly_tpu/models/common.py: the layer math of the
paged serving forward, plus the contiguous KV cache and the forwards
`generate` runs (prefill through the flash kernels, the single-token
decode step with its deferred cache write, and the write-combined decode
window). Params are the JAX package's nested dict in its exact key names
and stacked [L, ...] layout, holding torch tensors; a forward loops over
layers with `params["layers"][...][i]`, a view.

Where the JAX package rebuilds a cache array with dynamic_update_slice,
the port writes the cache tensors IN PLACE and returns them. The write
start clamps as dynamic_update_slice clamps it (start = min(start, S - T),
`_clamp_start`), so a write that would run past the buffer's end lands
where the JAX package lands it.

Numerics follow the JAX functions: norms and softmax in float32, masked
scores at the finite -1e30, int8 K/V codes that are never dequantized
into a copy (the K scale multiplies the scores, the V scale folds into
the probabilities), and round-half-to-even int8 quantization, so int8
codes come out byte-identical to the JAX package's.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from butterfly_tpu_torch.core.config import ModelConfig
from butterfly_tpu_torch.core.device import resolve_device
from butterfly_tpu_torch.ops.flash_attention import flash_attention

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


class KVCache(NamedTuple):
    """Contiguous KV cache: [num_layers, batch, max_seq, num_kv_heads,
    head_dim]; `length[b]` = tokens already written for sequence b.

    int8 mode (init_cache(quant="int8")): k/v hold int8 codes in
    [L, B, Kv, S, H] order and k_scale/v_scale [L, B, Kv, S] one f32 scale
    per stored vector, the JAX package's layout."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor  # [B] int32
    k_scale: Optional[torch.Tensor] = None  # [L, B, Kv, S] f32 iff int8
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_seq(self) -> int:
        return self.k.shape[3] if self.quantized else self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               quant: str = "none", device=None) -> KVCache:
    """A zeroed cache on `device` (None = CUDA)."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    length = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if quant == "int8":
        qshape = (cfg.num_layers, batch, cfg.num_kv_heads, max_seq,
                  cfg.head_dim)
        return KVCache(
            k=torch.zeros(qshape, dtype=torch.int8, device=dev),
            v=torch.zeros(qshape, dtype=torch.int8, device=dev),
            length=length,
            k_scale=torch.zeros(qshape[:-1], dtype=torch.float32, device=dev),
            v_scale=torch.zeros(qshape[:-1], dtype=torch.float32, device=dev))
    if quant != "none":
        raise ValueError(f"unknown kv quant {quant!r}")
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   length=length)


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
# Contiguous cache writes
# ---------------------------------------------------------------------------

def _clamp_start(start: torch.Tensor, S: int, T: int) -> torch.Tensor:
    """lax.dynamic_update_slice's start for a T-long update of an S-long
    axis: clamped into [0, S - T] so the update fits. [B] long."""
    return start.long().clamp(0, max(S - T, 0))


def _run_index(start: torch.Tensor, S: int, T: int):
    """(rows [B, T], positions [B, T]) of each row's clamped T-long run."""
    B = start.shape[0]
    pos = _clamp_start(start, S, T)[:, None] \
        + torch.arange(T, device=start.device)[None, :]
    rows = torch.arange(B, device=start.device)[:, None].expand(B, T)
    return rows, pos


def update_cache_layer(ck: torch.Tensor, cv: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, start: torch.Tensor):
    """Write k/v [B,T,Kv,H] into one layer's cache [B,S,Kv,H] at per-row
    offsets `start` [B], IN PLACE (clamped like dynamic_update_slice).
    Returns (ck, cv)."""
    rows, pos = _run_index(start, ck.shape[1], k.shape[1])
    ck[rows, pos] = k.to(ck.dtype)
    cv[rows, pos] = v.to(cv.dtype)
    return ck, cv


def update_cache_layer_q(ck, cv, k_s, v_s, k, v, start):
    """int8 twin of update_cache_layer: quantize, then write codes into
    ck/cv [B,Kv,S,H] and scales into k_s/v_s [B,Kv,S], IN PLACE. k/v
    arrive as [B,T,Kv,H]. Returns (ck, cv, k_s, v_s)."""
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    rows, pos = _run_index(start, ck.shape[2], k.shape[1])
    # advanced indices at dims 0 and 2 (a slice between) put the index
    # dims first: the indexed view is [B, T, Kv, H], k's own layout
    ck[rows, :, pos] = kq
    cv[rows, :, pos] = vq
    k_s[rows, :, pos] = ks
    v_s[rows, :, pos] = vs
    return ck, cv, k_s, v_s


# ---------------------------------------------------------------------------
# Contiguous-cache layers and forwards
# ---------------------------------------------------------------------------

def _dequant_mirror(x: torch.Tensor) -> torch.Tensor:
    """x quantized to int8 and back, in x's dtype: the values an int8
    cache hands back for x."""
    xq, xs = quantize_kv(x)
    return (xq.float() * xs[..., None]).to(x.dtype)


def attention_block(x, p: Params, cfg: ModelConfig, ck, cv, positions, mask,
                    cos, sin, fresh: bool = False, k_s=None, v_s=None):
    """One attention sublayer with contiguous-cache update.

    x: [B,T,D]; ck/cv: one layer's cache [B,S,Kv,H] (int8: codes
    [B,Kv,S,H] + scales k_s/v_s [B,Kv,S]), written in place; positions
    [B,T]; mask [B,T,S]. Under cfg.attn_impl == "flash" multi-token calls
    take the flash kernels: `fresh` (positions start at 0, nothing live
    before) attends the just-projected K/V alone; a warm call attends the
    cache as a prefix count-masked at each row's start plus the causal
    chunk (int8 caches mirror the chunk's written representation, so the
    operands equal what the dense path reads back). Otherwise dense
    attend over the written cache.

    Returns (out, ck, cv), (out, ck, cv, k_s, v_s) with an int8 cache, or
    with ck None (fresh only: NO-CACHE mode, nothing written) (out, k, v)
    with the raw projected K/V for the caller to write.
    """
    q, k, v = qkv_proj(x, p, cfg, cos, sin)
    flash = cfg.attn_impl == "flash" and x.shape[1] > 1
    if ck is None:
        if not fresh:
            raise ValueError("no-cache attention_block is fresh-prefill only")
        out = flash_attention(q, k, v, causal=True) if flash \
            else attend(q, k, v, mask, cfg)
        return attn_output(out, p, cfg), k, v
    start = positions[:, 0]
    if k_s is not None:
        ck, cv, k_s, v_s = update_cache_layer_q(ck, cv, k_s, v_s, k, v, start)
    else:
        ck, cv = update_cache_layer(ck, cv, k, v, start)
    if flash and fresh:
        out = flash_attention(q, k, v, causal=True)
    elif flash:
        kf, vf = k, v
        if k_s is not None:
            kf, vf = _dequant_mirror(k), _dequant_mirror(v)
        out = flash_attention(q, kf, vf, causal=True, prefix_k=ck,
                              prefix_v=cv,
                              prefix_len=start.to(torch.int32).contiguous(),
                              prefix_k_scale=k_s, prefix_v_scale=v_s)
    else:
        out = attend(q, ck, cv, mask, cfg, k_s, v_s)
    if k_s is not None:
        return attn_output(out, p, cfg), ck, cv, k_s, v_s
    return attn_output(out, p, cfg), ck, cv


def transformer_layer(x, lp: Params, cfg: ModelConfig, ck, cv, positions,
                      mask, cos, sin, fresh: bool = False, k_s=None,
                      v_s=None):
    """Pre-norm residual block: x + attn(norm(x)); x + ffn(norm(x)).
    Returns (x, *rest) with attention_block's rest."""
    h = pre_norm(x, lp["ln1"], cfg)
    attn_out, *rest = attention_block(h, lp["attn"], cfg, ck, cv, positions,
                                      mask, cos, sin, fresh, k_s, v_s)
    x = x + attn_out
    x = x + ffn_block(pre_norm(x, lp["ln2"], cfg), lp, cfg)
    return (x, *rest)


def _cast_layer(lp: Params, dtype) -> Params:
    return {k: _cast_layer(v, dtype) if isinstance(v, dict)
            else _cast_float(v, dtype) for k, v in lp.items()}


def scan_layers(params: Params, cfg: ModelConfig, x, k, v, positions, mask,
                cos, sin, fresh: bool = False, k_s=None, v_s=None):
    """transformer_layer over every layer (the JAX lax.scan as a Python
    loop), each against its slice of the stacked [L, ...] cache, written
    in place. Returns (x, k, v[, k_s, v_s])."""
    compute = torch_dtype(cfg.dtype)
    quant = k_s is not None
    for i in range(cfg.num_layers):
        lp = _cast_layer(layer_params(params, i), compute)
        x = transformer_layer(x, lp, cfg, k[i], v[i], positions, mask, cos,
                              sin, fresh, k_s[i] if quant else None,
                              v_s[i] if quant else None)[0]
    return (x, k, v, k_s, v_s) if quant else (x, k, v)


def _take_rows(x: torch.Tensor, last_index) -> torch.Tensor:
    """x [B,T,D] -> [B,1,D] at each row's last_index (take_along_axis)."""
    return torch.gather(x, 1, last_index.long()[:, None, None].expand(
        x.shape[0], 1, x.shape[-1]))


def _fresh_prefill_forward(params: Params, cfg: ModelConfig, tokens,
                           cache: KVCache, positions, last_index):
    """Fresh-prefill fast path: attention runs over each layer's freshly
    projected K/V (no-cache attention_block), and the layer's K/V (in the
    cache's representation) lands at positions 0..T-1 of its cache slice.
    Padded rows' K/V land too, at positions no causal query reaches
    before decode overwrites them."""
    B, T = tokens.shape
    quant = cache.quantized
    compute = torch_dtype(cfg.dtype)
    x, cos, sin = embed_tokens(params, cfg, tokens, positions)
    mask = make_mask(positions, T)  # causal over the chunk itself
    for i in range(cfg.num_layers):
        lp = _cast_layer(layer_params(params, i), compute)
        x, k, v = transformer_layer(x, lp, cfg, None, None, positions, mask,
                                    cos, sin, fresh=True)
        if quant:
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            cache.k[i, :, :, :T] = kq.permute(0, 2, 1, 3)
            cache.v[i, :, :, :T] = vq.permute(0, 2, 1, 3)
            cache.k_scale[i, :, :, :T] = ks.permute(0, 2, 1)
            cache.v_scale[i, :, :, :T] = vs.permute(0, 2, 1)
        else:
            cache.k[i, :, :T] = k.to(cache.k.dtype)
            cache.v[i, :, :T] = v.to(cache.v.dtype)
    if last_index is not None:
        x = _take_rows(x, last_index)
    logits = final_logits(params, cfg, x)
    return logits, cache._replace(length=(cache.length + T).to(torch.int32))


def decode_attend(q, k_new, v_new, ck, cv, start, cfg: ModelConfig,
                  k_s=None, v_s=None, wk=None, wv=None, wk_s=None,
                  wv_s=None):
    """One-token attention over (old cache, positions < start) + (the
    window's staged steps) + (the token itself), which equals causal
    attention after writing the token, so the caller writes every layer's
    K/V once after the layer loop (_decode_forward).

    q [B,1,Nq,H]; k_new/v_new [B,1,Kv,H]; ck/cv [B,S,Kv,H] (int8: codes
    [B,Kv,S,H] + scales k_s/v_s [B,Kv,S]); start [B] flushed length. The
    window wk/wv [W,B,Kv,H] (+ scales [W,B,Kv]) holds the previous
    unflushed steps in the cache's representation, every entry live, at
    positions start..start+W-1. Scores in f32, softmax in f32."""
    B, _, Nq, H = q.shape
    quant = k_s is not None
    S = ck.shape[2] if quant else ck.shape[1]
    Kv = k_new.shape[2]
    G = Nq // Kv
    compute = q.dtype
    qg = q.reshape(B, Kv, G, H)
    qf = qg.float()
    scale = 1.0 / torch.sqrt(torch.tensor(H, dtype=torch.float32))
    k_eq = "bksh" if quant else "bskh"
    s_c = torch.einsum(f"bkgh,{k_eq}->bkgs", qf,
                       _cast_float(ck, compute).float())
    if quant:
        s_c = s_c * k_s[:, :, None, :]
    s_c = s_c * scale
    older = torch.arange(S, device=q.device)[None, :] < start[:, None]
    s_c = torch.where(older[:, None, None, :], s_c,
                      torch.full_like(s_c, -1e30))
    parts = [s_c]
    if wk is not None:
        s_w = torch.einsum("bkgh,cbkh->bkgc", qf,
                           _cast_float(wk, compute).float())
        if quant:
            s_w = s_w * wk_s.permute(1, 2, 0)[:, :, None, :]
        parts.append(s_w * scale)
    s_self = (qf * k_new.reshape(B, Kv, 1, H).float()).sum(
        dim=-1, keepdim=True) * scale
    parts.append(s_self)
    p = torch.softmax(torch.cat(parts, dim=-1), dim=-1)
    p_c = p[..., :S]
    if quant:
        p_c = p_c * v_s[:, :, None, :]
    out = torch.einsum(f"bkgs,{k_eq}->bkgh", p_c.to(compute),
                       cv.to(compute))
    if wk is not None:
        p_w = p[..., S:-1]
        if quant:
            p_w = p_w * wv_s.permute(1, 2, 0)[:, :, None, :]
        out = out + torch.einsum("bkgc,cbkh->bkgh", p_w.to(compute),
                                 wv.to(compute))
    out = out + p[..., -1:].to(v_new.dtype) * v_new.reshape(B, Kv, 1, H)
    return out.reshape(B, 1, Nq, H)


def _decode_layer_body(x, lp: Params, cfg: ModelConfig, cache: KVCache, i,
                       cos, sin, start, wk_i=None, wv_i=None, wks_i=None,
                       wvs_i=None):
    """One decode layer against layer i's slice of the cache (+ this
    layer's window entries). Returns (x, k_new, v_new), k/v [B,1,Kv,H]."""
    lp = _cast_layer(lp, torch_dtype(cfg.dtype))
    k_s = v_s = None
    if cache.quantized:
        k_s, v_s = cache.k_scale[i], cache.v_scale[i]
    h = pre_norm(x, lp["ln1"], cfg)
    q, k, v = qkv_proj(h, lp["attn"], cfg, cos, sin)
    out = decode_attend(q, k, v, cache.k[i], cache.v[i], start, cfg, k_s,
                        v_s, wk_i, wv_i, wks_i, wvs_i)
    x = x + attn_output(out, lp["attn"], cfg)
    x = x + ffn_block(pre_norm(x, lp["ln2"], cfg), lp, cfg)
    return x, k, v


def _decode_forward(params: Params, cfg: ModelConfig, tokens,
                    cache: KVCache, positions):
    """Single-token decode step with ONE cache write for all layers after
    the layer loop (the cache is read-only inside it). Every row's length
    advances by 1. Returns (logits [B,1,V], cache)."""
    B = tokens.shape[0]
    x, cos, sin = embed_tokens(params, cfg, tokens, positions)
    start = positions[:, 0]
    quant = cache.quantized
    new = []
    for i in range(cfg.num_layers):
        x, k, v = _decode_layer_body(x, layer_params(params, i), cfg, cache,
                                     i, cos, sin, start)
        if quant:
            kq, ksc = quantize_kv(k[:, 0])
            vq, vsc = quantize_kv(v[:, 0])
            new.append((kq, vq, ksc, vsc))
        else:
            new.append((k[:, 0].to(cache.k.dtype), v[:, 0].to(cache.v.dtype)))
    logits = final_logits(params, cfg, x)
    stacked = [torch.stack(c) for c in zip(*new)]  # [L, B, Kv(, H)]
    rows, pos = _run_index(start, cache.max_seq, 1)
    rows, pos = rows[:, 0], pos[:, 0]
    if quant:
        # advanced dims 1 and 3 (a slice between) go first: [B, L, Kv, H]
        cache.k[:, rows, :, pos] = stacked[0].transpose(0, 1)
        cache.v[:, rows, :, pos] = stacked[1].transpose(0, 1)
        cache.k_scale[:, rows, :, pos] = stacked[2].transpose(0, 1)
        cache.v_scale[:, rows, :, pos] = stacked[3].transpose(0, 1)
    else:
        cache.k[:, rows, pos] = stacked[0]
        cache.v[:, rows, pos] = stacked[1]
    return logits, cache._replace(length=(cache.length + 1).to(torch.int32))


def decode_step_win(params: Params, cfg: ModelConfig, tokens,
                    cache: KVCache, prev: list, wstep: int):
    """One decode step against (cache + prior window steps + self), no
    cache write. tokens [B,1] sit at position cache.length + wstep; `prev`
    holds this flush group's steps 0..wstep-1 as returned by this
    function. Returns (logits, new_kv): this token's per-layer K/V
    stacked [L,B,Kv,H] — float (k, v) or int8 (kq, vq, k_scale [L,B,Kv],
    v_scale) in the cache's representation."""
    quant = cache.quantized
    positions = (cache.length + wstep)[:, None]
    x, cos, sin = embed_tokens(params, cfg, tokens, positions)
    start = cache.length
    win = tuple(torch.stack(c, dim=1) for c in zip(*prev)) if prev else ()
    new = []
    for i in range(cfg.num_layers):
        w = [t[i] for t in win]   # [W,B,Kv,H] (+ [W,B,Kv] scales)
        x, k, v = _decode_layer_body(
            x, layer_params(params, i), cfg, cache, i, cos, sin, start,
            *(w + [None] * (4 - len(w))))
        if quant:
            kq, ksc = quantize_kv(k[:, 0])
            vq, vsc = quantize_kv(v[:, 0])
            new.append((kq, vq, ksc, vsc))
        else:
            new.append((k[:, 0].to(cache.k.dtype), v[:, 0].to(cache.v.dtype)))
    return final_logits(params, cfg, x), \
        tuple(torch.stack(c) for c in zip(*new))


def flush_window(cache: KVCache, steps: list,
                 uniform: bool = False) -> KVCache:
    """Write a whole flush group (C = len(steps) tokens per row, each a
    decode_step_win new_kv) into the cache at each row's flushed length,
    IN PLACE, in one write per cache tensor; lengths advance by C.

    `uniform` asserts every row's flushed length is equal: the write then
    starts at row 0's length for every row (the JAX package's one
    scalar-offset update), still read on the device."""
    start = cache.length
    C = len(steps)
    S = cache.max_seq
    B = start.shape[0]
    if uniform:
        start = start[:1].expand(B)
    rows, pos = _run_index(start, S, C)       # [B, C]
    if cache.quantized:
        kq = torch.stack([s[0] for s in steps], dim=3)   # [L,B,Kv,C,H]
        vq = torch.stack([s[1] for s in steps], dim=3)
        ksc = torch.stack([s[2] for s in steps], dim=3)  # [L,B,Kv,C]
        vsc = torch.stack([s[3] for s in steps], dim=3)
        # advanced dims 1 and 3 (a slice between) go first: [B,C,L,Kv(,H)]
        cache.k[:, rows, :, pos] = kq.permute(1, 3, 0, 2, 4)
        cache.v[:, rows, :, pos] = vq.permute(1, 3, 0, 2, 4)
        cache.k_scale[:, rows, :, pos] = ksc.permute(1, 3, 0, 2)
        cache.v_scale[:, rows, :, pos] = vsc.permute(1, 3, 0, 2)
    else:
        ks = torch.stack([s[0] for s in steps], dim=2)   # [L,B,C,Kv,H]
        vs = torch.stack([s[1] for s in steps], dim=2)
        cache.k[:, rows, pos] = ks
        cache.v[:, rows, pos] = vs
    return cache._replace(length=(cache.length + C).to(torch.int32))


def forward(params: Params, cfg: ModelConfig, tokens, cache: KVCache,
            positions=None, fresh: bool = False, last_index=None):
    """Run the model over `tokens` [B,T], reading and writing `cache`.

    positions defaults to cache.length[:,None] + arange(T) (append).
    `fresh`: nothing live precedes these tokens and positions start at 0
    (recycled buffers may hold stale bytes: masking, not zeroing, keeps
    them out); only then may the fresh flash kernel run. Single-token
    warm calls take the decode fast path (_decode_forward). last_index
    [B] runs the LM head on that row only ([B,1,V]). Returns (logits
    [B,T,V] float32, cache with length + T)."""
    B, T = tokens.shape
    if positions is None:
        positions = cache.length.long()[:, None] \
            + torch.arange(T, device=tokens.device)[None, :]
    if T == 1 and not fresh:
        return _decode_forward(params, cfg, tokens, cache, positions)
    if fresh and T > 1:
        return _fresh_prefill_forward(params, cfg, tokens, cache, positions,
                                      last_index)
    x, cos, sin = embed_tokens(params, cfg, tokens, positions)
    mask = make_mask(positions, cache.max_seq)
    x = scan_layers(params, cfg, x, cache.k, cache.v, positions, mask, cos,
                    sin, fresh, cache.k_scale, cache.v_scale)[0]
    if last_index is not None:
        x = _take_rows(x, last_index)
    logits = final_logits(params, cfg, x)
    return logits, cache._replace(length=(cache.length + T).to(torch.int32))


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
    layout) that the serving engine holds; `init` fills one. Calling the
    handle runs the module-level `forward`, as the JAX handle's
    `__call__` does."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, generator: Optional[torch.Generator] = None) -> Params:
        return init_params(self.cfg, generator, self.device)

    def init_cache(self, batch: int, max_seq: int, dtype=None) -> KVCache:
        return init_cache(self.cfg, batch, max_seq, dtype,
                          device=self.device)

    def forward(self, params: Params, tokens, cache: KVCache,
                positions=None):
        return forward(params, self.cfg, tokens, cache, positions)
