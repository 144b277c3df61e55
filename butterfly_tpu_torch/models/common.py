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
codes come out byte-identical to the JAX package's. Every matmul weight
goes through quant/int8.py:qeinsum, so int8 weight trees ({"q8", "s"}
leaves) run the same layer math as float ones.

Under a tensor mesh (parallel/partition.py:shard_params) the split
leaves are Shards and the same functions run per tensor shard
(parallel/tensor.py): q/k/v and the MLP's gate/up stay split over the
heads and F from the column-parallel matmuls to the row-parallel wo and
w_down, whose partials are summed by `all_reduce` (then bo / b_down,
once); attention runs per shard on its heads and its own cache
(`over_heads`, the sharded flash wrapper); the embedding looks up each
shard's vocab range and sums, the logits concatenate the vocab shards.
Under a data mesh `forward`, `decode_step_win` and `flush_window` run
each data group's batch rows against its part of the cache and
concatenate the results.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from butterfly_tpu_torch.core.config import ModelConfig
from butterfly_tpu_torch.core.device import resolve_device
from butterfly_tpu_torch.core.mesh import (data_degree, stage_degree,
                                           tensor_degree)
from butterfly_tpu_torch.ops.flash_attention import flash_attention_sharded
from butterfly_tpu_torch.parallel.partition import (
    Shards, expert_parts, held_experts, held_tensor_shards, layers_per_stage,
    local_stages, part_device, shard_count, stack_stages)
from butterfly_tpu_torch.parallel.tensor import (
    all_gather_cat, cat_groups, data_groups, embed_lookup, gather,
    group_part, group_rows, over_heads, run_groups, sharded_einsum, tmap)

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
               quant: str = "none", device=None, mesh=None,
               split_batch: bool = True) -> KVCache:
    """A zeroed cache on `device` (None = CUDA), or, under a tensor or
    data `mesh`, placed as parallel/partition.py:shard_cache places it
    (kv heads over `tensor`, batch over `data` unless `split_batch` is
    False), allocated per shard. Under a stage mesh each stage holds its
    [L/S, ...] layers over its own mesh (a Shards over "stage")."""
    if stage_degree(mesh) > 1:
        Ls = layers_per_stage(cfg, mesh)
        mine = local_stages(mesh)     # a process allocates its own stages
        per = [init_cache(cfg.replace(num_layers=Ls), batch, max_seq, dtype,
                          quant, sub.first_device, sub, split_batch)
               for sub in map(mesh.stage_mesh, mine)]

        def stack(items):
            return stack_stages(items, mine[0], stage_degree(mesh))
        return KVCache(*(stack([c[j] for c in per]) for j in (0, 1)),
                       length=torch.zeros((batch,), dtype=torch.int32,
                                          device=mesh.first_device),
                       k_scale=stack([c.k_scale for c in per]),
                       v_scale=stack([c.v_scale for c in per]))
    if tensor_degree(mesh) > 1 or data_degree(mesh) > 1:
        return _init_cache_sharded(cfg, batch, max_seq, dtype, quant, mesh,
                                   split_batch)
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


def _init_cache_sharded(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                        quant: str, mesh, split_batch: bool) -> KVCache:
    T = tensor_degree(mesh)
    T = T if cfg.num_kv_heads % T == 0 else 1
    D = data_degree(mesh) if split_batch else 1
    D = D if batch % D == 0 else 1
    shard_cfg = cfg.replace(num_kv_heads=cfg.num_kv_heads // T)
    kv_dim = 2 if quant == "int8" else 3
    groups, firsts = [], []
    for d in range(D):
        devs, lo = held_tensor_shards(mesh, d, T)
        firsts.append(lo)
        groups.append([init_cache(shard_cfg, batch // D, max_seq, dtype,
                                  quant, dev) for dev in devs])

    def leaf(name):
        per = [[getattr(c, name) for c in g] for g in groups]
        if per[0][0] is None:
            return None
        per = [Shards(p, "tensor", kv_dim, lo, T) if T > 1 else p[0]
               for p, lo in zip(per, firsts)]
        return Shards(per, "data", 1) if D > 1 else per[0]
    length = torch.zeros((batch,), dtype=torch.int32,
                         device=mesh.first_device)
    return KVCache(k=leaf("k"), v=leaf("v"), length=length,
                   k_scale=leaf("k_scale"), v_scale=leaf("v_scale"))


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
    """einsum(spec, x, W) in the compute dtype: the JAX qeinsum, int8
    ({"q8", "s"}) weights included (quant/int8.py); a W split over the
    tensor axis runs column- or row-parallel (parallel/tensor.py)."""
    return sharded_einsum(spec, x, w, dtype)


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
        q = tmap(torch.add, q, p["bq"])
        k = tmap(torch.add, k, p["bk"])
        v = tmap(torch.add, v, p["bv"])
    if cfg.pos_embedding == "rope":
        q = tmap(apply_rope, q, cos, sin)
        k = tmap(apply_rope, k, cos, sin)
    return q, k, v


def attn_output(out: torch.Tensor, p: Params, cfg: ModelConfig
                ) -> torch.Tensor:
    """Output projection of the attention sublayer. out: [B,T,Nq,H]
    (split over the heads under a tensor mesh: row-parallel, summed
    before the bias)."""
    out = _proj("btnh,nhd->btd", out, p["wo"], out.dtype)
    if cfg.use_bias:
        out = out + p["bo"]
    return out


def mlp_block(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    act = ACTIVATIONS[cfg.act]
    dt = x.dtype
    if cfg.arch == "gpt2":
        h = _proj("btd,df->btf", x, p["w_up"], dt)
        h = tmap(lambda a, b: act(a + b), h, p["b_up"])
        out = _proj("btf,fd->btd", h, p["w_down"], dt)
        return out + p["b_down"]
    # llama-style gated SwiGLU
    g = _proj("btd,df->btf", x, p["w_gate"], dt)
    u = _proj("btd,df->btf", x, p["w_up"], dt)
    return _proj("btf,fd->btd", tmap(lambda a, b: act(a) * b, g, u),
                 p["w_down"], dt)


def pre_norm(x: torch.Tensor, norm_p: Params, cfg: ModelConfig
             ) -> torch.Tensor:
    """The arch's norm (LayerNorm for gpt2, RMSNorm otherwise)."""
    if cfg.arch == "gpt2":
        return layer_norm(x, norm_p["scale"], norm_p["bias"], cfg.norm_eps)
    return rms_norm(x, norm_p["scale"], cfg.norm_eps)


def route_tokens(x: torch.Tensor, router_w: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE routing: f32 logits -> (gates [.., k] f32, expert idx
    [.., k] int64).

    The router product runs in the operands' common dtype (as the JAX
    einsum promotes) and is then cast to f32; the softmax is over the
    SELECTED k (Mixtral convention). Ties keep the lower expert first, as
    lax.top_k does (a stable descending sort). The single definition
    shared by the dense block and both expert-parallel dispatch paths."""
    dt = torch.promote_types(x.dtype, router_w.dtype)
    logits = torch.einsum("btd,de->bte", x.to(dt), router_w.to(dt)).float()
    gates, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(gates[..., :k], dim=-1), idx[..., :k]


def expert_swiglu(x: torch.Tensor, p: Params, cfg: ModelConfig,
                  spec_in: str, spec_out: str, dtype=None) -> torch.Tensor:
    """Every expert's SwiGLU, `spec_in` for gate/up and `spec_out` for
    down, x and both outputs expert-major (expert axis first). Experts
    split over expert shards (parallel/partition.py:Shards) run where
    each shard's weights live, their rows of x moved there and the
    output moved back to x's device, then concatenated in expert order;
    a plain leaf is one shard. F split over the tensor axis runs the gate/up
    column-parallel and the down projection row-parallel. On a mesh
    whose expert axis crosses processes each process runs its own
    shards' experts on their rows of x, and the outputs are all-gathered
    in expert order (parallel/tensor.py:all_gather_cat): every process
    then holds the whole [E, ...] output, bit for bit the one-process
    run's."""
    act = ACTIVATIONS[cfg.act]
    n = shard_count(p)
    first, held = held_experts(p)
    lo = first * (x.shape[0] // n)
    ys = []
    for wg, wu, wd in zip(*(expert_parts(p[k], n)
                            for k in ("w_gate", "w_up", "w_down"))):
        ne = (wg["q8"] if isinstance(wg, dict) else wg).shape[0]
        xs, lo = x[lo:lo + ne], lo + ne
        xs = xs.to(part_device(wg), non_blocking=True)
        g = sharded_einsum(spec_in, xs, wg, dtype)
        u = sharded_einsum(spec_in, xs, wu, dtype)
        h = tmap(lambda a, b: act(a) * b, g, u)
        ys.append(sharded_einsum(spec_out, h, wd, dtype)
                  .to(x.device, non_blocking=True))
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=0)
    if held < n:
        y = all_gather_cat(y, 0)
    return y


def moe_block(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    """Dense-compute MoE: every expert sees every token, masked by the
    router's combine weights. The expert-parallel dispatch lives in
    parallel/expert.py; this dense form is the single-device reference.

    The JAX product `btd,edf->ebtf` runs as `ebtd,edf->ebtf` over x
    broadcast along the experts: the same sums, with the expert axis a
    batch axis of both operands. Given `btd,edf`, torch.einsum would
    permute the [E, D, F] weight into one [D, E*F] matrix, a copy of
    every expert's gate and up weights at each call."""
    E = cfg.num_experts
    weights, idx = route_tokens(x, p["router"], cfg.num_experts_per_tok)
    onehot = F.one_hot(idx, E).float()                        # [B,T,k,E]
    comb = torch.einsum("btk,btke->bte", weights, onehot)      # [B,T,E]
    xe = x.unsqueeze(0).expand(E, *x.shape)                    # [E,B,T,D]
    y = expert_swiglu(xe, p, cfg, "ebtd,edf->ebtf", "ebtf,efd->ebtd",
                      x.dtype)
    return torch.einsum("ebtd,bte->btd", y, comb.to(y.dtype))


def ffn_block(h: torch.Tensor, lp: Params, cfg: ModelConfig) -> torch.Tensor:
    """FFN dispatch shared by every forward variant (contiguous, paged,
    window, spec verify, sequence-parallel): dense MLP, dense MoE, or
    expert-parallel MoE per cfg."""
    if cfg.is_moe:
        if cfg.moe_impl == "ep":
            from butterfly_tpu_torch.parallel.expert import moe_block_ep
            return moe_block_ep(h, lp["moe"], cfg)
        return moe_block(h, lp["moe"], cfg)
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
    x = embed_lookup(params["embed"]["tok"], tokens, compute)
    if cfg.pos_embedding == "learned":
        x = x + params["embed"]["pos"].to(compute)[positions]
        cos = sin = torch.zeros((B, T, cfg.head_dim // 2),
                                dtype=torch.float32, device=tokens.device)
    else:
        cos, sin = rope_freqs(cfg, positions)
    return x, cos, sin


def final_logits(params: Params, cfg: ModelConfig,
                 x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head. Returns logits [B,T,V] float32 (a head split
    over the vocab gives each shard's columns, concatenated)."""
    compute = torch_dtype(cfg.dtype)
    if cfg.arch == "gpt2":
        x = layer_norm(x, params["final_norm"]["scale"],
                       params["final_norm"]["bias"], cfg.norm_eps)
    else:
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = tmap(lambda w, h: torch.einsum("btd,vd->btv", h,
                                                w.to(compute)),
                      params["embed"]["tok"], x, out_split=2)
    else:
        logits = _proj("btd,dv->btv", x, params["lm_head"], compute)
    return gather(logits, -1).float()


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


def _set(dst, idx: tuple, val) -> None:
    """dst[idx] = val, IN PLACE, per tensor shard when dst is split (the
    index tensors read on each part's device)."""
    def put(d, v):
        d[tuple(i.to(d.device, non_blocking=True)
                if isinstance(i, torch.Tensor) else i for i in idx)] = v
    tmap(put, dst, val)


def _stack(items: list, dim: int = 0):
    """torch.stack per tensor shard (a list of Shards stacks part-wise)."""
    if isinstance(items[0], Shards):
        return tmap(lambda *xs: torch.stack(xs, dim=dim), *items,
                    out_split=items[0].split + (items[0].split >= dim))
    return torch.stack(items, dim=dim)


def _new_kv(k, v, quant: bool, dtype):
    """One token's K/V [B, Kv, H] in the cache's representation: float
    (k, v) or int8 (kq, vq, k_scale, v_scale); per shard when split."""
    if quant:
        kq, ksc = tmap(quantize_kv, k)
        vq, vsc = tmap(quantize_kv, v)
        return kq, vq, ksc, vsc
    return tmap(lambda a: a.to(dtype), k), tmap(lambda a: a.to(dtype), v)


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
        out = flash_attention_sharded(q, k, v, causal=True) if flash \
            else over_heads(attend, q, k, v, mask, cfg)
        return attn_output(out, p, cfg), k, v
    start = positions[:, 0]
    if k_s is not None:
        ck, cv, k_s, v_s = tmap(update_cache_layer_q, ck, cv, k_s, v_s, k, v,
                                start)
    else:
        ck, cv = tmap(update_cache_layer, ck, cv, k, v, start)
    if flash and fresh:
        out = flash_attention_sharded(q, k, v, causal=True)
    elif flash:
        kf, vf = k, v
        if k_s is not None:
            kf, vf = tmap(_dequant_mirror, k), tmap(_dequant_mirror, v)
        out = flash_attention_sharded(
            q, kf, vf, causal=True, prefix_k=ck, prefix_v=cv,
            prefix_len=start.to(torch.int32).contiguous(),
            prefix_k_scale=k_s, prefix_v_scale=v_s)
    else:
        out = over_heads(attend, q, ck, cv, mask, cfg, k_s, v_s)
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
            kq, ks = tmap(quantize_kv, k)
            vq, vs = tmap(quantize_kv, v)
            cols = (i, slice(None), slice(None), slice(0, T))
            _set(cache.k, cols, tmap(lambda a: a.permute(0, 2, 1, 3), kq))
            _set(cache.v, cols, tmap(lambda a: a.permute(0, 2, 1, 3), vq))
            _set(cache.k_scale, cols, tmap(lambda a: a.permute(0, 2, 1), ks))
            _set(cache.v_scale, cols, tmap(lambda a: a.permute(0, 2, 1), vs))
        else:
            rows = (i, slice(None), slice(0, T))
            _set(cache.k, rows, tmap(lambda a: a.to(cache.k.dtype), k))
            _set(cache.v, rows, tmap(lambda a: a.to(cache.v.dtype), v))
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
    out = over_heads(decode_attend, q, k, v, cache.k[i], cache.v[i], start,
                     cfg, k_s, v_s, wk_i, wv_i, wks_i, wvs_i)
    x = x + attn_output(out, lp["attn"], cfg)
    x = x + ffn_block(pre_norm(x, lp["ln2"], cfg), lp, cfg)
    return x, k, v


def _decode_forward(params: Params, cfg: ModelConfig, tokens,
                    cache: KVCache, positions):
    """Single-token decode step with ONE cache write for all layers after
    the layer loop (the cache is read-only inside it). Every row's length
    advances by 1. Returns (logits [B,1,V], cache)."""
    x, cos, sin = embed_tokens(params, cfg, tokens, positions)
    start = positions[:, 0]
    quant = cache.quantized
    new = []
    for i in range(cfg.num_layers):
        x, k, v = _decode_layer_body(x, layer_params(params, i), cfg, cache,
                                     i, cos, sin, start)
        new.append(_new_kv(k[:, 0], v[:, 0], quant, cache.k.dtype))
    logits = final_logits(params, cfg, x)
    stacked = [_stack(list(c)) for c in zip(*new)]  # [L, B, Kv(, H)]
    rows, pos = _run_index(start, cache.max_seq, 1)
    rows, pos = rows[:, 0], pos[:, 0]
    if quant:
        # advanced dims 1 and 3 (a slice between) go first: [B, L, Kv, H]
        idx = (slice(None), rows, slice(None), pos)
        for dst, val in zip((cache.k, cache.v, cache.k_scale, cache.v_scale),
                            stacked):
            _set(dst, idx, tmap(lambda a: a.transpose(0, 1), val))
    else:
        _set(cache.k, (slice(None), rows, pos), stacked[0])
        _set(cache.v, (slice(None), rows, pos), stacked[1])
    return logits, cache._replace(length=(cache.length + 1).to(torch.int32))


def _group_cache(cache: KVCache, g) -> KVCache:
    """Data group g's rows of a contiguous cache (written in place)."""
    return KVCache(*(group_rows(t, g, 1, inplace=True)
                     for t in (cache.k, cache.v)),
                   length=group_rows(cache.length, g),
                   k_scale=group_rows(cache.k_scale, g, 1, inplace=True),
                   v_scale=group_rows(cache.v_scale, g, 1, inplace=True))


def _group_steps(steps: list, g) -> list:
    """Group g's rows of window steps (tuples of [L, B, ...] tensors)."""
    return [tuple(group_rows(t, g, 1) for t in s) for s in steps]


def decode_step_win(params: Params, cfg: ModelConfig, tokens,
                    cache: KVCache, prev: list, wstep: int):
    """One decode step against (cache + prior window steps + self), no
    cache write. tokens [B,1] sit at position cache.length + wstep; `prev`
    holds this flush group's steps 0..wstep-1 as returned by this
    function. Returns (logits, new_kv): this token's per-layer K/V
    stacked [L,B,Kv,H] — float (k, v) or int8 (kq, vq, k_scale [L,B,Kv],
    v_scale) in the cache's representation. Data groups run their rows
    and the results concatenate."""
    groups = data_groups(tokens.shape[0])
    if groups is not None:
        outs = [_decode_step_win(group_part(params, g.index), cfg,
                                 group_rows(tokens, g), _group_cache(cache, g),
                                 _group_steps(prev, g), wstep)
                for g in groups]
        return (cat_groups([o[0] for o in outs]),
                cat_groups([o[1] for o in outs], dim=1))
    return _decode_step_win(params, cfg, tokens, cache, prev, wstep)


def _decode_step_win(params: Params, cfg: ModelConfig, tokens,
                     cache: KVCache, prev: list, wstep: int):
    quant = cache.quantized
    positions = (cache.length + wstep)[:, None]
    x, cos, sin = embed_tokens(params, cfg, tokens, positions)
    start = cache.length
    win = tuple(_stack(list(c), dim=1) for c in zip(*prev)) if prev else ()
    new = []
    for i in range(cfg.num_layers):
        w = [t[i] for t in win]   # [W,B,Kv,H] (+ [W,B,Kv] scales)
        x, k, v = _decode_layer_body(
            x, layer_params(params, i), cfg, cache, i, cos, sin, start,
            *(w + [None] * (4 - len(w))))
        new.append(_new_kv(k[:, 0], v[:, 0], quant, cache.k.dtype))
    return final_logits(params, cfg, x), \
        tuple(_stack(list(c)) for c in zip(*new))


def flush_window(cache: KVCache, steps: list,
                 uniform: bool = False) -> KVCache:
    """Write a whole flush group (C = len(steps) tokens per row, each a
    decode_step_win new_kv) into the cache at each row's flushed length,
    IN PLACE, in one write per cache tensor; lengths advance by C.

    `uniform` asserts every row's flushed length is equal: the write then
    starts at row 0's length for every row (the JAX package's one
    scalar-offset update), still read on the device. Data groups write
    their rows."""
    groups = data_groups(cache.length.shape[0])
    if groups is not None:
        for g in groups:
            _flush_window(_group_cache(cache, g), _group_steps(steps, g),
                          uniform)
        return cache._replace(length=(cache.length + len(steps))
                              .to(torch.int32))
    return _flush_window(cache, steps, uniform)


def _flush_window(cache: KVCache, steps: list,
                  uniform: bool = False) -> KVCache:
    start = cache.length
    C = len(steps)
    S = cache.max_seq
    B = start.shape[0]
    if uniform:
        start = start[:1].expand(B)
    rows, pos = _run_index(start, S, C)       # [B, C]
    if cache.quantized:
        kq, vq, ksc, vsc = (_stack([s[j] for s in steps], dim=3)
                            for j in range(4))  # [L,B,Kv,C(,H)]
        # advanced dims 1 and 3 (a slice between) go first: [B,C,L,Kv(,H)]
        idx = (slice(None), rows, slice(None), pos)
        _set(cache.k, idx, tmap(lambda a: a.permute(1, 3, 0, 2, 4), kq))
        _set(cache.v, idx, tmap(lambda a: a.permute(1, 3, 0, 2, 4), vq))
        _set(cache.k_scale, idx, tmap(lambda a: a.permute(1, 3, 0, 2), ksc))
        _set(cache.v_scale, idx, tmap(lambda a: a.permute(1, 3, 0, 2), vsc))
    else:
        ks, vs = (_stack([s[j] for s in steps], dim=2)
                  for j in range(2))           # [L,B,C,Kv,H]
        _set(cache.k, (slice(None), rows, pos), ks)
        _set(cache.v, (slice(None), rows, pos), vs)
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
    [B,T,V] float32, cache with length + T). Data groups run their rows
    against their part of the cache, one GroupRun over the batch
    (parallel/tensor.py), and the results concatenate."""
    B, T = tokens.shape
    if positions is None:
        positions = cache.length.long()[:, None] \
            + torch.arange(T, device=tokens.device)[None, :]
    groups = data_groups(B)
    if groups is not None:
        outs = run_groups(groups, lambda g: _forward(
            group_part(params, g.index), cfg, group_rows(tokens, g),
            _group_cache(cache, g), group_rows(positions, g), fresh,
            group_rows(last_index, g)), B)
        return (cat_groups([o[0] for o in outs]), cache._replace(
            length=cat_groups([o[1].length for o in outs])))
    return _forward(params, cfg, tokens, cache, positions, fresh, last_index)


def _forward(params: Params, cfg: ModelConfig, tokens, cache: KVCache,
             positions, fresh: bool, last_index):
    T = tokens.shape[1]
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
                device=None, experts: Optional[Tuple[int, int]] = None
                ) -> Params:
    """Random init (normal, 0.02 std) in cfg.param_dtype, on `device`.

    Each stacked [L, ...] leaf is allocated once in the parameter dtype
    and filled layer by layer from float32 draws, so a large model never
    holds a float32 copy of the whole tree. `generator` must live on
    `device` (a seed-0 one is made when it is None). Draws differ from
    jax.random's; the JAX tree crosses over through models/bridge.py.

    `experts` = [lo, hi) keeps only those experts of the MoE expert
    leaves ([L, hi - lo, ...]): every expert is still drawn, one layer at
    a time, so the kept ones equal the whole tree's (a process of a mesh
    whose expert axis crosses processes holds only its own).
    """
    dev = resolve_device(device)
    pdt = torch_dtype(cfg.param_dtype)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    L, D, Nq, Kv, H, F_, V = (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                              cfg.num_kv_heads, cfg.head_dim,
                              cfg.intermediate_size, cfg.vocab_size)

    def draw(shape, std=0.02, keep=None):
        kept = shape if keep is None else \
            (shape[0], keep[1] - keep[0]) + tuple(shape[2:])
        out = torch.empty(kept, dtype=pdt, device=dev)
        f32 = torch.float32
        if len(shape) > 1 and shape[0] == L:
            for i in range(L):
                w = torch.randn(shape[1:], generator=generator, dtype=f32,
                                device=dev)
                out[i].copy_((w if keep is None else w[keep[0]:keep[1]])
                             * std)
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
        E = cfg.num_experts
        layers["moe"] = {"router": draw((L, D, E)),
                         "w_gate": draw((L, E, D, F_), keep=experts),
                         "w_up": draw((L, E, D, F_), keep=experts),
                         "w_down": draw((L, E, F_, D), keep=experts)}
    elif cfg.arch == "gpt2":
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
