"""Flash prefill attention: the Hopper kernels' wrapper and its plain version.

The counterpart of butterfly_tpu/ops/flash_attention.py's `flash_attention`
(same arguments and layouts; the Pallas block sizes and interpret switch
have no counterpart). On CUDA tensors `flash_attention` launches one of the
hand-written sm_90a kernels in csrc/flash_attention.cu (built at first use,
see ops/build.py) or raises; on CPU tensors it computes the plain PyTorch
version, `flash_attention_ref`. Two entry points, two launch counters:

* fresh: causal (or non-causal) self-attention over the just-projected
  Q/K/V — every `generate` prefill and every fresh gang of the alternating
  serving path (`flash_attention.launches_fresh`);
* warm: a cached prefix (a gathered pool view, float or int8 codes plus
  scales) attended ahead of the causal fresh chunk — every chunk
  continuation of the alternating serving path
  (`flash_attention.launches_warm`).

Under a tensor mesh `flash_attention_sharded` (the JAX package's mesh
wrapper) runs the unmodified kernel per tensor shard on its q heads and
its own K/V and prefix, or once over every head where the K/V is
replicated (`shardable_axes` finds no tensor split); without a mesh it is
`flash_attention`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from butterfly_tpu_torch.core.mesh import active_mesh
from butterfly_tpu_torch.parallel.partition import Shards
from butterfly_tpu_torch.parallel.tensor import over_heads

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_HEAD_DIMS = (16, 32, 64, 128, 256)
NEG_INF = -1e30
#: query rows per block of the wgmma kernels, fresh and warm (bf16 / f16
#: at head dims 64 and 128): two warpgroups of 64 rows
FRESH_BQ = 128


def fresh_block_order(B: int, T: int, Nq: int, causal: bool):
    """(batch row, query tile, query head) of each block of the fresh
    wgmma kernel, in launch order (blockIdx.x), as the kernel decodes it
    (csrc/flash_wgmma.cuh): query heads fastest, so the G heads of one kv
    head are adjacent blocks and share K/V tiles through L2; with `causal`
    the query tiles run last to first, the heaviest (most keys) first."""
    ntiles = -(-T // FRESH_BQ)
    return [(b, ntiles - 1 - ti if causal else ti, n)
            for b in range(B) for ti in range(ntiles) for n in range(Nq)]


def warm_block_order(prefix_len, T: int, Nq: int, Sp: int):
    """(batch row, query tile, query head) of each block of the warm
    wgmma kernel, in launch order (blockIdx.x), as the kernel decodes it
    (csrc/flash_warm_wgmma.cuh): batch rows by prefix_len clamped to
    [0, Sp], longest first (ties by row), since a block's work grows with
    its row's live prefix; within a row the query tiles last to first (the
    causal chunk's heaviest first); query heads fastest, so a kv group's
    heads are adjacent blocks. The kernel ranks the lengths on the card;
    `prefix_len` here is any sequence of ints."""
    plen = [min(max(int(p), 0), Sp) for p in prefix_len]
    rows = sorted(range(len(plen)), key=lambda b: (-plen[b], b))
    ntiles = -(-T // FRESH_BQ)
    return [(b, ntiles - 1 - ti, n)
            for b in rows for ti in range(ntiles) for n in range(Nq)]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        prefix_k: Optional[torch.Tensor] = None,
                        prefix_v: Optional[torch.Tensor] = None,
                        prefix_len: Optional[torch.Tensor] = None,
                        prefix_k_scale: Optional[torch.Tensor] = None,
                        prefix_v_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain PyTorch flash attention, written from the definition: one
    masked softmax in f32 over [live prefix columns ‖ fresh chunk].

    Fresh key j is live for query i iff j < T and, if causal, j <= i;
    prefix column c is live for batch row b iff c < prefix_len[b]. Scores
    are q·k in f32 times rsqrt(H), the int8 prefix's K scale multiplying
    the score columns first; a masked score is -1e30 and a masked
    probability exactly 0; the denominator sums the probabilities before
    the int8 prefix's V scale folds into them; the output is
    acc / max(l, 1e-30) in q's dtype, so a row with nothing live is 0.

    Shapes as `flash_attention`."""
    if prefix_k is not None and not causal:
        raise ValueError("warm-prefix flash attention is causal-only")
    B, T, Nq, H = q.shape
    Kv = k.shape[2]
    G = Nq // Kv
    dev = q.device
    scale = torch.rsqrt(torch.tensor(float(H)))
    qf = q.float().reshape(B, T, Kv, G, H)
    s_parts = [torch.einsum("btkgh,bskh->bkgts", qf, k.float()) * scale]
    live_f = torch.ones((T, T), dtype=torch.bool, device=dev)
    if causal:
        live_f = torch.tril(live_f)
    masks = [live_f[None, None, None].expand(B, 1, 1, T, T)]
    quant = prefix_k_scale is not None
    if prefix_k is not None:
        if quant:   # codes [B, Kv, Sp, H], scales [B, Kv, Sp]
            Sp = prefix_k.shape[2]
            s_p = torch.einsum("btkgh,bksh->bkgts", qf, prefix_k.float())
            s_p = s_p * prefix_k_scale[:, :, None, None, :] * scale
        else:       # float view [B, Sp, Kv, H]
            Sp = prefix_k.shape[1]
            s_p = torch.einsum("btkgh,bskh->bkgts", qf,
                               prefix_k.float()) * scale
        live_p = torch.arange(Sp, device=dev)[None, :] \
            < prefix_len.long()[:, None]                      # [B, Sp]
        s_parts.insert(0, s_p)
        masks.insert(0, live_p[:, None, None, None, :].expand(B, 1, 1, T, Sp))
    s = torch.cat(s_parts, dim=-1)
    mask = torch.cat(masks, dim=-1)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgts,bskh->bkgth", p[..., -T:], v.float())
    if prefix_k is not None:
        pp = p[..., :-T]
        if quant:
            pp = pp * prefix_v_scale[:, :, None, None, :]
            out = out + torch.einsum("bkgts,bksh->bkgth", pp,
                                     prefix_v.float())
        else:
            out = out + torch.einsum("bkgts,bskh->bkgth", pp,
                                     prefix_v.float())
    out = out / den
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Nq, H).to(q.dtype)


def _kernel_fns():
    """The C entry points of the built library (built at first use)."""
    from butterfly_tpu_torch.ops.build import load
    lib = load("flash_attention")
    fresh, warm = lib.bt_flash_fresh, lib.bt_flash_warm
    if fresh.argtypes is None:
        fresh.restype = ctypes.c_int
        fresh.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                          + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        warm.restype = ctypes.c_int
        warm.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
                         + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 3
                         + [ctypes.c_void_p])
    return fresh, warm


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def _check_operand(t: torch.Tensor, q: torch.Tensor, name: str) -> None:
    _check(t.device == q.device, f"{name} must share q's device")
    _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    prefix_k: Optional[torch.Tensor] = None,
                    prefix_v: Optional[torch.Tensor] = None,
                    prefix_len: Optional[torch.Tensor] = None,
                    prefix_k_scale: Optional[torch.Tensor] = None,
                    prefix_v_scale: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Blockwise (flash) attention over fresh Q/K/V, optionally after a
    cached prefix.

    q: [B, T, Nq, H]; k/v: [B, T, Kv, H] (self-attention; query head n
    reads kv head n // (Nq / Kv); made contiguous if they are not).
    Returns [B, T, Nq, H] in q's dtype; softmax and accumulation in f32
    (the bf16/f16 kernel rounds the probabilities to q's dtype for the
    P·V product; the plain version does not).

    Warm prefix (chunk continuations): prefix_k/prefix_v are the cached
    context, attended ahead of the causal fresh chunk — a float view
    [B, Sp, Kv, H] in q's dtype (any strides with a contiguous last dim),
    or int8 codes [B, Kv, Sp, H] with f32 scales prefix_k_scale /
    prefix_v_scale [B, Kv, Sp]. prefix_len [B] int32 counts each row's
    live cached tokens; columns at or past it never contribute. `causal`
    must then be True.

    CPU tensors take the plain version; CUDA tensors launch the sm_90a
    kernel (counted in `flash_attention.launches_fresh` or
    `.launches_warm`) or raise. bf16 / f16 at head dims 64 and 128 take
    the wgmma kernels (the warm one's launch order is `warm_block_order`,
    decided on the card from prefix_len), other head dims mma.sync, f32
    the CUDA cores.
    """
    warm = prefix_k is not None
    if warm and not causal:
        raise ValueError("warm-prefix flash attention is causal-only")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, prefix_k, prefix_v,
                                   prefix_len, prefix_k_scale,
                                   prefix_v_scale)
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    _check(q.dim() == 4 and k.dim() == 4, "q/k/v must be [B, T, N, H]")
    B, T, Nq, H = q.shape
    Kv = k.shape[2]
    _check(H in _HEAD_DIMS, f"head_dim {H} not in {_HEAD_DIMS}")
    _check(Kv > 0 and Nq % Kv == 0, f"Nq={Nq} not a multiple of Kv={Kv}")
    _check(q.dtype in _DTYPE_CODE, f"q dtype {q.dtype} unsupported")
    _check(k.shape == (B, T, Kv, H) and v.shape == k.shape,
           "k/v must be [B, T, Kv, H] like q")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           "q/k/v must share one dtype")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(t, q, name)
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    fresh_fn, warm_fn = _kernel_fns()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _DTYPE_CODE[q.dtype]
    if not warm:
        rc = fresh_fn(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), B, T, Nq, Kv, H, int(causal), stream)
        if rc != 0:
            raise RuntimeError(f"flash_attention fresh kernel launch failed "
                               f"(code {rc})")
        _WRAPPER.launches_fresh += 1
        return out
    quant = prefix_k_scale is not None
    _check(prefix_v is not None and prefix_len is not None,
           "prefix_k needs prefix_v and prefix_len")
    _check(prefix_k.dim() == 4 and prefix_v.shape == prefix_k.shape,
           "prefix_k/prefix_v must be 4-D and of one shape")
    _check(prefix_k.stride() == prefix_v.stride(),
           "prefix_k/prefix_v must share strides")
    if quant:
        _check(prefix_v_scale is not None, "both prefix scales are required")
        _check(prefix_k.dtype == torch.int8 and prefix_v.dtype == torch.int8,
               "an int8 prefix holds int8 codes")
        Sp = prefix_k.shape[2]
        _check(prefix_k.shape == (B, Kv, Sp, H),
               "int8 prefix codes must be [B, Kv, Sp, H]")
        sb, sh, ss, sd = prefix_k.stride()
        for name, sc in (("prefix_k_scale", prefix_k_scale),
                         ("prefix_v_scale", prefix_v_scale)):
            _check(sc.dtype == torch.float32 and sc.shape == (B, Kv, Sp)
                   and sc.is_contiguous(),
                   f"{name} must be contiguous f32 [B, Kv, Sp]")
            _check_operand(sc, q, name)
    else:
        _check(prefix_k.dtype == q.dtype and prefix_v.dtype == q.dtype,
               "a float prefix must be in q's dtype")
        Sp = prefix_k.shape[1]
        _check(prefix_k.shape == (B, Sp, Kv, H),
               "a float prefix must be [B, Sp, Kv, H]")
        sb, ss, sh, sd = prefix_k.stride()
    _check(sd == 1 and sb % 8 == 0 and ss % 8 == 0 and sh % 8 == 0,
           "the prefix needs a contiguous last dim and strides that are "
           "multiples of 8 elements")
    _check(prefix_len.dtype == torch.int32 and prefix_len.shape == (B,)
           and prefix_len.is_contiguous(), "prefix_len must be int32 [B]")
    for name, t in (("prefix_k", prefix_k), ("prefix_v", prefix_v),
                    ("prefix_len", prefix_len)):
        _check_operand(t, q, name)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = warm_fn(code, int(quant), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 prefix_k.data_ptr(), prefix_v.data_ptr(),
                 ptr(prefix_k_scale), ptr(prefix_v_scale),
                 prefix_len.data_ptr(), out.data_ptr(),
                 B, T, Nq, Kv, H, Sp, sb, ss, sh, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention warm kernel launch failed "
                           f"(code {rc})")
    _WRAPPER.launches_warm += 1
    return out


#: kernel launches since the last reset, per entry point (plain ints; set
#: them to 0 before a run to count that run's launches)
flash_attention.launches_fresh = 0
flash_attention.launches_warm = 0
#: the wrapper that holds the counts: its body counts through this name,
#: so a check that rebinds the module's `flash_attention` (to compare each
#: call of the sharded wrapper with the plain version) leaves them in place
_WRAPPER = flash_attention


def shardable_axes(batch: int, nq: int, kv: int):
    """(data_axis, tensor_axis) of the active mesh usable to shard an
    attention operand set: `data` must divide the batch/slot dim,
    `tensor` both head counts; an axis absent or of size 1 is None. The
    eligibility rule of both kernel wrappers, and of the K/V placement
    (parallel/partition.py splits the pools by the same test)."""
    mesh = active_mesh()
    if mesh is None:
        return None, None
    D, T = mesh.shape.get("data", 1), mesh.shape.get("tensor", 1)
    d = "data" if D > 1 and batch % D == 0 else None
    t = "tensor" if T > 1 and nq % T == 0 and kv % T == 0 else None
    return d, t


def live_auto_mesh() -> bool:
    """True when the active mesh has an axis larger than 1: a kernel call
    whose operands no axis splits then runs once over the whole operand
    set on the replicated tensors (the JAX package's dense fallback)."""
    mesh = active_mesh()
    return mesh is not None and any(v > 1 for v in mesh.shape.values())


def check_shard_layout(who: str, q, kv, nq: int, nkv: int) -> None:
    """Raise unless `kv` is split over the tensor axis exactly where the
    mesh rule (`shardable_axes`) splits it."""
    _, t = shardable_axes(1, nq, nkv)
    split = isinstance(kv, Shards)
    if live_auto_mesh() and (t is not None) != split:
        raise ValueError(f"{who}: K/V {'split' if split else 'replicated'} "
                         f"over the tensor axis, but the mesh rule "
                         f"{'splits' if t else 'replicates'} Nq={nq}, "
                         f"Kv={nkv}")
    if split and not isinstance(q, Shards):
        raise ValueError(f"{who}: split K/V needs q split over its heads")


def flash_attention_sharded(q, k, v, causal: bool = True, prefix_k=None,
                            prefix_v=None, prefix_len=None,
                            prefix_k_scale=None, prefix_v_scale=None):
    """Mesh-aware flash attention: q [B, T, Nq, H] split over the tensor
    axis's heads (parallel/partition.py:Shards, one part per shard),
    k/v [B, T, Kv, H] and the prefix operands split the same way
    (`warm_prefix_specs`: kv heads with the pools). Each shard runs the
    unmodified kernel on its heads; no cross-shard traffic. Where Kv does
    not divide the tensor axis the K/V and the prefix are replicated:
    the kernel runs once over every head and each shard takes its heads'
    rows, so the kernel stays on the path. Unsharded operands: exactly
    `flash_attention`. Data groups arrive split already (the forwards
    run each group's rows)."""
    check_shard_layout("flash_attention_sharded", q, k, q.shape[2],
                       k.shape[2])
    return over_heads(flash_attention, q, k, v, causal=causal,
                      prefix_k=prefix_k, prefix_v=prefix_v,
                      prefix_len=prefix_len, prefix_k_scale=prefix_k_scale,
                      prefix_v_scale=prefix_v_scale)
