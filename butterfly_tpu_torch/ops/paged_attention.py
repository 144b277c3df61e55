"""Paged decode attention: the Hopper kernel's wrapper and its plain version.

The counterpart of butterfly_tpu/ops/paged_attention.py (same signature,
same layouts). On CUDA tensors `paged_attention` launches the hand-written
sm_90a kernel in csrc/paged_attention.cu (built at first use, see
ops/build.py) or raises; on CPU tensors it computes the plain PyTorch
version, `paged_attention_ref`. `paged_attention.launches` counts kernel
launches, so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_HEAD_DIMS = (16, 32, 64, 128, 256)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        lengths: torch.Tensor,
                        k_scale_pages: Optional[torch.Tensor] = None,
                        v_scale_pages: Optional[torch.Tensor] = None,
                        win_k: Optional[torch.Tensor] = None,
                        win_v: Optional[torch.Tensor] = None,
                        win_count: Optional[torch.Tensor] = None,
                        win_k_scale: Optional[torch.Tensor] = None,
                        win_v_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain PyTorch single-token attention over each slot's paged KV,
    written from the definition: gather every slot's pages into one
    [S, Kv, max_pages*page, H] key/value run (dequantized when the pool
    holds int8 codes), append the window's staged entries, then a masked
    softmax in f32 — key j of the pages attends iff j < lengths[s],
    window entry w iff w < win_count[s]. Masked probabilities are exactly
    0, so a slot with nothing to attend returns zeros.

    Shapes as `paged_attention`: q [S, Nq, H]; pools [P, Kv, page, H];
    scales [P, Kv*page]; page_table [S, max_pages]; lengths [S]; window
    [S, Kv, W, H] (+ scales [S, Kv, W]) with win_count [S]."""
    S, Nq, H = q.shape
    _, Kv, page, _ = k_pages.shape
    mp = page_table.shape[1]
    G = Nq // Kv
    tbl = page_table.long()

    def gather(pages, scales):
        x = pages[tbl].float()                       # [S, mp, Kv, page, H]
        if scales is not None:
            sc = scales[tbl].reshape(S, mp, Kv, page)
            x = x * sc[..., None]
        return x.permute(0, 2, 1, 3, 4).reshape(S, Kv, mp * page, H)

    k = gather(k_pages, k_scale_pages)
    v = gather(v_pages, v_scale_pages)
    valid = torch.arange(mp * page, device=q.device)[None, :] \
        < lengths.long()[:, None]                    # [S, mp*page]
    if win_k is not None:
        W = win_k.shape[2]
        wk, wv = win_k.float(), win_v.float()
        if win_k_scale is not None:
            wk = wk * win_k_scale[..., None]
            wv = wv * win_v_scale[..., None]
        k = torch.cat([k, wk], dim=2)
        v = torch.cat([v, wv], dim=2)
        wvalid = torch.arange(W, device=q.device)[None, :] \
            < win_count.long()[:, None]
        valid = torch.cat([valid, wvalid], dim=1)
    qf = q.float().reshape(S, Kv, G, H)
    scores = torch.einsum("skgh,skth->skgt", qf, k) \
        * torch.rsqrt(torch.tensor(float(H)))
    mask = valid[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("skgt,skth->skgh", p, v) / den
    return out.reshape(S, Nq, H).to(q.dtype)


def _kernel_fn():
    """The C entry point of the built library (built at first use)."""
    from butterfly_tpu_torch.ops.build import load
    fn = load("paged_attention").bt_paged_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 13
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention: {msg}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor,
                    k_scale_pages: Optional[torch.Tensor] = None,
                    v_scale_pages: Optional[torch.Tensor] = None,
                    win_k: Optional[torch.Tensor] = None,
                    win_v: Optional[torch.Tensor] = None,
                    win_count: Optional[torch.Tensor] = None,
                    win_k_scale: Optional[torch.Tensor] = None,
                    win_v_scale: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Single-token attention over each slot's paged KV.

    q: [slots, Nq, H] (post-rope); k_pages/v_pages: [P, Kv, page, H];
    page_table: [slots, max_pages] int32; lengths: [slots] int32 — the
    cache tokens INCLUDING the current one (with a window: the FLUSHED
    pool length only); k/v_scale_pages: [P, Kv*page] f32 iff the pool
    holds int8 codes. Window (kv_write_combine): win_k/win_v
    [S, Kv, W, H] in the pool's representation (+ win_k/v_scale
    [S, Kv, W] when int8) at positions lengths[s] .. lengths[s] +
    win_count[s] - 1. Returns [slots, Nq, H] in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the sm_90a
    kernel (counted in `paged_attention.launches`) or raise.
    """
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths,
                                   k_scale_pages, v_scale_pages, win_k,
                                   win_v, win_count, win_k_scale,
                                   win_v_scale)
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    quant = k_scale_pages is not None
    window = win_k is not None
    S, Nq, H = q.shape
    _check(k_pages.dim() == 4, "pools must be [P, Kv, page, H]")
    P, Kv, page, H2 = k_pages.shape
    _check(H2 == H and H in _HEAD_DIMS,
           f"head_dim {H} (pool {H2}) not in {_HEAD_DIMS}")
    _check(Kv > 0 and Nq % Kv == 0, f"Nq={Nq} not a multiple of Kv={Kv}")
    _check(q.dtype in _DTYPE_CODE, f"q dtype {q.dtype} unsupported")
    pool_dt = torch.int8 if quant else q.dtype
    _check(k_pages.dtype == pool_dt and v_pages.dtype == pool_dt,
           f"pools must be {pool_dt} (got {k_pages.dtype})")
    _check(v_pages.shape == k_pages.shape, "k/v pool shapes differ")
    _check(page_table.dim() == 2 and page_table.shape[0] == S,
           "page_table must be [S, max_pages]")
    _check(page_table.dtype == torch.int32 and lengths.dtype == torch.int32,
           "page_table and lengths must be int32")
    _check(lengths.shape == (S,), "lengths must be [S]")
    tensors = [q, k_pages, v_pages, page_table, lengths]
    if quant:
        _check(v_scale_pages is not None, "both pool scales are required")
        for sc in (k_scale_pages, v_scale_pages):
            _check(sc.dtype == torch.float32 and sc.shape == (P, Kv * page),
                   "pool scales must be f32 [P, Kv*page]")
        tensors += [k_scale_pages, v_scale_pages]
    W = 0
    if window:
        _check(win_v is not None and win_count is not None,
               "win_k needs win_v and win_count")
        W = win_k.shape[2]
        _check(win_k.shape == (S, Kv, W, H) and win_v.shape == win_k.shape,
               "window must be [S, Kv, W, H]")
        _check(win_k.dtype == pool_dt and win_v.dtype == pool_dt,
               "window must hold the pool's representation")
        _check(win_count.dtype == torch.int32 and win_count.shape == (S,),
               "win_count must be int32 [S]")
        tensors += [win_k, win_v, win_count]
        if quant:
            _check(win_k_scale is not None and win_v_scale is not None,
                   "an int8 window needs its scales")
            for sc in (win_k_scale, win_v_scale):
                _check(sc.dtype == torch.float32 and sc.shape == (S, Kv, W),
                       "window scales must be f32 [S, Kv, W]")
            tensors += [win_k_scale, win_v_scale]
    for t in tensors:
        _check(t.device == q.device, "all operands must share q's device")
        _check(t.is_contiguous(), "operands must be contiguous")
    out = torch.empty_like(q)
    if S == 0:
        return out
    fn = _kernel_fn()

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = fn(_DTYPE_CODE[q.dtype], int(quant), ptr(q), ptr(k_pages),
            ptr(v_pages), ptr(k_scale_pages), ptr(v_scale_pages),
            ptr(page_table), ptr(lengths),
            ptr(win_k) if window else None, ptr(win_v) if window else None,
            ptr(win_k_scale) if window else None,
            ptr(win_v_scale) if window else None,
            ptr(win_count) if window else None, ptr(out),
            S, Nq, Kv, H, page, page_table.shape[1], W,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed "
                           f"(code {rc})")
    paged_attention.launches += 1
    return out


#: kernel launches since the last reset (a plain int; set it to 0 before
#: a run to count that run's launches)
paged_attention.launches = 0
