"""Paged decode attention: the Hopper kernel's wrapper and its plain version.

The counterpart of butterfly_tpu/ops/paged_attention.py (same signature,
same layouts). On CUDA tensors `paged_attention` launches the hand-written
sm_90a kernel in csrc/paged_attention.cu (built at first use, see
ops/build.py) or raises; on CPU tensors it computes the plain PyTorch
version, `paged_attention_ref`. `paged_attention.launches` counts wrapper calls
that launched the kernel (one per call, though a call launches the split
kernel and the merge kernel), so a run can show that its main path went
through it.

The kernel splits each slot's key axis across blocks (flash-decoding):
`split_plan` fixes the split size and count from the table's width alone,
`split_columns` says which keys a split folds, and
`paged_attention_split_ref` is the plain version of that decomposition —
one partial (m, l, acc) per split, merged in split order — which the tests
and chip_smoke.py hold against the others.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from butterfly_tpu_torch.ops.flash_attention import check_shard_layout
from butterfly_tpu_torch.parallel.tensor import over_heads

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_HEAD_DIMS = (16, 32, 64, 128, 256)
#: tokens of the paged run one kernel block folds (a whole number of pages)
SPLIT_TOKENS = 256
NEG_INF = -1e30


def split_plan(page: int, max_pages: int, window: bool):
    """The kernel's grid along the key axis, from static sizes only (never
    from `lengths`, which live on the card): (split_pages, n_page_splits,
    n_split). Split i < n_page_splits covers pages [i * split_pages,
    (i + 1) * split_pages) of a slot's table row; with a window, split
    n_page_splits covers the window's W rows."""
    split_pages = max(1, SPLIT_TOKENS // page)
    n_page_splits = max(1, -(-max_pages // split_pages))
    return split_pages, n_page_splits, n_page_splits + int(window)


def split_columns(i: int, plan, page: int, max_pages: int):
    """Columns [c0, c1) that split i folds, in a slot's [paged run ‖
    window] key axis (the layout of `_dense_kv`). Only the live ones count
    (position < lengths[s], window row < win_count[s]): a split with none
    is the empty split, whose partial is exactly m = -1e30, l = 0,
    acc = 0 — the kernel's block writes it without reading K/V."""
    split_pages, n_page_splits, _ = plan
    run = max_pages * page
    if i == n_page_splits:
        return run, None                   # the window's rows, to the end
    c0 = i * split_pages * page
    return c0, min(c0 + split_pages * page, run)


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
    Kv = k_pages.shape[1]
    k, v, valid = _dense_kv(q, k_pages, v_pages, page_table, lengths,
                            k_scale_pages, v_scale_pages, win_k, win_v,
                            win_count, win_k_scale, win_v_scale)
    qf = q.float().reshape(S, Kv, Nq // Kv, H)
    scores = torch.einsum("skgh,skth->skgt", qf, k) \
        * torch.rsqrt(torch.tensor(float(H)))
    mask = valid[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("skgt,skth->skgh", p, v) / den
    return out.reshape(S, Nq, H).to(q.dtype)


def _dense_kv(q, k_pages, v_pages, page_table, lengths, k_scale_pages,
              v_scale_pages, win_k, win_v, win_count, win_k_scale,
              win_v_scale):
    """Every slot's pages gathered (dequantized) into one f32 [S, Kv,
    max_pages*page (+ W), H] key/value run with the window appended, and
    the [S, max_pages*page (+ W)] liveness of each column."""
    S, Nq, H = q.shape
    _, Kv, page, _ = k_pages.shape
    mp = page_table.shape[1]
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
    return k, v, valid


def paged_attention_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, page_table: torch.Tensor,
                              lengths: torch.Tensor,
                              k_scale_pages: Optional[torch.Tensor] = None,
                              v_scale_pages: Optional[torch.Tensor] = None,
                              win_k: Optional[torch.Tensor] = None,
                              win_v: Optional[torch.Tensor] = None,
                              win_count: Optional[torch.Tensor] = None,
                              win_k_scale: Optional[torch.Tensor] = None,
                              win_v_scale: Optional[torch.Tensor] = None,
                              return_partials: bool = False):
    """Plain PyTorch version of the kernel's decomposition (same arguments
    as `paged_attention`): for each split of `split_plan`, the partial
    (m, l, acc) over the live keys of its `split_columns` — m the max
    score (-1e30 when nothing is live), l the sum of exp(score - m), acc
    the sum of exp(score - m) v, all f32 — then the partials merged in
    split order: M = max m_i, out = sum acc_i e^(m_i - M) /
    max(sum l_i e^(m_i - M), 1e-30). With `return_partials` also returns
    (m, l, acc) stacked on a split axis: [S, Kv, n_split, G (, H)]."""
    S, Nq, H = q.shape
    _, Kv, page, _ = k_pages.shape
    mp = page_table.shape[1]
    window = win_k is not None
    plan = split_plan(page, mp, window)
    k, v, valid = _dense_kv(q, k_pages, v_pages, page_table, lengths,
                            k_scale_pages, v_scale_pages, win_k, win_v,
                            win_count, win_k_scale, win_v_scale)
    qf = q.float().reshape(S, Kv, Nq // Kv, H)
    scores = torch.einsum("skgh,skth->skgt", qf, k) \
        * torch.rsqrt(torch.tensor(float(H)))
    ms, ls, accs = [], [], []
    for i in range(plan[2]):
        c0, c1 = split_columns(i, plan, page, mp)
        cols = torch.zeros(k.shape[2], dtype=torch.bool, device=q.device)
        cols[c0:c1] = True
        live = (cols[None, :] & valid)[:, None, None, :]
        sc = torch.where(live, scores, torch.full_like(scores, NEG_INF))
        m = sc.amax(dim=-1)                                  # [S, Kv, G]
        p = torch.where(live, torch.exp(sc - m[..., None]),
                        torch.zeros_like(sc))
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("skgt,skth->skgh", p, v))
    m, l, acc = (torch.stack(x, dim=2) for x in (ms, ls, accs))
    M = m.amax(dim=2, keepdim=True)
    f = torch.exp(m - M)
    den = (l * f).sum(dim=2).clamp_min(1e-30)
    out = (acc * f[..., None]).sum(dim=2) / den[..., None]
    out = out.reshape(S, Nq, H).to(q.dtype)
    return (out, (m, l, acc)) if return_partials else out


def _kernel_fn():
    """The C entry point of the built library (built at first use)."""
    from butterfly_tpu_torch.ops.build import load
    fn = load("paged_attention").bt_paged_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 14
                       + [ctypes.c_int] * 10 + [ctypes.c_void_p])
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
    kernel (counted in `paged_attention.launches`) or raise. The launch
    reads nothing back from the card: its grid comes from `split_plan`.
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
    mp = page_table.shape[1]
    plan = split_plan(page, mp, window)
    # the partials (m, l, acc) of every split: written before they are read
    ws = torch.empty(S * Kv * plan[2] * (Nq // Kv) * (H + 2),
                     dtype=torch.float32, device=q.device)
    fn = _kernel_fn()

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = fn(_DTYPE_CODE[q.dtype], int(quant), ptr(q), ptr(k_pages),
            ptr(v_pages), ptr(k_scale_pages), ptr(v_scale_pages),
            ptr(page_table), ptr(lengths),
            ptr(win_k) if window else None, ptr(win_v) if window else None,
            ptr(win_k_scale) if window else None,
            ptr(win_v_scale) if window else None,
            ptr(win_count) if window else None, ptr(out), ptr(ws),
            S, Nq, Kv, H, page, mp, W, *plan,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed "
                           f"(code {rc})")
    _WRAPPER.launches += 1
    return out


#: kernel launches since the last reset (a plain int; set it to 0 before
#: a run to count that run's launches)
paged_attention.launches = 0
#: the wrapper that holds the count: its body counts through this name, so
#: a check that rebinds the module's `paged_attention` (to compare each
#: call of the sharded wrapper with the plain version) leaves it in place
_WRAPPER = paged_attention


def paged_attention_sharded(q, k_pages, v_pages, page_table, lengths,
                            k_scale_pages=None, v_scale_pages=None,
                            win_k=None, win_v=None, win_count=None,
                            win_k_scale=None, win_v_scale=None):
    """Mesh-aware paged attention: q [slots, Nq, H] split over the tensor
    axis's heads (parallel/partition.py:Shards), each shard's own pool
    [P, Kv/t, page, H] (a separate contiguous tensor, as the kernel
    requires), its int8 scale pool [P, Kv/t*page] and its window
    [S, Kv/t, W, H]; the block table and lengths are every shard's. Each
    shard calls the unmodified kernel on its heads (Kv/t kv heads, G =
    Nq/Kv unchanged). Where Kv does not divide the tensor axis the pool
    is replicated: the kernel runs once over every head and each shard
    takes its heads' rows. Unsharded operands: exactly
    `paged_attention`. Data groups arrive split already (each group's
    forward passes its slots)."""
    check_shard_layout("paged_attention_sharded", q, k_pages, q.shape[1],
                       k_pages.shape[1])
    return over_heads(paged_attention, q, k_pages, v_pages, page_table,
                      lengths, k_scale_pages, v_scale_pages, win_k=win_k,
                      win_v=win_v, win_count=win_count,
                      win_k_scale=win_k_scale, win_v_scale=win_v_scale)
