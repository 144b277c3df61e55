"""Ring-attention block stats: the Hopper kernel's wrapper, its plain
version, and the stats algebra the seq-parallel paths merge with.

The counterpart of butterfly_tpu/ops/ring_attention.py (same functions,
arguments and layouts; the Pallas block sizes and interpret switch have no
counterpart). One K/V block's attention is computed as UNNORMALISED
partial flash statistics

    stats = (m [B,Nq,T], l [B,Nq,T], acc [B,Nq,T,H])   all f32

with m the max live score, l = sum exp(s - m), acc = sum exp(s - m) * v.
Partials over disjoint key sets merge associatively (`merge_stats`) and
one `finalize_stats` normalises, so a ring of K/V blocks, or a prefix
split over shards plus a suffix, is one online softmax.

Masking contract: the only predicate is k_pos <= q_pos. Callers sanitise
invalid keys (padding, past the live prefix, unwritten suffix slots) to
`INVALID_POS`, so causality, raggedness and padding are one comparison. A
row with no live key gets m = NEG_INF (the finite -1e30), l = 0, acc = 0,
so every merge needs no isinf/NaN guard.

On CUDA tensors `ring_block_stats` launches one of the hand-written sm_90a
kernels in csrc/ring_attention.cu (built at first use, see ops/build.py)
or raises; on CPU tensors it computes the plain version,
`ring_block_stats_ref`. Routes on the card: a decode step (T = 1) splits
the keys over blocks (flash-decoding: `ring_split_plan` sizes the split
from the static S alone, a second kernel merges the partials in split
order; `ring_block_stats_split_ref` is the plain version of that
decomposition); T > 1 in bf16 / f16 at head dims 64 and 128 runs the
warpgroup-MMA kernel, everything else the CUDA-core one (`ring_route`
says which kernel a call takes). The module-level `launches` counts
wrapper calls that launched a kernel, `launches_decode` those of them
that took the T = 1 route (set both to 0 before a run to count that
run's).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

#: sanitised "never attend" key position: k_pos <= q_pos is False for
#: every real query position.
INVALID_POS = 2**31 - 1
NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
#: the head dims the kernels take (the paged and flash kernels' set)
_HEAD_DIMS = (16, 32, 64, 128, 256)
#: bf16 / f16 run on the tensor cores at these head dims, else on the
#: CUDA cores in f32
_TC_HEAD_DIMS = (64, 128)
#: keys one block of the T = 1 kernel folds
SPLIT_KEYS = 256

#: wrapper calls that launched a kernel since the last reset (plain ints);
#: `launches_decode` counts the T = 1 (split) route's share
launches = 0
launches_decode = 0


def ring_route(T: int, H: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA call of `ring_block_stats` launches for T query
    rows at head dim H with q in `dtype`: "split_tc" / "split_cc" (T = 1,
    the split kernel on the tensor / CUDA cores), "wgmma" or "cuda_cores"
    (T > 1). Raises ValueError for a head dim or dtype no kernel takes
    (there is no plain fallback on the card). Reads no tensor."""
    _check(dtype in _DTYPE_CODE, f"q dtype {dtype} unsupported "
           f"(float32, float16 or bfloat16)")
    _check(H in _HEAD_DIMS, f"head_dim {H} not in {_HEAD_DIMS}")
    tc = dtype != torch.float32 and H in _TC_HEAD_DIMS
    if T == 1:
        return "split_tc" if tc else "split_cc"
    return "wgmma" if tc else "cuda_cores"


def ring_split_plan(S: int):
    """The T = 1 kernel's grid along the keys, from the static S alone
    (never from the positions, which live on the card): (keys per split,
    number of splits). Split i folds keys [i * split, min(S, (i + 1) *
    split)); with one split the kernel writes the stats itself, with more
    a merge kernel combines them."""
    return SPLIT_KEYS, max(1, -(-S // SPLIT_KEYS))


# -- the stats algebra ----------------------------------------------------------

def zero_stats(B: int, Nq: int, T: int, H: int, device=None):
    """Identity element of `merge_stats` (m = the finite NEG_INF)."""
    f32 = torch.float32
    return (torch.full((B, Nq, T), NEG_INF, dtype=f32, device=device),
            torch.zeros((B, Nq, T), dtype=f32, device=device),
            torch.zeros((B, Nq, T, H), dtype=f32, device=device))


def merge_stats(a, b):
    """Merge two partial flash stats over disjoint key sets: both
    accumulators rescale from their own max to the joint max before they
    add. m is always >= NEG_INF (finite), so a fully masked partial
    (m = NEG_INF, l = acc = 0) merges as a clean no-op."""
    m_a, l_a, acc_a = a
    m_b, l_b, acc_b = b
    m = torch.maximum(m_a, m_b)
    c_a = torch.exp(m_a - m)
    c_b = torch.exp(m_b - m)
    l = l_a * c_a + l_b * c_b
    acc = acc_a * c_a[..., None] + acc_b * c_b[..., None]
    return m, l, acc


def finalize_stats(stats, dtype) -> torch.Tensor:
    """Normalise merged stats -> [B, T, Nq, H] attention output."""
    _, l, acc = stats
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.movedim(1, 2).to(dtype)             # [B,Nq,T,H]->[B,T,Nq,H]


# -- the plain version ----------------------------------------------------------

def ring_block_stats_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, k_pos: torch.Tensor,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None):
    """Plain PyTorch partial flash stats of one K/V block.

    q: [B,T,Nq,H]; float k/v: [B,S,Kv,H]; int8 k/v: codes [B,Kv,S,H] with
    k_scale/v_scale [B,Kv,S]. q_pos [B,T], k_pos [B,S] int32, invalid keys
    sanitised to INVALID_POS. Returns (m, l, acc) as [B,Nq,T] / [B,Nq,T] /
    [B,Nq,T,H] f32, head order n = kv*G + g. Scores are q.k in f32 (times
    the K scale of the column for int8) times rsqrt(H); l sums the
    probabilities before the int8 V scale folds into them."""
    B, T, Nq, H = q.shape
    quant = k_scale is not None
    Kv = k.shape[1] if quant else k.shape[2]
    G = Nq // Kv
    scale = 1.0 / torch.sqrt(torch.tensor(H, dtype=torch.float32))
    qh = q.movedim(2, 1).reshape(B, Kv, G, T, H).float()
    kf = k.float() if quant else k.movedim(2, 1).float()   # [B,Kv,S,H]
    vf = v.float() if quant else v.movedim(2, 1).float()
    s = torch.einsum("bkgth,bksh->bkgts", qh, kf)
    if quant:
        s = s * k_scale[:, :, None, None, :]
    s = s * scale
    mask = k_pos[:, None, None, None, :] <= q_pos[:, None, None, :, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                     # finite
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    if quant:
        p = p * v_scale[:, :, None, None, :]
    acc = torch.einsum("bkgts,bksh->bkgth", p, vf)
    return (m.reshape(B, Nq, T), l.reshape(B, Nq, T),
            acc.reshape(B, Nq, T, H))


def ring_block_stats_split_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, q_pos: torch.Tensor,
                               k_pos: torch.Tensor,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None,
                               return_partials: bool = False):
    """Plain PyTorch version of the T = 1 kernel's decomposition (the
    arguments of `ring_block_stats_ref`, any T): for each split of
    `ring_split_plan(S)` the partial stats of its keys
    (`ring_block_stats_ref` on the slice: a split with nothing live is
    exactly m = -1e30, l = 0, acc = 0), then the partials merged in split
    order: M = max m_i, l = sum l_i e^(m_i - M), acc = sum acc_i
    e^(m_i - M), m = M. Unnormalised, as the ring contract wants. With
    `return_partials` also returns the partials stacked on a leading split
    axis."""
    quant = k_scale is not None
    S = k.shape[2] if quant else k.shape[1]
    split, n_split = ring_split_plan(S)
    parts = []
    for i in range(n_split):
        sl = slice(i * split, min(S, (i + 1) * split))
        if quant:
            parts.append(ring_block_stats_ref(
                q, k[:, :, sl], v[:, :, sl], q_pos, k_pos[:, sl],
                k_scale[:, :, sl], v_scale[:, :, sl]))
        else:
            parts.append(ring_block_stats_ref(q, k[:, sl], v[:, sl], q_pos,
                                              k_pos[:, sl]))
    M = parts[0][0]
    for m_i, _, _ in parts[1:]:
        M = torch.maximum(M, m_i)
    l = acc = None
    for m_i, l_i, acc_i in parts:
        f = torch.exp(m_i - M)
        l_f, acc_f = l_i * f, acc_i * f[..., None]
        l = l_f if l is None else l + l_f
        acc = acc_f if acc is None else acc + acc_f
    stats = (M, l, acc)
    if return_partials:
        return stats, tuple(torch.stack(x) for x in zip(*parts))
    return stats


# -- the kernel -----------------------------------------------------------------

def _kernel_fns():
    """The C entry points of the built library (built at first use):
    (bt_ring_stats, bt_ring_decode)."""
    from butterfly_tpu_torch.ops.build import load
    lib = load("ring_attention")
    stats, decode = lib.bt_ring_stats, lib.bt_ring_decode
    if stats.argtypes is None:
        stats.restype = ctypes.c_int
        stats.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                          + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 3
                          + [ctypes.c_void_p])
        decode.restype = ctypes.c_int
        decode.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 11
                           + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
                           + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return stats, decode


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ring_block_stats: {msg}")


def ring_block_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, k_pos: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None):
    """Partial flash stats of one K/V block: the contract of
    `ring_block_stats_ref`, whose shapes it takes.

    CPU tensors take the plain version. CUDA tensors launch an sm_90a
    kernel (counted in `launches`; T = 1 also in `launches_decode`) or
    raise: q in f32, bf16 or f16 at head_dim 16, 32, 64, 128 or 256
    (`ring_route`: bf16 / f16 at 64 and 128 on the tensor cores, where P
    enters P.V rounded to q's dtype; else the CUDA cores in f32); float
    k/v in q's dtype with any strides whose last dim is contiguous and the
    others multiples of 16 bytes; int8 codes likewise, with f32 scales.
    Nothing is padded: keys past S simply do not exist, and the kernel
    treats them as INVALID_POS.
    T = 1 takes the split kernel, sized by `ring_split_plan` from S alone
    (no value is read back from the card)."""
    global launches, launches_decode
    if q.device.type == "cpu":
        return ring_block_stats_ref(q, k, v, q_pos, k_pos, k_scale, v_scale)
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    _check(q.dim() == 4 and k.dim() == 4, "q/k/v must be 4-D")
    B, T, Nq, H = q.shape
    quant = k_scale is not None
    ring_route(T, H, q.dtype)
    if quant:
        Kv, S = k.shape[1], k.shape[2]
        _check(k.shape == (B, Kv, S, H), "int8 codes must be [B, Kv, S, H]")
        _check(k.dtype == torch.int8 and v.dtype == torch.int8,
               "int8 K/V hold int8 codes")
        _check(v_scale is not None, "both scales are required")
        sb, sh, ss, sd = k.stride()
    else:
        S, Kv = k.shape[1], k.shape[2]
        _check(k.shape == (B, S, Kv, H), "float k/v must be [B, S, Kv, H]")
        _check(k.dtype == q.dtype and v.dtype == q.dtype,
               "float k/v must be in q's dtype")
        sb, ss, sh, sd = k.stride()
    _check(v.shape == k.shape and v.stride() == k.stride(),
           "k and v must share shape and strides")
    _check(Kv > 0 and Nq % Kv == 0, f"Nq={Nq} not a multiple of Kv={Kv}")
    el = 16 // k.element_size()   # elements in 16 bytes
    _check(sd == 1 and sb % el == 0 and ss % el == 0 and sh % el == 0,
           "k/v need a contiguous last dim and strides that are multiples "
           "of 16 bytes")
    _check(q_pos.shape == (B, T) and k_pos.shape == (B, S),
           "q_pos must be [B, T] and k_pos [B, S]")
    q = q.contiguous()
    qp = q_pos.to(torch.int32).contiguous()
    kp = k_pos.to(torch.int32).contiguous()
    ks = vs = None
    if quant:
        ks = k_scale.to(torch.float32).contiguous()
        vs = v_scale.to(torch.float32).contiguous()
        _check(ks.shape == (B, Kv, S) and vs.shape == (B, Kv, S),
               "scales must be [B, Kv, S]")
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", qp),
                    ("k_pos", kp), ("k_scale", ks), ("v_scale", vs)):
        if t is not None:
            _check(t.device == q.device, f"{name} must share q's device")
            _check(t.data_ptr() % 16 == 0 or t.numel() == 0,
                   f"{name} must be 16-byte aligned")
    f32 = torch.float32
    m = torch.empty((B, Nq, T), dtype=f32, device=q.device)
    l = torch.empty((B, Nq, T), dtype=f32, device=q.device)
    acc = torch.empty((B, Nq, T, H), dtype=f32, device=q.device)
    if B == 0 or T == 0:
        return m, l, acc
    stats_fn, decode_fn = _kernel_fns()

    def ptr(t):
        return None if t is None else t.data_ptr()

    head = (_DTYPE_CODE[q.dtype], int(quant), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), ptr(ks), ptr(vs), qp.data_ptr(), kp.data_ptr(),
            m.data_ptr(), l.data_ptr(), acc.data_ptr())
    # the launch goes to the current device: make it q's (a mesh may put
    # shards on several cards)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if T == 1:
            split, n_split = ring_split_plan(S)
            ws = None
            if n_split > 1:   # partials: acc, then m and l
                ws = torch.empty(B * Nq * n_split * (H + 2), dtype=f32,
                                 device=q.device)
            rc = decode_fn(*head, ptr(ws), B, S, Nq, Kv, H, sb, ss, sh,
                           split, n_split, stream)
        else:
            rc = stats_fn(*head, B, T, S, Nq, Kv, H, sb, ss, sh, stream)
    if rc != 0:
        raise RuntimeError(f"ring_block_stats kernel launch failed "
                           f"(code {rc})")
    launches += 1
    launches_decode += T == 1
    return m, l, acc


def block_stats(q, k, v, q_pos, k_pos, k_scale=None, v_scale=None,
                kernel: Optional[bool] = None):
    """The call sites' entry: `kernel=None` takes the kernel when the
    tensors are on CUDA (ring_block_stats picks by device); False forces
    the plain version (comparisons against the kernel only)."""
    if kernel is False:
        return ring_block_stats_ref(q, k, v, q_pos, k_pos, k_scale, v_scale)
    return ring_block_stats(q, k, v, q_pos, k_pos, k_scale, v_scale)
