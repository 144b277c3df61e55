"""PyTorch port: ops/ring_attention.py (the ring block's partial flash
stats, their merge algebra, the wrapper) against the JAX package, f32.

Tolerances: m, l and acc within 2e-5 of JAX's plain version and of its
Pallas kernel run in interpret mode (the same arithmetic summed in
another order by ATen's and XLA's CPU kernels); a row with no live key
exactly m = -1e30, l = 0, acc = 0. The CUDA kernel itself is held against
the plain version on the card (chip_smoke.py, ring phase); here its test
skips without a card.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butterfly_tpu.ops import ring_attention as J
from butterfly_tpu_torch.ops import ring_attention as T

torch.set_num_threads(1)

TOL = 2e-5
B, NQ, KV, H = 2, 8, 2, 8


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _block(Tq, S, start, seed=0, holes=False):
    """Tq queries at positions [start, start + Tq) over S keys at 0..S-1;
    with `holes`, some keys carry INVALID_POS (unwritten or padded)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, NQ, H)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, H)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, H)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(start, start + Tq)[None],
                            (B, Tq)).astype(np.int32)
    k_pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    if holes:
        k_pos = np.where(rng.random((B, S)) < 0.3, J.INVALID_POS, k_pos) \
            .astype(np.int32)
    return q, k, v, q_pos, k_pos


def _quant(x):
    """[B,S,Kv,H] float -> (codes [B,Kv,S,H] int8, scales [B,Kv,S] f32)."""
    xt = np.moveaxis(x, 2, 1)
    scale = np.maximum(np.abs(xt).max(-1) / 127.0, 1e-8).astype(np.float32)
    codes = np.round(xt / scale[..., None]).astype(np.int8)
    return codes, scale


def _inputs(quant, Tq, S, start, holes=False):
    q, k, v, q_pos, k_pos = _block(Tq, S, start, holes=holes)
    if not quant:
        return (q, k, v, q_pos, k_pos)
    kc, ks = _quant(k)
    vc, vs = _quant(v)
    return (q, kc, vc, q_pos, k_pos, ks, vs)


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=tol, rtol=0)


GEOMETRY = [(8, 32, 24, False), (5, 19, 11, False), (5, 19, 11, True)]


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("Tq,S,start,holes", GEOMETRY,
                         ids=["aligned", "ragged", "holes"])
def test_ring_block_stats_match_jax(quant, Tq, S, start, holes):
    """The port's plain version (and its wrapper on CPU tensors) against
    JAX's plain version and its Pallas kernel in interpret mode, with
    8x8 blocks so the kernel streams several key tiles."""
    args = _inputs(quant, Tq, S, start, holes)
    got = T.ring_block_stats_ref(*map(torch.from_numpy, args))
    ref = J.ring_block_stats_ref(*map(jnp.asarray, args))
    kern = J.ring_block_stats(*map(jnp.asarray, args), block_q=8, block_k=8,
                              interpret=True)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
    _close(got, ref)
    _close(got, kern)
    _close(T.ring_block_stats(*map(torch.from_numpy, args)), ref)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_fully_masked_rows_are_exact(quant):
    """A block every query must ignore (keys after every query, or all
    INVALID_POS) gives exactly m = -1e30, l = 0, acc = 0, as JAX's does;
    in a partly masked block the rows with no live key do too."""
    args = list(_inputs(quant, 6, 16, 0))
    args[4] = args[4] + 100                     # every key after every query
    m, l, acc = T.ring_block_stats(*map(torch.from_numpy, args))
    assert (m == T.NEG_INF).all() and (l == 0).all() and (acc == 0).all()
    _close((m, l, acc), J.ring_block_stats_ref(*map(jnp.asarray, args)))
    # queries at 0..5 over keys 3..18: rows 0-2 see nothing
    args[4] = args[4] - 97
    m, l, acc = T.ring_block_stats(*map(torch.from_numpy, args))
    assert (m[:, :, :3] == T.NEG_INF).all() and (l[:, :, :3] == 0).all() \
        and (acc[:, :, :3] == 0).all()
    assert (l[:, :, 3:] > 0).all()
    # merging the empty partial is a no-op
    z = T.zero_stats(B, NQ, 6, H)
    _close(T.merge_stats(z, (m, l, acc)), (m, l, acc), tol=0)


def _dense(q, k, v, q_pos, k_pos):
    """Full masked softmax attention, head n on kv head n // G (numpy)."""
    G = q.shape[2] // k.shape[2]
    kx = np.repeat(k, G, axis=2)
    vx = np.repeat(v, G, axis=2)
    s = np.einsum("btnh,bsnh->bnts", q, kx) / np.sqrt(q.shape[-1])
    mask = k_pos[:, None, None, :] <= q_pos[:, None, :, None]
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    return np.einsum("bnts,bsnh->btnh", p, vx)


def test_four_shard_merge_matches_dense_and_jax():
    """A seq=4 ring decomposition on one device: per-shard partial stats
    folded left to right from zero_stats equal dense attention, and the
    same fold in JAX."""
    q, k, v, q_pos, k_pos = _block(8, 32, 24, seed=3)
    parts_t, parts_j = [], []
    for i in range(4):
        sl = slice(i * 8, (i + 1) * 8)
        a = (q, k[:, sl], v[:, sl], q_pos, k_pos[:, sl])
        parts_t.append(T.ring_block_stats_ref(*map(torch.from_numpy, a)))
        parts_j.append(J.ring_block_stats_ref(*map(jnp.asarray, a)))
    got = functools.reduce(T.merge_stats, parts_t, T.zero_stats(B, NQ, 8, H))
    ref = functools.reduce(J.merge_stats, parts_j, J.zero_stats(B, NQ, 8, H))
    _close(got, ref)
    out = T.finalize_stats(got, torch.float32)
    _close([out], [J.finalize_stats(ref, jnp.float32)])
    _close([out], [_dense(q, k, v, q_pos, k_pos)], tol=2e-5)


def test_cpu_wrapper_does_not_count_launches():
    """On CPU tensors the wrapper computes the plain version and counts
    nothing; block_stats(kernel=False) is the plain version everywhere."""
    args = [torch.from_numpy(a) for a in _inputs(False, 5, 19, 11)]
    n0 = T.launches
    T.ring_block_stats(*args)
    T.block_stats(*args)
    T.block_stats(*args, kernel=False)
    assert T.launches == n0
    _close(T.block_stats(*args, kernel=False), T.ring_block_stats_ref(*args),
           tol=0)


@pytest.mark.cuda
def test_ring_kernel_matches_plain_on_the_card():
    """The sm_90a kernel against its plain version (bf16 and f32, float
    and int8 K/V, a fully masked block), and its launch count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for quant, dt, tol in ((False, torch.float32, 1e-4),
                           (True, torch.float32, 1e-4),
                           (False, torch.bfloat16, 2e-2)):
        args = [torch.from_numpy(a).cuda() for a in
                _inputs(quant, 70, 130, 60, holes=True)]
        args[0] = args[0].to(dt)
        if not quant:
            args[1], args[2] = args[1].to(dt), args[2].to(dt)
        H_ = args[0].shape[-1]
        pad = torch.zeros(args[0].shape[:-1] + (64 - H_,), device="cuda",
                          dtype=dt)
        args[0] = torch.cat([args[0], pad], -1)     # head_dim 64
        for i in (1, 2):
            z = torch.zeros(args[i].shape[:-1] + (64 - H_,), device="cuda",
                            dtype=args[i].dtype)
            args[i] = torch.cat([args[i], z], -1)
        n0 = T.launches
        got = T.ring_block_stats(*args)
        torch.cuda.synchronize()
        assert T.launches == n0 + 1
        want = T.ring_block_stats_ref(*args)
        out = T.finalize_stats(got, torch.float32)
        ref = T.finalize_stats(want, torch.float32)
        assert (out - ref).abs().max().item() <= tol
        assert (got[0] - want[0]).abs().max().item() <= 1e-3
