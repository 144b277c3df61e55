"""PyTorch port: ops/ring_attention.py (the ring block's partial flash
stats, their merge algebra, the split-and-merge decomposition of the
T = 1 kernel, the wrapper) against the JAX package, f32.

Tolerances: m, l and acc within 2e-5 of JAX's plain version and of its
Pallas kernel run in interpret mode (the same arithmetic summed in
another order by ATen's and XLA's CPU kernels); in the split-and-merge
cases, whose l sums several hundred probabilities to ~100, l within 2e-5
plus 1e-6 of its magnitude (f32 rounding of a sum that size); a row with
no live key, and a split with no live key, exactly m = -1e30, l = 0,
acc = 0. The CUDA
kernels are held against the plain versions on the card (marker `cuda`,
and chip_smoke.py's ring phase); here those tests skip without a card.
"""
import ast
import functools
import pathlib

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


# -- the T = 1 kernel's split-and-merge decomposition -------------------------

# (T, S, query start, holes): T = 1 over S not a multiple of the 256-key
# split, with INVALID_POS holes, a query that sees only the first split,
# and T > 1 (the plain version takes any T)
SPLIT_GEOMETRY = [(1, 300, 280, False), (1, 600, 590, True),
                  (1, 800, 100, False), (5, 530, 511, True)]


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("Tq,S,start,holes", SPLIT_GEOMETRY,
                         ids=["t1_ragged_split", "t1_holes",
                              "t1_dead_splits", "t5_holes"])
def test_split_ref_matches_jax(quant, Tq, S, start, holes):
    """ring_block_stats_split_ref (partials per split, merged in split
    order) against JAX's Pallas kernel in interpret mode and its plain
    version."""
    args = _inputs(quant, Tq, S, start, holes)
    got = T.ring_block_stats_split_ref(*map(torch.from_numpy, args))
    ref = J.ring_block_stats_ref(*map(jnp.asarray, args))
    kern = J.ring_block_stats(*map(jnp.asarray, args), block_q=8,
                              block_k=64, interpret=True)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
    for want in (kern, ref):
        _close(got[::2], want[::2])                     # m and acc
        np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]),
                                   atol=TOL, rtol=1e-6)  # l


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_split_ref_empty_rows_and_splits_are_exact(quant):
    """A split none of whose keys is live (past the query, or all
    INVALID_POS) is exactly the empty partial, and a row with nothing live
    in any split merges to exactly m = -1e30, l = 0, acc = 0."""
    args = [torch.from_numpy(a) for a in _inputs(quant, 1, 800, 300)]
    args[4][1, 256:512] = T.INVALID_POS       # row 1's second split
    _, (m, l, acc) = T.ring_block_stats_split_ref(*args,
                                                  return_partials=True)
    assert m.shape[0] == 4                     # splits of 256 over 800 keys
    assert (m[2:] == T.NEG_INF).all() and (l[2:] == 0).all() \
        and (acc[2:] == 0).all()               # keys 512.. > position 300
    assert (m[1, 1] == T.NEG_INF).all() and (l[1, 1] == 0).all() \
        and (acc[1, 1] == 0).all()
    assert (l[:2, 0] > 0).all() and (l[0, 1] > 0).all()
    args[3] = args[3] * 0 - 1                  # every query before key 0
    stats = T.ring_block_stats_split_ref(*args)
    assert (stats[0] == T.NEG_INF).all() and (stats[1] == 0).all() \
        and (stats[2] == 0).all()
    _close(stats, J.ring_block_stats_ref(*map(jnp.asarray,
                                              (a.numpy() for a in args))))


@pytest.mark.parametrize("S,want", [(0, (256, 1)), (1, (256, 1)),
                                    (256, (256, 1)), (257, (256, 2)),
                                    (2048, (256, 8)), (4095, (256, 16))])
def test_ring_split_plan_from_static_sizes(S, want):
    """The T = 1 grid comes from S alone: 256 keys a split, the splits
    covering [0, S) with a ragged last one."""
    assert T.ring_split_plan(S) == want
    split, n = T.ring_split_plan(S)
    assert T.SPLIT_KEYS == split and (n - 1) * split < max(S, 1) <= n * split


def test_wrapper_reads_nothing_back_from_the_card():
    """The T = 1 route is sized from S, not from the positions: no line
    of the module brings a tensor to the host (a sync per decode step
    would serialise generate_long's launches)."""
    src = pathlib.Path(T.__file__).read_text()
    calls = {n.func.attr for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert not calls & {"item", "cpu", "tolist", "numpy", "synchronize"}


# -- the kernels on the card --------------------------------------------------

def _card_inputs(B_, Tq, S, Nq, Kv, H_, q_pos, dt, quant, holes, seed):
    """Card tensors for ring_block_stats: q_pos [B_, Tq] as given, keys at
    0..S-1 (with `holes`, ~20% INVALID_POS over garbage K/V)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    dev = "cuda"
    q = torch.randn((B_, Tq, Nq, H_), generator=gen, device=dev).to(dt)
    kp = torch.arange(S, device=dev, dtype=torch.int32)[None].repeat(B_, 1)
    bad = torch.zeros((B_, S), dtype=torch.bool, device=dev)
    if holes:
        bad = torch.rand((B_, S), generator=gen, device=dev) < 0.2
        kp = torch.where(bad, torch.full_like(kp, T.INVALID_POS), kp)
    if quant:
        k, v = (torch.randint(-127, 128, (B_, Kv, S, H_), generator=gen,
                              device=dev, dtype=torch.int8)
                for _ in range(2))
        ks, vs = (torch.rand((B_, Kv, S), generator=gen, device=dev) * 0.02
                  for _ in range(2))
        return (q, k, v, q_pos, kp, ks, vs)
    k, v = (torch.randn((B_, S, Kv, H_), generator=gen, device=dev).to(dt)
            for _ in range(2))
    k[bad] = 30.0
    v[bad] = -30.0
    return (q, k, v, q_pos, kp, None, None)


def _card_check(args, got, want, f32):
    """Masked rows exact; m within 1e-3 (f32 1e-4); the finalised output
    within 2^-7 (|ref| + sum p|v| / l) per element (bf16: P enters P.V
    rounded to bf16, the output is compared unrounded), f32 1e-4."""
    m, l, acc = got
    m_r, l_r, acc_r = want
    dead = l_r == 0
    assert (m[dead] == T.NEG_INF).all() and (l[dead] == 0).all() \
        and (acc[dead] == 0).all()
    assert (l[~dead] > 0).all()
    assert (m - m_r).abs().max().item() <= (1e-4 if f32 else 1e-3)
    out = T.finalize_stats(got, torch.float32)
    ref = T.finalize_stats(want, torch.float32)
    diff = (out - ref).abs()
    if f32:
        assert diff.max().item() <= 1e-4
        return
    q, k, v, qp, kp, ks, vs = args
    absv = T.finalize_stats(T.ring_block_stats_ref(q, k, v.abs(), qp, kp, ks,
                                                   vs), torch.float32)
    bound = 2.0 ** -7 * (ref.abs() + absv)
    assert (diff <= bound).all(), (diff / bound.clamp_min(1e-30)).max().item()


# (B, S, Nq, Kv, H, query positions per row, dtype, int8, holes): one
# decode token per row. 2048 keys of Llama-3-8B's heads (8 splits); rows
# at different positions (one before every key: exactly empty; one that
# sees only its first split); S not a multiple of the split; GPT-2's heads
# (G = 1); f32 on the CUDA cores; G = 16 (two head groups of 8 a block)
CARD_T1 = [
    (1, 2048, 32, 8, 128, [3000], torch.bfloat16, False, False),
    (4, 2048, 32, 8, 128, [3000, 100, -1, 1300], torch.bfloat16, False,
     True),
    (2, 1000, 32, 8, 128, [999, 517], torch.bfloat16, True, True),
    (2, 300, 12, 12, 64, [299, 12], torch.bfloat16, False, False),
    (3, 777, 32, 8, 128, [800, 2, 500], torch.float32, False, True),
    (2, 513, 16, 4, 64, [600, 256], torch.float32, True, False),
    (1, 600, 32, 2, 64, [599], torch.bfloat16, False, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B_,S,Nq,Kv,H_,qpos,dt,quant,holes", CARD_T1)
def test_t1_kernel_matches_both_plain_versions_on_the_card(
        B_, S, Nq, Kv, H_, qpos, dt, quant, holes):
    """The T = 1 split kernel against ring_block_stats_ref and its
    split-and-merge plain version; the same bits on a relaunch; each call
    counted once in `launches` and in `launches_decode`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    qp = torch.tensor(qpos, dtype=torch.int32, device="cuda")[:, None]
    args = _card_inputs(B_, 1, S, Nq, Kv, H_, qp, dt, quant, holes, S + H_)
    n0, d0 = T.launches, T.launches_decode
    got = T.ring_block_stats(*args)
    again = T.ring_block_stats(*args)
    torch.cuda.synchronize()
    assert (T.launches, T.launches_decode) == (n0 + 2, d0 + 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    f32 = dt == torch.float32
    _card_check(args, got, T.ring_block_stats_ref(*args), f32)
    _card_check(args, got, T.ring_block_stats_split_ref(*args), f32)


# (T, S, q start, k start, H, int8, holes): the diagonal block (T not a
# multiple of the 128-row block), an earlier block, a block every query
# ignores (exactly empty), holes over garbage, int8 codes, GPT-2's heads
CARD_WG = [
    (1000, 1000, 0, 0, 128, False, False),
    (300, 700, 700, 0, 128, False, False),
    (256, 256, 0, 512, 128, False, False),
    (333, 900, 600, 0, 128, False, True),
    (500, 500, 0, 0, 128, True, True),
    (200, 260, 60, 0, 64, False, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("Tq,S,q0,k0,H_,quant,holes", CARD_WG)
def test_wgmma_kernel_matches_plain_on_the_card(Tq, S, q0, k0, H_, quant,
                                                holes):
    """The T > 1 bf16 warpgroup-MMA kernel against its plain version
    within the element bound; masked rows exact; the same bits on a
    relaunch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    Nq, Kv = (32, 8) if H_ == 128 else (12, 12)
    qp = torch.arange(q0, q0 + Tq, device="cuda",
                      dtype=torch.int32)[None].repeat(2, 1)
    args = list(_card_inputs(2, Tq, S, Nq, Kv, H_, qp, torch.bfloat16,
                             quant, holes, Tq + S))
    args[4] = args[4] + k0 * (args[4] != T.INVALID_POS)
    n0, d0 = T.launches, T.launches_decode
    got = T.ring_block_stats(*args)
    again = T.ring_block_stats(*args)
    torch.cuda.synchronize()
    assert (T.launches, T.launches_decode) == (n0 + 2, d0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _card_check(args, got, T.ring_block_stats_ref(*args), False)
