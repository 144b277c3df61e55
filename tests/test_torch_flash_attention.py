"""PyTorch port: flash attention's plain version (what the wrapper runs on
CPU tensors) against the JAX package's Pallas kernels, which run in
interpret mode off-TPU. f32 at 2e-5: the two sum over at most a few dozen
keys in different orders (blockwise online softmax vs one softmax)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butterfly_tpu.models.common import quantize_kv as jax_quantize
from butterfly_tpu.ops.flash_attention import flash_attention as jax_fa
from butterfly_tpu_torch.ops.flash_attention import (FRESH_BQ,
                                                     flash_attention,
                                                     flash_attention_ref,
                                                     fresh_block_order,
                                                     warm_block_order)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls

TOL = 2e-5


def _qkv(seed, B, T, Nq, Kv, H):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, T, Nq, H), (B, T, Kv, H), (B, T, Kv, H)))


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a))
            for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


FRESH = [  # (name, B, T, Nq, Kv, H, causal)
    ("causal", 2, 16, 4, 4, 16, True),
    ("non_causal", 2, 16, 4, 4, 16, False),
    ("gqa", 2, 24, 8, 2, 16, True),
    ("ragged_T", 3, 13, 4, 2, 32, True),
    ("ragged_non_causal", 1, 21, 4, 1, 16, False),
    ("one_token", 2, 1, 4, 2, 16, True),
]


@pytest.mark.parametrize("name,B,T,Nq,Kv,H,causal", FRESH,
                         ids=[f[0] for f in FRESH])
def test_fresh_matches_jax(name, B, T, Nq, Kv, H, causal):
    q, k, v = _qkv(1, B, T, Nq, Kv, H)
    want = jax_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal)
    got = flash_attention_ref(*_t(q, k, v), causal=causal)
    assert got.shape == (B, T, Nq, H) and got.dtype == torch.float32
    _close(got, want)


def _prefix(seed, B, Sp, Kv, H, plen, garbage=True):
    rng = np.random.default_rng(seed)
    pk = rng.standard_normal((B, Sp, Kv, H)).astype(np.float32)
    pv = rng.standard_normal((B, Sp, Kv, H)).astype(np.float32)
    if garbage:
        # large finite garbage past each row's live count: a kernel that
        # reads past prefix_len moves the output far beyond TOL
        for b, n in enumerate(plen):
            pk[b, n:] = 1e3
            pv[b, n:] = -1e3
    return pk, pv


WARM = [  # (name, T, Sp, prefix_len per row)
    ("aligned", 16, 32, [0, 32, 8]),
    ("ragged", 13, 40, [0, 17, 39]),
    ("single_token_chunk", 1, 24, [5, 0, 24]),
]


@pytest.mark.parametrize("name,T,Sp,plen", WARM, ids=[w[0] for w in WARM])
def test_warm_float_prefix_matches_jax(name, T, Sp, plen):
    B, Nq, Kv, H = 3, 4, 2, 16
    q, k, v = _qkv(2, B, T, Nq, Kv, H)
    pk, pv = _prefix(3, B, Sp, Kv, H, plen)
    pl = np.asarray(plen, np.int32)
    want = jax_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  prefix_k=jnp.asarray(pk), prefix_v=jnp.asarray(pv),
                  prefix_len=jnp.asarray(pl))
    got = flash_attention_ref(*_t(q, k, v), True, *_t(pk, pv, pl))
    _close(got, want)


@pytest.mark.parametrize("name,T,Sp,plen", WARM, ids=[w[0] for w in WARM])
def test_warm_int8_prefix_matches_jax(name, T, Sp, plen):
    B, Nq, Kv, H = 3, 4, 2, 16
    q, k, v = _qkv(4, B, T, Nq, Kv, H)
    pk, pv = _prefix(5, B, Sp, Kv, H, plen, garbage=False)
    # the int8 pool representation: kv-major codes + per-vector scales
    kq, ks = jax_quantize(jnp.asarray(pk).transpose(0, 2, 1, 3))
    vq, vs = jax_quantize(jnp.asarray(pv).transpose(0, 2, 1, 3))
    pl = np.asarray(plen, np.int32)
    want = jax_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  prefix_k=kq, prefix_v=vq, prefix_len=jnp.asarray(pl),
                  prefix_k_scale=ks, prefix_v_scale=vs)
    got = flash_attention_ref(*_t(q, k, v), True,
                              *_t(kq, vq, pl, ks, vs))
    _close(got, want)


def test_prefix_of_zero_equals_fresh():
    q, k, v = _t(*_qkv(6, 2, 12, 4, 2, 16))
    pk = torch.full((2, 8, 2, 16), 7.0)
    got = flash_attention_ref(q, k, v, True, pk, pk,
                              torch.zeros(2, dtype=torch.int32))
    assert torch.equal(got, flash_attention_ref(q, k, v, True))


def test_warm_prefix_must_be_causal():
    q, k, v = _t(*_qkv(7, 1, 4, 2, 2, 16))
    pk = torch.zeros((1, 4, 2, 16))
    plen = torch.zeros(1, dtype=torch.int32)
    for fn in (flash_attention, flash_attention_ref):
        with pytest.raises(ValueError, match="causal-only"):
            fn(q, k, v, False, pk, pk, plen)
    with pytest.raises(ValueError, match="causal-only"):
        jax_fa(*(jnp.asarray(a.numpy()) for a in (q, k, v)), causal=False,
               prefix_k=jnp.asarray(pk.numpy()),
               prefix_v=jnp.asarray(pk.numpy()),
               prefix_len=jnp.asarray(plen.numpy()))


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    q, k, v = _t(*_qkv(8, 2, 10, 4, 2, 16))
    pk, pv = _t(*_prefix(9, 2, 12, 2, 16, [3, 12]))
    plen = torch.tensor([3, 12], dtype=torch.int32)
    before = (flash_attention.launches_fresh, flash_attention.launches_warm)
    assert torch.equal(flash_attention(q, k, v),
                       flash_attention_ref(q, k, v))
    assert torch.equal(flash_attention(q, k, v, True, pk, pv, plen),
                       flash_attention_ref(q, k, v, True, pk, pv, plen))
    assert (flash_attention.launches_fresh,
            flash_attention.launches_warm) == before


def test_bf16_output_keeps_q_dtype():
    q, k, v = (t.to(torch.bfloat16) for t in _t(*_qkv(10, 1, 9, 4, 2, 16)))
    out = flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    ref32 = flash_attention_ref(q.float(), k.float(), v.float())
    assert (out.float() - ref32).abs().max().item() < 2e-2


@pytest.mark.parametrize("B,T,Nq,Kv,causal", [(4, 1024, 32, 8, True),
                                               (2, 1000, 12, 12, False),
                                               (1, 1, 4, 2, True),
                                               (3, 129, 8, 2, True)])
def test_fresh_block_order(B, T, Nq, Kv, causal):
    """The fresh wgmma kernel's launch order: every (batch row, query
    tile, head) once; a kv group's heads in adjacent blocks; causal query
    tiles from the heaviest (last) down."""
    order = fresh_block_order(B, T, Nq, causal)
    ntiles = -(-T // FRESH_BQ)
    assert sorted(order) == [(b, i, n) for b in range(B)
                             for i in range(ntiles) for n in range(Nq)]
    G = Nq // Kv
    for i in range(0, len(order), G):   # each run of G blocks: one kv head
        group = order[i:i + G]
        assert len({(b, t, n // G) for b, t, n in group}) == 1
    tiles = [t for b, t, n in order if b == 0 and n == 0]
    assert tiles == (sorted(tiles, reverse=True) if causal else sorted(tiles))
    if causal:   # work per block (live keys) never rises along the launch
        work = [min(T, (t + 1) * FRESH_BQ) for b, t, n in order if b == 0]
        assert work == sorted(work, reverse=True)


# (B, T, Nq, Kv, H, causal, dtype): bf16 / f16 at H = 64 and 128 take the
# wgmma kernel, H = 32 the mma.sync one, f32 the CUDA-core one
CARD_FRESH = [
    (2, 1024, 32, 8, 128, True, torch.bfloat16),
    (2, 1000, 32, 8, 128, True, torch.bfloat16),
    (2, 512, 32, 8, 128, False, torch.bfloat16),
    (2, 700, 12, 12, 64, True, torch.bfloat16),
    (1, 300, 12, 12, 64, False, torch.float16),
    (2, 257, 8, 2, 128, True, torch.float16),
    (3, 1, 8, 2, 128, True, torch.bfloat16),
    (2, 100, 8, 2, 32, True, torch.bfloat16),
    (2, 130, 8, 2, 64, True, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,Nq,Kv,H,causal,dt", CARD_FRESH)
def test_fresh_kernel_matches_plain_on_the_card(B, T, Nq, Kv, H, causal, dt):
    """The fresh sm_90a kernel against its plain version: bf16 / f16
    outputs within 2e-2 and each element within 2^-7 (|ref| + sum p|v|/l)
    (the output rounded on both sides, P rounded to bf16 for P.V); f32 at
    1e-4. The same bits on a second launch; one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (torch.from_numpy(a).cuda().to(dt)
               for a in _qkv(T + H, B, T, Nq, Kv, H))
    n0 = flash_attention.launches_fresh
    out = flash_attention(q, k, v, causal)
    again = flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches_fresh == n0 + 2
    assert torch.equal(out, again)
    ref = flash_attention_ref(q, k, v, causal).float()
    diff = (out.float() - ref).abs()
    assert torch.isfinite(out.float()).all()
    if dt == torch.float32:
        assert diff.max().item() <= 1e-4
        return
    assert diff.max().item() <= 2e-2
    absv = flash_attention_ref(q, k, v.abs(), causal).float()
    bound = 2.0 ** -7 * (ref.abs() + absv)
    assert (diff <= bound).all(), (diff / bound).max().item()


@pytest.mark.parametrize("plen,T,Nq,Sp", [([0, 17, 512, 1536], 512, 32, 2048),
                                         ([5, 5, 0, 5], 200, 4, 64),
                                         ([-3, 900, 40], 129, 2, 512),
                                         ([7], 1, 3, 8)])
def test_warm_block_order(plen, T, Nq, Sp):
    """The warm wgmma kernel's launch order against a brute-force ranking:
    every (batch row, query tile, head) once; rows by prefix_len clamped
    to [0, Sp], longest first, ties by row; each row's tiles last to
    first; a kv group's heads adjacent."""
    order = warm_block_order(plen, T, Nq, Sp)
    ntiles = -(-T // FRESH_BQ)
    B = len(plen)
    assert sorted(order) == [(b, i, n) for b in range(B)
                             for i in range(ntiles) for n in range(Nq)]
    clamped = [min(max(p, 0), Sp) for p in plen]
    rank = [sum(clamped[o] > clamped[b] or (clamped[o] == clamped[b]
                                            and o < b) for o in range(B))
            for b in range(B)]
    per_row = ntiles * Nq
    for i, (b, t, n) in enumerate(order):
        assert rank[b] == i // per_row
        assert t == ntiles - 1 - (i % per_row) // Nq and n == i % Nq


def _warm_card(B, T, Nq, Kv, H, Sp, plen, dt, prefix, seed):
    """Card inputs of a warm call: q/k/v, and a prefix as a strided view
    of a larger pool (float) or int8 codes + scales, with large garbage
    past each row's prefix_len."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    dev = "cuda"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)
    q, k, v = randn(B, T, Nq, H), randn(B, T, Kv, H), randn(B, T, Kv, H)
    kw = {"prefix_len": torch.tensor(plen, dtype=torch.int32, device=dev)}
    if prefix == "float":
        # a view with strides of its own: every other kv head of a wider
        # pool, rows padded, as a gathered pool view can be
        pool_k, pool_v = randn(B, Sp + 8, 2 * Kv, H), randn(B, Sp + 8, 2 * Kv,
                                                            H)
        pk, pv = pool_k[:, :Sp, ::2], pool_v[:, :Sp, ::2]
        for b, n in enumerate(plen):
            pk[b, max(n, 0):] = 30.0
            pv[b, max(n, 0):] = -30.0
        kw.update(prefix_k=pk, prefix_v=pv)
    else:
        shape = (B, Kv, Sp, H)
        pk, pv = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(shape[:-1], generator=gen, device=dev) * 0.02
                  for _ in range(2))
        for b, n in enumerate(plen):
            ks[b, :, max(n, 0):] = 1.0
            vs[b, :, max(n, 0):] = 1.0
        kw.update(prefix_k=pk, prefix_v=pv, prefix_k_scale=ks,
                  prefix_v_scale=vs)
    return q, k, v, kw


# (B, T, Nq, Kv, H, Sp, prefix_len, dtype, prefix): bf16 / f16 at H = 64
# and 128 take the wgmma kernel: Llama-3-8B's heads over a ragged prefix
# (incl. 0 and the whole prefix), int8 codes, GPT-2's heads, f16, a
# prefix of 0 everywhere, T not a multiple of the 128-row block
CARD_WARM = [
    (4, 512, 32, 8, 128, 2048, [0, 17, 512, 1536], torch.bfloat16, "float"),
    (3, 300, 32, 8, 128, 700, [700, 0, 63], torch.bfloat16, "int8"),
    (2, 200, 12, 12, 64, 300, [65, 300], torch.bfloat16, "float"),
    (2, 129, 8, 2, 128, 256, [1, 255], torch.float16, "float"),
    (2, 64, 8, 2, 64, 128, [0, 0], torch.bfloat16, "int8"),
    (1, 1, 8, 2, 128, 100, [99], torch.bfloat16, "float"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,Nq,Kv,H,Sp,plen,dt,prefix", CARD_WARM)
def test_warm_kernel_matches_plain_on_the_card(B, T, Nq, Kv, H, Sp, plen, dt,
                                               prefix):
    """The warm wgmma kernel against its plain version, each element
    within 2^-7 (|ref| + sum p|v| / l) and 2e-2 overall; garbage past
    prefix_len never reaches the output; the same bits on a relaunch; one
    launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, kw = _warm_card(B, T, Nq, Kv, H, Sp, plen, dt, prefix, T + Sp)
    n0 = flash_attention.launches_warm
    out = flash_attention(q, k, v, True, **kw)
    again = flash_attention(q, k, v, True, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches_warm == n0 + 2
    assert torch.equal(out, again)
    ref = flash_attention_ref(q, k, v, True, **kw).float()
    diff = (out.float() - ref).abs()
    assert torch.isfinite(out.float()).all()
    assert diff.max().item() <= 2e-2
    kw_abs = dict(kw, prefix_v=kw["prefix_v"].abs())
    absv = flash_attention_ref(q, k, v.abs(), True, **kw_abs).float()
    bound = 2.0 ** -7 * (ref.abs() + absv)
    assert (diff <= bound).all(), (diff / bound).max().item()
