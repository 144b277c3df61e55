"""PyTorch port: paged decode attention's plain version (what the wrapper
runs on CPU tensors) against the JAX package's Pallas kernel, which runs
in interpret mode off-TPU. f32 at 2e-5, the tolerance of
tests/test_kernels.py's paged-attention checks: the two sum in different
orders over at most a few hundred keys."""
import jax
import numpy as np
import pytest
import torch

from butterfly_tpu.ops.paged_attention import paged_attention as jax_pa
from butterfly_tpu_torch.ops.paged_attention import (paged_attention,
                                                     paged_attention_ref)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls

TOL = 2e-5
S, NQ, KV, H, PAGE, MP = 4, 4, 2, 16, 4, 6


def _inputs(seed, quant=False, window=0, empty=False, garbage=False,
            null_tail=True):
    rng = np.random.default_rng(seed)
    P = S * MP + 1
    q = rng.standard_normal((S, NQ, H)).astype(np.float32)
    if quant:
        kp = rng.integers(-127, 128, (P, KV, PAGE, H)).astype(np.int8)
        vp = rng.integers(-127, 128, (P, KV, PAGE, H)).astype(np.int8)
        ks = (rng.random((P, KV * PAGE)) * 0.02).astype(np.float32)
        vs = (rng.random((P, KV * PAGE)) * 0.02).astype(np.float32)
    else:
        kp = rng.standard_normal((P, KV, PAGE, H)).astype(np.float32)
        vp = rng.standard_normal((P, KV, PAGE, H)).astype(np.float32)
        ks = vs = None
    lengths = np.array([9, 1, MP * PAGE, 14], np.int32)
    if empty:
        lengths[1] = 0
    # distinct pages per slot; the unused tail points at the null page
    perm = rng.permutation(P - 1).astype(np.int32)
    table = np.full((S, MP), P - 1, np.int32)
    for s in range(S):
        n = -(-int(lengths[s]) // PAGE) if null_tail else MP
        table[s, :n] = perm[s * MP:s * MP + n]
    if garbage:
        # large finite values at every position past each slot's length
        for s in range(S):
            for j in range(MP):
                for t in range(PAGE):
                    if j * PAGE + t >= lengths[s] and table[s, j] != P - 1:
                        pid = table[s, j]
                        if quant:
                            kp[pid, :, t] = 127
                            vp[pid, :, t] = 127
                            ks[pid, np.arange(KV) * PAGE + t] = 1e4
                        else:
                            kp[pid, :, t] = 1e4
                            vp[pid, :, t] = 1e4
    win = {}
    if window:
        W = window
        shape = (S, KV, W, H)
        if quant:
            win["win_k"] = rng.integers(-127, 128, shape).astype(np.int8)
            win["win_v"] = rng.integers(-127, 128, shape).astype(np.int8)
            win["win_k_scale"] = (rng.random(shape[:-1]) * 0.02) \
                .astype(np.float32)
            win["win_v_scale"] = (rng.random(shape[:-1]) * 0.02) \
                .astype(np.float32)
        else:
            win["win_k"] = rng.standard_normal(shape).astype(np.float32)
            win["win_v"] = rng.standard_normal(shape).astype(np.float32)
        wc = np.array([2, 0 if empty else 1, W, 3 % (W + 1)], np.int32)
        win["win_count"] = wc
        if garbage:
            for s in range(S):
                for key in ("win_k", "win_v"):
                    win[key][s, :, wc[s]:] = 127 if quant else 1e4
    return (q, kp, vp, table, lengths, ks, vs), win


CASES = {
    "float": dict(),
    "int8": dict(quant=True),
    "window_float": dict(window=5),
    "window_int8": dict(quant=True, window=5),
    "empty_slot": dict(empty=True),
    "empty_slot_window": dict(empty=True, window=3),
    "garbage_past_lengths": dict(garbage=True, window=4),
    "garbage_past_lengths_int8": dict(quant=True, garbage=True, window=4),
    "null_page_tables": dict(null_tail=True),
    "full_tables": dict(null_tail=False, window=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_jax_kernel(case):
    kw = CASES[case]
    args, win = _inputs(sorted(CASES).index(case), **kw)
    want = np.asarray(jax_pa(*args, **win))
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    twin = {k: torch.from_numpy(v) for k, v in win.items()}
    got = paged_attention(*targs, **twin)        # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (S, NQ, H)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    assert np.isfinite(got.numpy()).all()
    if kw.get("empty"):
        # nothing to attend: exactly zero, never NaN
        assert (got[1] == 0).all()
    if kw.get("garbage"):
        assert np.abs(got.numpy()).max() < 100.0
    # the wrapper's CPU branch IS the plain version
    ref = paged_attention_ref(*targs, **twin)
    assert torch.equal(got, ref)


def test_cpu_wrapper_launches_no_kernel():
    args, win = _inputs(3, window=2)
    before = paged_attention.launches
    paged_attention(*[None if a is None else torch.from_numpy(a)
                      for a in args],
                    **{k: torch.from_numpy(v) for k, v in win.items()})
    assert paged_attention.launches == before


def test_bf16_plain_version_close_to_jax():
    """bf16 q and pools: both sides accumulate in f32 and round the
    output to bf16, so they agree to bf16 resolution (2e-2, the bf16
    tolerance of tests/test_kernels.py)."""
    args, win = _inputs(5, window=3)
    jargs = [None if a is None else jax.numpy.asarray(a) for a in args]
    jargs[:3] = [a.astype(jax.numpy.bfloat16) for a in jargs[:3]]
    jwin = {k: (jax.numpy.asarray(v).astype(jax.numpy.bfloat16)
                if v.dtype == np.float32 else v) for k, v in win.items()}
    want = np.asarray(jax_pa(*jargs, **jwin).astype(jax.numpy.float32))
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    targs[:3] = [a.to(torch.bfloat16) for a in targs[:3]]
    twin = {k: (torch.from_numpy(v).to(torch.bfloat16)
                if v.dtype == np.float32 else torch.from_numpy(v))
            for k, v in win.items()}
    got = paged_attention(*targs, **twin)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=0)
