"""PyTorch port: speculative acceptance (engine/sampling.py
speculative_accept, speculative_tree_accept and the tree helpers) against
the JAX package.

Greedy rows are held token for token against the JAX kernels (and the
host _accept_drafts walk). Rows at temperature > 0 cannot match bits
(torch.Generator and jax.random draw different numbers), so the
acceptance law is held by its distribution, as tests/test_spec_sampling.py
holds the JAX kernel: N trials ride as N rows of one batched call, and
the empirical law must sit within a max deviation that a biased kernel
exceeds deterministically at that N.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butterfly_tpu.engine import sampling as JS
from butterfly_tpu_torch.engine import sampling as TS
from butterfly_tpu_torch.engine.engine import _accept_drafts

torch.set_num_threads(1)

V, GAMMA = 8, 3
TREE_W, TREE_N = 2, 5                 # width 2, 5 nodes: depth 2
TREE_D = (TREE_N - 1) // TREE_W


def _target(row, temp, top_k=0, top_p=1.0):
    """The distribution plain decode samples from at this position (the
    JAX filters)."""
    scaled = JS._filter_logits(jnp.asarray(row) / temp, top_k, top_p)
    return np.asarray(jax.nn.softmax(scaled))


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _tile(a, n):
    return torch.from_numpy(np.repeat(np.asarray(a), n, axis=0))


def _draw(logits, drafts, temp, n, top_k=0, top_p=1.0, seed=0,
          spec_mask=None):
    """n one-hot-proposal trials as n rows of one call."""
    mask = None if spec_mask is None else torch.full((n,), spec_mask)
    em, na = TS.speculative_accept(
        _tile(logits, n), _tile(drafts, n).to(torch.int32), _gen(seed),
        torch.full((n,), temp), top_k, top_p, mask)
    return em.numpy(), na.numpy()


def _draw_q(logits, q_logits, temp, n, top_k=0, top_p=1.0, seed=0,
            spec_mask=None):
    """Real-proposal trials: each row's drafts are SAMPLED from the
    filtered, scaled q (what the draft model does), then scored with
    the same q."""
    g = _gen(seed)
    scaled_q = TS._filter_logits(_tile(q_logits, n) / temp, top_k, top_p)
    drafts = TS.gumbel_argmax(scaled_q[:, :GAMMA], g)
    mask = None if spec_mask is None else torch.full((n,), spec_mask)
    em, na = TS.speculative_accept(
        _tile(logits, n), drafts, g, torch.full((n,), temp), top_k, top_p,
        mask, scaled_q[:, :GAMMA])
    return em.numpy(), na.numpy(), drafts.numpy()


def _draw_tree(logits, q_logits, temp, n, top_k=0, top_p=1.0, seed=0,
               spec_mask=None):
    """Tree trials: each depth's fan is TREE_W i.i.d. draws from the one
    shared q (tree_draft's stochastic rows)."""
    g = _gen(seed)
    scaled_q = TS._filter_logits(_tile(q_logits, n) / temp, top_k, top_p)
    fan_q = scaled_q[:, :, None, :].expand(n, TREE_D, TREE_W, V)
    drafts = TS.gumbel_argmax(fan_q.contiguous(), g)
    mask = None if spec_mask is None else torch.full((n,), spec_mask)
    em, na, perm = TS.speculative_tree_accept(
        _tile(logits, n), drafts, g, torch.full((n,), temp), top_k, top_p,
        mask, scaled_q, width=TREE_W, nodes=TREE_N)
    return em.numpy(), na.numpy(), perm.numpy()


def _emp(col, n=V):
    return np.bincount(col, minlength=n) / len(col)


# -- linear acceptance, one-hot proposals ------------------------------------------

@pytest.mark.parametrize("which", ["likely", "unlikely"])
def test_first_token_marginal_matches_target(which):
    """P(emitted[0] = x) = p_0(x) whatever the draft."""
    logits = np.random.RandomState(0).randn(1, GAMMA + 1, V) \
        .astype(np.float32) * 2.0
    d0 = int(np.argmax(logits[0, 0]) if which == "likely"
             else np.argmin(logits[0, 0]))
    em, _ = _draw(logits, [[d0, 1, 5]], 0.7, 20000)
    assert np.abs(_emp(em[:, 0]) - _target(logits[0, 0], 0.7)).max() < 0.015


def test_second_token_conditional_matches_target():
    """Given the first draft accepted, emitted[1] ~ p_1."""
    logits = np.random.RandomState(1).randn(1, GAMMA + 1, V) \
        .astype(np.float32) * 2.0
    d0 = int(np.argmax(logits[0, 0]))
    em, na = _draw(logits, [[d0, 2, 6]], 0.8, 30000)
    sel = na >= 1
    assert sel.sum() > 5000
    assert np.abs(_emp(em[sel, 1]) - _target(logits[0, 1], 0.8)).max() < 0.02


def test_acceptance_probability_is_p_of_draft():
    """P(n_acc >= 1) = p_0(d_1): min(1, p/q) with a one-hot q."""
    logits = np.random.RandomState(2).randn(1, GAMMA + 1, V) \
        .astype(np.float32) * 2.0
    _, na = _draw(logits, [[3, 0, 0]], 1.0, 20000)
    assert abs((na >= 1).mean() - _target(logits[0, 0], 1.0)[3]) < 0.015


@pytest.mark.parametrize("top_k,top_p", [(3, 1.0), (0, 0.6)],
                         ids=["top_k", "top_p"])
def test_filters_respected(top_k, top_p):
    """The filters apply to acceptance AND resampling: a draft outside
    the nucleus is never accepted, and nothing outside it is emitted."""
    logits = np.random.RandomState(3).randn(1, GAMMA + 1, V) \
        .astype(np.float32) * 2.0
    tgt = _target(logits[0, 0], 0.9, top_k, top_p)
    outside = int(np.argsort(logits[0, 0])[0])
    assert tgt[outside] == 0
    em, na = _draw(logits, [[outside, 0, 0]], 0.9, 4000, top_k, top_p)
    assert (na == 0).all()
    assert set(em[:, 0].tolist()) <= set(np.flatnonzero(tgt > 0).tolist())
    assert np.abs(_emp(em[:, 0]) - tgt).max() < 0.03


def test_greedy_rows_match_jax_and_accept_drafts():
    """temp-0 rows: the host _accept_drafts walk and the JAX kernel, token
    for token, for every accept count."""
    rng = np.random.RandomState(4)
    S = 64
    logits = rng.randn(S, GAMMA + 1, V).astype(np.float32) * 2.0
    greedy = logits.argmax(-1)
    drafts = rng.randint(0, V, (S, GAMMA))
    # plant accepted prefixes of every length
    for i in range(S):
        k = i % (GAMMA + 1)
        drafts[i, :k] = greedy[i, :k]
    em, na = TS.speculative_accept(
        torch.from_numpy(logits), torch.from_numpy(drafts).to(torch.int32),
        _gen(0), torch.zeros(S), 0, 1.0)
    jem, jna = JS.speculative_accept(
        jnp.asarray(logits), jnp.asarray(drafts, jnp.int32),
        jax.random.PRNGKey(0), jnp.zeros((S,), jnp.float32), 0, 1.0)
    assert na.tolist() == np.asarray(jna).tolist()
    for i in range(S):
        n = int(na[i]) + 1
        assert em[i, :n].tolist() == np.asarray(jem)[i, :n].tolist()
        assert em[i, :n].tolist() == _accept_drafts(drafts[i].tolist(),
                                                    greedy[i])
    assert sorted(set(na.tolist())) == list(range(GAMMA + 1))


def test_opt_out_rows_sample_full_distribution():
    """spec_mask False: no acceptance, one draw from the FULL target (no
    residual bias against the draft, here the mode)."""
    logits = np.random.RandomState(5).randn(1, GAMMA + 1, V) \
        .astype(np.float32) * 2.0
    d0 = int(np.argmax(logits[0, 0]))
    em, na = _draw(logits, [[d0, 0, 0]], 0.7, 20000, spec_mask=False)
    assert (na == 0).all()
    assert np.abs(_emp(em[:, 0]) - _target(logits[0, 0], 0.7)).max() < 0.015


# -- linear acceptance, real proposals --------------------------------------------

def test_real_q_first_token_marginal_matches_target():
    rng = np.random.RandomState(10)
    logits = rng.randn(1, GAMMA + 1, V).astype(np.float32) * 2.0
    q = rng.randn(1, GAMMA + 1, V).astype(np.float32) * 2.0
    em, _, _ = _draw_q(logits, q, 0.7, 20000)
    assert np.abs(_emp(em[:, 0]) - _target(logits[0, 0], 0.7)).max() < 0.015


def test_real_q_joint_two_position_law():
    """Given the first draft accepted, emitted[1] ~ p_1 under a real q
    close to p (so acceptance is frequent)."""
    rng = np.random.RandomState(11)
    logits = rng.randn(1, GAMMA + 1, V).astype(np.float32) * 2.0
    q = logits + rng.randn(1, GAMMA + 1, V).astype(np.float32) * 0.3
    em, na, _ = _draw_q(logits, q, 0.8, 30000, seed=1)
    sel = na >= 1
    assert sel.sum() > 5000
    assert np.abs(_emp(em[sel, 1]) - _target(logits[0, 1], 0.8)).max() < 0.02


def test_real_q_acceptance_rate_is_expected_min_ratio():
    """P(n_acc >= 1) = sum_x q(x) min(1, p(x)/q(x))."""
    rng = np.random.RandomState(12)
    logits = rng.randn(1, GAMMA + 1, V).astype(np.float32) * 2.0
    q = rng.randn(1, GAMMA + 1, V).astype(np.float32) * 2.0
    _, na, _ = _draw_q(logits, q, 1.0, 20000, seed=2)
    p0 = _target(logits[0, 0], 1.0).astype(np.float64)
    q0 = _target(q[0, 0], 1.0).astype(np.float64)
    want = float(np.sum(np.minimum(p0, q0)))
    assert abs((na >= 1).mean() - want) < 0.015


def test_real_q_greedy_rows_ignore_q():
    """temp-0 rows take the argmax semantics whatever q says: token for
    token the JAX kernel's."""
    rng = np.random.RandomState(13)
    S = 32
    logits = rng.randn(S, GAMMA + 1, V).astype(np.float32) * 2.0
    q = rng.randn(S, GAMMA, V).astype(np.float32) * 2.0
    drafts = np.where(rng.rand(S, GAMMA) < 0.5, logits[:, :GAMMA].argmax(-1),
                      rng.randint(0, V, (S, GAMMA)))
    em, na = TS.speculative_accept(
        torch.from_numpy(logits), torch.from_numpy(drafts).to(torch.int32),
        _gen(1), torch.zeros(S), 0, 1.0, None, torch.from_numpy(q))
    jem, jna = JS.speculative_accept(
        jnp.asarray(logits), jnp.asarray(drafts, jnp.int32),
        jax.random.PRNGKey(1), jnp.zeros((S,), jnp.float32), 0, 1.0, None,
        jnp.asarray(q))
    assert na.tolist() == np.asarray(jna).tolist()
    for i in range(S):
        n = int(na[i]) + 1
        assert em[i, :n].tolist() == np.asarray(jem)[i, :n].tolist()


def test_real_q_opt_out_rows_sample_full_distribution():
    rng = np.random.RandomState(14)
    logits = rng.randn(1, GAMMA + 1, V).astype(np.float32) * 2.0
    em, na, _ = _draw_q(logits, logits, 0.7, 20000, seed=3,
                        spec_mask=False)
    assert (na == 0).all()
    assert np.abs(_emp(em[:, 0]) - _target(logits[0, 0], 0.7)).max() < 0.015


# -- token trees ---------------------------------------------------------------------

def test_tree_helpers_match_jax():
    for w, n in ((1, 2), (2, 5), (2, 9), (3, 7), (4, 9)):
        assert TS.tree_depth(w, n) == JS.tree_depth(w, n)
        np.testing.assert_array_equal(TS.tree_ancestor_matrix(w, n),
                                      JS.tree_ancestor_matrix(w, n))
        for d in range(TS.tree_depth(w, n) + 1):
            assert TS.tree_principal(d, w) == JS.tree_principal(d, w)
            for j in range(w if d else 0):
                assert TS.tree_node_index(d, j, w) == \
                    JS.tree_node_index(d, j, w)


def test_tree_first_token_marginal_matches_target():
    rng = np.random.RandomState(20)
    logits = rng.randn(1, TREE_N, V).astype(np.float32) * 2.0
    q = rng.randn(1, TREE_D, V).astype(np.float32) * 2.0
    em, _, _ = _draw_tree(logits, q, 0.7, 20000)
    assert np.abs(_emp(em[:, 0]) - _target(logits[0, 0], 0.7)).max() < 0.015


def test_tree_acceptance_mass_recursive_residual():
    """P(n_acc >= 1) = 1 - prod_j (1 - beta_j) under the recursive
    residual r_0 = p, r_{j+1} = norm((r_j - q)+)."""
    rng = np.random.RandomState(21)
    logits = rng.randn(1, TREE_N, V).astype(np.float32) * 2.0
    q = rng.randn(1, TREE_D, V).astype(np.float32) * 2.0
    _, na, _ = _draw_tree(logits, q, 1.0, 20000, seed=3)
    p = _target(logits[0, 0], 1.0).astype(np.float64)
    qq = _target(q[0, 0], 1.0).astype(np.float64)
    r, miss = p.copy(), 1.0
    for _ in range(TREE_W):
        miss *= 1.0 - float(np.sum(qq * np.minimum(
            1.0, r / np.maximum(qq, 1e-30))))
        r_next = np.maximum(r - qq, 0.0)
        if r_next.sum() > 0:
            r = r_next / r_next.sum()
    assert abs((na >= 1).mean() - (1.0 - miss)) < 0.015


def test_tree_depth2_conditional_matches_target():
    """Given the depth-1 PRINCIPAL accepted, emitted[1] ~ the target at
    the principal node."""
    rng = np.random.RandomState(22)
    logits = rng.randn(1, TREE_N, V).astype(np.float32) * 2.0
    q = logits[:, :1].repeat(TREE_D, axis=1) \
        + rng.randn(1, TREE_D, V).astype(np.float32) * 0.3
    em, na, perm = _draw_tree(logits, q, 0.8, 30000, seed=4)
    pn1 = TS.tree_node_index(1, 0, TREE_W)
    sel = (na >= 1) & (perm[:, 1] == pn1)
    assert sel.sum() > 5000
    assert np.abs(_emp(em[sel, 1]) - _target(logits[0, pn1], 0.8)).max() \
        < 0.02


def test_tree_greedy_rows_match_jax():
    """temp-0 rows: emitted, n_acc and perm token for token the JAX
    kernel's, over fans that hit the principal, a sibling, or nothing."""
    rng = np.random.RandomState(23)
    S = 64
    logits = rng.randn(S, TREE_N, V).astype(np.float32) * 2.0
    greedy = logits.argmax(-1)
    drafts = rng.randint(0, V, (S, TREE_D, TREE_W))
    for i in range(S):       # plant hits on the principal or the sibling
        if i % 3:
            drafts[i, 0, i % 2] = greedy[i, 0]
        if i % 5 == 0:
            drafts[i, 1, 0] = greedy[i, 1]
    q = rng.randn(S, TREE_D, V).astype(np.float32)
    em, na, perm = TS.speculative_tree_accept(
        torch.from_numpy(logits), torch.from_numpy(drafts).to(torch.int32),
        _gen(0), torch.zeros(S), 0, 1.0, None, torch.from_numpy(q),
        width=TREE_W, nodes=TREE_N)
    jem, jna, jperm = JS.speculative_tree_accept(
        jnp.asarray(logits), jnp.asarray(drafts, jnp.int32),
        jax.random.PRNGKey(0), jnp.zeros((S,), jnp.float32), 0, 1.0, None,
        jnp.asarray(q), width=TREE_W, nodes=TREE_N)
    assert na.tolist() == np.asarray(jna).tolist()
    for i in range(S):
        n = int(na[i]) + 1
        assert em[i, :n].tolist() == np.asarray(jem)[i, :n].tolist()
        assert perm[i, :n].tolist() == np.asarray(jperm)[i, :n].tolist()
    assert len(set(na.tolist())) == TREE_D + 1


def test_tree_opt_out_rows_sample_full_distribution():
    rng = np.random.RandomState(24)
    logits = rng.randn(1, TREE_N, V).astype(np.float32) * 2.0
    q = rng.randn(1, TREE_D, V).astype(np.float32) * 2.0
    em, na, _ = _draw_tree(logits, q, 0.7, 20000, seed=5, spec_mask=False)
    assert (na == 0).all()
    assert np.abs(_emp(em[:, 0]) - _target(logits[0, 0], 0.7)).max() < 0.015
