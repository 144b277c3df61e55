"""Token samplers: greedy, temperature, top-k, top-p.

The counterparts of butterfly_tpu/engine/sampling.py: `SamplingParams`,
`sample`, the logit filters, speculative acceptance (`speculative_accept`,
linear drafts) and token-tree acceptance (`speculative_tree_accept` with
its numpy tree helpers). A sampled draw is Gumbel-max over the filtered,
temperature-scaled logits with uniforms from a `torch.Generator` on the
logits' device — the categorical draw jax.random.categorical makes, from
other random bits — so sampling never syncs with the host. Where the JAX
functions split a key into an accept-uniform key and a resample key, the
port draws both from the one generator it is given, in that order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0   # 0 => greedy
    top_k: int = 0             # 0 => disabled
    top_p: float = 1.0         # 1.0 => disabled
    max_new_tokens: int = 128
    stop_token: int = -1       # -1 => none

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0


def _apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
    return torch.where(logits < kth, torch.full_like(logits, -float("inf")),
                       logits)


def _apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens until cumulative prob exceeds p (always keep the first)
    inf = torch.full_like(sorted_logits, float("inf"))
    cutoff = torch.where(cum - probs > p, -inf, sorted_logits)
    threshold = torch.where(torch.isfinite(cutoff), cutoff, inf) \
        .amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, -inf, logits)


def _filter_logits(scaled: torch.Tensor, top_k: int,
                   top_p: float) -> torch.Tensor:
    """The temperature-scaled logits after the static top-k/top-p
    filters."""
    if top_k > 0:
        scaled = _apply_top_k(scaled, top_k)
    if top_p < 1.0:
        scaled = _apply_top_p(scaled, top_p)
    return scaled


def gumbel_argmax(scaled: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """One categorical draw per row of softmax(scaled) [..., V] -> [...]
    int32, by Gumbel-max with uniforms from `generator`."""
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    return torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1) \
        .to(torch.int32)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           sp: SamplingParams) -> torch.Tensor:
    """logits [B,V] float32 -> token ids [B] int32: argmax when greedy,
    else a draw from the temperature-scaled, top-k/top-p filtered
    distribution."""
    if sp.is_greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = _filter_logits(logits / sp.temperature, sp.top_k, sp.top_p)
    return gumbel_argmax(scaled, generator)


def speculative_accept(logits: torch.Tensor, drafts: torch.Tensor,
                       generator: Optional[torch.Generator],
                       temps: torch.Tensor, top_k: int, top_p: float,
                       spec_mask: Optional[torch.Tensor] = None,
                       q_logits: Optional[torch.Tensor] = None):
    """Batched draft acceptance with the rejection-sampling correction
    (Leviathan et al. 2023), for one-hot OR real proposals.

    logits [S, C, V] are a verify forward's per-position target logits
    (C = gamma + 1); drafts [S, gamma]; temps [S] (0 = greedy row).
    The target p_i is the filtered, temperature-scaled distribution
    plain decode samples from. q_logits None: the proposal is a point
    mass at the draft, so d_i is accepted with probability p_i(d_i) and
    the first rejection resamples from p_i with d_i masked out.
    q_logits [S, gamma, V] (already filtered and scaled, as the drafter
    sampled): accept with probability min(1, p/q), resample from the
    normalised (p - q)+. When every draft is accepted a bonus token
    samples from p_gamma. Greedy rows accept while d_i == argmax_i and
    emit the argmax at the first mismatch (_accept_drafts), whatever q.
    spec_mask [S] False rows accept nothing and draw one sample from the
    FULL distribution at position 0.

    Returns (emitted [S, C] int32, n_acc [S] int32): the accepted drafts,
    then the correction/bonus at column n_acc; entries past it are
    padding."""
    S, C, V = logits.shape
    gamma = C - 1
    dev = logits.device
    if spec_mask is None:
        spec_mask = torch.ones((S,), dtype=torch.bool, device=dev)
    temps = temps.to(dev, torch.float32)
    stochastic = temps > 0
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)   # [S, C]
    safe_t = torch.where(stochastic, temps, torch.ones_like(temps))
    scaled = _filter_logits(logits / safe_t[:, None, None], top_k, top_p)
    if gamma > 0:
        d = drafts.long()
        probs = torch.softmax(scaled[:, :gamma, :], dim=-1)
        p_draft = torch.gather(probs, 2, d[..., None])[..., 0]
        u = torch.rand((S, gamma), generator=generator, device=dev)
        if q_logits is None:
            acc_p = p_draft
            one_hot = torch.nn.functional.one_hot(d, V).bool()
            resid = torch.where(one_hot & spec_mask[:, None, None],
                                torch.full_like(scaled[:, :gamma, :],
                                                -float("inf")),
                                scaled[:, :gamma, :])
        else:
            q_probs = torch.softmax(q_logits.float(), dim=-1)
            q_draft = torch.gather(q_probs, 2, d[..., None])[..., 0]
            acc_p = torch.where(q_draft > 0,
                                p_draft / torch.where(q_draft > 0, q_draft,
                                                      torch.ones_like(
                                                          q_draft)),
                                torch.ones_like(q_draft))
            resid_p = (probs - q_probs).clamp(min=0.0)
            resid = torch.where(resid_p > 0, torch.log(resid_p),
                                torch.full_like(resid_p, -float("inf")))
            resid = torch.where(spec_mask[:, None, None], resid,
                                scaled[:, :gamma, :])
        accept = torch.where(stochastic[:, None], u < acc_p,
                             drafts.to(torch.int32) == greedy_tok[:, :gamma])
        accept = accept & spec_mask[:, None]
        n_acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1) \
            .to(torch.int32)
        corr_logits = torch.cat([resid, scaled[:, gamma:, :]], dim=1)
        pad_drafts = torch.cat(
            [drafts.to(torch.int32),
             torch.zeros((S, 1), dtype=torch.int32, device=dev)], dim=1)
    else:
        n_acc = torch.zeros((S,), dtype=torch.int32, device=dev)
        corr_logits = scaled
        pad_drafts = torch.zeros((S, C), dtype=torch.int32, device=dev)
    drawn = gumbel_argmax(corr_logits, generator)
    corr = torch.where(stochastic[:, None], drawn, greedy_tok)
    col = torch.arange(C, device=dev)[None, :]
    emitted = torch.where(col < n_acc[:, None], pad_drafts, corr)
    return emitted, n_acc


def tree_depth(width: int, nodes: int) -> int:
    """Expansion depth D of the budgeted token tree: `nodes` counts the
    root chain token plus D full fans of `width` siblings."""
    return (nodes - 1) // width


def tree_principal(d: int, width: int) -> int:
    """Chunk index of the depth-d principal node (sibling 0 of its fan;
    the root chain token at depth 0). Every depth-(d+1) fan hangs off
    the depth-d principal (a caterpillar tree)."""
    return 0 if d == 0 else 1 + (d - 1) * width


def tree_node_index(d: int, j: int, width: int) -> int:
    """Chunk index of depth-d sibling j (d >= 1, 0 <= j < width)."""
    return 1 + (d - 1) * width + j


def tree_ancestor_matrix(width: int, nodes: int) -> np.ndarray:
    """[N, N] bool: anc[n, m] — may node n attend chunk position m? True
    for m on n's root->n ancestor path (self included)."""
    N = nodes
    anc = np.zeros((N, N), dtype=bool)
    anc[0, 0] = True
    for d in range(1, tree_depth(width, nodes) + 1):
        path = [tree_principal(k, width) for k in range(d)]
        for j in range(width):
            n = tree_node_index(d, j, width)
            anc[n, path] = True
            anc[n, n] = True
    return anc


def speculative_tree_accept(logits: torch.Tensor, drafts: torch.Tensor,
                            generator: Optional[torch.Generator],
                            temps: torch.Tensor, top_k: int, top_p: float,
                            spec_mask: Optional[torch.Tensor] = None,
                            q_logits: Optional[torch.Tensor] = None, *,
                            width: int, nodes: int):
    """Token-TREE acceptance (SpecInfer-style) with the recursive-residual
    correction: the output law is the target's.

    logits [S, N, V] are one tree-verify forward's per-node logits (node
    0 the chain token, depth-d sibling j at tree_node_index(d, j));
    drafts [S, D, w] the fans (sibling 0 = the principal); q_logits
    [S, D, V] the filtered scaled logits each fan was drawn from i.i.d.
    The walk runs root to leaf: at depth d candidates are tested in
    sibling order against the recursive residual r (r_0 = p at the
    parent principal; accept j w.p. min(1, r_j(x)/q(x)); on rejection
    r_{j+1} = norm((r_j - q)+)). A principal acceptance above the bottom
    continues the walk; a non-principal acceptance, or the bottom, ends
    it with a bonus from the accepted node's own distribution; a fully
    rejected fan ends it with a draw from the last residual. Greedy rows
    accept a sibling iff it is the parent's argmax and end with the
    argmax at the terminal node. spec_mask False rows draw one sample
    from the full distribution at node 0.

    Returns (emitted [S, D+1], n_acc [S], perm [S, D+1]): perm[:, i] is
    the chunk index of the i-th kept node (perm[:, 0] = 0), the K/V
    compaction the caller applies."""
    S, N, V = logits.shape
    w, D = width, tree_depth(width, nodes)
    assert N == nodes and drafts.shape[1] == D and drafts.shape[2] == w
    C_out = D + 1
    dev = logits.device
    if spec_mask is None:
        spec_mask = torch.ones((S,), dtype=torch.bool, device=dev)
    temps = temps.to(dev, torch.float32)
    stochastic = temps > 0
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)   # [S, N]
    safe_t = torch.where(stochastic, temps, torch.ones_like(temps))
    scaled = _filter_logits(logits / safe_t[:, None, None], top_k, top_p)
    u = torch.rand((S, D, w), generator=generator, device=dev)
    if q_logits is None:
        # greedy-only callers: a uniform stand-in keeps the stochastic
        # algebra defined; greedy rows never read it
        q_logits = torch.zeros((S, D, V), device=dev)
    q_probs = torch.softmax(q_logits.float(), dim=-1)           # [S, D, V]

    zeros_i = torch.zeros((S,), dtype=torch.int32, device=dev)
    walking = spec_mask.clone()
    n_acc = zeros_i.clone()
    acc_cols, perm_cols = [], [zeros_i]
    final_lg = scaled[:, 0, :]
    final_node = zeros_i.clone()
    ninf = torch.full_like(final_lg, -float("inf"))
    for d in range(1, D + 1):
        pn = tree_principal(d - 1, w)
        r = torch.softmax(scaled[:, pn, :], dim=-1)             # r_0 = p
        q_d = q_probs[:, d - 1, :]
        acc_here = torch.zeros((S,), dtype=torch.bool, device=dev)
        tok_here = zeros_i.clone()
        node_here = zeros_i.clone()
        for j in range(w):
            tok = drafts[:, d - 1, j].to(torch.int32)
            r_tok = torch.gather(r, 1, tok.long()[:, None])[:, 0]
            q_tok = torch.gather(q_d, 1, tok.long()[:, None])[:, 0]
            ratio = torch.where(q_tok > 0, r_tok / torch.where(
                q_tok > 0, q_tok, torch.ones_like(q_tok)),
                torch.ones_like(q_tok))
            acc_j = torch.where(stochastic, u[:, d - 1, j] < ratio,
                                tok == greedy_tok[:, pn])
            take = walking & ~acc_here & acc_j
            tok_here = torch.where(take, tok, tok_here)
            node_here = torch.where(
                take, torch.full_like(node_here, tree_node_index(d, j, w)),
                node_here)
            acc_here = acc_here | take
            # token-independent residual after a rejection; a zero-mass
            # residual (r == q) keeps r to stay defined
            r_next = (r - q_d).clamp(min=0.0)
            mass = r_next.sum(dim=-1, keepdim=True)
            r = torch.where(mass > 0, r_next / mass.clamp(min=1e-38), r)
        acc_cols.append(tok_here)
        perm_cols.append(torch.where(acc_here, node_here, zeros_i))
        n_acc = n_acc + acc_here.to(torch.int32)
        rej = walking & ~acc_here
        resid = torch.where(r > 0, torch.log(r), ninf)
        final_lg = torch.where(rej[:, None], resid, final_lg)
        final_node = torch.where(rej, torch.full_like(final_node, pn),
                                 final_node)
        if d < D:
            term = acc_here & (node_here != tree_principal(d, w))
        else:
            term = acc_here
        term = walking & term
        node_scaled = torch.gather(
            scaled, 1, node_here.long()[:, None, None].expand(S, 1, V))[:, 0]
        final_lg = torch.where(term[:, None], node_scaled, final_lg)
        final_node = torch.where(term, node_here, final_node)
        walking = walking & acc_here & ~term

    drawn = gumbel_argmax(final_lg, generator)
    final_greedy = torch.gather(greedy_tok, 1, final_node.long()[:, None])[:, 0]
    final = torch.where(stochastic, drawn, final_greedy)
    acc_pad = torch.stack(acc_cols + [zeros_i], dim=1)         # [S, D+1]
    col = torch.arange(C_out, device=dev)[None, :]
    emitted = torch.where(col < n_acc[:, None], acc_pad, final[:, None])
    return emitted, n_acc, torch.stack(perm_cols, dim=1)
