"""On-device draft model for speculative serving, in PyTorch.

The counterpart of butterfly_tpu/models/draft.py. The draft is the
target's first `draft_layers` layers (`derive_draft_params`): the layer
leaves are views of the target's stacked tensors, and the embedding,
final norm and LM head are the SAME tensor objects, so the draft costs
no extra weight memory, float and int8 trees alike; an MoE target's
draft keeps its `moe` leaves (expert-sharded ones too), as in JAX. Its per-round
micro-steps run inside the serving engine's spec block, over its own
contiguous KV cache (models.common.KVCache, int8 codes + scales when
kv_quant="int8") that rides the block carry: each round writes γ+1
entries at the draft length, and the engine rolls the length back to the
ACCEPTED count, so rejected drafts sit past it, unattendable, and the
next round overwrites them in place. At admission the scheduler reseeds
a slot's draft cache from host truth (`ModelDraftSource.prefill`).

An independent draft checkpoint (RuntimeConfig.draft_ckpt) is loaded by
ckpt/load.py:load_draft_checkpoint (engine/serving.py builds the source).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from butterfly_tpu_torch.core.config import ModelConfig
from butterfly_tpu_torch.engine.sampling import _filter_logits, gumbel_argmax
from butterfly_tpu_torch.models.common import KVCache, forward, init_cache
from butterfly_tpu_torch.parallel.tensor import tmap

Params = dict


def resolve_draft_layers(cfg: ModelConfig, draft_layers: int) -> int:
    """Validated truncation depth: `draft_layers` as given, or (when 0)
    a quarter of the target's depth, floored at 1; it must be a strict
    truncation."""
    if draft_layers < 0:
        raise ValueError(f"draft_layers must be >= 0, got {draft_layers}")
    n = draft_layers if draft_layers > 0 else max(1, cfg.num_layers // 4)
    if not 1 <= n < cfg.num_layers:
        raise ValueError(
            f"draft_layers={draft_layers} invalid for a "
            f"{cfg.num_layers}-layer target: need 1 <= n < num_layers")
    return n


def _slice_layers(node, n: int):
    if isinstance(node, dict):
        return {k: _slice_layers(v, n) for k, v in node.items()}
    return node[:n]          # a view of the stacked [L, ...] tensor


def derive_draft_params(params: Params, cfg: ModelConfig,
                        draft_layers: int) -> Tuple[ModelConfig, Params]:
    """Truncated-layer draft: the first `draft_layers` layers (views,
    int8 {"q8", "s"} leaves included), the embedding, final norm and LM
    head shared as the same objects."""
    n = resolve_draft_layers(cfg, draft_layers)
    dparams: Params = {
        "embed": params["embed"],
        "layers": _slice_layers(params["layers"], n),
        "final_norm": params["final_norm"],
    }
    if "lm_head" in params:
        dparams["lm_head"] = params["lm_head"]
    return cfg.replace(num_layers=n), dparams


def _pow2(n: int, lo: int, hi: int) -> int:
    """Next power-of-two bucket >= n in [lo, hi]."""
    b = lo
    while b < min(n, hi):
        b *= 2
    return min(b, hi)


def _set_drop(dst: torch.Tensor, dim: int, idx: torch.Tensor,
              vals: torch.Tensor) -> None:
    """dst.index_copy along `dim` at idx, IN PLACE, dropping entries whose
    index is out of range (jnp's mode="drop", no host sync). A dropped
    entry is redirected to the last index carrying the value that index
    ends up with (a member's write there, or its current contents), so
    the duplicate writes agree."""
    n = dst.shape[dim]
    M = idx.shape[0]
    ok = idx < n
    ar = torch.arange(M, device=idx.device)
    hit = torch.where(ok & (idx == n - 1), ar, torch.full_like(ar, -1))
    j = hit.max()
    old = dst.select(dim, n - 1)
    new = vals.index_select(dim, j.clamp(min=0).reshape(1)).squeeze(dim)
    fill = torch.where(j >= 0, new, old).unsqueeze(dim)
    shape = [1] * vals.dim()
    shape[dim] = M
    vals = torch.where(ok.reshape(shape), vals, fill)
    dst.index_copy_(dim, idx.clamp(max=n - 1).long(), vals.to(dst.dtype))


def _draft_prefill_step(cfg: ModelConfig, params, cache: KVCache, tokens,
                        lens, slots) -> KVCache:
    """Seed `slots`' draft KV with their prompts, IN PLACE: gather the
    member rows' cache slices, run ONE fresh causal forward over the
    padded [M, T] chunk, scatter back. Padding rows carry an
    out-of-range slot id: their gather clamps (reads a live row, unused)
    and their scatter drops, so they never touch live state. Positions
    >= lens hold K/V past the seeded length, overwritten by the first
    micro-step."""
    S = cache.length.shape[0]
    quant = cache.quantized
    rows = slots.long().clamp(max=S - 1)
    sub = KVCache(
        k=cache.k[:, rows], v=cache.v[:, rows],
        length=torch.zeros_like(lens),
        k_scale=cache.k_scale[:, rows] if quant else None,
        v_scale=cache.v_scale[:, rows] if quant else None)
    M, T = tokens.shape
    positions = torch.arange(T, device=tokens.device)[None, :].expand(M, T)
    _, sub = forward(params, cfg, tokens, sub, positions, fresh=True)
    for dst, val in ((cache.k, sub.k), (cache.v, sub.v),
                     (cache.k_scale, sub.k_scale),
                     (cache.v_scale, sub.v_scale)):
        if dst is not None:
            tmap(_set_drop, dst, 1, slots, val)
    length = cache.length.clone()
    _set_drop(length, 0, slots, lens.to(torch.int32))
    return cache._replace(length=length)


class ModelDraftSource:
    """Draft source backed by a real on-device model (DRAFT_SOURCES
    entry "model", engine/serving.py). Its state is the draft KVCache;
    `draft` / `tree_draft` run inside the spec block, `prefill` is the
    host-side admission hook."""

    stateful = True

    def __init__(self, cfg: ModelConfig, params, *, num_slots: int,
                 width: int, kv_quant: str = "none", mesh=None):
        self.cfg = cfg
        self.params = params
        self.num_slots = num_slots
        self.width = width
        self.kv_quant = kv_quant
        self.mesh = mesh
        self.device = params["final_norm"]["scale"].device

    def init_state(self) -> KVCache:
        """A zeroed draft cache [L_d, S, W_d, Kv, H] (int8 codes + scales
        iff kv_quant="int8"); W_d = the serving max_seq + γ+1 slack, so
        micro-step writes at the sequence cap never clamp onto a live
        entry. Under a tensor mesh its kv heads split with the weights'; its
        slots stay whole (admission gathers any slots), each data group
        reading its rows."""
        return init_cache(self.cfg, self.num_slots, self.width,
                          quant=self.kv_quant, device=self.device,
                          mesh=self.mesh, split_batch=False)

    def prefill(self, state: KVCache, slots, rows: np.ndarray,
                lens: np.ndarray) -> KVCache:
        """Reseed newly admitted slots' draft KV from host truth: the
        rows the scheduler seeds the token history with, WITHOUT the
        first sampled token (the draft_len == hist_len - 1 invariant).
        Runs at a full drain barrier (admission)."""
        slots = np.asarray(torch.as_tensor(slots).cpu(), np.int32)
        M = len(slots)
        T = _pow2(int(max(1, lens.max())), 16, self.width)
        Mb = _pow2(M, 1, self.num_slots)
        buf = np.zeros((Mb, T), np.int32)
        buf[:M] = rows[:, :T]
        lv = np.zeros((Mb,), np.int32)
        lv[:M] = np.minimum(lens, T)
        # padding rows scatter nowhere: an out-of-range slot id
        sv = np.full((Mb,), self.num_slots, np.int32)
        sv[:M] = slots

        def dev(a):
            return torch.as_tensor(a).to(self.device)
        return _draft_prefill_step(self.cfg, self.params, state, dev(buf),
                                   dev(lv), dev(sv))

    def _micro_steps(self, hist, hlen, steps: int, live, state, temps,
                     top_k: int, top_p: float, pick):
        """`steps` autoregressive micro-steps plus a final write-only one
        over the draft cache. Entry invariant: state.length == hlen - 1
        on live slots. Step j feeds the current token (the history tail,
        then the previous pick), writes its K/V at the draft length and
        proposes through `pick(q, scaled) -> (chosen [S, ...], next
        token [S])`. Dead slots' lengths never advance. Returns (picks,
        filtered scaled q per step, state at base + steps + 1)."""
        S, H = hist.shape
        dlen0 = state.length
        cur = torch.gather(hist, 1, (hlen.long() - 1).clamp(0, H - 1)[:, None])[:, 0]
        temps = temps.to(hist.device, torch.float32)
        safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))[:, None]
        picks, qlogs = [], []
        for j in range(steps + 1):
            logits, state = forward(self.params, self.cfg, cur[:, None],
                                    state)
            state = state._replace(length=torch.where(
                live, dlen0 + j + 1, dlen0).to(torch.int32))
            if j == steps:
                break
            q = logits[:, -1, :]
            scaled = _filter_logits(q / safe_t, top_k, top_p)
            chosen, cur = pick(q, scaled, temps)
            picks.append(chosen)
            qlogs.append(scaled)
        return torch.stack(picks, dim=1), torch.stack(qlogs, dim=1), state

    def draft(self, hist, hlen, gamma: int, ngram: int, live, state,
              generator, temps, top_k: int, top_p: float):
        """γ micro-steps: greedy proposals on temp-0 slots, draws from
        the filtered distribution the accept test scores as q otherwise.
        Returns (drafts [S, γ] int32, q_logits [S, γ, V], state at
        base + γ + 1 on live slots)."""
        def pick(q, scaled, temps):
            greedy = torch.argmax(q, dim=-1).to(torch.int32)
            nxt = torch.where(temps > 0, gumbel_argmax(scaled, generator),
                              greedy)
            return nxt, nxt
        return self._micro_steps(hist, hlen, gamma, live, state, temps,
                                 top_k, top_p, pick)

    def tree_draft(self, hist, hlen, width: int, depth: int, live, state,
                   generator, temps, top_k: int, top_p: float):
        """`depth` micro-steps along the principal chain, each branching
        a fan of `width` candidates from its one q: i.i.d. draws on
        stochastic rows, the top-`width` tokens on greedy rows (index 0
        the argmax, so the principal chain is `draft`'s). Only the
        principal's K/V enters the draft cache. Returns (drafts [S,
        depth, width] int32, q_logits [S, depth, V], state at base +
        depth + 1 on live slots)."""
        def pick(q, scaled, temps):
            top = torch.topk(q, width, dim=-1).indices.to(torch.int32)
            fan = torch.stack(
                [torch.where(temps > 0, gumbel_argmax(scaled, generator),
                             top[:, i]) for i in range(width)], dim=1)
            return fan, fan[:, 0]
        return self._micro_steps(hist, hlen, depth, live, state, temps,
                                 top_k, top_p, pick)
