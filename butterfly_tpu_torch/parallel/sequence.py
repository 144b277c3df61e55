"""Sequence parallelism for long context: ring attention and Ulysses, on a
single-controller mesh.

The counterpart of butterfly_tpu/parallel/sequence.py. The JAX package
runs each function body once per device under `shard_map`, with the
collectives (the ring's `ppermute` inside the layer scan, `pmax`/`psum`
inside the decode layer) in the middle of the layer loop. The port keeps
ONE layer loop and holds every seq-sharded value as a list with one
tensor per shard, on that shard's device; inside a layer it runs each
shard's work in shard order. The collectives become:

* `ppermute(i -> i+1)`: the list rotates, each tensor moving with
  `.to(device, non_blocking=True)` (a no-op when both shards share a
  card);
* `pmax` / `psum`: reductions on the first shard's device, in shard
  order;
* `axis_index`: the loop index;
* `all_to_all` / `all_gather` (Ulysses): concatenations and splits.

Weights are replicated as under the JAX seq-only mesh, but once per
DISTINCT device (`replicate_params`): shards that share a card share its
tensors. Replicated values (the decode step's activations, the suffix
cache, the serving lane's gathered prefix) live on the first shard's
device, which is where every program that is not seq-parallel runs.

Masking follows ops/ring_attention.py: the one predicate is
k_pos <= q_pos, invalid keys carry INVALID_POS.

Under kv_quant="int8" each shard quantises its chunk ONCE (kv-major
layout, the pool's representation) and every ring read goes through
codes + scales, dequantised in the kernel.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from butterfly_tpu_torch.core.config import ModelConfig
from butterfly_tpu_torch.models.common import (
    KVCache, Params, _cast_layer, attend, attn_output, embed_tokens,
    ffn_block, final_logits, layer_params, pre_norm, qkv_proj, quantize_kv,
    torch_dtype, update_cache_layer, update_cache_layer_q)
from butterfly_tpu_torch.ops.ring_attention import (
    INVALID_POS, block_stats, finalize_stats, merge_stats, zero_stats)

Shards = List[torch.Tensor]


class Replicated(dict):
    """One weight tree per distinct device: {torch.device: tree}."""


def replicate_params(params: Params, devices: Sequence[torch.device]
                     ) -> Replicated:
    """The weight tree on every distinct device of `devices` (the tree
    itself where it already lives: no copy)."""
    def to(node, dev):
        if isinstance(node, dict):
            return {k: to(v, dev) for k, v in node.items()}
        return node.to(dev)
    out = Replicated()
    for d in devices:
        d = torch.device(d)
        if d not in out:
            out[d] = to(params, d)
    return out


def _replicas(params, devices) -> Replicated:
    return params if isinstance(params, Replicated) \
        else replicate_params(params, devices)


def _layer_params(reps: Replicated, i: int, dtype) -> Dict:
    """Layer i's weights in the compute dtype, per distinct device."""
    return {d: _cast_layer(layer_params(p, i), dtype) for d, p in reps.items()}


def _rotate(xs: Sequence[Optional[torch.Tensor]],
            devs: Sequence[torch.device]) -> list:
    """ppermute i -> i+1: shard i receives shard i-1's value."""
    N = len(xs)
    return [None if xs[i - 1] is None
            else xs[i - 1].to(devs[i], non_blocking=True) for i in range(N)]


def _split(x: torch.Tensor, devs: Sequence[torch.device], dim: int = 1
           ) -> Shards:
    """x split into len(devs) equal chunks along `dim`, chunk i on devs[i]."""
    return [c.to(d, non_blocking=True)
            for c, d in zip(x.chunk(len(devs), dim=dim), devs)]


def gather_shards(xs: Shards, dim: int = 1, device=None) -> torch.Tensor:
    """The seq-sharded list concatenated along `dim` on `device` (None =
    the first shard's)."""
    dev = xs[0].device if device is None else device
    return torch.cat([x.to(dev) for x in xs], dim=dim)


class ShardedKVCache(NamedTuple):
    """sp_forward's cache: each shard keeps the K/V it computed.

    k/v[i]: shard i's [L, B, Tl, Kv, H] (float) or codes [L, B, Kv, Tl, H]
    with k_scale/v_scale[i] [L, B, Kv, Tl] (int8), on shard i's device;
    `length` [B] on the first shard's device."""

    k: Shards
    v: Shards
    length: torch.Tensor
    k_scale: Optional[Shards] = None
    v_scale: Optional[Shards] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def local_len(self) -> int:
        return self.k[0].shape[3] if self.quantized else self.k[0].shape[2]

    def gather(self, device=None) -> KVCache:
        """The whole cache as one contiguous KVCache (the JAX global
        array's layout) on `device` (None = the first shard's)."""
        sd = 3 if self.quantized else 2
        k, v = gather_shards(self.k, sd, device), gather_shards(self.v, sd,
                                                                device)
        if not self.quantized:
            return KVCache(k=k, v=v, length=self.length.to(k.device))
        return KVCache(k=k, v=v, length=self.length.to(k.device),
                       k_scale=gather_shards(self.k_scale, 3, device),
                       v_scale=gather_shards(self.v_scale, 3, device))


# ---------------------------------------------------------------------------
# Ring and Ulysses attention over shard lists
# ---------------------------------------------------------------------------

def ring_stats(q: Shards, k: Shards, v: Shards, q_pos: Shards,
               k_pos: Shards, k_scale: Optional[Shards] = None,
               v_scale: Optional[Shards] = None,
               kernel: Optional[bool] = None) -> list:
    """Merged (unfinalised) flash stats of every shard over all N ring
    blocks, one (m, l, acc) per shard on its device.

    At ring step s shard i holds the K/V (+ positions, + int8 scales) of
    shard (i - s) mod N and folds its block's stats into its running
    stats with merge_stats, seeded from zero_stats: the JAX scan's order."""
    N = len(q)
    devs = [x.device for x in q]
    B, T, Nq, H = q[0].shape
    ks = list(k_scale) if k_scale is not None else [None] * N
    vs = list(v_scale) if v_scale is not None else [None] * N
    cur = [list(k), list(v), list(k_pos), ks, vs]
    stats = [zero_stats(B, Nq, T, H, device=d) for d in devs]
    for step in range(N):
        ck, cv, ckp, cks, cvs = cur
        for i in range(N):
            blk = block_stats(q[i], ck[i], cv[i], q_pos[i], ckp[i], cks[i],
                              cvs[i], kernel=kernel)
            stats[i] = merge_stats(stats[i], blk)
        if step < N - 1:  # the last rotation would be discarded
            cur = [_rotate(x, devs) for x in cur]
    return stats


def ring_attention(q: Shards, k: Shards, v: Shards, q_pos: Shards,
                   k_pos: Shards, k_scale: Optional[Shards] = None,
                   v_scale: Optional[Shards] = None,
                   kernel: Optional[bool] = None) -> Shards:
    """Causal GQA over the sequence ring. Per shard: q [B, Tq, Nq, H];
    float k/v [B, Tk, Kv, H]; int8 k/v codes [B, Kv, Tk, H] with
    k_scale/v_scale [B, Kv, Tk]; q_pos/k_pos [B, T*] absolute positions,
    invalid keys sanitised to INVALID_POS. Returns [B, Tq, Nq, H] per
    shard."""
    return [finalize_stats(s, x.dtype) for s, x in
            zip(ring_stats(q, k, v, q_pos, k_pos, k_scale, v_scale,
                           kernel=kernel), q)]


def ulysses_attention(q: Shards, k: Shards, v: Shards,
                      q_pos: Shards) -> Shards:
    """All-to-all head <-> sequence reshard, then full causal attention on
    the whole sequence for each shard's head group, and back.

    Per shard q [B, T/N, Nq, H], k/v [B, T/N, Kv, H]. Needs Kv % N == 0,
    or N % Kv == 0 and Nq % N == 0: then each kv head is REPLICATED
    r = N / Kv times first, so shard d receives the kv head (d // r) its
    q-head block contracts with. Returns [B, T/N, Nq, H] per shard."""
    N = len(q)
    devs = [x.device for x in q]
    B, Tl, Nq, H = q[0].shape
    Kv = k[0].shape[2]
    if Kv % N != 0:
        if N % Kv != 0 or Nq % N != 0:
            raise ValueError(
                f"ulysses needs Kv % N == 0 or (N % Kv == 0 and "
                f"Nq % N == 0); got Nq={Nq}, Kv={Kv}, N={N}")
        r = N // Kv
        k = [x.repeat_interleave(r, dim=2) for x in k]
        v = [x.repeat_interleave(r, dim=2) for x in v]

    def heads_to_seq(xs):  # all_to_all(split_axis=2, concat_axis=1)
        w = xs[0].shape[2] // N
        return [torch.cat([x[:, :, d * w:(d + 1) * w].to(devs[d])
                           for x in xs], dim=1) for d in range(N)]

    qq, kk, vv = heads_to_seq(q), heads_to_seq(k), heads_to_seq(v)
    outs = []
    for d in range(N):
        pos = torch.cat([p.to(devs[d]) for p in q_pos], dim=1)  # all_gather
        mask = pos[:, None, :] <= pos[:, :, None]                # [B,T,T]
        outs.append(attend(qq[d], kk[d], vv[d], mask, None))
    # back: all_to_all(split_axis=1, concat_axis=2)
    return [torch.cat([o[:, i * Tl:(i + 1) * Tl].to(devs[i]) for o in outs],
                      dim=2) for i in range(N)]


# ---------------------------------------------------------------------------
# Whole-model sequence-parallel prefill
# ---------------------------------------------------------------------------

def _attend_chunk(q, k, v, pos, impl: str, quant: bool, compute,
                  kernel: Optional[bool]):
    """One layer's attention over the shards' fresh chunks (sp_forward).
    Returns (out per shard, the chunk's K/V per shard in the cache's
    representation)."""
    if quant:
        qk = [quantize_kv(x.movedim(2, 1)) for x in k]       # [B,Kv,Tl,H]
        qv = [quantize_kv(x.movedim(2, 1)) for x in v]
        kq, ksc = [a for a, _ in qk], [b for _, b in qk]
        vq, vsc = [a for a, _ in qv], [b for _, b in qv]
        if impl == "ring":
            out = ring_attention(q, kq, vq, pos, pos, ksc, vsc,
                                 kernel=kernel)
        else:
            # Ulysses gathers whole sequences for a dense attend: it reads
            # the dequantised values (same operands, no scale plumbing)
            kf = [(a.float() * s[..., None]).movedim(1, 2).to(compute)
                  for a, s in zip(kq, ksc)]
            vf = [(a.float() * s[..., None]).movedim(1, 2).to(compute)
                  for a, s in zip(vq, vsc)]
            out = ulysses_attention(q, kf, vf, pos)
        return out, list(zip(kq, vq, ksc, vsc))
    if impl == "ring":
        out = ring_attention(q, k, v, pos, pos, kernel=kernel)
    else:
        out = ulysses_attention(q, k, v, pos)
    return out, [(a.to(compute), b.to(compute)) for a, b in zip(k, v)]


def sp_forward(params, cfg: ModelConfig, tokens: torch.Tensor, mesh,
               impl: str = "ring", kv_quant: str = "none",
               kernel: Optional[bool] = None
               ) -> Tuple[Shards, ShardedKVCache]:
    """Long-context prefill with activations sharded over `seq`.

    tokens: [B, T], T divisible by the seq size. `params` is one weight
    tree or `replicate_params`' map. Returns (logits per shard
    [B, T/N, V] f32, ShardedKVCache with S = T: int8 codes + scales when
    kv_quant="int8")."""
    devs = mesh.seq_devices()
    N = len(devs)
    B, T = tokens.shape
    if T % N != 0:
        raise ValueError(f"seq len {T} not divisible by seq axis {N}")
    if kv_quant not in ("none", "int8"):
        raise ValueError(f"unknown kv quant {kv_quant!r}")
    if impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown seq impl {impl!r}")
    quant = kv_quant == "int8"
    reps = _replicas(params, devs)
    compute = torch_dtype(cfg.dtype)
    Tl = T // N
    toks = _split(tokens, devs)
    pos = [(i * Tl + torch.arange(Tl, device=d))[None, :].expand(B, Tl)
           .to(torch.int32) for i, d in enumerate(devs)]
    xs, cs, ss = [], [], []
    for i, d in enumerate(devs):
        x, cos, sin = embed_tokens(reps[d], cfg, toks[i], pos[i])
        xs.append(x)
        cs.append(cos)
        ss.append(sin)
    kv_layers = []
    for li in range(cfg.num_layers):
        lps = _layer_params(reps, li, compute)
        lp = [lps[d] for d in devs]
        qs, ks, vs = [], [], []
        for i in range(N):
            h = pre_norm(xs[i], lp[i]["ln1"], cfg)
            q, k, v = qkv_proj(h, lp[i]["attn"], cfg, cs[i], ss[i])
            qs.append(q)
            ks.append(k)
            vs.append(v)
        out, kv_out = _attend_chunk(qs, ks, vs, pos, impl, quant, compute,
                                    kernel)
        for i in range(N):
            x = xs[i] + attn_output(out[i], lp[i]["attn"], cfg)
            xs[i] = x + ffn_block(pre_norm(x, lp[i]["ln2"], cfg), lp[i], cfg)
        kv_layers.append(kv_out)
    logits = [final_logits(reps[d], cfg, x) for d, x in zip(devs, xs)]
    # per shard: stack its layers' K/V ([L, ...] like the JAX cache)
    parts = [[torch.stack([kv_layers[li][i][j] for li in range(cfg.num_layers)])
              for j in range(len(kv_layers[0][0]))] for i in range(N)]
    length = torch.full((B,), T, dtype=torch.int32, device=devs[0])
    if quant:
        cache = ShardedKVCache(k=[p[0] for p in parts], v=[p[1] for p in parts],
                               length=length, k_scale=[p[2] for p in parts],
                               v_scale=[p[3] for p in parts])
    else:
        cache = ShardedKVCache(k=[p[0] for p in parts],
                               v=[p[1] for p in parts], length=length)
    return logits, cache


# ---------------------------------------------------------------------------
# Decode over the sharded prefix
# ---------------------------------------------------------------------------

def sp_decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                   positions: torch.Tensor, prefix: ShardedKVCache,
                   suffix: KVCache, mesh,
                   prefix_len: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, KVCache]:
    """One decode step over sp_forward's sharded cache.

    The long prefix stays sharded where prefill left it; generated tokens
    live in a small replicated contiguous `suffix` cache (on the first
    shard's device, written IN PLACE). Each shard attends its prefix chunk
    into partial (m, l, acc); the partials combine on the first device in
    shard order (the JAX pmax/psum), then the suffix block folds in with
    merge_stats before one finalize. Per layer that is N prefix launches
    plus ONE suffix launch (JAX runs the replicated suffix block once per
    device).

    tokens/positions: [B, 1] on the first device (positions = prefix
    length + step). prefix_len [B]: real prefix tokens per row (slots at
    or past it are masked out: generate_long's divisibility pad);
    defaults to prefix.length. int8: prefix and suffix must agree.
    Returns (last-token logits [B, V], suffix with length + 1).

    Capacity contract: the caller sizes the suffix for the whole run (a
    step past its end would clamp onto the last slot). Checked eagerly
    when the lengths live on the CPU; on a card the check would cost a
    host sync per step, so it is skipped there, as the JAX package skips
    it under jit."""
    if suffix.length.device.type == "cpu":
        if int(suffix.length.max()) >= suffix.max_seq:
            raise ValueError(
                f"suffix cache full ({suffix.max_seq} slots): size "
                "init_cache(max_seq=...) for the whole decode run")
    if prefix_len is None:
        prefix_len = prefix.length
    quant = prefix.quantized
    if quant != suffix.quantized:
        raise ValueError("prefix and suffix caches must agree on kv_quant")
    devs = mesh.seq_devices()
    N = len(devs)
    dev0 = devs[0]
    reps = _replicas(params, devs)
    compute = torch_dtype(cfg.dtype)
    B = tokens.shape[0]
    Smax = suffix.max_seq
    Tl = prefix.local_len
    slen = suffix.length
    plen = prefix_len.to(dev0)
    x, cos, sin = embed_tokens(reps[dev0], cfg, tokens, positions)
    # sanitised key positions, built ONCE outside the layer loop: suffix
    # slot j holds the token at position plen + j, visible up to this
    # step's own write (j <= slen); prefix slots at or past plen (the
    # divisibility pad) are INVALID_POS
    j = torch.arange(Smax, device=dev0)
    suf_pos = torch.where(j[None, :] <= slen[:, None],
                          plen[:, None] + j[None, :],
                          torch.full((B, Smax), INVALID_POS, device=dev0,
                                     dtype=torch.int64)).to(torch.int32)
    pre_pos, q_pos = [], []
    for i, d in enumerate(devs):
        gpos = i * Tl + torch.arange(Tl, device=d)
        pl = plen.to(d)
        pre_pos.append(torch.where(gpos[None, :] < pl[:, None], gpos[None, :],
                                   torch.full((B, Tl), INVALID_POS, device=d,
                                              dtype=torch.int64))
                       .to(torch.int32))
        q_pos.append(positions.to(d).to(torch.int32))
    suf_qpos = positions.to(torch.int32)
    for li in range(cfg.num_layers):
        lp = _cast_layer(layer_params(reps[dev0], li), compute)
        h = pre_norm(x, lp["ln1"], cfg)
        q, k, v = qkv_proj(h, lp["attn"], cfg, cos, sin)
        if quant:
            ck, cv, cks, cvs = update_cache_layer_q(
                suffix.k[li], suffix.v[li], suffix.k_scale[li],
                suffix.v_scale[li], k, v, slen)
        else:
            ck, cv = update_cache_layer(suffix.k[li], suffix.v[li], k, v,
                                        slen)
            cks = cvs = None
        parts = []
        for i, d in enumerate(devs):
            blk = block_stats(
                q.to(d, non_blocking=True), prefix.k[i][li],
                prefix.v[i][li], q_pos[i], pre_pos[i],
                prefix.k_scale[i][li] if quant else None,
                prefix.v_scale[i][li] if quant else None)
            parts.append([t.to(dev0, non_blocking=True) for t in blk])
        # pmax, then psum of the rescaled partials, in shard order
        m_g = parts[0][0]
        for p in parts[1:]:
            m_g = torch.maximum(m_g, p[0])
        l_g = acc_g = None
        for m_i, l_i, acc_i in parts:
            corr = torch.exp(m_i - m_g)
            l_c, acc_c = l_i * corr, acc_i * corr[..., None]
            l_g = l_c if l_g is None else l_g + l_c
            acc_g = acc_c if acc_g is None else acc_g + acc_c
        suf = block_stats(q, ck, cv, suf_qpos, suf_pos, cks, cvs)
        out = finalize_stats(merge_stats((m_g, l_g, acc_g), suf), x.dtype)
        x = x + attn_output(out, lp["attn"], cfg)
        x = x + ffn_block(pre_norm(x, lp["ln2"], cfg), lp, cfg)
    logits = final_logits(reps[dev0], cfg, x)
    return logits[:, -1, :], suffix._replace(
        length=(suffix.length + 1).to(torch.int32))


# ---------------------------------------------------------------------------
# One chunk of the serving lane's long-prompt prefill
# ---------------------------------------------------------------------------

def sp_chunk_body(params, cfg: ModelConfig, tokens: torch.Tensor,
                  start: int, prefix: tuple, mesh):
    """One paged long-prompt prefill chunk, sharded over `seq` — the
    serving sibling of sp_forward (the JAX body runs inside shard_map).

    tokens: [B=1, C] chunk buffer (C divisible by the seq size) whose
    first token sits at absolute position `start`, also the count of
    flushed pool-prefix tokens. `prefix` is the slot's gathered pool
    prefix for every layer, replicated: (pk, pv) [L, B, S, Kv, H] when
    float, (pk, pv, pks, pvs) codes [L, B, Kv, S, H] + scales [L, B, Kv, S]
    when the pool is int8; it is copied once to each other distinct shard
    device. Each query attends that prefix (positions < start live) and
    the fresh chunk via the ring; the two partials share one finalize.
    Chunk padding needs no sanitising: pad positions exceed every real
    query's, and the caller routes pad K/V to the null page.

    Returns (logits per shard [B, C/N, V], per shard the chunk's K/V for
    every layer in the pool's representation: (k, v) [L, B, C/N, Kv, H]
    in the compute dtype, or codes [L, B, Kv, C/N, H] + scales)."""
    devs = mesh.seq_devices()
    N = len(devs)
    reps = _replicas(params, devs)
    compute = torch_dtype(cfg.dtype)
    quant = len(prefix) == 4
    B, C = tokens.shape
    Cl = C // N
    S = prefix[0].shape[3] if quant else prefix[0].shape[2]
    pre = {}
    for d in devs:
        if d not in pre:
            pre[d] = tuple(t.to(d, non_blocking=True) for t in prefix)
    toks = _split(tokens, devs)
    pos, pre_pos = [], {}
    for i, d in enumerate(devs):
        pos.append((start + i * Cl + torch.arange(Cl, device=d))[None, :]
                   .expand(B, Cl).to(torch.int32))
        if d not in pre_pos:
            # exactly the flushed tokens (< start) are attendable
            g = torch.arange(S, device=d)
            pre_pos[d] = torch.where(g < start, g,
                                     torch.full_like(g, INVALID_POS))[None] \
                .expand(B, S).to(torch.int32)
    xs, cs, ss = [], [], []
    for i, d in enumerate(devs):
        x, cos, sin = embed_tokens(reps[d], cfg, toks[i], pos[i])
        xs.append(x)
        cs.append(cos)
        ss.append(sin)
    kv_layers = []
    for li in range(cfg.num_layers):
        lps = _layer_params(reps, li, compute)
        lp = [lps[d] for d in devs]
        qs, ks, vs, pres = [], [], [], []
        for i, d in enumerate(devs):
            h = pre_norm(xs[i], lp[i]["ln1"], cfg)
            q, k, v = qkv_proj(h, lp[i]["attn"], cfg, cs[i], ss[i])
            p = pre[d]
            pres.append(block_stats(
                q, p[0][li], p[1][li], pos[i], pre_pos[d],
                p[2][li] if quant else None, p[3][li] if quant else None))
            qs.append(q)
            ks.append(k)
            vs.append(v)
        if quant:
            qk = [quantize_kv(x.movedim(2, 1)) for x in ks]  # [B,Kv,Cl,H]
            qv = [quantize_kv(x.movedim(2, 1)) for x in vs]
            fresh = ring_stats(qs, [a for a, _ in qk], [a for a, _ in qv],
                               pos, pos, [s for _, s in qk],
                               [s for _, s in qv])
            kv_out = [(a, b, s, t) for (a, s), (b, t) in zip(qk, qv)]
        else:
            fresh = ring_stats(qs, ks, vs, pos, pos)
            kv_out = [(a.to(compute), b.to(compute)) for a, b in zip(ks, vs)]
        for i in range(N):
            out = finalize_stats(merge_stats(pres[i], fresh[i]), xs[i].dtype)
            x = xs[i] + attn_output(out, lp[i]["attn"], cfg)
            xs[i] = x + ffn_block(pre_norm(x, lp[i]["ln2"], cfg), lp[i], cfg)
        kv_layers.append(kv_out)
    logits = [final_logits(reps[d], cfg, x) for d, x in zip(devs, xs)]
    kv = [tuple(torch.stack([kv_layers[li][i][j]
                             for li in range(cfg.num_layers)])
                for j in range(len(kv_layers[0][0]))) for i in range(N)]
    return logits, kv
