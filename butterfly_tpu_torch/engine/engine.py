"""Inference engine: prefill and decode steps + the generate loops, in PyTorch.

The counterpart of butterfly_tpu/engine/engine.py. One prefill program
(full-prompt forward through the flash kernel wherever kernels run, cache
write) and one decode step; the fused generate loops run every decode step
on the device without a host sync per token (the done mask and the stop
test stay on the device, tokens come back in one copy at the end). The
JAX package's jitted lax.scan becomes a Python loop of eagerly launched
device work.

Under a seq mesh (core/mesh.py) `generate_long` runs the long-context
path of parallel/sequence.py: a sequence-parallel prefill through the ring
kernel (or Ulysses) that leaves the prompt's K/V sharded where it was
computed, then decode steps that merge per-shard partial attention. Every
other program runs on the mesh's first device.

Batch shapes are rectangular: prompts are right-padded; pad keys sit at
positions the causal mask never reaches before decode overwrites them.
Random draws come from ONE torch.Generator seeded from `seed` (the JAX
key splits); greedy output equals the JAX package's token for token.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from butterfly_tpu_torch.core.config import ModelConfig, RuntimeConfig
from butterfly_tpu_torch.core.device import resolve_device
from butterfly_tpu_torch.core.mesh import require_seq_mesh, seq_degree
from butterfly_tpu_torch.engine.sampling import SamplingParams, sample
from butterfly_tpu_torch.models.common import (
    KVCache, Model, decode_step_win, flush_window, forward, init_cache,
    torch_dtype)
from butterfly_tpu_torch.parallel.sequence import (
    replicate_params, sp_decode_step, sp_forward)

#: where each refused configuration waits (ROADMAP.md, PyTorch/CUDA port)
ROADMAP = "ROADMAP.md, PyTorch/CUDA port queue"


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({ROADMAP}: "
                               f"{item})")


@dataclass
class GenerateResult:
    tokens: np.ndarray          # [B, max_new] ids (past a stop: the stop id)
    lengths: np.ndarray         # [B] number of valid generated tokens
    prompt_lengths: np.ndarray  # [B]


def is_quantized_tree(params) -> bool:
    """Does the weight tree hold int8 ({"q8", "s"}) leaves?"""
    if isinstance(params, dict):
        if "q8" in params and "s" in params:
            return True
        return any(is_quantized_tree(v) for v in params.values())
    return False


def mesh_device(mesh, device, model) -> torch.device:
    """The engine's device: the mesh's first device under a (seq-only)
    mesh, where every program that is not seq-parallel runs; else
    `device`, else the model's. A `device` that disagrees with the mesh
    raises."""
    if mesh is None:
        return resolve_device(
            device if device is not None else getattr(model, "device", None))
    require_seq_mesh(mesh)
    first = resolve_device(mesh.seq_devices()[0])
    if device is not None:
        want = torch.device(device)
        if want.type != first.type or want.index not in (None, first.index):
            raise ValueError(f"device {device} is not the mesh's first "
                             f"device ({first})")
    return first


def to_device(params, device: torch.device):
    """The weight tree with every leaf on `device` (no copy when there)."""
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    return params.to(device)


class InferenceEngine:
    """Inference over a weight tree on `device` (None = the model's
    device, CUDA unless the caller asks for the CPU), or over a seq-only
    `mesh` (core/mesh.py): then on the mesh's first device, with one copy
    of the weights per distinct mesh device for `generate_long`."""

    def __init__(self, model: Model, params,
                 runtime: Optional[RuntimeConfig] = None, mesh=None,
                 use_flash_prefill: Optional[bool] = None, device=None):
        self.model = model
        self.cfg = model.cfg
        self.runtime = runtime or RuntimeConfig()
        if self.cfg.is_moe:
            raise not_ported("MoE models", "Mixtral / expert parallelism")
        if is_quantized_tree(params):
            raise not_ported("int8 weights (--quant int8)", "int8 weights")
        self.mesh = mesh
        self.device = mesh_device(mesh, device, model)
        # (B, max_seq) -> reusable cache buffers from the previous call;
        # bounded (FIFO) so varying shapes can't pin unbounded memory
        self._cache_pool: "OrderedDict" = OrderedDict()
        self._cache_pool_cap = 2
        self.params = to_device(cast_params(params, self.cfg), self.device)
        # the weights on every other distinct mesh device (shards that
        # share a card share its tensors: no second copy)
        self._replicas = None if mesh is None else \
            replicate_params(self.params, mesh.seq_devices())
        if use_flash_prefill is None:
            # the hand-written kernels need the card; the CPU runs their
            # plain versions (the wrapper picks by tensor device)
            use_flash_prefill = self.device.type == "cuda"
        # prefill steps are always fresh (positions 0..T-1), so they may
        # take the flash kernel (cfg.attn_impl contract)
        self._prefill_cfg = self.cfg.replace(attn_impl="flash") \
            if use_flash_prefill else self.cfg
        window = self.runtime.decode_window
        if window == 0:  # auto (config.py rationale)
            window = 16 if self.runtime.kv_quant == "int8" else 1
        self._decode_window = max(1, window)

    # -- public API ---------------------------------------------------------

    def new_cache(self, batch: int, max_seq: Optional[int] = None) -> KVCache:
        return init_cache(self.cfg, batch,
                          max_seq or self.runtime.max_seq_len,
                          quant=self.runtime.kv_quant, device=self.device)

    def prefill(self, tokens: torch.Tensor, true_lens: torch.Tensor,
                cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
        """tokens [B,Tpad] right-padded; returns (last-token logits [B,V],
        cache)."""
        return _prefill_step(self._prefill_cfg, self.params, tokens, cache,
                             true_lens)

    def decode(self, token: torch.Tensor, cache: KVCache,
               generator: Optional[torch.Generator], sp: SamplingParams
               ) -> Tuple[torch.Tensor, KVCache, torch.Generator]:
        return _decode_step(self.cfg, self.params, token, cache, generator,
                            sp)

    def generate(self, prompts: Sequence[Sequence[int]],
                 sp: Optional[SamplingParams] = None,
                 seed: int = 0, fused: bool = True) -> GenerateResult:
        """End-to-end batched generation from python-list prompts."""
        sp = sp or SamplingParams()
        n_real = len(prompts)
        tokens, true_lens = pad_prompts(prompts)
        B = tokens.shape[0]
        total = tokens.shape[1] + sp.max_new_tokens
        if total > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt ({tokens.shape[1]}) + max_new_tokens "
                f"({sp.max_new_tokens}) = {total} exceeds the model's "
                f"max_seq_len ({self.cfg.max_seq_len})")
        # Exact KV sizing: prefill writes T slots and the decode loop at
        # most max(max_new, ceil(steps/C)*C) more (the windowed loop rounds
        # the step count up to a multiple of the window; its tail steps
        # write frozen tokens past `total`). Attention reads the WHOLE
        # buffer every step, so slack rows are pure memory traffic.
        steps = sp.max_new_tokens - 1
        iters = -(-steps // self._decode_window) if steps else 0
        max_seq = max(self.runtime.max_seq_len,
                      tokens.shape[1] + max(sp.max_new_tokens,
                                            iters * self._decode_window))
        # Reuse the previous call's cache buffers when the shape matches:
        # stale K/V is harmless — prefill overwrites positions 0..T-1 and
        # the causal mask never reaches past each row's written length.
        cache = self._cache_pool.pop((B, max_seq), None)
        if cache is None:
            cache = self.new_cache(B, max_seq)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        tok_t = torch.as_tensor(tokens).to(self.device)
        lens_t = torch.as_tensor(true_lens).to(self.device)
        logits, cache = self.prefill(tok_t, lens_t, cache)
        first = sample(logits, gen, sp)
        if fused:
            if self._decode_window > 1:
                # every row flushes at the same offset (equal prompt
                # lengths): the one scalar-offset write per flush group
                uniform = bool(np.all(true_lens == true_lens[0]))
                out, lens, cache = _generate_fused_win(
                    self.cfg, self._decode_window, self.params, first, cache,
                    gen, sp, sp.max_new_tokens, uniform)
            else:
                out, lens, cache = _generate_fused(
                    self.cfg, self.params, first, cache, gen, sp,
                    sp.max_new_tokens)
            both = torch.cat([out.to(torch.int32),
                              lens.to(torch.int32)[:, None]], dim=1).cpu()
            out, lens = both[:, :-1].numpy(), both[:, -1].numpy()
        else:
            toks = [first.cpu().numpy()]
            cur = first
            for _ in range(sp.max_new_tokens - 1):
                cur, cache, gen = self.decode(cur, cache, gen, sp)
                toks.append(cur.cpu().numpy())
            out = np.stack(toks, axis=1)
            lens = _stop_lengths(out, sp.stop_token)
            out = _mask_after_stop(out, lens, sp.stop_token)
        self._cache_pool[(B, max_seq)] = cache
        while len(self._cache_pool) > self._cache_pool_cap:
            self._cache_pool.popitem(last=False)  # FIFO-evict (frees memory)
        return GenerateResult(tokens=out[:n_real], lengths=lens[:n_real],
                              prompt_lengths=np.asarray(true_lens)[:n_real])

    def generate_long(self, prompt: Sequence[int],
                      sp: Optional[SamplingParams] = None,
                      seed: int = 0, impl: str = "ring") -> GenerateResult:
        """Long-context generation over the mesh's `seq` axis: a
        sequence-parallel prefill (sp_forward, ring attention or Ulysses)
        leaves the prompt's K/V sharded over `seq` where it was computed;
        decode steps (sp_decode_step) merge per-shard partial attention,
        so the long prefix is never regathered. One sequence; the prompt
        is right-padded to a multiple of the seq size and the pad K/V is
        masked out of every decode step. kv_quant="int8" rides through:
        the sharded prefix and the replicated suffix hold codes + scales.

        Decode dispatches run ahead of the host, up to
        runtime.inflight_blocks deep, chained on the device token; tokens
        dispatched past a stop are discarded. Random draws come from one
        torch.Generator seeded from `seed`.

        CLI surface: `butterfly generate --seq-parallel N`."""
        sp = sp or SamplingParams()
        N = seq_degree(self.mesh)
        if N <= 1:
            raise ValueError(
                "generate_long needs a mesh with a seq axis > 1 "
                "(CLI: --seq-parallel N)")
        ids = list(prompt)
        true_len = len(ids)
        total = true_len + sp.max_new_tokens
        if total > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt ({true_len}) + max_new_tokens "
                f"({sp.max_new_tokens}) = {total} exceeds the model's "
                f"max_seq_len ({self.cfg.max_seq_len})")
        pad = -(-true_len // N) * N
        tokens = np.zeros((1, pad), np.int32)
        tokens[0, :true_len] = np.asarray(ids, np.int32)
        dev = self.device
        kvq = self.runtime.kv_quant
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        logits, prefix = sp_forward(self._replicas, self.cfg,
                                    torch.as_tensor(tokens).to(dev),
                                    self.mesh, impl=impl, kv_quant=kvq)
        shard, row = divmod(true_len - 1, pad // N)
        cur = sample(logits[shard][:, row, :].to(dev), gen, sp)
        del logits
        plen = torch.full((1,), true_len, dtype=torch.int32, device=dev)
        # replicated suffix cache sized for the whole decode run (in the
        # prefix's representation)
        suffix = init_cache(self.cfg, 1, sp.max_new_tokens, quant=kvq,
                            device=dev)
        depth = max(1, self.runtime.inflight_blocks)
        pending = deque([cur])
        out: List[int] = []
        n_disp = 0  # decode steps dispatched so far
        while pending:
            while len(pending) <= depth and n_disp < sp.max_new_tokens - 1:
                # positions depend only on the dispatch count, so
                # dispatching runs ahead of the stop-token check
                positions = torch.full((1, 1), true_len + n_disp,
                                       dtype=torch.int32, device=dev)
                logits, suffix = sp_decode_step(
                    self._replicas, self.cfg, cur[:, None], positions,
                    prefix, suffix, self.mesh, prefix_len=plen)
                cur = sample(logits, gen, sp)
                pending.append(cur)
                n_disp += 1
            tok = int(pending.popleft()[0])
            out.append(tok)
            if sp.stop_token >= 0 and tok == sp.stop_token:
                break  # in-flight steps past the stop are discarded
        toks = np.asarray(out, np.int32)[None]
        lens = _stop_lengths(toks, sp.stop_token)
        return GenerateResult(tokens=_mask_after_stop(toks, lens,
                                                      sp.stop_token),
                              lengths=lens,
                              prompt_lengths=np.asarray([true_len]))

    def generate_speculative(self, *args, **kwargs):
        """Prompt-lookup speculative generation."""
        raise not_ported("generate_speculative", "speculation")


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def _prefill_step(cfg: ModelConfig, params, tokens, cache: KVCache,
                  true_lens):
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    # last real token's logits only (forward last_index docs)
    logits, cache = forward(params, cfg, tokens, cache, positions,
                            fresh=True, last_index=true_lens - 1)
    cache = cache._replace(length=true_lens.to(torch.int32))
    return logits[:, 0, :], cache


def _decode_step(cfg: ModelConfig, params, token, cache: KVCache, generator,
                 sp: SamplingParams):
    logits, cache = forward(params, cfg, token[:, None], cache)
    nxt = sample(logits[:, -1, :], generator, sp)
    return nxt, cache, generator


def _done0(first, sp: SamplingParams):
    if sp.stop_token >= 0:
        return first == sp.stop_token
    return torch.zeros_like(first, dtype=torch.bool)


def _generate_fused(cfg: ModelConfig, params, first, cache: KVCache,
                    generator, sp: SamplingParams, max_new: int):
    """Every decode step launched back to back, no host sync: rows that
    hit the stop token keep stepping but their outputs freeze (done mask
    on the device). Returns (out [B, max_new], lens [B], cache)."""
    cur, done = first, _done0(first, sp)
    toks = [first]
    for _ in range(max_new - 1):
        logits, cache = forward(params, cfg, cur[:, None], cache)
        nxt = sample(logits[:, -1, :], generator, sp)
        nxt = torch.where(done, cur, nxt)
        if sp.stop_token >= 0:
            done = done | (nxt == sp.stop_token)
        cur = nxt
        toks.append(nxt)
    out = torch.stack(toks, dim=1)
    return out, _stop_lengths_t(out, sp.stop_token), cache


def _generate_fused_win(cfg: ModelConfig, C: int, params, first,
                        cache: KVCache, generator, sp: SamplingParams,
                        max_new: int, uniform: bool = False):
    """Write-combined fused generate: C decode steps against (cache +
    prior window steps + self), then ONE write of all C tokens per cache
    tensor (flush_window). Token for token identical to _generate_fused:
    the window holds the cache's exact representation. The step count
    rounds up to a multiple of C; the tail steps' tokens are dropped."""
    B = first.shape[0]
    steps = max_new - 1
    iters = -(-steps // C) if steps else 0
    cur, done = first, _done0(first, sp)
    toks = []
    for _ in range(iters):
        window = []
        for j in range(C):
            logits, new_kv = decode_step_win(params, cfg, cur[:, None], cache,
                                             window, j)
            window.append(new_kv)
            nxt = sample(logits[:, -1, :], generator, sp)
            nxt = torch.where(done, cur, nxt)
            if sp.stop_token >= 0:
                done = done | (nxt == sp.stop_token)
            cur = nxt
            toks.append(nxt)
        cache = flush_window(cache, window, uniform=uniform)
    rest = torch.stack(toks[:steps], dim=1) if steps \
        else torch.zeros((B, 0), dtype=first.dtype, device=first.device)
    out = torch.cat([first[:, None], rest], dim=1)
    return out, _stop_lengths_t(out, sp.stop_token), cache


def _stop_lengths_t(out: torch.Tensor, stop: int) -> torch.Tensor:
    """Valid tokens per row: up to and including the first stop token."""
    B, T = out.shape
    if stop < 0:
        return torch.full((B,), T, dtype=torch.int32, device=out.device)
    hit = out == stop
    first_hit = torch.argmax(hit.to(torch.int32), dim=1)
    return torch.where(hit.any(dim=1), first_hit + 1,
                       torch.full_like(first_hit, T)).to(torch.int32)


def _stop_lengths(out: np.ndarray, stop: int) -> np.ndarray:
    return _stop_lengths_t(torch.from_numpy(np.asarray(out)), stop).numpy()


def _mask_after_stop(out: np.ndarray, lens: np.ndarray,
                     stop: int) -> np.ndarray:
    if stop < 0:
        return out
    mask = np.arange(out.shape[1])[None, :] >= lens[:, None]
    out = out.copy()
    out[mask] = stop
    return out


def cast_params(params, cfg: ModelConfig):
    """One-time cast of the weight tree to the compute dtype.

    Floating leaves already in the compute dtype are returned as they
    are (no copy); integer leaves are left alone."""
    target = torch_dtype(cfg.dtype)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if node.is_floating_point() and node.dtype != target:
            return node.to(target)
        return node
    return walk(params)


def pad_prompts(prompts: Sequence[Sequence[int]], pad_id: int = 0
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad variable-length prompts to a rectangle."""
    lens = np.asarray([len(p) for p in prompts], np.int32)
    T = int(lens.max())
    out = np.full((len(prompts), T), pad_id, np.int32)
    for i, p in enumerate(prompts):
        out[i, :len(p)] = np.asarray(p, np.int32)
    return out, lens
