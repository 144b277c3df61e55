"""PyTorch port: prefix caching and the host KV tier against the JAX
package, on tiny llama in f32 on the CPU.

cache/prefix.py and cache/hosttier.py are the port's own copies (the
tier holds CPU tensors); the scheduler's admission walk, eviction hook
and reviver are the carried-over host logic. Closed-loop runs (submit
all, run_until_done) of prompts that share page-aligned prefixes, in both
dispatch modes, with a roomy pool, a pool starved enough to preempt, and
that starved pool with a host tier: greedy tokens must be byte-identical
to the JAX scheduler's with prefix caching on and to the port's own run
without it; the hit, preemption and tier counters must equal the
reference's."""
import jax
import numpy as np
import pytest
import torch

from butterfly_tpu.cache import prefix as J
from butterfly_tpu.core.config import RuntimeConfig as JRuntime, tiny
from butterfly_tpu.engine.serving import ServingEngine as JEngine
from butterfly_tpu.models.common import Model as JModel
from butterfly_tpu.sched.scheduler import Scheduler as JScheduler
from butterfly_tpu_torch.cache import prefix as T
from butterfly_tpu_torch.cache.hosttier import HostKVTier
from butterfly_tpu_torch.core import config as tconfig
from butterfly_tpu_torch.engine.serving import ServingEngine
from butterfly_tpu_torch.models.bridge import params_from_numpy
from butterfly_tpu_torch.models.common import Model
from butterfly_tpu_torch.sched.scheduler import Scheduler

torch.set_num_threads(1)

CFG = tiny("llama", dtype="float32", param_dtype="float32")
TCFG = tconfig.tiny("llama", dtype="float32", param_dtype="float32")
PAGE = 8
COUNTERS = ("prefix_cache_hit_tokens", "prefix_cache_lookup_tokens",
            "preemptions_total", "kv_tier_pages_saved_total",
            "kv_tier_pages_restored_total", "kv_tier_misses_total")


@pytest.fixture(scope="module")
def weights():
    jp = JModel(CFG).init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _prompts():
    """8 prompts over three 2-page shared prefixes, unique tails."""
    rng = np.random.RandomState(0)
    heads = [rng.randint(1, 200, 2 * PAGE).tolist() for _ in range(3)]
    return [heads[i % 3] + rng.randint(1, 200, 3 + i).tolist()
            for i in range(8)]


# -- the hash chain and the allocator (pure host) -----------------------------

@pytest.mark.parametrize("page", [1, 4, 8, 16])
def test_chain_block_hashes_equal_the_reference(page):
    rng = np.random.RandomState(page)
    for n in (0, page - 1, page, 3 * page + 2, 10 * page):
        toks = rng.randint(0, 2 ** 31 - 1, max(n, 0)).tolist()
        want = J.chain_block_hashes(toks, page)
        assert T.chain_block_hashes(toks, page) == want
        assert [h.hex() for h in T.chain_block_hashes(toks, page, 2)] \
            == [h.hex() for h in want[:2]]


def test_allocator_follows_the_reference_op_for_op():
    """A seeded random run of admit / register / release / import_page /
    pin on both allocators: every return value and every page table
    equal, invariants held after each step."""
    rng = np.random.RandomState(1)
    heads = [rng.randint(0, 50, 12).tolist() for _ in range(3)]
    a = J.PrefixCachingAllocator(24, 4, 8)
    b = T.PrefixCachingAllocator(24, 4, 8)
    held = set()
    for _ in range(400):
        op = rng.randint(4)
        slot = int(rng.randint(6))
        if op == 0 and slot not in held:
            toks = heads[rng.randint(3)] + rng.randint(0, 50,
                                                       rng.randint(1, 12)
                                                       ).tolist()
            need = len(toks) + int(rng.randint(1, 6))
            got = (a.admit(slot, toks, need), b.admit(slot, toks, need))
            assert got[0] == got[1]
            if got[0] is not None:
                held.add(slot)
                assert a.register(slot, toks) == b.register(slot, toks)
        elif op == 1 and slot in held:
            assert a.release(slot) == b.release(slot)
            held.discard(slot)
        elif op == 2:
            h = J.chain_block_hashes(heads[rng.randint(3)], 4)[-1]
            try:
                want = a.import_page(h)
            except MemoryError:
                with pytest.raises(MemoryError):
                    b.import_page(h)
            else:
                assert b.import_page(h) == want
        else:
            h = J.chain_block_hashes(heads[rng.randint(3)], 4)[0]
            pid = a.lookup(h)
            assert b.lookup(h) == pid
            if pid is not None:
                a.pin([pid])
                b.pin([pid])
                a.unpin([pid])
                b.unpin([pid])
        for s in range(6):
            assert a.pages_of(s) == b.pages_of(s)
        assert a.free_pages == b.free_pages
        a.check_invariants()
        b.check_invariants()
    assert (a.hit_tokens, a.lookup_tokens) == (b.hit_tokens, b.lookup_tokens)


def test_host_tier_keeps_bf16_cpu_tensors(tmp_path):
    """The tier's one host representation: CPU tensors in the pool's
    dtype (bf16 has no numpy form), copied on save, byte-exact through
    the LRU, the disk spill and the promotion back."""
    gen = torch.Generator()
    gen.manual_seed(0)

    def page():
        return (torch.randn((2, 2, 8, 16), generator=gen).to(torch.bfloat16),
                torch.randn((2, 2, 8, 16), generator=gen).to(torch.bfloat16))
    one = page()
    nbytes = 2 * one[0].nbytes
    tier = HostKVTier(capacity_bytes=nbytes, spill_dir=str(tmp_path))
    src = torch.cat([one[0][None], one[0][None]])   # a view is saved
    tier.save(b"a", src[1], one[1])
    src.zero_()                                     # the tier copied
    two = page()
    tier.save(b"b", *two)                           # spills "a" to disk
    assert tier.spills == 1 and tier.bytes_used == nbytes
    k, v, ks, vs = tier.load(b"a")                  # promoted back
    assert k.dtype == torch.bfloat16 and k.device.type == "cpu"
    assert torch.equal(k, one[0]) and torch.equal(v, one[1])
    assert ks is None and vs is None
    assert tier.restores == 1 and tier.load(b"zz") is None
    assert tier.misses == 1


# -- closed-loop scheduler runs against the JAX scheduler ---------------------

# (pool pages, host tier MiB, max new tokens): roomy, starved enough to
# preempt, and the starved pool with a host tier
SCENARIOS = {"roomy": (0, 0.0, 12), "starved": (8, 0.0, 12),
             "starved_tier": (8, 1.0, 12)}


def _run(sched_cls, engine, prompts, max_new):
    s = sched_cls(engine)
    reqs = [s.submit(p, max_new_tokens=max_new) for p in prompts]
    s.run_until_done()
    assert all(r.state == "finished" and len(r.output) == max_new
               for r in reqs)
    if hasattr(s.alloc, "check_invariants"):
        s.alloc.check_invariants()
    m = s.metrics()
    return [r.output for r in reqs], {k: m.get(k) for k in COUNTERS}


@pytest.fixture(scope="module")
def engines(weights):
    """(JAX engine, port engine) per (dispatch mode, pool pages), shared
    by the scenarios of one pool: each run gets a fresh Scheduler, and
    the runtime is set per run (as the operating-point sweep does)."""
    jp, tp = weights
    made = {}

    def get(mixed, pages):
        if (mixed, pages) not in made:
            rt = dict(max_batch_size=2, max_seq_len=64, page_size=PAGE,
                      num_pages=pages, mixed_dispatch=mixed)
            made[mixed, pages] = (
                JEngine(JModel(CFG), jp, JRuntime(**rt), use_kernels=False),
                ServingEngine(Model(TCFG, device="cpu"), tp,
                              tconfig.RuntimeConfig(**rt)))
        return made[mixed, pages]
    return get


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "alternating"])
def test_prefix_caching_matches_jax_scheduler(engines, mixed, scenario):
    pages, tier_mb, max_new = SCENARIOS[scenario]
    jeng, engine = engines(mixed, pages)
    for e in (jeng, engine):
        e.runtime = e.runtime.replace(prefix_caching=True,
                                      host_kv_tier_mb=tier_mb)
    prompts = _prompts()
    want, jm = _run(JScheduler, jeng, prompts, max_new)
    got, tm = _run(Scheduler, engine, prompts, max_new)
    assert got == want
    assert tm == jm
    # the same engine without prefix caching decodes the same tokens
    engine.runtime = engine.runtime.replace(prefix_caching=False,
                                            host_kv_tier_mb=0.0)
    plain, pm = _run(Scheduler, engine, prompts, max_new)
    assert plain == got and pm["prefix_cache_hit_tokens"] is None
    if scenario == "roomy":
        assert tm["prefix_cache_hit_tokens"] > 0
    else:
        assert tm["preemptions_total"] > 0
    if scenario == "starved" and not mixed:
        # preempted requests readmit through their warm pages
        assert tm["prefix_cache_hit_tokens"] > 0
    if scenario == "starved_tier":
        assert tm["kv_tier_pages_saved_total"] > 0
        assert tm["kv_tier_pages_restored_total"] > 0
        assert tm["prefix_cache_hit_tokens"] > 0
