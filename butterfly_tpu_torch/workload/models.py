"""Request-population specs: what a workload's traffic looks like.

A `Workload` is a weighted mix of `Cohort`s; each cohort draws its
prompt length and decode budget from a composable distribution
(`Uniform` / `LogNormal` / `Buckets` — the bucketed-empirical form fits
measured production histograms) and may share a **page-aligned prefix**
with every other request of its cohort (the "same chat template /
system prompt" population). Shared prefixes are sized in whole KV pages
so they register and hash as complete `chain_block_hashes` blocks
(cache/prefix.py) — the same alignment tools/loadgen.py's
`shared_prefix` uses — which is what lets the prefix cache and the
router's affinity ring actually see the sharing.

`Workload.sample(n, seed)` is deterministic and **insertion-order
independent**: every request draws from its own seeded stream
(`Random(seed, index)`), so the same spec + seed yields a byte-identical
trace regardless of how the caller slices or extends it, and a
mutation anywhere in one request's draw chain cannot shift every later
request (the property the determinism tests pin).

stdlib-only: generating a trace needs no torch, no numpy, no device. A
copy of butterfly_tpu/workload/models.py.
"""
from __future__ import annotations

import hashlib
import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

# ---------------------------------------------------------------------------
# Length distributions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Uniform:
    """Integer uniform on [lo, hi] inclusive."""
    lo: int
    hi: int

    def sample(self, rng: random.Random) -> int:
        return rng.randint(self.lo, self.hi)

    def spec(self) -> Dict:
        return {"dist": "uniform", "lo": self.lo, "hi": self.hi}


@dataclass(frozen=True)
class LogNormal:
    """Lognormal with a given median, clamped to [lo, hi].

    The natural shape for prompt/response lengths: most requests are
    short, a heavy tail is long (Splitwise, arXiv:2311.18677 fig. 3).
    `sigma` is the log-space standard deviation (0.7 ~ a 2x spread
    around the median per sigma).
    """
    median: float
    sigma: float
    lo: int
    hi: int

    def sample(self, rng: random.Random) -> int:
        v = self.median * math.exp(rng.gauss(0.0, self.sigma))
        return max(self.lo, min(self.hi, int(round(v))))

    def spec(self) -> Dict:
        return {"dist": "lognormal", "median": self.median,
                "sigma": self.sigma, "lo": self.lo, "hi": self.hi}


@dataclass(frozen=True)
class Buckets:
    """Bucketed-empirical: weighted (lo, hi, weight) ranges.

    Fit a measured histogram directly: pick a bucket by weight, then
    uniform within it. The tuple-of-tuples form keeps the spec hashable
    (frozen dataclasses are jit-static-friendly and dict-key-safe).
    """
    buckets: Tuple[Tuple[int, int, float], ...]

    def sample(self, rng: random.Random) -> int:
        total = sum(w for _, _, w in self.buckets)
        x = rng.random() * total
        for lo, hi, w in self.buckets:
            x -= w
            if x <= 0:
                return rng.randint(lo, hi)
        lo, hi, _ = self.buckets[-1]
        return rng.randint(lo, hi)

    def spec(self) -> Dict:
        return {"dist": "buckets",
                "buckets": [list(b) for b in self.buckets]}


Dist = Union[Uniform, LogNormal, Buckets]


def dist_from_spec(spec: Dict) -> Dist:
    kind = spec.get("dist")
    if kind == "uniform":
        return Uniform(int(spec["lo"]), int(spec["hi"]))
    if kind == "lognormal":
        return LogNormal(float(spec["median"]), float(spec["sigma"]),
                         int(spec["lo"]), int(spec["hi"]))
    if kind == "buckets":
        return Buckets(tuple((int(lo), int(hi), float(w))
                             for lo, hi, w in spec["buckets"]))
    raise ValueError(f"unknown distribution spec {spec!r}")


# ---------------------------------------------------------------------------
# Cohorts and workloads
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Cohort:
    """One request population inside a workload.

    `shared_prefix_pages` > 0 gives every request of this cohort the
    same leading token block, sized in whole KV pages so the prefix
    registers/hashes as complete chain blocks (the chat-template
    population the prefix cache and router affinity exist for). The
    prefix tokens are derived from (workload name, cohort name) alone —
    NOT the sample seed — so traces sampled with different seeds still
    present one stable prefix population to a cache.
    """
    name: str
    weight: float
    prompt_len: Dist
    max_new: Dist
    shared_prefix_pages: int = 0
    temperature: float = 0.0
    priority: str = "interactive"
    deadline_ms: Optional[float] = None
    speculative: bool = True

    def spec(self) -> Dict:
        return {"name": self.name, "weight": self.weight,
                "prompt_len": self.prompt_len.spec(),
                "max_new": self.max_new.spec(),
                "shared_prefix_pages": self.shared_prefix_pages,
                "temperature": self.temperature,
                "priority": self.priority,
                "deadline_ms": self.deadline_ms,
                "speculative": self.speculative}


@dataclass
class RequestSpec:
    """One sampled request of a trace (the unit replay fires)."""
    index: int
    cohort: str
    tokens: List[int]
    max_new: int
    temperature: float = 0.0
    priority: str = "interactive"
    deadline_ms: Optional[float] = None
    speculative: bool = True
    arrival_s: float = 0.0  # offset from trace start (arrivals.py)

    def payload(self) -> Dict:
        """The /generate request body this spec stands for."""
        body: Dict = {"tokens": list(self.tokens),
                      "max_tokens": self.max_new,
                      "stop_token": -1,
                      "request_id": f"trace-{self.index}"}
        if self.temperature:
            body["temperature"] = self.temperature
        if self.priority != "interactive":
            body["priority"] = self.priority
        if self.deadline_ms is not None:
            body["deadline_ms"] = self.deadline_ms
        if not self.speculative:
            body["speculative"] = False
        return body

    def to_json(self) -> Dict:
        return {"index": self.index, "cohort": self.cohort,
                "tokens": list(self.tokens), "max_new": self.max_new,
                "temperature": self.temperature,
                "priority": self.priority,
                "deadline_ms": self.deadline_ms,
                "speculative": self.speculative,
                "arrival_s": self.arrival_s}

    @classmethod
    def from_json(cls, obj: Dict) -> "RequestSpec":
        return cls(index=int(obj["index"]), cohort=str(obj["cohort"]),
                   tokens=[int(t) for t in obj["tokens"]],
                   max_new=int(obj["max_new"]),
                   temperature=float(obj.get("temperature", 0.0)),
                   priority=str(obj.get("priority", "interactive")),
                   deadline_ms=(None if obj.get("deadline_ms") is None
                                else float(obj["deadline_ms"])),
                   speculative=bool(obj.get("speculative", True)),
                   arrival_s=float(obj.get("arrival_s", 0.0)))


def _stream(seed: int, *parts) -> random.Random:
    """An independent deterministic substream: SHA-256 over (seed,
    parts) -> Random seed. Substreams never share state, so one
    request's draw count can't shift another's values (and Python's
    Mersenne seeding from a big int is version-stable)."""
    h = hashlib.sha256(("%d|" % seed + "|".join(str(p) for p in parts))
                       .encode()).digest()
    return random.Random(int.from_bytes(h[:8], "big"))


@dataclass(frozen=True)
class Workload:
    """A named, weighted mix of cohorts over a token-id vocabulary."""
    name: str
    cohorts: Tuple[Cohort, ...]
    vocab: int = 258            # tiny-model/ByteTokenizer default
    page_size: int = 16         # prefix alignment unit (match the server)

    def __post_init__(self):
        if not self.cohorts:
            raise ValueError("workload needs at least one cohort")
        for c in self.cohorts:
            if c.weight <= 0:
                raise ValueError(f"cohort {c.name!r} weight must be > 0")
            if c.priority not in ("interactive", "batch"):
                raise ValueError(f"cohort {c.name!r}: unknown priority "
                                 f"{c.priority!r}")

    def prefix_tokens(self, cohort: Cohort) -> List[int]:
        """The cohort's shared leading block: page-aligned length, token
        ids derived from (workload, cohort) names only — stable across
        sample seeds, so every trace of this workload shares it."""
        n = cohort.shared_prefix_pages * self.page_size
        if n <= 0:
            return []
        rng = _stream(0, "prefix", self.name, cohort.name,
                      self.vocab, self.page_size)
        return [rng.randrange(1, self.vocab) for _ in range(n)]

    def sample(self, n: int, seed: int = 0) -> List[RequestSpec]:
        """Generate `n` request specs, deterministically.

        Prompt length is max(sampled, prefix + 1): a cohort's shared
        prefix is always followed by at least one private token, so
        last-token logits never come off a shared page."""
        cum: List[Tuple[float, Cohort]] = []
        acc = 0.0
        for c in self.cohorts:
            acc += c.weight
            cum.append((acc, c))
        total = acc
        prefixes = {c.name: self.prefix_tokens(c) for c in self.cohorts}
        specs: List[RequestSpec] = []
        for i in range(n):
            rng = _stream(seed, "req", self.name, i)
            x = rng.random() * total
            cohort = next(c for hi, c in cum if x <= hi)
            prefix = prefixes[cohort.name]
            plen = max(cohort.prompt_len.sample(rng), len(prefix) + 1)
            tail = [rng.randrange(1, self.vocab)
                    for _ in range(plen - len(prefix))]
            specs.append(RequestSpec(
                index=i, cohort=cohort.name, tokens=prefix + tail,
                max_new=cohort.max_new.sample(rng),
                temperature=cohort.temperature,
                priority=cohort.priority,
                deadline_ms=cohort.deadline_ms,
                speculative=cohort.speculative))
        return specs

    @property
    def max_prompt_len(self) -> int:
        """Upper bound on sampled prompt length (pool-sizing aid)."""
        out = 0
        for c in self.cohorts:
            hi = c.prompt_len.hi if not isinstance(c.prompt_len, Buckets) \
                else max(b[1] for b in c.prompt_len.buckets)
            out = max(out, hi, c.shared_prefix_pages * self.page_size + 1)
        return out

    @property
    def max_new_hi(self) -> int:
        out = 0
        for c in self.cohorts:
            hi = c.max_new.hi if not isinstance(c.max_new, Buckets) \
                else max(b[1] for b in c.max_new.buckets)
            out = max(out, hi)
        return out

    def spec(self) -> Dict:
        return {"name": self.name, "vocab": self.vocab,
                "page_size": self.page_size,
                "cohorts": [c.spec() for c in self.cohorts]}

    @classmethod
    def from_spec(cls, spec: Dict) -> "Workload":
        return cls(name=str(spec["name"]),
                   vocab=int(spec.get("vocab", 258)),
                   page_size=int(spec.get("page_size", 16)),
                   cohorts=tuple(Cohort(
                       name=str(c["name"]), weight=float(c["weight"]),
                       prompt_len=dist_from_spec(c["prompt_len"]),
                       max_new=dist_from_spec(c["max_new"]),
                       shared_prefix_pages=int(
                           c.get("shared_prefix_pages", 0)),
                       temperature=float(c.get("temperature", 0.0)),
                       priority=str(c.get("priority", "interactive")),
                       deadline_ms=(None if c.get("deadline_ms") is None
                                    else float(c["deadline_ms"])),
                       speculative=bool(c.get("speculative", True)))
                       for c in spec["cohorts"]))


# ---------------------------------------------------------------------------
# Canned workloads
# ---------------------------------------------------------------------------


def mixed_chat(*, page_size: int = 16, vocab: int = 258,
               prompt_lo: int = 32, prompt_hi: int = 1024,
               max_new_lo: int = 8, max_new_hi: int = 256,
               deadline_ms: Optional[float] = None) -> Workload:
    """The canned preemption-forcing mixed workload.

    Five cohorts modeling a chat service's production mix:

    * ``chat`` (45%) — the main interactive population: two shared
      template pages (system prompt), lognormal prompts/responses.
    * ``chat_alt`` (20%) — a second template cohort (different shared
      prefix), shorter prompts: two prefix populations is the minimum
      that exercises affinity *splitting* rather than one hot arc.
    * ``doc_batch`` (20%) — batch-priority long-prompt/short-answer
      summarization: the shed-first, preempt-first class.
    * ``probe`` (15%) — short interactive probes; carries the
      workload's deadline budget when one is declared.
    * ``long_doc`` (10%) — the top of the prompt range
      (prompt_hi/2..prompt_hi; 512-1024 at the default sizing), batch
      priority, near-minimal decode budget: prompts that exceed
      prefill_chunk and so CHUNK across scheduler ticks, putting the
      warm-prefix prefill path (flash cached-prefix kernel vs dense
      fallback) under the mixed bench's clock. Under a seq-parallel
      mesh with ``seq_parallel_threshold`` below prompt_hi, the
      cohort's longest prompts additionally route through the
      scheduler's seq-parallel prefill lane, so the mixed bench
      exercises the lane's chunk dispatches against live decode
      traffic (the dedicated ``longctx_*`` bench row measures that
      interference in isolation).

    Prompt lengths span [prompt_lo, prompt_hi] (default 32-1024),
    decode budgets [max_new_lo, max_new_hi] — heterogeneous enough
    that page demand is bursty and slot lifetimes interleave, which
    (with a pool sized below worst-case demand) is what drives
    preemption, shedding, and deadline scrubbing instead of the
    uniform 128/128 best case.
    """
    mid_prompt = max(prompt_lo + 1, min(prompt_hi, 3 * prompt_lo))
    mid_new = max(max_new_lo + 1, min(max_new_hi,
                                      (max_new_lo + max_new_hi) // 3))
    prefix_pages = max(1, min(2, (prompt_lo - 1) // page_size))
    return Workload(
        name="mixed_chat", vocab=vocab, page_size=page_size,
        cohorts=(
            Cohort("chat", 0.45,
                   LogNormal(mid_prompt, 0.7, prompt_lo, prompt_hi),
                   LogNormal(mid_new, 0.6, max_new_lo, max_new_hi),
                   shared_prefix_pages=prefix_pages),
            Cohort("chat_alt", 0.20,
                   LogNormal(max(prompt_lo + 1, 2 * prompt_lo), 0.5,
                             prompt_lo, prompt_hi),
                   Uniform(max_new_lo, max(max_new_lo, max_new_hi // 2)),
                   shared_prefix_pages=prefix_pages),
            Cohort("doc_batch", 0.20,
                   Uniform(max(prompt_lo, prompt_hi // 2), prompt_hi),
                   Uniform(max_new_lo, max(max_new_lo, max_new_hi // 4)),
                   priority="batch"),
            Cohort("probe", 0.15,
                   Uniform(prompt_lo, min(prompt_hi, 2 * prompt_lo)),
                   Uniform(max_new_lo, max(max_new_lo, max_new_hi // 2)),
                   deadline_ms=deadline_ms),
            Cohort("long_doc", 0.10,
                   Uniform(max(prompt_lo, prompt_hi // 2), prompt_hi),
                   Uniform(max_new_lo, max(max_new_lo, max_new_hi // 8)),
                   priority="batch"),
        ))


def uniform(*, page_size: int = 16, vocab: int = 258,
            prompt_lo: int = 128, prompt_hi: Optional[int] = None,
            max_new_lo: int = 128, max_new_hi: Optional[int] = None,
            deadline_ms: Optional[float] = None) -> Workload:
    """The legacy best-case shape (every request identical when hi is
    left at lo) as a named workload, so sweeps can compare mixed vs
    uniform on one substrate. Same kwarg surface as mixed_chat so the
    CLI sizing flags apply to either."""
    return Workload(
        name="uniform", vocab=vocab, page_size=page_size,
        cohorts=(Cohort("uniform", 1.0,
                        Uniform(prompt_lo, prompt_hi or prompt_lo),
                        Uniform(max_new_lo, max_new_hi or max_new_lo),
                        deadline_ms=deadline_ms),))


WORKLOADS = {"mixed_chat": mixed_chat, "uniform": uniform}


def get_workload(name: str, **overrides) -> Workload:
    """Resolve a canned workload by name with sizing overrides."""
    try:
        factory = WORKLOADS[name]
    except KeyError:
        raise ValueError(f"unknown workload {name!r}: expected one of "
                         f"{sorted(WORKLOADS)}") from None
    return factory(**overrides)
