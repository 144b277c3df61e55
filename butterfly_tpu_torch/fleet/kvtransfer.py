"""Cross-replica KV page transfer: chain-hash-addressed export/import.

The port of butterfly_tpu/fleet/kvtransfer.py, with the same payload
format: page bytes are the pool's raw little-endian element bytes in
base64, with the dtype named as numpy names it ("bfloat16", "float32",
"float16", "int8"), so a payload crosses between the two packages. The
port reads and writes CPU tensors (numpy has no bfloat16): bytes go out
through a uint8 view of the tensor and come back through a view of the
same width.

The prefix cache (cache/prefix.py) already makes every registered KV
page content-addressable: page i's key is a SHA-256 chain digest
committing to all tokens of blocks 0..i. This module serializes those
pages between replicas by that key — the replica half of a
disaggregated prefill/decode handoff (the JAX package's
fleet/controlplane.py drives it over GET /kv/pages and POST /kv/import):

* ``export_payload(sched, hex_hashes)`` — resolve the requested chain
  on the LOCAL registry, pin the matched leading run against eviction,
  read the page contents to the host in one gather, unpin, and return
  a JSON-safe payload (base64 page bytes + dtype/shape metadata +
  geometry). When the replica carries a host KV tier
  (cache/hosttier.py) the leading run continues from it where the
  device registry misses — evicted chains stay exportable. Hashes past
  the first miss of BOTH tiers are reported ``missing`` — pages behind
  a gap could never be attached by ``admit`` anyway.
* ``import_payload(sched, payload)`` — validate geometry (page size,
  layer/head/dim counts, dtype, quantization MUST match; a mismatched
  import would alias garbage K/V under a valid-looking hash), claim
  free pages via ``import_page`` in chain order, scatter the bytes into
  the local pool, and leave the pages warm in the registry so the next
  admission of the same prefix hits them like any local prefix-cache
  entry.

Correctness never depends on a transfer landing: an evicted / missing /
partially imported chain just means the decode replica prefills the
uncovered tail itself. Both sides run under the serving lock
(serve/server.py handler threads), so the scheduler thread can neither
dispatch onto the pools mid-read nor recycle a page mid-write.
"""
from __future__ import annotations

import base64
import math
from typing import Dict, List

import torch

PAYLOAD_VERSION = 1

#: payload dtype names (numpy's spelling, as the JAX package writes them)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _enc(t: torch.Tensor) -> Dict:
    t = t.detach().to("cpu").contiguous()
    raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return {"b64": base64.b64encode(raw).decode("ascii"),
            "dtype": _NAMES[t.dtype], "shape": list(t.shape)}


def _dec(obj: Dict) -> torch.Tensor:
    """A CPU tensor from an _enc entry; ValueError when the bytes do not
    fill the stated shape, KeyError for an unknown dtype name."""
    dtype = _DTYPES[obj["dtype"]]
    shape = [int(n) for n in obj["shape"]]
    raw = base64.b64decode(obj["b64"])
    if len(raw) != math.prod(shape) * dtype.itemsize:
        raise ValueError(f"{len(raw)} bytes do not fill {shape} of "
                         f"{obj['dtype']}")
    flat = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    return flat.view(dtype).reshape(shape)


def _geometry(sched) -> Dict:
    cache = sched.engine.cache
    return {
        "page_size": cache.page_size,
        "num_layers": int(cache.k_pages.shape[0]),
        "num_kv_heads": int(cache.k_pages.shape[2]),
        "head_dim": int(cache.k_pages.shape[4]),
        "dtype": _NAMES[cache.k_pages.dtype],
        "quantized": bool(cache.quantized),
    }


def _registry_alloc(sched):
    """The scheduler's allocator, iff it carries the prefix registry the
    transfer is keyed by (prefix_caching on)."""
    alloc = sched.alloc
    if not hasattr(alloc, "lookup"):
        raise LookupError(
            "KV transfer requires prefix caching (--prefix-caching): "
            "without the content-hash page registry there is nothing "
            "to address pages by")
    return alloc


def export_payload(sched, hex_hashes: List[str]) -> Dict:
    """Serialize the leading registered run of `hex_hashes` from
    `sched`'s page pool. Caller holds the serving lock."""
    alloc = _registry_alloc(sched)
    hashes = [bytes.fromhex(h) for h in hex_hashes]
    matched: List[int] = []
    for h in hashes:
        pid = alloc.lookup(h)
        if pid is None:
            break
        matched.append(pid)
    # continue the leading run from the host tier (cache/hosttier.py):
    # a chain this replica evicted to host DRAM is still exportable —
    # the bytes are already host-resident, so no device read is needed
    # for the continuation. Chain contiguity holds: the tier pages
    # start exactly where the device registry missed.
    tier = getattr(sched, "host_tier", None)
    tier_pages: List[tuple] = []
    if tier is not None:
        for i in range(len(matched), len(hashes)):
            data = tier.load(hashes[i])
            if data is None:
                break
            tier_pages.append((hex_hashes[i], data))
    payload: Dict = {
        "version": PAYLOAD_VERSION,
        "meta": _geometry(sched),
        "pages": [],
        "missing": hex_hashes[len(matched) + len(tier_pages):],
        "bytes": 0,
    }
    if not matched and not tier_pages:
        return payload
    total = 0
    if matched:
        # pin the whole run before any device read: the gather below
        # may release the GIL, and an admission on the scheduler thread
        # (once the lock is handed back between chunked exports) must
        # never recycle a page mid-transfer
        alloc.pin(matched)
        try:
            k, v, ks, vs = sched.engine.read_pages(matched)
        finally:
            alloc.unpin(matched)
        for i, h in enumerate(hex_hashes[:len(matched)]):
            entry = {"hash": h, "k": _enc(k[:, i]), "v": _enc(v[:, i])}
            total += k[:, i].nbytes + v[:, i].nbytes
            if ks is not None:
                entry["k_scale"] = _enc(ks[:, i])
                entry["v_scale"] = _enc(vs[:, i])
                total += ks[:, i].nbytes + vs[:, i].nbytes
            payload["pages"].append(entry)
    for h, (k1, v1, ks1, vs1) in tier_pages:
        entry = {"hash": h, "k": _enc(k1), "v": _enc(v1)}
        total += k1.nbytes + v1.nbytes
        if ks1 is not None:
            entry["k_scale"] = _enc(ks1)
            entry["v_scale"] = _enc(vs1)
            total += ks1.nbytes + vs1.nbytes
        payload["pages"].append(entry)
    payload["bytes"] = total
    return payload


def import_payload(sched, payload: Dict) -> Dict:
    """Land an export_payload into `sched`'s pool + prefix registry.
    Caller holds the serving lock. Raises ValueError on geometry
    mismatch (nothing imported); page exhaustion mid-chain stops the
    import with the leading run landed (reported ``no_space``)."""
    alloc = _registry_alloc(sched)
    if int(payload.get("version", -1)) != PAYLOAD_VERSION:
        raise ValueError(f"unsupported KV payload version "
                         f"{payload.get('version')!r}")
    meta, local = payload.get("meta", {}), _geometry(sched)
    bad = {k: (meta.get(k), local[k]) for k in local
           if meta.get(k) != local[k]}
    if bad:
        raise ValueError(
            "KV geometry mismatch (theirs vs ours): "
            + ", ".join(f"{k}={a!r}/{b!r}" for k, (a, b) in bad.items()))
    imported = skipped = 0
    no_space = False
    pids: List[int] = []
    ks_list, vs_list = [], []
    k_list, v_list = [], []
    for entry in payload.get("pages", ()):
        h = bytes.fromhex(entry["hash"])
        try:
            pid = alloc.import_page(h)
        except MemoryError:
            no_space = True
            break  # chain order: what landed is a usable leading run
        if pid is None:
            skipped += 1
            continue
        pids.append(pid)
        k_list.append(_dec(entry["k"]))
        v_list.append(_dec(entry["v"]))
        if local["quantized"]:
            ks_list.append(_dec(entry["k_scale"]))
            vs_list.append(_dec(entry["v_scale"]))
        imported += 1
    if pids:
        # one stacked scatter: [L, n, Kv, page, H] in page order
        k = torch.stack(k_list, dim=1)
        v = torch.stack(v_list, dim=1)
        ks = torch.stack(ks_list, dim=1) if ks_list else None
        vs = torch.stack(vs_list, dim=1) if vs_list else None
        sched.engine.write_pages(pids, k, v, ks, vs)
    return {"imported": imported, "skipped": skipped,
            "no_space": no_space, "free_pages": alloc.free_pages}
