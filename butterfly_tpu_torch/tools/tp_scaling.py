"""Tensor-parallel scaling model from the collectives one decode step runs:
the port of tools/tp_scaling.py.

The JAX script lowers the decode program over fake-device meshes and
reads the collectives XLA inserted out of the optimized HLO. The port has
no compiler in between: its tensor split (parallel/tensor.py) sums
row-parallel partials in `all_reduce` and concatenates vocab-split
logits in `gather`. So this tool counts them at run time, over one
decode step (models/common.py:forward, one token a row, as the JAX
script's `measure` lowers it) on a `tensor` mesh: each call's kind, one
payload's shape, dtype, elements and bytes, and the layer whose body made
it. The counters are swapped in for that step only and restored after:
no other path counts anything or pays for it.

A payload is one shard's partial for a reduction (the shape XLA gives an
all-reduce) and the gathered result for a gather (an all-gather's
output). A ring all-reduce moves 2*(tp-1)/tp of its payload per card.
On one card every shard sits on the same device, so these are copies and
adds on that device, not NVLink traffic; the output says so.

`model_row` keeps the JAX script's formula. Its constants are datasheet
figures for the card of record, NVIDIA H100 80GB HBM3 (SXM) at 700 W:
3.35 TB/s HBM, 989 TFLOP/s dense bf16, NVLink 450 GB/s each way. They
are not measurements.

    python -m butterfly_tpu_torch.tools.tp_scaling [--layers 2] [--batch 8]
        [--seq 128] [--tp 2,4,8] [--device cpu] [--out FILE]

On the card the model is Llama-3-8B's layer geometry at `--layers`
layers in bf16, every shard on cuda:0 (one shard per card where the card
count allows); with `--device cpu` a tiny f32 config whose heads, kv
heads, FFN and vocabulary divide 8.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path
from typing import Dict, List, Optional

import torch

#: datasheet figures of the card of record (not measurements)
HBM_BW = 3.35e12         # NVIDIA H100 SXM HBM3 bytes/s
PEAK_FLOPS = 989e12      # dense bf16 tensor-core peak
NVLINK_BW = 450e9        # NVLink 4, bytes/s each way per card
CARD = "NVIDIA H100 80GB HBM3 at 700 W (datasheet)"

#: the CPU config: tiny Llama whose split dims divide 8
TINY_TP = dict(vocab_size=256, num_heads=8, num_kv_heads=8, head_dim=8,
               dtype="float32", param_dtype="float32")


def _payload(kind: str, t: torch.Tensor, layer: Optional[int]) -> Dict:
    return dict(kind=kind, shape=tuple(t.shape), dtype=str(t.dtype),
                elements=t.numel(), bytes=t.numel() * t.element_size(),
                layer=layer)


@contextlib.contextmanager
def counting():
    """Count every all_reduce and gather of the tensor split while the
    block runs: yields the list the records land in. The functions are
    swapped in every module that holds them, and the decode layer body
    is wrapped to tag each record with its layer (None outside)."""
    from butterfly_tpu_torch.models import common
    from butterfly_tpu_torch.parallel import sequence, tensor
    from butterfly_tpu_torch.parallel.partition import axis_parts
    records: List[Dict] = []
    at = [None]
    plain_reduce, plain_gather = tensor.all_reduce, tensor.gather
    plain_body = common._decode_layer_body

    def all_reduce(parts, across=None):
        records.append(_payload("all_reduce", parts[0], at[0]))
        return plain_reduce(parts, across)

    def gather(x, dim):
        out = plain_gather(x, dim)
        if axis_parts(x, "tensor") is not None:
            records.append(_payload("gather", out, at[0]))
        return out

    def body(x, lp, cfg, cache, i, *a, **kw):
        at[0] = i
        try:
            return plain_body(x, lp, cfg, cache, i, *a, **kw)
        finally:
            at[0] = None
    swaps = [(m, name, new) for m, name, new in (
        (tensor, "all_reduce", all_reduce), (tensor, "gather", gather),
        (common, "gather", gather), (sequence, "gather", gather),
        (common, "_decode_layer_body", body))]
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    for m, name, new in swaps:
        setattr(m, name, new)
    try:
        yield records
    finally:
        for m, name, old in saved:
            setattr(m, name, old)


def measure(model, params, tp: int, batch: int, seq: int,
            devices: Optional[list] = None) -> List[Dict]:
    """The collectives of one decode step (one token a row after an empty
    cache) over a tensor = tp mesh of `devices` (default: tp shards on
    the tree's device). `params` is the unsharded tree; its placement is
    views where the shards share its device."""
    from butterfly_tpu_torch.core.config import MeshConfig
    from butterfly_tpu_torch.core.mesh import make_mesh, mesh_ctx
    from butterfly_tpu_torch.models.common import forward, init_cache
    from butterfly_tpu_torch.parallel.partition import (shard_cache,
                                                        shard_params)
    cfg = model.cfg
    dev = model.device
    devices = devices or [str(dev)] * tp
    mesh = make_mesh(MeshConfig(tensor=tp), devices)
    sp = shard_params(params, cfg, mesh)
    cache = shard_cache(init_cache(cfg, batch, seq, device=dev), cfg, mesh)
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    with mesh_ctx(mesh), counting() as records, torch.no_grad():
        forward(sp, cfg, tok, cache)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return records


def per_layer(records: List[Dict]) -> Dict:
    """One layer's collectives (every layer's must match) and those
    outside the layers: {"layer": [...], "outside": [...],
    "layers": n}."""
    by: Dict[int, list] = {}
    for r in records:
        if r["layer"] is not None:
            by.setdefault(r["layer"], []).append(r)
    keys = [[(r["kind"], r["shape"], r["dtype"]) for r in by[i]]
            for i in sorted(by)]
    if any(k != keys[0] for k in keys):
        raise AssertionError("layers differ in their collectives")
    return dict(layer=by[min(by)] if by else [], layers=len(by),
                outside=[r for r in records if r["layer"] is None])


def model_row(tp: int, per_layer_ar_bytes: float, cfg_layers: int = 32,
              batch: int = 8):
    """Per-card decode-step time model for Llama-3-8B int8 at `tp` (the
    JAX script's formula, the card of record's datasheet figures)."""
    weight_bytes = 8.03e9           # int8 weights (+scales) of record
    flops = 2 * 8.03e9 * batch
    comm = cfg_layers * per_layer_ar_bytes   # bytes each card moves/step
    t_compute = max(weight_bytes / tp / HBM_BW, flops / tp / PEAK_FLOPS)
    t_comm = comm / NVLINK_BW
    t = t_compute + t_comm
    t1 = max(weight_bytes / HBM_BW, flops / PEAK_FLOPS)
    eff = t1 / (tp * t)
    return t_compute, t_comm, t, eff


def build_model(device: str, layers: int):
    """(model, unsharded params): Llama-3-8B's layer geometry in bf16 on
    the card, the tiny TINY_TP config in f32 on the CPU."""
    from butterfly_tpu_torch.core.config import llama3_8b, tiny
    from butterfly_tpu_torch.models.common import Model, init_params
    if device == "cpu":
        cfg = tiny("llama", num_layers=layers, **TINY_TP)
    else:
        cfg = llama3_8b().replace(num_layers=layers, max_seq_len=2048)
    model = Model(cfg, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return model, init_params(cfg, gen, device)


def shard_devices(device: str, tp: int) -> list:
    """One shard per card where there are tp cards, else all on one."""
    if device != "cpu" and torch.cuda.device_count() >= tp:
        return [f"cuda:{i}" for i in range(tp)]
    return [device if device != "cuda" else "cuda:0"] * tp


def table(rows: Dict[int, Dict], batch: int, devices: Dict[int, list]
          ) -> List[str]:
    """The report: collectives per layer at each measured tp, then the
    projected scaling from the per-layer all-reduce payload."""
    lines = ["# TP scaling model (collectives counted at run time, "
             "parallel/tensor.py)", "",
             "| tp | reductions/layer | elements each | payload B/layer "
             "| per-card ring B/layer | outside the layers | devices |",
             "|---|---|---|---|---|---|---|"]
    payload = None
    for tp, pl in sorted(rows.items()):
        ar = [r for r in pl["layer"] if r["kind"] == "all_reduce"]
        b = sum(r["bytes"] for r in ar)
        ring = b * 2 * (tp - 1) / tp
        out = ", ".join(f"{r['kind']} {list(r['shape'])} {r['dtype']}"
                        for r in pl["outside"]) or "none"
        devs = sorted(set(devices[tp]))
        lines.append(f"| {tp} | {len(ar)} | "
                     f"{'/'.join(str(r['elements']) for r in ar) or '-'} | "
                     f"{b:,} | {ring:,.0f} | {out} | {','.join(devs)} |")
        payload = b
    one = [tp for tp, d in devices.items() if len(set(d)) == 1]
    if one:
        lines += ["", f"At tp {', '.join(map(str, sorted(one)))} every "
                  "shard sits on one device: these collectives are copies "
                  "and adds on that device, not NVLink traffic."]
    if payload:
        lines += ["", f"## Projected Llama-3-8B int8 decode scaling "
                  f"({CARD})", "",
                  f"HBM {HBM_BW / 1e12:.2f} TB/s, NVLink {NVLINK_BW / 1e9:.0f}"
                  f" GB/s each way, bf16 peak {PEAK_FLOPS / 1e12:.0f} TFLOP/s"
                  "; t = max(weights/tp/HBM, flops/tp/peak) + comm/NVLink "
                  "(no overlap assumed).", "",
                  "| tp | compute ms | comm ms | step ms | scaling "
                  "efficiency |", "|---|---|---|---|---|"]
        for tp in (1, 2, 4, 8, 16, 32, 64):
            ring = payload * 2 * (tp - 1) / tp if tp > 1 else 0.0
            tc, tm, t, eff = model_row(tp, ring, batch=batch)
            lines.append(f"| {tp} | {tc * 1e3:.3f} | {tm * 1e3:.3f} | "
                         f"{t * 1e3:.3f} | {eff * 100:.1f}% |")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m butterfly_tpu_torch.tools.tp_scaling")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--tp", default="2,4,8",
                    help="tensor sizes to measure, comma-separated")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="also write the report to this file")
    args = ap.parse_args(argv)
    model, params = build_model(args.device, args.layers)
    rows, devs = {}, {}
    for tp in (int(t) for t in args.tp.split(",")):
        devs[tp] = shard_devices(args.device, tp)
        rows[tp] = per_layer(measure(model, params, tp, args.batch,
                                     args.seq, devs[tp]))
        print(f"tp={tp}: {len(rows[tp]['layer'])} collectives a layer",
              file=sys.stderr)
    lines = table(rows, args.batch, devs)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
