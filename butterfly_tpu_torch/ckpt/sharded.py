"""The port's own checkpoint save/load, and serving snapshots for failure
recovery: the counterpart of butterfly_tpu/ckpt/sharded.py.

Layout under <dir>/:
  params/params.safetensors   the weight tree, one tensor per dotted tree
                              path ("layers.attn.wq", "lm_head.q8", ...),
                              written by ckpt/safetensors_io.py
  butterfly.json              {"model_config": {...}, "step": N}

The reference writes `params/` as an Orbax OCDBT tree. The port does not
read or write Orbax directories: that format needs tensorstore, not
torch. A tree placed over a mesh is gathered leaf by leaf as it is
written (tensor parts concatenated, one data replica), and `load_sharded`
places each leaf over a mesh as `parallel/partition.py:shard_params`
would, straight from the file: only each device's parts are copied to
it, so the whole tree never lands on one device first.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict

import torch

from butterfly_tpu_torch.ckpt.safetensors_io import SafetensorsDir, save_file
from butterfly_tpu_torch.core.config import ModelConfig
from butterfly_tpu_torch.core.device import resolve_device


def _flat(tree: Dict, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _unflat(flat: Dict[str, Any]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _gather(leaf) -> torch.Tensor:
    """A leaf on the host, whole: a mesh-placed leaf's tensor parts
    concatenated on their split dim (another process's gathered from
    it), its data replicas taken once."""
    from butterfly_tpu_torch.parallel.partition import Shards
    if isinstance(leaf, Shards):
        if leaf.split is None:
            return _gather(leaf.parts[0])
        if leaf.distributed:    # every process joins the all-gather
            from butterfly_tpu_torch.parallel.tensor import gather
            return gather(leaf, leaf.split).detach().to("cpu")
        return torch.cat([_gather(p) for p in leaf.parts], dim=leaf.split)
    return leaf.detach().to("cpu")


def save_checkpoint(path: str, params: Any, cfg: ModelConfig,
                    step: int = 0) -> None:
    """Write params (+ config sidecar) to `path`; a tree placed over a
    mesh is written whole."""
    p = Path(path).absolute()
    (p / "params").mkdir(parents=True, exist_ok=True)
    save_file(_flat(params), p / "params" / "params.safetensors",
              to_host=_gather)
    (p / "butterfly.json").write_text(json.dumps({
        "model_config": dataclasses.asdict(cfg), "step": step}))


def load_config(path: str) -> tuple[ModelConfig, int]:
    meta = json.loads((Path(path).absolute() / "butterfly.json").read_text())
    return ModelConfig(**meta["model_config"]), int(meta.get("step", 0))


def load_sharded(path: str, cfg: ModelConfig, mesh=None,
                 device=None) -> Any:
    """Restore params as saved (dtypes, int8 leaves included). With a
    mesh, each leaf lands in `shard_params`'s layout, on its devices;
    without one, the tree goes to `device` (None = CUDA)."""
    files = sorted((Path(path).absolute() / "params").glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no params/*.safetensors under {path}")
    host = dict(SafetensorsDir(files))   # mapped, not read
    if mesh is None:
        dev = resolve_device(device)
        return _unflat({k: v.to(dev, copy=True) for k, v in host.items()})
    from butterfly_tpu_torch.parallel.partition import shard_params
    if all(torch.device(d).type == "cpu" for d in mesh.devices.flat):
        # shard_params keeps views of a leaf already on its device: give
        # it leaves of their own, not maps of the file
        host = {k: v.clone() for k, v in host.items()}
    return shard_params(_unflat(host), cfg, mesh)


def save_serving_snapshot(path: str, scheduler) -> None:
    """Host-side serving state for failure recovery: queued + running
    requests (prompt + generated tokens). On restore they are resubmitted
    and their KV recomputed — the paged pool itself is NOT checkpointed
    (recompute beats serializing the whole pool)."""
    reqs = []
    for r in scheduler.unfinished_requests():
        reqs.append({
            "prompt": r.prompt, "output": r.output,
            "max_new_tokens": r.max_new_tokens,
            "temperature": r.temperature, "stop_token": r.stop_token,
        })
    Path(path).write_text(json.dumps({"requests": reqs}))


def restore_serving_snapshot(path: str, scheduler) -> int:
    """Resubmit snapshotted requests (prompt+output as the new prefix)."""
    data = json.loads(Path(path).read_text())
    n = 0
    for r in data["requests"]:
        remaining = r["max_new_tokens"] - len(r["output"])
        if remaining <= 0:
            continue
        scheduler.submit(
            r["prompt"] + r["output"], max_new_tokens=remaining,
            temperature=r["temperature"], stop_token=r["stop_token"])
        n += 1
    return n

