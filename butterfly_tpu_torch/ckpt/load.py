"""Checkpoint import: HF safetensors / torch-bin directories -> the port's tree.

The counterpart of butterfly_tpu/ckpt/load.py. Safetensors files are
read by the port's own reader (ckpt/safetensors_io.py), so the
`safetensors` package is not needed; BF16 files load too.

Each model family's `params_from_hf_state_dict` (models/llama.py,
gpt2.py, mixtral.py) describes its tree as `HFLeaf`s: which HF tensors
make each leaf, and how. `materialize` then builds the tree one leaf,
and one layer of a stacked leaf, at a time: each HF tensor goes to the
device as it is stored, is transposed and reshaped there, and lands in
the leaf in the compute dtype (`cfg.dtype`), which is what the engine's
`cast_params` would give. No float32 copy of the tree exists on the host
or the device. Widening a stored BF16 or F16 value to float32 is exact
and a float32 value is rounded once either way, so the leaves are the
reference loader's (which widens every tensor to float32 on the host)
cast to the compute dtype, bit for bit. With `quantize=True` each
matmul weight is quantized to int8 codes and scales one layer at a time
as it is loaded (quant/int8.py's scheme and contraction axes): the
result is `quantize_int8` of the compute-dtype tree, bit for bit,
without ever holding that tree.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, NamedTuple, Sequence

import torch

from butterfly_tpu_torch.core.config import ModelConfig
from butterfly_tpu_torch.core.device import resolve_device


class HFLeaf(NamedTuple):
    """One leaf of the tree, made from HF tensors. `names[i]` are the HF
    names layer i's slice is built from (one entry for an unstacked
    leaf), and `build(*tensors)` makes the slice from those tensors, on
    the target device, in their stored dtype."""
    names: Sequence[Sequence[str]]
    build: Callable[..., torch.Tensor]
    stacked: bool


def one(name: str, build: Callable = lambda a: a) -> HFLeaf:
    """An unstacked leaf from one HF tensor."""
    return HFLeaf([[name]], build, False)


def stack(fmt: str, num_layers: int, build: Callable = lambda a: a) -> HFLeaf:
    """An [L, ...] leaf whose layer i comes from `fmt.format(i)`."""
    return HFLeaf([[fmt.format(i)] for i in range(num_layers)], build, True)


def materialize(plan: Dict, sd: Mapping[str, torch.Tensor], cfg: ModelConfig,
                device=None, quantize: bool = False) -> Dict:
    """The tree `plan` describes, built from the state dict `sd` on
    `device` (None = CUDA) in `cfg.dtype`, the matmul weights as int8
    `{"q8", "s"}` leaves when `quantize`."""
    from butterfly_tpu_torch.models.common import torch_dtype
    from butterfly_tpu_torch.quant.int8 import _axes, _quant
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)

    def fetch(names):
        return [sd[n].to(dev) for n in names]

    def leaf(spec: HFLeaf, parent: str, name: str):
        axes = _axes(parent, name) if quantize and (
            parent in ("attn", "mlp", "moe") or name == "lm_head") else None
        out = None
        for i, names in enumerate(spec.names):
            part = spec.build(*fetch(names))
            if axes is not None:
                # the leaf's layer slice in the compute dtype, quantized
                # as quantize_int8 quantizes a stacked leaf: per layer
                w = torch.empty(part.shape, dtype=dt, device=dev)
                w.copy_(part)
                del part
                q = _quant(w.unsqueeze(0) if spec.stacked else w, axes, dt)
                if not spec.stacked:
                    return q
                if out is None:
                    n = len(spec.names)
                    out = {k: torch.empty((n,) + tuple(v.shape[1:]),
                                          dtype=v.dtype, device=dev)
                           for k, v in q.items()}
                for k in ("q8", "s"):
                    out[k][i].copy_(q[k][0])
                continue
            if out is None:
                shape = ((len(spec.names),) if spec.stacked else ()) \
                    + tuple(part.shape)
                out = torch.empty(shape, dtype=dt, device=dev)
            (out[i] if spec.stacked else out).copy_(part)
        return out

    def walk(node, parent):
        return {k: walk(v, k) if isinstance(v, dict) else leaf(v, parent, k)
                for k, v in node.items()}
    return walk(plan, "")


def _load_hf_state_dict(path: Path) -> Mapping[str, torch.Tensor]:
    """Every *.safetensors (preferred, sorted) or pytorch_model*.bin / *.pt
    in a dir, as one mapping of CPU tensors."""
    st_files = sorted(path.glob("*.safetensors"))
    if st_files:
        from butterfly_tpu_torch.ckpt.safetensors_io import SafetensorsDir
        return SafetensorsDir(st_files)
    bin_files = sorted(path.glob("pytorch_model*.bin")) + sorted(path.glob("*.pt"))
    if bin_files:
        sd: Dict[str, Any] = {}
        for f in bin_files:
            sd.update(torch.load(str(f), map_location="cpu",
                                 weights_only=True, mmap=True))
        return sd
    raise FileNotFoundError(
        f"no *.safetensors or pytorch_model*.bin found under {path}")


def load_checkpoint(path: str, cfg: ModelConfig, device=None,
                    quantize: bool = False, experts=None):
    """Load model weights from `path` (HF-format dir) into the port's
    tree on `device` (None = CUDA), in `cfg.dtype`; int8 matmul weights
    when `quantize`. `experts` = [lo, hi) reads only those experts of an
    MoE checkpoint (models/mixtral.py)."""
    p = Path(path)
    if not p.is_dir():
        raise FileNotFoundError(f"checkpoint dir not found: {path}")
    sd = _load_hf_state_dict(p)
    if cfg.arch == "gpt2":
        from butterfly_tpu_torch.models.gpt2 import params_from_hf_state_dict
    elif cfg.arch == "llama":
        from butterfly_tpu_torch.models.llama import params_from_hf_state_dict
    elif cfg.arch == "mixtral":
        from butterfly_tpu_torch.models.mixtral import \
            params_from_hf_state_dict
    else:
        raise ValueError(f"unknown arch {cfg.arch!r}")
    kw = {} if experts is None else {"experts": experts}
    return params_from_hf_state_dict(sd, cfg, device=device,
                                     quantize=quantize, **kw)


def load_draft_checkpoint(path: str, target_cfg: ModelConfig, device=None):
    """Independent narrow draft checkpoint for speculative serving
    (`serve --draft-ckpt`, RuntimeConfig.draft_ckpt): an HF-format dir
    whose config.json describes the draft's own (smaller) geometry.

    The draft proposes tokens the TARGET verifies, so the vocabularies
    must be the same; a mismatch would score q(x) against the wrong ids,
    biasing every accept test. Geometry is otherwise free (narrower
    hidden, fewer layers, different head counts), and so is its compute
    dtype (config.json carries none: ModelConfig's default, as in the
    reference). Returns (draft_cfg, draft_params)."""
    dcfg = config_from_hf_dir(path)
    if dcfg.vocab_size != target_cfg.vocab_size:
        raise ValueError(
            f"draft checkpoint vocab {dcfg.vocab_size} != target vocab "
            f"{target_cfg.vocab_size}: the draft must propose in the "
            f"target's vocabulary (same tokenizer)")
    return dcfg, load_checkpoint(path, dcfg, device)


def config_from_hf_dir(path: str) -> ModelConfig:
    """Best-effort ModelConfig from a HF config.json next to the weights
    (the reference's defaults, field for field)."""
    p = Path(path)
    if not p.is_dir():
        raise FileNotFoundError(f"checkpoint dir not found: {path}")
    cj = json.loads((p / "config.json").read_text())
    mt = cj.get("model_type", "llama")
    if mt == "gpt2":
        return ModelConfig(
            arch="gpt2", vocab_size=cj["vocab_size"], hidden_size=cj["n_embd"],
            num_layers=cj["n_layer"], num_heads=cj["n_head"],
            num_kv_heads=cj["n_head"], head_dim=cj["n_embd"] // cj["n_head"],
            intermediate_size=cj.get("n_inner") or 4 * cj["n_embd"],
            max_seq_len=cj["n_positions"], use_bias=True, tie_embeddings=True,
            act="gelu_new", pos_embedding="learned",
            norm_eps=cj.get("layer_norm_epsilon", 1e-5),
        )
    common = dict(
        vocab_size=cj["vocab_size"], hidden_size=cj["hidden_size"],
        num_layers=cj["num_hidden_layers"], num_heads=cj["num_attention_heads"],
        num_kv_heads=cj.get("num_key_value_heads", cj["num_attention_heads"]),
        head_dim=cj.get("head_dim",
                        cj["hidden_size"] // cj["num_attention_heads"]),
        intermediate_size=cj["intermediate_size"],
        max_seq_len=cj.get("max_position_embeddings", 8192),
        norm_eps=cj.get("rms_norm_eps", 1e-5),
        rope_theta=cj.get("rope_theta", 500000.0),
        tie_embeddings=cj.get("tie_word_embeddings", False),
    )
    if mt == "mixtral":
        return ModelConfig(arch="mixtral",
                           num_experts=cj.get("num_local_experts", 8),
                           num_experts_per_tok=cj.get("num_experts_per_tok", 2),
                           **common)
    return ModelConfig(arch="llama", **common)
