"""Mixtral-8x7B MoE family: Llama-style attention (GQA + RoPE) with a
top-2-of-8 expert SwiGLU FFN, expressed via ModelConfig over the shared
layer math in models/common.py (route_tokens, moe_block), with the
expert-parallel dispatch in parallel/expert.py (cfg.moe_impl="ep"). The
counterpart of butterfly_tpu/models/mixtral.py, with its HF checkpoint
converter."""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from butterfly_tpu_torch.ckpt.load import HFLeaf, materialize, stack
from butterfly_tpu_torch.core.config import ModelConfig, mixtral_8x7b  # noqa: F401
from butterfly_tpu_torch.models.common import Model
from butterfly_tpu_torch.models.llama import attention_plan, outer_plan


def model(cfg: ModelConfig | None = None, device=None) -> Model:
    return Model(cfg or mixtral_8x7b(), device=device)


def params_from_hf_state_dict(sd: Mapping, cfg: ModelConfig, device=None,
                              quantize: bool = False,
                              experts: Optional[Tuple[int, int]] = None
                              ) -> Dict:
    """HF MixtralForCausalLM weights as the port's tree, on `device` in
    cfg.dtype (ckpt/load.py:materialize).

    HF expert weights live at
    model.layers.{l}.block_sparse_moe.experts.{e}.w1|w2|w3.weight with
    w1=gate [F,D], w2=down [D,F], w3=up [F,D]; the router is
    block_sparse_moe.gate.weight [E,D]. The port's layout stacks layers
    AND experts: w_gate/w_up [L,E,D,F], w_down [L,E,F,D], router [L,D,E].
    `experts` = [lo, hi) reads only those experts ([L, hi - lo, ...]).
    """
    L, E = cfg.num_layers, cfg.num_experts
    held = range(*experts) if experts is not None else range(E)
    moe = "model.layers.{}.block_sparse_moe."

    def experts(which):  # w1|w2|w3 -> [L, E, in, out]
        return HFLeaf([[f"{moe.format(i)}experts.{e}.{which}.weight"
                        for e in held] for i in range(L)],
                      lambda *ws: torch.stack([w.T for w in ws]), True)

    layers = attention_plan(cfg)
    layers["moe"] = {
        "router": stack(moe + "gate.weight", L, lambda a: a.T),   # [D, E]
        "w_gate": experts("w1"),
        "w_up": experts("w3"),
        "w_down": experts("w2"),
    }
    return materialize(outer_plan(sd, layers), sd, cfg, device, quantize)
