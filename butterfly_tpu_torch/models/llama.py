"""Llama-3 model family: RMSNorm, RoPE (rotate-half, matching the HF
convention so imported safetensors agree numerically), GQA, SwiGLU,
untied lm_head — all expressed via ModelConfig over the shared layer math
in models/common.py. The counterpart of butterfly_tpu/models/llama.py,
with its HF checkpoint converter."""
from __future__ import annotations

from typing import Dict, Mapping

from butterfly_tpu_torch.ckpt.load import materialize, one, stack
from butterfly_tpu_torch.core.config import ModelConfig, llama3_8b, llama3_70b  # noqa: F401
from butterfly_tpu_torch.models.common import Model


def model(cfg: ModelConfig | None = None, device=None) -> Model:
    return Model(cfg or llama3_8b(), device=device)


def attention_plan(cfg: ModelConfig) -> Dict:
    """The norms and attention leaves of a Llama-style layer stack (Llama
    and Mixtral share them). HF Linear stores weight as [out, in]; the
    port's layout is [in, ...out], and q/k/v split the out axis into
    (heads, head_dim)."""
    L, D = cfg.num_layers, cfg.hidden_size
    Nq, Kv, H = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def proj(n_heads):
        return lambda a: a.T.reshape(D, n_heads, H)

    p = "model.layers.{}."
    return {
        "ln1": {"scale": stack(p + "input_layernorm.weight", L)},
        "ln2": {"scale": stack(p + "post_attention_layernorm.weight", L)},
        "attn": {
            "wq": stack(p + "self_attn.q_proj.weight", L, proj(Nq)),
            "wk": stack(p + "self_attn.k_proj.weight", L, proj(Kv)),
            "wv": stack(p + "self_attn.v_proj.weight", L, proj(Kv)),
            "wo": stack(p + "self_attn.o_proj.weight", L,
                        lambda a: a.T.reshape(Nq, H, D)),
        },
    }


def outer_plan(sd: Mapping, layers: Dict) -> Dict:
    """The embedding, final norm and LM head around `layers`; the head is
    tied to the embedding when the checkpoint has no lm_head.weight."""
    head = "lm_head.weight" if "lm_head.weight" in sd \
        else "model.embed_tokens.weight"
    return {"embed": {"tok": one("model.embed_tokens.weight")},
            "layers": layers,
            "final_norm": {"scale": one("model.norm.weight")},
            "lm_head": one(head, lambda a: a.T)}


def params_from_hf_state_dict(sd: Mapping, cfg: ModelConfig, device=None,
                              quantize: bool = False) -> Dict:
    """A HF transformers LlamaForCausalLM state_dict as the port's tree,
    on `device` in cfg.dtype (ckpt/load.py:materialize)."""
    L = cfg.num_layers
    p = "model.layers.{}.mlp."
    layers = attention_plan(cfg)
    layers["mlp"] = {
        "w_gate": stack(p + "gate_proj.weight", L, lambda a: a.T),
        "w_up": stack(p + "up_proj.weight", L, lambda a: a.T),
        "w_down": stack(p + "down_proj.weight", L, lambda a: a.T),
    }
    return materialize(outer_plan(sd, layers), sd, cfg, device, quantize)
