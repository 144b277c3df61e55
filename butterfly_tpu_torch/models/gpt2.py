"""GPT-2 model family: LayerNorm + bias, learned positions, gelu_new, tied
lm_head — all expressed through ModelConfig over the shared layer math in
models/common.py. The counterpart of butterfly_tpu/models/gpt2.py, with
its HF checkpoint converter."""
from __future__ import annotations

from typing import Dict, Mapping

from butterfly_tpu_torch.ckpt.load import materialize, one, stack
from butterfly_tpu_torch.core.config import ModelConfig, gpt2_124m  # noqa: F401
from butterfly_tpu_torch.models.common import Model


def model(cfg: ModelConfig | None = None, device=None) -> Model:
    return Model(cfg or gpt2_124m(), device=device)


def params_from_hf_state_dict(sd: Mapping, cfg: ModelConfig, device=None,
                              quantize: bool = False) -> Dict:
    """A HF transformers GPT2LMHeadModel state_dict as the port's tree, on
    `device` in cfg.dtype (ckpt/load.py:materialize).

    HF GPT-2 uses Conv1D (weight stored [in, out], the port's `x @ w`
    orientation) and a fused c_attn producing q|k|v along the out axis.
    The LM head is tied to the embedding (no lm_head leaf)."""
    L, D, N, H = cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.head_dim
    h = "transformer.h.{}."

    def qkv(j):   # the j-th third of c_attn's out axis, as [D, N, H]
        return lambda w: w[:, j * D:(j + 1) * D].reshape(D, N, H)

    def qkv_bias(j):
        return lambda b: b[j * D:(j + 1) * D].reshape(N, H)

    attn_w, attn_b = h + "attn.c_attn.weight", h + "attn.c_attn.bias"
    plan = {
        "embed": {"tok": one("transformer.wte.weight"),
                  "pos": one("transformer.wpe.weight")},
        "layers": {
            "ln1": {"scale": stack(h + "ln_1.weight", L),
                    "bias": stack(h + "ln_1.bias", L)},
            "ln2": {"scale": stack(h + "ln_2.weight", L),
                    "bias": stack(h + "ln_2.bias", L)},
            "attn": {
                "wq": stack(attn_w, L, qkv(0)),
                "wk": stack(attn_w, L, qkv(1)),
                "wv": stack(attn_w, L, qkv(2)),
                "bq": stack(attn_b, L, qkv_bias(0)),
                "bk": stack(attn_b, L, qkv_bias(1)),
                "bv": stack(attn_b, L, qkv_bias(2)),
                "wo": stack(h + "attn.c_proj.weight", L,
                            lambda a: a.reshape(N, H, D)),
                "bo": stack(h + "attn.c_proj.bias", L),
            },
            "mlp": {
                "w_up": stack(h + "mlp.c_fc.weight", L),
                "b_up": stack(h + "mlp.c_fc.bias", L),
                "w_down": stack(h + "mlp.c_proj.weight", L),
                "b_down": stack(h + "mlp.c_proj.bias", L),
            },
        },
        "final_norm": {"scale": one("transformer.ln_f.weight"),
                       "bias": one("transformer.ln_f.bias")},
    }
    return materialize(plan, sd, cfg, device, quantize)
