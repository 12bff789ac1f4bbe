"""LLaMA-family HF conversion (counterpart of
``areal_tpu/models/hf/llama.py``): the HF config to a TransformerConfig,
and an HF state dict of torch tensors to the port's stacked param tree."""

from __future__ import annotations

from typing import Any, Dict

import torch

from areal_tpu_torch.models.config import TransformerConfig


def config_from_hf(hf: Dict[str, Any], is_critic: bool = False) -> TransformerConfig:
    head_dim = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
    rope_scaling = hf.get("rope_scaling") or {}
    rope_type = rope_scaling.get("rope_type") or rope_scaling.get("type")
    if rope_type not in (None, "default", "linear", "llama3"):
        raise NotImplementedError(
            f"rope scaling type {rope_type!r} from HF config is not supported yet"
        )
    return TransformerConfig(
        n_layers=hf["num_hidden_layers"],
        hidden_dim=hf["hidden_size"],
        n_q_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=head_dim,
        intermediate_dim=hf["intermediate_size"],
        vocab_size=hf["vocab_size"],
        max_position_embeddings=hf.get("max_position_embeddings", 4096),
        activation="silu" if hf.get("hidden_act", "silu") == "silu" else "gelu",
        mlp_type="gated",
        norm_type="rms",
        norm_eps=hf.get("rms_norm_eps", 1e-6),
        rotary_base=hf.get("rope_theta", 10000.0),
        rotary_scaling=rope_scaling.get("factor"),
        rotary_scaling_type=rope_type,
        rotary_scaling_params=dict(rope_scaling) or None,
        attn_bias=bool(hf.get("attention_bias", False)),
        tied_embeddings=bool(hf.get("tie_word_embeddings", False)),
        is_critic=is_critic,
    )


def params_from_hf_llama_style(
    sd: Dict[str, torch.Tensor],
    cfg: TransformerConfig,
    qkv_bias: bool = False,
    qk_norm: bool = False,
) -> Dict:
    """HF linear weights are [out, in]; they are transposed into the
    matmul-ready [in, out] layout and stacked over layers. Leaves come
    out float32 on the state dict's device."""
    L = cfg.n_layers

    def w(name):
        return sd[name].float()

    def stack(fmt, transpose=False):
        xs = [w(fmt.format(i)) for i in range(L)]
        return torch.stack([x.T.contiguous() for x in xs] if transpose else xs)

    pre = "model.layers.{}."
    attn = {
        "wq": stack(pre + "self_attn.q_proj.weight", True),
        "wk": stack(pre + "self_attn.k_proj.weight", True),
        "wv": stack(pre + "self_attn.v_proj.weight", True),
        "wo": stack(pre + "self_attn.o_proj.weight", True),
    }
    if qkv_bias:
        attn["bq"] = stack(pre + "self_attn.q_proj.bias")
        attn["bk"] = stack(pre + "self_attn.k_proj.bias")
        attn["bv"] = stack(pre + "self_attn.v_proj.bias")
    if qk_norm:
        attn["q_norm"] = stack(pre + "self_attn.q_norm.weight")
        attn["k_norm"] = stack(pre + "self_attn.k_norm.weight")
    params: Dict = {
        "embedding": {"weight": w("model.embed_tokens.weight")},
        "layers": {
            "ln1": {"weight": stack(pre + "input_layernorm.weight")},
            "ln2": {"weight": stack(pre + "post_attention_layernorm.weight")},
            "attn": attn,
            "mlp": {
                "w_gate": stack(pre + "mlp.gate_proj.weight", True),
                "w_up": stack(pre + "mlp.up_proj.weight", True),
                "w_down": stack(pre + "mlp.down_proj.weight", True),
            },
        },
        "final_norm": {"weight": w("model.norm.weight")},
    }
    if cfg.is_critic:
        # HF causal-LM checkpoints have no critic head: use score.weight
        # when present, else zeros (as the reference does).
        params["head"] = {"weight": (
            w("score.weight").T.contiguous() if "score.weight" in sd
            else torch.zeros((cfg.hidden_dim, 1), dtype=torch.float32,
                             device=params["embedding"]["weight"].device))}
    elif not cfg.tied_embeddings:
        params["head"] = {"weight": w("lm_head.weight").T.contiguous()}
    return params
