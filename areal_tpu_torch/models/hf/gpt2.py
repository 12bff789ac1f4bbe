"""GPT-2 HF conversion (counterpart of ``areal_tpu/models/hf/gpt2.py``):
learned absolute positions, LayerNorm with bias, a plain tanh-gelu MLP,
the fused c_attn QKV split into wq / wk / wv, biases everywhere, tied
embeddings. HF's Conv1D stores its weights as [in, out] already, so
nothing is transposed."""

from __future__ import annotations

from typing import Any, Dict

import torch

from areal_tpu_torch.models.config import TransformerConfig


def config_from_hf(hf: Dict[str, Any], is_critic: bool = False) -> TransformerConfig:
    D = hf["n_embd"]
    H = hf["n_head"]
    return TransformerConfig(
        n_layers=hf["n_layer"],
        hidden_dim=D,
        n_q_heads=H,
        n_kv_heads=H,
        head_dim=D // H,
        intermediate_dim=hf.get("n_inner") or 4 * D,
        vocab_size=hf["vocab_size"],
        max_position_embeddings=hf.get("n_positions", 1024),
        activation="gelu",
        mlp_type="plain",
        norm_type="layer",
        norm_eps=hf.get("layer_norm_epsilon", 1e-5),
        pos_emb="learned",
        attn_bias=True,
        attn_out_bias=True,
        mlp_bias=True,
        tied_embeddings=True,
        is_critic=is_critic,
    )


def config_to_hf(cfg: TransformerConfig) -> Dict[str, Any]:
    return {
        "architectures": ["GPT2LMHeadModel"],
        "model_type": "gpt2",
        "n_layer": cfg.n_layers,
        "n_embd": cfg.hidden_dim,
        "n_head": cfg.n_q_heads,
        "n_inner": cfg.intermediate_dim,
        "vocab_size": cfg.vocab_size,
        "n_positions": cfg.max_position_embeddings,
        "activation_function": "gelu_new",
        "layer_norm_epsilon": cfg.norm_eps,
        "tie_word_embeddings": True,
        "torch_dtype": "float32",
    }


def params_from_hf(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict:
    L, D = cfg.n_layers, cfg.hidden_dim

    def w(name):
        return (sd[name] if name in sd else sd[f"transformer.{name}"]).float()

    def stack(fmt, cols=None):
        xs = [w(fmt.format(i)) for i in range(L)]
        if cols is not None:
            xs = [x[..., cols * D:(cols + 1) * D] for x in xs]
        return torch.stack(xs)

    c_attn, c_bias = "h.{}.attn.c_attn.weight", "h.{}.attn.c_attn.bias"  # [D, 3D], [3D]
    params: Dict = {
        "embedding": {"weight": w("wte.weight")},
        "pos_embedding": {"weight": w("wpe.weight")},
        "layers": {
            "ln1": {"weight": stack("h.{}.ln_1.weight"), "bias": stack("h.{}.ln_1.bias")},
            "ln2": {"weight": stack("h.{}.ln_2.weight"), "bias": stack("h.{}.ln_2.bias")},
            "attn": {
                "wq": stack(c_attn, 0), "wk": stack(c_attn, 1), "wv": stack(c_attn, 2),
                "bq": stack(c_bias, 0), "bk": stack(c_bias, 1), "bv": stack(c_bias, 2),
                "wo": stack("h.{}.attn.c_proj.weight"),
                "bo": stack("h.{}.attn.c_proj.bias"),
            },
            "mlp": {
                "w_in": stack("h.{}.mlp.c_fc.weight"),
                "b_in": stack("h.{}.mlp.c_fc.bias"),
                "w_out": stack("h.{}.mlp.c_proj.weight"),
                "b_out": stack("h.{}.mlp.c_proj.bias"),
            },
        },
        "final_norm": {"weight": w("ln_f.weight"), "bias": w("ln_f.bias")},
    }
    if cfg.is_critic:
        params["head"] = {"weight": torch.zeros((D, 1), dtype=torch.float32)}
    return params


def params_to_hf(params: Dict, cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    layers = params["layers"]
    a, m = layers["attn"], layers["mlp"]
    sd: Dict[str, torch.Tensor] = {
        "wte.weight": params["embedding"]["weight"],
        "wpe.weight": params["pos_embedding"]["weight"],
        "ln_f.weight": params["final_norm"]["weight"],
        "ln_f.bias": params["final_norm"]["bias"],
    }
    for i in range(cfg.n_layers):
        pre = f"h.{i}."
        sd[pre + "ln_1.weight"] = layers["ln1"]["weight"][i]
        sd[pre + "ln_1.bias"] = layers["ln1"]["bias"][i]
        sd[pre + "ln_2.weight"] = layers["ln2"]["weight"][i]
        sd[pre + "ln_2.bias"] = layers["ln2"]["bias"][i]
        sd[pre + "attn.c_attn.weight"] = torch.cat([a["wq"][i], a["wk"][i], a["wv"][i]], dim=1)
        sd[pre + "attn.c_attn.bias"] = torch.cat([a["bq"][i], a["bk"][i], a["bv"][i]])
        sd[pre + "attn.c_proj.weight"] = a["wo"][i]
        sd[pre + "attn.c_proj.bias"] = a["bo"][i]
        sd[pre + "mlp.c_fc.weight"] = m["w_in"][i]
        sd[pre + "mlp.c_fc.bias"] = m["b_in"][i]
        sd[pre + "mlp.c_proj.weight"] = m["w_out"][i]
        sd[pre + "mlp.c_proj.bias"] = m["b_out"][i]
    return sd
