"""Gemma HF conversion (counterpart of ``areal_tpu/models/hf/gemma.py``).

Gemma's RMSNorm computes x * (1 + w): the +1 is folded into the weights
on import and taken out on export, so the shared rms norm applies. The
embeddings are scaled by sqrt(hidden_dim) (``embedding_multiplier``);
tanh gelu, tied embeddings, an explicit head_dim.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.hf.llama import params_from_hf_llama_style, params_to_hf_llama_style


def config_from_hf(hf: Dict[str, Any], is_critic: bool = False) -> TransformerConfig:
    return TransformerConfig(
        n_layers=hf["num_hidden_layers"],
        hidden_dim=hf["hidden_size"],
        n_q_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf["head_dim"],
        intermediate_dim=hf["intermediate_size"],
        vocab_size=hf["vocab_size"],
        max_position_embeddings=hf.get("max_position_embeddings", 8192),
        activation="gelu",
        mlp_type="gated",
        norm_type="rms",
        norm_eps=hf.get("rms_norm_eps", 1e-6),
        rotary_base=hf.get("rope_theta", 10000.0),
        tied_embeddings=True,
        embedding_multiplier=math.sqrt(hf["hidden_size"]),
        is_critic=is_critic,
    )


def config_to_hf(cfg: TransformerConfig) -> Dict[str, Any]:
    return {
        "architectures": ["GemmaForCausalLM"],
        "model_type": "gemma",
        "num_hidden_layers": cfg.n_layers,
        "hidden_size": cfg.hidden_dim,
        "num_attention_heads": cfg.n_q_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim,
        "intermediate_size": cfg.intermediate_dim,
        "vocab_size": cfg.vocab_size,
        "max_position_embeddings": cfg.max_position_embeddings,
        "hidden_act": "gelu_pytorch_tanh",
        "rms_norm_eps": cfg.norm_eps,
        "rope_theta": cfg.rotary_base,
        "tie_word_embeddings": True,
        "torch_dtype": "bfloat16",
    }


def _shifted_norms(params: Dict, offset: float) -> Dict:
    """A copy of the tree's top levels with every norm weight + offset
    (the other leaves shared, not copied)."""
    layers = dict(params["layers"])
    for key in ("ln1", "ln2"):
        layers[key] = dict(layers[key], weight=layers[key]["weight"] + offset)
    return dict(params, layers=layers,
                final_norm=dict(params["final_norm"],
                                weight=params["final_norm"]["weight"] + offset))


def params_from_hf(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict:
    return _shifted_norms(params_from_hf_llama_style(sd, cfg), +1.0)


def params_to_hf(params: Dict, cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    return params_to_hf_llama_style(_shifted_norms(params, -1.0), cfg)
