"""Qwen2 / Qwen2.5 HF conversion: the llama layout plus qkv bias
(counterpart of ``areal_tpu/models/hf/qwen2.py``), and the published
config of DeepSeek-R1-Distill-Qwen-1.5B, the model behind the reference
system's headline run, written out in code (the weights are not in the
repository; runs use seeded random weights at these shapes)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.hf.llama import (
    config_from_hf as llama_config_from_hf,
    config_to_hf as llama_config_to_hf,
    params_from_hf_llama_style,
    params_to_hf_llama_style,
)

# https://huggingface.co/deepseek-ai/DeepSeek-R1-Distill-Qwen-1.5B/blob/main/config.json
R1_DISTILL_QWEN_1_5B_HF: Dict[str, Any] = {
    "architectures": ["Qwen2ForCausalLM"],
    "model_type": "qwen2",
    "hidden_act": "silu",
    "num_hidden_layers": 28,
    "hidden_size": 1536,
    "num_attention_heads": 12,
    "num_key_value_heads": 2,
    "intermediate_size": 8960,
    "vocab_size": 151936,
    "max_position_embeddings": 131072,
    "rope_theta": 10000,
    "rms_norm_eps": 1e-06,
    "tie_word_embeddings": False,
    "bos_token_id": 151643,
    "eos_token_id": 151643,
    "torch_dtype": "bfloat16",
}


def config_from_hf(hf: Dict[str, Any], is_critic: bool = False) -> TransformerConfig:
    cfg = llama_config_from_hf(hf, is_critic)
    cfg.attn_bias = True  # qwen2 always uses qkv bias
    return cfg


def config_to_hf(cfg: TransformerConfig) -> Dict[str, Any]:
    hf = llama_config_to_hf(cfg)
    hf["architectures"] = ["Qwen2ForCausalLM"]
    hf["model_type"] = "qwen2"
    hf.pop("attention_bias", None)
    hf.pop("head_dim", None)
    return hf


def params_from_hf(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict:
    return params_from_hf_llama_style(sd, cfg, qkv_bias=True)


def params_to_hf(params: Dict, cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    return params_to_hf_llama_style(params, cfg, qkv_bias=True)


def r1_distill_qwen_1_5b_config(**overrides) -> TransformerConfig:
    """The published R1-Distill-Qwen-1.5B config through ``config_from_hf``
    (head_dim 128, GQA group 6, qkv bias), with bf16 params and compute;
    ``overrides`` set TransformerConfig fields (e.g. a cut ``n_layers``)."""
    cfg = config_from_hf(R1_DISTILL_QWEN_1_5B_HF)
    cfg.param_dtype = "bfloat16"
    cfg.compute_dtype = "bfloat16"
    for k, v in overrides.items():
        if not hasattr(cfg, k):
            raise AttributeError(f"TransformerConfig has no field {k!r}")
        setattr(cfg, k, v)
    return cfg
