"""Qwen3 HF conversion: the llama layout with per-head q/k RMSNorm, no
qkv bias and a decoupled head_dim (counterpart of
``areal_tpu/models/hf/qwen3.py``)."""

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


def config_from_hf(hf: Dict[str, Any], is_critic: bool = False) -> TransformerConfig:
    cfg = llama_config_from_hf(hf, is_critic)
    cfg.attn_bias = False
    cfg.qk_norm = True
    return cfg


def config_to_hf(cfg: TransformerConfig) -> Dict[str, Any]:
    hf = llama_config_to_hf(cfg)
    hf["architectures"] = ["Qwen3ForCausalLM"]
    hf["model_type"] = "qwen3"
    hf["attention_bias"] = False
    return hf


def params_from_hf(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict:
    return params_from_hf_llama_style(sd, cfg, qkv_bias=False, qk_norm=True)


def params_to_hf(params: Dict, cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    return params_to_hf_llama_style(params, cfg, qkv_bias=False, qk_norm=True)
