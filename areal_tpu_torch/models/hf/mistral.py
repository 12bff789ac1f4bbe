"""Mistral HF conversion: the llama layout, silu, GQA (counterpart of
``areal_tpu/models/hf/mistral.py``). Sliding-window attention is not
modelled, as in the reference: the model attends over the whole packed
context, a superset of the window."""

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
    return llama_config_from_hf(hf, is_critic)


def config_to_hf(cfg: TransformerConfig) -> Dict[str, Any]:
    hf = llama_config_to_hf(cfg)
    hf["architectures"] = ["MistralForCausalLM"]
    hf["model_type"] = "mistral"
    hf.pop("attention_bias", None)
    return hf


def params_from_hf(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict:
    return params_from_hf_llama_style(sd, cfg)


def params_to_hf(params: Dict, cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    return params_to_hf_llama_style(params, cfg)
