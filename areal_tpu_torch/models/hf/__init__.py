"""HF checkpoint conversion and disk IO for the port (counterpart of
``areal_tpu/models/hf/__init__.py``): a registry of the dense families
(llama, qwen2, qwen3, mistral, gemma, gpt2), and ``load_hf_model`` /
``save_hf_model`` through safetensors, so a checkpoint directory one
package writes loads in the other. Tensors stay torch tensors on the CPU;
``save_hf_model`` keeps each leaf's dtype (bfloat16 included) and writes
the tokenizer beside the weights when given one, and ``load_hf_model``
gives float32 params, as the reference does."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from areal_tpu_torch.models.config import TransformerConfig


@dataclasses.dataclass
class HFFamily:
    name: str
    hf_model_type: str
    config_from_hf: Callable[[Dict[str, Any], bool], TransformerConfig]
    config_to_hf: Callable[[TransformerConfig], Dict[str, Any]]
    params_from_hf: Callable[[Dict[str, torch.Tensor], TransformerConfig], Dict]
    params_to_hf: Callable[[Dict, TransformerConfig], Dict[str, torch.Tensor]]


HF_FAMILY_REGISTRY: Dict[str, HFFamily] = {}


def register_hf_family(name: str, family: HFFamily):
    if name in HF_FAMILY_REGISTRY:
        raise ValueError(f"HF family {name!r} already registered")
    HF_FAMILY_REGISTRY[name] = family


def get_family(name: str) -> HFFamily:
    if name not in HF_FAMILY_REGISTRY:
        raise KeyError(
            f"unknown HF family {name!r}; registered: {sorted(HF_FAMILY_REGISTRY)}"
        )
    return HF_FAMILY_REGISTRY[name]


def family_from_hf_config(hf_config: Dict[str, Any]) -> HFFamily:
    mt = hf_config.get("model_type")
    for fam in HF_FAMILY_REGISTRY.values():
        if fam.hf_model_type == mt:
            return fam
    raise KeyError(f"no registered family for HF model_type {mt!r}")


def load_hf_config(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def load_hf_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of an HF checkpoint directory (safetensors, sharded or
    single, else torch ``.bin``) as CPU tensors in their stored dtype."""
    import safetensors.torch

    out: Dict[str, torch.Tensor] = {}
    st_files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if st_files:
        for f in st_files:
            out.update(safetensors.torch.load_file(os.path.join(path, f), device="cpu"))
        return out
    bin_files = sorted(f for f in os.listdir(path) if f.endswith(".bin"))
    if bin_files:
        for f in bin_files:
            out.update(torch.load(os.path.join(path, f), map_location="cpu",
                                  weights_only=True))
        return out
    raise FileNotFoundError(f"no safetensors/bin weights under {path}")


def load_hf_model(path: str, is_critic: bool = False,
                  family: Optional[str] = None) -> Tuple[TransformerConfig, Dict]:
    """(TransformerConfig, float32 params on the CPU) from an HF
    checkpoint directory."""
    hf_cfg = load_hf_config(path)
    fam = get_family(family) if family else family_from_hf_config(hf_cfg)
    cfg = fam.config_from_hf(hf_cfg, is_critic)
    params = fam.params_from_hf(load_hf_state_dict(path), cfg)
    return cfg, params


def save_hf_model(save_dir: str, cfg: TransformerConfig, params: Dict, family: str,
                  tokenizer=None):
    """Write an HF-format checkpoint (config.json + model.safetensors, and
    the tokenizer's files when given one) from a param tree of tensors on
    any device."""
    import safetensors.torch

    fam = get_family(family)
    os.makedirs(save_dir, exist_ok=True)
    # A fresh CPU copy of each tensor: per-layer slices of the stacked
    # leaves share storage, which safetensors refuses. Transposes are made
    # contiguous where the params live (on the card, not the host).
    sd = {k: v.detach().contiguous().to("cpu", copy=True)
          for k, v in fam.params_to_hf(params, cfg).items()}
    safetensors.torch.save_file(sd, os.path.join(save_dir, "model.safetensors"))
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(fam.config_to_hf(cfg), f, indent=2)
    if tokenizer is not None:
        tokenizer.save_pretrained(save_dir)


from areal_tpu_torch.models.hf import gemma, gpt2, llama, mistral, qwen2, qwen3  # noqa: E402

for _mod in (llama, qwen2, qwen3, mistral, gemma, gpt2):
    _name = _mod.__name__.rsplit(".", 1)[1]
    register_hf_family(_name, HFFamily(_name, _name, _mod.config_from_hf, _mod.config_to_hf,
                                       _mod.params_from_hf, _mod.params_to_hf))
del _mod, _name
