"""Transformer architecture configuration.

A copy of ``areal_tpu/models/config.py`` (the port imports nothing of the
JAX package), with the same fields and defaults so that one
configuration describes the same model in both packages. It covers GQA
attention, rotary variants, RMS/LayerNorm, gated MLPs, actor (LM head)
or critic (scalar head) outputs, tied embeddings and qk-norm. ``MoEConfig``
is carried for the config's shape; the port's engine raises
``NotImplementedError`` for MoE models (a later slice).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    # Expert capacity = capacity_factor * T * top_k / num_experts.
    capacity_factor: float = 1.25
    routed_scaling_factor: float = 1.0
    aux_loss_coef: float = 1e-3
    z_loss_coef: float = 0.0
    # Size of each expert's hidden dim; defaults to intermediate_dim.
    expert_intermediate_dim: Optional[int] = None
    # "capacity" (einsum dispatch, drops tokens past capacity) or
    # "dropless" (sort-by-expert grouped matmuls); see the reference's
    # areal_tpu/models/config.py.
    dispatch: str = "capacity"
    # Dense layers interleaved with MoE (e.g. first k layers dense).
    first_k_dense: int = 0

    def __post_init__(self):
        if self.dispatch not in ("capacity", "dropless"):
            raise ValueError(
                f"MoEConfig.dispatch must be 'capacity' or 'dropless', "
                f"got {self.dispatch!r}"
            )


@dataclasses.dataclass(eq=False)  # eq=False keeps it hashable (by id)
class TransformerConfig:
    n_layers: int = 2
    hidden_dim: int = 64
    n_q_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 16
    intermediate_dim: int = 128
    vocab_size: int = 128
    max_position_embeddings: int = 2048

    activation: str = "silu"  # silu | gelu
    mlp_type: str = "gated"  # gated | plain
    norm_type: str = "rms"  # rms | layer
    norm_eps: float = 1e-6

    # Position encoding: "rotary" (default) or "learned" absolute
    # embeddings (gpt2).
    pos_emb: str = "rotary"
    rotary_base: float = 10000.0
    rotary_scaling: Optional[float] = None
    rotary_scaling_type: Optional[str] = None  # linear | llama3 | None
    # Extra factors for llama3-style scaling (low/high_freq_factor,
    # original_max_position_embeddings), carried from the HF config.
    rotary_scaling_params: Optional[dict] = None
    rotary_interleaved: bool = False

    attn_bias: bool = False  # qwen2 uses qkv bias
    attn_out_bias: bool = False  # gpt2 also biases the output projection
    mlp_bias: bool = False
    qk_norm: bool = False  # qwen3 per-head RMSNorm on q/k
    tied_embeddings: bool = False
    embedding_multiplier: Optional[float] = None  # gemma normalizer

    is_critic: bool = False
    moe: Optional[MoEConfig] = None

    # Numerics: params kept in param_dtype, compute in compute_dtype.
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.n_q_heads % self.n_kv_heads != 0:
            raise ValueError("n_q_heads must be a multiple of n_kv_heads")
        if isinstance(self.moe, dict):
            # Configs from plain kwargs dicts carry the MoE block as a dict.
            self.moe = MoEConfig(**self.moe)

    @property
    def q_dim(self) -> int:
        return self.n_q_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_uses_moe(self, layer_idx: int) -> bool:
        return self.moe is not None and layer_idx >= self.moe.first_k_dense
