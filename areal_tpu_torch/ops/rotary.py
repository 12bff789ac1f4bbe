"""Rotary position embeddings with scaling variants (counterpart of
``areal_tpu/ops/rotary.py``).

Batches are packed, so every token carries its own position id and the
embedding is gathered per token. ``rotary_inv_freq`` is host-side numpy,
as in the reference; the other two run on tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

SUPPORTED_ROPE_TYPES = (None, "default", "linear", "llama3")


def rotary_inv_freq(
    head_dim: int,
    base: float = 10000.0,
    scaling: Optional[float] = None,
    scaling_type: Optional[str] = None,
    scaling_params: Optional[dict] = None,
) -> np.ndarray:
    if scaling_type not in SUPPORTED_ROPE_TYPES:
        raise NotImplementedError(
            f"rope scaling type {scaling_type!r} not supported "
            f"(supported: {SUPPORTED_ROPE_TYPES})"
        )
    inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    if scaling_type == "linear" and scaling:
        inv_freq = inv_freq / scaling
    elif scaling_type == "llama3" and scaling:
        # llama3 frequency interpolation: low frequencies scaled, high
        # frequencies kept, a smooth ramp between (factors from the
        # checkpoint's rope_scaling).
        p = scaling_params or {}
        low_freq_factor = p.get("low_freq_factor", 1.0)
        high_freq_factor = p.get("high_freq_factor", 4.0)
        orig_ctx = p.get("original_max_position_embeddings", 8192)
        wavelen = 2 * np.pi / inv_freq
        low_wl = orig_ctx / low_freq_factor
        high_wl = orig_ctx / high_freq_factor
        scaled = inv_freq / scaling
        smooth = (orig_ctx / wavelen - low_freq_factor) / (
            high_freq_factor - low_freq_factor
        )
        smoothed = (1 - smooth) * scaled + smooth * inv_freq
        inv_freq = np.where(
            wavelen < high_wl, inv_freq, np.where(wavelen > low_wl, scaled, smoothed)
        )
    return inv_freq.astype(np.float32)


def rotary_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor):
    """cos/sin of shape (*positions.shape, head_dim/2), fp32."""
    freqs = positions.float()[..., None] * inv_freq.float()
    return torch.cos(freqs), torch.sin(freqs)


def apply_rotary(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, interleaved: bool = False,
) -> torch.Tensor:
    """x: (..., n_heads, head_dim); cos/sin: (..., head_dim/2), broadcast
    over heads. Half layout (HF neox): pairs (x[:d/2], x[d/2:]);
    interleaved: pairs (x[0::2], x[1::2])."""
    dtype = x.dtype
    x = x.float()
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    if interleaved:
        x1, x2 = x[..., 0::2], x[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        out = out.reshape(x.shape)
    else:
        d2 = x.shape[-1] // 2
        x1, x2 = x[..., :d2], x[..., d2:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)
