"""RMSNorm / LayerNorm in fp32 (counterpart of ``areal_tpu/ops/norms.py``).

Both normalize in float32 and return the input's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
    eps: float = 1e-5,
) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    out = (x32 - mean) * (var + eps) ** -0.5
    out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
