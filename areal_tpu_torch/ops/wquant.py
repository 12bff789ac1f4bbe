"""Weight matmul of the decode and prefill paths (counterpart of
``areal_tpu/ops/wquant.py``). Only the plain-weight branch is ported;
int8 decode weights are a later slice."""

from __future__ import annotations

import torch


def qmat(h: torch.Tensor, w: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``h @ w`` with the weight cast to the compute dtype."""
    if isinstance(w, tuple):
        raise NotImplementedError("int8 (data, scale) weights are not ported yet")
    return h @ w.to(cdt)
