"""Carry a reference param tree into the port.

``params_from_numpy`` takes the JAX package's param tree as numpy arrays
(the stacked-layer layout of ``areal_tpu/models/transformer.py:
init_params``: ``embedding/weight``, ``layers/{ln1,ln2,attn,mlp}/...``
with a leading ``L`` axis, ``final_norm``, ``head``) and returns the same
tree of torch tensors, which is the port's param layout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from areal_tpu_torch import resolve_device


def params_from_numpy(tree: Dict[str, Any], device="cuda",
                      dtype: Optional[torch.dtype] = torch.float32) -> Dict[str, Any]:
    """Same tree, leaves as tensors on ``device`` in ``dtype`` (None keeps
    each leaf's own dtype)."""
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        t = torch.from_numpy(np.array(x)).to(device)  # a copy: x may be read-only
        return t if dtype is None else t.to(dtype)

    return conv(tree)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's params as a float32 numpy tree (the inverse direction).
    Always a copy: a train engine updates its tensors in place."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return np.array(params.detach().float().cpu().numpy())
