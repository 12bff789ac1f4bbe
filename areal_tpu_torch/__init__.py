"""PyTorch/CUDA port of areal_tpu for NVIDIA Hopper (H100).

The JAX package ``areal_tpu`` stays the reference; this package imports
``torch`` and nothing of JAX or ``areal_tpu``. Its layout mirrors the
reference's so each module's counterpart is easy to find
(``models/transformer.py``, ``ops/attention.py``, ``engine/paged.py``,
``engine/serving.py``, ...). Every Pallas kernel of the reference on a
ported path is a hand-written CUDA kernel here (``csrc/``, built and
loaded by ``kernels.py``); each kernel's plain PyTorch version sits in
the module of its wrapper and runs only for tensors on the CPU.

Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise rather than run on the CPU. Tests pass ``device="cpu"``.

Importing the package imports no ``torch``: the reward executor's
sandbox workers load ``functioncall.math_grader`` under a memory limit
that torch and its CUDA libraries would not fit in.
"""

from __future__ import annotations


def resolve_device(device="cuda") -> "torch.device":
    """The torch device an entry point runs on. A CUDA device without a
    card raises: the port never falls back to the CPU on its own."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name: str) -> "torch.dtype":
    """TransformerConfig dtype names ('float32', 'bfloat16', ...) as torch
    dtypes."""
    import torch

    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt
