"""Packed variable-length causal attention with GQA (counterpart of
``areal_tpu/ops/attention.py`` and the forward of
``areal_tpu/ops/pallas/flash_attn.py``).

Rows are packed token streams tagged with segment ids (0 = padding,
sequences numbered from 1) and per-token positions; a token attends to
tokens of its own segment at positions at or before its own. Shapes
carry a leading row dimension R where the reference vmaps over rows:
q ``[R, T, Hq, hd]``, k/v ``[R, T, Hkv, hd]``, segment ids and positions
``[R, T]`` int32.

- ``reference_packed_attention``: the plain version, a dense einsum and
  mask. It is what runs for tensors on the CPU, and what the kernel is
  held against.
- ``flash_packed_attention``: the wrapper of the hand-written CUDA kernel
  ``csrc/flash_attn.cu`` (online softmax, causal tile skip). A CUDA
  tensor launches the kernel or raises; a CPU tensor takes the plain
  version.
- ``packed_attention``: the model's entry, the same function. There are
  no splash, ring, Ulysses or sharded variants in the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from areal_tpu_torch import kernels

NEG_INF = -2.0**30


def segment_causal_mask(segment_ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Boolean [R, Tq, Tk]: token i may attend to token j."""
    same = segment_ids[:, :, None] == segment_ids[:, None, :]
    causal = positions[:, :, None] >= positions[:, None, :]
    valid = (segment_ids[:, :, None] > 0) & (segment_ids[:, None, :] > 0)
    return same & causal & valid


def reference_packed_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    segment_ids: torch.Tensor, positions: torch.Tensor,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """The plain version: f32 scores over the whole [T, T] mask. Fully
    masked (padding) rows output 0."""
    R, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else hd**-0.5
    qg = q.reshape(R, T, Hkv, group, hd).float()
    scores = torch.einsum("rqhgd,rkhd->rhgqk", qg, k.float()) * scale
    mask = segment_causal_mask(segment_ids, positions)[:, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0)
    out = torch.einsum("rhgqk,rkhd->rqhgd", probs, v.float())
    return out.reshape(R, T, Hq, hd).to(q.dtype)


def _flash_fwd(q, k, v, segment_ids, positions, scale: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: (out [R, T, Hq, hd] bf16, lse [R, Hq, T]
    f32). Raises on anything the kernel does not take."""
    R, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    kernels.check_cuda_tensor("q", q, torch.bfloat16, 4)
    kernels.check_cuda_tensor("k", k, torch.bfloat16, 4)
    kernels.check_cuda_tensor("v", v, torch.bfloat16, 4)
    kernels.check_cuda_tensor("segment_ids", segment_ids, torch.int32, 2)
    kernels.check_cuda_tensor("positions", positions, torch.int32, 2)
    if hd not in (64, 128):
        raise ValueError(f"flash kernel takes head_dim 64 or 128, got {hd}")
    if k.shape != (R, T, Hkv, hd) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(
            f"flash kernel shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}")
    if segment_ids.shape != (R, T) or positions.shape != (R, T):
        raise ValueError("segment_ids / positions must be [R, T]")
    if R > 65535 or Hq > 65535:
        raise ValueError(f"flash kernel grid limit: R={R}, Hq={Hq}")
    out = torch.empty_like(q)
    lse = torch.empty((R, Hq, T), dtype=torch.float32, device=q.device)
    kernels.launch("flash_attn_fwd_bf16", q, k, v, segment_ids, positions,
                   out, lse, R, T, Hq, Hkv, hd, float(scale))
    return out, lse


def flash_packed_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    segment_ids: torch.Tensor, positions: torch.Tensor,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Packed causal GQA attention through the CUDA flash kernel (bf16 in
    and out, f32 accumulation). On a CPU tensor: the plain version."""
    if q.device.type == "cpu":
        return reference_packed_attention(
            q, k, v, segment_ids, positions, softmax_scale=softmax_scale)
    scale = float(softmax_scale) if softmax_scale is not None else q.shape[-1] ** -0.5
    return _flash_fwd(q, k, v, segment_ids, positions, scale)[0]


# The model's attention entry: on CUDA the flash kernel, on the CPU the
# plain version (the dispatch lives in the kernel's wrapper).
packed_attention = flash_packed_attention
