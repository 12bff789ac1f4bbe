"""Token-level loss / logprob primitives over packed rows (counterpart of
``areal_tpu/ops/loss.py``).

All token-aligned arrays live in the shifted frame: position t scores the
token at t + 1 of the same segment; sequence-final tokens and padding
score nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint


def gather_logprobs(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """log P(labels) under logits along the last axis, float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long().unsqueeze(-1))[..., 0]
    return picked - lse


def shift_left(x: torch.Tensor, fill=0) -> torch.Tensor:
    """x[:, t+1] at t, ``fill`` in the last column."""
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


def _next_token_targets(input_ids: torch.Tensor, segment_ids: torch.Tensor):
    """(next_ids, valid) in the shifted frame shared by all logprob ops."""
    next_ids = shift_left(input_ids)
    valid = (segment_ids > 0) & (shift_left(segment_ids) == segment_ids)
    return next_ids, valid


def next_token_logprobs(
    logits: torch.Tensor,  # [R, T, V]
    input_ids: torch.Tensor,  # [R, T]
    segment_ids: torch.Tensor,  # [R, T], 0 = pad
) -> torch.Tensor:
    """logprob[t] = log P(token[t+1] | prefix) where t+1 continues the same
    segment; 0 elsewhere (sequence-final tokens, padding). Shape [R, T]."""
    next_ids, valid = _next_token_targets(input_ids, segment_ids)
    return torch.where(valid, gather_logprobs(logits, next_ids), 0.0)


def next_token_entropy(logits: torch.Tensor, segment_ids: torch.Tensor) -> torch.Tensor:
    """Per-position predictive entropy, masked like next_token_logprobs."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ent = -(torch.exp(logp) * logp).sum(-1)
    return torch.where(segment_ids > 0, ent, 0.0)


def _pick_chunk(n_tokens: int, target: int = 4096) -> int:
    """Largest divisor of n_tokens that is <= target (>= 1)."""
    c = min(target, n_tokens)
    while n_tokens % c:
        c -= 1
    return c


def _chunk_logprobs(h_c, y_c, head_w):
    logits = (h_c @ head_w.to(h_c.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, y_c.unsqueeze(-1))[:, 0]
    return picked - lse


def fused_next_token_logprobs(
    hidden: torch.Tensor,  # [R, T, D] compute dtype
    head_w: torch.Tensor,  # [D, V]
    input_ids: torch.Tensor,  # [R, T]
    segment_ids: torch.Tensor,  # [R, T]
    chunk_size: Optional[int] = None,
) -> torch.Tensor:
    """next_token_logprobs straight from hidden states, without ever
    holding the [R, T, V] logits.

    The token axis is flattened and walked in chunks; each chunk computes
    its [C, V] logits tile, reduces it to (picked - logsumexp) and drops
    it. Each chunk is checkpointed, so the backward recomputes the tile
    instead of keeping softmax residuals: peak memory is O(C * V) in both
    directions. The head's gradient accumulates over chunks in the head's
    own dtype. ``chunk_size`` defaults to a byte budget: a float32 tile of
    about 512 MB whatever the vocabulary (C * V elements), at least 256
    tokens; the chunk used is the largest divisor of R * T at or below it.

    Returns [R, T] float32, zeros at invalid (sequence-final / pad) slots.
    """
    R, T, D = hidden.shape
    V = head_w.shape[-1]
    if chunk_size is None:
        chunk_size = max(256, (1 << 27) // V)
    next_ids, valid = _next_token_targets(input_ids, segment_ids)
    n = R * T
    c = _pick_chunk(n, chunk_size)
    flat_h = hidden.reshape(n // c, c, D)
    flat_y = next_ids.reshape(n // c, c).long()
    needs_grad = torch.is_grad_enabled() and (hidden.requires_grad or head_w.requires_grad)
    chunks = []
    for h_c, y_c in zip(flat_h, flat_y):
        if needs_grad:
            chunks.append(checkpoint(_chunk_logprobs, h_c, y_c, head_w, use_reentrant=False))
        else:
            chunks.append(_chunk_logprobs(h_c, y_c, head_w))
    logp = torch.cat(chunks).reshape(R, T)
    return torch.where(valid, logp, 0.0)


def sft_loss_from_logprobs(
    logp: torch.Tensor,  # [R, T] next-token logprobs (zeros at invalid)
    loss_mask: torch.Tensor,  # [R, T]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked next-token NLL from precomputed logprobs: (sum, n_tokens)."""
    mask = loss_mask.float()
    return -(logp * mask).sum(), mask.sum()


def sft_loss(
    logits: torch.Tensor,  # [R, T, V]
    input_ids: torch.Tensor,  # [R, T]
    segment_ids: torch.Tensor,  # [R, T]
    loss_mask: torch.Tensor,  # [R, T] 1.0 where the target token (t+1) counts
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token cross entropy over masked positions: (sum_loss,
    n_tokens); callers normalize globally."""
    return sft_loss_from_logprobs(
        next_token_logprobs(logits, input_ids, segment_ids), loss_mask)


def masked_normalization(
    x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-5, unbiased: bool = True,
) -> torch.Tensor:
    """Whiten x over masked elements (advantage normalization)."""
    mask = mask.float()
    x32 = x.float()
    n = mask.sum().clamp(min=1.0)
    mean = (x32 * mask).sum() / n
    var = (((x32 - mean) ** 2) * mask).sum() / (n - (1.0 if unbiased else 0.0)).clamp(min=1.0)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return torch.where(mask > 0, out, 0.0).to(x.dtype)
