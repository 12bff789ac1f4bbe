"""Per-row token sampling (counterpart of ``areal_tpu/ops/sampling.py``
and of ``warp_logits`` / ``warp_sample`` in ``areal_tpu/engine/paged.py``).
``sample_token`` keeps the reference's signature for the in-framework
generator (``models/generation.py``), over ``warp_sample``.

Every sampling parameter is a ``[B]`` tensor, so one call serves any mix
of per-request temperature, top-k, top-p, greedy and EOS-forbid rows.
Random draws come from an explicit ``torch.Generator`` (Gumbel-max over
the warped logits, the same sampler as ``jax.random.categorical``; the
bits differ from JAX's, so tests compare the warped logits).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30
# top-k requests at or below this threshold warp through torch.topk
# instead of a full-vocab sort (tier 2 of warp_logits).
TOPK_FAST_MAX = 128

TIERS = ("temperature", "topk", "sort")


def select_tier(top_ps, top_ks, active_rows=None, vocab_size: int = 0) -> str:
    """The warp tier the ACTIVE rows need: 'temperature' (no top-k/top-p),
    'topk' (all active k <= TOPK_FAST_MAX and no top-p) or 'sort'.
    Accepts numpy arrays or tensors; on a CUDA tensor this reads the
    device, so the engine passes its host copies instead."""
    tp = np.asarray(top_ps.cpu() if isinstance(top_ps, torch.Tensor) else top_ps)
    tk = np.asarray(top_ks.cpu() if isinstance(top_ks, torch.Tensor) else top_ks)
    row_topk = tk > 0
    row_topp = tp < 1.0 - 1e-6
    if active_rows is not None:
        act = np.asarray(
            active_rows.cpu() if isinstance(active_rows, torch.Tensor) else active_rows
        ).astype(bool)
        row_topk &= act
        row_topp &= act
    if not (row_topk.any() or row_topp.any()):
        return "temperature"
    kmax = min(TOPK_FAST_MAX, vocab_size) if vocab_size else TOPK_FAST_MAX
    if row_topp.any() or (np.where(row_topk, tk, 0) > kmax).any():
        return "sort"
    return "topk"


def _with_cutoffs(warped, top_ps, top_ks):
    """One descending sort serves both warps (top-k threshold and top-p
    nucleus cutoff)."""
    V = warped.shape[-1]
    sorted_desc = torch.sort(warped, dim=-1, descending=True).values
    k_eff = torch.where(top_ks <= 0, V, torch.clamp(top_ks, max=V)).long()
    kth = torch.gather(sorted_desc, -1, (k_eff - 1)[:, None])
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_ps[:, None]
    cutoff_idx = (keep_sorted.sum(dim=-1, keepdim=True) - 1).clamp(min=0)
    p_cut = torch.gather(sorted_desc, -1, cutoff_idx)
    return torch.where(warped < torch.maximum(kth, p_cut), NEG_INF, warped)


def _with_topk_only(warped, top_ks):
    """k-th largest via torch.topk: the threshold the sort path gathers
    at sorted[k-1], without ordering the other V-k logits."""
    kmax = min(TOPK_FAST_MAX, warped.shape[-1])
    vals = torch.topk(warped, kmax, dim=-1).values  # [B, kmax] descending
    k_eff = torch.clamp(top_ks, 1, kmax).long()
    kth = torch.gather(vals, -1, (k_eff - 1)[:, None])
    kth = torch.where((top_ks > 0)[:, None], kth, NEG_INF)
    return torch.where(warped < kth, NEG_INF, warped)


def warp_logits(logits, temps, top_ps, top_ks, forbid_rows, eos_mask,
                active_rows=None, tier: Optional[str] = None):
    """Per-row temperature / top-k / top-p / EOS-forbid on [B, V] logits.

    Returns (warped [B, V], base_logp [B, V]): base_logp is the
    log-softmax of the UNWARPED, forbid-masked logits, the distribution
    PPO logprobs are reported under. The tiers give the same warped
    logits on the rows they share, except that the sort tier also cuts
    tail tokens whose cumulative probability rounds to 1 (as the
    reference's sort tier does). ``tier`` (see
    ``select_tier``) lets a caller that knows the rows' settings on the
    host skip the device read."""
    logits = logits.float()
    em = eos_mask if eos_mask.dim() == 2 else eos_mask[None, :]
    forbid = forbid_rows[:, None] & em
    logits = torch.where(forbid, NEG_INF, logits)
    base_logp = torch.log_softmax(logits, dim=-1)
    warped = logits / torch.clamp(temps.float()[:, None], min=1e-6)
    if tier is None:
        tier = select_tier(top_ps, top_ks, active_rows, logits.shape[-1])
    if tier == "sort":
        warped = _with_cutoffs(warped, top_ps.float(), top_ks)
    elif tier == "topk":
        warped = _with_topk_only(warped, top_ks)
    elif tier != "temperature":
        raise ValueError(f"unknown warp tier {tier!r}; expected one of {TIERS}")
    return warped, base_logp


def warp_sample(logits, generator: torch.Generator, temps, top_ps, top_ks,
                greedy_mask, forbid_rows, eos_mask, active_rows=None,
                tier: Optional[str] = None):
    """Per-row warped sampling. Returns (tokens [B] int32, logprobs [B] of
    the unwarped distribution); greedy rows take the argmax of
    base_logp."""
    warped, base_logp = warp_logits(
        logits, temps, top_ps, top_ks, forbid_rows, eos_mask,
        active_rows=active_rows, tier=tier,
    )
    u = torch.rand(warped.shape, generator=generator, device=warped.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
    sampled = torch.argmax(warped + gumbel, dim=-1)
    argmax = torch.argmax(base_logp, dim=-1)
    tokens = torch.where(greedy_mask, argmax, sampled)
    logprobs = torch.gather(base_logp, -1, tokens[:, None])[:, 0]
    return tokens.int(), logprobs


def sample_token(
    logits: torch.Tensor,  # [B, V]
    rng: torch.Generator,
    greedy: bool = False,
    temperature: float = 1.0,
    top_k: int = -1,
    top_p: float = 1.0,
    forbid_token_ids=None,  # e.g. the stop tokens under min_new_tokens
    forbid_mask: Optional[torch.Tensor] = None,  # [B] rows the forbid applies to
):
    """The reference's ``sample_token`` (``areal_tpu/ops/sampling.py``)
    with one setting for every row, through ``warp_sample``: returns
    (tokens [B] int32, logprobs [B]); the logprob is of the forbid-masked,
    unwarped distribution, and sampling draws from the warped one. ``rng``
    is a ``torch.Generator`` (the reference splits a JAX key), so sampled
    tokens differ from the reference's; greedy rows take the argmax."""
    B, V = logits.shape
    dev = logits.device
    eos_mask = torch.zeros((V,), dtype=torch.bool, device=dev)
    ids = list(forbid_token_ids) if forbid_token_ids is not None else []
    if ids:
        eos_mask[torch.as_tensor(ids, dtype=torch.long, device=dev)] = True
    if forbid_mask is None:
        forbid_mask = torch.full((B,), bool(ids), dtype=torch.bool, device=dev)

    def full(value, dtype):
        return torch.full((B,), value, dtype=dtype, device=dev)

    tier = "temperature" if greedy else select_tier(
        np.asarray([top_p], np.float32), np.asarray([top_k], np.int32), vocab_size=V)
    return warp_sample(
        logits, rng, full(float(temperature), torch.float32),
        full(float(top_p), torch.float32), full(int(top_k), torch.int32),
        full(bool(greedy), torch.bool), forbid_mask, eos_mask, tier=tier)
