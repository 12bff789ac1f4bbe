"""PPO functional suite: decoupled loss, rewards, KL controllers, value
norm (counterpart of ``areal_tpu/interfaces/functional.py``). The loss math
runs on packed [R, T] tensors on the engine's device; the controllers and
the value normalizer keep small host state."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch


class FixedKLController:

    def __init__(self, kl_coef: float):
        self.value = kl_coef

    def update(self, current_kl: float, n_steps: int):
        pass


class AdaptiveKLController:

    def __init__(self, init_kl_coef: float, target: float, horizon: float):
        self.value = init_kl_coef
        self.target = target
        self.horizon = horizon

    def update(self, current_kl: float, n_steps: int):
        error = np.clip(current_kl / self.target - 1, -0.2, 0.2)
        self.value *= 1 + error * n_steps / self.horizon


def packed_rewards(
    kl_coef: float,
    clip_reward_value: float,
    score: torch.Tensor,  # [R, T]: task reward broadcast per token (used at seq end)
    logprobs: torch.Tensor,  # [R, T] behavior logprobs (shifted frame)
    ref_logprobs: torch.Tensor,  # [R, T]
    response_mask: torch.Tensor,  # [R, T] 1.0 on response-token positions (shifted)
    last_response_mask: torch.Tensor,  # [R, T] 1.0 only at the final response position
    mask_no_eos_with_zero: bool = False,
    no_eos_mask: Optional[torch.Tensor] = None,  # [R, T] 1 where seq had no EOS
) -> torch.Tensor:
    """Token-level rewards: -kl_coef * (logp - ref_logp) everywhere on the
    response, plus the clipped task score at the final response token."""
    kl = (logprobs - ref_logprobs) * response_mask
    rewards = -kl_coef * kl
    tail = torch.clamp(score, -clip_reward_value, clip_reward_value)
    if mask_no_eos_with_zero and no_eos_mask is not None:
        tail = torch.where(no_eos_mask > 0, 0.0, tail)
    return rewards + tail * last_response_mask


def actor_loss_fn(
    logprobs: torch.Tensor,  # [R, T] current policy
    old_logprobs: torch.Tensor,  # [R, T] behavior policy (from generation)
    advantages: torch.Tensor,  # [R, T]
    eps_clip: float,
    loss_mask: torch.Tensor,  # [R, T]
    c_clip: Optional[float] = None,
    proximal_logprobs: Optional[torch.Tensor] = None,
    behav_imp_weight_cap: Optional[float] = None,
    stats_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decoupled-PPO clipped surrogate (sum over masked tokens).

    With `proximal_logprobs` (the policy recomputed at training time), the
    clipping centre is the proximal policy and the behavior correction
    exp(prox - old) multiplies the loss, optionally capped: the decoupled
    objective that keeps stale rollouts usable. Without it, plain PPO
    (prox == old). Dual clip via c_clip. `stats_mask` keeps monitoring on
    the raw response mask when `loss_mask` carries normalization scales.
    """
    mask = loss_mask.float()
    smask = mask if stats_mask is None else stats_mask.float()
    denom_prox = proximal_logprobs if proximal_logprobs is not None else old_logprobs
    ratio = torch.exp((logprobs - denom_prox) * (mask > 0))
    clipped_ratio = torch.clamp(ratio, 1.0 - eps_clip, 1.0 + eps_clip)
    adv = advantages.float()
    surr1 = ratio * adv
    surr2 = clipped_ratio * adv
    loss = -torch.minimum(surr1, surr2)
    clip_mask = surr1 > surr2  # where clipping binds
    if c_clip is not None:
        # Dual clip: bound the loss for very negative advantages.
        surr3 = c_clip * adv
        dual_mask = (adv < 0) & (surr3 > torch.minimum(surr1, surr2))
        loss = torch.where(dual_mask, -surr3, loss)
    else:
        dual_mask = torch.zeros_like(clip_mask)
    if proximal_logprobs is not None:
        behav_w = torch.exp((denom_prox - old_logprobs) * (mask > 0))
        if behav_imp_weight_cap is not None:
            # Tokens whose behavior weight exceeds the cap are dropped.
            keep = (behav_w <= behav_imp_weight_cap).float()
            mask = mask * keep
            smask = smask * keep
        loss = loss * behav_w
    loss_sum = (loss * mask).sum()
    stats = {
        "importance_weight": (ratio * smask).sum(),
        "clip_ratio": (clip_mask.float() * smask).sum(),
        "dual_clip_ratio": (dual_mask.float() * smask).sum(),
        "actor_denom": smask.sum(),
    }
    return loss_sum, stats


def critic_loss_fn(
    value: torch.Tensor,  # [R, T]
    old_value: torch.Tensor,  # [R, T]
    target_value: torch.Tensor,  # [R, T] returns
    value_eps_clip: float,
    loss_mask: torch.Tensor,
    stats_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped value loss (sum over masked tokens)."""
    mask = loss_mask.float()
    smask = mask if stats_mask is None else stats_mask.float()
    value = value.float()
    clipped = old_value + torch.clamp(value - old_value, -value_eps_clip, value_eps_clip)
    l1 = (value - target_value) ** 2
    l2 = (clipped - target_value) ** 2
    loss = 0.5 * torch.maximum(l1, l2)
    clip_mask = l2 > l1
    return (loss * mask).sum(), {
        "value_clip_ratio": (clip_mask.float() * smask).sum(),
    }


@dataclasses.dataclass
class RunningMeanStd:
    """EMA running statistics used to normalize critic targets."""

    beta: float = 0.99995
    epsilon: float = 1e-5
    mean: float = 0.0
    mean_sq: float = 0.0
    debiasing_term: float = 0.0

    def update(self, x: np.ndarray, mask: Optional[np.ndarray] = None):
        x = np.asarray(x, np.float64)
        if mask is not None:
            m = np.asarray(mask, bool)
            if m.sum() == 0:
                return
            x = x[m]
        batch_mean = float(x.mean())
        batch_sq = float((x**2).mean())
        self.mean = self.beta * self.mean + (1 - self.beta) * batch_mean
        self.mean_sq = self.beta * self.mean_sq + (1 - self.beta) * batch_sq
        self.debiasing_term = self.beta * self.debiasing_term + (1 - self.beta)

    @property
    def debiased_mean(self) -> float:
        return self.mean / max(self.debiasing_term, self.epsilon)

    @property
    def debiased_std(self) -> float:
        mean = self.debiased_mean
        var = self.mean_sq / max(self.debiasing_term, self.epsilon) - mean**2
        return float(np.sqrt(max(var, self.epsilon)))

    def normalize(self, x):
        return (np.asarray(x, np.float32) - self.debiased_mean) / self.debiased_std

    def denormalize(self, x):
        return np.asarray(x, np.float32) * self.debiased_std + self.debiased_mean

    def state_dict(self):
        return dataclasses.asdict(self)

    def load_state_dict(self, d):
        for k, v in d.items():
            setattr(self, k, v)
