"""AdamW, LR schedules and global-norm clipping (counterpart of
``areal_tpu/engine/optimizer.py``, which builds them from optax).

``AdamW.update`` computes what ``optax.chain(clip_by_global_norm(c),
adamw(lr=1, b1, b2, eps, weight_decay, mask=ndim > 1))`` computes: the
update for a unit learning rate. The caller scales it by the schedule
value it wants, which is how the train engine honours ``version_steps``
as the schedule position while Adam's bias correction keeps counting
actual updates. The moments are kept in each parameter's own dtype, as
optax keeps them (``mu_dtype=None``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List

import torch


@dataclasses.dataclass
class OptimizerConfig:
    """Mirrors the reference's OptimizerConfig dataclass."""

    type: str = "adamw"
    lr: float = 1e-5
    weight_decay: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-5
    min_lr_ratio: float = 0.0
    lr_scheduler_type: str = "constant"  # constant | linear | cosine
    warmup_steps_proportion: float = 0.001
    gradient_clipping: float = 1.0


def make_lr_schedule(cfg: OptimizerConfig, total_train_steps: int) -> Callable[[int], float]:
    """step -> learning rate: a linear warmup from lr / warmup to lr over
    ``warmup`` steps (so the very first step trains), then constant, linear
    or cosine decay to lr * min_lr_ratio over the remaining steps."""
    warmup = int(cfg.warmup_steps_proportion * total_train_steps)
    decay_steps = max(1, total_train_steps - warmup)
    end = cfg.lr * cfg.min_lr_ratio
    if cfg.lr_scheduler_type not in ("constant", "linear", "cosine"):
        raise ValueError(f"unknown lr_scheduler_type {cfg.lr_scheduler_type!r}")

    def after(step: int) -> float:
        if cfg.lr_scheduler_type == "constant":
            return cfg.lr
        frac = min(max(step, 0), decay_steps) / decay_steps
        if cfg.lr_scheduler_type == "linear":
            return cfg.lr + frac * (end - cfg.lr)
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return cfg.lr * ((1.0 - cfg.min_lr_ratio) * cosine + cfg.min_lr_ratio)

    def schedule(step: int) -> float:
        step = int(step)
        if step < warmup:
            start = cfg.lr / warmup
            return start + (min(max(step, 0), warmup) / warmup) * (cfg.lr - start)
        return after(step - warmup)

    return schedule


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict of tensors, in sorted-key order (the order
    jax flattens a dict in)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all leaves, float32, on the device."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


class AdamW:
    """State and update rule over a list of parameter leaves."""

    def __init__(self, cfg: OptimizerConfig, params: List[torch.Tensor]):
        if cfg.type != "adamw":
            raise NotImplementedError(f"optimizer type {cfg.type!r}")
        self.cfg = cfg
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              grad_norm: torch.Tensor, lr: float) -> None:
        """One update in place: clip ``grads`` (whose global norm is
        ``grad_norm``) to ``cfg.gradient_clipping``, advance the moments,
        and add ``lr`` times the unit-learning-rate AdamW update to each
        parameter. Weight decay applies to leaves with more than one
        dimension. No host sync: the clip factor stays on the device."""
        cfg = self.cfg
        if cfg.gradient_clipping:
            # optax.clip_by_global_norm: g * (clip / norm) where norm > clip.
            clip = torch.where(grad_norm < cfg.gradient_clipping,
                               torch.ones_like(grad_norm),
                               cfg.gradient_clipping / grad_norm)
        self.count += 1
        bc1 = 1.0 - cfg.beta1 ** self.count
        bc2 = 1.0 - cfg.beta2 ** self.count
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            g = g.to(p.dtype)
            if cfg.gradient_clipping:
                g = g * clip.to(p.dtype)
            mu.mul_(cfg.beta1).add_(g, alpha=1.0 - cfg.beta1)
            nu.mul_(cfg.beta2).addcmul_(g, g, value=1.0 - cfg.beta2)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
            if cfg.weight_decay and p.dim() > 1:
                update = update + cfg.weight_decay * p
            p.add_((update * (-lr)).to(p.dtype))
