"""AdamW, LR schedules and global-norm clipping (counterpart of
``areal_tpu/engine/optimizer.py``, which builds them from optax).

``AdamW.update`` computes what ``optax.chain(clip_by_global_norm(c),
adamw(lr=1, b1, b2, eps, weight_decay, mask=ndim > 1))`` computes: the
update for a unit learning rate. The caller scales it by the schedule
value it wants, which is how the train engine honours ``version_steps``
as the schedule position while Adam's bias correction keeps counting
actual updates. The moments are kept in each parameter's own dtype, as
optax keeps them (``mu_dtype=None``).

``AdamW.optax_state`` gives the state in the layout optax's chain keeps
it, and ``load_optax_state`` takes that layout back, so a checkpoint of
either package restores the other's optimizer. The optax state classes
are stood in for by NamedTuples of the same fields (``OPTAX_STATE_NAMES``
maps each to optax's module and name for the checkpoint pickle).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple

import numpy as np
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


def as_tensor(x) -> torch.Tensor:
    """A tensor over a numpy leaf (a copy if the array is read-only)."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    return torch.from_numpy(x if x.flags.writeable else x.copy())


def tree_unflatten(template, leaves: List[Any]):
    """A nested dict shaped as ``template`` holding ``leaves`` in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


class EmptyState(NamedTuple):
    """optax's ``EmptyState`` (identity, clip_by_global_norm, add_decayed_weights)."""


class ScaleByAdamState(NamedTuple):
    count: Any  # int32 0-d array: the number of updates
    mu: Any  # nested dict shaped as the params
    nu: Any


class MaskedState(NamedTuple):
    inner_state: Any


class ScaleByScheduleState(NamedTuple):
    count: Any


# The module and name each stand-in is pickled under: optax's, taken from
# a pickle optax 0.2.6 wrote (tests/test_torch_checkpoint.py holds them).
OPTAX_STATE_NAMES = {
    EmptyState: ("optax._src.base", "EmptyState"),
    ScaleByAdamState: ("optax._src.transform", "ScaleByAdamState"),
    MaskedState: ("optax.transforms._masking", "MaskedState"),
    ScaleByScheduleState: ("optax._src.transform", "ScaleByScheduleState"),
}


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

    def optax_state(self, params) -> tuple:
        """The state as the reference's optimizer keeps it: the state of
        ``chain(clip_by_global_norm or identity, adamw(..., mask))``, that
        is ``(EmptyState(), (ScaleByAdamState(count, mu, nu), MaskedState(
        EmptyState()), ScaleByScheduleState(count)))``, with ``mu`` and
        ``nu`` shaped as ``params`` (this optimizer's own tensors, not
        copies) and each count an int32 0-d array. Without weight decay
        the reference builds no mask, and the middle state is
        ``EmptyState()``."""
        count = np.asarray(self.count, dtype=np.int32)
        decay = MaskedState(EmptyState()) if self.cfg.weight_decay else EmptyState()
        adam = ScaleByAdamState(count, tree_unflatten(params, self.mu),
                                tree_unflatten(params, self.nu))
        return (EmptyState(), (adam, decay, ScaleByScheduleState(count.copy())))

    @torch.no_grad()
    def load_optax_state(self, state) -> None:
        """Take back a state in ``optax_state``'s layout (numpy or torch
        leaves), copying the moments into this optimizer's tensors."""
        try:
            adam = state[1][0]
            count, mu, nu = adam[0], adam[1], adam[2]
        except (IndexError, TypeError, KeyError) as e:
            raise ValueError(f"not an AdamW state in optax's layout: {e!r}")
        mu, nu = tree_leaves(mu), tree_leaves(nu)
        if len(mu) != len(self.mu) or len(nu) != len(self.nu):
            raise ValueError(f"optimizer state mismatch: {len(mu)} moments for "
                             f"{len(self.mu)} parameters")
        for dst, src in zip(self.mu + self.nu, mu + nu):
            src = as_tensor(src)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"optimizer state mismatch: {tuple(src.shape)} "
                                 f"for {tuple(dst.shape)}")
            dst.copy_(src.to(device=dst.device, dtype=dst.dtype))
        self.count = int(np.asarray(count))
