"""Port parity: LR schedules and AdamW of areal_tpu_torch against the
reference's optax build, on fixed numpy params and gradients.

Limits: schedules 1e-5 relative (optax evaluates them in float32, and its
ramp (init - end) * frac + end cancels: it reads 1.5000027e-05 where the
value is 1.5e-05);
parameters after 5 AdamW steps 1e-6 abs and 1e-5 relative to the largest
update (float32 arithmetic in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from areal_tpu.engine import optimizer as jo
from areal_tpu_torch.engine import optimizer as to

TOTAL = 200


@pytest.mark.parametrize("kind", ["constant", "linear", "cosine"])
@pytest.mark.parametrize("warmup_prop", [0.0, 0.1])
def test_schedule_matches_optax(kind, warmup_prop):
    kw = dict(lr=3e-4, lr_scheduler_type=kind, warmup_steps_proportion=warmup_prop,
              min_lr_ratio=0.1)
    want = jo.make_lr_schedule(jo.OptimizerConfig(**kw), TOTAL)
    got = to.make_lr_schedule(to.OptimizerConfig(**kw), TOTAL)
    warmup = int(warmup_prop * TOTAL)
    for step in (0, 1, warmup - 1, warmup, warmup + 1, TOTAL // 2, TOTAL - 1, TOTAL, TOTAL + 50):
        if step < 0:
            continue
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5, err_msg=str(step))
    if warmup:
        np.testing.assert_allclose(got(0), 3e-4 / warmup, rtol=1e-6)  # first step trains


def test_unknown_schedule_and_optimizer_are_refused():
    with pytest.raises(ValueError, match="lr_scheduler_type"):
        to.make_lr_schedule(to.OptimizerConfig(lr_scheduler_type="step"), 10)
    with pytest.raises(NotImplementedError):
        to.AdamW(to.OptimizerConfig(type="sgd"), [torch.zeros(2)])


def _tree(rng):
    return {
        "layers": {"w": rng.standard_normal((2, 6, 5)).astype(np.float32),
                   "b": rng.standard_normal((2, 5)).astype(np.float32)},
        "norm": rng.standard_normal((6,)).astype(np.float32),
        "embedding": rng.standard_normal((7, 6)).astype(np.float32),
    }


@pytest.mark.parametrize("clip", [0.0, 1.0, 100.0])
@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_adamw_matches_optax(clip, weight_decay):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [jax.tree_util.tree_map(lambda p: (rng.standard_normal(p.shape) * 2).astype(np.float32),
                                    params) for _ in range(5)]
    lrs = [1e-2, 1e-2, 5e-3, 2e-2, 1e-3]
    kw = dict(lr=1e-2, weight_decay=weight_decay, gradient_clipping=clip, eps=1e-5)

    tx = jo.make_optimizer(jo.OptimizerConfig(**kw), 10, external_lr=True)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    for g, lr in zip(grads, lrs):
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + (u * jnp.float32(lr)).astype(p.dtype),
                                    jp, updates)

    tp = to.tree_leaves(jax.tree_util.tree_map(lambda p: torch.from_numpy(p.copy()), params))
    opt = to.AdamW(to.OptimizerConfig(**kw), tp)
    for g, lr in zip(grads, lrs):
        gl = to.tree_leaves(jax.tree_util.tree_map(torch.from_numpy, g))
        opt.apply(tp, gl, to.global_norm(gl), lr)
    assert opt.count == 5

    moved = 0.0
    for got, want, start in zip(tp, jax.tree_util.tree_leaves(jp),
                                jax.tree_util.tree_leaves(params)):
        want = np.asarray(want)
        moved = max(moved, float(np.max(np.abs(want - start))))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)
    assert moved > 1e-3  # the steps did something


def test_global_norm_and_leaf_order_match_jax():
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    leaves = to.tree_leaves(jax.tree_util.tree_map(torch.from_numpy, tree))
    for a, b in zip(leaves, jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)
    want = optax.global_norm(jax.tree_util.tree_map(jnp.asarray, tree))
    np.testing.assert_allclose(to.global_norm(leaves).item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moments_start_in_the_parameters_dtype_as_optax_keeps_them(dtype):
    tx = jo.make_optimizer(jo.OptimizerConfig(), 10, external_lr=True)
    p = {"w": jnp.zeros((3, 2), dtype)}
    adam = [s for s in jax.tree_util.tree_leaves(tx.init(p)) if s.shape == (3, 2)]
    assert adam and all(s.dtype == jnp.dtype(dtype) for s in adam)
    opt = to.AdamW(to.OptimizerConfig(), [torch.zeros(3, 2, dtype=getattr(torch, dtype))])
    assert opt.mu[0].dtype == opt.nu[0].dtype == getattr(torch, dtype)
