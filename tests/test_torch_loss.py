"""Port parity: token-level loss primitives of areal_tpu_torch against
areal_tpu, on the same numpy inputs in float32.

Limits: forward values 1e-5 abs (logsumexp over a small vocabulary, other
reduction orders); gradients of the fused logprobs with respect to hidden
states and head 1e-4 of max|ref|. The fused path must never hold an
[R, T, V] tensor in either direction: a dispatch hook records the largest
tensor any op produces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from areal_tpu.ops import loss as jl
from areal_tpu_torch.ops import loss as tl

R, T, D, V = 2, 48, 16, 96


def make_inputs(seed=0):
    rng = np.random.default_rng(seed)
    seg = np.zeros((R, T), np.int32)
    seg[0, :20], seg[0, 20:41] = 1, 2
    seg[1, :45] = 1
    ids = rng.integers(0, V, size=(R, T)).astype(np.int32)
    hidden = rng.standard_normal((R, T, D)).astype(np.float32)
    head = (rng.standard_normal((D, V)) * 0.3).astype(np.float32)
    return hidden, head, ids, seg


def test_logprob_and_entropy_ops_match_reference():
    hidden, head, ids, seg = make_inputs()
    logits = hidden @ head
    want_lp = jl.next_token_logprobs(jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(seg))
    got_lp = tl.next_token_logprobs(torch.from_numpy(logits), torch.from_numpy(ids),
                                    torch.from_numpy(seg))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), atol=1e-5, rtol=0)
    assert np.all(got_lp.numpy()[seg == 0] == 0.0)
    want_ent = jl.next_token_entropy(jnp.asarray(logits), jnp.asarray(seg))
    got_ent = tl.next_token_entropy(torch.from_numpy(logits), torch.from_numpy(seg))
    np.testing.assert_allclose(got_ent.numpy(), np.asarray(want_ent), atol=1e-5, rtol=0)
    labels = np.asarray(ids)
    np.testing.assert_allclose(
        tl.gather_logprobs(torch.from_numpy(logits), torch.from_numpy(labels)).numpy(),
        np.asarray(jl.gather_logprobs(jnp.asarray(logits), jnp.asarray(labels))),
        atol=1e-5, rtol=0)
    mask = (seg > 0).astype(np.float32)
    want = jl.sft_loss(jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(mask))
    got = tl.sft_loss(torch.from_numpy(logits), torch.from_numpy(ids),
                      torch.from_numpy(seg), torch.from_numpy(mask))
    np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=1e-5)
    assert got[1].item() == float(want[1])


@pytest.mark.parametrize("n,target", [(96, 4096), (96, 7), (97, 50), (16384, 883)])
def test_pick_chunk_matches_reference(n, target):
    assert tl._pick_chunk(n, target) == jl._pick_chunk(n, target)


@pytest.mark.parametrize("chunk_size", [None, 96, 32, 7, 1])
def test_fused_logprobs_match_reference_forward_and_gradients(chunk_size):
    hidden, head, ids, seg = make_inputs(seed=1)
    w = np.random.default_rng(2).standard_normal((R, T)).astype(np.float32)

    def loss(h, hw):
        lp = jl.fused_next_token_logprobs(h, hw, jnp.asarray(ids), jnp.asarray(seg),
                                          chunk_size=chunk_size)
        return jnp.sum(lp * w), lp

    (_, want_lp), (want_dh, want_dw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(head))
    h = torch.from_numpy(hidden).requires_grad_(True)
    hw = torch.from_numpy(head).requires_grad_(True)
    lp = tl.fused_next_token_logprobs(h, hw, torch.from_numpy(ids), torch.from_numpy(seg),
                                      chunk_size=chunk_size)
    (lp * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(want_lp), atol=1e-5, rtol=0)
    for got, want in ((h.grad, want_dh), (hw.grad, want_dw)):
        want = np.asarray(want)
        assert np.max(np.abs(got.numpy() - want)) <= 1e-4 * np.max(np.abs(want))
    # the unfused path gives the same numbers
    full = tl.next_token_logprobs(torch.from_numpy(hidden @ head), torch.from_numpy(ids),
                                  torch.from_numpy(seg))
    np.testing.assert_allclose(lp.detach().numpy(), full.numpy(), atol=1e-5, rtol=0)


class _LargestTensor(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


def test_fused_logprobs_never_hold_the_full_logits():
    hidden, head, ids, seg = make_inputs(seed=3)
    h = torch.from_numpy(hidden).requires_grad_(True)
    hw = torch.from_numpy(head).requires_grad_(True)
    chunk = 8
    with _LargestTensor() as seen:
        lp = tl.fused_next_token_logprobs(h, hw, torch.from_numpy(ids), torch.from_numpy(seg),
                                          chunk_size=chunk)
        lp.sum().backward()
    # the largest tensors are the head's gradient [D, V], the hidden
    # states [R, T, D] and one [chunk, V] tile; never [R, T, V]
    assert seen.numel == max(D * V, R * T * D, chunk * V)
    assert seen.numel < R * T * V
    with _LargestTensor() as seen_unfused:
        tl.next_token_logprobs(h.detach() @ hw.detach(), torch.from_numpy(ids),
                               torch.from_numpy(seg))
    assert seen_unfused.numel == R * T * V  # the hook does see such a tensor


@pytest.mark.parametrize("unbiased", [True, False])
def test_masked_normalization_matches_reference(unbiased):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((R, T)) * 3 + 1).astype(np.float32)
    mask = (rng.random((R, T)) > 0.3).astype(np.float32)
    want = jl.masked_normalization(jnp.asarray(x), jnp.asarray(mask), unbiased=unbiased)
    got = tl.masked_normalization(torch.from_numpy(x), torch.from_numpy(mask), unbiased=unbiased)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert np.all(got.numpy()[mask == 0] == 0.0)
    empty = tl.masked_normalization(torch.from_numpy(x), torch.zeros(R, T))
    assert torch.all(empty == 0)
