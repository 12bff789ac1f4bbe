"""Port parity: the backward of packed attention in areal_tpu_torch
against areal_tpu.

The same numpy q, k, v, dout and packing go through
(a) ``jax.grad`` of the reference's plain ``reference_packed_attention``,
(b) the reference's Pallas ``_bwd`` kernels in interpret mode (through the
    ``custom_vjp`` of ``flash_packed_attention``, as
    tests/model/test_flash_attn.py runs them on the CPU),
and through the port's two plain paths: autograd through
``reference_packed_attention`` (what a CPU tensor takes) and the explicit
``reference_packed_attention_bwd`` (the CUDA kernels' arithmetic, the
yardstick they are held against on the card).

Limits: float32 inputs 1e-4 of max|ref| per tensor (same math, other
reduction orders); bfloat16 inputs 2e-2 of max|ref| per tensor (p and ds
are rounded to bf16 before the products, and outputs to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.ops.attention import reference_packed_attention as jax_reference
from areal_tpu.ops.pallas.flash_attn import flash_packed_attention as jax_flash
from areal_tpu_torch.ops.attention import (
    flash_packed_attention,
    reference_packed_attention,
    reference_packed_attention_bwd,
)

CASES = {
    # name: (T, n_seqs, Hq, Hkv, hd)
    "mha_hd64": (256, 3, 4, 4, 64),
    "gqa2_hd64": (256, 3, 4, 2, 64),
    "gqa3_hd128": (128, 2, 6, 2, 128),
    "gqa6_hd64": (256, 4, 6, 1, 64),
}


def make_packed(T, n_seqs, hq, hkv, hd, seed):
    """Random cut points -> n_seqs contiguous segments + tail padding."""
    rng = np.random.RandomState(seed)
    cuts = np.sort(rng.choice(np.arange(1, T - 1), size=n_seqs - 1, replace=False))
    bounds = [0, *cuts.tolist(), T - rng.randint(1, T // 8)]
    seg = np.zeros(T, np.int32)
    pos = np.zeros(T, np.int32)
    for s in range(n_seqs):
        lo, hi = bounds[s], bounds[s + 1]
        seg[lo:hi] = s + 1
        pos[lo:hi] = np.arange(hi - lo)
    q = rng.randn(T, hq, hd).astype(np.float32)
    k = rng.randn(T, hkv, hd).astype(np.float32)
    v = rng.randn(T, hkv, hd).astype(np.float32)
    dout = rng.randn(T, hq, hd).astype(np.float32)
    return q, k, v, dout, seg, pos


def jax_grads(fn, q, k, v, dout, seg, pos):
    def loss(q, k, v):
        return jnp.vdot(fn(q, k, v, seg, pos), dout)

    return [np.asarray(g, np.float32) for g in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


def torch_autograd_grads(q, k, v, dout, seg, pos, dtype):
    qt, kt, vt = (torch.from_numpy(x)[None].to(dtype).requires_grad_(True) for x in (q, k, v))
    out = flash_packed_attention(qt, kt, vt, torch.from_numpy(seg)[None],
                                 torch.from_numpy(pos)[None])
    out.backward(torch.from_numpy(dout)[None].to(dtype))
    return [t.grad[0].float().numpy() for t in (qt, kt, vt)]


def torch_explicit_grads(q, k, v, dout, seg, pos, dtype):
    qt, kt, vt, dt = (torch.from_numpy(x)[None].to(dtype) for x in (q, k, v, dout))
    grads = reference_packed_attention_bwd(
        qt, kt, vt, torch.from_numpy(seg)[None], torch.from_numpy(pos)[None], dt)
    return [g[0].float().numpy() for g in grads]


def assert_close(got, want, rel, what):
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        err = float(np.max(np.abs(g - w)))
        scale = float(np.max(np.abs(w)))
        assert err <= rel * scale, f"{what} {name}: {err:.3e} > {rel} * {scale:.3e}"


@pytest.mark.parametrize("path", ["autograd", "explicit"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_grads_match_jax_grad_of_the_plain_reference(case, path):
    args = make_packed(*CASES[case], seed=7)
    want = jax_grads(jax_reference, *args)
    fn = torch_autograd_grads if path == "autograd" else torch_explicit_grads
    assert_close(fn(*args, torch.float32), want, 1e-4, f"{case} {path}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_grads_match_the_pallas_backward_kernels(case):
    args = make_packed(*CASES[case], seed=11)
    want = jax_grads(lambda *a: jax_flash(*a, interpret=True), *args)
    assert_close(torch_explicit_grads(*args, torch.float32), want, 1e-4, case)
    assert_close(torch_autograd_grads(*args, torch.float32), want, 1e-4, case)


@pytest.mark.parametrize("case", ["gqa2_hd64", "gqa3_hd128"])
def test_bf16_grads_match_the_pallas_backward_kernels(case):
    q, k, v, dout, seg, pos = make_packed(*CASES[case], seed=13)
    bf = lambda x: np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    q, k, v, dout = bf(q), bf(k), bf(v), bf(dout)  # values exact in bf16

    def loss(q, k, v):
        out = jax_flash(q.astype(jnp.bfloat16), k.astype(jnp.bfloat16),
                        v.astype(jnp.bfloat16), seg, pos, interpret=True)
        return jnp.vdot(out.astype(jnp.float32), dout)

    want = [np.asarray(g, np.float32) for g in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]
    got = torch_explicit_grads(q, k, v, dout, seg, pos, torch.bfloat16)
    assert_close(got, want, 2e-2, case)


def test_padding_rows_get_zero_dq_and_add_nothing_to_dk_dv():
    """Two packed rows, the second all padding: its dq, dk, dv are exact
    zeros, and padding positions of the first row get exact zeros too."""
    q, k, v, dout, seg, pos = make_packed(128, 2, 4, 2, 64, seed=17)
    R = lambda x: torch.from_numpy(np.stack([x, x]))
    seg2 = np.stack([seg, np.zeros_like(seg)])
    pos2 = np.stack([pos, np.zeros_like(pos)])
    grads = reference_packed_attention_bwd(
        R(q), R(k), R(v), torch.from_numpy(seg2), torch.from_numpy(pos2), R(dout))
    for g in grads:
        assert torch.all(g[1] == 0)
        assert torch.all(g[0][torch.from_numpy(seg) == 0] == 0)
        assert torch.isfinite(g).all()
    # With the forward kernel's logsumexp convention on padding rows
    # (-1e30): exp(s - lse) overflows there and must still be masked.
    lse = torch.full((2, 4, 128), -1e30)
    out = reference_packed_attention(R(q), R(k), R(v), torch.from_numpy(seg2),
                                     torch.from_numpy(pos2))
    grads2 = reference_packed_attention_bwd(
        R(q), R(k), R(v), torch.from_numpy(np.stack([np.zeros_like(seg)] * 2)),
        torch.from_numpy(pos2), R(dout), out=out, lse=lse)
    for g in grads2:
        assert torch.all(g == 0)
