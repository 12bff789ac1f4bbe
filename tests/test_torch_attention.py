"""Port parity: packed attention of areal_tpu_torch against areal_tpu.

The port's ``packed_attention`` on a CPU tensor runs its plain version
(the CUDA flash kernel is held against it on the card by
chip_smoke.py). Here it is held against the reference's dense oracle
and against the reference's Pallas flash kernel run in interpret mode,
as tests/model/test_flash_attn.py runs it. float32 inputs made from a
seed; rtol 1e-4, atol 1e-5 (different reduction orders; the Pallas
kernel's online softmax)."""

import numpy as np
import pytest
import torch

from areal_tpu.ops.attention import reference_packed_attention as jax_reference
from areal_tpu.ops.pallas.flash_attn import flash_packed_attention as jax_flash
from areal_tpu_torch.ops.attention import (
    flash_packed_attention,
    packed_attention,
    reference_packed_attention,
)

RTOL, ATOL = 1e-4, 1e-5


def make_packed(T, n_seqs, hq, hkv, hd, seed, pad_tail=0):
    rng = np.random.RandomState(seed)
    cuts = np.sort(rng.choice(np.arange(1, T - 1), size=n_seqs - 1, replace=False))
    bounds = [0, *cuts.tolist(), T - pad_tail]
    seg = np.zeros(T, np.int32)
    pos = np.zeros(T, np.int32)
    for s in range(n_seqs):
        lo, hi = bounds[s], bounds[s + 1]
        seg[lo:hi] = s + 1
        pos[lo:hi] = np.arange(hi - lo)
    q = rng.randn(T, hq, hd).astype(np.float32)
    k = rng.randn(T, hkv, hd).astype(np.float32)
    v = rng.randn(T, hkv, hd).astype(np.float32)
    return q, k, v, seg, pos


def port(fn, q, k, v, seg, pos):
    """Run a port function on one packed row (leading R = 1)."""
    t = lambda a: torch.from_numpy(a)[None]
    return fn(t(q), t(k), t(v), t(seg), t(pos))[0].numpy()


@pytest.fixture(scope="module")
def cases():
    """(inputs, jax reference output, jax flash output) per case; the JAX
    flash kernel runs once per case in interpret mode."""
    out = {}
    for name, hq, hkv in (("gqa_4_2", 4, 2), ("gqa_6_1", 6, 1)):
        args = make_packed(256, n_seqs=3, hq=hq, hkv=hkv, hd=32, seed=hq, pad_tail=40)
        out[name] = (args, np.asarray(jax_reference(*args)),
                     np.asarray(jax_flash(*args, interpret=True)))
    return out


@pytest.mark.parametrize("name", ["gqa_4_2", "gqa_6_1"])
def test_packed_attention_matches_reference(cases, name):
    args, ref, _ = cases[name]
    np.testing.assert_allclose(port(packed_attention, *args), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["gqa_4_2", "gqa_6_1"])
def test_packed_attention_matches_pallas_flash(cases, name):
    args, _, flash = cases[name]
    got = port(packed_attention, *args)
    np.testing.assert_allclose(got, flash, rtol=RTOL, atol=ATOL)
    seg = args[3]
    np.testing.assert_array_equal(got[seg == 0], 0.0)  # padding rows write 0


def test_rows_are_independent():
    """The leading row dimension R (the reference vmaps over rows): two
    rows at once equal each row alone."""
    a = make_packed(64, 2, 4, 2, 16, seed=1, pad_tail=5)
    b = make_packed(64, 3, 4, 2, 16, seed=2)
    stack = [torch.from_numpy(np.stack([x, y])) for x, y in zip(a, b)]
    both = reference_packed_attention(*stack).numpy()
    np.testing.assert_allclose(both[0], port(reference_packed_attention, *a), rtol=1e-6)
    np.testing.assert_allclose(both[1], port(reference_packed_attention, *b), rtol=1e-6)


def test_wrapper_on_cpu_is_the_plain_version():
    args = make_packed(32, 2, 4, 2, 16, seed=3)
    np.testing.assert_array_equal(port(flash_packed_attention, *args),
                                  port(reference_packed_attention, *args))
    assert packed_attention is flash_packed_attention
