"""Port parity: norms and rotary of areal_tpu_torch against areal_tpu.

Inputs are made from a seed with numpy and fed to both packages in
float32; outputs agree to rtol 1e-5 (same float32 formulas, different
libraries' reductions)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.ops import norms as jnorms
from areal_tpu.ops import rotary as jrot
from areal_tpu_torch.ops import norms as tnorms
from areal_tpu_torch.ops import rotary as trot

RTOL, ATOL = 1e-5, 1e-6


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal((64,)).astype(np.float32)
    _close(tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("with_bias", [True, False])
def test_layer_norm_matches_reference(with_bias):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 48)).astype(np.float32) + 2.0
    w = rng.standard_normal((48,)).astype(np.float32)
    b = rng.standard_normal((48,)).astype(np.float32) if with_bias else None
    _close(
        tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                          None if b is None else torch.from_numpy(b), 1e-5),
        jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w),
                          None if b is None else jnp.asarray(b), 1e-5),
    )


@pytest.mark.parametrize("scaling,stype,params", [
    (None, None, None),
    (4.0, "linear", None),
    (8.0, "llama3", {"low_freq_factor": 1.0, "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 64}),
])
def test_rotary_inv_freq_matches_reference(scaling, stype, params):
    got = trot.rotary_inv_freq(32, 500000.0, scaling, stype, params)
    want = jrot.rotary_inv_freq(32, 500000.0, scaling, stype, params)
    np.testing.assert_array_equal(got, want)


def test_rotary_rejects_unknown_scaling():
    with pytest.raises(NotImplementedError):
        trot.rotary_inv_freq(32, 10000.0, 2.0, "yarn")


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("stype", [None, "llama3"])
def test_apply_rotary_matches_reference(interleaved, stype):
    rng = np.random.default_rng(2)
    hd = 32
    params = {"original_max_position_embeddings": 128} if stype else None
    inv = trot.rotary_inv_freq(hd, 10000.0, 8.0 if stype else None, stype, params)
    pos = rng.integers(0, 4096, size=(2, 7)).astype(np.int32)
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)

    tcos, tsin = trot.rotary_cos_sin(torch.from_numpy(pos), torch.from_numpy(inv))
    jcos, jsin = jrot.rotary_cos_sin(jnp.asarray(pos), jnp.asarray(inv))
    _close(tcos, jcos)
    _close(tsin, jsin)
    got = trot.apply_rotary(torch.from_numpy(x), tcos, tsin, interleaved)
    want = jrot.apply_rotary(jnp.asarray(x), jcos, jsin, interleaved)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-5)
