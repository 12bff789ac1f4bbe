"""Port parity: GAE over packed rows in areal_tpu_torch against areal_tpu.

The same numpy rewards, values, segment ids and bootstraps go through the
reference's serial oracle ``gae_rows`` (and its Pallas scan kernel in
interpret mode) and through the port's ``packed_gae`` /
``segment_scan_reverse``, which on CPU tensors run the scan kernel's plain
version. Cases follow tests/ops/test_gae.py: misaligned packing,
all-padding rows, a bootstrap at a segment boundary, lam 0 and 1.

Limit: 1e-5 of max(1, max|ref|) (the scan and the oracle associate the
float32 sums differently); positions outside segments are exact zeros.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.ops import gae as jax_gae
from areal_tpu.ops.pallas.gae_scan import segment_scan_reverse as pallas_scan
from areal_tpu_torch.ops import gae as torch_gae


def _pack(R, T, seed=0, max_len=40, gap=True):
    """Misaligned packed rows: segments start at random offsets, padding
    gaps between them, a bootstrap at every segment's final token."""
    rng = np.random.RandomState(seed)
    seg = np.zeros((R, T), np.int32)
    boot = np.zeros((R, T), np.float32)
    for r in range(R):
        t = int(rng.randint(0, 5))
        s = 1
        while t < T - 4:
            length = int(rng.randint(3, max_len))
            end = min(t + length, T)
            seg[r, t:end] = s
            boot[r, end - 1] = rng.randn()
            s += 1
            t = end + (int(rng.randint(0, 3)) if gap else 0)
    rew = (rng.randn(R, T) * (seg > 0)).astype(np.float32)
    val = (rng.randn(R, T) * (seg > 0)).astype(np.float32)
    return rew, val, seg, boot


def _jax(args):
    return tuple(jnp.asarray(x) for x in args)


def _torch(args):
    return tuple(torch.from_numpy(x) for x in args)


def _assert_close(got, want, rel=1e-5):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.max(np.abs(w))))
    np.testing.assert_allclose(g, w, atol=rel * scale, rtol=0)


@pytest.mark.parametrize("fn", ["packed_gae", "gae_rows"])
@pytest.mark.parametrize("R,T", [(8, 256), (3, 100)])
@pytest.mark.parametrize("gamma,lam", [(1.0, 1.0), (0.97, 0.95), (0.9, 0.0)])
def test_gae_matches_the_reference_oracle(fn, R, T, gamma, lam):
    args = _pack(R, T, seed=1)
    adv0, ret0 = jax_gae.gae_rows(*_jax(args), gamma=gamma, lam=lam)
    adv1, ret1 = getattr(torch_gae, fn)(*_torch(args), gamma=gamma, lam=lam)
    _assert_close(adv1.numpy(), adv0)
    _assert_close(ret1.numpy(), ret0)
    assert np.all(adv1.numpy()[args[2] == 0] == 0.0)
    assert np.all(ret1.numpy()[args[2] == 0] == 0.0)


def test_all_padding_rows_are_exact_zeros():
    rew, val, seg, boot = _pack(8, 128, seed=2)
    seg = seg.copy()
    seg[1] = 0
    seg[3] = 0
    args = (rew, val, seg, boot)
    adv0, ret0 = jax_gae.gae_rows(*_jax(args), gamma=0.97, lam=0.95)
    adv1, ret1 = torch_gae.packed_gae(*_torch(args), gamma=0.97, lam=0.95)
    assert torch.all(adv1[1] == 0) and torch.all(ret1[3] == 0)
    _assert_close(adv1.numpy(), adv0)
    _assert_close(ret1.numpy(), ret0)


def test_truncation_bootstrap_stays_inside_its_segment():
    T = 128
    seg = np.zeros((2, T), np.int32)
    seg[:, 2:6] = 1
    seg[:, 6:9] = 2  # abuts segment 1
    rew = np.zeros((2, T), np.float32)
    rew[:, 2:9] = 1.0
    val = np.zeros((2, T), np.float32)
    boot = np.zeros((2, T), np.float32)
    boot[:, 5] = 10.0  # segment 1 truncated, V(s_T+1) = 10
    gamma, lam = 0.9, 0.8
    adv, _ = torch_gae.packed_gae(*_torch((rew, val, seg, boot)), gamma=gamma, lam=lam)
    np.testing.assert_allclose(adv[0, 5].item(), 1.0 + gamma * 10.0, rtol=1e-6)
    np.testing.assert_allclose(adv[0, 8].item(), 1.0, rtol=1e-6)
    adv0, _ = jax_gae.gae_rows(*_jax((rew, val, seg, boot)), gamma=gamma, lam=lam)
    _assert_close(adv.numpy(), adv0)


def test_lam_one_is_the_discounted_delta_sum():
    gamma = 0.95
    rew, val, seg, boot = _pack(4, 128, seed=4, max_len=20)
    adv, _ = torch_gae.packed_gae(*_torch((rew, val, seg, boot)), gamma=gamma, lam=1.0)
    adv = adv.numpy().astype(np.float64)
    for r in range(seg.shape[0]):
        for s in np.unique(seg[r])[1:] if seg[r].any() else []:
            idx = np.where(seg[r] == s)[0]
            v_n = np.append(val[r, idx[1:]], boot[r, idx[-1]])
            delta = rew[r, idx] + gamma * v_n - val[r, idx]
            want, acc = np.zeros(len(idx)), 0.0
            for j in range(len(idx) - 1, -1, -1):
                acc = delta[j] + gamma * acc
                want[j] = acc
            scale = max(1.0, np.max(np.abs(want)))
            np.testing.assert_allclose(adv[r, idx], want, atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("gamma,lam", [(1.0, 1.0), (0.97, 0.95)])
def test_plain_scan_matches_the_pallas_scan_kernel(gamma, lam):
    """The same affine elements through the reference's Pallas kernel
    (interpret mode; it needs 8 | R and 128 | T) and the port's plain
    scan; the elements themselves agree exactly with the reference's."""
    args = _pack(8, 256, seed=6)
    a0, b0, valid0, _ = jax_gae._gae_affine_elems(*_jax(args), gamma, lam)
    a1, b1, valid1, _ = torch_gae._gae_affine_elems(*_torch(args), gamma, lam)
    np.testing.assert_array_equal(a1.numpy(), np.asarray(a0))
    np.testing.assert_allclose(b1.numpy(), np.asarray(b0), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(valid1.numpy(), np.asarray(valid0))
    want = pallas_scan(a0, b0, interpret=True)
    got = torch_gae.segment_scan_reverse(a1, b1)
    _assert_close(got.numpy(), want)


def test_scan_takes_any_shape_and_refuses_wrong_cuda_inputs():
    a = torch.rand(3, 37)
    b = torch.randn(3, 37)
    x = torch_gae.segment_scan_reverse(a, b)
    want = np.zeros((3, 38), np.float64)
    for t in range(36, -1, -1):
        want[:, t] = a[:, t].numpy() * want[:, t + 1] + b[:, t].numpy()
    np.testing.assert_allclose(x.numpy(), want[:, :37], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="CUDA tensor"):
        torch_gae._scan_kernel(a, b)
