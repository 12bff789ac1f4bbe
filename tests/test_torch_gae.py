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


# ----------------------------------------------------------------------
# The CUDA kernel's plan and association order, checked on the CPU
# ----------------------------------------------------------------------

_PLAN_CASES = [(1, 1, 132), (1, 7, 132), (3, 5001, 132), (300, 129, 132), (1, 32768, 132),
               (2, 32768, 132), (16, 4096, 132), (4096, 4096, 132), (131, 5121, 132),
               (132, 5121, 132), (16, 4097, 132), (8, 8192, 1), (5, 1023, 2)]


def _tile_ranges(R, T, plan):
    return [(r, k, k * plan.tile, min((k + 1) * plan.tile, T))
            for r in range(R) for k in range(plan.tiles)]


@pytest.mark.parametrize("R,T,n_sm", _PLAN_CASES)
def test_gae_plan_tiles_cover_each_row_once(R, T, n_sm):
    plan = torch_gae.gae_plan(R, T, n_sm)
    assert plan.tile % torch_gae.CHUNK == 0 and plan.ctas == R * plan.tiles
    # a split row has tiles of one chunk (the kernel holds a tile in registers)
    assert plan.tiles == 1 or plan.tile == torch_gae.CHUNK
    covered = np.zeros((R, T), np.int32)
    for r, _, lo, hi in _tile_ranges(R, T, plan):
        assert lo < hi, "empty tile"
        covered[r, lo:hi] += 1
    assert np.all(covered == 1)


@pytest.mark.parametrize("R,T,n_sm", _PLAN_CASES)
def test_gae_tickets_wait_only_on_earlier_tickets(R, T, n_sm):
    """Each ticket maps to one (row, tile); every tile right of a CTA's own
    in its row (the aggregates it waits on) went to an earlier ticket."""
    plan = torch_gae.gae_plan(R, T, n_sm)
    if plan.tiles == 1:
        return
    ticket_of = {}
    for t in range(plan.ctas):
        ticket_of[torch_gae.ticket_tile(t, plan.tiles)] = t
    assert set(ticket_of) == {(r, k) for r in range(R) for k in range(plan.tiles)}
    for (r, k), t in ticket_of.items():
        assert all(ticket_of[(r, j)] < t for j in range(k + 1, plan.tiles))


def test_gae_plan_reads_shapes_and_sm_count_only():
    assert torch_gae.gae_plan(16, 4096, 132) == torch_gae.gae_plan(16, 4096, 132)
    # few long rows split; short rows and rows that give every SM a CTA do not
    assert torch_gae.gae_plan(1, 32768, 132) == (1024, 32, 32)
    assert torch_gae.gae_plan(2, 32768, 132) == (1024, 32, 64)
    assert torch_gae.gae_plan(16, 4096, 132) == (4096, 1, 16)
    assert torch_gae.gae_plan(16, 4097, 132) == (1024, 5, 80)
    assert torch_gae.gae_plan(4096, 4096, 132) == (4096, 1, 4096)
    assert torch_gae.gae_plan(131, 16384, 132).tiles == 16
    assert torch_gae.gae_plan(132, 16384, 132).tiles == 1
    assert torch_gae.gae_plan(131, 16384, 114).tiles == 1
    assert torch_gae.gae_plan(3, 5001, 132) == (1024, 5, 15)
    assert torch_gae.gae_plan(1, 1, 132) == (1024, 1, 1)


def test_plan_args_keep_scratch_and_a_nonzero_epoch(monkeypatch):
    """The C entries' trailing arguments, on CPU scratch: the plan, the
    aggregates, flags and ticket (views of one zeroed buffer, ticket
    first), an epoch that moves every launch and is never 0 (the flags'
    initial value), and scratch kept per device and stream, grown when a
    launch needs more tiles."""
    import types

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch_gae, "_scratch", {})
    dev = torch.device("cpu")
    tile, tiles, agg, flags, ticket, e1 = torch_gae._plan_args(dev, 2, 32768)
    assert (tile, tiles) == (1024, 32) and agg.shape == (64, 2) and flags.shape == (64,)
    assert ticket.shape == (1,) and ticket.data_ptr() + 4 == flags.data_ptr()
    assert not flags.any() and not ticket.any() and e1 != 0
    *_, e2 = torch_gae._plan_args(dev, 1, 7)  # one tile a row: scratch unused, kept
    assert e2 == e1 + 1 and len(torch_gae._scratch) == 1
    _, _, agg3, *_, e3 = torch_gae._plan_args(dev, 3, 32768)  # more tiles: grown
    assert agg3.shape == (96, 2) and e3 == e2 + 1
    torch_gae._scratch[(None, 7)].epoch = 0xFFFFFFFF
    assert torch_gae._plan_args(dev, 1, 7)[-1] == 1  # wraps past 0


def test_plan_args_refuse_cuda_graph_capture(monkeypatch):
    """A captured launch would replay one epoch and could accept a flag of
    its previous replay, so the wrappers refuse capture before they touch
    the scratch or its epoch."""
    import types

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch_gae, "_scratch", {})
    dev = torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    e1 = torch_gae._plan_args(dev, 2, 32768)[-1]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    for R, T in ((2, 32768), (1, 7)):
        with pytest.raises(RuntimeError, match="CUDA graph"):
            torch_gae._plan_args(dev, R, T)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert torch_gae._plan_args(dev, 2, 32768)[-1] == e1 + 1


def test_packed_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    from areal_tpu_torch import kernels

    monkeypatch.setattr(kernels, "launch", lambda *a: pytest.fail("reached the launcher"))
    rew, val, seg, boot = _torch(_pack(2, 16, seed=3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        torch_gae._packed_gae_kernel(rew, val, seg, boot, 1.0, 1.0)


# The kernel's association order, emulated with float32 torch ops: per
# thread (E consecutive elements), per warp (a shuffle tree from the
# right), per chunk (the warps through shared memory, composed from the
# right), then across the tiles of a split row (aggregates in groups of 32
# aligned at the row's end, a shuffle tree in each) or along the chunks of
# a whole-row tile (the carry). Elements past T are a = b = 0, as the
# kernel loads them.
_NT, _E = 256, 4


def _warp_scan_right(A, B):
    lane = torch.arange(32)
    s = 1
    while s < 32:
        A2 = torch.cat([A[..., s:], torch.ones_like(A[..., :s])], -1)
        B2 = torch.cat([B[..., s:], torch.zeros_like(B[..., :s])], -1)
        keep = lane + s >= 32
        A, B = torch.where(keep, A, A * A2), torch.where(keep, B, A * B2 + B)
        s *= 2
    return A, B


def _chunk_maps(a, b):
    """Per chunk [n, CHUNK]: the thread maps' exclusive parts and the
    chunk aggregate, as the kernel holds them before it knows its carry."""
    n = a.shape[0]
    a4 = a.reshape(n, _NT // 32, 32, _E)
    b4 = b.reshape(n, _NT // 32, 32, _E)
    A = torch.ones_like(a4[..., 0])
    B = torch.zeros_like(A)
    for i in range(_E - 1, -1, -1):
        A, B = a4[..., i] * A, a4[..., i] * B + b4[..., i]
    A, B = _warp_scan_right(A, B)
    exA = torch.cat([A[..., 1:], torch.ones_like(A[..., :1])], -1)
    exB = torch.cat([B[..., 1:], torch.zeros_like(B[..., :1])], -1)
    wA, wB = A[..., 0], B[..., 0]  # warp aggregates [n, NW]
    nw = _NT // 32
    XA, XB = [None] * nw, [None] * nw
    cA, cB = torch.ones_like(wA[:, 0]), torch.zeros_like(wB[:, 0])
    for v in range(nw - 1, -1, -1):
        XA[v], XB[v] = cA, cB  # the warps right of warp v
        cA, cB = wA[:, v] * cA, wA[:, v] * cB + wB[:, v]
    return (exA, exB, torch.stack(XA, 1), torch.stack(XB, 1)), (cA, cB)


def _chunk_apply(a, b, parts, carry):
    exA, exB, XA, XB = parts
    n = a.shape[0]
    a4 = a.reshape(n, _NT // 32, 32, _E)
    b4 = b.reshape(n, _NT // 32, 32, _E)
    xw = XA * carry[:, None] + XB
    x = exA * xw[..., None] + exB
    out = torch.empty_like(a4)
    for i in range(_E - 1, -1, -1):
        x = a4[..., i] * x + b4[..., i]
        out[..., i] = x
    return out.reshape(n, -1)


def _emulated_scan(a, b, n_sm):
    R, T = a.shape
    plan = torch_gae.gae_plan(R, T, n_sm)
    C = torch_gae.CHUNK
    width = plan.tile * plan.tiles
    a = torch.nn.functional.pad(a.float(), (0, width - T))
    b = torch.nn.functional.pad(b.float(), (0, width - T))
    x = torch.empty_like(a)
    if plan.tiles == 1:
        carry = torch.zeros(R)
        for c in range(width // C - 1, -1, -1):
            sl = slice(c * C, (c + 1) * C)
            parts, (gA, gB) = _chunk_maps(a[:, sl], b[:, sl])
            x[:, sl] = _chunk_apply(a[:, sl], b[:, sl], parts, carry)
            carry = gA * carry + gB
        return x[:, :T]
    nt = plan.tiles
    at, bt = a.reshape(R * nt, C), b.reshape(R * nt, C)
    parts, (gA, gB) = _chunk_maps(at, bt)
    gA, gB = gA.reshape(R, nt), gB.reshape(R, nt)
    carry = torch.zeros(R, nt)
    for tile in range(nt - 1):
        xr = torch.zeros(R)
        for hi in range(nt, tile + 1, -32):
            k = torch.arange(hi - 32, hi)
            live = k > tile
            kk = k.clamp(min=0)
            mA = torch.where(live, gA[:, kk], 1.0)
            mB = torch.where(live, gB[:, kk], 0.0)
            mA, mB = _warp_scan_right(mA, mB)
            xr = mA[:, 0] * xr + mB[:, 0]
        carry[:, tile] = xr
    return _chunk_apply(at, bt, parts, carry.reshape(-1)).reshape(R, width)[:, :T]


@pytest.mark.parametrize("R,T,n_sm", [(8, 5120, 132), (8, 5120, 8), (8, 1024, 132)])
@pytest.mark.parametrize("gamma,lam", [(1.0, 1.0), (0.97, 0.95)])
def test_emulated_kernel_order_matches_the_pallas_scan(R, T, n_sm, gamma, lam):
    """Split rows (n_sm 132: 5 tiles a row), a whole-row tile walked in
    chunks (n_sm 8) and one chunk, against the Pallas kernel (interpret
    mode, 8 | R and 128 | T)."""
    args = _pack(R, T, seed=11, max_len=600)
    a0, b0, _, _ = jax_gae._gae_affine_elems(*_jax(args), gamma, lam)
    want = pallas_scan(a0, b0, interpret=True)
    got = _emulated_scan(torch.from_numpy(np.array(a0)), torch.from_numpy(np.array(b0)),
                         n_sm)
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("R,T,n_sm,max_len", [
    (2, 40961, 132, 30000),  # 41 tiles: two look-right groups, odd T
    (3, 5001, 132, 3000), (3, 5001, 1, 3000), (1, 7, 132, 40), (300, 129, 132, 40)])
@pytest.mark.parametrize("gamma,lam", [(1.0, 1.0), (0.97, 0.95)])
def test_emulated_kernel_order_matches_gae_rows(R, T, n_sm, max_len, gamma, lam):
    """The fused entry's result through the emulated order (affine
    elements, scan, masking) against the reference's serial oracle."""
    args = _pack(R, T, seed=12, max_len=max_len)
    adv0, ret0 = jax_gae.gae_rows(*_jax(args), gamma=gamma, lam=lam)
    a, b, valid, v32 = torch_gae._gae_affine_elems(*_torch(args), gamma, lam)
    adv, ret = torch_gae._finish_gae(_emulated_scan(a, b, n_sm), v32, valid)
    _assert_close(adv.numpy(), adv0)
    _assert_close(ret.numpy(), ret0)
    assert np.all(adv.numpy()[args[2] == 0] == 0.0)


def test_packed_gae_on_cpu_is_its_plain_version():
    args = _torch(_pack(4, 300, seed=13))
    got = torch_gae.packed_gae(*args, gamma=0.97, lam=0.95)
    want = torch_gae.reference_packed_gae(*args, gamma=0.97, lam=0.95)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
