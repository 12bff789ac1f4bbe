"""Port parity: the paged KV cache and per-row sampling of areal_tpu_torch
against areal_tpu.

- quantize_kv is bit-equal to the reference's (round half to even);
- the plain paged decode attention (what a CPU tensor runs; the CUDA
  kernels are held against it on the card by chip_smoke.py) matches the
  reference's XLA gather path for float pools and the reference's int8
  Pallas kernel in interpret mode for int8 pools, at the shapes of
  tests/engine/test_kv_int8.py (rtol/atol 2e-5, float32);
- the decode mode's split plan covers every page of a page row exactly
  once, and a plain model of its split arithmetic (partials, then a
  fixed-order combine) matches the same references, empty splits and
  trash rows included;
- rows of one prompt sharing one page row (the chunk mode) match the
  reference row by row, at chunk sizes off the kernel's 64-row tile,
  unaligned starts and 16-token pages;
- PageAllocator and scatter_prefill behave as the reference's;
- warp_logits gives the reference's warped logits and base_logp for all
  three tiers (rtol 1e-5). Random bits differ between the frameworks, so
  sampled tokens are not compared; greedy rows are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.engine import paged as jp
from areal_tpu_torch.engine import paged as tp
from areal_tpu_torch.ops import sampling as ts

TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def test_quantize_kv_bit_equal():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32) * 4.0
    x[0, 0] = 0.0  # all-zero row: scale floor
    x[1, 1, :] = np.linspace(-1, 1, 16)  # exact halves after scaling
    w_t, s_t = tp.quantize_kv(_t(x))
    w_j, s_j = jp.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(
        tp.dequantize_kv(w_t, s_t, torch.float32).numpy(),
        np.asarray(jp.dequantize_kv(w_j, s_j, jnp.float32)))


def _pools(rng, Hkv, N, pg, hd, int8):
    kd = rng.standard_normal((Hkv, N, pg, hd)).astype(np.float32)
    vd = rng.standard_normal((Hkv, N, pg, hd)).astype(np.float32)
    if not int8:
        return (kd, vd), (_t(kd), _t(vd))
    kq, ks = jp.quantize_kv(jnp.asarray(kd))
    vq, vs = jp.quantize_kv(jnp.asarray(vd))
    jpools = ((kq, ks[..., 0]), (vq, vs[..., 0]))
    tpools = tuple((_t(d), _t(s)) for d, s in jpools)
    return jpools, tpools


@pytest.mark.parametrize("lengths", [[3, 8, 5], [1, 16, 9]])
def test_plain_paged_attention_float_pool(lengths):
    rng = np.random.default_rng(1)
    Hkv, N, pg, hd, B, Hq, P = 2, 6, 8, 16, 3, 4, 2
    (kd, vd), (kt, vt) = _pools(rng, Hkv, N, pg, hd, int8=False)
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    pi = rng.integers(1, N, size=(B, P)).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    want = jp._paged_attention_xla(jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd),
                                   jnp.asarray(lens), jnp.asarray(pi), hd**-0.5)
    got = tp.paged_decode_attention(_t(q), kt, vt, _t(lens), _t(pi))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,lengths", [
    ((2, 6, 8, 16, 3, 4, 2), [3, 8, 5]),
    ((2, 6, 8, 16, 3, 4, 2), [1, 16, 9]),
    ((1, 3, 128, 128, 2, 2, 2), [150, 77]),  # the engine's pg = hd = 128
])
def test_plain_paged_attention_int8_pool_matches_pallas_kernel(shape, lengths):
    rng = np.random.default_rng(2)
    Hkv, N, pg, hd, B, Hq, P = shape
    jpools, tpools = _pools(rng, Hkv, N, pg, hd, int8=True)
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    pi = rng.integers(1, N, size=(B, P)).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    want = jp.paged_decode_attention(
        jnp.asarray(q), jpools[0], jpools[1], jnp.asarray(lens), jnp.asarray(pi),
        impl="int8_kernel")  # the Pallas kernel, interpreted off-TPU
    got = tp.paged_decode_attention(_t(q), tpools[0], tpools[1], _t(lens), _t(pi))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_shared_page_row_rows_match_single_rows():
    """Chunked prefill passes one page row expanded over all rows (row
    stride 0); each row equals the same row computed alone."""
    rng = np.random.default_rng(3)
    _, (kt, vt) = _pools(rng, 2, 5, 4, 8, int8=False)
    q = _t(rng.standard_normal((6, 4, 8)).astype(np.float32))
    row = _t(np.asarray([3, 1, 4, 2], np.int32))
    lens = _t(np.arange(9, 15, dtype=np.int32))
    both = tp.paged_decode_attention(q, kt, vt, lens, row[None].expand(6, 4))
    for i in range(6):
        one = tp.paged_decode_attention(q[i:i + 1], kt, vt, lens[i:i + 1], row[None])
        np.testing.assert_allclose(both[i].numpy(), one[0].numpy(), rtol=1e-6)


@pytest.mark.parametrize("B", [1, 16, 1024])
@pytest.mark.parametrize("P", [1, 32, 257])
@pytest.mark.parametrize("n_sm", [1, 132])
def test_split_plan_covers_every_page_once(B, P, n_sm):
    splits, per = tp.split_plan(B, 2, P, n_sm)
    owned = [p for sp in range(splits) for p in range(sp * per, min((sp + 1) * per, P))]
    assert owned == list(range(P))  # in order, each page once
    assert 1 <= splits <= P and (splits - 1) * per < P <= splits * per  # no split empty
    # whole pages cost at most half the plan's four CTAs an SM: at least two
    # CTAs an SM where the pages allow
    assert B * 2 * splits >= min(2 * n_sm, B * 2 * P)


def _split_case(rng, int8, lengths, trash_rows, pg=8, P=8, Hkv=2, Hq=6, hd=16):
    B = len(lengths)
    N = 1 + B * P
    jpools, tpools = _pools(rng, Hkv, N, pg, hd, int8)
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    pi = rng.permutation(np.arange(1, N)).astype(np.int32)[:B * P].reshape(B, P)
    pi[list(trash_rows)] = tp.TRASH_PAGE  # inactive slots read the trash page
    return q, jpools, tpools, np.asarray(lengths, np.int32), pi


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("splits,per", [(1, 8), (3, 3), (8, 1)])
def test_split_model_matches_reference(int8, splits, per):
    """Split counts 1, 3 and 8 over 8 pages of 8 tokens: lengths 1 and 5
    leave every split past the first empty, 64 fills all, and rows 2 and 4
    are trash rows (page row all trash page)."""
    rng = np.random.default_rng(5)
    lengths, trash = [1, 64, 30, 5, 17, 40], (2, 4)
    q, jpools, tpools, lens, pi = _split_case(rng, int8, lengths, trash)
    scale = 16 ** -0.5
    if int8:  # the Pallas kernel, interpreted off-TPU
        want = jp.paged_decode_attention(jnp.asarray(q), jpools[0], jpools[1],
                                         jnp.asarray(lens), jnp.asarray(pi),
                                         impl="int8_kernel")
    else:
        want = jp._paged_attention_xla(jnp.asarray(q), jnp.asarray(jpools[0]),
                                       jnp.asarray(jpools[1]), jnp.asarray(lens),
                                       jnp.asarray(pi), scale)
    got = tp._paged_attention_split(_t(q), tpools[0], tpools[1], _t(lens), _t(pi), scale,
                                    splits, per)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    plain = tp._paged_attention_xla(_t(q), tpools[0], tpools[1], _t(lens), _t(pi), scale)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("C,start,pg", [
    (70, 37, 16),   # off the 64-row tile, start mid-page, a 64-token tile spans 4 pages
    (130, 128, 8),  # two whole tiles and 2 rows, page-aligned start
    (64, 5, 16),    # one whole tile, start mid-page
])
def test_shared_page_row_chunk_matches_reference(C, start, pg):
    """Rows of one prompt at positions start..start+C-1 share one page row
    (row stride 0) with lengths start+i+1: each row equals the reference
    run on that row alone, for float and int8 pools."""
    rng = np.random.default_rng(C + start + pg)
    Hkv, Hq, hd = 2, 6, 16
    P = -(-(start + C) // pg)
    N = P + 3
    q = rng.standard_normal((C, Hq, hd)).astype(np.float32)
    row = rng.permutation(np.arange(1, N)).astype(np.int32)[:P]
    lens = (start + 1 + np.arange(C)).astype(np.int32)
    for int8 in (False, True):
        jpools, tpools = _pools(rng, Hkv, N, pg, hd, int8)
        got = tp.paged_decode_attention(_t(q), tpools[0], tpools[1], _t(lens),
                                        _t(row)[None].expand(C, P))
        pi = np.broadcast_to(row, (C, P)).copy()
        if int8:
            want = jp.paged_decode_attention(jnp.asarray(q), jpools[0], jpools[1],
                                             jnp.asarray(lens), jnp.asarray(pi),
                                             impl="int8_kernel")
        else:
            want = jp._paged_attention_xla(jnp.asarray(q), jnp.asarray(jpools[0]),
                                           jnp.asarray(jpools[1]), jnp.asarray(lens),
                                           jnp.asarray(pi), hd ** -0.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_page_allocator_matches_reference():
    a, b = tp.PageAllocator(9), jp.PageAllocator(9)
    for n in (3, 2, 4, 1):
        assert a.alloc(n) == b.alloc(n)
        assert a.n_free == b.n_free
    a.free([2, 5]), b.free([2, 5])
    assert a.alloc(2) == b.alloc(2) and a.n_free == b.n_free
    assert a.alloc(5) is None and a.n_free == b.n_free  # no state change
    with pytest.raises(ValueError):
        a.free([tp.TRASH_PAGE])
    with pytest.raises(ValueError):
        tp.PageAllocator(1)
    assert tp.pages_needed(0, 8) == 1 and tp.pages_needed(17, 8) == 3


@pytest.mark.parametrize("int8", [False, True])
def test_scatter_prefill_matches_reference(int8):
    rng = np.random.default_rng(4)
    L, n, pad, Hkv, hd, pg, N = 2, 3, 8, 2, 4, 4, 9
    kp = rng.standard_normal((L, n, pad, Hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((L, n, pad, Hkv, hd)).astype(np.float32)
    flat = np.asarray([1, 2, 3, 0, 5, 6], np.int32)
    shape = (L, Hkv, N, pg, hd)
    if int8:
        jk = (jnp.zeros(shape, jnp.int8), jnp.zeros(shape[:-1], jnp.float32))
        tk = (torch.zeros(shape, dtype=torch.int8), torch.zeros(shape[:-1]))
    else:
        jk, tk = jnp.zeros(shape), torch.zeros(shape)
    jv, tv = jax.tree_util.tree_map(jnp.copy, jk), jax.tree_util.tree_map(
        lambda x: x, tuple(t.clone() for t in tk) if int8 else tk.clone())
    jk, jv = jp.scatter_prefill(jk, jv, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(flat))
    tp.scatter_prefill(tk, tv, _t(kp), _t(vp), _t(flat).long())
    for jpool, tpool in ((jk, tk), (jv, tv)):
        for jl, tl in zip(jax.tree_util.tree_leaves(jpool),
                          tpool if int8 else (tpool,)):
            # pages written once are equal; the trash page (0) takes
            # whichever colliding write lands last, so it is skipped.
            np.testing.assert_array_equal(tl.numpy()[:, :, 1:], np.asarray(jl)[:, :, 1:])


def _warp_inputs(tier):
    rng = np.random.default_rng({"temperature": 5, "topk": 6, "sort": 7}[tier])
    B, V = 5, 300
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    temps = np.asarray([1.0, 0.7, 1.3, 0.5, 2.0], np.float32)
    top_ps = np.ones(B, np.float32)
    top_ks = np.full(B, -1, np.int32)
    if tier == "topk":
        top_ks[:] = [3, -1, 10, 128, 1]
    if tier == "sort":
        top_ps[:] = [0.8, 1.0, 0.5, 0.95, 1.0]
        top_ks[:] = [-1, 200, 7, -1, 250]  # k > TOPK_FAST_MAX forces the sort
    forbid = np.asarray([True, False, True, False, False])
    eos = np.zeros(V, bool)
    eos[[5, 17]] = True
    active = np.asarray([True, True, True, True, False])
    return logits, temps, top_ps, top_ks, forbid, eos, active


@pytest.mark.parametrize("tier", ["temperature", "topk", "sort"])
def test_warp_logits_matches_reference(tier):
    args = _warp_inputs(tier)
    assert ts.select_tier(args[2], args[3], args[6], args[0].shape[1]) == tier
    w_j, lp_j = jp.warp_logits(*[jnp.asarray(a) for a in args[:6]],
                               active_rows=jnp.asarray(args[6]))
    w_t, lp_t = ts.warp_logits(*[_t(a) for a in args[:6]], active_rows=_t(args[6]))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-5)


def test_warp_sample_greedy_rows_match_reference():
    logits, temps, top_ps, top_ks, forbid, eos, active = _warp_inputs("sort")
    greedy = np.asarray([True, False, True, True, False])
    tok_j, lp_j = jp.warp_sample(
        *[jnp.asarray(a) for a in (logits,)], jax.random.PRNGKey(0),
        *[jnp.asarray(a) for a in (temps, top_ps, top_ks, greedy, forbid, eos)])
    gen = torch.Generator().manual_seed(0)
    tok_t, lp_t = ts.warp_sample(_t(logits), gen, *[_t(a) for a in (
        temps, top_ps, top_ks, greedy, forbid, eos)])
    np.testing.assert_array_equal(tok_t.numpy()[greedy], np.asarray(tok_j)[greedy])
    np.testing.assert_allclose(lp_t.numpy()[greedy], np.asarray(lp_j)[greedy], rtol=1e-5)
    # forbidden EOS columns are never sampled, and every logprob is <= 0
    assert not eos[tok_t.numpy()[forbid]].any()
    assert (lp_t.numpy() <= 0).all()
