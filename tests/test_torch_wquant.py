"""Port parity of int8 decode weights (ops/wquant.py) against the
reference's, on the CPU.

- ``quantize_weight`` and the decode tree (``maybe_quantize_decode_weights``,
  the engine's path; tied and untied embeddings) give codes and scales
  bit-equal to the reference's from the same float32 numpy leaves, as the
  reference's engine computes them: under jit, where XLA multiplies by the
  float32 reciprocal of 127 (eager jnp divides, up to an ulp apart);
- ``qmat``'s plain branch (the CPU path; the card runs the W8A16 kernel,
  held against this branch by chip_smoke.py) within rtol 1e-5 of the
  reference's, float32 on both sides;
- ``layer_params`` slices (int8, scale) leaves per layer, and the decode
  step takes the quantized head;
- a bad dtype raises ``ValueError``, the kernel's wrapper refuses what
  the kernel does not take before nvcc is touched, and a badly built
  ``PackedW8`` is refused where it is built;
- the kernel's packed layout (``pack_codes``) gives the codes back bit
  for bit through ``unpack_codes`` at the decode shapes of
  R1-Distill-Qwen-1.5B, gpt2's and gemma's widths, ragged K and N and a
  stacked leaf sliced per layer; packing a whole decode tree and
  unpacking it gives the reference's tree bit for bit, and the engine's
  CPU tree is never packed;
- the kernel's plan covers every (row block, column tile, K chunk) once,
  in the same order on every call, with no split empty and its shared
  memory within the CTA's, at the decode shapes and M from 1 to 300;
- the grouped projections (``qmats`` over ``wq+wk+wv`` and
  ``w_gate+w_up``) equal the reference's ``qmat`` projection by
  projection, and a decode step on a packed tree equals one on the
  unpacked tree bit for bit (the packed weights' plain version on CPU
  tensors);
- the engine's int8 copy follows the live weights: rebuilt on
  ``update_params`` and on ``cutover_params`` (scales x1.5 after a x1.5
  swap), and prefill stays unquantized (the first token equals the
  bf16 engine's).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.models.config import TransformerConfig as JaxConfig
from areal_tpu.models.transformer import init_params as jax_init
from areal_tpu.ops import wquant as ref_wq
from areal_tpu_torch.convert import params_from_numpy
from areal_tpu_torch.engine.paged import paged_decode_hidden, paged_decode_step
from areal_tpu_torch.engine.serving import GenRequest, ServingEngine
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.transformer import layer_params
from areal_tpu_torch.ops import wquant
from tests.test_torch_serving import TINY


def _np(x):
    return np.asarray(x)


def _tree(tied: bool, seed: int = 0):
    cfg = dict(TINY, tied_embeddings=tied)
    return cfg, jax.tree_util.tree_map(
        np.asarray, jax_init(JaxConfig(**cfg), jax.random.PRNGKey(seed)))


def _assert_trees_equal(port, ref):
    assert set(port) == set(ref)
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_trees_equal(port[k], ref[k])
        elif isinstance(ref[k], tuple):
            assert isinstance(port[k], tuple) and len(port[k]) == 2, k
            np.testing.assert_array_equal(port[k][0].numpy(), _np(ref[k][0]))
            assert port[k][0].dtype == torch.int8
            np.testing.assert_array_equal(port[k][1].numpy(), _np(ref[k][1]))
        else:
            np.testing.assert_array_equal(port[k].numpy(), _np(ref[k]))


@pytest.mark.parametrize("shape", [(16, 24), (3, 32, 64), (2, 64, 256)])
def test_quantize_weight_is_bit_equal(shape):
    rng = np.random.default_rng(len(shape) * 7 + shape[-1])
    w = rng.standard_normal(shape, dtype=np.float32) * 0.3
    w[..., 0, 1] = 0.0  # an all-but-zero column keeps its floor
    w[..., :, 2] = 0.0
    q_ref, s_ref = jax.jit(ref_wq.quantize_weight)(jnp.asarray(w))
    q, s = wquant.quantize_weight(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), _np(q_ref))
    np.testing.assert_array_equal(s.numpy(), _np(s_ref))
    assert int(q.abs().max()) == 127


@pytest.mark.parametrize("tied", [False, True])
def test_decode_tree_is_bit_equal(tied):
    cfg, tree = _tree(tied)
    ref = ref_wq.maybe_quantize_decode_weights(
        jax.tree_util.tree_map(jnp.asarray, tree), tied, "int8")
    port = wquant.maybe_quantize_decode_weights(params_from_numpy(tree, device="cpu"),
                                                tied, "int8")
    _assert_trees_equal(port, ref)
    assert isinstance(port["layers"]["mlp"]["w_down"], tuple)
    assert not isinstance(port["layers"]["ln1"]["weight"], tuple)
    assert port["head_q"][0].shape == (TINY["hidden_dim"], TINY["vocab_size"])
    assert port["head_q"][0].is_contiguous()


def test_model_dtype_gives_no_tree():
    _, tree = _tree(False)
    params = params_from_numpy(tree, device="cpu")
    for dt in (None, "model"):
        assert wquant.maybe_quantize_decode_weights(params, False, dt) is None


@pytest.mark.parametrize("bad", ["fp8", "int4", "bf16"])
def test_a_bad_dtype_raises(bad):
    _, tree = _tree(False)
    params = params_from_numpy(tree, device="cpu")
    with pytest.raises(ValueError, match="decode_weight_dtype"):
        wquant.maybe_quantize_decode_weights(params, False, bad)
    with pytest.raises(ValueError, match="decode_weight_dtype"):
        ServingEngine(TransformerConfig(**TINY), params, decode_weight_dtype=bad, device="cpu")


@pytest.mark.parametrize("lead", [(), (5,), (2, 3)])
def test_qmat_plain_branch_matches_reference(lead):
    rng = np.random.default_rng(11)
    w = rng.standard_normal((48, 40), dtype=np.float32)
    h = rng.standard_normal(lead + (48,), dtype=np.float32)
    ref = _np(ref_wq.qmat(jnp.asarray(h), ref_wq.quantize_weight(jnp.asarray(w)), jnp.float32))
    got = wquant.qmat(torch.from_numpy(h), wquant.quantize_weight(torch.from_numpy(w)),
                      torch.float32)
    assert got.shape == lead + (40,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    plain = wquant.qmat(torch.from_numpy(h), torch.from_numpy(w), torch.float32)
    np.testing.assert_allclose(plain.numpy(), _np(ref_wq.qmat(jnp.asarray(h), jnp.asarray(w),
                                                              jnp.float32)),
                               rtol=1e-5, atol=1e-6)


def test_layer_params_slices_tuple_leaves():
    _, tree = _tree(False)
    q = wquant.quantize_decode_weights(params_from_numpy(tree, device="cpu"), False)
    for i in range(TINY["n_layers"]):
        lp = layer_params(q["layers"], i)
        wq_i, s_i = lp["attn"]["wq"]
        full_q, full_s = q["layers"]["attn"]["wq"]
        assert wq_i.shape == full_q.shape[1:] and s_i.shape == full_s.shape[1:]
        assert torch.equal(wq_i, full_q[i]) and torch.equal(s_i, full_s[i])
        assert wq_i.data_ptr() == full_q[i].data_ptr()  # a view, never a copy
        assert torch.equal(lp["ln1"]["weight"], q["layers"]["ln1"]["weight"][i])


def test_decode_step_takes_the_quantized_head():
    """A tree with head_q runs it: the decode step's logits are qmat of the
    final hidden state with the (int8, scale) head, not the float head's."""
    cfg = TransformerConfig(**TINY)
    _, tree = _tree(False)
    params = params_from_numpy(tree, device="cpu")
    q = wquant.quantize_decode_weights(params, False)
    B, pg = 3, 8
    shape = (cfg.n_layers, cfg.n_kv_heads, 8, pg, cfg.head_dim)
    pages = torch.arange(1, 1 + B, dtype=torch.int32)[:, None]
    lengths = torch.tensor([0, 3, 5], dtype=torch.int32)
    tokens = torch.tensor([4, 9, 17], dtype=torch.int32)
    active = torch.ones(B, dtype=torch.bool)

    def pools():
        return torch.zeros(shape), torch.zeros(shape)

    got = paged_decode_step(q, cfg, tokens, *pools(), pages, lengths, active)
    hidden = paged_decode_hidden(q, cfg, tokens, *pools(), pages, lengths, active)
    assert torch.equal(got, wquant.qmat(hidden, q["head_q"], torch.float32).float())
    float_head = hidden @ params["head"]["weight"]
    assert not torch.equal(got, float_head)
    np.testing.assert_allclose(got.numpy(), float_head.numpy(), atol=0.05)


def test_the_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    h = torch.zeros((4, 64), dtype=torch.bfloat16)
    wq = torch.zeros((64, 32), dtype=torch.int8)
    s = torch.ones((32,), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        wquant.w8a16_matmul(h, wquant.pack_weights([(wq, s)]))
    with pytest.raises(ValueError, match="PackedW8"):
        wquant.w8a16_matmul(h, (wq, s))
    # A CPU tensor takes the plain version through qmat, never the wrapper.
    out = wquant.qmat(h, (wq, s), torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (4, 32)
    assert torch.equal(wquant.qmat(h, wquant.pack_weights([(wq, s)]), torch.bfloat16), out)


def _bad_packs():
    q = torch.zeros((100, 72), dtype=torch.int8)
    s = torch.ones((72,), dtype=torch.float32)
    pw = wquant.pack_weights([(q, s)])
    codes = pw.codes
    return {
        "codes float": (codes.float(), s, 100, (72,)),
        "codes short": (codes[:, :1].contiguous(), s, 100, (72,)),
        "K mismatch": (codes, s, 200, (72,)),
        "parts mismatch": (codes, s, 100, (200,)),
        "scale bf16": (codes, s.to(torch.bfloat16), 100, (72,)),
        "scale short": (codes, s[:40], 100, (72,)),
        "codes strided": (codes.transpose(0, 1), s, 100, (72,)),
        "codes misaligned": (torch.zeros(codes.numel() + 16, dtype=torch.int8)
                             [1:1 + codes.numel()].view(codes.shape), s, 100, (72,)),
    }


@pytest.mark.parametrize("case", list(_bad_packs()))
def test_a_badly_built_packed_weight_is_refused(case):
    """PackedW8 checks its tensors where it is built (the wrapper, run per
    layer, does not), so a bad one raises instead of reaching the kernel;
    a layer's view of a good one is not checked again and stays valid."""
    with pytest.raises(ValueError, match="PackedW8"):
        wquant.PackedW8(*_bad_packs()[case])


# The decode-path shapes of R1-Distill-Qwen-1.5B, (K, N): wq/wo, wk/wv,
# w_gate/w_up, w_down, the head.
DECODE_SHAPES = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536), (1536, 151936)]
# gpt2's w_in and its tied head (50257 columns), gemma-2b's MLP width.
FAMILY_SHAPES = [(768, 3072), (768, 50257), (2048, 16384)]
RAGGED_SHAPES = [(100, 40), (16, 8)]


@pytest.mark.parametrize("K,N", DECODE_SHAPES + FAMILY_SHAPES + RAGGED_SHAPES)
def test_pack_then_unpack_gives_the_codes_back(K, N):
    g = torch.Generator().manual_seed(K * 7 + N)
    q = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    packed = wquant.pack_codes(q)
    T, C = -(-N // wquant.TN), -(-K // wquant.CK)
    assert packed.shape == (T, C, wquant.CHUNK) and packed.dtype == torch.int8
    assert packed.is_contiguous()
    assert torch.equal(wquant.unpack_codes(packed, K, N), q)
    # The padding is zeros: the kernel multiplies it.
    assert int((packed != 0).sum()) == int((q != 0).sum())


def test_the_chunk_order_is_the_fragment_order():
    """Byte p of a chunk is what consumer thread p % 2048 // 16 holds for
    its load p // 2048: channel 16 w + g (+ 8), depth 16 kk + 2 t (+ 1,
    + 8), four codes a 32-bit register, the low-index code first."""
    src, dst = wquant._chunk_order()
    assert sorted(src.tolist()) == list(range(wquant.CHUNK))
    assert torch.equal(src[dst], torch.arange(wquant.CHUNK))
    # Thread 37 (warp 1, lane 5: g = 1, t = 1), its first load, bytes 0-7:
    # k16 step 0, rows g and g + 8 of warp 1, depths 2 and 3, then 10 and 11.
    first = [(int(x) // wquant.CK, int(x) % wquant.CK) for x in src[37 * 16:37 * 16 + 8]]
    assert first == [(17, 2), (17, 3), (25, 2), (25, 3), (17, 10), (17, 11), (25, 10), (25, 11)]


def test_a_stacked_leaf_packs_per_layer():
    g = torch.Generator().manual_seed(3)
    q = torch.randint(-127, 128, (3, 100, 72), generator=g, dtype=torch.int8)
    s = torch.rand((3, 72), generator=g)
    pw = wquant.pack_weights([(q, s)])
    assert pw.codes.shape == (3, 2, 2, wquant.CHUNK) and pw.N == 72 and pw.K == 100
    for i in range(3):
        layer = pw[i]
        assert layer.codes.data_ptr() == pw.codes[i].data_ptr()  # a view, never a copy
        assert torch.equal(wquant.unpack_codes(layer.codes, 100, 72), q[i])
        assert torch.equal(layer.scale, s[i])
    (back_q, back_s), = wquant.unpack_weights(pw)
    assert torch.equal(back_q, q) and torch.equal(back_s, s)


def _cta_work(plan, K, N):
    """(cta, row block, split, column tiles, K chunks) of every CTA of a
    launch, as w8a16_matmul.cu's kernel derives them from blockIdx.x: a CTA
    walks every groups-th tile from its group's index, and for each tile
    its split's chunks, in order. (The kernel's own mapping is held by the
    chip's parity runs; this copy checks that the plan leaves it nothing
    to miss.)"""
    T, C = -(-N // wquant.TN), -(-K // wquant.CK)
    for b in range(plan.ctas):
        grp, split = b % plan.groups, (b // plan.groups) % plan.splits
        rb = b // (plan.groups * plan.splits)
        tiles = list(range(grp, T, plan.groups))
        chunks = list(range(split * C // plan.splits, (split + 1) * C // plan.splits))
        yield b, rb, split, tiles, chunks


@pytest.mark.parametrize("M", [1, 16, 37, 80, 256, 300])
@pytest.mark.parametrize("K,N", DECODE_SHAPES + [(1536, 2048), (1536, 17920), (768, 50257)]
                         + RAGGED_SHAPES)
def test_the_split_plan_covers_k(M, K, N):
    """The kernel's plan: every (row block, column tile, K chunk) once,
    in the same order on every call; no split empty; the row blocks cover
    M with none empty; the A slice, ring and tile buffers fit a CTA's
    shared memory; about one CTA an SM."""
    n_sm = 132
    plan = wquant.w8a16_plan(M, K, N, n_sm)
    T, C = -(-N // wquant.TN), -(-K // wquant.CK)
    assert plan.mb in wquant.MB_WIDTHS
    assert plan.mb * plan.n_rb >= M > plan.mb * (plan.n_rb - 1)
    assert 1 <= plan.splits <= C and 1 <= plan.groups <= T
    assert plan.ctas <= max(n_sm, plan.n_rb * plan.splits)
    assert plan.smem <= wquant.SMEM_CTA
    # Split s takes chunks s C // splits .. (s + 1) C // splits: none empty.
    assert all((s + 1) * C // plan.splits > s * C // plan.splits for s in range(plan.splits))
    work = list(_cta_work(plan, K, N))
    assert [w[0] for w in work] == list(range(plan.ctas))
    seen = {}
    for b, rb, split, tiles, chunks in work:
        assert chunks, f"CTA {b}: split {split} is empty"
        assert tiles == sorted(tiles) and chunks == sorted(chunks)
        assert wquant.w8a16_smem(plan.mb, len(chunks), plan.stages, plan.cps) <= plan.smem
        for t in tiles:
            for c in chunks:
                assert (rb, t, c) not in seen
                seen[(rb, t, c)] = b
    assert len(seen) == plan.n_rb * T * C
    assert wquant.w8a16_plan(M, K, N, n_sm) == plan
    assert list(_cta_work(plan, K, N)) == work


def _packed_tree(tied: bool, seed: int = 0):
    cfg, tree = _tree(tied, seed)
    params = params_from_numpy(tree, device="cpu")
    return cfg, tree, params, wquant.quantize_decode_weights(params, tied, pack=True)


@pytest.mark.parametrize("tied", [False, True])
def test_a_packed_tree_unpacks_to_the_reference_tree(tied):
    _, tree, params, packed = _packed_tree(tied)
    attn, mlp = packed["layers"]["attn"], packed["layers"]["mlp"]
    assert set(attn) >= {"wq+wk+wv", "wo"} and not {"wq", "wk", "wv"} & set(attn)
    assert set(mlp) >= {"w_gate+w_up", "w_down"}
    assert attn["wq+wk+wv"].parts == (TINY["n_q_heads"] * TINY["head_dim"],
                                      TINY["n_kv_heads"] * TINY["head_dim"],
                                      TINY["n_kv_heads"] * TINY["head_dim"])
    assert isinstance(packed["head_q"], wquant.PackedW8)
    ref = ref_wq.maybe_quantize_decode_weights(
        jax.tree_util.tree_map(jnp.asarray, tree), tied, "int8")
    _assert_trees_equal(wquant.unpack_decode_tree(packed), ref)
    # The engine's CPU tree keeps the reference's layout: nothing packed.
    cpu = wquant.maybe_quantize_decode_weights(params, tied, "int8")
    leaves = [v for grp in cpu["layers"].values() for v in grp.values()] + [cpu["head_q"]]
    assert not any(isinstance(v, wquant.PackedW8) for v in leaves)


@pytest.mark.parametrize("names", [("wq", "wk", "wv"), ("w_gate", "w_up")])
def test_grouped_projections_match_the_reference_one_by_one(names):
    sub = "attn" if names[0] == "wq" else "mlp"
    _, tree, params, packed = _packed_tree(False, seed=4)
    rng = np.random.default_rng(9)
    h = rng.standard_normal((5, TINY["hidden_dim"]), dtype=np.float32)
    lp = layer_params(packed["layers"], 1)[sub]
    got = wquant.qmats(torch.from_numpy(h), lp, names, torch.float32)
    assert len(got) == len(names)
    ref_tree = ref_wq.maybe_quantize_decode_weights(
        jax.tree_util.tree_map(jnp.asarray, tree), False, "int8")["layers"][sub]
    for name, out in zip(names, got):
        q, s = ref_tree[name]
        want = _np(ref_wq.qmat(jnp.asarray(h), (q[1], s[1]), jnp.float32))
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)
    # Unpacked, the same call is one qmat a projection.
    plain = wquant.qmats(torch.from_numpy(h), layer_params(
        wquant.quantize_decode_weights(params, False)["layers"], 1)[sub], names, torch.float32)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


def test_a_decode_step_on_a_packed_tree_equals_the_unpacked_one():
    cfg = TransformerConfig(**TINY)
    _, _, params, packed = _packed_tree(False, seed=5)
    unpacked = wquant.quantize_decode_weights(params, False)
    B, pg = 3, 8
    shape = (cfg.n_layers, cfg.n_kv_heads, 8, pg, cfg.head_dim)
    pages = torch.arange(1, 1 + B, dtype=torch.int32)[:, None]
    lengths = torch.tensor([0, 3, 5], dtype=torch.int32)
    tokens = torch.tensor([4, 9, 17], dtype=torch.int32)
    active = torch.ones(B, dtype=torch.bool)
    out = [paged_decode_step(tree, cfg, tokens, torch.zeros(shape), torch.zeros(shape), pages,
                             lengths, active) for tree in (packed, unpacked)]
    assert torch.equal(out[0], out[1])


def _run(engine, reqs, timeout=120):
    results, done = {}, threading.Event()

    def cb(res):
        results[res.qid] = res
        if len(results) == len(reqs):
            done.set()

    for r in reqs:
        r.done_cb = cb
        engine.submit(r)
    assert done.wait(timeout), f"only {len(results)}/{len(reqs)} finished"
    return results


def _scales(engine):
    return {k: engine._qparams["layers"][grp][k][1].clone()
            for grp, keys in (("attn", ("wq", "wk", "wv", "wo")),
                              ("mlp", ("w_gate", "w_up", "w_down")))
            for k in keys} | {"head_q": engine._qparams["head_q"][1].clone()}


def _scaled(tree, f):
    if isinstance(tree, dict):
        return {k: _scaled(v, f) for k, v in tree.items()}
    return tree * f


@pytest.mark.parametrize("path", ["update_params", "cutover_params"])
def test_the_int8_copy_is_rebuilt_on_every_swap(path):
    _, tree = _tree(False, seed=1)
    params = params_from_numpy(tree, device="cpu")
    eng = ServingEngine(TransformerConfig(**TINY), params, max_batch_size=2, max_seq_len=64,
                        decode_block_steps=4, page_size=8, eos_token_id=None, seed=0,
                        decode_weight_dtype="int8", device="cpu")
    before = _scales(eng)
    eng.start()
    try:
        _run(eng, [GenRequest(qid="w0", input_ids=[3, 1, 4], max_new_tokens=5, greedy=True)])
        if path == "update_params":
            eng.update_params(_scaled(params, 1.5))
        else:
            eng.cutover_params(_scaled(params, 1.5), version=3)
        want_version = 1 if path == "update_params" else 3
        # The pin commits as the loop pops the update; the version goes
        # live right after the int8 copy is rebuilt.
        for _ in range(1000):
            if eng.version == want_version:
                break
            time.sleep(0.01)
        assert eng.version == want_version
        after = _scales(eng)
        for k in before:
            np.testing.assert_allclose(after[k].numpy(), 1.5 * before[k].numpy(), rtol=1e-6)
        # The decode blocks run the new copy: tokens equal an engine built
        # on the swapped weights.
        got = _run(eng, [GenRequest(qid="w1", input_ids=[2, 7, 1, 8], max_new_tokens=9,
                                    greedy=True)])["w1"]
    finally:
        eng.stop()
    fresh = ServingEngine(TransformerConfig(**TINY), _scaled(params, 1.5), max_batch_size=2,
                          max_seq_len=64, decode_block_steps=4, page_size=8, eos_token_id=None,
                          seed=0, decode_weight_dtype="int8", device="cpu")
    fresh.start()
    try:
        want = _run(fresh, [GenRequest(qid="w1", input_ids=[2, 7, 1, 8], max_new_tokens=9,
                                       greedy=True)])["w1"]
    finally:
        fresh.stop()
    assert got.output_ids == want.output_ids


def test_prefill_stays_unquantized():
    """The first token comes from prefill, which runs the float params: it
    and its logprob equal the unquantized engine's exactly."""
    _, tree = _tree(False, seed=2)
    params = params_from_numpy(tree, device="cpu")
    prompts = [[5, 9, 2, 6, 5, 3, 5], [8, 9, 7, 9, 3, 2, 3, 8, 4, 6, 2, 6, 4, 3, 3, 8, 3]]
    out = {}
    for dt in (None, "int8"):
        eng = ServingEngine(TransformerConfig(**TINY), params, max_batch_size=2,
                            max_seq_len=64, decode_block_steps=4, page_size=8,
                            prefill_chunk=8, eos_token_id=None, seed=0,
                            decode_weight_dtype=dt, device="cpu")
        eng.start()
        try:
            out[dt] = _run(eng, [GenRequest(qid=f"p{i}", input_ids=p, max_new_tokens=6,
                                            greedy=True) for i, p in enumerate(prompts)])
        finally:
            eng.stop()
    for q in out[None]:
        assert out["int8"][q].output_ids[0] == out[None][q].output_ids[0]
        assert out["int8"][q].output_logprobs[0] == out[None][q].output_logprobs[0]
