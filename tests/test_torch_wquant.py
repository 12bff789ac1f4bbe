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
- a bad dtype raises ``ValueError``, and the kernel's wrapper refuses what
  the kernel does not take before nvcc is touched;
- the kernel's split plan covers K with no empty split and fills the card
  at the decode shapes of R1-Distill-Qwen-1.5B;
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
        wquant.w8a16_matmul(h, wq, s)
    # A CPU tensor takes the plain version through qmat, never the wrapper.
    out = wquant.qmat(h, (wq, s), torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (4, 32)


# The decode-path shapes of R1-Distill-Qwen-1.5B, (K, N): wq/wo, wk/wv,
# w_gate/w_up, w_down, the head.
DECODE_SHAPES = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536), (1536, 151936)]


@pytest.mark.parametrize("M", [1, 16, 37, 80, 256])
@pytest.mark.parametrize("K,N", DECODE_SHAPES + [(100, 40), (16, 8)])
def test_the_split_plan_covers_k(M, K, N):
    n_sm = 132
    splits, per = wquant.w8a16_plan(M, K, N, n_sm)
    k_chunks = -(-K // wquant.BK)
    assert splits >= 1 and per >= 1
    assert (splits - 1) * per < k_chunks <= splits * per  # no split empty
    tiles = -(-N // wquant.BN) * -(-M // wquant.MB)
    if tiles < n_sm and k_chunks > 1:
        assert splits > 1  # small-N layers split K to cover the SMs
    if tiles >= 2 * n_sm:
        assert splits == 1
    assert wquant.w8a16_plan(M, K, N, n_sm) == (splits, per)


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
