"""Port parity: areal_tpu_torch's ServingEngine (device="cpu", the plain
attention paths) against areal_tpu's ServingEngine on the same params.

Greedy decoding makes the two engines comparable token for token: the
same requests must give IDENTICAL greedy tokens and logprobs within
rtol 1e-4 (float32 on both sides; different libraries' reduction
orders). Cases: more requests than slots, the chunked prefill path, pool
pressure preemption (same preempted requests, same partial outputs), an
int8 KV pool. Each reference engine runs once per module (a fixture), as
its compiles dominate. The update_params interrupt semantics follow
tests/engine/test_serving.py.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from areal_tpu.engine.serving import GenRequest as JaxRequest
from areal_tpu.engine.serving import ServingEngine as JaxEngine
from areal_tpu.models.config import TransformerConfig as JaxConfig
from areal_tpu.models.transformer import init_params
from areal_tpu_torch.convert import params_from_numpy
from areal_tpu_torch.engine.serving import GenRequest, ServingEngine
from areal_tpu_torch.models.config import TransformerConfig

# The tiny model of tests/engine/serving_utils.py, copied.
TINY = dict(n_layers=2, hidden_dim=32, n_q_heads=2, n_kv_heads=1, head_dim=16,
            intermediate_dim=64, vocab_size=64, max_position_embeddings=512,
            compute_dtype="float32", param_dtype="float32")
EOS = 5

# name -> (shared engine kwargs, prompt lengths, max_new_tokens)
CASES = {
    # 6 requests on 4 slots: queueing and slot reuse
    "float": (dict(max_batch_size=4, max_seq_len=128, decode_block_steps=4,
                   eos_token_id=EOS), [3, 5, 9, 2, 12, 7], 24),
    # prompts past prefill_chunk take the chunked path (several chunks,
    # several pages), the rest the batched path, in one admission round
    "chunked": (dict(max_batch_size=4, max_seq_len=256, decode_block_steps=4,
                     page_size=16, prefill_chunk=16, eos_token_id=EOS),
                [40, 9, 33, 16], 20),
    # a 5-page pool for 4 slots that each grow past one page: preemption
    "preempt": (dict(max_batch_size=4, max_seq_len=64, decode_block_steps=4,
                     page_size=8, kv_pool_tokens=40, eos_token_id=None),
                [6, 10, 4, 9, 7], 30),
    # int8 KV pool through both the batched and the chunked prefill
    "int8": (dict(max_batch_size=4, max_seq_len=256, decode_block_steps=4,
                  page_size=16, prefill_chunk=16, eos_token_id=EOS,
                  kv_cache_dtype="int8"), [40, 9, 3, 21, 12], 20),
}


def _prompts(name):
    rng = np.random.default_rng(len(name))
    return [rng.integers(0, 64, size=n).tolist() for n in CASES[name][1]]


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


def _serve(engine_cls, req_cls, params, name, **extra):
    kw, _, max_new = CASES[name]
    eng = engine_cls(TransformerConfig(**TINY) if engine_cls is ServingEngine
                     else JaxConfig(**TINY), params, seed=0, **kw, **extra)
    eng.start()
    try:
        return _run(eng, [req_cls(qid=f"{name}{i}", input_ids=p, max_new_tokens=max_new,
                                  greedy=True) for i, p in enumerate(_prompts(name))])
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def tree():
    cfg = JaxConfig(**TINY)
    return jax.tree_util.tree_map(np.asarray, init_params(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def reference(tree):
    """Every case through the reference engine, once."""
    params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    return {name: _serve(JaxEngine, JaxRequest, params, name) for name in CASES}


@pytest.fixture(scope="module")
def port_params(tree):
    return params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_greedy_matches_reference_engine(reference, port_params, name):
    got = _serve(ServingEngine, GenRequest, port_params, name, device="cpu")
    want = reference[name]
    assert sorted(got) == sorted(want)
    for qid in want:
        g, w = got[qid], want[qid]
        assert g.error is None and w.error is None
        assert g.output_ids == w.output_ids, qid
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs,
                                   rtol=1e-4, atol=1e-5)
        assert (g.no_eos, g.interrupted) == (w.no_eos, w.interrupted), qid
    if name == "preempt":
        assert any(r.interrupted for r in got.values()), "pool pressure never preempted"
    if name == "float":
        assert any(not r.no_eos for r in got.values()), "no request stopped on EOS"


def test_sampled_requests_are_valid(port_params):
    """Non-greedy rows (temperature, top-k, top-p) produce in-vocab tokens,
    logprobs <= 0, and never EOS before min_new_tokens."""
    eng = ServingEngine(TransformerConfig(**TINY), port_params, max_batch_size=4,
                        max_seq_len=128, decode_block_steps=4, eos_token_id=EOS,
                        seed=3, device="cpu")
    eng.start()
    try:
        reqs = [GenRequest(qid=f"s{i}", input_ids=[7 + i, 11, 13], max_new_tokens=20,
                           min_new_tokens=8, temperature=t, top_k=k, top_p=p)
                for i, (t, k, p) in enumerate([(1.0, -1, 1.0), (0.7, 5, 1.0),
                                               (1.3, -1, 0.9), (0.8, 200, 0.5)])]
        results = _run(eng, reqs)
    finally:
        eng.stop()
    for r in results.values():
        assert 8 <= len(r.output_ids) <= 20
        assert all(0 <= t < 64 for t in r.output_ids)
        assert EOS not in r.output_ids[:7]
        assert all(lp <= 0 for lp in r.output_logprobs)


def test_interrupt_and_weight_update(port_params):
    eng = ServingEngine(TransformerConfig(**TINY), port_params, max_batch_size=2,
                        max_seq_len=2048, decode_block_steps=2, eos_token_id=None,
                        seed=0, device="cpu")
    eng.start()
    try:
        results, ev = {}, threading.Event()

        def cb(res):
            results[res.qid] = res
            ev.set()

        # Long-budget request with no EOS: can only end via interrupt.
        eng.submit(GenRequest(qid="long", input_ids=[3, 4], max_new_tokens=1500,
                              done_cb=cb))
        deadline = time.monotonic() + 30
        while eng.decode_blocks < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        new = {k: v for k, v in port_params.items()}
        new["final_norm"] = {"weight": port_params["final_norm"]["weight"] * 1.01}
        eng.update_params(new, allow_interrupt=True)
        assert ev.wait(30)
        res = results["long"]
        assert res.interrupted and res.no_eos
        assert 0 < len(res.output_ids) < 1500
        assert res.version_start == 0
        deadline = time.monotonic() + 10
        while eng.version != 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.version == 1
        after = _run(eng, [GenRequest(qid="after", input_ids=[5, 6], max_new_tokens=4)])
        assert after["after"].version_start == 1 and after["after"].version_end == 1
        # A pinned update not newer than the highest pinned one is dropped.
        eng.update_params(new, version=7)
        deadline = time.monotonic() + 10
        while eng.version != 7 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.version == 7
        eng.update_params(new, version=7)
        time.sleep(0.05)
        assert eng.version == 7 and eng._pending_params is None
    finally:
        eng.stop()


def test_engine_rejects_what_the_slice_lacks(port_params):
    from areal_tpu_torch.models.config import MoEConfig

    with pytest.raises(NotImplementedError):
        ServingEngine(TransformerConfig(**TINY, moe=MoEConfig()), port_params, device="cpu")
    with pytest.raises(ValueError):
        ServingEngine(TransformerConfig(**TINY), port_params, kv_cache_dtype="fp8",
                      device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(TransformerConfig(**TINY), port_params)
