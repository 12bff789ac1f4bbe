"""Port parity of the serving engine's scheduling surface: token-budget
admission, priority classes with starvation aging, the prefill/decode
interleave, TTFT / ITL histograms, the qid prefix cache and ``warm``.

Each case of tests/engine/test_scheduler.py (7), test_prefix_cache.py
(7) and the serving cases of test_warm.py (2) runs through the reference
ServingEngine (JAX on the CPU) and areal_tpu_torch's (``device="cpu"``)
on the same numpy params (the tiny model of tests/test_torch_serving.py).
Each asserts what the reference test asserts, on both engines, and that
the two agree: identical greedy tokens with logprobs within rtol 1e-4,
equal prefix-cache and preemption counters, equal admission order, and
the same ``metrics()`` key set. The prompts are the reference tests'
lengths with token ids inside the tiny vocabulary.
"""

import threading

import jax
import numpy as np
import pytest

from areal_tpu.engine.serving import GenRequest as RefRequest
from areal_tpu.engine.serving import ServingEngine as RefEngine
from areal_tpu.models.config import TransformerConfig as RefConfig
from areal_tpu.models.transformer import init_params
from areal_tpu_torch.convert import params_from_numpy
from areal_tpu_torch.engine.serving import GenRequest, ServingEngine
from areal_tpu_torch.models.config import TransformerConfig
from tests.test_torch_serving import EOS, TINY

V = TINY["vocab_size"]
SIDES = ("ref", "port")


@pytest.fixture(scope="module")
def tree():
    return jax.tree_util.tree_map(
        np.asarray, init_params(RefConfig(**TINY), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def build(tree):
    """build(side, **kw) -> (engine, request class) on the shared params.
    ``prompt_bucket`` reaches the reference only (the port pads prefill
    to whole pages and chunks cache-hit deltas by the page size)."""
    ref_params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    port_params = params_from_numpy(tree, device="cpu")

    def make(side, **kw):
        if side == "ref":
            return RefEngine(RefConfig(**TINY), ref_params, **kw), RefRequest
        kw.pop("prompt_bucket", None)
        return (ServingEngine(TransformerConfig(**TINY), port_params, device="cpu", **kw),
                GenRequest)

    make.tree = tree
    return make


def toks(seed, n):
    return np.random.default_rng(seed).integers(0, V, size=n).tolist()


def run(engine, reqs, timeout=120):
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


def gen(engine, req_cls, qid, ids, max_new):
    return run(engine, [req_cls(qid=qid, input_ids=list(ids), max_new_tokens=max_new,
                                greedy=True)])[qid]


def assert_same(ref, port):
    """Identical greedy tokens, logprobs within rtol 1e-4, same flags."""
    for a, b in zip(ref, port):
        assert a.output_ids == b.output_ids, (a.qid, a.output_ids, b.output_ids)
        np.testing.assert_allclose(b.output_logprobs, a.output_logprobs, rtol=1e-4, atol=1e-5)
        assert (a.no_eos, a.interrupted) == (b.no_eos, b.interrupted), a.qid


def assert_same_counters(ref, port):
    m_ref, m_port = ref.metrics(), port.metrics()
    assert set(m_port) == set(m_ref)
    for k in ("prefix_cache_hits", "prefix_tokens_reused", "prefix_cached_tokens",
              "num_preempted_reqs", "total_requests", "total_generated"):
        assert m_port[k] == m_ref[k], k


def running_qids(eng):
    return [r.qid for r in eng._slot_req if r is not None]


# ----------------------------------------------------------------------
# tests/engine/test_scheduler.py
# ----------------------------------------------------------------------


def sched_engine(build, side, **kw):
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("decode_block_steps", 4)
    kw.setdefault("prompt_bucket", 8)
    return build(side, **kw)


def test_token_budget_caps_admissions_per_round(build):
    seen = {}
    for side in SIDES:
        eng, Req = sched_engine(build, side, prefill_token_budget=10)
        for i in range(3):
            eng.submit(Req(qid=f"q{i}", input_ids=[3] * 8, max_new_tokens=4, greedy=True))
        assert eng.queued_prompt_tokens == 24
        trace = []
        for want_running, want_queued in ((1, 16), (2, 8), (3, 0)):
            eng._admit()
            assert sum(r is not None for r in eng._slot_req) == want_running
            assert eng.queued_prompt_tokens == want_queued
            trace.append(running_qids(eng))
        seen[side] = trace
    assert seen["port"] == seen["ref"]


def test_token_budget_oversized_prompt_still_admits(build):
    for side in SIDES:
        eng, Req = sched_engine(build, side, prefill_token_budget=4)
        eng.submit(Req(qid="big", input_ids=[3] * 16, max_new_tokens=4, greedy=True))
        eng._admit()
        assert eng._slot_req.count(None) == eng.B - 1


def test_priority_admits_continuations_before_fresh(build):
    seen = {}
    for side in SIDES:
        eng, Req = sched_engine(build, side, prefill_token_budget=8)
        eng.submit(Req(qid="fresh1", input_ids=[3] * 8, priority=1))
        eng.submit(Req(qid="fresh2", input_ids=[4] * 8, priority=1))
        eng.submit(Req(qid="cont", input_ids=[5] * 8, priority=0))
        eng._admit()
        assert running_qids(eng) == ["cont"]
        eng._admit()
        assert set(running_qids(eng)) == {"cont", "fresh1"}
        seen[side] = running_qids(eng)
    assert seen["port"] == seen["ref"]


def test_starved_fresh_request_ages_into_class0(build):
    seen = {}
    for side in SIDES:
        eng, Req = sched_engine(build, side, max_batch_size=24, prefill_token_budget=8)
        eng.submit(Req(qid="fresh", input_ids=[3] * 8, priority=1, max_new_tokens=4))
        rounds, order = 0, []
        while True:
            eng.submit(Req(qid=f"cont{rounds}", input_ids=[5] * 8, priority=0,
                           max_new_tokens=4))
            before = set(running_qids(eng))
            eng._admit()
            order.append(sorted(set(running_qids(eng)) - before))
            rounds += 1
            if "fresh" in running_qids(eng):
                break
            assert rounds <= eng.STARVATION_ROUNDS + 1, "fresh never promoted"
        assert rounds == eng.STARVATION_ROUNDS + 1
        seen[side] = order
    assert seen["port"] == seen["ref"]


def test_rejected_overlong_prompt_releases_queued_tokens(build):
    for side in SIDES:
        eng, Req = sched_engine(build, side)
        got = []
        eng.submit(Req(qid="huge", input_ids=[3] * 200, max_new_tokens=4, done_cb=got.append))
        assert eng.queued_prompt_tokens == 200
        eng._admit()
        assert eng.queued_prompt_tokens == 0
        assert len(got) == 1 and got[0].output_ids == [] and got[0].no_eos


def test_latency_histograms_and_snapshot_reset(build):
    outs = {}
    for side in SIDES:
        eng, Req = sched_engine(build, side, eos_token_id=None)
        eng.start()
        try:
            res = run(eng, [Req(qid=f"h{i}", input_ids=[7, 8, 9], max_new_tokens=8,
                                greedy=True) for i in range(3)])
            m = eng.metrics()
            assert m["ttft_count"] == 3.0
            assert m["itl_count"] >= 3.0
            assert 0.0 < m["ttft_p50_ms"] <= m["ttft_p99_ms"]
            assert 0.0 < m["itl_p50_ms"] <= m["itl_p99_ms"]
            snap = eng.latency_snapshot(reset=True)
            assert sum(snap["ttft_counts"]) == 3
            assert snap["ttft_p99_ms"] == m["ttft_p99_ms"]
            after = eng.latency_snapshot()
            assert sum(after["ttft_counts"]) == 0 and sum(after["itl_counts"]) == 0
            outs[side] = (eng, [res[f"h{i}"] for i in range(3)])
        finally:
            eng.stop()
    assert_same(outs["ref"][1], outs["port"][1])
    assert_same_counters(outs["ref"][0], outs["port"][0])
    # Both engines emit the same tokens, so their ITL sample counts agree.
    assert outs["ref"][0].metrics()["itl_count"] == outs["port"][0].metrics()["itl_count"]


def test_interleave_knob_preserves_results(build):
    outs = {}
    for side in SIDES:
        for ratio in (1, 3):
            eng, Req = sched_engine(build, side, eos_token_id=EOS,
                                    decode_blocks_per_admit=ratio, prefill_token_budget=16)
            eng.start()
            try:
                res = run(eng, [Req(qid=f"r{i}", input_ids=[9 + i, 11, 13], max_new_tokens=12,
                                    greedy=True) for i in range(6)])
                for r in res.values():
                    assert 1 <= len(r.output_ids) <= 12
                outs[side, ratio] = [res[f"r{i}"] for i in range(6)]
            finally:
                eng.stop()
        assert ([r.output_ids for r in outs[side, 1]]
                == [r.output_ids for r in outs[side, 3]])
    assert_same(outs["ref", 1], outs["port", 1])
    assert_same(outs["ref", 3], outs["port", 3])


# ----------------------------------------------------------------------
# tests/engine/test_prefix_cache.py
# ----------------------------------------------------------------------


def cache_engine(build, side, prefix_cache_tokens, **kw):
    eng, Req = build(side, max_batch_size=4, max_seq_len=256, decode_block_steps=4,
                     prompt_bucket=16, eos_token_id=None, page_size=16,
                     prefix_cache_tokens=prefix_cache_tokens, **kw)
    eng.start()
    return eng, Req


def test_resubmission_reuses_prefix_and_matches_uncached(build):
    """A 40-token prompt and 8 new tokens park 47 covered tokens, so the
    resubmission's delta prefill starts at position 47, off the 16-token
    page boundary."""
    prompt = toks(1, 40)
    outs = {}
    for side in SIDES:
        ref_eng, Req = cache_engine(build, side, None)
        try:
            full = gen(ref_eng, Req, "ref", prompt, 16)
        finally:
            ref_eng.stop()
        eng, Req = cache_engine(build, side, 4096)
        try:
            r1 = gen(eng, Req, "s/0", prompt, 8)
            assert eng.prefix_cache_hits == 0
            assert eng._prefix_cache["s/0"][0] == (prompt + r1.output_ids)[:47]
            r2 = gen(eng, Req, "s/0", prompt + r1.output_ids, 8)
            assert eng.prefix_cache_hits == 1
            assert eng.prefix_tokens_reused == 47 and 47 % 16 != 0
            assert r1.output_ids + r2.output_ids == full.output_ids
            outs[side] = (eng, [full, r1, r2])
        finally:
            eng.stop()
    assert_same(outs["ref"][1], outs["port"][1])
    assert_same_counters(outs["ref"][0], outs["port"][0])


def test_cache_disabled_frees_pages(build):
    outs = {}
    for side in SIDES:
        eng, Req = cache_engine(build, side, None)
        try:
            free0 = eng._allocator.n_free
            outs[side] = (eng, [gen(eng, Req, "a", toks(2, 30), 4)])
            assert eng._allocator.n_free == free0
            assert eng._cached_tokens == 0
        finally:
            eng.stop()
    assert_same(outs["ref"][1], outs["port"][1])
    assert_same_counters(outs["ref"][0], outs["port"][0])


def test_budget_eviction_lru(build):
    outs = {}
    for side in SIDES:
        eng, Req = cache_engine(build, side, 64)
        try:
            free0 = eng._allocator.n_free
            a = gen(eng, Req, "a", toks(3, 40), 4)
            assert "a" in eng._prefix_cache
            b = gen(eng, Req, "b", toks(4, 40), 4)
            assert "a" not in eng._prefix_cache and "b" in eng._prefix_cache
            cached = eng.metrics()["prefix_cached_tokens"]
            eng._flush_prefix_cache()
            assert eng._cached_tokens == 0
            assert eng._allocator.n_free == free0
            outs[side] = (eng, [a, b], cached)
        finally:
            eng.stop()
    assert_same(outs["ref"][1], outs["port"][1])
    assert_same_counters(outs["ref"][0], outs["port"][0])
    assert outs["port"][2] == outs["ref"][2]


def test_weight_update_flushes_cache(build):
    outs = {}
    for side in SIDES:
        eng, Req = cache_engine(build, side, 4096)
        try:
            prompt = toks(5, 30)
            out1 = gen(eng, Req, "w", prompt, 4)
            assert eng._cached_tokens > 0
            new = (jax.tree_util.tree_map(np.asarray, build.tree) if side == "ref"
                   else params_from_numpy(build.tree, device="cpu"))
            eng.update_params(new, allow_interrupt=True)
            gen(eng, Req, "warm", [1, 2, 3], 2)  # lets the swap land
            assert eng._cached_tokens == 0
            out2 = gen(eng, Req, "w", prompt + out1.output_ids, 4)
            assert eng.prefix_cache_hits == 0
            assert len(out2.output_ids) == 4
            assert eng.version == 1
            outs[side] = (eng, [out1, out2])
        finally:
            eng.stop()
    assert_same(outs["ref"][1], outs["port"][1])
    assert_same_counters(outs["ref"][0], outs["port"][0])


def test_pool_pressure_evicts_cache_before_preempting(build):
    outs = {}
    for side in SIDES:
        eng, Req = cache_engine(build, side, 100000, kv_pool_tokens=12 * 16)
        try:
            old = gen(eng, Req, "old", toks(6, 80), 8)
            assert eng._cached_tokens > 0
            res = gen(eng, Req, "new", toks(7, 100), 8)
            assert len(res.output_ids) == 8
            assert eng.n_preempted == 0
            outs[side] = (eng, [old, res])
        finally:
            eng.stop()
    assert_same(outs["ref"][1], outs["port"][1])
    assert_same_counters(outs["ref"][0], outs["port"][0])


def test_eviction_under_page_pressure_keeps_accounting_consistent(build):
    outs = {}
    pa, pb, pc = toks(8, 40), toks(9, 40), toks(10, 100)
    for side in SIDES:
        eng, Req = cache_engine(build, side, 100000, kv_pool_tokens=12 * 16)
        try:
            free_total = eng._allocator.n_free

            def check_invariants():
                cached_pages = sum(len(p) for _, p in eng._prefix_cache.values())
                slot_pages = sum(len(p) for p in eng._slot_pages)
                assert eng._allocator.n_free + cached_pages + slot_pages == free_total
                assert eng._cached_tokens == sum(len(t) for t, _ in eng._prefix_cache.values())
                assert eng.prefix_cache_hits <= eng.total_requests

            out_a = gen(eng, Req, "a", pa, 8)
            out_b = gen(eng, Req, "b", pb, 8)
            assert "a" in eng._prefix_cache and "b" in eng._prefix_cache
            check_invariants()
            c = gen(eng, Req, "c", pc, 8)
            assert "a" not in eng._prefix_cache, "pressure never evicted"
            assert "b" in eng._prefix_cache
            assert eng.n_preempted == 0
            check_invariants()
            hits0 = eng.prefix_cache_hits
            out_b2 = gen(eng, Req, "b", pb + out_b.output_ids, 4)
            assert eng.prefix_cache_hits == hits0 + 1
            ref = gen(eng, Req, "bref", pb + out_b.output_ids, 4)
            assert out_b2.output_ids == ref.output_ids
            check_invariants()
            hits1 = eng.prefix_cache_hits
            out_a2 = gen(eng, Req, "a", pa + out_a.output_ids, 4)
            assert eng.prefix_cache_hits == hits1
            assert len(out_a2.output_ids) == 4
            check_invariants()
            assert eng.total_requests == 6
            assert eng.prefix_cache_hits == 1
            outs[side] = (eng, [out_a, out_b, c, out_b2, ref, out_a2])
        finally:
            eng.stop()
    assert_same(outs["ref"][1], outs["port"][1])
    assert_same_counters(outs["ref"][0], outs["port"][0])


def test_first_token_finish_still_parks_prompt(build):
    outs = {}
    for side in SIDES:
        eng, Req = cache_engine(build, side, 4096)
        try:
            prompt = toks(11, 40)
            out1 = gen(eng, Req, "f/0", prompt, 1)
            assert len(out1.output_ids) == 1 and eng._cached_tokens >= len(prompt)
            out2 = gen(eng, Req, "f/0", prompt + out1.output_ids, 4)
            assert eng.prefix_cache_hits == 1
            assert len(out2.output_ids) == 4
            outs[side] = (eng, [out1, out2])
        finally:
            eng.stop()
    assert_same(outs["ref"][1], outs["port"][1])
    assert_same_counters(outs["ref"][0], outs["port"][0])


# ----------------------------------------------------------------------
# tests/engine/test_warm.py (the serving cases)
# ----------------------------------------------------------------------


def warm_engine(build, side):
    return build(side, max_batch_size=2, max_seq_len=128, decode_block_steps=4,
                 prompt_bucket=8, page_size=8, eos_token_id=None, kv_pool_tokens=2 * 128)


def test_serving_warm_compiles_then_serves(build):
    outs = {}
    for side in SIDES:
        eng, Req = warm_engine(build, side)
        eng.start()
        try:
            assert eng.warm([8, 16]) > 0.0
            res = gen(eng, Req, "q0", [1] * 8, 8)
            assert len(res.output_ids) == 8
            outs[side] = (eng, [res])
        finally:
            eng.stop()
    assert_same(outs["ref"][1], outs["port"][1])
    assert_same_counters(outs["ref"][0], outs["port"][0])


def test_serving_warm_requires_start(build):
    ref, _ = warm_engine(build, "ref")
    with pytest.raises(AssertionError):
        ref.warm([8])
    port, _ = warm_engine(build, "port")
    with pytest.raises(RuntimeError, match="requires start"):
        port.warm([8])
