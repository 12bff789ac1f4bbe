"""Port parity of n-gram speculative decoding (engine/spec_decode.py and the
engine's speculative path) against the reference's, on the CPU, float32 on
both sides.

- ``propose_ngram_drafts``: drafts and ``eff`` equal to the reference's on
  the reference test's cases and on seeded random histories, windowed and
  unbounded;
- ``spec_verify`` fed the very draws JAX makes (the uniforms of
  ``jax.random.uniform`` and the Gumbel noise behind
  ``jax.random.categorical``): ``emitted`` and ``n_emit`` equal, logprobs
  within 1e-5, for greedy rows, sampled rows (temperature, top-k, top-p)
  and ``eff`` = 0;
- the port's speculative engine against the reference's speculative engine
  and against the port's plain engine, in six cases (float, chunked,
  preempt, int8 KV pool, int8 decode weights, all three): greedy tokens
  identical, logprobs within rtol 1e-4, and the ``spec_emitted_tokens`` /
  ``spec_active_steps`` counters equal to the reference's (every request is
  queued before the loop starts, so admission rounds are alike). Against
  the plain engine the preempt case compares the tokens both emitted: the
  speculative block reserves 1 + draft_len times the pages, so pool
  pressure preempts it sooner (as in the reference);
- ``min_new_tokens``, the exact budget and a prefix-cache resubmission,
  each against the reference engine;
- the smoke's ``spec`` phase, its engine legs and its server, at a tiny size.

Each reference engine runs once per module (a fixture), as its compiles
dominate.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from areal_tpu.engine.serving import GenRequest as JaxRequest
from areal_tpu.engine.serving import ServingEngine as JaxEngine
from areal_tpu.engine.spec_decode import propose_ngram_drafts as ref_propose
from areal_tpu.engine.spec_decode import spec_verify as ref_verify
from areal_tpu.models.config import TransformerConfig as JaxConfig
from areal_tpu.models.transformer import init_params
from areal_tpu_torch.convert import params_from_numpy
from areal_tpu_torch.engine.serving import GenRequest, ServingEngine
from areal_tpu_torch.engine.spec_decode import propose_ngram_drafts, spec_verify
from areal_tpu_torch.models.config import TransformerConfig
from tests.test_torch_serving import CASES, TINY

# ----------------------------------------------------------------------
# propose_ngram_drafts
# ----------------------------------------------------------------------

# (tokens, pending position, ngram, draft_len, window, history width): the
# reference test's cases (tests/engine/test_spec_decode.py).
PROPOSE_CASES = [
    ([1, 2, 3, 9, 1, 2, 3], 6, 2, 4, 0, 16),          # simple repeat
    ([1, 2, 3, 4], 3, 2, 4, 0, 16),                   # no match
    ([7, 8, 1, 9, 7, 8, 2, 9, 7, 8], 9, 2, 3, 0, 16),  # most recent wins
    ([3], 0, 2, 4, 0, 16),                            # short history
    ([4, 4, 4], 2, 2, 4, 0, 16),                      # continuation capped
    ([1, 2, 3, 9, 1, 2, 3], 6, 2, 4, 8, 64),          # windowed, recent match
    ([5, 6] + [10 + i for i in range(20)] + [5, 6], 23, 2, 3, 4, 64),  # stale
    ([5, 6] + [10 + i for i in range(20)] + [5, 6], 23, 2, 3, 0, 64),
    ([7, 8, 1, 9, 7, 8, 2, 9, 7, 8], 9, 2, 3, 8, 32),  # windowed, most recent
]


def _propose_both(hist, lengths, ngram, d, window):
    ref = ref_propose(jnp.asarray(hist), jnp.asarray(lengths, jnp.int32), ngram=ngram,
                      draft_len=d, window=window)
    got = propose_ngram_drafts(torch.from_numpy(hist), torch.from_numpy(lengths),
                               ngram, d, window=window)
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


@pytest.mark.parametrize("case", range(len(PROPOSE_CASES)))
def test_propose_matches_reference_cases(case):
    toks, pend, g, d, window, width = PROPOSE_CASES[case]
    hist = np.zeros((1, width + 1), np.int32)
    hist[0, :len(toks)] = toks
    (rd, re_), (gd, ge) = _propose_both(hist, np.asarray([pend], np.int32), g, d, window)
    np.testing.assert_array_equal(ge, re_)
    np.testing.assert_array_equal(gd, rd)
    assert gd.dtype == np.int32 and ge.dtype == np.int32


@pytest.mark.parametrize("window", [0, 5, 24, 200])
@pytest.mark.parametrize("ngram,d", [(1, 3), (2, 4), (3, 2)])
def test_propose_matches_reference_on_random_histories(window, ngram, d):
    rng = np.random.default_rng(window * 10 + ngram)
    B, S = 6, 96
    # A small vocabulary, so matches are frequent; the pending positions
    # span the edge cases (0, 1, the last column).
    hist = rng.integers(0, 5, size=(B, S + 1)).astype(np.int32)
    lengths = np.asarray([0, 1, 17, 40, S - 2, S - 1], np.int32)
    (rd, re_), (gd, ge) = _propose_both(hist, lengths, ngram, d, window)
    np.testing.assert_array_equal(ge, re_)
    np.testing.assert_array_equal(gd, rd)
    assert (ge > 0).any()


# ----------------------------------------------------------------------
# spec_verify with JAX's own draws
# ----------------------------------------------------------------------


def _verify_both(logits, draft, eff, greedy, temps, top_ps, top_ks, forbid, eos_ids, seed):
    B, d1, V = logits.shape
    key = jax.random.PRNGKey(seed)
    eos = np.zeros((V,), bool)
    eos[list(eos_ids)] = True
    ref = ref_verify(jnp.asarray(logits), jnp.asarray(draft), jnp.asarray(eff), key,
                     jnp.asarray(temps), jnp.asarray(top_ps), jnp.asarray(top_ks),
                     jnp.asarray(greedy), jnp.asarray(forbid), jnp.asarray(eos))
    # The draws spec_verify makes inside: one split, the acceptance
    # uniforms from the first key, the categorical's Gumbel noise from the
    # second.
    k_u, k_cat = jax.random.split(key)
    u = torch.from_numpy(np.array(jax.random.uniform(k_u, (B, d1 - 1))))
    gumbel = torch.from_numpy(np.array(jax.random.gumbel(k_cat, (B, V))))
    got = spec_verify(torch.from_numpy(logits), torch.from_numpy(draft),
                      torch.from_numpy(eff), None, torch.from_numpy(temps),
                      torch.from_numpy(top_ps), torch.from_numpy(top_ks),
                      torch.from_numpy(greedy), torch.from_numpy(forbid),
                      torch.from_numpy(eos), u=u, gumbel=gumbel)
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


@pytest.mark.parametrize("mode", ["greedy", "sampled", "mixed", "eff0"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_verify_matches_reference_with_its_draws(mode, seed):
    rng = np.random.default_rng(seed + 100)
    B, d, V = 6, 3, 23
    logits = (rng.standard_normal((B, d + 1, V)) * 2.0).astype(np.float32)
    # Drafts that often hit the argmax (so greedy rows accept some) and
    # random ones.
    draft = rng.integers(0, V, size=(B, d)).astype(np.int32)
    hit = rng.random((B, d)) < 0.6
    draft = np.where(hit, logits[:, :d].argmax(axis=2), draft).astype(np.int32)
    eff = np.asarray([3, 2, 0, 1, 3, 3], np.int32)
    if mode == "eff0":
        eff[:] = 0
    greedy = np.full((B,), mode in ("greedy", "eff0"), bool)
    if mode == "mixed":
        greedy[::2] = True
    temps = np.ones((B,), np.float32)
    top_ps = np.ones((B,), np.float32)
    top_ks = np.full((B,), -1, np.int32)
    if mode in ("sampled", "mixed"):
        temps = np.asarray([1.0, 0.7, 1.3, 1.0, 0.9, 1.0], np.float32)
        top_ks[1] = 5
        top_ps[4] = 0.8
    forbid = np.zeros((B,), bool)
    forbid[3] = True
    (r_emit, r_n, r_lp), (g_emit, g_n, g_lp) = _verify_both(
        logits, draft, eff, greedy, temps, top_ps, top_ks, forbid, (7,), seed)
    np.testing.assert_array_equal(g_n, r_n)
    np.testing.assert_array_equal(g_emit, r_emit)
    np.testing.assert_allclose(g_lp, r_lp, rtol=1e-5, atol=1e-5)
    if mode == "eff0":
        assert (g_n == 1).all()
        masked = np.where(np.arange(V) == 7, -1e30, logits[:, 0])
        want = np.where(forbid, masked.argmax(axis=1), logits[:, 0].argmax(axis=1))
        np.testing.assert_array_equal(g_emit[:, 0], want)
    if mode == "greedy":
        assert g_n.max() > 1  # some drafts accepted


# ----------------------------------------------------------------------
# Engines: the port's speculative engine against the reference's and
# against the port's plain engine
# ----------------------------------------------------------------------

SPEC = dict(speculative_draft_len=3)
# name -> (base case of tests/test_torch_serving.py, extra engine kwargs)
ENGINE_CASES = {
    "float": ("float", {}),
    "chunked": ("chunked", {}),
    "preempt": ("preempt", {}),
    "int8_kv": ("int8", {}),
    "int8_weights": ("float", dict(decode_weight_dtype="int8")),
    "all_three": ("int8", dict(decode_weight_dtype="int8")),
}


def _prompts(name):
    """The base case's prompts, with a repeated span in every other one so
    drafts are accepted from the prompt too."""
    rng = np.random.default_rng(len(name) + 40)
    out = []
    for i, n in enumerate(CASES[name][1]):
        p = rng.integers(0, 64, size=n).tolist()
        if i % 2 == 0 and n >= 6:
            span = p[:3]
            p = (p + span * 3)[:max(n, 9)]
        out.append(p)
    return out


def _queue_then_serve(engine, reqs, timeout=120):
    """Queue every request, then start the loop: its first admission round
    sees them all, in both packages."""
    results, done = {}, threading.Event()

    def cb(res):
        results[res.qid] = res
        if len(results) == len(reqs):
            done.set()

    for r in reqs:
        r.done_cb = cb
        engine.submit(r)
    engine.start()
    try:
        assert done.wait(timeout), f"only {len(results)}/{len(reqs)} finished"
        return results, engine.metrics()
    finally:
        engine.stop()


def _serve(package, params, name, spec=True):
    base, extra = ENGINE_CASES[name]
    kw, _, max_new = CASES[base]
    kw = dict(kw, **extra, **(SPEC if spec else {}))
    if package == "ref":
        eng = JaxEngine(JaxConfig(**TINY), params, seed=0, **kw)
        req = JaxRequest
    else:
        eng = ServingEngine(TransformerConfig(**TINY), params, seed=0, device="cpu", **kw)
        req = GenRequest
    reqs = [req(qid=f"{name}{i}", input_ids=p, max_new_tokens=max_new, greedy=True)
            for i, p in enumerate(_prompts(base))]
    return _queue_then_serve(eng, reqs)


@pytest.fixture(scope="module")
def tree():
    return jax.tree_util.tree_map(
        np.asarray, init_params(JaxConfig(**TINY), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def port_params(tree):
    return params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def reference(tree):
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return {name: _serve("ref", params, name) for name in ENGINE_CASES}


def _assert_same(got, want, prefix_only=False):
    assert sorted(got) == sorted(want)
    for qid in want:
        g, w = got[qid], want[qid]
        assert g.error is None and w.error is None
        if prefix_only:
            n = min(len(g.output_ids), len(w.output_ids))
            assert n > 0 and g.output_ids[:n] == w.output_ids[:n], qid
            np.testing.assert_allclose(g.output_logprobs[:n], w.output_logprobs[:n],
                                       rtol=1e-4, atol=1e-5)
            continue
        assert g.output_ids == w.output_ids, qid
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs, rtol=1e-4, atol=1e-5)
        assert (g.no_eos, g.interrupted) == (w.no_eos, w.interrupted), qid


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_spec_engine_matches_reference_spec_engine(reference, port_params, name):
    got, m = _serve("port", port_params, name)
    want, m_ref = reference[name]
    _assert_same(got, want)
    for k in ("spec_emitted_tokens", "spec_active_steps", "spec_tokens_per_step",
              "num_preempted_reqs"):
        assert m[k] == m_ref[k], k
    assert m["spec_emitted_tokens"] > m["spec_active_steps"] > 0  # drafts accepted
    if name == "preempt":
        assert any(r.interrupted for r in got.values()), "pool pressure never preempted"


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_spec_engine_matches_the_plain_engine(port_params, name):
    spec, _ = _serve("port", port_params, name)
    plain, m_plain = _serve("port", port_params, name, spec=False)
    assert m_plain["spec_active_steps"] == 0.0
    _assert_same(spec, plain, prefix_only=name == "preempt")


def _one_engine(package, params, reqs_fn, **kw):
    base = dict(max_batch_size=4, max_seq_len=128, decode_block_steps=4, page_size=8,
                eos_token_id=5, seed=0)
    base.update(kw)
    if package == "ref":
        eng = JaxEngine(JaxConfig(**TINY), jax.tree_util.tree_map(jnp.asarray, params),
                        **base)
        return _queue_then_serve(eng, reqs_fn(JaxRequest))[0]
    eng = ServingEngine(TransformerConfig(**TINY), params_from_numpy(params, device="cpu"),
                        device="cpu", **base)
    return _queue_then_serve(eng, reqs_fn(GenRequest))[0]


def test_min_new_tokens_and_the_exact_budget(tree):
    def reqs(cls):
        return [cls(qid="m", input_ids=[6, 6, 6, 6], max_new_tokens=16, min_new_tokens=8,
                    greedy=True),
                cls(qid="b", input_ids=[2, 3, 2, 3, 2, 3], max_new_tokens=11, greedy=True),
                cls(qid="s", input_ids=[3, 1, 4, 1, 3, 1], max_new_tokens=20,
                    min_new_tokens=12, temperature=1.0)]

    got = _one_engine("port", tree, reqs, speculative_draft_len=4)
    want = _one_engine("ref", tree, reqs, speculative_draft_len=4)
    for q in ("m", "b"):
        assert got[q].output_ids == want[q].output_ids, q
    assert len(got["m"].output_ids) >= 8 and 5 not in got["m"].output_ids[:7]
    assert 5 not in got["s"].output_ids[:11] and len(got["s"].output_ids) >= 12
    budget = _one_engine("port", tree, lambda cls: [cls(
        qid="b", input_ids=[2, 3, 2, 3, 2, 3], max_new_tokens=11, greedy=True)],
        speculative_draft_len=4, eos_token_id=None)["b"]
    assert len(budget.output_ids) == 11 and budget.no_eos


def test_prefix_cache_resubmission(tree):
    """A cache-hit admission prefills only the delta, but the history row
    holds the whole prompt: the continuation equals the reference's
    speculative engine's and a plain engine's."""
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    kw = dict(eos_token_id=None, prefill_chunk=8, prefix_cache_tokens=256)

    def run(package, **extra):
        base = dict(max_batch_size=4, max_seq_len=128, decode_block_steps=4, page_size=8,
                    seed=0, **kw, **extra)
        if package == "ref":
            eng = JaxEngine(JaxConfig(**TINY), jax.tree_util.tree_map(jnp.asarray, tree),
                            **base)
            cls = JaxRequest
        else:
            eng = ServingEngine(TransformerConfig(**TINY), params_from_numpy(tree, device="cpu"),
                                device="cpu", **base)
            cls = GenRequest
        out, done = {}, threading.Event()

        def cb(res):
            out[res.qid + str(len(out))] = res
            done.set()

        eng.start()
        try:
            eng.submit(cls(qid="pc", input_ids=list(prompt), max_new_tokens=6, greedy=True,
                           done_cb=cb))
            assert done.wait(60)
            done.clear()
            r1 = out["pc0"]
            eng.submit(cls(qid="pc", input_ids=list(prompt) + list(r1.output_ids),
                           max_new_tokens=5, greedy=True, done_cb=cb))
            assert done.wait(60)
            return r1, out["pc1"], eng.prefix_cache_hits
        finally:
            eng.stop()

    p1, p2, hits = run("port", speculative_draft_len=3)
    r1, r2, _ = run("ref", speculative_draft_len=3)
    q1, q2, _ = run("port")
    assert hits == 1 and len(p1.output_ids) == 6 and len(p2.output_ids) == 5
    assert p1.output_ids == r1.output_ids == q1.output_ids
    assert p2.output_ids == r2.output_ids == q2.output_ids


# ----------------------------------------------------------------------
# The smoke's spec phase at a tiny size
# ----------------------------------------------------------------------


@pytest.fixture
def fault_hits_kept():
    """The server in the phase counts its /generate calls in the port's
    process-global fault injector; give the counts back as they were, so
    tests later in this process that compare them across packages see
    only their own calls."""
    from areal_tpu_torch.base.fault_injection import faults

    with faults._lock:
        saved = dict(faults._hits)
    yield
    with faults._lock:
        faults._hits.clear()
        faults._hits.update(saved)


def test_spec_phase_runs_on_the_cpu(fault_hits_kept):
    """The phase's legs at a tiny size: (a) greedy, plain against
    speculative, (b) sampled, (c) the int8 pool, speculation and int8
    weights in one engine, then a server with both taking a wave and a
    weight update. Its gates run here as on the card, the launch counts
    aside (the CPU runs the plain versions)."""
    cfg = TransformerConfig(**dict(TINY, vocab_size=512, max_position_embeddings=2048,
                                   hidden_dim=64, n_q_heads=4, n_kv_heads=2, head_dim=16))
    from areal_tpu_torch.models.transformer import init_params as port_init

    params = port_init(cfg, seed=0, device="cpu")
    stats = chip_smoke.spec_phase(torch, np.random.default_rng(0), torch.device("cpu"), cfg,
                                  params, 0, "cpu", sizes=chip_smoke.SPEC_TINY)
    assert stats["greedy"]["spec_tokens_per_step"] > 1.0
    assert set(stats["decode_tok_s"]) == {"bf16", "int8_weights", "spec", "spec_int8_weights"}
    assert stats["server"]["spec_emitted_tokens"] > stats["server"]["spec_active_steps"]
