"""Port parity of the in-framework generator (``models/generation.py``),
``TorchTrainEngine.generate`` and the engine's offload.

The same numpy params (the reference's ``init_params``, float32 compute)
and prompts go through both packages on the CPU.

- Greedy ``generate_tokens``: equal tokens, ``no_eos`` and lengths,
  logprobs within atol 1e-4, over ragged prompts, EOS plus extra stop
  ids, ``min_new_tokens`` forbidding the stop set, and the
  ``max_new_tokens`` cap.
- Sampled generation: a generator seed gives the same tokens twice, and
  each reported logprob equals the port's forward logprob of that token
  within 1e-4 (the unwarped distribution, also under top-k / top-p). The
  sampled tokens themselves differ from the reference's by design (a
  ``torch.Generator`` against a JAX key).
- The decode path: on the CPU the generator's attention is the paged
  pool's plain version, equal to the dense ``decode_attention`` within
  1e-6, and the dense version is never called; a tensor that is not on
  the CPU (``meta`` here) reaches the kernel wrapper, which refuses it,
  and the dense version refuses it too.
- ``TorchTrainEngine.generate`` against ``JaxTrainEngine.generate`` with
  ``gconfig.n=2``, greedy: equal tokens and lengths, logprobs within
  1e-4, the call counter advanced the same way.
- Offload: the forward after the lazy restore is bit-equal to the one
  before; ``get_params`` / ``get_opt_state`` answer from the host copies
  meanwhile; ``set_params`` while offloaded keeps the AdamW moments; a
  train step after a restore equals one without the offload.
"""

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api.data_api import MicroBatchSpec as JMicroBatchSpec
from areal_tpu.api.data_api import SequenceSample as JSequenceSample
from areal_tpu.api.model_api import GenerationHyperparameters as JGen
from areal_tpu.models import generation as jgen
from areal_tpu.models import transformer as jt
from areal_tpu.models.config import TransformerConfig as JaxConfig
from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import GenerationHyperparameters as TGen
from areal_tpu_torch.convert import params_from_numpy, params_to_numpy
from areal_tpu_torch.engine import paged
from areal_tpu_torch.engine.optimizer import OptimizerConfig, tree_leaves
from areal_tpu_torch.engine.torch_engine import TorchTrainEngine
from areal_tpu_torch.models import generation as tgen
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.transformer import forward
from areal_tpu_torch.ops import attention as tattn

CFG = dict(n_layers=2, hidden_dim=32, n_q_heads=4, n_kv_heads=2, head_dim=8,
           intermediate_dim=64, vocab_size=97, max_position_embeddings=512,
           attn_bias=True, compute_dtype="float32", param_dtype="float32")
EOS = 5


def numpy_params(seed=0):
    tree = jt.init_params(JaxConfig(**CFG), jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG["vocab_size"], n).tolist() for n in lens]


GREEDY_CASES = {
    "ragged": (dict(max_new_tokens=24), (5, 17, 70, 3, 64)),
    "eos_and_stop_ids": (dict(max_new_tokens=24, stop_token_ids=[3, 7, 11]), (9, 30, 2, 41)),
    "min_new_forbids_stops": (dict(max_new_tokens=24, min_new_tokens=10,
                                   stop_token_ids=[3, 7, 11]), (9, 30, 2, 41)),
    "max_new_cap": (dict(max_new_tokens=3), (12, 65, 1)),
}


@pytest.fixture(scope="module")
def tree():
    return numpy_params()


def _both(tree, prompt_list, kw, seed=1):
    want = jgen.generate_tokens(tree, JaxConfig(**CFG), prompt_list, JGen(greedy=True, **kw),
                                jax.random.PRNGKey(0), eos_token_id=EOS)
    got = tgen.generate_tokens(params_from_numpy(tree, device="cpu"), TransformerConfig(**CFG),
                               prompt_list, TGen(greedy=True, **kw),
                               torch.Generator().manual_seed(seed), eos_token_id=EOS)
    return got, want


@pytest.mark.parametrize("case", sorted(GREEDY_CASES))
def test_greedy_generate_tokens_matches_reference(tree, case):
    kw, lens = GREEDY_CASES[case]
    got, want = _both(tree, prompts(3, lens), kw)
    assert len(got) == len(want) == len(lens)
    for g, w in zip(got, want):
        assert g["output_ids"] == w["output_ids"]
        assert g["no_eos"] == w["no_eos"]
        assert len(g["output_logprobs"]) == len(w["output_logprobs"]) == len(g["output_ids"])
        np.testing.assert_allclose(g["output_logprobs"], w["output_logprobs"], atol=1e-4)
    stops = set(kw.get("stop_token_ids", [])) | {EOS}
    for g in got:
        ids = g["output_ids"]
        # A finished row ends on its stop token, which it counts; a capped
        # one has max_new_tokens and no stop.
        if g["no_eos"]:
            assert len(ids) == kw["max_new_tokens"] and not stops & set(ids)
        else:
            assert ids[-1] in stops and not stops & set(ids[:-1])
            assert len(ids) >= kw.get("min_new_tokens", 0) + 1
    if case == "min_new_forbids_stops":
        # Without the forbid some rows stop inside the first 10 tokens.
        free, _ = _both(tree, prompts(3, lens), dict(kw, min_new_tokens=0))
        assert any(not g["no_eos"] and len(g["output_ids"]) <= 10 for g in free)


def _forward_logprobs(params, prompt, out_ids):
    """The port's forward logprob of each generated token."""
    full = torch.tensor([prompt + out_ids], dtype=torch.int32)
    T = full.shape[1]
    seg = torch.ones_like(full)
    pos = torch.arange(T, dtype=torch.int32)[None]
    logits = forward(params, TransformerConfig(**CFG), full, seg, pos, device="cpu")[0]
    logp = torch.log_softmax(logits.float(), dim=-1)
    idx = torch.arange(len(prompt) - 1, T - 1)
    return logp[idx, full[0, len(prompt):].long()].numpy()


@pytest.mark.parametrize("warp", [dict(temperature=1.0), dict(temperature=0.7, top_k=5),
                                  dict(temperature=1.3, top_p=0.8)])
def test_sampled_generation_is_seeded_and_reports_forward_logprobs(tree, warp):
    params = params_from_numpy(tree, device="cpu")
    plist = prompts(4, (6, 33, 12))
    gcfg = TGen(max_new_tokens=16, **warp)
    runs = [tgen.generate_tokens(params, TransformerConfig(**CFG), plist, gcfg,
                                 torch.Generator().manual_seed(s), eos_token_id=EOS)
            for s in (7, 7, 8)]
    assert [r["output_ids"] for r in runs[0]] == [r["output_ids"] for r in runs[1]]
    assert [r["output_ids"] for r in runs[0]] != [r["output_ids"] for r in runs[2]]
    for p, r in zip(plist, runs[0]):
        np.testing.assert_allclose(r["output_logprobs"],
                                   _forward_logprobs(params, p, r["output_ids"]), atol=1e-4)


def _pool_case(seed=0, B=3, S=40, pg=16):
    """One dense cache and the same KV in a page pool (rows on scattered
    pages), lengths including the new token."""
    g = torch.Generator().manual_seed(seed)
    Hq, Hkv, hd = CFG["n_q_heads"], CFG["n_kv_heads"], CFG["head_dim"]
    q = torch.randn(B, Hq, hd, generator=g)
    k = torch.randn(B, S, Hkv, hd, generator=g)
    v = torch.randn(B, S, Hkv, hd, generator=g)
    lengths = torch.tensor([1, 17, S], dtype=torch.int32)[:B]
    n = S // pg + 1
    order = torch.randperm(B * n, generator=g) + 1
    table = order.reshape(B, n).to(torch.int32)
    pools = [torch.zeros(Hkv, 1 + B * n, pg, hd) for _ in range(2)]
    for pool, x in zip(pools, (k, v)):
        padded = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n * pg - S))
        pool[:, table.long()] = padded.reshape(B, n, pg, Hkv, hd).permute(3, 0, 1, 2, 4)
    return q, k, v, lengths, pools, table


def test_paged_plain_decode_equals_the_dense_decode_attention():
    q, k, v, lengths, (kp, vp), table = _pool_case()
    dense = tattn.decode_attention(q, k, v, lengths)
    got = paged.paged_decode_attention(q, kp, vp, lengths, table)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-6)


def test_decode_attention_off_the_cpu_reaches_the_kernel_or_raises():
    q, k, v, lengths, (kp, vp), table = _pool_case()
    meta = [t.to("meta") for t in (q, k, v, lengths, kp, vp, table)]
    with pytest.raises(ValueError, match="CPU tensors only"):
        tattn.decode_attention(*meta[:4])
    # The paged wrapper hands a non-CPU tensor to the kernel path, whose
    # checks refuse it before any launch.
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        paged.paged_decode_attention(meta[0], meta[4], meta[5], meta[3], meta[6])


def test_generator_decodes_through_the_paged_plain_version_only(tree, monkeypatch):
    calls = {"paged_plain": 0, "dense": 0}
    plain = paged._paged_attention_xla

    def counting_plain(*a, **k):
        calls["paged_plain"] += 1
        return plain(*a, **k)

    def refusing_dense(*a, **k):
        calls["dense"] += 1
        raise AssertionError("the generator called the dense decode_attention")

    monkeypatch.setattr(paged, "_paged_attention_xla", counting_plain)
    monkeypatch.setattr(tattn, "decode_attention", refusing_dense)
    out = tgen.generate_tokens(params_from_numpy(tree, device="cpu"), TransformerConfig(**CFG),
                               prompts(5, (4, 9)), TGen(greedy=True, max_new_tokens=6),
                               torch.Generator().manual_seed(0))
    # One decode step per generated token but the last, one call a layer.
    assert calls == {"paged_plain": CFG["n_layers"] * 5, "dense": 0}
    assert all(len(o["output_ids"]) == 6 for o in out)


def _prompt_sample(cls, plist):
    return cls.from_default(
        ids=[f"p{i}" for i in range(len(plist))], seqlens=[len(p) for p in plist],
        data={"packed_prompts": np.concatenate([np.asarray(p, np.int32) for p in plist])})


class _Tok:
    eos_token_id = EOS


def test_engine_generate_matches_reference_engine(tree):
    from areal_tpu.engine.jax_engine import JaxTrainEngine

    plist = prompts(6, (7, 21, 50))
    jeng = JaxTrainEngine(JaxConfig(**CFG), jax.tree_util.tree_map(jax.numpy.asarray, tree),
                          optimizer_config=None, row_len_multiple=32)
    teng = TorchTrainEngine(TransformerConfig(**CFG), params_from_numpy(tree, device="cpu"),
                            row_len_multiple=32, device="cpu")
    for _ in range(2):  # the counter advances on each call in both
        want = jeng.generate(_prompt_sample(JSequenceSample, plist), JMicroBatchSpec(), _Tok(),
                             JGen(n=2, greedy=True, max_new_tokens=12))
        got = teng.generate(_prompt_sample(SequenceSample, plist), MicroBatchSpec(), _Tok(),
                            TGen(n=2, greedy=True, max_new_tokens=12))
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert g["output_ids"] == w["output_ids"] and g["no_eos"] == w["no_eos"]
            np.testing.assert_allclose(g["output_logprobs"], w["output_logprobs"], atol=1e-4)
        # Replicas of one prompt sit next to each other.
        assert got[0]["output_ids"] == got[1]["output_ids"]
    assert teng.rng_state()["gen_calls"] == jeng.rng_state()["gen_calls"] == 2


def _train_engine(tree):
    return TorchTrainEngine(TransformerConfig(**CFG), params_from_numpy(tree, device="cpu"),
                            optimizer_config=OptimizerConfig(lr=1e-3), total_train_steps=10,
                            row_len_multiple=32, device="cpu")


def _sft_step(engine, seed=0):
    from areal_tpu_torch.interfaces import sft

    rng = np.random.RandomState(seed)
    lens = rng.randint(6, 30, size=5).tolist()
    ids = rng.randint(0, CFG["vocab_size"], size=sum(lens))
    pm = np.concatenate([(np.arange(n) < 2).astype(np.int64) for n in lens])
    sample = SequenceSample.from_default(ids=[f"s{i}" for i in range(5)], seqlens=lens,
                                         data={"packed_input_ids": ids, "prompt_mask": pm})
    from areal_tpu_torch.api.model_api import Model, ModelName

    return sft.SFTInterface().train_step(Model(ModelName("m"), engine, None), sample,
                                         MicroBatchSpec())


def _logprobs(engine):
    plist = prompts(8, (9, 14))
    sample = SequenceSample.from_default(
        ids=["a", "b"], seqlens=[len(p) for p in plist],
        data={"packed_input_ids": np.concatenate([np.asarray(p) for p in plist])})
    return engine.forward(sample, MicroBatchSpec()).data["logprobs"]


def test_offload_restores_lazily_and_bit_equal(tree):
    eng = _train_engine(tree)
    _sft_step(eng, 0)
    before = _logprobs(eng)
    params_before = params_to_numpy(eng.get_params())
    mu_before = [m.clone() for m in eng.optimizer.mu]
    eng.offload()
    assert eng.params is None and eng._offloaded
    # While offloaded the host copies answer.
    host = params_to_numpy(eng.get_params())
    for a, b in zip(tree_leaves(host), tree_leaves(params_before)):
        np.testing.assert_array_equal(a, b)
    adam = eng.get_opt_state()[1][0]
    for a, b in zip(tree_leaves(adam.mu), mu_before):
        assert torch.equal(torch.as_tensor(a), b)
    after = _logprobs(eng)  # restores on the call
    assert not eng._offloaded and eng.params is not None
    np.testing.assert_array_equal(after, before)
    # A train step after an offload and restore equals one without.
    twin = _train_engine(tree)
    _sft_step(twin, 0)
    eng.offload()
    got, want = _sft_step(eng, 1), _sft_step(twin, 1)
    assert got == want
    for a, b in zip(tree_leaves(eng.get_params()), tree_leaves(twin.get_params())):
        assert torch.equal(a, b)


def test_set_params_while_offloaded_keeps_the_moments(tree):
    eng = _train_engine(tree)
    _sft_step(eng, 0)
    mu, nu = [m.clone() for m in eng.optimizer.mu], [m.clone() for m in eng.optimizer.nu]
    eng.offload()
    new = numpy_params(seed=3)
    eng.set_params(new)
    assert not eng._offloaded
    for a, b in zip(eng.optimizer.mu + eng.optimizer.nu, mu + nu):
        assert a.device == b.device and torch.equal(a, b)
    for a, b in zip(tree_leaves(params_to_numpy(eng.get_params())), tree_leaves(new)):
        np.testing.assert_array_equal(a, b)
    # drop_offloaded_state discards the host copies: the moments come back
    # as zeros for a full state load to fill.
    eng.offload()
    eng.drop_offloaded_state()
    assert all(not m.any() for m in eng.optimizer.mu + eng.optimizer.nu)
