"""Port parity of HF checkpoint IO: a directory the port's
``save_hf_model`` writes loads in the reference to bit-equal float32
params and an equal config, and the other way round, for llama and
qwen2; both write the same ``config.json``; a bf16 checkpoint loads in
the port as its bf16 values in float32; the tokenizer is saved beside
the weights. For gemma, gpt2, mistral and qwen3 (configs in code,
random weights) the four mappings equal the reference's (configs as
dicts, state dicts and param trees bit for bit), and one forward of
each package on the converted weights agrees in float32 to rtol 1e-4,
atol 1e-5 (the tolerance of tests/test_torch_transformer.py)."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import areal_tpu.models.hf as rhf
from areal_tpu.models.config import TransformerConfig as RefConfig
from areal_tpu.models.transformer import init_params
from areal_tpu_torch.convert import params_from_numpy, params_to_numpy
from areal_tpu_torch.models import hf as thf
from areal_tpu_torch.models.config import TransformerConfig

CFG = dict(n_layers=2, hidden_dim=32, n_q_heads=4, n_kv_heads=2, head_dim=8,
           intermediate_dim=48, vocab_size=96, max_position_embeddings=256)
FAMILY_CFG = {"llama": dict(attn_bias=False), "qwen2": dict(attn_bias=True)}


def _tree(family, seed=0):
    cfg = RefConfig(**CFG, **FAMILY_CFG[family])
    return cfg, jax.tree_util.tree_map(np.asarray, init_params(cfg, jax.random.PRNGKey(seed)))


def _assert_trees_equal(got, want):
    flat_g, tree_g = jax.tree_util.tree_flatten(got)
    flat_w, tree_w = jax.tree_util.tree_flatten(want)
    assert tree_g == tree_w
    for a, b in zip(flat_g, flat_w):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("family", ["llama", "qwen2"])
def test_port_checkpoint_loads_in_the_reference(tmp_path, family):
    ref_cfg, tree = _tree(family)
    thf.save_hf_model(str(tmp_path), TransformerConfig(**CFG, **FAMILY_CFG[family]),
                      params_from_numpy(tree, device="cpu"), family)
    cfg, params = rhf.load_hf_model(str(tmp_path))
    assert _fields(cfg) == _fields(ref_cfg)
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, params), tree)


@pytest.mark.parametrize("family", ["llama", "qwen2"])
def test_reference_checkpoint_loads_in_the_port(tmp_path, family):
    ref_cfg, tree = _tree(family, seed=1)
    rhf.save_hf_model(str(tmp_path), ref_cfg, tree, family)
    cfg, params = thf.load_hf_model(str(tmp_path))
    assert _fields(cfg) == _fields(TransformerConfig(**CFG, **FAMILY_CFG[family]))
    _assert_trees_equal(params_to_numpy(params), tree)


@pytest.mark.parametrize("family", ["llama", "qwen2"])
def test_both_write_the_same_config_json(tmp_path, family):
    ref_cfg, tree = _tree(family)
    rhf.save_hf_model(str(tmp_path / "ref"), ref_cfg, tree, family)
    thf.save_hf_model(str(tmp_path / "port"), TransformerConfig(**CFG, **FAMILY_CFG[family]),
                      params_from_numpy(tree, device="cpu"), family)
    read = lambda side: json.load(open(os.path.join(tmp_path, side, "config.json")))  # noqa: E731
    assert read("port") == read("ref")


def test_bf16_checkpoint_loads_as_float32(tmp_path):
    cfg = TransformerConfig(**CFG, attn_bias=True)
    _, tree = _tree("qwen2", seed=2)
    bf16 = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    thf.save_hf_model(str(tmp_path), cfg, bf16, "qwen2")
    from safetensors import safe_open

    with safe_open(os.path.join(tmp_path, "model.safetensors"), "pt") as f:
        assert {f.get_tensor(k).dtype for k in f.keys()} == {torch.bfloat16}
    _, params = thf.load_hf_model(str(tmp_path))
    _assert_trees_equal(params_to_numpy(params), params_to_numpy(bf16))


def test_tokenizer_is_saved_beside_the_weights(tmp_path):
    from tests import fixtures

    rows = fixtures.make_sft_rows(8, seed=1)
    tok = fixtures.train_tiny_tokenizer([r["prompt"] for r in rows], tmp_path)
    _, tree = _tree("qwen2")
    out = tmp_path / "ckpt"
    thf.save_hf_model(str(out), TransformerConfig(**CFG, **FAMILY_CFG["qwen2"]),
                      params_from_numpy(tree, device="cpu"), "qwen2", tokenizer=tok)
    rhf.save_hf_model(str(tmp_path / "ref"), _tree("qwen2")[0], tree, "qwen2", tokenizer=tok)
    assert sorted(os.listdir(out)) == sorted(os.listdir(tmp_path / "ref"))
    assert {"tokenizer.json", "tokenizer_config.json"} <= set(os.listdir(out))
    from transformers import AutoTokenizer

    assert AutoTokenizer.from_pretrained(str(out)).eos_token_id == tok.eos_token_id


# Small configs of each dense family, as their HF config.json would read.
FAMILY_HF = {
    "gemma": dict(model_type="gemma", num_hidden_layers=2, hidden_size=32,
                  num_attention_heads=4, num_key_value_heads=1, head_dim=16,
                  intermediate_size=48, vocab_size=96, max_position_embeddings=128,
                  rms_norm_eps=1e-6, rope_theta=10000.0),
    "gpt2": dict(model_type="gpt2", n_layer=2, n_embd=32, n_head=4, n_inner=64,
                 vocab_size=96, n_positions=64, layer_norm_epsilon=1e-5),
    "mistral": dict(model_type="mistral", num_hidden_layers=2, hidden_size=32,
                    num_attention_heads=4, num_key_value_heads=2, intermediate_size=48,
                    vocab_size=96, max_position_embeddings=128, rope_theta=1e6,
                    rms_norm_eps=1e-5, hidden_act="silu", tie_word_embeddings=False,
                    sliding_window=4096),
    "qwen3": dict(model_type="qwen3", num_hidden_layers=2, hidden_size=32,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                  intermediate_size=48, vocab_size=96, max_position_embeddings=128,
                  rope_theta=1e6, rms_norm_eps=1e-6, hidden_act="silu",
                  tie_word_embeddings=False),
}


@pytest.mark.parametrize("family", sorted(FAMILY_HF))
def test_dense_family_matches_reference(tmp_path, family):
    import jax.numpy as jnp

    from areal_tpu.models import transformer as jt
    from areal_tpu_torch.models import transformer as tt
    from tests.test_torch_transformer import numpy_params, packed_batch

    hf = FAMILY_HF[family]
    rfam, tfam = rhf.get_family(family), thf.get_family(family)
    assert (thf.family_from_hf_config(hf).name, rhf.family_from_hf_config(hf).name) == (
        family, family)
    ref_cfg, cfg = rfam.config_from_hf(hf, False), tfam.config_from_hf(hf, False)
    assert _fields(cfg) == _fields(ref_cfg)
    assert tfam.config_to_hf(cfg) == rfam.config_to_hf(ref_cfg)
    ref_cfg.compute_dtype = cfg.compute_dtype = "float32"

    tree = numpy_params(ref_cfg, seed=len(family))
    ref_sd = rfam.params_to_hf(tree, ref_cfg)
    sd = tfam.params_to_hf(params_from_numpy(tree, device="cpu"), cfg)
    assert sorted(sd) == sorted(ref_sd)
    for k in ref_sd:
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(ref_sd[k]), err_msg=k)

    ref_params = rfam.params_from_hf({k: np.asarray(v) for k, v in ref_sd.items()}, ref_cfg)
    params = tfam.params_from_hf(
        {k: torch.from_numpy(np.array(v)) for k, v in ref_sd.items()}, cfg)
    _assert_trees_equal(params_to_numpy(params), jax.tree_util.tree_map(np.asarray, ref_params))

    ids, seg, pos = packed_batch(1, cfg.vocab_size)
    want = jt.forward(jax.tree_util.tree_map(jnp.asarray, ref_params), ref_cfg,
                      jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(pos))
    got = tt.forward(params, cfg, torch.from_numpy(ids), torch.from_numpy(seg),
                     torch.from_numpy(pos), device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
