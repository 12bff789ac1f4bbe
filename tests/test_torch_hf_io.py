"""Port parity of HF checkpoint IO: a directory the port's
``save_hf_model`` writes loads in the reference to bit-equal float32
params and an equal config, and the other way round, for llama and
qwen2; both write the same ``config.json``; a bf16 checkpoint loads in
the port as its bf16 values in float32."""

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
