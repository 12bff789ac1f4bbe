"""Port parity: the packed transformer forward and the HF conversion of
areal_tpu_torch against areal_tpu.

Params come from the reference's init_params (random biases and norm
weights added with numpy, so those paths carry signal), carried into the
port by ``params_from_numpy``; both packages run the same packed rows in
float32. Logits and the returned per-layer k/v agree to rtol 1e-4,
atol 1e-5 (same math, different libraries' matmul and reduction
orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.models import transformer as jt
from areal_tpu.models.config import TransformerConfig as JaxConfig
from areal_tpu.models.hf import get_family
from areal_tpu_torch.convert import params_from_numpy, params_to_numpy
from areal_tpu_torch.models import transformer as tt
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.hf import qwen2 as tq

RTOL, ATOL = 1e-4, 1e-5

BASE = dict(n_layers=2, hidden_dim=32, n_q_heads=4, n_kv_heads=2, head_dim=8,
            intermediate_dim=48, vocab_size=96, max_position_embeddings=64,
            compute_dtype="float32", param_dtype="float32")
VARIANTS = {
    "qkv_bias": dict(attn_bias=True),
    "qk_norm": dict(qk_norm=True, rotary_interleaved=True),
    "learned_pos_layer_norm": dict(
        pos_emb="learned", norm_type="layer", norm_eps=1e-5, mlp_type="plain",
        activation="gelu", attn_out_bias=True, mlp_bias=True, attn_bias=True),
    "tied_embeddings": dict(tied_embeddings=True, embedding_multiplier=5.0,
                            rotary_scaling=8.0, rotary_scaling_type="llama3",
                            rotary_scaling_params={"original_max_position_embeddings": 16}),
    "critic": dict(is_critic=True),
}


def numpy_params(jcfg, seed):
    """Reference init, with every zero/one-initialised leaf (biases, norm
    weights) replaced by random values."""
    tree = jax.tree_util.tree_map(np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        name = jax.tree_util.keystr(path)
        if any(s in name for s in ("'b", "norm", "ln1", "ln2")):
            return (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(perturb, tree)


def packed_batch(seed, vocab):
    rng = np.random.default_rng(seed)
    R, T = 2, 24
    seg = np.zeros((R, T), np.int32)
    pos = np.zeros((R, T), np.int32)
    for r, lens in enumerate(([9, 7, 5], [20])):
        t = 0
        for s, n in enumerate(lens):
            seg[r, t:t + n] = s + 1
            pos[r, t:t + n] = np.arange(n)
            t += n
    ids = rng.integers(0, vocab, size=(R, T)).astype(np.int32)
    return ids, seg, pos


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_reference(variant):
    kw = {**BASE, **VARIANTS[variant]}
    jcfg, tcfg = JaxConfig(**kw), TransformerConfig(**kw)
    tree = numpy_params(jcfg, seed=len(variant))
    ids, seg, pos = packed_batch(1, jcfg.vocab_size)
    want, (wk, wv) = jt.forward(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                                jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(pos),
                                return_kv=True)
    params = params_from_numpy(tree, device="cpu")
    got, (gk, gv) = tt.forward(params, tcfg, torch.from_numpy(ids),
                               torch.from_numpy(seg), torch.from_numpy(pos),
                               return_kv=True, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=RTOL, atol=ATOL)


def test_params_from_numpy_keeps_tree_and_layout():
    jcfg = JaxConfig(**BASE, attn_bias=True)
    tree = numpy_params(jcfg, seed=3)
    params = params_from_numpy(tree, device="cpu", dtype=torch.float32)
    back = params_to_numpy(params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    bf = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert bf["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert bf["layers"]["attn"]["wk"].shape == (2, 32, 16)  # [L, in, out]


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": np.zeros(2, np.float32)})  # device defaults to cuda
    cfg = TransformerConfig(**BASE)
    params = params_from_numpy(numpy_params(JaxConfig(**BASE), seed=4), device="cpu")
    ids, seg, pos = (torch.from_numpy(a) for a in packed_batch(2, cfg.vocab_size))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.forward(params, cfg, ids, seg, pos)  # device defaults to cuda


def _tiny_qwen2_hf():
    return {"model_type": "qwen2", "num_hidden_layers": 2, "hidden_size": 32,
            "num_attention_heads": 4, "num_key_value_heads": 2,
            "intermediate_size": 48, "vocab_size": 96,
            "max_position_embeddings": 128, "rope_theta": 1000000.0,
            "rms_norm_eps": 1e-6, "tie_word_embeddings": False, "hidden_act": "silu"}


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_qwen2_config_from_hf_matches_reference():
    hf = _tiny_qwen2_hf()
    assert _fields(tq.config_from_hf(hf)) == _fields(get_family("qwen2").config_from_hf(hf, False))
    r1 = tq.r1_distill_qwen_1_5b_config()
    ref = _fields(get_family("qwen2").config_from_hf(tq.R1_DISTILL_QWEN_1_5B_HF, False))
    ref.update(param_dtype="bfloat16", compute_dtype="bfloat16")
    assert _fields(r1) == ref
    assert (r1.n_layers, r1.hidden_dim, r1.n_q_heads, r1.n_kv_heads, r1.head_dim,
            r1.intermediate_dim, r1.vocab_size, r1.attn_bias, r1.tied_embeddings) == (
        28, 1536, 12, 2, 128, 8960, 151936, True, False)


def test_qwen2_state_dict_conversion_matches_reference():
    hf = _tiny_qwen2_hf()
    cfg = tq.config_from_hf(hf)
    rng = np.random.default_rng(5)
    D, F, V, q, kv = 32, 48, 96, 32, 16
    shapes = {"model.embed_tokens.weight": (V, D), "model.norm.weight": (D,),
              "lm_head.weight": (V, D)}
    for i in range(2):
        p = f"model.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (D,), p + "post_attention_layernorm.weight": (D,),
            p + "self_attn.q_proj.weight": (q, D), p + "self_attn.q_proj.bias": (q,),
            p + "self_attn.k_proj.weight": (kv, D), p + "self_attn.k_proj.bias": (kv,),
            p + "self_attn.v_proj.weight": (kv, D), p + "self_attn.v_proj.bias": (kv,),
            p + "self_attn.o_proj.weight": (D, q), p + "mlp.gate_proj.weight": (F, D),
            p + "mlp.up_proj.weight": (F, D), p + "mlp.down_proj.weight": (D, F),
        })
    sd = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    want = get_family("qwen2").params_from_hf(sd, get_family("qwen2").config_from_hf(hf, False))
    got = params_to_numpy(tq.params_from_hf({k: torch.from_numpy(v) for k, v in sd.items()}, cfg))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
