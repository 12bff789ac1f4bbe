"""The packed transformer forward (counterpart of
``areal_tpu/models/transformer.py``).

Params keep the reference's tree: a dict with ``embedding/weight``,
``layers/{ln1,ln2,attn,mlp}/...`` whose leaves carry a leading layer axis
``L``, ``final_norm`` and (untied actor or critic) ``head``; matmul
weights are ``[in, out]``. The reference scans over the stacked layers
with ``lax.scan``; here a Python loop walks per-layer views of each leaf
(one ``unbind`` per leaf and forward, so the backward writes each stacked
gradient once, as one stack).

A batch is ``[R, T]`` packed rows tagged with segment ids (0 = padding)
and per-token positions. Compute runs in ``cfg.compute_dtype``; logits
are float32. ``forward`` is differentiable in the params; ``remat="full"``
recomputes each layer in the backward (``torch.utils.checkpoint``). There
is no mesh in the port.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from areal_tpu_torch import resolve_device, torch_dtype
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.ops.attention import packed_attention
from areal_tpu_torch.ops.norms import layer_norm, rms_norm
from areal_tpu_torch.ops.rotary import apply_rotary, rotary_cos_sin, rotary_inv_freq
from areal_tpu_torch.ops.wquant import qmat

Params = Dict[str, Any]


def init_params(cfg: TransformerConfig, seed: int, device="cuda",
                dtype: Optional[torch.dtype] = None) -> Params:
    """Random params in the reference's layout and scales (normal /
    sqrt(fan_in) for matmuls, 0.02 for embeddings and head, zero biases,
    unit norms), drawn leaf by leaf from ``numpy.random.default_rng(seed)``
    and moved to ``device`` one leaf at a time, so host memory holds one
    leaf at once. ``dtype`` defaults to ``cfg.param_dtype``."""
    if cfg.moe is not None:
        raise NotImplementedError("MoE models are not ported yet")
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.param_dtype)
    rng = np.random.default_rng(seed)
    D, Fd, V, L = cfg.hidden_dim, cfg.intermediate_dim, cfg.vocab_size, cfg.n_layers

    def put(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(device=device).to(dtype)

    def dense(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        x = rng.standard_normal(shape, dtype=np.float32)
        x *= np.float32(scale)
        return put(x)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    attn = {
        "wq": dense((L, D, cfg.q_dim)),
        "wk": dense((L, D, cfg.kv_dim)),
        "wv": dense((L, D, cfg.kv_dim)),
        "wo": dense((L, cfg.q_dim, D)),
    }
    if cfg.attn_bias:
        attn["bq"] = const((L, cfg.q_dim), 0.0)
        attn["bk"] = const((L, cfg.kv_dim), 0.0)
        attn["bv"] = const((L, cfg.kv_dim), 0.0)
    if cfg.attn_out_bias:
        attn["bo"] = const((L, D), 0.0)
    if cfg.qk_norm:
        attn["q_norm"] = const((L, cfg.head_dim), 1.0)
        attn["k_norm"] = const((L, cfg.head_dim), 1.0)
    if cfg.mlp_type == "gated":
        mlp = {"w_gate": dense((L, D, Fd)), "w_up": dense((L, D, Fd)),
               "w_down": dense((L, Fd, D))}
        if cfg.mlp_bias:
            mlp.update(b_gate=const((L, Fd), 0.0), b_up=const((L, Fd), 0.0),
                       b_down=const((L, D), 0.0))
    else:
        mlp = {"w_in": dense((L, D, Fd)), "w_out": dense((L, Fd, D))}
        if cfg.mlp_bias:
            mlp.update(b_in=const((L, Fd), 0.0), b_out=const((L, D), 0.0))
    layers = {"ln1": {"weight": const((L, D), 1.0)},
              "ln2": {"weight": const((L, D), 1.0)}, "attn": attn, "mlp": mlp}
    params: Params = {
        "embedding": {"weight": dense((V, D), scale=0.02)},
        "layers": layers,
        "final_norm": {"weight": const((D,), 1.0)},
    }
    if cfg.norm_type == "layer":
        layers["ln1"]["bias"] = const((L, D), 0.0)
        layers["ln2"]["bias"] = const((L, D), 0.0)
        params["final_norm"]["bias"] = const((D,), 0.0)
    if cfg.pos_emb == "learned":
        params["pos_embedding"] = {
            "weight": dense((cfg.max_position_embeddings, D), scale=0.02)}
    if cfg.is_critic:
        params["head"] = {"weight": dense((D, 1), scale=0.02)}
    elif not cfg.tied_embeddings:
        params["head"] = {"weight": dense((D, V), scale=0.02)}
    return params


def count_params(params: Params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i`` of the stacked layer tree (views into the leaves)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def unbind_layers(layers: Params, n_layers: int) -> List[Params]:
    """The stacked layer tree as a list of per-layer trees: one ``unbind``
    per leaf (views), whose backward is one stack per leaf. Indexing layer
    ``i`` out of a leaf instead would, in the backward, allocate a zero
    tensor of the whole stacked leaf per layer."""
    out: List[Params] = [{} for _ in range(n_layers)]
    for k, v in layers.items():
        parts = unbind_layers(v, n_layers) if isinstance(v, dict) else v.unbind(0)
        for i in range(n_layers):
            out[i][k] = parts[i]
    return out


def norm(x, p, cfg: TransformerConfig):
    if cfg.norm_type == "rms":
        return rms_norm(x, p["weight"], cfg.norm_eps)
    return layer_norm(x, p["weight"], p.get("bias"), cfg.norm_eps)


def _act(x, cfg: TransformerConfig):
    # jax.nn.gelu defaults to the tanh approximation.
    return F.silu(x) if cfg.activation == "silu" else F.gelu(x, approximate="tanh")


def mlp(h, lp, cfg: TransformerConfig, cdt):
    if cfg.mlp_type == "gated":
        g = qmat(h, lp["w_gate"], cdt)
        u = qmat(h, lp["w_up"], cdt)
        if "b_gate" in lp:
            g = g + lp["b_gate"].to(cdt)
            u = u + lp["b_up"].to(cdt)
        out = qmat(_act(g, cfg) * u, lp["w_down"], cdt)
        if "b_down" in lp:
            out = out + lp["b_down"].to(cdt)
    else:
        u = qmat(h, lp["w_in"], cdt)
        if "b_in" in lp:
            u = u + lp["b_in"].to(cdt)
        out = qmat(_act(u, cfg), lp["w_out"], cdt)
        if "b_out" in lp:
            out = out + lp["b_out"].to(cdt)
    return out


def qkv(h, a, cfg: TransformerConfig, cdt, cos, sin):
    """Projections, qk-norm and rotary: h [..., D] -> q [..., Hq, hd],
    k and v [..., Hkv, hd]. Shared by the packed forward and the paged
    decode step."""
    q = qmat(h, a["wq"], cdt)
    k = qmat(h, a["wk"], cdt)
    v = qmat(h, a["wv"], cdt)
    if "bq" in a:
        q = q + a["bq"].to(cdt)
        k = k + a["bk"].to(cdt)
        v = v + a["bv"].to(cdt)
    lead = h.shape[:-1]
    q = q.reshape(*lead, cfg.n_q_heads, cfg.head_dim)
    k = k.reshape(*lead, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(*lead, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, a["q_norm"], cfg.norm_eps)
        k = rms_norm(k, a["k_norm"], cfg.norm_eps)
    if cos is not None:
        q = apply_rotary(q, cos, sin, cfg.rotary_interleaved)
        k = apply_rotary(k, cos, sin, cfg.rotary_interleaved)
    return q, k, v


def attn_out(o, a, cfg: TransformerConfig, cdt):
    """Output projection of attention o [..., Hq, hd] -> [..., D]."""
    out = qmat(o.reshape(*o.shape[:-2], cfg.q_dim), a["wo"], cdt)
    if "bo" in a:
        out = out + a["bo"].to(cdt)
    return out


@functools.lru_cache(maxsize=64)
def _inv_freq(head_dim, base, scaling, scaling_type, scaling_items, device):
    # Cached per device: a host->device copy from pageable memory waits
    # for the stream, and embed runs once per decode step.
    return torch.from_numpy(rotary_inv_freq(
        head_dim, base, scaling, scaling_type,
        dict(scaling_items) if scaling_items else None)).to(device)


def embed(params, cfg: TransformerConfig, input_ids, positions, cdt):
    """Token (and learned position) embedding plus the rotary cos/sin of
    ``positions`` (None for learned position embeddings)."""
    x = params["embedding"]["weight"][input_ids].to(cdt)
    if cfg.embedding_multiplier:
        # The multiplier rounded to the compute dtype first, as the
        # reference multiplies by jnp.asarray(multiplier, cdt).
        x = x * float(torch.tensor(cfg.embedding_multiplier, dtype=cdt))
    if cfg.pos_emb == "learned":
        return x + params["pos_embedding"]["weight"][positions].to(cdt), None, None
    p = cfg.rotary_scaling_params
    inv_freq = _inv_freq(cfg.head_dim, cfg.rotary_base, cfg.rotary_scaling,
                         cfg.rotary_scaling_type,
                         tuple(sorted(p.items())) if p else None, x.device)
    cos, sin = rotary_cos_sin(positions, inv_freq)
    return x, cos, sin


def lm_head(params, cfg: TransformerConfig, x, cdt) -> torch.Tensor:
    """Final-normed hidden [..., D] -> float32 logits [..., V] (critic:
    values [...])."""
    if cfg.is_critic:
        return (x @ params["head"]["weight"].to(cdt)).float()[..., 0]
    head_w = (params["embedding"]["weight"].T if cfg.tied_embeddings
              else params["head"]["weight"])
    return (x @ head_w.to(cdt)).float()


def forward(
    params: Params,
    cfg: TransformerConfig,
    input_ids: torch.Tensor,  # [R, T] int32
    segment_ids: torch.Tensor,  # [R, T] int32, 0 = padding
    positions: torch.Tensor,  # [R, T] int32
    output: str = "logits",  # logits | hidden
    return_kv: bool = False,
    remat: Any = False,  # False / "none" | True / "full"
    device="cuda",
):
    """Packed-rows forward. Returns logits [R, T, V] float32 (critic
    values [R, T]), or the final-normed hidden states with
    ``output="hidden"``; with ``return_kv`` also the per-layer post-rotary
    (k, v), each stacked [L, R, T, Hkv, hd], for prefill. With
    ``remat="full"`` and gradients enabled each layer keeps only its input
    and is recomputed in the backward. Params and inputs must live on
    ``device``."""
    if cfg.moe is not None:
        raise NotImplementedError("MoE models are not ported yet")
    remat_mode = {True: "full", False: "none"}.get(remat, remat)
    if remat_mode not in ("full", "none"):
        raise ValueError(f"unknown remat mode {remat!r} (the port has 'full' and 'none')")
    device = resolve_device(device)
    for name, t in (("input_ids", input_ids), ("params", params["embedding"]["weight"])):
        if t.device != device:
            raise ValueError(f"forward on {device}: {name} lives on {t.device}")
    cdt = torch_dtype(cfg.compute_dtype)
    x, cos, sin = embed(params, cfg, input_ids, positions, cdt)

    def layer_body(lp, x):
        q, k, v = qkv(norm(x, lp["ln1"], cfg), lp["attn"], cfg, cdt, cos, sin)
        o = packed_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             segment_ids, positions)
        x = x + attn_out(o, lp["attn"], cfg, cdt)
        x = x + mlp(norm(x, lp["ln2"], cfg), lp["mlp"], cfg, cdt)
        return x, k, v

    use_remat = remat_mode == "full" and torch.is_grad_enabled()
    ks, vs = [], []
    for lp in unbind_layers(params["layers"], cfg.n_layers):
        body = functools.partial(layer_body, lp)
        x, k, v = checkpoint(body, x, use_reentrant=False) if use_remat else body(x)
        if return_kv:
            ks.append(k)
            vs.append(v)
    x = norm(x, params["final_norm"], cfg)
    out = x if output == "hidden" else lm_head(params, cfg, x, cdt)
    if return_kv:
        return out, (torch.stack(ks), torch.stack(vs))
    return out
