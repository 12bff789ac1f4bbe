"""Per-channel int8 weights for the serving DECODE path, W8A16
(counterpart of ``areal_tpu/ops/wquant.py``).

Decode at small batch streams every weight once a step. An int8 copy of
the decode-path matmul weights halves that stream; activations, norms,
biases, the embedding lookup and every PREFILL path stay in the model's
dtype (prefill runs the unquantized params, so prompt processing is
identical to the unquantized engine). Opt-in through
``ServingEngine(decode_weight_dtype="int8")``.

Convention: ``w ~= w_q * scale`` with ``scale = absmax(w, input dim) /
127`` per output channel (symmetric int8, no round(127.5) wrap), so the
dequantization commutes with the matmul: ``h @ (w_q * s) == (h @ w_q) *
s``, and ``qmat`` scales the OUTPUT.

On the TPU the reference leaves the int8-to-bf16 convert to XLA, which
folds it into the matmul's operand read. PyTorch has no such fusion, so
``qmat`` launches the hand-written W8A16 kernel (``csrc/w8a16_matmul.cu``)
for CUDA tensors, and runs the plain version
``(h @ w_q.to(cdt)) * s.to(cdt)`` for CPU tensors only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from areal_tpu_torch import kernels

_Q = 127.0  # symmetric int8 range used for weights (no round(127.5) wrap)
_INV_Q = float(torch.tensor(1.0 / _Q, dtype=torch.float32))  # 1/127 rounded to float32

# Decode-path matmul weight names (attention projections + dense MLP).
_QUANT_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_in", "w_out"}
)

# The kernel's tile (csrc/w8a16_matmul.cu): columns a CTA, K depth of a
# chunk, rows of an M block.
BN, BK, MB = 64, 64, 128


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., in, out] float -> (int8 [..., in, out], float32 scale [...,
    out]). The reference's serving engine runs its quantize under jit,
    where XLA turns the division by 127 into a product with the float32
    reciprocal; the scale here is that product, and ``torch.round`` rounds
    half to even as ``jnp.round`` does, so codes and scales equal the tree
    the reference serves, bit for bit, from the same float32 input."""
    w32 = w.float()
    s = torch.clamp(w32.abs().amax(dim=-2), min=1e-8) * _INV_Q
    q = torch.clamp(torch.round(w32 / s[..., None, :]), -_Q, _Q).to(torch.int8)
    return q.contiguous(), s


def _qmat_plain(h: torch.Tensor, wq: torch.Tensor, s: torch.Tensor, cdt) -> torch.Tensor:
    """The plain version: dequantize to the compute dtype, matmul, scale."""
    return (h @ wq.to(cdt)) * s.to(cdt)


# CTAs a launch aims for an SM.
CTAS_PER_SM = 2


def w8a16_plan(M: int, K: int, N: int, n_sm: int) -> Tuple[int, int]:
    """(splits, K chunks a split) of a kernel launch: about CTAS_PER_SM
    CTAs an SM over the (column slice, M block) tiles, K split in whole
    chunks of BK, no split empty. It reads the shapes and the card only,
    so the same shapes always reduce in the same order."""
    tiles = -(-N // BN) * -(-M // MB)
    k_chunks = -(-K // BK)
    want = max(1, min(k_chunks, -(-CTAS_PER_SM * n_sm // tiles)))
    per = -(-k_chunks // want)
    return -(-k_chunks // per), per


def w8a16_matmul(h: torch.Tensor, wq: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``(h @ wq) * s`` on the card: h [..., K] bf16, wq [K, N] int8 (row
    major, a per-layer view of the stacked leaf is fine), s [N] float32;
    returns bf16 [..., N]. Launches ``w8a16_matmul_bf16``."""
    if h.device.type != "cuda":
        raise ValueError(f"w8a16_matmul: expected CUDA tensors, got {h.device}")
    K, N = wq.shape[-2], wq.shape[-1]
    if h.shape[-1] != K or wq.dim() != 2 or s.shape != (N,):
        raise ValueError(f"w8a16_matmul: shapes h {tuple(h.shape)}, wq {tuple(wq.shape)}, "
                         f"s {tuple(s.shape)} do not chain")
    lead = h.shape[:-1]
    a = h.reshape(-1, K).contiguous()
    M = a.shape[0]
    if a.dtype != torch.bfloat16:
        raise ValueError(f"w8a16_matmul: activations must be bfloat16, got {a.dtype}")
    if wq.dtype != torch.int8 or not wq.is_contiguous():
        raise ValueError("w8a16_matmul: wq must be a contiguous int8 tensor")
    if s.dtype != torch.float32 or not s.is_contiguous():
        raise ValueError("w8a16_matmul: s must be a contiguous float32 tensor")
    for name, t in (("wq", wq), ("s", s)):
        if t.device != a.device:
            raise ValueError(f"w8a16_matmul: {name} lives on {t.device}, h on {a.device}")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    if M == 0:
        return out.reshape(*lead, N)
    splits, per = w8a16_plan(M, K, N, kernels.sm_count(a.device.index or 0))
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=a.device)
            if splits > 1 else None)
    vec_a = int(K % 8 == 0 and a.data_ptr() % 16 == 0)
    vec_w = int(N % 16 == 0 and wq.data_ptr() % 16 == 0)
    kernels.launch("w8a16_matmul_bf16", a, wq, s, out, part, M, K, N, splits, per,
                   vec_a, vec_w)
    return out.reshape(*lead, N)


def qmat(h: torch.Tensor, w, cdt) -> torch.Tensor:
    """``h @ w`` for a plain weight, or ``(h @ w_q) * scale`` for a
    quantized (int8, scale) pair: the W8A16 kernel for CUDA tensors (a
    bfloat16 compute dtype), the plain version for CPU tensors."""
    if isinstance(w, tuple):
        wq, s = w
        if h.device.type == "cpu":
            return _qmat_plain(h, wq, s, cdt)
        if cdt != torch.bfloat16:
            raise ValueError(f"the W8A16 kernel computes in bfloat16, not {cdt}")
        return w8a16_matmul(h.to(cdt), wq, s)
    return h @ w.to(cdt)


def quantize_decode_weights(params, tied_embeddings: bool):
    """The decode-path int8 param tree of a served param tree.

    Returns a NEW dict sharing every unquantized leaf with ``params``
    (embedding for the token lookup, norms, biases), with:
      - layers/attn wq|wk|wv|wo and dense-MLP weights -> (int8, scale)
      - "head_q": the quantized LM head ((embedding.T) for tied weights)
    Leaves keep their leading stacked-layer dim; scales reduce the input
    dim only, so per-layer slices stay aligned. The reference keeps MoE
    expert weights unquantized; the port has no MoE yet (ROADMAP Queue A,
    item 6.2) and refuses such a tree."""

    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            if k in _QUANT_KEYS and not isinstance(v, dict):
                out[k] = quantize_weight(v)
            else:
                out[k] = walk(v)
        return out

    q = dict(params)
    q["layers"] = {}
    for k, v in params["layers"].items():
        if k == "mlp" and "router" in v:
            raise NotImplementedError("MoE models are not ported yet")
        q["layers"][k] = walk(v)
    head_w = (params["embedding"]["weight"].T if tied_embeddings
              else params["head"]["weight"])
    q["head_q"] = quantize_weight(head_w)
    return q


def maybe_quantize_decode_weights(params, tied_embeddings: bool, dtype: Optional[str]):
    """The int8 decode tree for ``dtype="int8"``, None for None / "model"."""
    if dtype is None or dtype == "model":
        return None
    if dtype != "int8":
        raise ValueError(
            f"decode_weight_dtype={dtype!r}: expected None, 'model', or 'int8'")
    with torch.no_grad():
        return quantize_decode_weights(params, tied_embeddings=tied_embeddings)
