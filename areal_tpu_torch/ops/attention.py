"""Packed variable-length causal attention with GQA (counterpart of
``areal_tpu/ops/attention.py`` and of ``areal_tpu/ops/pallas/flash_attn.py``,
forward and backward).

Rows are packed token streams tagged with segment ids (0 = padding,
sequences numbered from 1) and per-token positions; a token attends to
tokens of its own segment at positions at or before its own. Shapes
carry a leading row dimension R where the reference vmaps over rows:
q ``[R, T, Hq, hd]``, k/v ``[R, T, Hkv, hd]``, segment ids and positions
``[R, T]`` int32.

- ``reference_packed_attention``: the plain version, a dense einsum and
  mask. It is what runs for tensors on the CPU, and what the kernel is
  held against.
- ``reference_packed_attention_bwd``: the plain backward, which repeats
  the backward kernels' arithmetic (p from the logsumexp, p and ds rounded
  to the input dtype before the products). The kernels are held against it.
- ``flash_packed_attention``: the wrapper of the hand-written CUDA kernels,
  a ``torch.autograd.Function`` whose forward is ``csrc/flash_attn.cu``
  (tensor-core tiles, online softmax, segment-aware tile skip, saves the
  f32 logsumexp) and whose backward is the dq and dk/dv kernels of
  ``csrc/flash_attn_bwd.cu``. A CUDA tensor launches the kernels or
  raises; a CPU tensor takes the plain version, with autograd through it.
- ``tile_segment_ranges`` / ``live_tile_pairs``: the kernels'
  segment-aware tile skip, as plain PyTorch. The first is the pre-pass the
  kernels read, built once per call for the tile that both libraries
  report (``shared_tile_ranges``) and saved by the forward for the
  backward; the second is the pair predicate they apply, which the tests
  and a counting launch of each kernel are held to.
- ``packed_attention``: the model's entry, the same function. There are
  no splash, ring, Ulysses or sharded variants in the port.
- ``decode_attention``: the reference's one-token attention over a dense
  ``[B, S, Hkv, hd]`` cache, as plain PyTorch, for CPU tensors only. The
  in-framework generator (``models/generation.py``) keeps its cache in
  the serving engine's page pool and decodes through the
  ``paged_decode_bf16`` kernel (``engine/paged.paged_decode_attention``);
  this dense version is what the tests hold that path against.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from areal_tpu_torch import kernels

NEG_INF = -2.0**30
_NO_SEGMENT = torch.iinfo(torch.int32).max


def segment_causal_mask(segment_ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Boolean [R, Tq, Tk]: token i may attend to token j."""
    same = segment_ids[:, :, None] == segment_ids[:, None, :]
    causal = positions[:, :, None] >= positions[:, None, :]
    valid = (segment_ids[:, :, None] > 0) & (segment_ids[:, None, :] > 0)
    return same & causal & valid


def reference_packed_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    segment_ids: torch.Tensor, positions: torch.Tensor,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """The plain version: f32 scores over the whole [T, T] mask. Fully
    masked (padding) rows output 0."""
    R, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else hd**-0.5
    qg = q.reshape(R, T, Hkv, group, hd).float()
    scores = torch.einsum("rqhgd,rkhd->rhgqk", qg, k.float()) * scale
    mask = segment_causal_mask(segment_ids, positions)[:, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0)
    out = torch.einsum("rhgqk,rkhd->rqhgd", probs, v.float())
    return out.reshape(R, T, Hq, hd).to(q.dtype)


def _flash_fwd(q, k, v, segment_ids, positions, scale: float,
               ranges: Optional[torch.Tensor] = None, count_pairs: bool = False):
    """Launch the CUDA kernel: (out [R, T, Hq, hd] bf16, lse [R, Hq, T]
    f32), and with `count_pairs` also the (q tile, kv tile) steps each CTA
    ran, as the kernel counted them (int32 [CTAs]). ``ranges`` are the
    tile segment ranges (built here for the library's tile when not
    given). Raises on anything the kernel does not take."""
    R, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    kernels.check_cuda_tensor("q", q, torch.bfloat16, 4)
    kernels.check_cuda_tensor("k", k, torch.bfloat16, 4)
    kernels.check_cuda_tensor("v", v, torch.bfloat16, 4)
    kernels.check_cuda_tensor("segment_ids", segment_ids, torch.int32, 2)
    kernels.check_cuda_tensor("positions", positions, torch.int32, 2)
    if hd not in (64, 128):
        raise ValueError(f"flash kernel takes head_dim 64 or 128, got {hd}")
    if k.shape != (R, T, Hkv, hd) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(
            f"flash kernel shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}")
    if segment_ids.shape != (R, T) or positions.shape != (R, T):
        raise ValueError("segment_ids / positions must be [R, T]")
    if R > 65535 or Hq > 65535:
        raise ValueError(f"flash kernel grid limit: R={R}, Hq={Hq}")
    if ranges is None:
        ranges = tile_segment_ranges(segment_ids, fwd_tile())
    pairs = _pair_counts(ranges, T, Hq if count_pairs else 0, fwd_tile())
    out = torch.empty_like(q)
    lse = q.new_empty((R, Hq, T), dtype=torch.float32)
    kernels.launch("flash_attn_fwd_bf16", q, k, v, segment_ids, positions, ranges,
                   out, lse, pairs, R, T, Hq, Hkv, hd, float(scale))
    return (out, lse, pairs) if count_pairs else (out, lse)


def reference_packed_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    segment_ids: torch.Tensor, positions: torch.Tensor, dout: torch.Tensor,
    softmax_scale: Optional[float] = None,
    out: Optional[torch.Tensor] = None, lse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward: (dq, dk, dv) of ``sum(out * dout)`` in the
    inputs' dtype, with the backward kernels' arithmetic (p = exp(s - lse)
    under the mask, ds = p (dout.v - delta) scale, p and ds rounded to the
    input dtype before the products, f32 sums). ``out`` [R, T, Hq, hd] and
    ``lse`` [R, Hq, T] are the forward's; when not given they come from
    the plain forward. One packed row at a time, so the live score
    tensors are [Hq, T, T]."""
    R, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else hd**-0.5
    dt = q.dtype
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for r in range(R):
        qg = q[r].reshape(T, Hkv, group, hd).float()
        kf, vf = k[r].float(), v[r].float()
        dog = dout[r].reshape(T, Hkv, group, hd).float()
        s = torch.einsum("qhgd,khd->hgqk", qg, kf) * scale
        mask = segment_causal_mask(segment_ids[r:r + 1], positions[r:r + 1])[0]
        if lse is None:
            row_lse = torch.logsumexp(torch.where(mask, s, NEG_INF), dim=-1)
        else:
            row_lse = lse[r].reshape(Hkv, group, T)
        p = torch.where(mask, torch.exp(s - row_lse[..., None]), 0.0)
        if out is None:
            og = torch.einsum("hgqk,khd->qhgd", p, vf).to(dt).float()
        else:
            og = out[r].reshape(T, Hkv, group, hd).float()
        delta = (dog * og).sum(-1).permute(1, 2, 0)  # [Hkv, group, T]
        dp = torch.einsum("qhgd,khd->hgqk", dog, vf)
        ds = (p * (dp - delta[..., None]) * scale).to(dt).float()
        p = p.to(dt).float()
        dq[r] = torch.einsum("hgqk,khd->qhgd", ds, kf).reshape(T, Hq, hd).to(dt)
        dk[r] = torch.einsum("hgqk,qhgd->khd", ds, qg).to(dt)
        dv[r] = torch.einsum("hgqk,qhgd->khd", p, dog).to(dt)
    return dq, dk, dv


def tile_segment_ranges(segment_ids: torch.Tensor, block: int) -> torch.Tensor:
    """[R, ceil(T / block), 2] int32: for each tile of `block` tokens of
    each row, the lowest and the highest positive segment id in it. A tile
    of padding only gets the empty range (int32 max, 0)."""
    R, T = segment_ids.shape
    n = -(-T // block)
    seg = torch.nn.functional.pad(segment_ids, (0, n * block - T)).reshape(R, n, block)
    live = seg > 0
    lo = torch.where(live, seg, _NO_SEGMENT).amin(dim=-1)
    hi = torch.where(live, seg, 0).amax(dim=-1)
    return torch.stack([lo, hi], dim=-1).to(torch.int32).contiguous()


def live_tile_pairs(ranges: torch.Tensor) -> torch.Tensor:
    """Bool [R, n, n], [r, i, j]: the forward and backward kernels compute
    q tile i against kv tile j. The pair must be causal (j <= i, equal q
    and kv tiles) and the two tiles' segment ranges must meet; any other pair is
    all mask, so skipping it adds exact zeros. For contiguous sequences
    with ascending positions (the packer's rows) every kept pair holds a
    live entry."""
    lo, hi = ranges[..., 0], ranges[..., 1]
    meet = (torch.maximum(lo[:, :, None], lo[:, None, :])
            <= torch.minimum(hi[:, :, None], hi[:, None, :]))
    n = ranges.shape[1]
    causal = torch.ones((n, n), dtype=torch.bool, device=ranges.device).tril()
    return meet & causal


@functools.lru_cache(maxsize=None)
def bwd_tile() -> int:
    """Rows per q tile and per kv tile of the backward kernels, as their
    library reports it: the block their tile ranges must be built for."""
    return int(kernels.library("flash_attn_bwd").flash_attn_bwd_tile())


@functools.lru_cache(maxsize=None)
def fwd_tile() -> int:
    """The same for the forward kernel, as its library reports it."""
    return int(kernels.library("flash_attn").flash_attn_fwd_tile())


def shared_tile_ranges(segment_ids: torch.Tensor) -> torch.Tensor:
    """The tile ranges one forward and its backward share, built once for
    the tile both libraries report; they must report the same one."""
    if fwd_tile() != bwd_tile():
        raise RuntimeError(f"forward tile {fwd_tile()} != backward tile {bwd_tile()}: "
                           "one range tensor cannot serve both")
    return tile_segment_ranges(segment_ids, fwd_tile())


def _flash_bwd(q, k, v, segment_ids, positions, out, lse, dout, scale: float,
               ranges: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the two backward kernels: (dq, dk, dv) bf16. ``out`` and
    ``lse`` are the forward kernel's, ``ranges`` the tile ranges it ran
    with (built here when not given). Raises on anything the kernels do
    not take."""
    R, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)):
        kernels.check_cuda_tensor(name, t, torch.bfloat16, 4)
    kernels.check_cuda_tensor("segment_ids", segment_ids, torch.int32, 2)
    kernels.check_cuda_tensor("positions", positions, torch.int32, 2)
    kernels.check_cuda_tensor("lse", lse, torch.float32, 3)
    if hd not in (64, 128):
        raise ValueError(f"flash kernel takes head_dim 64 or 128, got {hd}")
    if (k.shape != (R, T, Hkv, hd) or v.shape != k.shape or Hq % Hkv
            or out.shape != q.shape or dout.shape != q.shape):
        raise ValueError(
            f"flash backward shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, out {tuple(out.shape)}, dout {tuple(dout.shape)}")
    if (segment_ids.shape != (R, T) or positions.shape != (R, T)
            or lse.shape != (R, Hq, T)):
        raise ValueError("segment_ids / positions must be [R, T], lse [R, Hq, T]")
    if R > 65535 or Hq > 65535:
        raise ValueError(f"flash kernel grid limit: R={R}, Hq={Hq}")
    delta = _bwd_delta(out, dout)
    if ranges is None:
        ranges = tile_segment_ranges(segment_ids, bwd_tile())
    args = (q, k, v, dout, segment_ids, positions, lse, delta, ranges)
    return (_launch_dq(*args, scale), *_launch_dkv(*args, scale))


def _bwd_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dout * out) in f32, laid out like the logsumexp,
    [R, Hq, T] (the reference computes it outside its kernels as well)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _pair_counts(ranges: torch.Tensor, T: int, heads: int, tile: int
                 ) -> Optional[torch.Tensor]:
    """Check that `ranges` is built for the kernels' `tile`; for a
    counting launch (`heads` > 0), one zeroed int32 slot per CTA of a grid
    of (tile, head, row)."""
    R, n = ranges.shape[:2]
    if n != -(-T // tile):
        raise ValueError(f"tile ranges of {n} tiles for T={T}: not built for the kernels' "
                         f"{tile}-row tile")
    return ranges.new_zeros(R * n * heads) if heads else None


def _launch_dq(q, k, v, dout, segment_ids, positions, lse, delta, ranges,
               scale: float, count_pairs: bool = False):
    """The dq kernel alone, on inputs `_flash_bwd` has checked and made.
    With `count_pairs`, also the (q tile, kv tile) products each CTA ran,
    as the kernel counted them: (dq, int32 [CTAs])."""
    R, T, Hq, hd = q.shape
    dq = torch.empty_like(q)
    pairs = _pair_counts(ranges, T, Hq if count_pairs else 0, bwd_tile())
    kernels.launch("flash_attn_bwd_dq_bf16", q, k, v, dout, segment_ids, positions,
                   lse, delta, ranges, dq, pairs, R, T, Hq, k.shape[2], hd, float(scale))
    return (dq, pairs) if count_pairs else dq


def _launch_dkv(q, k, v, dout, segment_ids, positions, lse, delta, ranges,
                scale: float, count_pairs: bool = False):
    """The dk/dv kernel alone, on inputs `_flash_bwd` has checked and made.
    With `count_pairs`, also the (q head, q tile, kv tile) products each
    CTA ran, as the kernel counted them: (dk, dv, int32 [CTAs])."""
    R, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    pairs = _pair_counts(ranges, T, Hkv if count_pairs else 0, bwd_tile())
    kernels.launch("flash_attn_bwd_dkv_bf16", q, k, v, dout, segment_ids, positions,
                   lse, delta, ranges, dk, dv, pairs, R, T, Hq, Hkv, hd, float(scale))
    return (dk, dv, pairs) if count_pairs else (dk, dv)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with the dq and dk/dv kernels as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, positions, scale):
        ranges = shared_tile_ranges(segment_ids)
        out, lse = _flash_fwd(q, k, v, segment_ids, positions, scale, ranges)
        ctx.save_for_backward(q, k, v, segment_ids, positions, out, lse, ranges)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment_ids, positions, out, lse, ranges = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, segment_ids, positions, out, lse,
                                dout.contiguous(), ctx.scale, ranges)
        return dq, dk, dv, None, None, None


def flash_packed_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    segment_ids: torch.Tensor, positions: torch.Tensor,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Packed causal GQA attention through the CUDA flash kernels (bf16 in
    and out, f32 accumulation), differentiable in q, k and v. On a CPU
    tensor: the plain version."""
    if q.device.type == "cpu":
        return reference_packed_attention(
            q, k, v, segment_ids, positions, softmax_scale=softmax_scale)
    scale = float(softmax_scale) if softmax_scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, segment_ids, positions, scale)


# The model's attention entry: on CUDA the flash kernel, on the CPU the
# plain version (the dispatch lives in the kernel's wrapper).
packed_attention = flash_packed_attention


def decode_attention(
    q: torch.Tensor,  # [B, Hq, hd], one new token per sequence
    k_cache: torch.Tensor,  # [B, S, Hkv, hd]
    v_cache: torch.Tensor,  # [B, S, Hkv, hd]
    cache_lens: torch.Tensor,  # [B] valid lengths INCLUDING the new token
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-step decode attention against a padded dense KV cache: the
    plain version, on CPU tensors only (a CUDA caller decodes through the
    paged kernel)."""
    if q.device.type != "cpu":
        raise ValueError(
            f"decode_attention is the plain dense version and runs on CPU tensors "
            f"only (got {q.device}); decode on the card goes through "
            f"engine/paged.paged_decode_attention")
    B, Hq, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    group = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    qg = q.reshape(B, Hkv, group, hd).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * scale
    mask = torch.arange(S)[None, :] < cache_lens[:, None]
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v_cache.float())
    return out.reshape(B, Hq, hd).to(q.dtype)
