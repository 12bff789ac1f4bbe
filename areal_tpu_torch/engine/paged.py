"""Paged KV cache for the serving engine (counterpart of
``areal_tpu/engine/paged.py``).

- KV lives in a page pool ``[L, Hkv, n_pages, page_size, hd]`` shared by
  every slot (int8 pools: a ``(data, scales [L, Hkv, N, pg])`` pair); a
  host-side ``PageAllocator`` hands out pages and a per-slot page table
  ``[B, pages_per_seq]`` maps sequence position to pool page.
- Page 0 is a reserved trash page: writes of inactive slots and of
  prompt padding go there, so a freed-and-reused page is never
  corrupted by a stale slot.
- The reference returns new pools from donated jitted functions; here
  the pools are written in place (``index_put_``), and the functions
  that write them return only their other results.
- Decode attention (``paged_decode_attention``) launches the
  hand-written CUDA kernels of ``csrc/paged_decode.cu`` for CUDA tensors
  (bf16 pool or int8 pool, by the pool's type) and runs the plain
  version ``_paged_attention_xla`` for CPU tensors. The kernel has a
  split-K decode mode (one page row per sequence; ``split_plan`` picks
  the splits) and a row-tiled chunk mode (rows sharing one page row);
  ``_paged_attention_split`` is a plain model of the decode mode's
  arithmetic, for the tests.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from areal_tpu_torch import kernels, torch_dtype
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.transformer import (
    attn_out, embed, layer_params, lm_head, mlp, norm, qkv,
)
from areal_tpu_torch.ops.quant_const import KV_INT8_MAX
from areal_tpu_torch.ops.sampling import NEG_INF, warp_sample
from areal_tpu_torch.ops.wquant import qmat

TRASH_PAGE = 0  # reserved sink page, never allocated


def pages_needed(n_tokens: int, page_size: int) -> int:
    return max(1, -(-n_tokens // page_size))


def kv_pool_data(pool) -> torch.Tensor:
    """The data leaf of a pool (bare tensor, or (data, scales) pair)."""
    return pool[0] if isinstance(pool, tuple) else pool


def pool_layer(pool, i: int):
    """Layer ``i`` of a pool (views, so writes land in the pool)."""
    return (pool[0][i], pool[1][i]) if isinstance(pool, tuple) else pool[i]


def quantize_kv(x: torch.Tensor):
    """[..., hd] float -> (int8 [..., hd], f32 scales [..., 1]).

    Dequantizes as w * s / 127.5. The exact-max element clips to 127
    instead of wrapping at round(127.5) = 128; ``torch.round`` rounds
    half to even, as ``jnp.rint`` does."""
    x32 = x.float()
    s = torch.clamp(x32.abs().amax(dim=-1, keepdim=True), min=1e-6)
    w = torch.clamp(torch.round(x32 * (KV_INT8_MAX / s)), -127, 127)
    return w.to(torch.int8), s


def dequantize_kv(w: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    return (w.float() * (s / KV_INT8_MAX)).to(dtype)


def gather_kv_tokens(pool, page_ids, n_tokens: int):
    """One sequence's KV out of the pool in token-major order (the
    handoff export and the tier spill, engine/kv_handoff.py).

    ``page_ids`` are the sequence's pages in order; tokens past
    ``n_tokens`` (final-page padding) are dropped. Plain pools give
    ``[L, Hkv, n_tokens, hd]``, int8 pools the ``(data, scales [L, Hkv,
    n_tokens])`` pair: fresh tensors on the pool's device, in its dtype
    (the caller copies their bytes to the host as they are)."""
    idx = torch.as_tensor(list(page_ids), dtype=torch.long,
                          device=kv_pool_data(pool).device)

    def g(arr):
        x = arr[:, :, idx]  # [L, Hkv, P, pg, (hd)]
        L, H = x.shape[0], x.shape[1]
        if x.dim() == 5:
            return x.reshape(L, H, -1, x.shape[-1])[:, :, :n_tokens].contiguous()
        return x.reshape(L, H, -1)[:, :, :n_tokens].contiguous()

    if isinstance(pool, tuple):
        return g(pool[0]), g(pool[1])
    return g(pool)


class PageAllocator:
    """Host-side free-list allocator over the pool's page indices. Page 0
    (TRASH_PAGE) is reserved."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (one is the trash page)")
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, 0, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages, or None (and no state change) if unavailable."""
        if n > len(self._free):
            return None
        got = self._free[-n:][::-1]
        del self._free[len(self._free) - n:]
        return got

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p == TRASH_PAGE:
                raise ValueError("freeing the trash page")
            self._free.append(p)


# ----------------------------------------------------------------------
# Paged decode attention: plain version and kernel wrapper
# ----------------------------------------------------------------------


def _paged_attention_xla(q, k_pages, v_pages, lengths, page_indices, scale):
    """The plain version (the reference's gather + masked-softmax path).

    q: [B, Hq, hd]; k/v_pages: [Hkv, N, pg, hd] (or int8 (data, scales)
    pairs, gathered quantized and dequantized after the gather); lengths:
    [B] valid tokens INCLUDING the one written this step; page_indices:
    [B, P]."""
    B, Hq, hd = q.shape
    Hkv, _, pg, _ = kv_pool_data(k_pages).shape
    P = page_indices.shape[1]
    group = Hq // Hkv
    idx = page_indices.long()

    def gather(pool):
        if isinstance(pool, tuple):
            d, s = pool
            g = dequantize_kv(d[:, idx], s[:, idx][..., None], torch.float32)
        else:
            g = pool[:, idx]  # [Hkv, B, P, pg, hd]
        return g.permute(1, 2, 3, 0, 4).reshape(B, P * pg, Hkv, hd)

    k = gather(k_pages)
    v = gather(v_pages)
    qg = q.reshape(B, Hkv, group, hd).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * scale
    pos = torch.arange(P * pg, device=q.device)[None, :]
    mask = pos < lengths[:, None]
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v.float())
    return out.reshape(B, Hq, hd).to(q.dtype)


def split_plan(B: int, Hkv: int, P: int, n_sm: int) -> Tuple[int, int]:
    """(splits, pages a split) of a decode-mode launch over page rows of
    P pages: about four (kv head, sequence, split) CTAs an SM (three fit
    at once; the fourth evens out the ragged lengths), each split a whole
    number of pages and split s owning pages [s * per, (s + 1) * per) of
    [0, P), none empty by shape. It reads the shapes and the card only,
    never the lengths, so the decode block never waits on the device."""
    want = max(1, min(P, -(-4 * n_sm // max(1, B * Hkv))))
    per = -(-P // want)
    return -(-P // per), per


_sm_count = kernels.sm_count


def _paged_decode_kernel(q, k_pages, v_pages, lengths, page_indices, scale):
    """Launch the bf16- or int8-pool CUDA kernel by the pool's type.
    ``page_indices`` may be one page row expanded over B (row stride 0,
    the chunked-prefill case: the kernel's chunk mode); otherwise the
    decode mode runs with the splits of ``split_plan`` and scratch for
    their partials."""
    B, Hq, hd = q.shape
    quantized = isinstance(k_pages, tuple)
    Hkv, N, pg, _ = kv_pool_data(k_pages).shape
    P = page_indices.shape[1]
    kernels.check_cuda_tensor("q", q, torch.bfloat16, 3)
    kernels.check_cuda_tensor("lengths", lengths, torch.int32, 1)
    if page_indices.dtype != torch.int32 or page_indices.device != q.device:
        raise ValueError("page_indices must be int32 on q's device")
    if page_indices.stride(1) != 1 or page_indices.stride(0) not in (0, P):
        raise ValueError("page_indices must have contiguous rows (row stride P or 0)")
    if hd not in (64, 128) or Hq % Hkv or Hq // Hkv > 8:
        raise ValueError(
            f"paged decode kernel takes head_dim 64/128 and GQA group <= 8, "
            f"got hd={hd}, Hq={Hq}, Hkv={Hkv}")
    if lengths.shape != (B,) or page_indices.shape[0] != B or B > 65535:
        raise ValueError("lengths must be [B] and page_indices [B, P], B <= 65535")
    out = torch.empty_like(q)
    stride = page_indices.stride(0)
    splits, per = 1, P
    if stride:
        splits, per = split_plan(B, Hkv, P, _sm_count(q.device.index or 0))
    partials = (q.new_empty(B * Hq * splits * (hd + 2), dtype=torch.float32)
                if splits > 1 else None)
    if quantized:
        for name, (d, s) in (("k_pages", k_pages), ("v_pages", v_pages)):
            kernels.check_cuda_tensor(name, d, torch.int8, 4)
            kernels.check_cuda_tensor(name + " scales", s, torch.float32, 3)
            if d.shape != (Hkv, N, pg, hd) or s.shape != (Hkv, N, pg):
                raise ValueError(f"{name}: mismatched pool shapes")
        kernels.launch(
            "paged_decode_int8", q, k_pages[0], k_pages[1], v_pages[0],
            v_pages[1], lengths, page_indices, stride, out, partials,
            B, Hq, Hkv, N, pg, hd, P, splits, per, float(scale))
    else:
        for name, pool in (("k_pages", k_pages), ("v_pages", v_pages)):
            kernels.check_cuda_tensor(name, pool, torch.bfloat16, 4)
            if pool.shape != (Hkv, N, pg, hd):
                raise ValueError(f"{name}: mismatched pool shapes")
        kernels.launch(
            "paged_decode_bf16", q, k_pages, v_pages, lengths, page_indices,
            stride, out, partials, B, Hq, Hkv, N, pg, hd, P, splits, per, float(scale))
    return out


def _paged_attention_split(q, k_pages, v_pages, lengths, page_indices, scale,
                           splits: int, per: int):
    """A plain model of the decode mode's arithmetic, for the tests: each
    split of ``per`` pages yields f32 partials (m, l, acc) over its tokens
    below the length (an empty split gives l = 0), and the splits merge in
    split order, skipping empty ones. Same inputs and result as
    ``_paged_attention_xla``."""
    B, Hq, hd = q.shape
    Hkv, _, pg, _ = kv_pool_data(k_pages).shape
    group = Hq // Hkv
    idx = page_indices.long()

    def gather(pool, pages):
        if isinstance(pool, tuple):
            d, s = pool
            g = dequantize_kv(d[:, pages], s[:, pages][..., None], torch.float32)
        else:
            g = pool[:, pages].float()  # [Hkv, B, n, pg, hd]
        return g.permute(1, 2, 3, 0, 4).reshape(B, -1, Hkv, hd)

    qg = q.reshape(B, Hkv, group, hd).float()
    ms, ls, accs = [], [], []
    for sp in range(splits):
        pages = idx[:, sp * per:(sp + 1) * per]
        k, v = gather(k_pages, pages), gather(v_pages, pages)
        tok = sp * per * pg + torch.arange(k.shape[1], device=q.device)
        mask = (tok[None, :] < lengths[:, None])[:, None, None, :]
        s = torch.einsum("bhgd,bshd->bhgs", qg, k) * scale
        s = torch.where(mask, s, float("-inf"))
        m = s.amax(dim=-1).clamp(min=NEG_INF)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhgs,bshd->bhgd", p, v))
    live = [l_ > 0 for l_ in ls]
    m_all = torch.stack([torch.where(a, m, NEG_INF) for a, m in zip(live, ms)]).amax(dim=0)
    l_sum = torch.zeros_like(m_all)
    o_sum = torch.zeros_like(accs[0])
    for a, m, l_, acc in zip(live, ms, ls, accs):
        c = torch.where(a, torch.exp(m - m_all), 0.0)
        l_sum = l_sum + l_ * c
        o_sum = o_sum + acc * c[..., None]
    out = torch.where((l_sum > 0)[..., None], o_sum / l_sum.clamp(min=1e-30)[..., None], 0.0)
    return out.reshape(B, Hq, hd).to(q.dtype)


def paged_decode_attention(
    q,  # [B, Hq, hd]
    k_pages,  # [Hkv, N, pg, hd], or an int8 (data, scales) pair
    v_pages,
    lengths,  # [B] int32, incl. the token written this step
    page_indices,  # [B, P] int32
    softmax_scale: Optional[float] = None,
):
    """One-token decode attention over the paged pool: the CUDA kernel for
    CUDA tensors (bf16 or int8 pool by the pool's type), the plain
    version for CPU tensors."""
    scale = float(softmax_scale) if softmax_scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _paged_attention_xla(q, k_pages, v_pages, lengths, page_indices, scale)
    return _paged_decode_kernel(q, k_pages, v_pages, lengths, page_indices, scale)


# ----------------------------------------------------------------------
# Paged decode step (one token per slot through all layers)
# ----------------------------------------------------------------------


def _write_kv(pool, w_pidx, w_off, val):
    """Scatter val [B, Hkv, hd] into pool [Hkv, N, pg, hd] at (page
    w_pidx[b], offset w_off[b]), in place. Active slots' pages are
    distinct; collisions happen only on the trash page."""
    val_t = val.transpose(0, 1)  # [Hkv, B, hd]
    if isinstance(pool, tuple):
        w, s = quantize_kv(val_t)
        pool[0][:, w_pidx, w_off] = w
        pool[1][:, w_pidx, w_off] = s[..., 0]
    else:
        pool[:, w_pidx, w_off] = val_t.to(pool.dtype)


def _paged_decode_layer(x, lp, cfg, cos, sin, kp_l, vp_l, w_pidx, w_off,
                        page_indices, lengths, cdt):
    """One layer for one new token per slot. x: [B, D]; kp_l/vp_l: the
    layer's pool [Hkv, N, pg, hd] (written in place); w_pidx/w_off: [B]
    write page and offset (trash-routed for inactive slots); lengths: [B]
    fill count BEFORE this token."""
    a = lp["attn"]
    q, k, v = qkv(norm(x, lp["ln1"], cfg), a, cfg, cdt, cos, sin)
    _write_kv(kp_l, w_pidx, w_off, k)
    _write_kv(vp_l, w_pidx, w_off, v)
    # q is a view of a grouped projection's output when no bias, norm or
    # rotary made it anew; the kernel takes contiguous rows.
    out = paged_decode_attention(q.contiguous(), kp_l, vp_l, lengths + 1, page_indices)
    x = x + attn_out(out, a, cfg, cdt)
    return x + mlp(norm(x, lp["ln2"], cfg), lp["mlp"], cfg, cdt)


def paged_decode_hidden(params, cfg: TransformerConfig, tokens, k_pages,
                        v_pages, page_indices, lengths, active):
    """All layers for one new token per slot; returns the final-normed
    hidden [B, D]. tokens: [B] inputs; lengths: [B] fill BEFORE this
    token; active: [B] bool (inactive slots write to the trash page).
    The pools are written in place."""
    if cfg.moe is not None:
        raise NotImplementedError("MoE models are not ported yet")
    cdt = torch_dtype(cfg.compute_dtype)
    pg = kv_pool_data(k_pages).shape[3]
    B, P = tokens.shape[0], page_indices.shape[1]
    col = torch.clamp(torch.div(lengths, pg, rounding_mode="floor"), max=P - 1)
    rows = torch.arange(B, device=tokens.device)
    w_pidx = torch.where(active, page_indices[rows, col], TRASH_PAGE)
    w_off = torch.where(active, lengths % pg, 0)
    x, cos, sin = embed(params, cfg, tokens, lengths, cdt)
    for i in range(cfg.n_layers):
        x = _paged_decode_layer(
            x, layer_params(params["layers"], i), cfg, cos, sin,
            pool_layer(k_pages, i), pool_layer(v_pages, i), w_pidx, w_off,
            page_indices, lengths, cdt,
        )
    return norm(x, params["final_norm"], cfg)


def paged_decode_step(params, cfg: TransformerConfig, tokens, k_pages,
                      v_pages, page_indices, lengths, active):
    """One decode step for all slots: float32 logits [B, V]; the pools
    are written in place. A tree with int8 decode weights
    (ops/wquant.quantize_decode_weights) runs its quantized head."""
    x = paged_decode_hidden(params, cfg, tokens, k_pages, v_pages,
                            page_indices, lengths, active)
    cdt = torch_dtype(cfg.compute_dtype)
    if "head_q" in params:
        return qmat(x, params["head_q"], cdt).float()
    return lm_head(params, cfg, x, cdt)


# ----------------------------------------------------------------------
# Chunked prefill (long prompts)
# ----------------------------------------------------------------------


def _chunk_prefill_body(params, cfg: TransformerConfig, tokens, k_pages,
                        v_pages, page_row, start: int, valid_len: int):
    """One chunk of ONE long prompt through the paged pool.

    A chunk of C tokens at positions start..start+C-1 is C decode rows of
    the same request with staggered lengths sharing one page-table row:
    every row's K/V is written first, then row i attends to flat
    positions < start+i+1 (earlier chunks, already in the pool, plus
    the causal part of this chunk). So this reuses the decode step.
    tokens: [C] right-padded (rows past ``valid_len`` are inactive and
    write to the trash page); page_row: [P]. Returns the float32 logits
    [V] of the last valid row (the first-token logits on the prompt's
    last chunk); the head runs on that row only.

    The reference splits the chunk into sub-chunks to bound the TPU
    kernel's SMEM page-index operand; the CUDA kernel reads one page row
    through a zero row stride (its chunk mode: each K/V tile of the row is
    loaded once for 64 rows), so the whole chunk runs as one step."""
    C = tokens.shape[0]
    rows = torch.arange(C, dtype=torch.int32, device=tokens.device)
    lengths = start + rows
    active = rows < valid_len
    page_indices = page_row[None, :].expand(C, page_row.shape[0])
    x = paged_decode_hidden(params, cfg, tokens, k_pages, v_pages,
                            page_indices, lengths, active)
    target = max(valid_len - 1, 0)
    return lm_head(params, cfg, x[target], torch_dtype(cfg.compute_dtype))


# ----------------------------------------------------------------------
# Prefill scatter
# ----------------------------------------------------------------------


def scatter_prefill(k_pages, v_pages, k_pref, v_pref, flat_page_ids):
    """Write batched-prefill KV into the pools, in place.

    k_pref/v_pref: [L, n, pad, Hkv, hd] from the packed forward;
    flat_page_ids: [n * pad // pg] pool pages in row-major (row, chunk)
    order, TRASH_PAGE for chunks past a row's allocation. int8 pools
    quantize each token's head vector before the write."""
    L, n, pad, Hkv, hd = k_pref.shape
    pg = kv_pool_data(k_pages).shape[3]
    n_chunks = pad // pg

    def to_chunks(pref):
        # [L, n, pad, Hkv, x] -> [L, Hkv, n * chunks, pg, x]
        x = pref.shape[-1]
        return pref.permute(0, 3, 1, 2, 4).reshape(L, Hkv, n * n_chunks, pg, x)

    def write(pool, pref):
        if isinstance(pool, tuple):
            w, s = quantize_kv(pref)
            pool[0][:, :, flat_page_ids] = to_chunks(w)
            pool[1][:, :, flat_page_ids] = to_chunks(s)[..., 0]
        else:
            pool[:, :, flat_page_ids] = to_chunks(pref).to(pool.dtype)

    write(k_pages, k_pref)
    write(v_pages, v_pref)


def scatter_prefill_int8(k_pages, v_pages, k_data, k_scales, v_data, v_scales,
                         page_ids):
    """Write an int8-wire KV prefix straight into an int8 pool, in place:
    the wire's (data, scales) pairs are the pool's encoding, so a spill
    and restore is bit-exact and never dequantizes.

    k_data/v_data: [L, Hkv, pad, hd] int8 token-major (padded to whole
    pages); k_scales/v_scales: [L, Hkv, pad] f32; page_ids: [pad // pg]
    pool pages in order."""
    L, Hkv, pad, hd = k_data.shape
    pg = k_pages[0].shape[3]
    n_chunks = pad // pg

    def write(pool, data, scales):
        pool[0][:, :, page_ids] = data.reshape(L, Hkv, n_chunks, pg, hd)
        pool[1][:, :, page_ids] = scales.reshape(L, Hkv, n_chunks, pg)

    write(k_pages, k_data, k_scales)
    write(v_pages, v_data, v_scales)


# ----------------------------------------------------------------------
# The decode block
# ----------------------------------------------------------------------


def paged_decode_block(
    params,
    cfg: TransformerConfig,
    k_pages,
    v_pages,
    page_indices,  # [B, P]
    lengths,  # [B] cache fill per slot (excl. the pending next_input token)
    next_input,  # [B] last sampled token, to feed
    active,  # [B] bool
    remaining,  # [B] int32 budget left
    min_remaining,  # [B] int32 forbid-EOS countdown
    temps,
    top_ps,
    top_ks,
    greedy_mask,
    eos_mask,  # [V] bool
    generator: torch.Generator,
    n_steps: int,
    tier: Optional[str] = None,
):
    """Run n_steps decode steps for every active slot (the host has
    allocated pages for lengths + n_steps tokens of each active slot).

    Returns (packed, lengths, next_input, active, remaining,
    min_remaining): ``packed`` is ONE [B, 2n+4] float32 tensor
    [tokens | logprobs | n_emitted, hit_eos, active, lengths], so the host
    makes exactly one device fetch per block. Emission is
    prefix-contiguous per slot, so tokens[:n_emitted] is the emitted
    sequence. The pools are written in place; ``tier`` is the warp tier
    the block's rows need (ops/sampling.select_tier), chosen once on the
    host."""
    B = lengths.shape[0]
    dev = lengths.device
    out_t = torch.zeros((B, n_steps), dtype=torch.int32, device=dev)
    out_lp = torch.zeros((B, n_steps), dtype=torch.float32, device=dev)
    out_m = torch.zeros((B, n_steps), dtype=torch.bool, device=dev)
    hit_eos = torch.zeros((B,), dtype=torch.bool, device=dev)
    for i in range(n_steps):
        logits = paged_decode_step(params, cfg, next_input, k_pages, v_pages,
                                   page_indices, lengths, active)
        tokens, logprobs = warp_sample(
            logits, generator, temps, top_ps, top_ks, greedy_mask,
            min_remaining > 0, eos_mask, active_rows=active, tier=tier,
        )
        emit = active
        tokens = torch.where(emit, tokens, 0)
        logprobs = torch.where(emit, logprobs, 0.0)
        out_t[:, i] = tokens
        out_lp[:, i] = logprobs
        out_m[:, i] = emit
        is_eos = eos_mask[tokens] & emit
        step = emit.to(torch.int32)
        remaining = remaining - step
        min_remaining = torch.clamp(min_remaining - step, min=0)
        exhausted = (remaining <= 0) & emit
        hit_eos = hit_eos | is_eos
        active = active & ~is_eos & ~exhausted
        lengths = lengths + step
        next_input = tokens
    packed = torch.cat([
        out_t.float(),
        out_lp,
        out_m.sum(dim=1, keepdim=True).float(),
        hit_eos[:, None].float(),
        active[:, None].float(),
        lengths[:, None].float(),
    ], dim=1)
    return packed, lengths, next_input, active, remaining, min_remaining
