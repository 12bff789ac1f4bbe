"""N-gram (prompt-lookup) speculative decoding for the paged engine
(counterpart of ``areal_tpu/engine/spec_decode.py``).

Decode at small batch streams every weight once a step to emit ONE token a
slot. Speculative decoding amortizes that read over several tokens: draft
candidate continuations, feed them all in one multi-row step, and keep the
verified prefix. Opt-in through ``ServingEngine(speculative_draft_len=...)``.

Drafts come from prompt lookup: the last ``g`` tokens of a slot's history
are matched against its earlier history, and the tokens that followed the
most recent earlier occurrence become the draft. History, matching and
verification stay on the device; the host makes one fetch a block.

Verification is lossless:
- greedy rows accept a draft token iff it is the argmax of the base
  distribution (the one ``warp_sample``'s greedy path takes), so the
  emitted stream is plain greedy decoding's;
- sampled rows use speculative sampling with a point-mass draft: accept
  draft t with probability p(t); on rejection, sample from p with t
  removed. The stream is distributed as plain sampling.

Random draws come from the engine's ``torch.Generator`` (``spec_draws``);
``spec_verify`` also takes them as tensors, so a test can hand it the
draws ``jax.random`` makes (``jax.random.categorical(k, x)`` is
``argmax(x + jax.random.gumbel(k, x.shape))``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from areal_tpu_torch.engine.paged import paged_decode_step
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.ops.sampling import NEG_INF, warp_logits


def propose_ngram_drafts(
    history: torch.Tensor,  # [B, S+1] int32; column S is a scratch column
    lengths: torch.Tensor,  # [B] int32: position of the PENDING token
    ngram: int,
    draft_len: int,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match the n-gram ending at the pending token against earlier
    history; return (draft [B, draft_len] int32, eff [B] int32: the number
    of proposed tokens, 0 when there is no match or too little history).

    history[b, 0..lengths[b]] are known tokens (prompt + emitted, the last
    one pending, its KV not yet written). The draft is the continuation
    after the MOST RECENT earlier occurrence; continuation tokens must
    themselves be known history. ``window > 0`` bounds the backward search
    to each slot's last ``window`` candidate match starts (gathered, so the
    compare is [B, W, g] whatever the configured S); 0 scans all of it."""
    B, S1 = history.shape
    S = S1 - 1
    g, d = ngram, draft_len
    dev = history.device
    ar_g = torch.arange(g, device=dev)
    lengths = lengths.long()
    last_idx = torch.clamp(lengths[:, None] - (g - 1) + ar_g[None, :], 0, S - 1)
    lastgram = torch.gather(history, 1, last_idx)  # [B, g]
    if window and window < S:
        W = int(window)
        base = torch.clamp(lengths[:, None] - g - W + 1, min=0)  # [B, 1]
        s_pos = base + torch.arange(W, device=dev)[None, :]  # [B, W] absolute starts
        win_idx = torch.clamp(s_pos[:, :, None] + ar_g[None, None, :], max=S - 1)
        windows = torch.gather(history, 1, win_idx.reshape(B, W * g)).reshape(B, W, g)
    else:
        # Unbounded: sliding windows [B, S, g] (the clamp keeps the tail in
        # bounds; those positions fail the validity mask).
        win_idx = torch.clamp(torch.arange(S, device=dev)[:, None] + ar_g[None, :], max=S - 1)
        windows = history[:, win_idx]  # [B, S, g]
        s_pos = torch.arange(S, device=dev)[None, :].expand(B, S)
    eq = (windows == lastgram[:, None, :]).all(dim=2)  # [B, S or W]
    # The earlier occurrence must end strictly before the pending position,
    # and there must be at least g tokens of history.
    valid = eq & (s_pos + g - 1 < lengths[:, None]) & (lengths[:, None] + 1 >= g)
    best = torch.where(valid, s_pos, torch.full_like(s_pos, -1)).amax(dim=1)  # [B]
    start = best + g  # continuation start (a known position <= lengths)
    cont_idx = torch.clamp(start[:, None] + torch.arange(d, device=dev)[None, :], 0, S - 1)
    draft = torch.gather(history, 1, cont_idx).int()
    eff = torch.where(best >= 0, torch.clamp(lengths - start + 1, 0, d),
                      torch.zeros_like(best)).int()
    return draft, eff


def spec_draws(generator: torch.Generator, B: int, d: int, V: int, device):
    """One verification step's random draws: the acceptance uniforms [B, d]
    and the Gumbel noise [B, V] of the final token's categorical."""
    u = torch.rand((B, d), generator=generator, device=device)
    g = torch.rand((B, V), generator=generator, device=device)
    gumbel = -torch.log(-torch.log(g.clamp_(min=torch.finfo(torch.float32).tiny)))
    return u, gumbel


def spec_verify(
    logits: torch.Tensor,  # [B, d+1, V] f32, row j = dist after feeding token j
    draft: torch.Tensor,  # [B, d] int32
    eff: torch.Tensor,  # [B] int32 proposed tokens (<= d)
    generator: Optional[torch.Generator],
    temps, top_ps, top_ks, greedy_mask, forbid_rows, eos_mask,
    active_rows=None,
    tier: Optional[str] = None,
    u: Optional[torch.Tensor] = None,  # [B, d] uniforms
    gumbel: Optional[torch.Tensor] = None,  # [B, V] Gumbel noise
):
    """Vectorized accept / resample. Returns (emitted [B, d+1] int32, n_emit
    [B] int32 in 1..d+1, logprobs [B, d+1] under the base distribution).
    Per slot:
      a = length of the accepted draft prefix (greedy: base argmax matches;
          sampled: u_j < p_j(draft_j)), capped at eff
      emitted = draft[:a] + one final token from position a's distribution
          (greedy: the base argmax; sampled: the rejected token removed and
          renormalized when a < eff, a plain sample when a == eff)
    Slots with eff = 0 reduce to one plain ``warp_sample`` step. ``u`` and
    ``gumbel`` default to fresh draws from ``generator``."""
    B, d1, V = logits.shape
    d = d1 - 1
    dev = logits.device

    def rep(x):
        return torch.repeat_interleave(x, d1, dim=0)

    warped_f, base_f = warp_logits(
        logits.reshape(B * d1, V), rep(temps), rep(top_ps), rep(top_ks), rep(forbid_rows),
        eos_mask, active_rows=rep(active_rows) if active_rows is not None else None,
        tier=tier,
    )
    warped = warped_f.reshape(B, d1, V)
    base_logp = base_f.reshape(B, d1, V)
    probs = torch.softmax(warped, dim=-1)
    if u is None or gumbel is None:
        u, gumbel = spec_draws(generator, B, d, V, dev)
    draft_l = draft.long()
    ar_d = torch.arange(d, device=dev)
    p_draft = torch.gather(probs[:, :d], 2, draft_l[:, :, None])[:, :, 0]  # [B, d]
    # Greedy acceptance is judged on the BASE distribution, the argmax the
    # plain decode path emits (warp_sample).
    ok_greedy = base_logp[:, :d].argmax(dim=2) == draft_l
    ok_sample = u < p_draft
    ok = torch.where(greedy_mask[:, None], ok_greedy, ok_sample)
    ok = ok & (ar_d[None, :] < eff[:, None])
    a = torch.cumprod(ok.int(), dim=1).sum(dim=1)  # [B] in 0..eff

    def at_a(x):  # x[b, a[b]] of a [B, d+1, V] tensor
        return torch.gather(x, 1, a[:, None, None].expand(B, 1, V))[:, 0]

    # On rejection (a < eff) remove the rejected draft token before the
    # final draw (the categorical renormalizes).
    if d > 0:
        rej_tok = torch.gather(draft_l, 1, torch.clamp(a, max=d - 1)[:, None])[:, 0]
    else:
        rej_tok = torch.zeros((B,), dtype=torch.long, device=dev)
    remove = a < eff
    remove_mask = remove[:, None] & (torch.arange(V, device=dev)[None, :] == rej_tok[:, None])
    sampled = torch.argmax(torch.where(remove_mask, NEG_INF, at_a(warped)) + gumbel, dim=-1)
    # The greedy final token from the BASE distribution (warp_sample's
    # greedy path); the mask never removes the base argmax of a greedy row.
    greedy_tok = torch.argmax(torch.where(remove_mask, NEG_INF, at_a(base_logp)), dim=-1)
    final = torch.where(greedy_mask, greedy_tok, sampled)

    # emitted[j] = draft[j] for j < a, final at j == a, zeros after.
    ar_d1 = torch.arange(d1, device=dev)
    emitted = torch.where(ar_d1[None, :] < a[:, None], F.pad(draft_l, (0, 1)),
                          torch.zeros((), dtype=torch.long, device=dev))
    emitted[torch.arange(B, device=dev), a] = final
    n_emit = a + 1
    logprobs = torch.gather(base_logp, 2, emitted[:, :, None])[:, :, 0]
    logprobs = torch.where(ar_d1[None, :] < n_emit[:, None], logprobs, 0.0)
    return emitted.int(), n_emit.int(), logprobs


def set_history(history: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor) -> None:
    """Write admitted requests' token history (prompt + first sampled
    token) into their slots' rows, in place. slots: [m]; rows: [m, S+1]
    int32. (The reference pads to a power-of-two batch and routes the
    padding to a scratch row; eager PyTorch takes the m rows as they are.)"""
    history[slots.long()] = rows


def paged_spec_decode_block(
    params,
    cfg: TransformerConfig,
    k_pages,
    v_pages,
    page_indices,  # [B, P]
    lengths,  # [B] cache fill per slot (excl. the pending next_input token)
    next_input,
    active,
    remaining,
    min_remaining,
    temps,
    top_ps,
    top_ks,
    greedy_mask,
    eos_mask,  # [V] bool
    generator: torch.Generator,
    history,  # [B, S+1] int32 (see set_history), updated in place
    n_steps: int,
    draft_len: int,
    ngram: int = 2,
    ngram_window: int = 0,
    tier: Optional[str] = None,
):
    """``paged_decode_block`` with n-gram speculative decoding: each step
    feeds 1 + draft_len rows a slot (the pending token and the drafts, at
    staggered lengths sharing the slot's page row) and emits the verified
    prefix plus one token. Returns (packed, lengths, next_input, active,
    remaining, min_remaining); ``packed`` is ONE [B, 2 n_out + 5] float32
    tensor [tokens | logprobs | n_emitted, hit_eos, active, lengths,
    steps active] with n_out = n_steps * (draft_len + 1), so the host makes
    one device fetch a block. The host reserves pages for lengths +
    min(n_out, remaining) tokens a slot: rejected rows still write (stale)
    KV, overwritten by later steps and never attended (position >= the
    slot's length). The pools and ``history`` are written in place.

    Each step's rows use ``page_indices`` repeated per row (a real copy, row
    stride P), so the paged kernel runs them in its decode mode and each
    row reads its slot's K/V."""
    B = lengths.shape[0]
    dev = lengths.device
    d1 = draft_len + 1
    n_out = n_steps * d1
    S1 = history.shape[1]
    j_idx = torch.arange(d1, device=dev)[None, :]
    brow = torch.arange(B, device=dev)[:, None].expand(B, d1)
    # One scratch column (n_out) absorbs masked scatter writes.
    out_t = torch.zeros((B, n_out + 1), dtype=torch.int32, device=dev)
    out_lp = torch.zeros((B, n_out + 1), dtype=torch.float32, device=dev)
    out_m = torch.zeros((B, n_out + 1), dtype=torch.bool, device=dev)
    hit_eos = torch.zeros((B,), dtype=torch.bool, device=dev)
    total = torch.zeros((B,), dtype=torch.int32, device=dev)
    steps_act = torch.zeros((B,), dtype=torch.int32, device=dev)
    row_pages = torch.repeat_interleave(page_indices, d1, dim=0)
    for _ in range(n_steps):
        steps_act = steps_act + active.int()
        # Drafting is off while the EOS-forbid floor is live and for
        # inactive slots, and never proposes past the remaining budget.
        draft, eff = propose_ngram_drafts(history, lengths, ngram, draft_len,
                                          window=ngram_window)
        eff = torch.where(active & (min_remaining <= 0), eff, 0)
        eff = torch.minimum(eff, torch.clamp(remaining - 1, min=0)).int()

        # [B, d1] rows: j = 0 feeds the pending token, j > 0 the drafts.
        toks = torch.cat([next_input[:, None], draft], dim=1)
        row_lengths = (lengths[:, None] + j_idx).reshape(-1).int()
        row_active = (active[:, None] & (j_idx <= eff[:, None])).reshape(-1)
        logits = paged_decode_step(params, cfg, toks.reshape(-1).int(), k_pages, v_pages,
                                   row_pages, row_lengths, row_active)
        emitted, n_emit, logprobs = spec_verify(
            logits.reshape(B, d1, -1), draft, eff, generator, temps, top_ps, top_ks,
            greedy_mask, min_remaining > 0, eos_mask, active_rows=active, tier=tier,
        )

        # Truncate the emitted group at the first EOS, then at the budget.
        pos_mask = j_idx < n_emit[:, None]
        is_eos = eos_mask[emitted.long()] & pos_mask
        any_eos = is_eos.any(dim=1)
        first_eos = is_eos.int().argmax(dim=1)
        n_emit = torch.where(any_eos, first_eos + 1, n_emit)
        n_emit = torch.minimum(n_emit, torch.clamp(remaining, min=0))
        n_emit = torch.where(active, n_emit, 0).int()
        emit_mask = j_idx < n_emit[:, None]
        emitted = torch.where(emit_mask, emitted, 0)
        logprobs = torch.where(emit_mask, logprobs, 0.0)

        # State advance (the plain block's, in units of n_emit).
        got_eos = any_eos & (first_eos < n_emit) & active
        remaining = remaining - n_emit
        min_remaining = torch.clamp(min_remaining - n_emit, min=0)
        exhausted = (remaining <= 0) & active & (n_emit > 0)
        hit_eos = hit_eos | got_eos
        new_active = active & ~got_eos & ~exhausted

        # next_input = the last emitted token (where n_emit > 0; inactive
        # slots keep their stale value).
        last_tok = torch.gather(emitted, 1, torch.clamp(n_emit - 1, min=0).long()[:, None])[:, 0]
        next_input = torch.where(n_emit > 0, last_tok, next_input)

        # History append: emitted[i] lands at position lengths + 1 + i;
        # masked writes go to the scratch column S.
        wpos = torch.where(emit_mask, torch.clamp(lengths[:, None] + 1 + j_idx, max=S1 - 1),
                           S1 - 1)
        history[brow, wpos.long()] = emitted
        lengths = lengths + n_emit

        # Emission buffers, compacted per slot: the host consumes the FIRST
        # n_emitted columns, so each step's group lands at the slot's
        # running offset (masked entries go to the scratch column n_out).
        wcol = torch.where(emit_mask, total[:, None] + j_idx, n_out).long()
        out_t[brow, wcol] = emitted
        out_lp[brow, wcol] = logprobs
        out_m[brow, wcol] = emit_mask
        total = total + n_emit
        active = new_active
    packed = torch.cat([
        out_t[:, :n_out].float(),
        out_lp[:, :n_out],
        out_m[:, :n_out].sum(dim=1, keepdim=True).float(),
        hit_eos[:, None].float(),
        active[:, None].float(),
        lengths[:, None].float(),
        # Steps each slot was ACTIVE for: the speculation yield's exact
        # denominator.
        steps_act[:, None].float(),
    ], dim=1)
    return packed, lengths, next_input, active, remaining, min_remaining
