"""In-framework generation: a batched prefill and a KV-cache decode loop
(counterpart of ``areal_tpu/models/generation.py``), used by
``TorchTrainEngine.generate`` for sync PPO.

The reference's conventions are kept: prompts right-padded to a multiple
of ``prompt_pad_multiple`` (P), a cache of ``P + max_new_tokens`` tokens a
row, the stop set ``gconfig.stop_token_ids`` plus EOS, every stop token
forbidden before ``min_new_tokens`` (the reported logprob is of that
forbid-masked, unwarped distribution), rows that are done emit token 0
with logprob 0 and stop advancing, the output length counts the stop
token, and ``no_eos`` is ``not done``.

The cache is not the reference's dense ``[L, B, S, Hkv, hd]`` array: it is
the serving engine's page pool (``[L, Hkv, N, page_size, hd]``,
``engine/paged.py``), each row owning a fixed run of
``ceil(cache_len / page_size)`` pages after the trash page. So the decode
step is ``engine/paged.paged_decode_step``, whose attention launches the
``paged_decode_bf16`` kernel in decode mode for CUDA tensors, and the
prefill is the packed ``forward(..., return_kv=True)`` (the flash forward
kernel) followed by ``scatter_prefill``, as the serving engine's batched
prefill does: padding tokens carry segment 0, so the kernel skips them,
and prompt chunks past a row's prompt go to the trash page. For CPU
tensors both take their plain versions; the dense
``ops/attention.decode_attention`` is the reference's arithmetic, which
the tests hold this path against.

Differences from the reference: sampling draws from a ``torch.Generator``
(the reference splits a JAX key), so sampled tokens differ between the
packages and greedy ones do not; the loop runs on the host, and checks
whether every row is done every ``DONE_CHECK_STEPS`` steps (one device
read each), where the reference tests it inside its device loop every
step: at most ``DONE_CHECK_STEPS - 1`` steps run after the last row
stopped, and they change no output.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from areal_tpu_torch import torch_dtype
from areal_tpu_torch.engine.paged import (
    TRASH_PAGE,
    pages_needed,
    paged_decode_step,
    scatter_prefill,
)
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.transformer import forward as packed_forward
from areal_tpu_torch.models.transformer import lm_head
from areal_tpu_torch.ops.sampling import sample_token

PAGE_SIZE = 128
# Steps between the host's reads of the rows' done flags.
DONE_CHECK_STEPS = 16


def _device_of(params) -> torch.device:
    return params["embedding"]["weight"].device


def prefill(params, cfg: TransformerConfig, input_ids, prompt_lens, cache_len: int,
            page_size: int = PAGE_SIZE):
    """Run the prompt forward and build the paged KV cache.

    input_ids: [B, P] right-padded prompts; prompt_lens: [B] int32 (tensors
    on the params' device). Returns (last_logits [B, V] float32, k_pages,
    v_pages, page_table): pools [L, Hkv, 1 + B * n, page_size, hd] in the
    compute dtype, row b owning pages 1 + b * n .. (b + 1) * n of the
    table [B, n], n = ceil(cache_len / page_size) (page 0 is the trash
    page); the head runs on each row's last prompt token only."""
    B, P = input_ids.shape
    dev = input_ids.device
    pos = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
    seg = (pos < prompt_lens[:, None]).to(torch.int32)
    positions = torch.where(seg > 0, pos, 0).to(torch.int32)
    hidden, (k_pref, v_pref) = packed_forward(
        params, cfg, input_ids, seg, positions, output="hidden", return_kv=True,
        device=dev)
    last = hidden[torch.arange(B, device=dev), torch.clamp(prompt_lens - 1, min=0).long()]
    last_logits = lm_head(params, cfg, last, torch_dtype(cfg.compute_dtype))
    del hidden
    n = pages_needed(cache_len, page_size)
    shape = (cfg.n_layers, cfg.n_kv_heads, 1 + B * n, page_size, cfg.head_dim)
    k_pages = torch.zeros(shape, dtype=k_pref.dtype, device=dev)
    v_pages = torch.zeros(shape, dtype=k_pref.dtype, device=dev)
    table = (1 + torch.arange(B * n, dtype=torch.int32, device=dev)).reshape(B, n)
    # scatter_prefill writes whole pages: pad the prompt axis to a page
    # multiple; chunks past a row's prompt go to the trash page, and the
    # padding tokens inside a row's last prompt page are overwritten by
    # decode writes before any step attends to them.
    pad = -(-P // page_size) * page_size
    if pad > P:
        widen = [0, 0, 0, 0, 0, pad - P]
        k_pref = torch.nn.functional.pad(k_pref, widen)
        v_pref = torch.nn.functional.pad(v_pref, widen)
    n_chunks = pad // page_size
    plens = prompt_lens.cpu().numpy()
    table_np = table.cpu().numpy()
    flat = np.full((B, n_chunks), TRASH_PAGE, np.int32)
    for b in range(B):
        n_p = pages_needed(int(plens[b]), page_size)
        flat[b, :n_p] = table_np[b, :n_p]
    scatter_prefill(k_pages, v_pages, k_pref, v_pref,
                    torch.from_numpy(flat.reshape(-1)).to(dev))
    return last_logits, k_pages, v_pages, table


def decode_step(params, cfg: TransformerConfig, tokens, k_pages, v_pages, page_table,
                lengths, active):
    """One decode step for every row: feed ``tokens`` [B] at cache fill
    ``lengths`` [B] (BEFORE this token). Returns float32 logits [B, V];
    the pools are written in place (rows not ``active`` write to the
    trash page)."""
    return paged_decode_step(params, cfg, tokens, k_pages, v_pages, page_table,
                             lengths, active)


@torch.no_grad()
def generate_tokens(
    params,
    cfg: TransformerConfig,
    prompts: List[List[int]],
    gconfig,
    generator: torch.Generator,
    eos_token_id: Optional[int] = None,
    prompt_pad_multiple: int = 64,
    page_size: int = PAGE_SIZE,
) -> List[Dict[str, Any]]:
    """Generate for a batch of prompts on the params' device. Returns one
    dict a prompt: ``output_ids``, ``output_logprobs``, ``no_eos``."""
    dev = _device_of(params)
    B = len(prompts)
    plens = np.array([len(p) for p in prompts], np.int32)
    P = int(-(-max(int(plens.max()), 1) // prompt_pad_multiple) * prompt_pad_multiple)
    input_ids = np.zeros((B, P), np.int32)
    for i, p in enumerate(prompts):
        input_ids[i, : len(p)] = p
    max_new = int(gconfig.max_new_tokens)
    cache_len = P + max_new

    stop = tuple(gconfig.stop_token_ids)
    if eos_token_id is not None and eos_token_id not in stop:
        stop = stop + (eos_token_id,)
    stop_ids = torch.as_tensor(stop, dtype=torch.int32, device=dev) if stop else None

    plens_dev = torch.from_numpy(plens).to(dev)
    logits, k_pages, v_pages, table = prefill(
        params, cfg, torch.from_numpy(input_ids).to(dev), plens_dev, cache_len, page_size)
    lengths = plens_dev.clone()
    out_tokens = torch.zeros((B, max_new), dtype=torch.int32, device=dev)
    out_logprobs = torch.zeros((B, max_new), dtype=torch.float32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    min_new = int(gconfig.min_new_tokens)
    for step in range(max_new):
        if step and step % DONE_CHECK_STEPS == 0 and bool(done.all()):
            break
        tokens, logprobs = sample_token(
            logits, generator, greedy=gconfig.greedy, temperature=gconfig.temperature,
            top_k=gconfig.top_k, top_p=gconfig.top_p,
            forbid_token_ids=stop if step < min_new else None,
        )
        hit_stop = (torch.isin(tokens, stop_ids) if stop_ids is not None
                    else torch.zeros_like(done))
        emit = torch.where(done, 0, tokens).to(torch.int32)
        out_tokens[:, step] = emit
        out_logprobs[:, step] = torch.where(done, 0.0, logprobs)
        if step + 1 < max_new:
            # The last sampled token's step would only feed a sample that
            # never comes: the reference runs it, its outputs unused.
            logits = decode_step(params, cfg, emit, k_pages, v_pages, table, lengths, ~done)
        lengths = lengths + (~done).to(lengths.dtype)
        done = done | hit_stop
    packed = torch.cat([out_tokens.float(), out_logprobs,
                        (lengths - plens_dev)[:, None].float(), done[:, None].float()], dim=1)
    host = packed.cpu().numpy()  # one fetch
    results = []
    for i in range(B):
        # `lengths` advances on the step that emits the stop token, so
        # the output counts it (the stop token is part of the output).
        n = int(host[i, 2 * max_new])
        results.append({
            "output_ids": host[i, :n].astype(np.int64).tolist(),
            "output_logprobs": host[i, max_new:max_new + n].astype(np.float32).tolist(),
            "no_eos": not bool(host[i, 2 * max_new + 1]),
        })
    return results
