#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (areal_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--phases build,parity,serve_bf16,serve_int8,interrupt]
                          [--out report.json]

Phases (every one must pass; the script exits nonzero on the first that
fails, and on a machine without CUDA):

1. build       - compile every kernel of areal_tpu_torch/csrc with nvcc for
                 sm_90a (one nvcc per source, in parallel).
2. parity      - hold each kernel against its plain PyTorch version on the
                 card, at the serving path's shapes, with bf16 inputs made
                 from --seed; time kernel, plain version and (where one
                 exists) one PyTorch library call with CUDA events.
3. serve_bf16  - a ServingEngine at the full width of
                 DeepSeek-R1-Distill-Qwen-1.5B (seeded random weights)
                 serves a mix of requests with a bf16 KV pool; launch
                 counts of every kernel on that path must be > 0.
4. serve_int8  - the same with kv_cache_dtype="int8".
5. interrupt   - update_params mid-generation returns partial results
                 with interrupted=True and the new version goes live.

Before the last line it prints the card's name and power limit (as
nvidia-smi reports them) and one {"kernels": [...]} JSON line; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
# Parity limits for the bf16 attention outputs. ATOL caps the error
# anywhere; RTOL is per output row (one query head's hd values) against
# that row's largest reference value, about 2.5 bf16 ulps there, so a
# long-context row (values ~0.03) is held as tightly as a short one (~1).
ATOL = 2e-2
RTOL = 2e-2
LSE_ATOL = 1e-3  # f32 logsumexp
PHASES = ("build", "parity", "serve_bf16", "serve_int8", "interrupt")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() over `iters` runs, each bracketed by
    CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ----------------------------------------------------------------------
# Phase 2: kernel parity and timing
# ----------------------------------------------------------------------


def row_errors(out, ref):
    """(max abs error, max over output rows of max|out - ref| / max|ref|)."""
    d = (out.float() - ref.float()).abs().amax(dim=-1)
    m = ref.float().abs().amax(dim=-1).clamp(min=1e-6)
    return d.max().item(), (d / m).max().item()


def packed_rows(rng, R, T, seg_lens_per_row):
    seg = np.zeros((R, T), np.int32)
    pos = np.zeros((R, T), np.int32)
    for r, lens in enumerate(seg_lens_per_row):
        t = 0
        for s, n in enumerate(lens):
            seg[r, t:t + n] = s + 1
            pos[r, t:t + n] = np.arange(n)
            t += n
    return seg, pos


def flash_case(torch, rng, dev, R, T, Hq, Hkv, hd, seg_lens_per_row):
    bf = torch.bfloat16
    q = torch.from_numpy(rng.standard_normal((R, T, Hq, hd), np.float32)).to(dev, bf)
    k = torch.from_numpy(rng.standard_normal((R, T, Hkv, hd), np.float32)).to(dev, bf)
    v = torch.from_numpy(rng.standard_normal((R, T, Hkv, hd), np.float32)).to(dev, bf)
    seg, pos = packed_rows(rng, R, T, seg_lens_per_row)
    return q, k, v, torch.from_numpy(seg).to(dev), torch.from_numpy(pos).to(dev)


def plain_lse(torch, q, k, seg, pos, scale):
    from areal_tpu_torch.ops.attention import segment_causal_mask

    R, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(R, T, Hkv, Hq // Hkv, hd).float()
    s = torch.einsum("rqhgd,rkhd->rhgqk", qg, k.float()) * scale
    mask = segment_causal_mask(seg, pos)[:, None, None]
    s = torch.where(mask, s, float("-inf"))
    lse = torch.logsumexp(s, dim=-1).reshape(R, Hq, T)
    return lse, mask.any(dim=-1).reshape(R, 1, T).expand(R, Hq, T)


def parity_flash(torch, rng, dev, report):
    from areal_tpu_torch.ops.attention import _flash_fwd, reference_packed_attention

    cases = [
        # ragged packed rows: several segments, padding tail, T % 128 != 0
        ("ragged_T1000", 2, 1000, 12, 2, 128, [[300, 220, 417], [999]]),
        ("T4096", 1, 4096, 12, 2, 128, [[4096]]),
        ("hd64", 2, 333, 8, 2, 64, [[100, 200], [5, 300, 27]]),
    ]
    # The serving path's prefill shape: 8 prompts of 512-1024 tokens, one
    # per row, padded to a whole number of 128-token pages.
    lens = rng.integers(512, 1025, size=8)
    cases.append(("prefill_R8_T1024", 8, 1024, 12, 2, 128, [[int(n)] for n in lens]))
    errs, rels = [], []
    for name, R, T, Hq, Hkv, hd, seg_lens in cases:
        q, k, v, seg, pos = flash_case(torch, rng, dev, R, T, Hq, Hkv, hd, seg_lens)
        scale = hd ** -0.5
        out, lse = _flash_fwd(q, k, v, seg, pos, scale)
        ref = reference_packed_attention(q, k, v, seg, pos)
        err, rel = row_errors(out, ref)
        lse_ref, has_key = plain_lse(torch, q, k, seg, pos, scale)
        lse_err = (lse - lse_ref).abs()[has_key].max().item()
        pad_zero = out.float()[seg == 0].abs().max().item() if (seg == 0).any() else 0.0
        log(f"  flash {name}: max_abs_err={err:.3e} (tol {ATOL}) max_row_rel_err={rel:.3e} "
            f"(tol {RTOL}) lse_err={lse_err:.3e} (tol {LSE_ATOL}) pad_rows_max={pad_zero:.1e}")
        if not (err <= ATOL and rel <= RTOL and lse_err <= LSE_ATOL and pad_zero == 0.0
                and torch.isfinite(out.float()).all()):
            raise AssertionError(f"flash {name} disagrees with its plain version")
        errs.append(err)
        rels.append(rel)
    # Timing at the serving path's prefill shape (the last case). Only
    # valid tokens need q/k/v reads; out, lse, seg and pos span all of T.
    valid = [n for row in seg_lens for n in row]
    flops = sum(2.0 * n * n * hd * Hq for n in valid)
    nbytes = (sum(valid) * (Hq + 2 * Hkv) * hd * 2 + R * T * Hq * hd * 2
              + 2 * R * T * 4 + R * Hq * T * 4)
    b_ms, b_by = bound(flops, nbytes)
    ms = time_ms(lambda: _flash_fwd(q, k, v, seg, pos, scale))
    plain_ms = time_ms(lambda: reference_packed_attention(q, k, v, seg, pos), iters=5)
    # Library yardstick: one SDPA call with an explicit boolean mask (k/v
    # expanded to the q heads and the mask built beforehand, untimed).
    from areal_tpu_torch.ops.attention import segment_causal_mask

    group = Hq // Hkv
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    mask = segment_causal_mask(seg, pos)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask))
    report["flash_attn_fwd_bf16"] = dict(
        name="flash_attn_fwd_bf16", route="cuda",
        source="areal_tpu_torch/csrc/flash_attn.cu",
        replaces="areal_tpu/ops/pallas/flash_attn.py:119",
        max_abs_err=max(errs), max_row_rel_err=max(rels), ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f"R={R} T={T} Hq={Hq} Hkv={Hkv} hd={hd} valid={sum(valid)}",
    )
    log(f"  flash timing {report['flash_attn_fwd_bf16']['shape']}: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, sdpa {lib_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")


def paged_case(torch, rng, dev, B, Hq, Hkv, hd, pg, lengths, int8, trash_rows=(),
               shared_row=False):
    from areal_tpu_torch.engine.paged import quantize_kv

    P = max(-(-int(n) // pg) for n in lengths)
    n_used = 1 if shared_row else B
    N = 1 + n_used * P  # page 0 is the trash page
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    pi = np.zeros((B, P), np.int32)
    for b in range(B):
        if b in trash_rows:
            continue  # an inactive slot: its row routes to the trash page
        row = perm[:P] if shared_row else perm[b * P:(b + 1) * P]
        pi[b] = row
    q = torch.from_numpy(rng.standard_normal((B, Hq, hd), np.float32)).to(dev, torch.bfloat16)
    kf = torch.from_numpy(rng.standard_normal((Hkv, N, pg, hd), np.float32)).to(dev)
    vf = torch.from_numpy(rng.standard_normal((Hkv, N, pg, hd), np.float32)).to(dev)
    if int8:
        kw, ks = quantize_kv(kf)
        vw, vs = quantize_kv(vf)
        k_pool, v_pool = (kw, ks[..., 0].contiguous()), (vw, vs[..., 0].contiguous())
    else:
        k_pool, v_pool = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    lens = torch.tensor(np.asarray(lengths, np.int32), device=dev)
    page_indices = torch.from_numpy(pi).to(dev)
    if shared_row:
        page_indices = page_indices[:1].expand(B, P)
    return q, k_pool, v_pool, lens, page_indices


def parity_paged(torch, rng, dev, report, int8: bool):
    from areal_tpu_torch.engine.paged import _paged_attention_xla, _paged_decode_kernel

    kname = "paged_decode_int8" if int8 else "paged_decode_bf16"
    Hq, Hkv, hd = 12, 2, 128
    cases = [
        ("B1_pg128", 1, 128, [3001], (), False),
        ("B16_pg16_trash", 16, 16,
         list(rng.integers(1, 4097, size=15)) + [4096], (3, 9), False),
        ("B16_pg128", 16, 128, list(rng.integers(1, 4097, size=16)), (), False),
        ("B1_pg16", 1, 16, [17], (), False),
        # chunked prefill: 256 rows share one page row, staggered lengths
        ("chunk256_shared_row", 256, 128, list(2048 + np.arange(256)), (), True),
    ]
    errs, rels = [], []
    for name, B, pg, lengths, trash, shared in cases:
        q, kp, vp, lens, pi = paged_case(torch, rng, dev, B, Hq, Hkv, hd, pg,
                                         lengths, int8, trash, shared)
        scale = hd ** -0.5
        out = _paged_decode_kernel(q, kp, vp, lens, pi, scale)
        ref = _paged_attention_xla(q, kp, vp, lens, pi, scale)
        err, rel = row_errors(out, ref)
        log(f"  {kname} {name}: max_abs_err={err:.3e} (tol {ATOL}) "
            f"max_row_rel_err={rel:.3e} (tol {RTOL})")
        if not (err <= ATOL and rel <= RTOL and torch.isfinite(out.float()).all()):
            raise AssertionError(f"{kname} {name} disagrees with its plain version")
        errs.append(err)
        rels.append(rel)
    # Timing at the serving decode shape: 16 slots, page 128, ragged
    # contexts up to 4096 tokens.
    lengths = list(rng.integers(1024, 4097, size=16))
    q, kp, vp, lens, pi = paged_case(torch, rng, dev, 16, Hq, Hkv, hd, 128, lengths, int8)
    scale = hd ** -0.5
    tok = float(sum(lengths))
    per_tok = Hkv * 2 * ((hd + 4) if int8 else hd * 2)  # K and V bytes
    nbytes = tok * per_tok + 2 * q.numel() * 2 + pi.numel() * 4 + 16 * 4
    flops = tok * Hq * hd * 4
    b_ms, b_by = bound(flops, nbytes)
    ms = time_ms(lambda: _paged_decode_kernel(q, kp, vp, lens, pi, scale), iters=50)
    plain_ms = time_ms(lambda: _paged_attention_xla(q, kp, vp, lens, pi, scale))
    report[kname] = dict(
        name=kname, route="cuda", source="areal_tpu_torch/csrc/paged_decode.cu",
        replaces=("areal_tpu/ops/pallas/paged_decode_int8.py:109" if int8
                  else "areal_tpu/engine/paged.py:341"),
        max_abs_err=max(errs), max_row_rel_err=max(rels), ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"B=16 Hq={Hq} Hkv={Hkv} hd={hd} pg=128 sum_len={int(tok)}",
    )
    log(f"  {kname} timing {report[kname]['shape']}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")


# ----------------------------------------------------------------------
# Phases 3-5: serving
# ----------------------------------------------------------------------


def run_requests(engine, reqs, timeout=900.0):
    results, done = {}, threading.Event()
    lock = threading.Lock()

    def cb(res):
        with lock:
            results[res.qid] = res
            if len(results) == len(reqs):
                done.set()

    t0 = time.perf_counter()
    for r in reqs:
        r.done_cb = cb
        engine.submit(r)
    if not done.wait(timeout):
        raise TimeoutError(f"only {len(results)}/{len(reqs)} requests finished")
    wall = time.perf_counter() - t0
    errs = [r.error for r in results.values() if r.error]
    if errs:
        raise RuntimeError(f"serving failed: {errs[0]}")
    return results, wall


def mixed_requests(rng, vocab):
    from areal_tpu_torch.engine.serving import GenRequest

    plens = [64, 200, 3000, 1500, 700, 2600, 90, 1024, 1100, 400, 2048, 333,
             128, 900, 1800, 2999]
    reqs = []
    for i, n in enumerate(plens):
        mode = i % 4
        reqs.append(GenRequest(
            qid=f"mix{i}", input_ids=rng.integers(0, vocab, size=n).tolist(),
            max_new_tokens=int(rng.integers(64, 257)),
            greedy=mode == 0,
            temperature=1.0 if mode in (0, 1) else 0.7,
            top_p=0.9 if mode == 2 else 1.0,
            top_k=40 if mode == 3 else -1,
        ))
    twin = rng.integers(0, vocab, size=512).tolist()
    for j in range(2):
        reqs.append(GenRequest(qid=f"twin{j}", input_ids=list(twin),
                               max_new_tokens=96, greedy=True))
    return reqs


def check_results(torch, engine, cfg, params, reqs, results):
    """Every request finished with valid ids and logprobs <= 0; the twin
    greedy prompts agree; greedy outputs agree with a teacher-forced
    forward over prompt + output (the packed prefill path, a different
    computation from the paged decode that produced them)."""
    from areal_tpu_torch.models.transformer import forward

    V = cfg.vocab_size
    for r in reqs:
        res = results[r.qid]
        ids, lps = res.output_ids, res.output_logprobs
        if not (1 <= len(ids) <= r.max_new_tokens and len(lps) == len(ids)):
            raise AssertionError(f"{r.qid}: {len(ids)} tokens for budget {r.max_new_tokens}")
        if not all(0 <= t < V for t in ids):
            raise AssertionError(f"{r.qid}: token id out of range")
        if not all(math.isfinite(x) and x <= 0.0 for x in lps):
            raise AssertionError(f"{r.qid}: logprob not finite or > 0")
    if results["twin0"].output_ids != results["twin1"].output_ids:
        raise AssertionError("identical greedy prompts gave different tokens")
    diffs, agree, n_tok = [], 0, 0
    for r in reqs:
        if not r.greedy or len(r.input_ids) > 1100:
            continue
        res = results[r.qid]
        seq = list(r.input_ids) + res.output_ids[:-1]
        T = len(seq)
        ids = torch.tensor([seq], dtype=torch.int32, device=engine.device)
        seg = torch.ones_like(ids)
        pos = torch.arange(T, dtype=torch.int32, device=engine.device)[None]
        with torch.inference_mode():
            logits = forward(params, cfg, ids, seg, pos,
                             device=engine.device)[0, len(r.input_ids) - 1:]
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{r.qid}: non-finite teacher-forced logits")
        logp = torch.log_softmax(logits, dim=-1)
        out = torch.tensor(res.output_ids, device=engine.device)
        lp_tf = logp.gather(-1, out[:, None])[:, 0].cpu().numpy()
        diffs.extend(np.abs(lp_tf - np.asarray(res.output_logprobs)).tolist())
        # a greedy token is the forward's argmax, or within 0.1 nats of it
        gap = (logp.max(dim=-1).values - logp.gather(-1, out[:, None])[:, 0]).cpu().numpy()
        agree += int((gap <= 0.1).sum())
        n_tok += len(out)
    med = float(np.median(diffs))
    log(f"  teacher-forced check: {agree}/{n_tok} greedy tokens at the forward's argmax "
        f"(within 0.1 nats); median |logprob diff| {med:.4f}")
    if agree < 0.95 * n_tok or med > 0.05:
        raise AssertionError("greedy outputs disagree with the teacher-forced forward")


def _kernel_class(name: str) -> str:
    if "flash_fwd_kernel" in name:
        return "flash_attn_fwd_bf16"
    if "paged_decode_kernel" in name:
        return "paged_decode"
    low = name.lower()
    if any(s in low for s in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "matmul (cuBLAS)"
    if "sort" in low or "topk" in low:
        return "sampling sort/topk"
    return "other (elementwise, norms, copies, ...)"


def profile_window(torch, engine, reqs_fn):
    """Run one batch of requests under torch.profiler; return the device
    busy time by kernel class and the device idle share of the window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run_requests(engine, reqs_fn())
        torch.cuda.synchronize()
    by_class, busy_us = {}, 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us <= 0:
            continue
        busy_us += us
        c = _kernel_class(e.key)
        by_class[c] = by_class.get(c, 0.0) + us / 1e3
    busy_ms = busy_us / 1e3
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms,
                device_idle_share=max(0.0, 1.0 - busy_ms / (wall * 1e3)),
                device_ms_by_class=dict(sorted(by_class.items(), key=lambda kv: -kv[1])))


def serve_phase(torch, rng, dev, cfg, params, kv_cache_dtype):
    from areal_tpu_torch import kernels
    from areal_tpu_torch.engine.serving import GenRequest, ServingEngine

    engine = ServingEngine(
        cfg, params, max_batch_size=16, max_seq_len=4096, decode_block_steps=16,
        page_size=128, prefill_chunk=1024, prefill_max_batch=8,
        eos_token_id=151643, seed=int(rng.integers(1 << 30)),
        kv_cache_dtype=kv_cache_dtype, device=dev,
    )
    engine.start()
    try:
        # Warm-up (cuBLAS handles, allocator) outside the counted run.
        run_requests(engine, [GenRequest(qid="warm", input_ids=[1] * 64,
                                         max_new_tokens=17, greedy=True)])
        reqs = mixed_requests(rng, cfg.vocab_size)
        kernels.reset_launches()
        results, wall = run_requests(engine, reqs)
        counts = dict(kernels.launches)
        n_prompt = sum(len(r.input_ids) for r in reqs)
        n_out = sum(len(res.output_ids) for res in results.values())
        log(f"  mixed run: {len(reqs)} requests, {n_prompt} prompt tokens, {n_out} "
            f"output tokens in {wall:.2f} s ({n_out / wall:.1f} output tok/s); "
            f"launches {counts}")
        check_results(torch, engine, cfg, params, reqs, results)
        # Prefill throughput and TTFT: 16 prompts of 1024 tokens, 1 new token.
        burst = [GenRequest(qid=f"ttft{i}", input_ids=rng.integers(0, cfg.vocab_size, 1024).tolist(),
                            max_new_tokens=1) for i in range(16)]
        res_b, wall_b = run_requests(engine, burst)
        ttft = sorted(r.latency for r in res_b.values())
        # Decode throughput: 16 short prompts decode 128 tokens each past
        # the first; the prefill time of the same prompts is subtracted.
        prompts = [rng.integers(0, cfg.vocab_size, 128).tolist() for _ in range(16)]
        _, wall_p = run_requests(engine, [GenRequest(qid=f"p{i}", input_ids=p, max_new_tokens=1)
                                          for i, p in enumerate(prompts)])
        _, wall_d = run_requests(engine, [GenRequest(
            qid=f"d{i}", input_ids=p, max_new_tokens=129, min_new_tokens=129, greedy=True)
            for i, p in enumerate(prompts)])
        stats = dict(
            requests=len(reqs), prompt_tokens=n_prompt, output_tokens=n_out,
            mixed_wall_s=wall, mixed_output_tok_s=n_out / wall,
            prefill_tok_s=16 * 1024 / wall_b,
            ttft_p50_ms=1e3 * ttft[len(ttft) // 2], ttft_max_ms=1e3 * ttft[-1],
            decode_tok_s=16 * 128 / max(wall_d - wall_p, 1e-9),
            launches=counts,
        )
        log(f"  prefill {stats['prefill_tok_s']:.0f} tok/s (16 x 1024), TTFT p50 "
            f"{stats['ttft_p50_ms']:.1f} ms max {stats['ttft_max_ms']:.1f} ms; decode "
            f"{stats['decode_tok_s']:.1f} tok/s (16 slots x 128 tokens)")
        # Where the time goes: profiled windows of prefill only (16 x 1024
        # prompts, 1 new token), short-context decode (the decode run
        # above) and long-context decode (16 x 3000-token prompts, 32 new
        # tokens; chunked prefill included).
        V = cfg.vocab_size
        long_prompts = [rng.integers(0, V, 3000).tolist() for _ in range(16)]
        windows = {
            "prefill_16x1024": lambda: [GenRequest(
                qid=f"wp{i}", input_ids=rng.integers(0, V, 1024).tolist(),
                max_new_tokens=1) for i in range(16)],
            "decode_16x128": lambda: [GenRequest(
                qid=f"wd{i}", input_ids=p, max_new_tokens=129, min_new_tokens=129,
                greedy=True) for i, p in enumerate(prompts)],
            "long_16x3000": lambda: [GenRequest(
                qid=f"wl{i}", input_ids=p, max_new_tokens=33, min_new_tokens=33,
                greedy=True) for i, p in enumerate(long_prompts)],
        }
        stats["profile"] = {}
        for wname, fn in windows.items():
            prof = profile_window(torch, engine, fn)
            stats["profile"][wname] = prof
            top = ", ".join(f"{k} {v:.1f} ms" for k, v in prof["device_ms_by_class"].items())
            log(f"  profile {wname}: wall {prof['wall_ms']:.1f} ms, device busy "
                f"{prof['device_busy_ms']:.1f} ms (idle share "
                f"{prof['device_idle_share']:.3f}); {top}")
        return stats
    finally:
        engine.stop()


def interrupt_phase(torch, rng, dev, cfg, params):
    from areal_tpu_torch import kernels
    from areal_tpu_torch.engine.serving import GenRequest, ServingEngine

    engine = ServingEngine(cfg, params, max_batch_size=4, max_seq_len=4096,
                           decode_block_steps=16, page_size=128, prefill_chunk=1024,
                           eos_token_id=None, seed=7, device=dev)
    engine.start()
    try:
        results, done = {}, threading.Event()

        def cb(res):
            results[res.qid] = res
            if len(results) == 4:
                done.set()

        kernels.reset_launches()
        for i in range(4):
            engine.submit(GenRequest(qid=f"long{i}", input_ids=rng.integers(0, cfg.vocab_size, 256).tolist(),
                                     max_new_tokens=3000, done_cb=cb))
        t0 = time.monotonic()
        while engine.decode_blocks < 4 and time.monotonic() - t0 < 300:
            time.sleep(0.05)
        new_params = {k: v for k, v in params.items()}
        new_params["final_norm"] = {"weight": params["final_norm"]["weight"] * 1.01}
        engine.update_params(new_params, allow_interrupt=True)
        if not done.wait(300):
            raise TimeoutError("interrupted requests did not return")
        for res in results.values():
            if not (res.interrupted and res.no_eos and 0 < len(res.output_ids) < 3000
                    and res.version_start == 0):
                raise AssertionError(f"bad interrupted result {res.qid}: "
                                     f"interrupted={res.interrupted} n={len(res.output_ids)}")
        t0 = time.monotonic()
        while engine.version != 1 and time.monotonic() - t0 < 60:
            time.sleep(0.05)
        after, _ = run_requests(engine, [GenRequest(qid="after", input_ids=[5, 6, 7],
                                                    max_new_tokens=8)])
        if engine.version != 1 or after["after"].version_start != 1:
            raise AssertionError("weight update did not go live")
        counts = dict(kernels.launches)
        for k in ("flash_attn_fwd_bf16", "paged_decode_bf16"):
            if counts[k] <= 0:
                raise AssertionError(f"interrupt: kernel {k} was not launched")
        lens = sorted(len(r.output_ids) for r in results.values())
        log(f"  interrupted 4 requests at {lens} tokens; version {engine.version}; "
            f"launches {counts}")
        return dict(partial_tokens=lens, launches=counts)
    finally:
        engine.stop()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--out", default=None, help="also write the full report here (JSON)")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        log("CUDA is not available: this script runs the port on an NVIDIA GPU")
        return 2
    from areal_tpu_torch import kernels, resolve_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device("cuda")
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} ({card}); torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    rng = np.random.default_rng(args.seed)
    report = {"card": card, "phases": {}}
    kernel_rows = {}
    t_start = time.perf_counter()

    log("phase build")
    secs = kernels.build_all()
    for name, text in kernels.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  [{name}] {line.strip()}")
    log(f"  built {len(kernels.SOURCES)} kernel libraries in {secs:.1f} s")
    report["phases"]["build"] = {"seconds": secs}

    if "parity" in phases:
        log("phase parity")
        parity_flash(torch, rng, dev, kernel_rows)
        parity_paged(torch, rng, dev, kernel_rows, int8=False)
        parity_paged(torch, rng, dev, kernel_rows, int8=True)
        torch.cuda.synchronize()

    serving = [p for p in phases if p in ("serve_bf16", "serve_int8", "interrupt")]
    main_counts = {}
    if serving:
        from areal_tpu_torch.models.hf.qwen2 import r1_distill_qwen_1_5b_config
        from areal_tpu_torch.models.transformer import count_params, init_params

        cfg = r1_distill_qwen_1_5b_config()
        t0 = time.perf_counter()
        params = init_params(cfg, seed=args.seed, device=dev, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        log(f"model: R1-Distill-Qwen-1.5B widths, {count_params(params) / 1e9:.3f} B "
            f"params (bf16, seeded random) in {time.perf_counter() - t0:.1f} s")
        for ph, kvd, need in (("serve_bf16", None, ("flash_attn_fwd_bf16", "paged_decode_bf16")),
                              ("serve_int8", "int8", ("flash_attn_fwd_bf16", "paged_decode_int8"))):
            if ph not in phases:
                continue
            log(f"phase {ph}")
            report["phases"][ph] = serve_phase(torch, rng, dev, cfg, params, kvd)
            counts = report["phases"][ph]["launches"]
            for k in need:
                if counts[k] <= 0:
                    raise AssertionError(f"{ph}: kernel {k} was not launched")
                main_counts.setdefault(k, counts[k])
            torch.cuda.empty_cache()
        if "interrupt" in phases:
            log("phase interrupt")
            report["phases"]["interrupt"] = interrupt_phase(torch, rng, dev, cfg, params)
        del params
        torch.cuda.empty_cache()

    kernels_line = []
    for name, row in kernel_rows.items():
        row = dict(row)
        # null where no serve phase that runs this kernel ran
        row["launches"] = main_counts.get(name)
        row["kernel_ms"] = row["ms"]  # the same time under its other name
        row["card"] = card
        kernels_line.append(row)
    report["kernels"] = kernels_line
    report["seconds"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    log(f"total {report['seconds']:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
