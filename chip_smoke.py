#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (areal_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out report.json] [--profile-serving]
        [--phases build,parity,serve_bf16,serve_int8,interrupt,http,grad,train,workers,
                  async_ppo]

Phases (every one must pass; the script exits nonzero on the first that
fails, and on a machine without CUDA):

1. build       - compile every kernel of areal_tpu_torch/csrc with nvcc for
                 sm_90a (one nvcc per source, in parallel).
2. parity      - hold each kernel against its plain PyTorch version on the
                 card, at the serving and training paths' shapes, with
                 inputs made from --seed; the attention kernels' tile-pair
                 counts against the skip predicate and two runs bit-equal;
                 time kernel, plain version and (where one exists) one
                 PyTorch library call (the forward, paged decode and both
                 GAE entries by the device time of their kernels beside
                 the whole call, the backward with CUDA events).
3. serve_bf16  - a ServingEngine at the full width of
                 DeepSeek-R1-Distill-Qwen-1.5B (seeded random weights)
                 serves a mix of requests with a bf16 KV pool; launch
                 counts of every kernel on that path must be > 0.
                 --profile-serving adds the profiled windows.
4. serve_int8  - the same with kv_cache_dtype="int8".
5. interrupt   - update_params mid-generation returns partial results
                 with interrupted=True and the new version goes live.
6. http        - the port's GenerationServer in process, at the full
                 width and depth, with the qid prefix cache and
                 token-budget admission, driven over HTTP: a mixed wave
                 from 18 client threads (checked as serve_bf16's), six
                 continuations that must hit the prefix cache, the same
                 wave through the engine alone (the server's overhead),
                 greedy requests bit-equal over HTTP and direct, a weight
                 update from a raw dump mid-wave, a stale retry, and
                 shedding; launch counts through the server must be > 0.
7. grad        - at full width and 2 layers, the gradients of the SFT loss
                 through the kernels against the plain attention on the
                 card, leaf by leaf.
8. train       - a TorchTrainEngine at the full width and depth of
                 R1-Distill-Qwen-1.5B (float32 params, bf16 compute): PPO
                 actor inference, one train_step (GAE, advantage
                 normalization, 4 minibatch updates), then 3 SFT steps;
                 launch counts of the forward, both backward kernels and
                 the fused GAE entry (packed_gae_f32) must be > 0.
9. workers     - the trainer half of the worker system through
                 LocalController(ExperimentConfig).run(): a spawned model
                 worker loads the actor from an HF directory of seeded
                 random weights at the full width and 14 of the 28
                 layers (the async_ppo phase runs all 28; float32
                 params, bf16 compute) and pulls 2 steps of the train
                 phase's PPO batch, pushed from this process as a
                 rollout worker would; the master runs 2 actor_train
                 steps, each followed by the raw-dump weight hand-off.
                 A GenerationServer here takes the last dump through
                 /update_weights_from_disk; greedy tokens over HTTP must
                 equal an engine's on the dumped params. Launches of the
                 forward, both backward kernels and packed_gae_f32 in the
                 worker, and of the forward and paged_decode_bf16 in the
                 server, must be > 0.
10. async_ppo  - the async RL loop through the port's entry point,
                 areal_tpu_torch.training.main_async_ppo.main(argv) with
                 the reference's override keys: a GenerationServer (bf16
                 pool, 16 slots x 4096 tokens), the gserver manager, a
                 rollout worker running the math agent and env over a
                 seeded prompt set under a tiny tokenizer, and a model
                 worker training the actor at full width and depth (float32
                 params, bf16 compute) for 2 steps at
                 max_head_offpolicyness 1. The fanout must land versions
                 1 and 2 on the server, every trained sample must be within
                 the staleness bound, and launches of the forward and
                 paged_decode_bf16 in the server and of the forward, both
                 backward kernels and packed_gae_f32 in the model worker
                 must be > 0.

Before the last line it prints the card's name and power limit (as
nvidia-smi reports them) and one {"kernels": [...]} JSON line; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
# Parity limits for the bf16 attention outputs. ATOL caps the error
# anywhere; RTOL is per output row (one query head's hd values) against
# that row's largest reference value, about 2.5 bf16 ulps there, so a
# long-context row (values ~0.03) is held as tightly as a short one (~1).
ATOL = 2e-2
RTOL = 2e-2
LSE_ATOL = 1e-3  # f32 logsumexp
# Gradients of attention (bf16) have no fixed scale (dk and dv sum over
# thousands of queries), so their limits are relative: every output row
# (one head's hd values of one token) within RTOL of that row's largest
# reference value, and the whole tensor within GRAD_TOL of its largest. A
# row's scale is taken as at least ROW_FLOOR of the tensor's: the dq row of
# a sequence's first token is dout.v - dout.out = 0 but for rounding.
GRAD_TOL = 2e-2
ROW_FLOOR = 1e-3
GAE_RTOL = 1e-5  # f32 scan, against max(1, max|ref|)
# Operations a token of the fused GAE entry: delta (3), the scan's
# multiply-add (2), x + V (1).
PACKED_GAE_FLOPS = 6.0
# The PPO step's batch as rows of 4096; few long chain-of-thought rows; a
# large batch (512 prompts x 16 answers x 2k tokens).
GAE_TIMING_SHAPES = ((16, 4096), (2, 32768), (4096, 4096))
# Shapes at which both GAE plan modes (a whole row a CTA; one-chunk tiles
# across CTAs) are timed beside each other, on both sides of each of
# gae_plan's two conditions (rows of at most 4 chunks; R >= SMs, 132).
GAE_PLAN_SHAPES = ((64, 4096), (4096, 4096), (66, 8192), (66, 16384), (132, 16384),
                   (33, 32768))
# SFT-loss gradients through the kernels against the plain attention, bf16
# compute end to end: per leaf, against the leaf's largest reference value.
LEAF_TOL = 5e-2
PHASES = ("build", "parity", "serve_bf16", "serve_int8", "interrupt", "http", "grad", "train",
          "workers", "async_ppo")
# The train phase at real size; a rehearsal on the CPU passes smaller ones.
TRAIN_SIZES = dict(n_prompts=8, group=4, prompt=(128, 512), response=(256, 3072),
                   row_len=4096, max_tokens_per_mb=16384, n_minibatches=4,
                   sft_seqs=8, sft_steps=3)


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


def device_ms(fn, names=None, iters: int = 20, warmup: int = 3, per_call=None) -> float:
    """Device milliseconds per call of fn(): the time of the CUDA kernels
    it launched whose names contain one of `names` (all of them when
    None), summed by torch.profiler. CUDA events around a call also count
    the host's time to enqueue it, which for a short kernel behind a
    Python wrapper is the longer of the two. `per_call`, where given, is
    how many such kernels one call launches: the time is then the mean of
    the launches the profiler saw, times `per_call`, so a window that lost
    some of its device events still reads true; one that lost more than
    half is taken again. `per_call="auto"` (a library call whose kernel
    count is not known beforehand) takes it as the launches seen over the
    calls, rounded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # A profiling window now and then comes back without some or all of
    # its device events; such a window is taken again, up to four times.
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and (names is None or any(n in e.key for n in names))]
        us = sum(e.self_device_time_total for e in seen)
        if us > 0 and per_call is None:
            return us / 1e3 / iters
        n = sum(e.count for e in seen)
        if per_call == "auto":
            per_call = max(1, round(n / iters))
        if us > 0 and 2 * n >= per_call * iters:
            if n != per_call * iters:
                log(f"  profiler: {n} of {per_call * iters} launches of {names} seen")
            return us / 1e3 / n * per_call
    raise RuntimeError(f"the profiler saw no device time, or not all launches, for kernels "
                       f"{names}")


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ----------------------------------------------------------------------
# Phase 2: kernel parity and timing
# ----------------------------------------------------------------------


def row_errors(out, ref, floor=1e-6):
    """(max abs error, max over output rows of max|out - ref| / max|ref|),
    a row's max|ref| taken as at least `floor`."""
    d = (out.float() - ref.float()).abs().amax(dim=-1)
    m = ref.float().abs().amax(dim=-1).clamp(min=floor)
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


def time_flash_fwd(torch, q, k, v, seg, pos, seg_lens, scale, plain_iters=5):
    """The forward kernel at one shape: its device time and bound, the
    pre-pass (tile ranges), the whole wrapper call, and the plain
    version's and SDPA's times on the same inputs."""
    from areal_tpu_torch.ops.attention import (
        _flash_fwd, fwd_tile, reference_packed_attention, segment_causal_mask,
        tile_segment_ranges)

    R, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    # Only valid tokens need q/k/v reads; out, lse, seg and pos span all of T.
    valid = [n for row in seg_lens for n in row]
    flops = sum(2.0 * n * n * hd * Hq for n in valid)
    nbytes = (sum(valid) * (Hq + 2 * Hkv) * hd * 2 + R * T * Hq * hd * 2
              + 2 * R * T * 4 + R * Hq * T * 4)
    b_ms, b_by = bound(flops, nbytes)
    ranges = tile_segment_ranges(seg, fwd_tile())
    ms = device_ms(lambda: _flash_fwd(q, k, v, seg, pos, scale, ranges), ("flash_fwd_kernel",),
                   per_call=1)
    pre_ms = device_ms(lambda: tile_segment_ranges(seg, fwd_tile()), per_call="auto")
    call_ms = time_ms(lambda: _flash_fwd(q, k, v, seg, pos, scale))
    plain_ms = time_ms(lambda: reference_packed_attention(q, k, v, seg, pos),
                       iters=plain_iters, warmup=1)
    # Library yardstick: one SDPA call with an explicit boolean mask (k/v
    # expanded to the q heads and the mask built beforehand, untimed), its
    # kernels' device time.
    group = Hq // Hkv
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    mask = segment_causal_mask(seg, pos)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = device_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask), per_call="auto")
    return dict(shape=f"R={R} T={T} Hq={Hq} Hkv={Hkv} hd={hd} valid={sum(valid)} "
                f"seqs={len(valid)}",
                ms=ms, pre_pass_ms=pre_ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


def parity_flash(torch, rng, dev, report, case_rng):
    """The forward kernel against its plain version. The training-shape
    case draws from `case_rng`, so the draws of `rng`, and the later
    phases' batches, are those of a run without it."""
    from areal_tpu_torch.ops.attention import (
        _flash_fwd, fwd_tile, live_tile_pairs, reference_packed_attention, tile_segment_ranges)

    cases = [
        # ragged packed rows: several segments, padding tail, T % 128 != 0
        ("ragged_T1000", rng, 2, 1000, 12, 2, 128, [[300, 220, 417], [999]]),
        ("T4096", rng, 1, 4096, 12, 2, 128, [[4096]]),
        ("hd64", rng, 2, 333, 8, 2, 64, [[100, 200], [5, 300, 27]]),
    ]
    # The serving path's prefill shape: 8 prompts of 512-1024 tokens, one
    # per row, padded to a whole number of 128-token pages.
    lens = rng.integers(512, 1025, size=8)
    cases.append(("prefill_R8_T1024", rng, 8, 1024, 12, 2, 128, [[int(n)] for n in lens]))
    # The training shape: rows of 4096 tokens, 2-6 sequences and a padding
    # tail each (the backward's timed case).
    cases.append(("train_R4_T4096", case_rng, 4, 4096, 12, 2, 128,
                  random_seg_lens(case_rng, 4, 4096)))
    timed = ("prefill_R8_T1024", "train_R4_T4096")
    errs, rels, timings, counted = [], [], {}, {}
    for name, gen, R, T, Hq, Hkv, hd, seg_lens in cases:
        q, k, v, seg, pos = flash_case(torch, gen, dev, R, T, Hq, Hkv, hd, seg_lens)
        scale = hd ** -0.5
        out, lse = _flash_fwd(q, k, v, seg, pos, scale)
        # Two runs bit-equal (remat runs the forward twice), and a counting
        # launch: the (q head, q tile, kv tile) steps its CTAs ran must equal
        # the skip predicate's count, with outputs bit-equal to the plain
        # launch's.
        out2, lse2 = _flash_fwd(q, k, v, seg, pos, scale)
        ranges = tile_segment_ranges(seg, fwd_tile())
        out3, lse3, pairs = _flash_fwd(q, k, v, seg, pos, scale, ranges, count_pairs=True)
        counted[name] = int(pairs.sum().item())
        predicate = int(live_tile_pairs(ranges).sum().item()) * Hq
        n_tiles = ranges.shape[1]
        causal_only = R * n_tiles * (n_tiles + 1) // 2 * Hq
        same = all(torch.equal(a, b) for a, b in ((out, out2), (lse, lse2), (out, out3),
                                                  (lse, lse3)))
        log(f"  flash {name} tile pairs (q head, q tile, kv tile): counted by the kernel "
            f"{counted[name]}, the skip predicate {predicate}, causal only {causal_only}; "
            f"two runs and the counting launch bit-equal: {same}")
        if not (same and counted[name] == predicate):
            raise AssertionError(f"flash {name}: runs differ or the kernel's tile pairs "
                                 f"disagree with the skip predicate")
        del out2, lse2, out3, lse3
        ref = reference_packed_attention(q, k, v, seg, pos)
        err, rel = row_errors(out, ref)
        del ref
        lse_ref, has_key = plain_lse(torch, q, k, seg, pos, scale)
        lse_err = (lse - lse_ref).abs()[has_key].max().item()
        del lse_ref, has_key
        pad_zero = out.float()[seg == 0].abs().max().item() if (seg == 0).any() else 0.0
        log(f"  flash {name}: max_abs_err={err:.3e} (tol {ATOL}) max_row_rel_err={rel:.3e} "
            f"(tol {RTOL}) lse_err={lse_err:.3e} (tol {LSE_ATOL}) pad_rows_max={pad_zero:.1e}")
        if not (err <= ATOL and rel <= RTOL and lse_err <= LSE_ATOL and pad_zero == 0.0
                and torch.isfinite(out.float()).all()):
            raise AssertionError(f"flash {name} disagrees with its plain version")
        errs.append(err)
        rels.append(rel)
        if name in timed:
            timings[name] = time_flash_fwd(torch, q, k, v, seg, pos, seg_lens, scale,
                                           plain_iters=5 if T <= 1024 else 2)
            t = timings[name]
            log(f"  flash timing {t['shape']}: kernel {t['ms']:.4f} ms (device), pre-pass "
                f"{t['pre_pass_ms']:.4f} ms, whole call {t['call_ms']:.3f} ms (events); plain "
                f"{t['plain_ms']:.3f} ms, sdpa {t['library_ms']:.4f} ms (device), bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    # The kernels line carries the serving path's prefill shape; the
    # training shape rides along.
    t = timings["prefill_R8_T1024"]
    report["flash_attn_fwd_bf16"] = dict(
        name="flash_attn_fwd_bf16", route="cuda",
        source="areal_tpu_torch/csrc/flash_attn.cu",
        replaces="areal_tpu/ops/pallas/flash_attn.py:119",
        max_abs_err=max(errs), max_row_rel_err=max(rels), ms=t["ms"],
        pre_pass_ms=t["pre_pass_ms"], call_ms=t["call_ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"], shape=t["shape"],
        tile_pairs_counted=counted["prefill_R8_T1024"],
        training_shape=dict(timings["train_R4_T4096"],
                            tile_pairs_counted=counted["train_R4_T4096"]))


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


def paged_bound(Hq, Hkv, hd, int8, lengths, n_rows, n_kv_tokens, pi_words):
    """Least time of one paged-attention call: each row's q read and out
    written once, the K/V of `n_kv_tokens` distinct tokens read once, the
    page table and lengths once; two products per (row, head, token)."""
    per_tok = Hkv * 2 * ((hd + 4) if int8 else hd * 2)  # K and V bytes
    nbytes = n_kv_tokens * per_tok + 2 * n_rows * Hq * hd * 2 + pi_words * 4 + n_rows * 4
    flops = float(sum(lengths)) * Hq * hd * 4
    return bound(flops, nbytes)


def parity_paged(torch, rng, dev, report, int8: bool, case_rng):
    """Both modes of the paged kernel against the plain version: decode
    steps (a page row per sequence) and chunk steps (rows of one prompt
    sharing one page row). The timed chunk case draws from `case_rng`, so
    the draws of `rng`, and the later phases' requests, are those of a run
    without it."""
    from areal_tpu_torch.engine.paged import (
        _paged_attention_xla, _paged_decode_kernel, _sm_count, split_plan)

    kname = "paged_decode_int8" if int8 else "paged_decode_bf16"
    Hq, Hkv, hd = 12, 2, 128
    cases = [
        ("B1_pg128", rng, 1, 128, [3001], (), False),
        ("B16_pg16_trash", rng, 16, 16,
         list(rng.integers(1, 4097, size=15)) + [4096], (3, 9), False),
        ("B16_pg128", rng, 16, 128, list(rng.integers(1, 4097, size=16)), (), False),
        ("B1_pg16", rng, 1, 16, [17], (), False),
        # chunked prefill: 256 rows share one page row, staggered lengths
        ("chunk256_shared_row", rng, 256, 128, list(2048 + np.arange(256)), (), True),
        # the third 1024-token chunk of a 3000-token prompt: rows at
        # positions 2048..3071 (952 valid, the rest inactive rows that the
        # engine still runs) over one page row of 24 pages
        ("chunk1024_start2048", case_rng, 1024, 128, list(2048 + 1 + np.arange(1024)), (),
         True),
        # 100 rows (off the 64-row tile) from position 37 (mid-page) over
        # 16-token pages: a 64-token kv tile spans four pages
        ("chunk100_start37_pg16", case_rng, 100, 16, list(37 + 1 + np.arange(100)), (), True),
    ]
    errs, rels = [], []
    for name, gen, B, pg, lengths, trash, shared in cases:
        q, kp, vp, lens, pi = paged_case(torch, gen, dev, B, Hq, Hkv, hd, pg,
                                         lengths, int8, trash, shared)
        scale = hd ** -0.5
        out = _paged_decode_kernel(q, kp, vp, lens, pi, scale)
        ref = _paged_attention_xla(q, kp, vp, lens, pi, scale)
        err, rel = row_errors(out, ref)
        del ref
        log(f"  {kname} {name}: max_abs_err={err:.3e} (tol {ATOL}) "
            f"max_row_rel_err={rel:.3e} (tol {RTOL})")
        if not (err <= ATOL and rel <= RTOL and torch.isfinite(out.float()).all()):
            raise AssertionError(f"{kname} {name} disagrees with its plain version")
        errs.append(err)
        rels.append(rel)
        if name == "chunk1024_start2048":
            b_ms, b_by = paged_bound(Hq, Hkv, hd, int8, lengths, B, max(lengths), pi.shape[1])
            chunk = dict(
                shape=f"B={B} rows sharing one page row, lengths {min(lengths)}-"
                      f"{max(lengths)}, Hq={Hq} Hkv={Hkv} hd={hd} pg={pg}",
                ms=device_ms(lambda: _paged_decode_kernel(q, kp, vp, lens, pi, scale),
                             ("paged_chunk_kernel",), per_call=1),
                call_ms=time_ms(lambda: _paged_decode_kernel(q, kp, vp, lens, pi, scale)),
                plain_ms=time_ms(lambda: _paged_attention_xla(q, kp, vp, lens, pi, scale),
                                 iters=3, warmup=1),
                bound_ms=b_ms, bound_by=b_by)
            log(f"  {kname} timing chunk {chunk['shape']}: kernel {chunk['ms']:.4f} ms "
                f"(device), whole call {chunk['call_ms']:.4f} ms (events); plain "
                f"{chunk['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
        del q, kp, vp, out
        torch.cuda.empty_cache()
    # Timing at the serving decode shape: 16 slots, page 128, ragged
    # contexts up to 4096 tokens.
    lengths = list(rng.integers(1024, 4097, size=16))
    q, kp, vp, lens, pi = paged_case(torch, rng, dev, 16, Hq, Hkv, hd, 128, lengths, int8)
    scale = hd ** -0.5
    b_ms, b_by = paged_bound(Hq, Hkv, hd, int8, lengths, 16, sum(lengths), pi.numel())
    splits, per = split_plan(16, Hkv, pi.shape[1], _sm_count(q.device.index or 0))
    out = _paged_decode_kernel(q, kp, vp, lens, pi, scale)
    same = torch.equal(out, _paged_decode_kernel(q, kp, vp, lens, pi, scale))
    log(f"  {kname} decode timing shape: {splits} splits of {per} pages over "
        f"{pi.shape[1]} pages a row; two runs bit-equal: {same}")
    if not same:
        raise AssertionError(f"{kname}: two decode runs differ")
    # A split launch runs its splits, then a combine: two kernels a call.
    ms = device_ms(lambda: _paged_decode_kernel(q, kp, vp, lens, pi, scale),
                   ("paged_split_kernel", "paged_combine_kernel"), iters=50,
                   per_call=2 if splits > 1 else 1)
    call_ms = time_ms(lambda: _paged_decode_kernel(q, kp, vp, lens, pi, scale), iters=50)
    plain_ms = time_ms(lambda: _paged_attention_xla(q, kp, vp, lens, pi, scale))
    report[kname] = dict(
        name=kname, route="cuda", source="areal_tpu_torch/csrc/paged_decode.cu",
        replaces=("areal_tpu/ops/pallas/paged_decode_int8.py:109" if int8
                  else "areal_tpu/engine/paged.py:341"),
        max_abs_err=max(errs), max_row_rel_err=max(rels), ms=ms, call_ms=call_ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"B=16 Hq={Hq} Hkv={Hkv} hd={hd} pg=128 sum_len={int(sum(lengths))}",
        splits=splits, pages_per_split=per, chunk=chunk,
    )
    log(f"  {kname} timing {report[kname]['shape']}: kernel {ms:.4f} ms (device: splits and "
        f"combine), whole call {call_ms:.4f} ms (events); plain {plain_ms:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")


def random_seg_lens(rng, R, T, lo=2, hi=6, pad_max=512):
    """Per row, `lo`..`hi` sequence lengths that fill T less a padding tail."""
    rows = []
    for _ in range(R):
        n = int(rng.integers(lo, hi + 1))
        used = T - int(rng.integers(1, pad_max + 1))
        cuts = np.sort(rng.choice(np.arange(1, used), size=n - 1, replace=False))
        rows.append(np.diff([0, *cuts.tolist(), used]).tolist())
    return rows


def short_seq_lens(rng, R, n, lo, hi):
    """Per row, `n` sequence lengths drawn from lo..hi."""
    return [rng.integers(lo, hi + 1, size=n).tolist() for _ in range(R)]


def time_flash_bwd(torch, q, k, v, dout, seg, pos, seg_lens, out, lse, scale):
    """Both backward kernels at one shape: their times and bounds, and the
    plain backward's and SDPA's backward's times on the same inputs."""
    from areal_tpu_torch.ops.attention import (
        _bwd_delta, _launch_dkv, _launch_dq, bwd_tile, reference_packed_attention_bwd,
        segment_causal_mask, tile_segment_ranges)

    R, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    # Work of the run's inputs: causal pairs within each sequence, reads of
    # valid tokens.
    valid = [n for row in seg_lens for n in row]
    pairs = sum(n * (n + 1) / 2.0 for n in valid)
    product = 2.0 * pairs * hd * Hq  # flops of one [T, T] x hd product
    tok = sum(valid)
    q_bytes, kv_bytes = tok * Hq * hd * 2, tok * Hkv * hd * 2
    stat_bytes = 2 * R * Hq * T * 4 + 2 * R * T * 4  # lse, delta, seg, pos
    full_q, full_kv = R * T * Hq * hd * 2, R * T * Hkv * hd * 2  # outputs span T
    dq_bound = bound(3 * product, 2 * q_bytes + 2 * kv_bytes + stat_bytes + full_q)
    dkv_bound = bound(4 * product, 2 * q_bytes + 2 * kv_bytes + stat_bytes + 2 * full_kv)
    whole_bound = bound(5 * product, 3 * q_bytes + 2 * kv_bytes + stat_bytes
                        + full_q + 2 * full_kv)
    delta = _bwd_delta(out, dout)
    ranges = tile_segment_ranges(seg, bwd_tile())
    args = (q, k, v, dout, seg, pos, lse, delta, ranges)
    dq_ms = time_ms(lambda: _launch_dq(*args, scale), iters=10)
    dkv_ms = time_ms(lambda: _launch_dkv(*args, scale), iters=10)
    pre_ms = time_ms(lambda: (_bwd_delta(out, dout), tile_segment_ranges(seg, bwd_tile())),
                     iters=10)
    plain_ms = time_ms(lambda: reference_packed_attention_bwd(
        q, k, v, seg, pos, dout, out=out, lse=lse), iters=3, warmup=1)
    # Library yardstick: autograd through one SDPA call with the boolean
    # mask (its forward untimed), which gives dq, dk and dv together.
    group = Hq // Hkv
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt = k.repeat_interleave(group, dim=2).transpose(1, 2).contiguous().requires_grad_(True)
    vt = v.repeat_interleave(group, dim=2).transpose(1, 2).contiguous().requires_grad_(True)
    mask = segment_causal_mask(seg, pos)[:, None]
    o = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    do = dout.transpose(1, 2).contiguous()
    lib_ms = time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), do, retain_graph=True),
                     iters=10)
    return dict(
        shape=f"R={R} T={T} Hq={Hq} Hkv={Hkv} hd={hd} valid={tok} seqs={len(valid)}",
        dq_ms=dq_ms, dkv_ms=dkv_ms, pre_pass_ms=pre_ms, plain_ms=plain_ms, library_ms=lib_ms,
        dq_bound=dq_bound, dkv_bound=dkv_bound, whole_bound=whole_bound)


def log_flash_bwd_timing(t):
    log(f"  flash_bwd timing {t['shape']}: dq {t['dq_ms']:.3f} ms (bound "
        f"{t['dq_bound'][0]:.4f} ms, {t['dq_bound'][1]}), dk/dv {t['dkv_ms']:.3f} ms (bound "
        f"{t['dkv_bound'][0]:.4f} ms, {t['dkv_bound'][1]}), pre-pass (delta, tile ranges) "
        f"{t['pre_pass_ms']:.3f} ms; whole backward bound {t['whole_bound'][0]:.4f} ms "
        f"({t['whole_bound'][1]}); plain {t['plain_ms']:.1f} ms, sdpa backward "
        f"{t['library_ms']:.3f} ms")


def count_tile_pairs(torch, name, q, k, v, dout, seg, pos, out, lse, scale, got):
    """A counting launch of each backward kernel: the (q head, q tile, kv
    tile) products its CTAs ran, as the kernel counted them, which must
    equal the plain skip predicate's count; the counting launch's outputs
    must be bit-equal to the plain launch's `got`. Returns the two counts
    and whether both checks held."""
    from areal_tpu_torch.ops.attention import (
        _bwd_delta, _launch_dkv, _launch_dq, bwd_tile, live_tile_pairs, tile_segment_ranges)

    Hq = q.shape[2]
    ranges = tile_segment_ranges(seg, bwd_tile())
    args = (q, k, v, dout, seg, pos, lse, _bwd_delta(out, dout), ranges, scale)
    dq, dq_pairs = _launch_dq(*args, count_pairs=True)
    dk, dv, dkv_pairs = _launch_dkv(*args, count_pairs=True)
    counted = {"dq": int(dq_pairs.sum().item()), "dkv": int(dkv_pairs.sum().item())}
    predicate = int(live_tile_pairs(ranges).sum().item()) * Hq
    R, n = ranges.shape[:2]
    causal_only = R * n * (n + 1) // 2 * Hq
    ok = (counted["dq"] == predicate == counted["dkv"]
          and all(torch.equal(a, b) for a, b in zip((dq, dk, dv), got)))
    log(f"  flash_bwd {name} tile pairs (q head, q tile, kv tile): counted by the kernels "
        f"dq {counted['dq']}, dk/dv {counted['dkv']}; the skip predicate (live_tile_pairs, "
        f"from the inputs) {predicate}; causal only (from the shape) {causal_only}, so "
        f"{counted['dq'] / causal_only:.3f} of it computed; counting launch bit-equal: "
        f"{ok}")
    return counted, ok


def parity_flash_bwd(torch, rng, dev, report, case_rng):
    """Both backward kernels against the plain backward on the same
    inputs: q, k, v, dout and the forward kernel's out and logsumexp (which
    parity_flash holds against the plain forward). The short-sequence and
    one-sequence cases draw from `case_rng`, so the draws of `rng`, and the
    later phases' batches, are those of a run without them."""
    from areal_tpu_torch.ops.attention import (
        _flash_bwd, _flash_fwd, reference_packed_attention_bwd)

    cases = [
        ("ragged_T1000", rng, 2, 1000, 12, 2, 128, [[300, 220, 417], [999]]),
        ("hd64", rng, 2, 333, 8, 2, 64, [[100, 200], [5, 300, 27]]),
        ("all_padding_row", rng, 2, 200, 12, 2, 128, [[64, 100], []]),
        # 32 sequences of 64-200 tokens a row (ragged T): most tile pairs
        # under the diagonal are skipped
        ("short_seqs_R2_T6500", case_rng, 2, 6500, 12, 2, 128,
         short_seq_lens(case_rng, 2, 32, 64, 200)),
        # one sequence a row: the causal-only worst case, nothing skipped
        ("one_seq_R4_T4096", case_rng, 4, 4096, 12, 2, 128, [[4096]] * 4),
        # the training shape: rows of 4096 tokens, 2-6 sequences and a
        # padding tail each
        ("train_R4_T4096", rng, 4, 4096, 12, 2, 128, random_seg_lens(rng, 4, 4096)),
    ]
    timed = ("one_seq_R4_T4096", "train_R4_T4096")
    errs = {"dq": [], "dk": [], "dv": []}
    failed = []
    timings, pairs = {}, {}
    for name, gen, R, T, Hq, Hkv, hd, seg_lens in cases:
        q, k, v, seg, pos = flash_case(torch, gen, dev, R, T, Hq, Hkv, hd, seg_lens)
        dout = torch.from_numpy(gen.standard_normal((R, T, Hq, hd), np.float32)).to(
            dev, torch.bfloat16)
        scale = hd ** -0.5
        out, lse = _flash_fwd(q, k, v, seg, pos, scale)
        got = _flash_bwd(q, k, v, seg, pos, out, lse, dout, scale)
        again = _flash_bwd(q, k, v, seg, pos, out, lse, dout, scale)
        ref = reference_packed_attention_bwd(q, k, v, seg, pos, dout, out=out, lse=lse)
        torch.cuda.synchronize()
        parts = []
        for tname, g, g2, w in zip(("dq", "dk", "dv"), got, again, ref):
            top = w.float().abs().max().item()
            err, rel = row_errors(g, w, floor=ROW_FLOOR * top)
            pad = g.float()[seg == 0].abs().max().item() if (seg == 0).any() else 0.0
            parts.append(f"{tname} abs={err:.3e} of max|ref|={top:.3e} row_rel={rel:.3e} "
                         f"pad_rows_max={pad:.1e}")
            if not (err <= GRAD_TOL * top and rel <= RTOL and pad == 0.0
                    and torch.isfinite(g.float()).all() and torch.equal(g, g2)):
                failed.append(f"{name} {tname}")
            errs[tname].append(err)
        log(f"  flash_bwd {name}: " + "; ".join(parts)
            + f" (limits: {GRAD_TOL} of max|ref|, row {RTOL}; two runs bit-equal)")
        pairs[name], pairs_ok = count_tile_pairs(torch, name, q, k, v, dout, seg, pos, out,
                                                 lse, scale, got)
        if not pairs_ok:
            failed.append(f"{name} tile pairs")
        del got, again, ref
        if name in timed:
            timings[name] = time_flash_bwd(torch, q, k, v, dout, seg, pos, seg_lens,
                                           out, lse, scale)
            log_flash_bwd_timing(timings[name])
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"flash backward disagrees with its plain version, between two "
                             f"runs or with the skip predicate: {failed}")
    # The kernels line carries the training shape, the main path's.
    t = timings["train_R4_T4096"]
    counted = pairs["train_R4_T4096"]
    for kname, replaces, ms, (b_ms, b_by), err, n_pairs in (
            ("flash_attn_bwd_dq_bf16", "areal_tpu/ops/pallas/flash_attn.py:265", t["dq_ms"],
             t["dq_bound"], max(errs["dq"]), counted["dq"]),
            ("flash_attn_bwd_dkv_bf16", "areal_tpu/ops/pallas/flash_attn.py:295", t["dkv_ms"],
             t["dkv_bound"], max(errs["dk"] + errs["dv"]), counted["dkv"])):
        report[kname] = dict(
            name=kname, route="cuda", source="areal_tpu_torch/csrc/flash_attn_bwd.cu",
            replaces=replaces, max_abs_err=err, ms=ms, plain_ms=t["plain_ms"], bound_ms=b_ms,
            bound_by=b_by, library_ms=t["library_ms"], shape=t["shape"],
            tile_pairs_counted=n_pairs,
            note="plain_ms and library_ms time dq, dk and dv together")
    report["flash_attn_bwd_dq_bf16"]["whole_backward"] = dict(
        ms=t["dq_ms"] + t["dkv_ms"] + t["pre_pass_ms"], pre_pass_ms=t["pre_pass_ms"],
        bound_ms=t["whole_bound"][0], bound_by=t["whole_bound"][1])
    one = timings["one_seq_R4_T4096"]
    report["flash_attn_bwd_dq_bf16"]["one_sequence"] = dict(
        shape=one["shape"], ms=one["dq_ms"], bound_ms=one["dq_bound"][0],
        library_ms=one["library_ms"], plain_ms=one["plain_ms"])
    report["flash_attn_bwd_dkv_bf16"]["one_sequence"] = dict(
        shape=one["shape"], ms=one["dkv_ms"], bound_ms=one["dkv_bound"][0],
        library_ms=one["library_ms"], plain_ms=one["plain_ms"])


def gae_batch(rng, R, T, seg_len):
    """A packed PPO batch for GAE as numpy [R, T] arrays: rewards, values,
    int32 segment ids and bootstraps. Each row holds segments of
    seg_len[0]..seg_len[1] tokens with 0-2 padding tokens between them and
    a padding tail (the segment it meets is cut there). Rewards are a small
    per-token (KL-like) term plus a score at each segment's last token;
    about half the segments are truncated and bootstrap there."""
    seg = np.zeros((R, T), np.int32)
    for r in range(R):
        used = T - int(rng.integers(0, T // 8 + 1))
        t, s = int(rng.integers(0, 3)), 1
        while t < used:
            end = min(t + int(rng.integers(seg_len[0], seg_len[1] + 1)), used)
            seg[r, t:end] = s
            s += 1
            t = end + int(rng.integers(0, 3))
    valid = seg > 0
    nxt = np.concatenate([seg[:, 1:], np.zeros((R, 1), np.int32)], axis=1)
    last = valid & (seg != nxt)
    rew = rng.standard_normal((R, T), np.float32) * np.float32(0.01)
    rew[last] += rng.standard_normal(int(last.sum()), np.float32)
    val = rng.standard_normal((R, T), np.float32) * valid
    boot = np.zeros((R, T), np.float32)
    trunc = last & (rng.random((R, T)) < 0.5)
    boot[trunc] = rng.standard_normal(int(trunc.sum()), np.float32)
    return rew * valid, val, seg, boot


def parity_gae(torch, rng, dev, report, gae_rng):
    """Both GAE entries against their plain versions (the serial scan
    loop; the affine elements, that loop and the masking), two runs of
    each bit-equal, then device time, call time and bound at three
    shapes. The scan's five random cases and its [16, 4096] timing input
    draw from `rng`, the packed batches from `gae_rng`, which keeps the
    later phases' batches those of earlier versions of this script."""
    from areal_tpu_torch.ops.gae import (
        CHUNK, GaePlan, _gae_affine_elems, _packed_gae_kernel, _scan_kernel, gae_plan,
        reference_packed_gae, reference_scan_reverse)

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def case(R, T):
        # a is gamma * lam inside a segment and 0 at its end and on padding
        a = np.full((R, T), 0.97 * 0.95, np.float32)
        b = rng.standard_normal((R, T), np.float32)
        for r in range(R):
            ends = rng.choice(np.arange(T), size=min(T, int(rng.integers(1, 7))), replace=False)
            a[r, ends] = 0.0
            tail = int(rng.integers(0, T // 4 + 1))
            if tail:
                a[r, T - tail:] = 0.0
                b[r, T - tail:] = 0.0
        return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)

    errs = {"gae_scan_f32": [], "packed_gae_f32": []}

    def check(kname, label, got, ref, again, zero=None):
        scale = max(1.0, max(r.abs().max().item() for r in ref))
        err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        same = all(torch.equal(g, h) for g, h in zip(got, again))
        zeros = zero is None or all(bool((g[zero] == 0).all()) for g in got)
        log(f"  {kname} {label}: max_abs_err={err:.3e} against scale {scale:.3f} "
            f"(tol {GAE_RTOL} relative); two runs bit-equal: {same}; zeros outside "
            f"segments: {zeros}")
        if not (err <= GAE_RTOL * scale and all(torch.isfinite(g).all() for g in got)
                and same and zeros):
            raise AssertionError(f"{kname} {label} disagrees with its plain version")
        errs[kname].append((err, err / scale))

    for R, T in ((16, 4096), (5, 1000), (3, 5001), (1, 7), (300, 129)):
        a, b = case(R, T)
        check("gae_scan_f32", f"[{R}, {T}] random", [_scan_kernel(a, b)],
              [reference_scan_reverse(a, b)], [_scan_kernel(a, b)])
    # Packed batches: the five shapes with short segments, then gamma =
    # lam = 1 (the PPO default: a = 1, float32 sums over thousands of
    # tokens), few long rows, and a large batch.
    cases = [(R, T, (3, 400), 0.97, 0.95)
             for R, T in ((16, 4096), (5, 1000), (3, 5001), (1, 7), (300, 129))]
    cases += [(8, 16384, (2048, 12288), 1.0, 1.0), (2, 32768, (2048, 24576), 1.0, 0.95),
              (4096, 4096, (64, 3072), 0.97, 0.95)]
    for R, T, seg_len, gamma, lam in cases:
        rew, val, seg, boot = (torch.from_numpy(x).to(dev)
                               for x in gae_batch(gae_rng, R, T, seg_len))
        label = f"[{R}, {T}] segments {seg_len[0]}-{seg_len[1]} gamma {gamma} lam {lam}"
        a, b, _, _ = _gae_affine_elems(rew, val, seg, boot, gamma, lam)
        check("gae_scan_f32", label, [_scan_kernel(a, b)], [reference_scan_reverse(a, b)],
              [_scan_kernel(a, b)])
        check("packed_gae_f32", label, _packed_gae_kernel(rew, val, seg, boot, gamma, lam),
              reference_packed_gae(rew, val, seg, boot, gamma, lam),
              _packed_gae_kernel(rew, val, seg, boot, gamma, lam), zero=seg == 0)
        del rew, val, seg, boot, a, b
        torch.cuda.empty_cache()

    # Timing: the PPO step's shape (the whole batch as 16 rows of 4096),
    # few long rows, a large batch. The plain loop (one serial step a
    # token) is timed at the first only.
    scan_in = case(16, 4096)
    timings = {"gae_scan_f32": [], "packed_gae_f32": []}
    for i, (R, T) in enumerate(GAE_TIMING_SHAPES):
        rew, val, seg, boot = (torch.from_numpy(x).to(dev)
                               for x in gae_batch(gae_rng, R, T, (64, 3072)))
        a, b = scan_in if i == 0 else _gae_affine_elems(rew, val, seg, boot, 0.97, 0.95)[:2]
        plan = gae_plan(R, T, n_sm)
        n = R * T
        for kname, fn, plain, nbytes, flops in (
                ("gae_scan_f32", lambda: _scan_kernel(a, b),
                 lambda: reference_scan_reverse(a, b), 12.0, 2.0),
                ("packed_gae_f32", lambda: _packed_gae_kernel(rew, val, seg, boot, 0.97, 0.95),
                 lambda: reference_packed_gae(rew, val, seg, boot, 0.97, 0.95), 24.0,
                 PACKED_GAE_FLOPS)):
            b_ms, b_by = bound(flops * n, nbytes * n, PEAK_F32_FLOPS)
            t = dict(shape=[R, T], ms=device_ms(fn, ["gae_"], iters=50, per_call=1),
                     call_ms=time_ms(fn, iters=50), bound_ms=b_ms, bound_by=b_by,
                     tile=plan.tile, tiles_per_row=plan.tiles, ctas=plan.ctas)
            if i == 0:
                t["plain_ms"] = time_ms(plain, iters=2, warmup=1)
            timings[kname].append(t)
            log(f"  {kname} timing [{R}, {T}]: kernel {t['ms']:.5f} ms (device), whole call "
                f"{t['call_ms']:.5f} ms (events); bound {b_ms:.5f} ms ({b_by}); "
                f"{plan.tiles} tiles of {plan.tile} a row, {plan.ctas} CTAs"
                + (f"; plain {t['plain_ms']:.1f} ms" if i == 0 else ""))
        del rew, val, seg, boot, a, b
        torch.cuda.empty_cache()

    # Both plan modes at each shape, whatever gae_plan picks there: a whole
    # row a CTA against one-chunk tiles across CTAs, on the same inputs,
    # held to each other within GAE_RTOL.
    modes = []
    gen = torch.Generator(device=dev).manual_seed(0)
    for R, T in GAE_PLAN_SHAPES:
        a = torch.where(torch.rand((R, T), generator=gen, device=dev) < 1e-3, 0.0,
                        0.97 * 0.95).float()
        b = torch.randn((R, T), generator=gen, device=dev)
        seg = (torch.arange(T, device=dev, dtype=torch.int32) // 1500 + 1).expand(R, T)
        seg = torch.where(torch.arange(T, device=dev) < T - T // 16, seg, 0).contiguous()
        chunks = -(-T // CHUNK)
        whole, split = GaePlan(chunks * CHUNK, 1, R), GaePlan(CHUNK, chunks, R * chunks)
        row = dict(shape=[R, T], chosen="whole" if gae_plan(R, T, n_sm) == whole else "split")
        for kname, fn in (
                ("gae_scan_f32", lambda plan: (_scan_kernel(a, b, plan),)),
                ("packed_gae_f32", lambda plan: _packed_gae_kernel(b, a, seg, b, 0.97, 0.95,
                                                                   plan))):
            outs = [fn(whole), fn(split)]
            scale = max(1.0, outs[0][0].abs().max().item())
            err = max((u - w).abs().max().item() for u, w in zip(*outs))
            if not err <= GAE_RTOL * scale:
                raise AssertionError(f"{kname} [{R}, {T}]: the two plan modes differ by {err}")
            row[kname] = dict(
                whole_ms=device_ms(lambda: fn(whole), ["gae_"], iters=30, per_call=1),
                split_ms=device_ms(lambda: fn(split), ["gae_"], iters=30, per_call=1))
            log(f"  {kname} plan modes [{R}, {T}] ({row['chosen']} chosen): whole rows "
                f"{row[kname]['whole_ms']:.5f} ms, split {row[kname]['split_ms']:.5f} ms "
                f"(device); modes agree to {err:.2e}")
        modes.append(row)
        del a, b, seg, outs
        torch.cuda.empty_cache()

    for kname in timings:
        first = timings[kname][0]
        report[kname] = dict(
            name=kname, route="cuda", source="areal_tpu_torch/csrc/gae_scan.cu",
            replaces="areal_tpu/ops/pallas/gae_scan.py:113",
            max_abs_err=max(e for e, _ in errs[kname]),
            max_rel_err=max(r for _, r in errs[kname]), ms=first["ms"],
            call_ms=first["call_ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bound_ms"], bound_by=first["bound_by"], library_ms=None,
            shape="R=16 T=4096 f32", tiles_per_row=first["tiles_per_row"],
            ctas=first["ctas"], timings=timings[kname],
            plan_modes=[dict(shape=m["shape"], chosen=m["chosen"], **m[kname]) for m in modes])


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
    if "flash_bwd_dq_kernel" in name:
        return "flash_attn_bwd_dq_bf16"
    if "flash_bwd_dkv_kernel" in name:
        return "flash_attn_bwd_dkv_bf16"
    if "packed_gae_kernel" in name:
        return "packed_gae_f32"
    if "gae_scan_kernel" in name:
        return "gae_scan_f32"
    if "paged_split_kernel" in name or "paged_combine_kernel" in name:
        return "paged decode, decode steps"
    if "paged_chunk_kernel" in name:
        return "paged decode, chunk steps"
    low = name.lower()
    if any(s in low for s in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "matmul (cuBLAS)"
    if "sort" in low or "topk" in low:
        return "sampling sort/topk"
    return "other (elementwise, norms, copies, ...)"


def profile_window(torch, fn):
    """Run fn() (which returns its wall seconds) under torch.profiler;
    return the device busy time by kernel class and the device idle share
    of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = fn()
        torch.cuda.synchronize()
    # Device rows only (kernels, memcpys, memsets): an operator's row
    # repeats the time of the kernels it launched.
    by_class, by_name, busy_us = {}, {}, 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        if us <= 0:
            continue
        busy_us += us
        c = _kernel_class(e.key)
        by_class[c] = by_class.get(c, 0.0) + us / 1e3
        by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    busy_ms = busy_us / 1e3
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms,
                device_idle_share=max(0.0, 1.0 - busy_ms / (wall * 1e3)),
                device_ms_by_class=dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
                top_kernels=[[k[:100], v] for k, v in
                             sorted(by_name.items(), key=lambda kv: -kv[1])[:16]])


def serve_phase(torch, rng, dev, cfg, params, kv_cache_dtype, profiled=False):
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
        if not profiled:
            return stats
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
            prof = profile_window(torch, lambda: run_requests(engine, fn())[1])
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


# ----------------------------------------------------------------------
# Phase 6: the generation server over HTTP
# ----------------------------------------------------------------------

STOP_TOKEN = 151643  # R1-Distill-Qwen's end-of-sentence id: the server has no tokenizer


def http_call(url, path, payload=None, headers=None, timeout=900.0):
    """(status, headers, parsed body) of one request to the server; a
    POST when `payload` is given. /metrics parses to {name: value}."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data,
                                 {"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, hdrs, body = resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        status, hdrs, body = e.code, dict(e.headers), e.read()
    if path == "/metrics":
        return status, hdrs, dict(line.split(" ", 1) for line in body.decode().splitlines())
    return status, hdrs, json.loads(body)


def generate_body(req, priority=None):
    """A GenRequest as the /generate JSON a rollout worker sends."""
    body = {"qid": req.qid, "input_ids": list(req.input_ids), "gconfig": {
        "max_new_tokens": req.max_new_tokens, "min_new_tokens": req.min_new_tokens,
        "greedy": req.greedy, "temperature": req.temperature, "top_p": req.top_p,
        "top_k": req.top_k, "stop_token_ids": list(req.stop_token_ids)}}
    if priority is not None:
        body["priority"] = priority
    return body


def http_wave(url, bodies):
    """POST every body from its own client thread, all released together;
    returns ({qid: response}, wall seconds). Every answer must be a 200
    with the reference's response keys; each response also carries
    `http_s`, its round trip as the client saw it less the engine's
    `latency` (submit to result): the time the request spent in HTTP and
    in the server's handler."""
    from types import SimpleNamespace

    keys = {"qid", "output_ids", "output_logprobs", "no_eos", "interrupted",
            "version_start", "version_end", "latency"}
    out, errors = {}, []
    start = threading.Barrier(len(bodies) + 1)

    def client(body):
        start.wait()
        t0 = time.monotonic()
        try:
            status, _, reply = http_call(url, "/generate", body)
        except Exception as e:  # reported below, with the qid
            status, reply = None, repr(e)
        if status != 200 or set(reply) != keys:
            errors.append(f"{body['qid']}: {status} {reply}")
        else:
            out[body["qid"]] = SimpleNamespace(
                **reply, http_s=time.monotonic() - t0 - reply["latency"])

    threads = [threading.Thread(target=client, args=(b,)) for b in bodies]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"/generate failed: {errors[:3]}")
    return out, wall


def perturbed(torch, params, seed):
    """A second seeded param set: each leaf times (1 + 0.01 N(0, 1)),
    drawn on the params' device."""
    gen = torch.Generator(device=next(iter(params["final_norm"].values())).device)
    gen.manual_seed(seed)

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        noise = torch.randn(x.shape, generator=gen, device=x.device, dtype=torch.float32)
        return (x.float() * (1.0 + 0.01 * noise)).to(x.dtype)

    return leaf(params)


def http_phase(torch, rng, dev, cfg, seed, card):
    """The port's GenerationServer in process, at the serving phases'
    configuration plus the qid prefix cache and token-budget admission,
    driven through HTTP: a mixed wave from 18 client threads, six
    continuations that must hit the prefix cache, the same wave through
    the engine alone, greedy requests equal over HTTP and direct, a
    weight update from a raw dump mid-wave (interrupted results, the
    resubmissions on version 1, a stale retry), and admission shedding."""
    import dataclasses
    import shutil
    import tempfile

    from areal_tpu_torch import kernels
    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.system_api import GenerationServerConfig
    from areal_tpu_torch.base import name_resolve, names
    from areal_tpu_torch.engine.serving import GenRequest
    from areal_tpu_torch.system.generation_server import GenerationServer
    from areal_tpu_torch.system.weight_transfer import dump_raw_params

    tmp = tempfile.mkdtemp(prefix="chip_smoke_http_")
    name_resolve.reconfigure("nfs", record_root=os.path.join(tmp, "name_resolve"))
    # An experiment name of this run's own: a weight update looks in
    # /dev/shm/areal_tpu/<experiment>/<trial>/<role> before the dump it is
    # given, and must not find another run's dump there.
    exp = os.path.basename(tmp)
    gcfg = GenerationServerConfig(
        experiment_name=exp, trial_name="http", server_index=0,
        model=ModelAbstraction("tpu_transformer", args=dict(config=dataclasses.asdict(cfg))),
        max_concurrent_requests=16, max_seq_len=4096, kv_page_size=128,
        decode_block_steps=16, prefill_chunk=1024, prefix_cache_tokens=65536,
        prefill_token_budget=8192, warm_on_start=True, seed=seed, device=str(dev))
    server = GenerationServer()
    t0 = time.perf_counter()
    server.configure(gcfg, experiment_name=gcfg.experiment_name, trial_name=gcfg.trial_name,
                     worker_name=gcfg.worker_name)
    run = threading.Thread(target=server.run, daemon=True)
    run.start()
    stats = dict(card=card)
    try:
        url = name_resolve.get(names.gen_server_url(exp, "http", "0"))
        engine = server.engine
        # /health first. It also builds urllib's opener (an SSL context
        # among its handlers, ~0.5 s with 18 threads racing to build it),
        # which the wave's first requests would otherwise pay inside
        # their round trips, as a long-lived client does not.
        status, _, health = http_call(url, "/health")
        if status != 200 or health != {"status": "ok", "version": 0, "role": "unified"}:
            raise AssertionError(f"http: /health answered {status} {health}")
        log(f"  server at {url} in {time.perf_counter() - t0:.1f} s (seeded random weights, "
            f"warm_on_start)")

        # The mixed wave over HTTP, the prefix-cache continuations after it,
        # the launches of each counted from 0. Nothing else launches a
        # kernel until both counts are read: the checks come after.
        reqs = mixed_requests(rng, cfg.vocab_size)
        for r in reqs:
            r.stop_token_ids = (STOP_TOKEN,)
        engine.latency_snapshot(reset=True)
        kernels.reset_launches()
        results, wall = http_wave(url, [generate_body(r) for r in reqs])
        counts_wave = dict(kernels.launches)
        _, _, m_wave = http_call(url, "/metrics")
        cont = [r for r in reqs if r.qid in ("mix1", "mix4", "mix9", "mix12", "mix13", "twin0")]
        cont_bodies = []
        for r in cont:
            fresh = rng.integers(0, cfg.vocab_size, size=32).tolist()
            c = GenRequest(qid=r.qid, input_ids=list(r.input_ids) + results[r.qid].output_ids
                           + fresh, max_new_tokens=32, greedy=True,
                           stop_token_ids=(STOP_TOKEN,))
            cont_bodies.append(generate_body(c, priority=0))
        kernels.reset_launches()
        _, cont_wall = http_wave(url, cont_bodies)
        counts_cont = dict(kernels.launches)
        counts = {k: counts_wave.get(k, 0) + counts_cont.get(k, 0)
                  for k in set(counts_wave) | set(counts_cont)}
        _, _, m = http_call(url, "/metrics")
        hits = float(m["areal:prefix_cache_hits"])
        n_prompt = sum(len(r.input_ids) for r in reqs)
        n_out = sum(len(res.output_ids) for res in results.values())
        http_ms = sorted(1e3 * res.http_s for res in results.values())
        check_results(torch, engine, engine.cfg, engine.params, reqs, results)
        log(f"  http wave: {len(reqs)} requests, {n_prompt} prompt tokens, {n_out} output "
            f"tokens in {wall:.2f} s ({n_out / wall:.1f} output tok/s); TTFT p50 "
            f"{m_wave['areal:ttft_p50_ms']} p99 {m_wave['areal:ttft_p99_ms']} ms, ITL p50 "
            f"{m_wave['areal:itl_p50_ms']} p99 {m_wave['areal:itl_p99_ms']} ms (/metrics "
            f"bucket edges); HTTP and handler time a request (round trip less engine "
            f"latency) median {http_ms[len(http_ms) // 2]:.1f} ms, max {http_ms[-1]:.1f} ms; "
            f"{card}")
        log(f"  continuations: {len(cont)} in {cont_wall:.2f} s; prefix_cache_hits {hits}, "
            f"prefix_tokens_reused {m['areal:prefix_tokens_reused']}; launches through the "
            f"server: wave {counts_wave}, continuations {counts_cont}")
        if hits < 6:
            raise AssertionError(f"http: prefix_cache_hits {hits} < 6 after the continuations")
        for k in ("flash_attn_fwd_bf16", "paged_decode_bf16"):
            if counts.get(k, 0) <= 0:
                raise AssertionError(f"http: kernel {k} was not launched through the server")

        # The same wave through the engine alone (new qids, no cache hits),
        # its launches and latencies apart.
        direct = [dataclasses.replace(r, qid=r.qid + "-direct", done_cb=None) for r in reqs]
        engine.latency_snapshot(reset=True)
        kernels.reset_launches()
        res_d, wall_d = run_requests(engine, direct)
        counts_d = dict(kernels.launches)
        snap_d = engine.latency_snapshot()
        n_out_d = sum(len(x.output_ids) for x in res_d.values())
        log(f"  engine alone, same wave: {n_out_d} output tokens in {wall_d:.2f} s "
            f"({n_out_d / wall_d:.1f} output tok/s; HTTP wall {wall:.2f} s); TTFT p50 "
            f"{snap_d['ttft_p50_ms']} p99 {snap_d['ttft_p99_ms']} ms, ITL p50 "
            f"{snap_d['itl_p50_ms']} p99 {snap_d['itl_p99_ms']} ms; launches {counts_d}")

        # Greedy requests one at a time: over HTTP and direct, bit-equal.
        for i, n in enumerate((300, 700)):
            r = GenRequest(qid=f"eq{i}", input_ids=rng.integers(0, cfg.vocab_size, n).tolist(),
                           max_new_tokens=64, greedy=True, stop_token_ids=(STOP_TOKEN,))
            status, _, over_http = http_call(url, "/generate", generate_body(r))
            alone, _ = run_requests(engine, [dataclasses.replace(r, qid=f"eq{i}-direct")])
            if status != 200 or over_http["output_ids"] != alone[f"eq{i}-direct"].output_ids:
                raise AssertionError(f"http: greedy eq{i} differs over HTTP and direct")
        log("  greedy requests over HTTP and through the engine alone: tokens bit-equal")

        # A weight update from a raw dump while a wave of 16 decodes.
        t1 = time.perf_counter()
        dump_dir = os.path.join(tmp, "param_realloc", "actor")
        new_params = perturbed(torch, engine.params, seed + 1)
        dump_s = dump_raw_params(new_params, dump_dir, version=1)
        del new_params
        torch.cuda.empty_cache()
        log(f"  raw dump of a second seeded param set: {dump_s:.1f} s")
        wave = [GenRequest(qid=f"upd{i}", input_ids=rng.integers(0, cfg.vocab_size, 256).tolist(),
                           max_new_tokens=2048, min_new_tokens=2048, greedy=True,
                           stop_token_ids=(STOP_TOKEN,)) for i in range(16)]
        box = {}
        waver = threading.Thread(target=lambda: box.update(
            zip(("res", "wall"), http_wave(url, [generate_body(r) for r in wave]))))
        waver.start()
        deadline = time.monotonic() + 300
        while float(http_call(url, "/metrics")[2]["areal:num_running_reqs"]) < 16:
            if time.monotonic() > deadline:
                raise TimeoutError("http: the update wave never ran 16 requests")
            time.sleep(0.05)
        status, _, upd = http_call(url, "/update_weights_from_disk", {
            "model_path": dump_dir, "allow_interrupt": True, "version": 1})
        waver.join()
        # The phase writes its dump to disk only, so the disk is the source.
        if status != 200 or not upd.get("success") or upd["source"] != "disk_raw":
            raise AssertionError(f"http: weight update failed: {status} {upd}")
        partial = box["res"]
        if not all(x.interrupted and 0 < len(x.output_ids) < 2048 and x.version_start == 0
                   for x in partial.values()):
            raise AssertionError("http: the wave was not interrupted by the update")
        # The partial-rollout protocol: resubmit prompt + partial output.
        resub, _ = http_wave(url, [generate_body(GenRequest(
            qid=r.qid, input_ids=list(r.input_ids) + partial[r.qid].output_ids,
            max_new_tokens=16, greedy=True, stop_token_ids=(STOP_TOKEN,)), priority=0)
            for r in wave])
        if not all(x.version_start == x.version_end == 1 and not x.interrupted
                   for x in resub.values()):
            raise AssertionError("http: resubmissions did not run on version 1")
        _, _, m = http_call(url, "/metrics")
        if m["areal:weight_version"] != "1.0":
            raise AssertionError(f"http: weight_version {m['areal:weight_version']}")
        status, _, stale = http_call(url, "/update_weights_from_disk", {
            "model_path": dump_dir, "allow_interrupt": True, "version": 1})
        if status != 200 or stale.get("stale") is not True:
            raise AssertionError(f"http: the retry of version 1 was not stale: {stale}")
        log(f"  weight update mid-wave: source {upd['source']}, load_s {upd['load_s']:.3f}, "
            f"last_weight_stage_s {m['areal:last_weight_stage_s']}, last_weight_swap_s "
            f"{m['areal:last_weight_swap_s']}; 16 interrupted at "
            f"{sorted(len(x.output_ids) for x in partial.values())} tokens (version_end "
            f"{sorted({x.version_end for x in partial.values()})}), resubmitted on version 1; "
            f"stale retry recognized; {time.perf_counter() - t1:.1f} s; {card}")

        # Admission shedding.
        http_call(url, "/configure", {"max_queue_depth": 0})
        status, hdrs, shed = http_call(url, "/generate", generate_body(reqs[0]))
        http_call(url, "/configure", {"max_queue_depth": None})
        if status != 429 or "Retry-After" not in hdrs or shed.get("error") != "overloaded":
            raise AssertionError(f"http: max_queue_depth=0 did not shed: {status} {shed}")
        log(f"  shed: 429, Retry-After {hdrs['Retry-After']}")
        stats.update(
            requests=len(reqs), prompt_tokens=n_prompt, output_tokens=n_out, wave_wall_s=wall,
            wave_output_tok_s=n_out / wall, wave_launches=counts_wave,
            continuation_launches=counts_cont,
            http_ms_median=http_ms[len(http_ms) // 2], http_ms_max=http_ms[-1],
            engine_alone_wall_s=wall_d, engine_alone_output_tokens=n_out_d,
            engine_alone_output_tok_s=n_out_d / wall_d, engine_alone_launches=counts_d,
            engine_alone_ttft_p50_ms=snap_d["ttft_p50_ms"],
            engine_alone_ttft_p99_ms=snap_d["ttft_p99_ms"],
            engine_alone_itl_p50_ms=snap_d["itl_p50_ms"],
            engine_alone_itl_p99_ms=snap_d["itl_p99_ms"],
            ttft_p50_ms=float(m_wave["areal:ttft_p50_ms"]),
            ttft_p99_ms=float(m_wave["areal:ttft_p99_ms"]),
            itl_p50_ms=float(m_wave["areal:itl_p50_ms"]),
            itl_p99_ms=float(m_wave["areal:itl_p99_ms"]),
            prefix_cache_hits=hits, continuation_wall_s=cont_wall, load_s=upd["load_s"],
            dump_s=dump_s, last_weight_stage_s=float(m["areal:last_weight_stage_s"]),
            last_weight_swap_s=float(m["areal:last_weight_swap_s"]), launches=counts)
        return stats
    finally:
        server.exit()
        run.join(timeout=120)
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# Phases 7-8: training
# ----------------------------------------------------------------------


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def leaf_paths(tree, prefix=""):
    """Names of a param tree's leaves in `optimizer.tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}/{k}")]
    return [prefix.lstrip("/")]


def _draw(rng, lo_hi) -> int:
    return int(rng.integers(lo_hi[0], lo_hi[1] + 1))


def rollout_sample(rng, sizes, vocab):
    """A seeded rollout batch as the rollout workers hand it to the
    trainer: `n_prompts` prompts with `group` responses each, prompt mask,
    per-sequence rewards (a good and a bad answer alternate) and no-EOS
    flags (two sequences were cut at the length limit)."""
    from areal_tpu_torch.api.data_api import SequenceSample

    n_prompts, group = sizes["n_prompts"], sizes["group"]
    ids, pms, group_lens = [], [], []
    for _ in range(n_prompts):
        prompt = rng.integers(0, vocab, size=_draw(rng, sizes["prompt"]))
        lens = []
        for _ in range(group):
            resp = rng.integers(0, vocab, size=_draw(rng, sizes["response"]))
            ids.append(np.concatenate([prompt, resp]))
            pms.append(np.concatenate([np.ones(len(prompt), np.int64),
                                       np.zeros(len(resp), np.int64)]))
            lens.append(len(prompt) + len(resp))
        group_lens.append(lens)
    n_seqs = n_prompts * group
    no_eos = np.zeros(n_seqs, np.float32)
    no_eos[[1, n_seqs - 2]] = 1.0
    per_seq = [[1] * group for _ in range(n_prompts)]
    return SequenceSample(
        ids=[f"prompt{i}" for i in range(n_prompts)],
        keys={"packed_input_ids", "prompt_mask", "seq_no_eos_mask", "rewards"},
        data={"packed_input_ids": np.concatenate(ids), "prompt_mask": np.concatenate(pms),
              "seq_no_eos_mask": no_eos,
              "rewards": np.tile([5.0, -5.0], n_seqs // 2 + 1)[:n_seqs].astype(np.float32)},
        seqlens={"packed_input_ids": group_lens, "prompt_mask": group_lens,
                 "seq_no_eos_mask": per_seq, "rewards": per_seq},
        metadata={"version_start": [0] * n_prompts, "version_end": [0] * n_prompts},
    )


def sft_sample(rng, n_seqs, sizes, vocab):
    from areal_tpu_torch.api.data_api import SequenceSample

    plens = [_draw(rng, sizes["prompt"]) for _ in range(n_seqs)]
    rlens = [_draw(rng, sizes["response"]) for _ in range(n_seqs)]
    lens = [p + r for p, r in zip(plens, rlens)]
    pm = np.concatenate([np.arange(n) < p for n, p in zip(lens, plens)]).astype(np.int64)
    return SequenceSample.from_default(
        ids=[f"sft{i}" for i in range(n_seqs)], seqlens=lens,
        data={"packed_input_ids": rng.integers(0, vocab, size=sum(lens)), "prompt_mask": pm})


def grad_phase(torch, rng, dev, cfg, seed):
    """Gradients of the SFT loss at full width and 2 layers: the kernel
    path (flash forward and backward kernels) against the plain attention,
    both on `dev`, leaf by leaf."""
    import dataclasses

    from areal_tpu_torch import kernels
    from areal_tpu_torch.engine.optimizer import tree_leaves
    from areal_tpu_torch.engine.torch_engine import TorchTrainEngine
    from areal_tpu_torch.interfaces.sft import sft_loss_weight, sft_row_loss
    from areal_tpu_torch.models import transformer
    from areal_tpu_torch.ops.attention import reference_packed_attention

    cfg2 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32")
    params = transformer.init_params(cfg2, seed=seed, device=dev)
    engine = TorchTrainEngine(cfg2, params, remat="full", row_len_multiple=1024,
                              max_row_len=1024, device=dev)
    sample = sft_sample(rng, 6, dict(prompt=(16, 128), response=(64, 512)), cfg2.vocab_size)
    _, rows_np = engine._build_rows(sample)
    rows = engine._device_rows(rows_np)
    denom = sft_loss_weight(sample)
    leaves = tree_leaves(engine.params)

    def loss_and_grads():
        loss, _ = sft_row_loss(engine._model_out(rows, "logprobs", "full"), rows)
        grads = torch.autograd.grad(loss / denom, leaves)
        return loss.item() / denom, grads

    kernels.reset_launches()
    loss_k, g_k = loss_and_grads()
    counts = dict(kernels.launches)
    # The plain path: the model's attention entry swapped for the plain
    # version for this one call.
    kernel_entry = transformer.packed_attention
    transformer.packed_attention = reference_packed_attention
    try:
        loss_p, g_p = loss_and_grads()
    finally:
        transformer.packed_attention = kernel_entry
    sync(torch, dev)
    worst = {}
    for name, a, b in zip(leaf_paths(engine.params), g_k, g_p):
        top = b.float().abs().max().item()
        worst[name] = (a.float() - b.float()).abs().max().item() / max(top, 1e-30)
        if not torch.isfinite(a).all() or worst[name] > LEAF_TOL:
            raise AssertionError(f"grad: leaf {name} differs by {worst[name]:.3e} of its "
                                 f"largest reference value (tol {LEAF_TOL})")
    if abs(loss_k - loss_p) > 1e-2 * abs(loss_p):
        raise AssertionError(f"grad: loss {loss_k} through the kernels, {loss_p} plain")
    if dev.type == "cuda":
        for k in ("flash_attn_fwd_bf16", "flash_attn_bwd_dq_bf16", "flash_attn_bwd_dkv_bf16"):
            if counts[k] <= 0:
                raise AssertionError(f"grad: kernel {k} was not launched")
    name, val = max(worst.items(), key=lambda kv: kv[1])
    log(f"  rows {tuple(rows['input_ids'].shape)}, {int(denom)} loss tokens: loss "
        f"{loss_k:.5f} (kernels) vs {loss_p:.5f} (plain); {len(worst)} leaves, worst "
        f"{name} at {val:.3e} of max|ref| (tol {LEAF_TOL}); launches {counts}")
    return dict(loss_kernels=loss_k, loss_plain=loss_p, worst_leaf=name, worst_rel=val,
                per_leaf=worst, launches=counts)


def train_phase(torch, rng, dev, cfg, seed, sizes=TRAIN_SIZES):
    """PPO actor inference and train_step, then SFT steps, through the
    interfaces and a TorchTrainEngine with float32 params."""
    import dataclasses

    from areal_tpu_torch import kernels
    from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.api.model_api import Model, ModelName, make_interface
    from areal_tpu_torch.engine.optimizer import OptimizerConfig
    from areal_tpu_torch.engine.torch_engine import TorchTrainEngine
    from areal_tpu_torch.interfaces import ppo, sft  # noqa: F401  (register the interfaces)
    from areal_tpu_torch.models.transformer import count_params, init_params

    cfg = dataclasses.replace(cfg, param_dtype="float32")
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = TorchTrainEngine(
        cfg, init_params(cfg, seed=seed, device=dev),
        optimizer_config=OptimizerConfig(lr=5e-5, warmup_steps_proportion=0.0),
        total_train_steps=100, remat="full", row_len_multiple=sizes["row_len"],
        max_row_len=sizes["row_len"], device=dev)
    sync(torch, dev)
    log(f"  engine: {cfg.n_layers} layers, {count_params(engine.params) / 1e9:.3f} B params "
        f"({cfg.param_dtype} params and moments, {cfg.compute_dtype} compute, seeded "
        f"random) in {time.perf_counter() - t0:.1f} s")
    model = Model(name=ModelName("actor"), module=engine, tokenizer=None)
    actor = make_interface("ppo_actor", n_minibatches=sizes["n_minibatches"],
                           gae_lambda=0.95)
    mb_spec = MicroBatchSpec(max_tokens_per_mb=sizes["max_tokens_per_mb"])
    sample = rollout_sample(rng, sizes, cfg.vocab_size)
    n_tok = sample.total_seqlen()
    # Rows each minibatch packs into: the flash forward's cost follows the
    # rows (it skips no tile under the diagonal), the backward's the tiles
    # that each sequence covers.
    mb_rows = [engine._build_rows(mb)[0].n_rows for mb in
               sample.split(MicroBatchSpec(n_mbs=sizes["n_minibatches"]))[0]]
    probe = engine.params["layers"]["attn"]["wq"]
    before = probe.detach()[0, :8, :8].clone()

    kernels.reset_launches()
    t0 = time.perf_counter()
    behav = actor.inference(model, sample, mb_spec)
    sync(torch, dev)
    t_inf = time.perf_counter() - t0
    lp = behav.data["logprobs"]
    if not np.isfinite(lp).all() or lp.max() > 0:
        raise AssertionError("train: behaviour logprobs not finite or > 0")
    sl = [list(x) for x in sample.seqlens["packed_input_ids"]]
    noise = rng.standard_normal(lp.shape).astype(np.float32) * 0.01
    sample.update_(SequenceSample(
        ids=list(sample.ids), keys={"packed_logprobs", "ref_logprobs"},
        data={"packed_logprobs": lp, "ref_logprobs": lp + noise},
        seqlens={"packed_logprobs": sl, "ref_logprobs": sl}))

    per_minibatch = []
    inner = engine.train_batch

    def recording_train_batch(*args, **kwargs):
        per_minibatch.append(inner(*args, **kwargs))
        return per_minibatch[-1]

    engine.train_batch = recording_train_batch  # to read each minibatch's stats
    t0 = time.perf_counter()
    try:
        stats = actor.train_step(model, sample, mb_spec)
    finally:
        del engine.train_batch
    sync(torch, dev)
    t_ppo = time.perf_counter() - t0
    first = per_minibatch[0]
    log(f"  ppo: {n_tok} tokens in {len(sl) * sizes['group']} sequences; inference "
        f"{t_inf:.2f} s ({n_tok / t_inf:.0f} tok/s); train_step {t_ppo:.2f} s "
        f"({n_tok / t_ppo:.0f} tok/s), {len(per_minibatch)} minibatches of "
        f"{[int(s['ppo_actor/n_mbs']) for s in per_minibatch]} micro-batches and {mb_rows} "
        f"rows of {sizes['row_len']}; first minibatch "
        f"importance_weight {first['ppo_actor/importance_weight']:.6f} clip_ratio "
        f"{first['ppo_actor/clip_ratio']:.2e}; loss {stats['ppo_actor/loss']:.5f} grad_norm "
        f"{stats['ppo_actor/grad_norm']:.4f} adv_mean {stats['ppo_actor/adv_mean']:.4f}")
    bad = [k for k, v in stats.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"train: non-finite stats {bad}")
    if not all(s["ppo_actor/grad_norm"] > 0 for s in per_minibatch):
        raise AssertionError("train: a minibatch had grad norm 0")
    if (abs(first["ppo_actor/importance_weight"] - 1.0) > 1e-3
            or abs(first["ppo_actor/clip_ratio"]) > 1e-3):
        raise AssertionError("train: the first minibatch is not on-policy: importance weight "
                             f"{first['ppo_actor/importance_weight']}, clip ratio "
                             f"{first['ppo_actor/clip_ratio']}")
    if len(per_minibatch) != sizes["n_minibatches"] or model.version != 1 \
            or engine.optimizer.count != sizes["n_minibatches"]:
        raise AssertionError("train: expected one optimizer update per minibatch and "
                             "one version step")
    if torch.equal(before, probe.detach()[0, :8, :8]):
        raise AssertionError("train: parameters did not change")

    sft_itf = make_interface("sft")
    batch = sft_sample(rng, sizes["sft_seqs"], sizes, cfg.vocab_size)
    sft_tok = batch.total_seqlen()
    sft_rows = engine._build_rows(batch)[0].n_rows
    sft_stats, sft_walls = [], []
    for _ in range(sizes["sft_steps"]):
        t0 = time.perf_counter()
        sft_stats.append(sft_itf.train_step(model, batch, mb_spec))
        sync(torch, dev)
        sft_walls.append(time.perf_counter() - t0)
    counts = dict(kernels.launches)
    losses = [s["sft/loss"] for s in sft_stats]
    log(f"  sft: {sizes['sft_steps']} steps on {sft_tok} tokens in {sft_rows} rows: loss "
        f"{losses}, grad_norm "
        f"{[round(s['sft/grad_norm'], 4) for s in sft_stats]}, step wall "
        f"{[round(w, 2) for w in sft_walls]} s ({sft_tok / min(sft_walls):.0f} tok/s best); "
        f"launches {counts}")
    if not all(math.isfinite(v) for s in sft_stats for v in s.values()):
        raise AssertionError("train: non-finite SFT stats")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: SFT loss did not fall: {losses}")
    if model.version != 1 + sizes["sft_steps"]:
        raise AssertionError("train: version did not advance with the SFT steps")
    if on_card:
        for k in ("flash_attn_fwd_bf16", "flash_attn_bwd_dq_bf16", "flash_attn_bwd_dkv_bf16",
                  "packed_gae_f32"):
            if counts[k] <= 0:
                raise AssertionError(f"train: kernel {k} was not launched")
    out = dict(
        tokens=n_tok, inference_s=t_inf, inference_tok_s=n_tok / t_inf,
        train_step_s=t_ppo, train_step_tok_s=n_tok / t_ppo, ppo_stats=stats,
        ppo_minibatches=per_minibatch, ppo_minibatch_rows=mb_rows, sft_tokens=sft_tok,
        sft_rows=sft_rows, sft_losses=losses,
        sft_step_s=sft_walls, sft_tok_s=sft_tok / min(sft_walls), launches=counts)
    if on_card:
        # Where the time goes: one more SFT train_batch under the profiler.
        def one_step():
            t0 = time.perf_counter()
            sft_itf.train_step(model, batch, mb_spec)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        prof = profile_window(torch, one_step)
        out["profile"] = {"sft_train_batch": prof}
        top = ", ".join(f"{k} {v:.1f} ms" for k, v in prof["device_ms_by_class"].items())
        log(f"  profile sft train_batch ({sft_tok} tokens): wall {prof['wall_ms']:.1f} ms, "
            f"device busy {prof['device_busy_ms']:.1f} ms (idle share "
            f"{prof['device_idle_share']:.3f}); {top}")
        for name, ms in prof["top_kernels"]:
            log(f"    {ms:8.1f} ms  {name}")
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"  peak device memory {out['peak_memory_gb']:.2f} GB")
    return out


# ----------------------------------------------------------------------
# Phase 9: the worker system
# ----------------------------------------------------------------------

WORKER_STEPS = 2
# The workers phase's depth, cut from the model's 28 layers to keep the
# default run near half its time limit.
WORKERS_LAYERS = 14
WORKERS_TIMEOUT_S = 600.0
# The realloc dump's update from init against an in-process replay's, per
# leaf: ||(dump - init) - (replay - init)|| / ||replay - init||. Readings
# on the H100 (PERF.md, PR 7 run W2): the dump 0 on every leaf (the same
# kernels on the same inputs), the params from before the last step (a
# stale dump) at least 0.44. The limit leaves room for a library call
# whose order of reduction differs between processes, and none for a
# stale or untrained dump.
WORKERS_UPDATE_RTOL = 0.01


def trajectories(rng, sizes, vocab, n_steps):
    """`n_steps` PPO batches as a rollout worker pushes them: one
    trajectory a prompt (its `group` answers), with rewards and no-EOS
    flags (rollout_sample's batch, split by prompt) and behaviour
    logprobs on the response positions near -log(vocab), what a model of
    random weights gives random tokens."""
    from areal_tpu_torch.api.data_api import SequenceSample

    out = []
    for step in range(n_steps):
        sample = rollout_sample(rng, sizes, vocab)
        lens = [l for sl in sample.seqlens["packed_input_ids"] for l in sl]
        pm = sample.data["prompt_mask"]
        lp = np.zeros(sum(lens), np.float32)
        off = 0
        for n in lens:
            plen = int(pm[off:off + n].sum())
            lp[off + plen - 1: off + n - 1] = (-math.log(vocab)
                                                + 0.01 * rng.standard_normal(n - plen))
            off += n
        sample.update_(SequenceSample(
            ids=list(sample.ids), keys={"packed_logprobs"}, data={"packed_logprobs": lp},
            seqlens={"packed_logprobs": [list(sl) for sl in sample.seqlens["packed_input_ids"]]}))
        for i, t in enumerate(sample.unpack()):
            t.ids = [f"s{step}-p{i}"]
            out.append(t)
    return out


def replay_update_errors(torch, dev, shard, mfc, batches, dumped, seed, worker_name):
    """Replay the model worker's train steps in this process (its
    factories, seed and batches) and hold the dump against the replay.
    Returns, per leaf, the dump's update error and that of the params from
    before the last step (what a dump taken before the step would hold),
    each ||(x - init) - (replay - init)|| / ||replay - init||, and the
    replay's seconds."""
    import areal_tpu_torch.engine.factories  # noqa: F401  (register the model and backends)
    from areal_tpu_torch.api.model_api import (FinetuneSpec, make_backend, make_interface,
                                               make_model)
    from areal_tpu_torch.base import seeding
    from areal_tpu_torch.interfaces import ppo  # noqa: F401  (register the interface)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v for k in sorted(tree) for k2, v in leaves(tree[k], f"{prefix}/{k}").items()}
        return {prefix: tree}

    t0 = time.perf_counter()
    seeding.set_random_seed(seed, worker_name)
    model = make_model(shard.model, name=shard.id.model_name, device=str(dev))
    model = make_backend(shard.backend).initialize(
        model, FinetuneSpec(train_batch_size=len(batches[0].ids)))
    actor = make_interface(shard.interface)
    # The HF weights are bf16, so their bf16 copy is the exact init.
    init = {k: v.detach().to(torch.bfloat16, copy=True)
            for k, v in leaves(model.module.get_params()).items()}
    for i, batch in enumerate(batches):
        if i == len(batches) - 1:
            before = {k: v.detach().clone() for k, v in leaves(model.module.get_params()).items()}
        actor.train_step(model, batch, mfc.mb_spec)
    after = {k: v.detach() for k, v in leaves(model.module.get_params()).items()}
    dumped = leaves(dumped)
    if sorted(dumped) != sorted(after):
        raise AssertionError(f"workers: dump leaves {sorted(dumped)} != {sorted(after)}")
    errs = {"dump": {}, "stale": {}}
    for k, a in after.items():
        a = a.double()
        step = a - init[k].double()
        norm = float(step.norm())
        moved = float((dumped[k].to(dev).double() - init[k].double()).norm())
        if norm == 0 or moved == 0:
            raise AssertionError(f"workers: {k} did not move from init (replay {norm}, "
                                 f"dump {moved})")
        errs["dump"][k] = float((dumped[k].to(dev).double() - a).norm()) / norm
        errs["stale"][k] = float((before[k].double() - a).norm()) / norm
    del model, init, before, after, a, step
    torch.cuda.empty_cache()
    return errs, time.perf_counter() - t0


def workers_phase(torch, rng, dev, cfg, seed, card, train_step_s=None, sizes=TRAIN_SIZES,
                  server_slots=4, greedy_lens=(300, 700, 1200, 2000), greedy_new=32):
    """The trainer half of the worker system through its entry point,
    LocalController(ExperimentConfig).run(): a spawned model worker hosts
    the PPO actor (loaded from an HF directory of seeded random bf16
    weights; float32 params and Adam moments, bf16 compute, remat full)
    and pulls the trajectories this process pushes as a rollout worker
    would; the inline master runs the actor_train MFC for WORKER_STEPS
    steps with the raw-dump weight hand-off after each. Then a
    GenerationServer in this process takes the last dump through
    /update_weights_from_disk and answers greedy requests over HTTP that
    must equal an engine's built from the dumped params. The dump's
    contents are held against a replay of the same steps in this process
    (replay_update_errors)."""
    import dataclasses
    import shutil
    import tempfile

    from areal_tpu_torch import kernels
    from areal_tpu_torch.api.config import (ModelAbstraction, ModelBackendAbstraction,
                                            ModelInterfaceAbstraction, ModelShardID)
    from areal_tpu_torch.api.data_api import (MicroBatchSpec, SequenceSample,
                                              sample_from_json, sample_to_json)
    from areal_tpu_torch.api.dfg import MFCDef, ModelInterfaceType, ParamReallocHook
    from areal_tpu_torch.api.model_api import ModelName
    from areal_tpu_torch.api.system_api import (
        ExperimentConfig, ExperimentSaveEvalControl, GenerationServerConfig,
        MasterWorkerConfig, ModelShardSpec, ModelWorkerConfig)
    from areal_tpu_torch.base import name_resolve, names
    from areal_tpu_torch.engine.serving import GenRequest, ServingEngine
    from areal_tpu_torch.models.hf import save_hf_model
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system.controller import LocalController
    from areal_tpu_torch.system.generation_server import GenerationServer
    from areal_tpu_torch.system.push_pull_stream import NameResolvingZmqPusher
    from areal_tpu_torch.system.weight_transfer import load_raw_params

    tmp = tempfile.mkdtemp(prefix="chip_smoke_workers_")
    # The experiment is named by the temp directory: no other run's
    # records or dumps share its keys.
    exp, trial = os.path.basename(tmp), "workers"
    nr_cfg = {"backend": "nfs", "record_root": os.path.join(tmp, "name_resolve")}
    name_resolve.reconfigure(**nr_cfg)
    fileroot = os.path.join(tmp, "fileroot")
    stats = dict(card=card)
    server = run = None
    try:
        t0 = time.perf_counter()
        hf_dir = os.path.join(tmp, "hf")
        params = init_params(cfg, seed=seed, device=dev, dtype=torch.bfloat16)
        sync(torch, dev)
        stats["init_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        save_hf_model(hf_dir, cfg, params, "qwen2")
        # An HF directory carries its tokenizer, which the model factory
        # loads (its own generator: the phase's batches stay the same).
        tiny_tokenizer(np.random.default_rng([seed, 6]), hf_dir, 64)
        del params
        torch.cuda.empty_cache()
        stats["hf_save_s"] = time.perf_counter() - t0
        log(f"  seeded random bf16 weights ({cfg.n_layers} layers) drawn in "
            f"{stats['init_s']:.1f} s, written as an HF directory in {stats['hf_save_s']:.1f} s")

        n_seqs = sizes["n_prompts"]
        actor = ModelName("actor", 0)
        train = MFCDef(
            name="actor_train", model_name=actor, interface_type=ModelInterfaceType.TRAIN_STEP,
            interface_impl=None, n_seqs=n_seqs,
            input_keys=("packed_input_ids", "prompt_mask", "packed_logprobs", "rewards",
                        "seq_no_eos_mask"),
            mb_spec=MicroBatchSpec(max_tokens_per_mb=sizes["max_tokens_per_mb"]),
            post_hooks=[ParamReallocHook(source=str(actor))])
        mw = ModelWorkerConfig(
            experiment_name=exp, trial_name=trial, worker_index=0,
            shards=[ModelShardSpec(
                id=ModelShardID(actor),
                model=ModelAbstraction("tpu_transformer", args=dict(model_path=hf_dir)),
                backend=ModelBackendAbstraction("jax_train", args=dict(
                    optimizer=dict(lr=5e-5, warmup_steps_proportion=0.0), remat=True,
                    row_len_multiple=sizes["row_len"], max_row_len=sizes["row_len"])),
                interface=ModelInterfaceAbstraction("ppo_actor", args=dict(
                    n_minibatches=sizes["n_minibatches"], gae_lambda=0.95)))],
            train_batch_size=n_seqs, stream_dataset=True, seed=seed, device=str(dev))
        master = MasterWorkerConfig(
            experiment_name=exp, trial_name=trial,
            exp_ctrl=ExperimentSaveEvalControl(benchmark_steps=WORKER_STEPS), rpcs=[train],
            model_topos={str(actor): [mw.worker_name]}, data_hosts=[mw.worker_name],
            n_model_workers=1, train_batch_size=n_seqs)
        ctl = LocalController(
            ExperimentConfig(experiment_name=exp, trial_name=trial, master=master,
                             model_workers=[mw]),
            name_resolve_cfg=nr_cfg, worker_env={"AREAL_FILEROOT": fileroot})
        trajs = trajectories(rng, sizes, cfg.vocab_size, WORKER_STEPS)
        wire = [sample_to_json(t) for t in trajs]
        n_tok = [sum(t.total_seqlen() for t in trajs[i * n_seqs:(i + 1) * n_seqs])
                 for i in range(WORKER_STEPS)]

        # This process plays the rollout worker: push every trajectory,
        # then wait for the trainer's acks (its WAL holds them).
        pushed = {}

        def rollout():
            try:
                pusher = NameResolvingZmqPusher(exp, trial, pusher_index=0, n_pushers=1,
                                                n_pullers=1, ack=True)
                try:
                    for i, w in enumerate(wire):
                        pusher.push(w, seq=f"0/{i}")
                    deadline = time.monotonic() + WORKERS_TIMEOUT_S
                    while pusher.unacked() and time.monotonic() < deadline:
                        pusher.drain_acks()
                        time.sleep(0.05)
                    pushed["unacked"] = pusher.unacked()
                finally:
                    pusher.close()
            except Exception as e:  # reported after the run
                pushed["error"] = repr(e)

        feeder = threading.Thread(target=rollout, daemon=True)
        feeder.start()
        t0 = time.perf_counter()
        result = ctl.run(timeout=WORKERS_TIMEOUT_S)
        stats["run_s"] = time.perf_counter() - t0
        feeder.join(timeout=60)
        if pushed.get("error") or pushed.get("unacked", 1):
            raise AssertionError(f"workers: the rollout side failed: {pushed}")
        summary = result["perf_summary"]
        steps = [s["actor_train"] for s in summary["mfc_stats"]]
        if result["global_step"] != WORKER_STEPS or len(steps) != WORKER_STEPS:
            raise AssertionError(f"workers: {result['global_step']} steps, "
                                 f"{len(steps)} reported")
        bad = [k for s in steps for k, v in s.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"workers: non-finite MFC stats {bad}")
        counts = {k: int(sum(s[f"launches/{k}"] for s in steps)) for k in kernels.launches}
        on_card = dev.type == "cuda"
        for k in ("flash_attn_fwd_bf16", "flash_attn_bwd_dq_bf16", "flash_attn_bwd_dkv_bf16",
                  "packed_gae_f32"):
            if on_card and counts[k] <= 0:
                raise AssertionError(f"workers: kernel {k} was not launched in the model worker")
        version = name_resolve.get(names.model_version(exp, trial, actor.role))
        if version != str(WORKER_STEPS):
            raise AssertionError(f"workers: published model version {version}")
        e2e = [h[0] for h in summary["history"]]
        stats.update(
            step_e2e_s=e2e, mfc_sec=[s["perf/sec"] for s in steps],
            mfc_elapsed_s=[s["perf/elapsed"] for s in steps],
            dump_s=[s["param_realloc/dump_s"] for s in steps], step_tokens=n_tok,
            peak_memory_gb=max(s["perf/mem_peak_bytes_in_use"] for s in steps) / 1e9,
            ppo_stats=steps, worker_launches=counts)
        log(f"  {WORKER_STEPS} actor_train steps through LocalController in "
            f"{stats['run_s']:.1f} s (worker start, HF load, steps, exit): tokens {n_tok}; "
            f"master step e2e {[round(x, 3) for x in e2e]} s, MFC perf/sec "
            f"{[round(x, 3) for x in stats['mfc_sec']]} s"
            f"{'' if train_step_s is None else f' (direct train_step {train_step_s:.2f} s)'}; "
            f"raw dump "
            f"{[round(x, 2) for x in stats['dump_s']]} s; worker peak device memory "
            f"{stats['peak_memory_gb']:.2f} GB; loss "
            f"{[round(s['ppo_actor/loss'], 5) for s in steps]}, importance_weight "
            f"{[round(s['ppo_actor/importance_weight'], 4) for s in steps]}; {card}")
        log(f"  launches in the model worker: {counts}")

        # The dump's contents: the same steps replayed here on the batches
        # the worker's data manager gathers (the wire's JSON, oldest first).
        dump_dir = os.path.join(fileroot, "param_realloc", exp, trial, actor.role)
        dumped, dump_version = load_raw_params(dump_dir)
        if dump_version != WORKER_STEPS:
            raise AssertionError(f"workers: the dump holds version {dump_version}")
        batches = [SequenceSample.gather([
            sample_from_json(json.loads(json.dumps(w))).select_keys(train.input_keys)
            for w in wire[i * n_seqs:(i + 1) * n_seqs]]) for i in range(WORKER_STEPS)]
        errs, stats["replay_s"] = replay_update_errors(
            torch, dev, mw.shards[0], train, batches, dumped, seed, mw.worker_name)
        stats["update_err"] = max(errs["dump"].values())
        stats["stale_update_err"] = min(errs["stale"].values())
        per_leaf = ", ".join(f"{k} {errs['dump'][k]:.2e} / {errs['stale'][k]:.2e}"
                             for k in errs["dump"])
        log(f"  replay in this process ({stats['replay_s']:.1f} s): the dump's update error "
            f"per leaf at most {stats['update_err']:.3e} (limit {WORKERS_UPDATE_RTOL}); the "
            f"params from before step {WORKER_STEPS} read at least "
            f"{stats['stale_update_err']:.3e} (per leaf, dump / before: {per_leaf})")
        if not stats["update_err"] <= WORKERS_UPDATE_RTOL < stats["stale_update_err"]:
            raise AssertionError(
                f"workers: the dump's update is off the replay's by {stats['update_err']:.3e} "
                f"(a stale dump reads {stats['stale_update_err']:.3e}; limit "
                f"{WORKERS_UPDATE_RTOL})")

        # The last dump into a GenerationServer over HTTP. The server runs
        # under a trial of its own: it leaves when its trial's status reads
        # COMPLETE, which the master wrote for the training trial.
        gcfg = GenerationServerConfig(
            experiment_name=exp, trial_name="serve", server_index=0,
            model=ModelAbstraction("tpu_transformer", args=dict(config=dataclasses.asdict(cfg))),
            max_concurrent_requests=server_slots, max_seq_len=4096, kv_page_size=128,
            decode_block_steps=16, prefill_chunk=1024, seed=seed, device=str(dev))
        server = GenerationServer()
        server.configure(gcfg, experiment_name=exp, trial_name=gcfg.trial_name,
                         worker_name=gcfg.worker_name)
        run = threading.Thread(target=server.run, daemon=True)
        run.start()
        url = server.address
        reqs = [GenRequest(qid=f"greedy{i}", input_ids=rng.integers(0, cfg.vocab_size, n).tolist(),
                           max_new_tokens=greedy_new, greedy=True, stop_token_ids=(STOP_TOKEN,))
                for i, n in enumerate(greedy_lens)]
        kernels.reset_launches()
        status, _, upd = http_call(url, "/update_weights_from_disk", {
            "model_path": dump_dir, "allow_interrupt": True, "version": WORKER_STEPS})
        if status != 200 or not upd.get("success") or upd["source"] != "disk_raw":
            raise AssertionError(f"workers: weight update failed: {status} {upd}")
        over_http = {}
        for r in reqs:  # one at a time, as the engine below runs them
            status, _, reply = http_call(url, "/generate", generate_body(r))
            if status != 200 or reply["version_start"] != WORKER_STEPS:
                raise AssertionError(f"workers: /generate {r.qid}: {status} {reply}")
            over_http[r.qid] = reply["output_ids"]
        server_counts = dict(kernels.launches)
        _, _, m = http_call(url, "/metrics")
        for k in ("flash_attn_fwd_bf16", "paged_decode_bf16"):
            if on_card and server_counts[k] <= 0:
                raise AssertionError(f"workers: kernel {k} was not launched by the server")
        server.exit()
        run.join(timeout=120)
        server = None
        torch.cuda.empty_cache()

        engine = ServingEngine(
            cfg=cfg, params=cast_tree(dumped, torch.bfloat16), max_batch_size=server_slots,
            max_seq_len=4096, decode_block_steps=16, eos_token_id=None, page_size=128,
            prefill_chunk=1024, device=dev)
        del dumped
        engine.start()
        try:
            direct = {}
            for r in reqs:
                res, _ = run_requests(engine, [GenRequest(
                    qid=r.qid, input_ids=r.input_ids, max_new_tokens=r.max_new_tokens,
                    greedy=True, stop_token_ids=r.stop_token_ids)])
                direct[r.qid] = res[r.qid].output_ids
        finally:
            engine.stop()
        if over_http != direct:
            raise AssertionError("workers: greedy tokens over HTTP differ from the engine's "
                                 "on the dumped params")
        stats.update(
            load_s=upd["load_s"], last_weight_stage_s=float(m["areal:last_weight_stage_s"]),
            last_weight_swap_s=float(m["areal:last_weight_swap_s"]),
            server_launches=server_counts,
            launches={k: counts[k] + server_counts[k] for k in counts})
        log(f"  server took the step-{WORKER_STEPS} dump: load_s {upd['load_s']:.3f}, "
            f"last_weight_stage_s {stats['last_weight_stage_s']}, last_weight_swap_s "
            f"{stats['last_weight_swap_s']}; {len(reqs)} greedy requests over HTTP equal the "
            f"engine's on the dumped params ({sum(map(len, direct.values()))} tokens); "
            f"launches through the server {server_counts}; {card}")
        return stats
    finally:
        if server is not None:
            server.exit()
            run.join(timeout=120)
        shutil.rmtree(tmp, ignore_errors=True)


# The async_ppo phase at real size; a rehearsal on the CPU passes smaller
# ones. The reference's override keys, as a user would pass them.
ASYNC_SIZES = dict(n_prompts=64, prompt=(256, 1024), train_batch_size=8, group=4,
                   max_new_tokens=256, offpolicy=1, steps=2, slots=16, max_seq_len=4096,
                   row_len=4096, max_tokens_per_mb=16384, n_minibatches=4, words=400)
ASYNC_TIMEOUT_S = 900.0


def tiny_tokenizer(rng, save_dir, n_words):
    """A WordPiece tokenizer trained on a seeded corpus of `n_words`
    distinct words and the digits (the shape of tests.fixtures'
    train_tiny_tokenizer), saved as an HF tokenizer in `save_dir`; each
    word is one token. Returns the words."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordPiece
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.trainers import WordPieceTrainer
    from transformers import PreTrainedTokenizerFast

    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = sorted({"".join(rng.choice(letters, int(rng.integers(3, 8))))
                    for _ in range(n_words)})
    corpus = [" ".join(words), " ".join(str(d) for d in range(100)), "the answer is boxed"]
    tok = Tokenizer(WordPiece(unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    tok.train_from_iterator(corpus, WordPieceTrainer(
        vocab_size=len(words) + 256, min_frequency=0, special_tokens=["[UNK]", "[EOS]"]))
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "tokenizer.json")
    tok.save(path)
    PreTrainedTokenizerFast(tokenizer_file=path, eos_token="[EOS]", pad_token="[EOS]",
                            unk_token="[UNK]").save_pretrained(save_dir)
    return words


def math_prompt_rows(rng, n, lo_hi, words):
    """`n` math prompts of lo..hi tokens under the tiny tokenizer (one
    token a word), each asking for a sum with its numeric answer."""
    rows = []
    for i in range(n):
        a, b = (int(x) for x in rng.integers(1, 50, 2))
        ask = f"what is {a} plus {b}"
        n_fill = max(0, _draw(rng, lo_hi) - len(ask.split()))
        rows.append(dict(query_id=f"q{i}", task="math",
                         prompt=" ".join(rng.choice(words, n_fill)) + " " + ask,
                         solutions=[f"\\boxed{{{a + b}}}"]))
    return rows


def read_trace(trace_dir):
    """Every span record of the run's trace shards, by worker label."""
    out = {}
    for name in sorted(os.listdir(trace_dir)):
        worker = None
        with open(os.path.join(trace_dir, name)) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("kind") == "header":
                    worker = rec["worker"]
                elif rec.get("kind") == "span":
                    out.setdefault(worker, []).append(rec)
    return out


def async_ppo_phase(torch, rng, dev, cfg, seed, card, sizes=ASYNC_SIZES):
    """The async RL loop through the port's entry point,
    areal_tpu_torch.training.main_async_ppo.main(argv), with the
    reference's override keys: a GenerationServer, the gserver manager,
    a rollout worker running the math agent and env, and a model worker
    training the actor (loaded with the server from an HF directory of
    seeded random weights and the tiny tokenizer) on the pushed
    trajectories, handing each step's weights back through the manager's
    fanout. Tracing is on: the spans give the staleness of every trained
    sample, the fanouts and the refused allocations; the server's exit
    record gives its kernel launches and peak memory."""
    import shutil
    import tempfile
    from collections import Counter

    from areal_tpu_torch.base import tracing
    from areal_tpu_torch.models.hf import save_hf_model
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system.generation_server import exit_record_path
    from areal_tpu_torch.training import main_async_ppo

    tmp = tempfile.mkdtemp(prefix="chip_smoke_async_")
    exp, trial = os.path.basename(tmp), "async"
    trace_dir = os.path.join(tmp, "trace")
    fileroot = os.path.join(tmp, "fileroot")
    env = {"AREAL_RL_TRACE": "1", "AREAL_RL_TRACE_DIR": trace_dir, "AREAL_FILEROOT": fileroot}
    saved_env = {k: os.environ.get(k) for k in env}
    stats = dict(card=card)
    try:
        t0 = time.perf_counter()
        hf_dir = os.path.join(tmp, "hf")
        words = tiny_tokenizer(rng, hf_dir, sizes["words"])
        params = init_params(cfg, seed=seed, device=dev, dtype=torch.bfloat16)
        save_hf_model(hf_dir, cfg, params, "qwen2")
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            # What this process still holds from earlier phases: part of
            # its peak below.
            stats["launcher_held_gb"] = torch.cuda.memory_allocated(dev) / 1e9
        data = os.path.join(tmp, "math.jsonl")
        rows = math_prompt_rows(rng, sizes["n_prompts"], sizes["prompt"], words)
        with open(data, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
        stats["setup_s"] = time.perf_counter() - t0
        argv = [
            f"experiment_name={exp}", f"trial_name={trial}", f"seed={seed}",
            f"name_resolve_root={os.path.join(tmp, 'name_resolve')}",
            f"actor.path={hf_dir}", f"tokenizer_path={hf_dir}",
            f"dataset.path={data}", f"dataset.max_length={sizes['prompt'][1]}",
            f"train_batch_size={sizes['train_batch_size']}", f"group_size={sizes['group']}",
            f"ppo.gconfig.max_new_tokens={sizes['max_new_tokens']}",
            f"ppo.max_head_offpolicyness={sizes['offpolicy']}",
            f"ppo.ppo_n_minibatches={sizes['n_minibatches']}",
            f"exp_ctrl.benchmark_steps={sizes['steps']}",
            "actor.optimizer.lr=5e-5", "actor.optimizer.warmup_steps_proportion=0.0",
            f"actor.row_len_multiple={sizes['row_len']}", f"actor.max_row_len={sizes['row_len']}",
            f"mb_spec_max_tokens={sizes['max_tokens_per_mb']}",
            "n_generation_servers=1", "n_rollout_workers=1",
            f"gen_max_concurrent_requests={sizes['slots']}",
            f"gen_max_seq_len={sizes['max_seq_len']}", "gen_kv_page_size=128",
            f"gen_prefill_chunk={sizes['prompt'][1]}", f"device={dev.type}",
        ]
        log(f"  main_async_ppo {' '.join(argv)}")
        os.environ.update(env)
        tracing._ENABLED = None  # re-read AREAL_RL_TRACE: the master runs here
        t0 = time.perf_counter()
        result = main_async_ppo.main(argv, worker_env=env, timeout=ASYNC_TIMEOUT_S)
        stats["run_s"] = time.perf_counter() - t0
        tracing.flush()
        summary = result["perf_summary"]
        steps = [s["actor_train"] for s in summary["mfc_stats"]]
        if result["global_step"] != sizes["steps"] or len(steps) != sizes["steps"]:
            raise AssertionError(f"async_ppo: {result['global_step']} steps, "
                                 f"{len(steps)} reported")
        bad = [k for s in steps for k, v in s.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"async_ppo: non-finite MFC stats {bad}")
        spans = read_trace(trace_dir)

        # The fanout landed each version on the server.
        landed = sorted(int(r["attrs"]["version"]) for r in spans.get("gserver_manager", [])
                        if r["name"] == "manager.weight_update"
                        and r["attrs"].get("n_success", 0) >= 1)
        served = sorted(int(r["attrs"]["version"]) for r in spans.get("generation_server/0", [])
                        if r["name"] == "server.weight_update" and "source" in r["attrs"])
        want = list(range(1, sizes["steps"] + 1))
        if landed != want or served != want:
            raise AssertionError(f"async_ppo: fanout landed versions {landed}, the server "
                                 f"loaded {served}, want {want}")
        sync_s = [(r["end_ns"] - r["start_ns"]) / 1e9 for r in spans["gserver_manager"]
                  if r["name"] == "manager.weight_update"]

        # Every trained sample within the staleness bound.
        waits = {r["attrs"]["sample_id"]: r["attrs"] for r in spans.get("master", [])
                 if r["name"] == "buffer.wait" and r["attrs"].get("rpc") == "actor_train"}
        n_want = sizes["steps"] * sizes["train_batch_size"]
        if len(waits) != n_want:
            raise AssertionError(f"async_ppo: {len(waits)} trained samples traced, "
                                 f"want {n_want}")
        lag = Counter(a["train_step"] - a["version_start"] for a in waits.values())
        if max(lag) > sizes["offpolicy"] or min(a["version_start"] for a in waits.values()) < 0:
            raise AssertionError(f"async_ppo: staleness {dict(lag)} past "
                                 f"max_head_offpolicyness={sizes['offpolicy']}")
        staled = sum(1 for r in spans.get("gserver_manager", [])
                     if r["name"] == "manager.allocate" and r["attrs"].get("reason") == "staled")

        # Launches: the server's from its exit record, the trainer's from
        # the MFC replies.
        with open(exit_record_path(exp, trial, "generation_server/0")) as f:
            srv = json.load(f)
        worker_counts = {k: int(sum(s.get(f"launches/{k}", 0) for s in steps))
                         for k in srv["launches"]}
        if dev.type == "cuda":
            for k in ("flash_attn_fwd_bf16", "paged_decode_bf16"):
                if srv["launches"][k] <= 0:
                    raise AssertionError(f"async_ppo: kernel {k} was not launched by the server")
            for k in ("flash_attn_fwd_bf16", "flash_attn_bwd_dq_bf16", "flash_attn_bwd_dkv_bf16",
                      "packed_gae_f32"):
                if worker_counts[k] <= 0:
                    raise AssertionError(
                        f"async_ppo: kernel {k} was not launched in the model worker")
        if srv["version"] != sizes["steps"]:
            raise AssertionError(f"async_ppo: the server ended at version {srv['version']}")
        gen_tokens = srv["metrics"]["total_generated"]
        stats.update(
            global_step=result["global_step"], server_final_version=srv["version"],
            step_e2e_s=[h[0] for h in summary["history"]],
            mfc_sec=[s["perf/sec"] for s in steps],
            dump_s=[s["param_realloc/dump_s"] for s in steps],
            output_tokens=gen_tokens, output_tok_per_s=gen_tokens / stats["run_s"],
            last_weight_sync_s=sync_s, server_stage_s=srv["metrics"]["last_weight_stage_s"],
            server_swap_s=srv["metrics"]["last_weight_swap_s"], staled_allocations=staled,
            staleness_hist={int(k): v for k, v in sorted(lag.items())},
            importance_weight_step1=steps[0]["ppo_actor/importance_weight"],
            peak_memory_gb={
                "model_worker": max(s["perf/mem_peak_bytes_in_use"] for s in steps) / 1e9,
                "generation_server": srv["peak_memory_bytes"] / 1e9,
                "launcher": (torch.cuda.max_memory_allocated(dev) / 1e9
                             if dev.type == "cuda" else 0.0)},
            server_launches=srv["launches"], worker_launches=worker_counts,
            launches={k: worker_counts[k] + srv["launches"][k] for k in worker_counts})
        log(f"  {stats['global_step']} async PPO steps in {stats['run_s']:.1f} s (worker start, "
            f"HF loads, rollouts, steps, exit); master step e2e "
            f"{[round(x, 3) for x in stats['step_e2e_s']]} s, MFC perf/sec "
            f"{[round(x, 3) for x in stats['mfc_sec']]} s, raw dump "
            f"{[round(x, 2) for x in stats['dump_s']]} s; {card}")
        log(f"  rollout output {gen_tokens:.0f} tokens, {stats['output_tok_per_s']:.1f} tokens/s "
            f"over the run; manager fanouts (last_weight_sync_s) "
            f"{[round(x, 3) for x in sync_s]} s, server stage {stats['server_stage_s']:.3f} s, "
            f"swap {stats['server_swap_s']:.3f} s; allocations refused as staled {staled}; "
            f"staleness (train step - version_start: samples) {stats['staleness_hist']}; "
            f"importance_weight of step 1 {stats['importance_weight_step1']:.6f}")
        log(f"  peak device memory (GB) {stats['peak_memory_gb']} (the launcher held "
            f"{stats.get('launcher_held_gb', 0.0):.2f} GB from earlier phases at the start); "
            f"launches in the model worker "
            f"{worker_counts}, in the server {srv['launches']}")
        return stats
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tracing._ENABLED = None
        shutil.rmtree(tmp, ignore_errors=True)


def cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def kernel_entry_name(mangled: str) -> str:
    """A kernel's name and template arguments (integers, bools, bf16 and
    int8 types) read off its mangled name (paged_split_kernel<bf16, 128,
    8>), else the mangled name."""
    m = re.search(r"\d([A-Za-z][A-Za-z_]*_kernel)I((?:13__nv_bfloat16|a|L[ib]\d+E)+)E",
                  mangled)
    if not m:
        return mangled
    args = []
    for tok, kind, val in re.findall(r"(13__nv_bfloat16|a|L([ib])(\d+)E)", m.group(2)):
        if kind:
            args.append(("false", "true")[int(val)] if kind == "b" else val)
        else:
            args.append("bf16" if tok.startswith("13") else "int8")
    return f"{m.group(1)}<{', '.join(args)}>"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--out", default=None, help="also write the full report here (JSON)")
    ap.add_argument("--profile-serving", action="store_true",
                    help="also run the serving phases' profiled windows")
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
    from areal_tpu_torch.models.hf.qwen2 import r1_distill_qwen_1_5b_config

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

    def phase_done(name, t0):
        report["phases"].setdefault(name, {})["phase_seconds"] = time.perf_counter() - t0
        log(f"  phase {name} took {time.perf_counter() - t0:.1f} s")

    log("phase build")
    secs = kernels.build_all()
    for name, text in kernels.build_logs.items():
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                log(f"  [{name}] entry {kernel_entry_name(entry.group(1))}")
            elif "registers" in line or "spill" in line or "error" in line:
                log(f"  [{name}] {line.strip()}")
    log(f"  built {len(kernels.SOURCES)} kernel libraries in {secs:.1f} s")
    report["phases"]["build"] = {"seconds": secs}

    if "parity" in phases:
        log("phase parity")
        t0 = time.perf_counter()
        # The training-shape forward case and the timed chunk cases draw
        # from their own generator, so the draws of `rng`, and the later
        # phases' batches, stay those of a run without them.
        case_rng = np.random.default_rng([args.seed, 2])
        parity_flash(torch, rng, dev, kernel_rows, case_rng)
        parity_paged(torch, rng, dev, kernel_rows, int8=False, case_rng=case_rng)
        parity_paged(torch, rng, dev, kernel_rows, int8=True, case_rng=case_rng)
        parity_flash_bwd(torch, rng, dev, kernel_rows,
                         np.random.default_rng([args.seed, 1]))
        parity_gae(torch, rng, dev, kernel_rows, np.random.default_rng([args.seed, 3]))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        phase_done("parity", t0)

    cfg = r1_distill_qwen_1_5b_config()
    serving = [p for p in phases if p in ("serve_bf16", "serve_int8", "interrupt")]
    main_counts = {}
    if serving:
        from areal_tpu_torch.models.transformer import count_params, init_params

        t0 = time.perf_counter()
        params = init_params(cfg, seed=args.seed, device=dev, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        log(f"serving model: R1-Distill-Qwen-1.5B widths, {count_params(params) / 1e9:.3f} B "
            f"params (bf16, seeded random) in {time.perf_counter() - t0:.1f} s")
        for ph, kvd, need in (("serve_bf16", None, ("flash_attn_fwd_bf16", "paged_decode_bf16")),
                              ("serve_int8", "int8", ("flash_attn_fwd_bf16", "paged_decode_int8"))):
            if ph not in phases:
                continue
            log(f"phase {ph}")
            t0 = time.perf_counter()
            report["phases"][ph] = serve_phase(torch, rng, dev, cfg, params, kvd,
                                               profiled=args.profile_serving)
            counts = report["phases"][ph]["launches"]
            for k in need:
                if counts[k] <= 0:
                    raise AssertionError(f"{ph}: kernel {k} was not launched")
                main_counts.setdefault(k, counts[k])
            torch.cuda.empty_cache()
            phase_done(ph, t0)
        if "interrupt" in phases:
            log("phase interrupt")
            t0 = time.perf_counter()
            report["phases"]["interrupt"] = interrupt_phase(torch, rng, dev, cfg, params)
            phase_done("interrupt", t0)
        # The serving engines and pools are gone; free their weights too
        # before the server and the training phases.
        del params
        torch.cuda.empty_cache()

    if "http" in phases:
        log("phase http")
        t0 = time.perf_counter()
        # Its own generator: the later phases' batches stay those of a
        # run without it.
        report["phases"]["http"] = http_phase(torch, np.random.default_rng([args.seed, 4]),
                                              dev, cfg, args.seed, card)
        counts = report["phases"]["http"]["launches"]
        for k in ("flash_attn_fwd_bf16", "paged_decode_bf16"):
            main_counts.setdefault(k, counts[k])
        torch.cuda.empty_cache()
        phase_done("http", t0)

    if "grad" in phases:
        log("phase grad")
        t0 = time.perf_counter()
        report["phases"]["grad"] = grad_phase(torch, rng, dev, cfg, args.seed)
        torch.cuda.empty_cache()
        phase_done("grad", t0)

    if "train" in phases:
        log("phase train")
        t0 = time.perf_counter()
        report["phases"]["train"] = train_phase(torch, rng, dev, cfg, args.seed)
        counts = report["phases"]["train"]["launches"]
        for k in ("flash_attn_bwd_dq_bf16", "flash_attn_bwd_dkv_bf16", "gae_scan_f32",
                  "packed_gae_f32"):
            main_counts[k] = counts[k]
        main_counts.setdefault("flash_attn_fwd_bf16", counts["flash_attn_fwd_bf16"])
        torch.cuda.empty_cache()
        phase_done("train", t0)

    if "workers" in phases:
        log("phase workers")
        t0 = time.perf_counter()
        # Cut in depth: the async_ppo phase runs the same trainer, dump
        # and server load at all 28 layers.
        report["phases"]["workers"] = workers_phase(
            torch, np.random.default_rng([args.seed, 5]), dev,
            dataclasses.replace(cfg, n_layers=WORKERS_LAYERS), args.seed, card)
        # The worker system is a main path of its own: its launches add.
        for k, n in report["phases"]["workers"]["launches"].items():
            if n:
                main_counts[k] = main_counts.get(k, 0) + n
        torch.cuda.empty_cache()
        phase_done("workers", t0)

    if "async_ppo" in phases:
        log("phase async_ppo")
        t0 = time.perf_counter()
        report["phases"]["async_ppo"] = async_ppo_phase(
            torch, np.random.default_rng([args.seed, 7]), dev, cfg, args.seed, card)
        # The async loop is a main path of its own: its launches add.
        for k, n in report["phases"]["async_ppo"]["launches"].items():
            if n:
                main_counts[k] = main_counts.get(k, 0) + n
        torch.cuda.empty_cache()
        phase_done("async_ppo", t0)

    kernels_line = []
    for name, row in kernel_rows.items():
        row = dict(row)
        # null where no phase that runs this kernel on its main path ran
        row["launches"] = main_counts.get(name)
        if name == "gae_scan_f32":
            row["note"] = ("the scan entry (segment_scan_reverse); the PPO path runs the same "
                           "kernel body through packed_gae_f32, so its count there is 0")
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
