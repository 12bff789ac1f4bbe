"""Generalized Advantage Estimation over packed rows (counterpart of
``areal_tpu/ops/gae.py`` and ``areal_tpu/ops/pallas/gae_scan.py``).

Inputs are [R, T] row-packed (several sequences per row, segment ids,
0 = padding). Bootstrapping for truncated (no-EOS) sequences is expressed
by placing V(s_T) in ``bootstrap`` at each sequence's final token.

- ``gae_rows``: the serial oracle, a right-to-left loop over the time axis
  vectorised across rows.
- ``segment_scan_reverse``: x[t] = a[t] * x[t+1] + b[t] from the right per
  row. On a CUDA tensor it launches the hand-written kernel
  ``csrc/gae_scan.cu`` (entry ``gae_scan_f32``) or raises; on a CPU tensor
  it runs the plain version, ``reference_scan_reverse`` (a serial loop).
- ``packed_gae``: the GAE recursion as that scan over per-token affine
  elements (``_gae_affine_elems``), which is what the PPO interface calls.
  On a CUDA tensor it is one launch of the same kernel (entry
  ``packed_gae_f32``: the elements built in its prologue, the masking in
  its epilogue) or raises; on a CPU tensor the plain version,
  ``reference_packed_gae``. The reference's ``associative_scan`` variant
  and its ``impl`` choice are not ported: the kernel reads its inputs once
  and writes its outputs once, which is what that variant stood in for.
- ``gae_plan``: how a launch splits rows into tiles across CTAs.
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Tuple

import torch

from areal_tpu_torch import kernels
from areal_tpu_torch.ops.loss import shift_left


def gae_rows(
    rewards: torch.Tensor,  # [R, T] per-token rewards
    values: torch.Tensor,  # [R, T] V(s_t)
    segment_ids: torch.Tensor,  # [R, T]
    bootstrap: torch.Tensor,  # [R, T] V(s_{T+1}) at final tokens of truncated seqs, else 0
    gamma: float = 1.0,
    lam: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (advantages, returns), both [R, T] float32, zero outside
    segments.

    delta_t = r_t + gamma * V(s_{t+1}) - V(s_t), with V(s_{t+1}) = the next
    token's value within the same segment, the bootstrap value at segment
    ends, 0 otherwise. A_t = delta_t + gamma*lam*A_{t+1} (same segment).
    """
    R, T = rewards.shape
    rewards, values, bootstrap = rewards.float(), values.float(), bootstrap.float()
    adv_next = torch.zeros(R, dtype=torch.float32, device=rewards.device)
    v_next = torch.zeros_like(adv_next)
    seg_next = torch.zeros(R, dtype=segment_ids.dtype, device=rewards.device)
    advs = torch.zeros_like(rewards)
    for t in range(T - 1, -1, -1):
        seg_t = segment_ids[:, t]
        valid = seg_t > 0
        same = (seg_t == seg_next) & valid
        v_tp1 = torch.where(same, v_next, bootstrap[:, t])
        delta = rewards[:, t] + gamma * v_tp1 - values[:, t]
        adv = delta + gamma * lam * torch.where(same, adv_next, 0.0)
        adv = torch.where(valid, adv, 0.0)
        advs[:, t] = adv
        adv_next, v_next, seg_next = adv, values[:, t], seg_t
    valid = segment_ids > 0
    return (torch.where(valid, advs, 0.0),
            torch.where(valid, advs + values, 0.0))


def _gae_affine_elems(rewards, values, segment_ids, bootstrap, gamma, lam):
    """(a, b, valid, values32): the per-token affine scan elements.

    The GAE recursion is x_t = a_t * x_{t+1} + b_t with
    a_t = gamma*lam*[seg_t == seg_{t+1}, both valid] and b_t = delta_t.
    V(s_{t+1}) is the left-shifted values where the next token shares the
    segment, the bootstrap at segment ends: the serial loop's carry,
    including its t = T-1 edge (the shifted pad has segment id 0). Masking
    b makes invalid positions exact zeros; a is already 0 there, so they
    never leak into neighbours."""
    rewards, values, bootstrap = rewards.float(), values.float(), bootstrap.float()
    valid = segment_ids > 0
    same = (segment_ids == shift_left(segment_ids)) & valid
    v_tp1 = torch.where(same, shift_left(values), bootstrap)
    delta = rewards + gamma * v_tp1 - values
    a = torch.where(same, float(gamma * lam), 0.0).to(torch.float32)
    b = torch.where(valid, delta, 0.0)
    return a, b, valid, values


def _finish_gae(adv, values32, valid):
    adv = torch.where(valid, adv, 0.0)
    return adv, torch.where(valid, adv + values32, 0.0)


def reference_scan_reverse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of the scan kernel: a serial right-to-left loop."""
    x = torch.empty_like(b)
    carry = torch.zeros_like(b[:, 0])
    for t in range(b.shape[1] - 1, -1, -1):
        carry = a[:, t] * carry + b[:, t]
        x[:, t] = carry
    return x


def reference_packed_gae(rewards, values, segment_ids, bootstrap, gamma=1.0, lam=1.0):
    """The plain version of the fused kernel: the affine elements, the
    serial scan, the masking."""
    a, b, valid, values32 = _gae_affine_elems(
        rewards, values, segment_ids, bootstrap, gamma, lam)
    return _finish_gae(reference_scan_reverse(a, b), values32, valid)


# Elements a CTA scans at once: 256 threads x 4 (csrc/gae_scan.cu CHUNK).
CHUNK = 1024
# Rows of up to this many chunks stay whole: a CTA walks such a row faster
# than a split launch starts, publishes and waits (H100 timings in PERF.md).
WHOLE_ROW_CHUNKS = 4


class GaePlan(NamedTuple):
    tile: int  # elements a CTA owns, a multiple of CHUNK
    tiles: int  # tiles a row
    ctas: int  # R * tiles


def gae_plan(R: int, T: int, n_sm: int) -> GaePlan:
    """The tiles of a launch over [R, T], from the shapes and the SM count
    only (never the data). A CTA owns a whole row and walks it a chunk at
    a time when the row is short (at most WHOLE_ROW_CHUNKS chunks) or the
    rows alone give every SM a CTA; otherwise each row is split into tiles
    of one chunk across CTAs, which meet through their published
    aggregates. Tile k of a row is [k * tile, (k + 1) * tile) cut at T."""
    chunks = -(-T // CHUNK)
    if chunks <= WHOLE_ROW_CHUNKS or R >= n_sm:
        return GaePlan(chunks * CHUNK, 1, R)
    return GaePlan(CHUNK, chunks, R * chunks)


def ticket_tile(ticket: int, tiles: int) -> Tuple[int, int]:
    """(row, tile) of a CTA's ticket in a split launch, as the kernel maps
    it: row by row, within a row the rightmost tile first, so every tile a
    CTA waits on (those right of its own) went to an earlier ticket."""
    return ticket // tiles, tiles - 1 - ticket % tiles


class _Scratch:
    """A launch's tile aggregates, their flags and the ticket counter,
    kept per device and stream across launches: the flags are zeroed once
    and each launch stamps its own epoch, and the kernel hands the ticket
    counter back at 0, so no memset runs per launch. A launch captured in
    a CUDA graph would replay one epoch and could accept a flag left by
    its previous replay, so ``_plan_args`` refuses capture."""

    def __init__(self, n: int, device: torch.device, epoch: int):
        self.agg = torch.empty((n, 2), dtype=torch.float32, device=device)
        state = torch.zeros(n + 1, dtype=torch.int32, device=device)
        self.ticket, self.flags = state[:1], state[1:]
        self.epoch = epoch


_scratch: Dict[Tuple[int, int], _Scratch] = {}
_scratch_lock = threading.Lock()  # two launches never share an epoch


def _plan_args(device: torch.device, R: int, T: int, plan: GaePlan | None = None) -> tuple:
    """The C entries' trailing arguments: tile, tiles, aggregates, flags,
    ticket and the launch's epoch (never 0, the flags' initial value).
    ``plan`` replaces ``gae_plan``'s (the smoke times both modes at one
    shape). Raises while the stream is being captured into a CUDA graph."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the GAE kernels stamp a new epoch every launch and "
                           "cannot be captured in a CUDA graph")
    if plan is None:
        plan = gae_plan(R, T, torch.cuda.get_device_properties(device).multi_processor_count)
    n = R * plan.tiles if plan.tiles > 1 else 1
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    with _scratch_lock:
        s = _scratch.get(key)
        if s is None or s.agg.shape[0] < n:
            s = _scratch[key] = _Scratch(n, device, s.epoch if s is not None else 0)
        s.epoch = s.epoch % 0xFFFFFFFF + 1
        return plan.tile, plan.tiles, s.agg, s.flags, s.ticket, s.epoch


def _scan_kernel(a: torch.Tensor, b: torch.Tensor, plan: GaePlan | None = None) -> torch.Tensor:
    """Launch the CUDA scan kernel. Raises on anything it does not take."""
    kernels.check_cuda_tensor("a", a, torch.float32, 2)
    kernels.check_cuda_tensor("b", b, torch.float32, 2)
    if a.shape != b.shape:
        raise ValueError(f"scan shapes: a {tuple(a.shape)}, b {tuple(b.shape)}")
    R, T = a.shape
    x = torch.empty_like(b)
    kernels.launch("gae_scan_f32", a, b, x, R, T, *_plan_args(a.device, R, T, plan))
    return x


def _packed_gae_kernel(rewards, values, segment_ids, bootstrap, gamma, lam, plan=None):
    """Launch the fused GAE kernel: (advantages, returns). Float inputs are
    cast to float32 and made contiguous; segment ids must be int32.
    Raises on anything the kernel does not take."""
    rewards, values, bootstrap = (
        t.float().contiguous() for t in (rewards, values, bootstrap))
    for name, t in (("rewards", rewards), ("values", values), ("bootstrap", bootstrap)):
        kernels.check_cuda_tensor(name, t, torch.float32, 2)
    kernels.check_cuda_tensor("segment_ids", segment_ids, torch.int32, 2)
    shapes = {tuple(t.shape) for t in (rewards, values, segment_ids, bootstrap)}
    if len(shapes) != 1 or len({t.device for t in (rewards, values, segment_ids,
                                                   bootstrap)}) != 1:
        raise ValueError(f"GAE inputs differ in shape or device: {sorted(shapes)}")
    R, T = rewards.shape
    adv, ret = torch.empty_like(rewards), torch.empty_like(rewards)
    kernels.launch("packed_gae_f32", rewards, values, segment_ids, bootstrap, adv, ret,
                   float(gamma), float(gamma * lam), R, T,
                   *_plan_args(rewards.device, R, T, plan))
    return adv, ret


def segment_scan_reverse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x[t] = a[t] * x[t+1] + b[t], scanned right to left per row, with
    x[T] = 0. a, b and the result are [R, T] float32, any R and T. A CUDA
    tensor goes through the kernel; a CPU tensor through the plain loop."""
    if a.device.type == "cpu":
        return reference_scan_reverse(a.float(), b.float())
    return _scan_kernel(a, b)


def packed_gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    bootstrap: torch.Tensor,
    gamma: float = 1.0,
    lam: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``gae_rows`` semantics: one launch of the fused kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if rewards.device.type == "cpu":
        return reference_packed_gae(rewards, values, segment_ids, bootstrap, gamma, lam)
    return _packed_gae_kernel(rewards, values, segment_ids, bootstrap, gamma, lam)
