"""Generalized Advantage Estimation over packed rows (counterpart of
``areal_tpu/ops/gae.py`` and ``areal_tpu/ops/pallas/gae_scan.py``).

Inputs are [R, T] row-packed (several sequences per row, segment ids,
0 = padding). Bootstrapping for truncated (no-EOS) sequences is expressed
by placing V(s_T) in ``bootstrap`` at each sequence's final token.

- ``gae_rows``: the serial oracle, a right-to-left loop over the time axis
  vectorised across rows.
- ``segment_scan_reverse``: x[t] = a[t] * x[t+1] + b[t] from the right per
  row. On a CUDA tensor it launches the hand-written kernel
  ``csrc/gae_scan.cu`` or raises; on a CPU tensor it runs the plain
  version, ``reference_scan_reverse`` (a serial loop).
- ``packed_gae``: the GAE recursion as that scan over per-token affine
  elements (``_gae_affine_elems``), which is what the PPO interface calls.
  The reference's ``associative_scan`` variant and its ``impl`` choice are
  not ported: the kernel reads (a, b) once and writes x once, which is
  what that variant stood in for.
"""

from __future__ import annotations

from typing import Tuple

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


def _scan_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA scan kernel. Raises on anything it does not take."""
    kernels.check_cuda_tensor("a", a, torch.float32, 2)
    kernels.check_cuda_tensor("b", b, torch.float32, 2)
    if a.shape != b.shape:
        raise ValueError(f"scan shapes: a {tuple(a.shape)}, b {tuple(b.shape)}")
    R, T = a.shape
    x = torch.empty_like(b)
    kernels.launch("gae_scan_f32", a, b, x, R, T)
    return x


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
    """``gae_rows`` semantics through ``segment_scan_reverse``."""
    a, b, valid, values32 = _gae_affine_elems(
        rewards, values, segment_ids, bootstrap, gamma, lam)
    adv = segment_scan_reverse(a.contiguous(), b.contiguous())
    return _finish_gae(adv, values32, valid)
