"""Analytic FLOPs of a model function call and device-memory telemetry
(the port's copy of ``transformer_forward_flops``, ``mfc_flops``,
``device_memory_stats`` and ``check_memory_kill_threshold`` from
``areal_tpu/base/monitor.py``). Memory is read from
``torch.cuda.memory_stats`` of the CUDA devices this process uses; the
CPU reports none, so the stats are zeros there."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from areal_tpu_torch.base import env_registry

# Fraction of device memory beyond which the worker raises so the
# relaunch loop can recover it (the reference's knob name).
MEMORY_KILL_THRESHOLD_ENV = "AREAL_TPU_MEMORY_KILL_THRESHOLD"


def transformer_forward_flops(cfg, seqlens: Sequence[int]) -> int:
    """Forward FLOPs from a TransformerConfig over packed sequences
    (matmul-only: 2 m n k a matmul, the attention term per sequence)."""
    total_tokens = int(sum(seqlens))
    D = cfg.hidden_dim
    q_dim = cfg.n_q_heads * cfg.head_dim
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    attn_proj = 2 * total_tokens * D * (2 * q_dim + 2 * kv_dim)
    attn_quad = 4 * sum(int(l) ** 2 for l in seqlens) * q_dim
    # Dense MLP only: the port's engines refuse MoE configs.
    n_in = 2 if cfg.mlp_type == "gated" else 1
    mlp = 2 * total_tokens * D * cfg.intermediate_dim * (n_in + 1)
    head = 2 * total_tokens * D * cfg.vocab_size
    return cfg.n_layers * (attn_proj + attn_quad + mlp) + head


def mfc_flops(cfg, interface_type: str, input_seqlens: Sequence[int]) -> int:
    """Analytic FLOPs of one model function call: train_step 3x forward,
    inference 1x (the port's model worker runs no generate MFC yet)."""
    if interface_type == "train_step":
        return 3 * transformer_forward_flops(cfg, input_seqlens)
    if interface_type == "inference":
        return transformer_forward_flops(cfg, input_seqlens)
    return 0


class DeviceOOMGuardError(RuntimeError):
    """Raised when device memory use crosses the kill threshold."""


def device_memory_stats(devices=None) -> dict:
    """Device memory in use, its limit and the peak, summed over
    ``devices`` (default: every CUDA device this process initialized);
    zeros without a card, so callers can log unconditionally."""
    in_use = limit = peak = 0
    n_reporting = 0
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())
                    if torch.cuda.is_initialized()]
                   if torch.cuda.is_available() else [])
    for d in devices:
        stats = torch.cuda.memory_stats(d)
        if not stats:
            continue
        n_reporting += 1
        in_use += int(stats.get("allocated_bytes.all.current", 0))
        peak += int(stats.get("allocated_bytes.all.peak", 0))
        limit += int(torch.cuda.get_device_properties(d).total_memory)
    frac = (in_use / limit) if limit else 0.0
    return {
        "mem_bytes_in_use": float(in_use),
        "mem_bytes_limit": float(limit),
        "mem_peak_bytes_in_use": float(peak),
        "mem_frac_in_use": float(frac),
        "mem_devices_reporting": float(n_reporting),
    }


def check_memory_kill_threshold(stats: Optional[dict] = None, devices=None):
    """Raise DeviceOOMGuardError when usage exceeds the env threshold.

    No-op when the env var is unset or no device reports stats."""
    threshold = env_registry.get_float(MEMORY_KILL_THRESHOLD_ENV)
    if threshold is None:
        return
    stats = stats if stats is not None else device_memory_stats(devices)
    if stats["mem_bytes_limit"] and stats["mem_frac_in_use"] > threshold:
        raise DeviceOOMGuardError(
            f"device memory {stats['mem_frac_in_use']:.3f} exceeds "
            f"kill threshold {threshold} "
            f"({stats['mem_bytes_in_use']:.0f}/{stats['mem_bytes_limit']:.0f} "
            f"bytes); terminating for relaunch-recovery"
        )
