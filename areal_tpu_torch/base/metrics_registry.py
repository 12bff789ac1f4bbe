"""Cross-process metric names of the worker system (the port's copy of
the ``perf/*``, trainer-plane and reward-executor ``areal:*`` entries of
``areal_tpu/base/metrics_registry.py``). The names are the reference's
byte for byte: MFC stats a port model worker ships are read by a master
of either package under the same keys. Each name is bound to a module
constant (``perf/sec`` -> ``PERF_SEC``) by the reference's rule."""

from __future__ import annotations

from typing import Dict

AREAL_PREFIX = "areal:"
PERF_PREFIX = "perf/"

_NAMES = (
    # MFC perf scalars (model worker -> master)
    "perf/sec", "perf/elapsed", "perf/flops", "perf/tflops", "perf/gen_tokens",
    "perf/gen_tokens_per_sec", "perf/packing_efficiency", "perf/h2d_wait_ms",
    "perf/dispatch_gap_ms", "perf/overlap_events", "perf/moe_drop_rate",
    "perf/moe_router_entropy", "perf/moe_expert_overload", "perf/moe_a2a_bytes",
    # rollout telemetry riding trajectory metadata (master side)
    "perf/rollout_e2e_p50_ms", "perf/rollout_e2e_p95_ms", "perf/reprefill_tokens",
    "perf/episode_turns", "perf/episode_tool_calls",
    # per-task staleness of the consumed batch and the buffer's per-task
    # admission drops (system/model_function_call.py)
    "perf/task_staleness_math", "perf/task_staleness_agentic",
    "perf/task_stale_dropped_math", "perf/task_stale_dropped_agentic",
    # device memory after every MFC (base/monitor.device_memory_stats)
    "perf/mem_bytes_in_use", "perf/mem_bytes_limit", "perf/mem_peak_bytes_in_use",
    "perf/mem_frac_in_use", "perf/mem_devices_reporting",
    # trainer-plane counters (push/pull stream, stream dataset, buffer)
    "areal:train_samples_lost_total", "areal:train_samples_duplicated_total",
    "areal:train_wal_replayed_total", "areal:train_wal_dup_dropped_total",
    "areal:train_stale_dropped_total",
    # pooled reward executor /metrics (system/reward_executor.py)
    "areal:rexec_jobs_total", "areal:rexec_job_failures", "areal:rexec_timeouts",
    "areal:rexec_shed_total", "areal:rexec_queue_depth", "areal:rexec_workers_alive",
    "areal:rexec_worker_respawns", "areal:rexec_warm_hits",
)

REGISTRY = frozenset(_NAMES)


def const_name(name: str) -> str:
    """``areal:x_y`` -> ``X_Y``, ``perf/x_y`` -> ``PERF_X_Y``."""
    if name.startswith(AREAL_PREFIX):
        return name[len(AREAL_PREFIX):].upper()
    if name.startswith(PERF_PREFIX):
        return "PERF_" + name[len(PERF_PREFIX):].upper()
    raise ValueError(f"metric {name!r} outside both namespaces")


for _name in _NAMES:
    globals()[const_name(_name)] = _name
del _name


def perf_mem_stats(mem: Dict[str, float]) -> Dict[str, float]:
    """Prefix monitor.device_memory_stats() keys into declared
    ``perf/mem_*`` scalars; an undeclared key raises."""
    out = {}
    for k, v in mem.items():
        name = f"{PERF_PREFIX}{k}"
        if name not in REGISTRY:
            raise KeyError(f"{name} is not declared in areal_tpu_torch.base.metrics_registry")
        out[name] = v
    return out
