"""The ``AREAL_*`` environment knobs the port reads (the port's copy of
``areal_tpu/base/env_registry.py``, trimmed to the knobs of the copied
modules; names, kinds and defaults are the reference's, so one
environment configures reference and port processes alike).

Accessor semantics are the reference's: unset or empty values fall back
to the declared default; booleans read ``"" / "0" / "false" / "no" /
"off"`` (any case) as False and anything else set as True; a knob whose
default is ``None`` returns ``None`` when unset. Reading an undeclared
name raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

_FALSEY = ("", "0", "false", "no", "off")


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    kind: str  # "str" | "int" | "float" | "bool"
    default: Any
    doc: str


_KNOBS: List[Knob] = [
    Knob("AREAL_LOG_LEVEL", "str", "INFO",
         "Root log level for the port's loggers (base/logging.py)."),
    Knob("AREAL_FAULTS", "str", "",
         "Deterministic chaos-injection spec (base/fault_injection.py); "
         "empty = no faults."),
    Knob("AREAL_HEALTH_TTL", "float", 10.0,
         "Default lease TTL seconds of a worker heartbeat (base/health.py)."),
    Knob("AREAL_NAME_RESOLVE_ROOT", "str", "/tmp/areal_tpu/name_resolve",
         "Root directory of the filesystem name-resolve backend "
         "(base/name_resolve.py); the reference's, so both packages "
         "share records."),
    Knob("AREAL_RL_TRACE", "bool", False,
         "Arm the request-scoped span recorder (base/tracing.py)."),
    Knob("AREAL_RL_TRACE_DIR", "str", None,
         "Output dir for span shards; unset = /tmp/areal_tpu/rl_trace[/<scope>]."),
    Knob("AREAL_RL_TRACE_RING", "int", 65536,
         "Span ring-buffer capacity per worker before drops (base/tracing.py)."),
    Knob("AREAL_CHAOS_HTTP", "bool", False,
         "Arm the generation server's /configure chaos-control surface; "
         "with it off, /configure refuses fault specs with 403."),
    Knob("AREAL_WEIGHT_LOAD_RETRIES", "int", 40,
         "Weight-load retry attempts while a dump lands "
         "(system/weight_transfer.py)."),
    Knob("AREAL_WEIGHT_LOAD_RETRY_S", "float", 0.25,
         "Sleep seconds between weight-load retries."),
    Knob("AREAL_FILEROOT", "str", None,
         "Filesystem root for logs, recover data and param-realloc dumps "
         "(base/constants.py); unset = <tempdir>/areal_tpu/$USER. Read at "
         "call time."),
    Knob("AREAL_CKPT_BACKEND", "str", "pickle",
         "Checkpoint storage backend when the API caller passes none: "
         "'pickle' (engine/checkpoint.py); 'orbax' is not ported and raises."),
    Knob("AREAL_CKPT_ASYNC", "bool", False,
         "Route pickle-backend engine checkpoints through the background "
         "writer (engine/checkpoint.py): the step loop pays only the "
         "snapshot while the host copy, pickling, fsync and rename run on "
         "the writer thread."),
    Knob("AREAL_WAL", "bool", True,
         "Arm the rollout write-ahead log and exactly-once ledger "
         "(system/wal.py, system/stream_dataset.py): accepted trajectories "
         "journal to disk before the pusher is acked."),
    Knob("AREAL_WAL_FSYNC_MS", "float", 50.0,
         "Max milliseconds an appended WAL record waits for the batched "
         "fsync (and its deferred ack); 0 = fsync every append."),
    Knob("AREAL_WAL_ACK_TIMEOUT_S", "float", 5.0,
         "Seconds a pushed sample may sit unacked before the pusher "
         "redelivers it (system/push_pull_stream.py)."),
    Knob("AREAL_WAL_REDELIVER_MAX", "int", 0,
         "Redeliveries of an unacked sample before the pusher drops it; "
         "0 = retry forever."),
    Knob("AREAL_RPC_ATTEMPTS", "int", 4,
         "Default attempts per cross-process RPC (base/rpc.py default_policy)."),
    Knob("AREAL_RPC_BACKOFF_S", "float", 0.05,
         "Base of the jittered exponential backoff between RPC attempts; a "
         "server's Retry-After floors the computed wait."),
    Knob("AREAL_RPC_BACKOFF_MAX_S", "float", 2.0,
         "Backoff ceiling for the default RPC policy."),
    Knob("AREAL_RPC_TIMEOUT_S", "float", 30.0,
         "Per-attempt timeout cap of the RPC policies."),
    Knob("AREAL_RPC_HEDGE", "bool", True,
         "Enable hedged reads of idempotent hash-verified GETs (the weight "
         "plane's /weights/chunk) when several holders exist."),
    Knob("AREAL_RPC_HEDGE_DELAY_S", "float", 0.25,
         "Silence window after which a hedge request launches against the "
         "next holder; first success wins, losers are dropped."),
    Knob("AREAL_RPC_BREAKER_FAILS", "int", 5,
         "Consecutive failures that open a per-peer circuit breaker "
         "(closed -> open); sheds (429) never count."),
    Knob("AREAL_RPC_BREAKER_COOLDOWN_S", "float", 2.0,
         "Open-breaker cooldown before ONE half-open probe is allowed "
         "through; probe success closes the circuit, failure re-opens."),
    Knob("AREAL_RPC_REDISCOVERY_ATTEMPTS", "int", 64,
         "Manager-blip budget shared by partial_rollout and the rollout "
         "worker (base/rpc.py rediscovery_policy)."),
    Knob("AREAL_RPC_REDISCOVERY_BACKOFF_MAX_S", "float", 5.0,
         "Backoff ceiling while rediscovering a restarted manager."),
    Knob("AREAL_SYMPY_TIMEOUT_S", "float", 3.0,
         "Per-expression sympy equivalence-check timeout "
         "(functioncall/math_grader.py)."),
    Knob("AREAL_PYEXEC_TIMEOUT", "float", 6.0,
         "Sandboxed python-answer execution timeout seconds "
         "(functioncall/python_answer.py)."),
    Knob("AREAL_REXEC_WORKERS", "int", 2,
         "Warm sandbox worker subprocesses per reward-executor service "
         "(system/reward_executor.py). Workers are reused across jobs; a "
         "job that times out or crashes costs one respawn, not the pool."),
    Knob("AREAL_REXEC_QUEUE_MAX", "int", 64,
         "Bounded pending-job queue per executor service; submits beyond "
         "it shed 429 + Retry-After."),
    Knob("AREAL_REXEC_MEM_MB", "int", 1024,
         "RLIMIT_AS ceiling (MiB) applied inside each warm sandbox worker "
         "at spawn."),
    Knob("AREAL_REXEC_TIMEOUT_S", "float", 6.0,
         "Default per-job wall timeout on the executor pool; an overrun "
         "kills and respawns the one worker running the job."),
    Knob("AREAL_REXEC_MAX_REUSE", "int", 0,
         "Jobs served per warm worker before a preventive recycle; 0 = "
         "unlimited reuse."),
    Knob("AREAL_TASK_STALENESS_WINDOWS", "str", "math:2,agentic:8",
         "Per-task admission windows of the trainer's buffer "
         "(system/buffer.py): 'task:max_lag' entries; a sample tagged with "
         "a listed task is dropped at admission once the train step minus "
         "its version_end exceeds the window."),
    Knob("AREAL_TPU_MEMORY_KILL_THRESHOLD", "float", None,
         "Device-memory fraction above which a model worker raises after "
         "an MFC (base/monitor.py); unset = disabled."),
]

REGISTRY: Dict[str, Knob] = {k.name: k for k in _KNOBS}


def _knob(name: str) -> Knob:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"{name} is not declared in areal_tpu_torch.base.env_registry") from None


def get_str(name: str) -> Optional[str]:
    k = _knob(name)
    v = os.environ.get(name)
    return v if v else k.default


def get_int(name: str) -> Optional[int]:
    k = _knob(name)
    v = os.environ.get(name)
    if not v:
        return k.default
    try:
        return int(v)
    except ValueError as e:
        raise ValueError(f"{name}={v!r}: expected an integer") from e


def get_float(name: str) -> Optional[float]:
    k = _knob(name)
    v = os.environ.get(name)
    if not v:
        return k.default
    try:
        return float(v)
    except ValueError as e:
        raise ValueError(f"{name}={v!r}: expected a float") from e


def get_bool(name: str) -> bool:
    k = _knob(name)
    v = os.environ.get(name)
    if not v:
        return bool(k.default)
    return v.strip().lower() not in _FALSEY
