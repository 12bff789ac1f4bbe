"""Request-scoped spans for the RL system plane (the port's copy of what
the generation server calls from ``areal_tpu/base/tracing.py``).

Off by default exactly as in the reference: every public call starts
with one cached boolean branch, and the recorder is allocated only when
``AREAL_RL_TRACE`` is truthy. Enabled, spans go to a bounded ring buffer
and are flushed in batches to a per-worker JSONL shard in the
reference's record layout (a header with one wall/monotonic anchor
pair, then one line a span), so the reference's merge tool reads port
shards. Context crosses processes as a small dict inside the HTTP JSON
bodies (``extract_from``).
"""

from __future__ import annotations

import atexit
import contextvars
import dataclasses
import json
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from areal_tpu_torch.base import env_registry

_ENV_ENABLE = "AREAL_RL_TRACE"
_ENV_DIR = "AREAL_RL_TRACE_DIR"
_ENV_RING = "AREAL_RL_TRACE_RING"
_DEFAULT_DIR = "/tmp/areal_tpu/rl_trace"
_FLUSH_EVERY = 512

# Cached enablement: None = not yet read from the environment. The hot
# path pays exactly one branch once this is a bool.
_ENABLED: Optional[bool] = None
# The recorder is allocated lazily and ONLY when enabled.
_REC: Optional["_Recorder"] = None
_REC_LOCK = threading.Lock()
# Worker label stamped on every span this process records (set from
# Worker.configure; falls back to "proc<pid>").
_WORKER: Optional[str] = None
# Experiment/trial scope for the DEFAULT shard dir: without it, reruns
# against the fixed default path would silently mix shards from earlier
# runs into every summary. An explicit AREAL_RL_TRACE_DIR wins — callers
# setting it own its freshness.
_SCOPE: Optional[str] = None

_CTX_KEY = "__rl_trace__"

_current: contextvars.ContextVar[Optional["SpanContext"]] = (
    contextvars.ContextVar("areal_rl_trace_ctx", default=None)
)


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """What crosses process/task boundaries: which trace, which parent."""

    trace_id: str
    span_id: str

    def to_dict(self) -> Dict[str, str]:
        return {"trace_id": self.trace_id, "span_id": self.span_id}


def enabled() -> bool:
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = env_registry.get_bool(_ENV_ENABLE)
    return _ENABLED


def trace_dir() -> str:
    d = env_registry.get_str(_ENV_DIR)
    if d:
        return d
    if _SCOPE:
        return os.path.join(_DEFAULT_DIR, _SCOPE)
    return _DEFAULT_DIR


def configure_worker(
    name: str, experiment: str = "", trial: str = ""
) -> None:
    """Label this process's shard with the worker name (e.g.
    'rollout_worker/0') and scope the default shard dir by
    experiment/trial. Safe to call when tracing is disabled."""
    global _WORKER, _SCOPE
    if name:
        _WORKER = name
    if experiment and trial:
        _SCOPE = f"{experiment}__{trial}".replace("/", "_").replace(
            os.sep, "_"
        )


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class _Recorder:
    """Bounded ring buffer of span dicts + batched JSONL shard writer."""

    def __init__(self, worker: str):
        self.worker = worker
        self.capacity = env_registry.get_int(_ENV_RING)
        self._buf: List[Dict] = []
        self._lock = threading.Lock()
        self.n_dropped = 0
        self.anchor_wall_ns = time.time_ns()
        self.anchor_mono_ns = time.monotonic_ns()
        d = trace_dir()
        os.makedirs(d, exist_ok=True)
        safe = worker.replace("/", "_").replace(os.sep, "_")
        self.path = os.path.join(d, f"{safe}.{os.getpid()}.jsonl")
        self._header_written = False

    def append(self, rec: Dict) -> None:
        flush_now = False
        with self._lock:
            if len(self._buf) >= self.capacity:
                # Overflow: drop the oldest half rather than blocking the
                # hot path or growing without bound.
                drop = self.capacity // 2
                del self._buf[:drop]
                self.n_dropped += drop
            self._buf.append(rec)
            flush_now = len(self._buf) >= _FLUSH_EVERY
        if flush_now:
            self.flush()

    def flush(self) -> None:
        # The file write stays under the lock: concurrent flushes from
        # two threads (engine loop + HTTP loop) would otherwise
        # interleave >8KB TextIOWrapper chunks mid-line and corrupt the
        # JSONL shard. Flushes are rare (every 512 spans), so briefly
        # blocking a concurrent append is the cheaper correctness.
        with self._lock:
            batch, self._buf = self._buf, []
            header = None
            if not self._header_written:
                header = {
                    "kind": "header",
                    "worker": self.worker,
                    "pid": os.getpid(),
                    "anchor_wall_ns": self.anchor_wall_ns,
                    "anchor_mono_ns": self.anchor_mono_ns,
                }
                self._header_written = True
            dropped, self.n_dropped = self.n_dropped, 0
            if header is None and not batch and not dropped:
                return
            lines = []
            if header is not None:
                lines.append(json.dumps(header, separators=(",", ":")))
            if dropped:
                lines.append(
                    json.dumps(
                        {"kind": "dropped", "count": dropped},
                        separators=(",", ":"),
                    )
                )
            for rec in batch:
                lines.append(
                    json.dumps(rec, separators=(",", ":"), default=str)
                )
            try:
                with open(self.path, "a") as f:
                    f.write("\n".join(lines) + "\n")
            except OSError:
                # Tracing must never take down the hot path: a full or
                # vanished /tmp loses this batch (counted as dropped);
                # if the header was in it, rewrite it with the next
                # successful flush so the shard stays parseable.
                self.n_dropped += len(batch)
                if header is not None:
                    self._header_written = False


def _rec() -> _Recorder:
    global _REC
    if _REC is None:
        with _REC_LOCK:
            if _REC is None:
                _REC = _Recorder(_WORKER or f"proc{os.getpid()}")
                atexit.register(_REC.flush)
    return _REC


def flush() -> None:
    if _REC is not None:
        _REC.flush()


# ---------------------------------------------------------------------------
# Context propagation
# ---------------------------------------------------------------------------


def extract(d: Any) -> Optional[SpanContext]:
    """Rebuild a SpanContext from `inject()` output (tolerates None /
    junk — transport metadata is best-effort)."""
    if not enabled() or not isinstance(d, dict):
        return None
    tid, sid = d.get("trace_id"), d.get("span_id")
    if not tid or not sid:
        return None
    return SpanContext(trace_id=str(tid), span_id=str(sid))


def extract_from(meta: Any) -> Optional[SpanContext]:
    """Pop and rebuild a context placed by `inject_into` (pops even when
    present-but-disabled so payloads stay clean)."""
    if not isinstance(meta, dict):
        return None
    d = meta.pop(_CTX_KEY, None)
    return extract(d)


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------


def _record(
    name: str,
    start_ns: int,
    end_ns: int,
    trace_id: str,
    span_id: str,
    parent_id: Optional[str],
    attrs: Dict[str, Any],
) -> None:
    rec = {
        "kind": "span",
        "name": name,
        "trace": trace_id,
        "span": span_id,
        "parent": parent_id,
        "start_ns": start_ns,
        "end_ns": end_ns,
        "tid": threading.get_ident() & 0xFFFF,
    }
    if attrs:
        rec["attrs"] = attrs
    _rec().append(rec)


class ManualSpan:
    """A span opened now and ended later (possibly from another task/
    thread) — for lifetimes that don't nest in one call frame, like a
    rollout episode or an HTTP request handled across callbacks. `ctx`
    is the span's OWN context: hand it to children / inject it."""

    __slots__ = ("name", "ctx", "parent_id", "start_ns", "attrs", "_done")

    def __init__(self, name: str, parent: Optional[SpanContext], attrs: Dict):
        if parent is not None:
            trace_id, self.parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, self.parent_id = _new_id(), None
        self.name = name
        self.ctx = SpanContext(trace_id=trace_id, span_id=_new_id())
        self.start_ns = time.monotonic_ns()
        self.attrs = dict(attrs)
        self._done = False

    def end(self, **attrs: Any) -> None:
        if self._done:
            return
        self._done = True
        self.attrs.update(attrs)
        _record(
            self.name, self.start_ns, time.monotonic_ns(),
            self.ctx.trace_id, self.ctx.span_id, self.parent_id, self.attrs,
        )


def start_span(
    name: str, ctx: Optional[SpanContext] = None, **attrs: Any
) -> Optional[ManualSpan]:
    """Open a ManualSpan under `ctx` (or the current context, or a new
    trace). Returns None when tracing is disabled — callers guard with
    `if ms is not None: ms.end()` or just `ms and ms.end()`."""
    if not enabled():
        return None
    parent = ctx if ctx is not None else _current.get()
    return ManualSpan(name, parent, attrs)


def record_span(
    name: str,
    start_ns: int,
    end_ns: Optional[int] = None,
    ctx: Optional[SpanContext] = None,
    **attrs: Any,
) -> None:
    """Record a span with explicit timestamps — for lifetimes that do not
    nest in one call frame (buffer residency: enqueue → consume). `ctx`
    is the PARENT (the recorded span gets a fresh span id under it);
    without one the span starts its own trace."""
    if not enabled():
        return
    parent = ctx if ctx is not None else _current.get()
    if parent is not None:
        trace_id, parent_id = parent.trace_id, parent.span_id
    else:
        trace_id, parent_id = _new_id(), None
    _record(
        name,
        int(start_ns),
        int(end_ns if end_ns is not None else time.monotonic_ns()),
        trace_id,
        _new_id(),
        parent_id,
        attrs,
    )


def event(name: str, ctx: Optional[SpanContext] = None, **attrs: Any) -> None:
    """Zero-duration marker (retries, evictions, drops)."""
    if not enabled():
        return
    t = time.monotonic_ns()
    record_span(name, t, t, ctx=ctx, **attrs)
