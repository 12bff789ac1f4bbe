"""RPC substrate pieces the port's servers and clients use (the port's
copy of ``Deadline``, ``RetryPolicy`` with its declared policies,
``shed_backoff``, ``retry_async`` / ``retry_sync`` (without the breaker)
and the process-global ``stats`` of
``areal_tpu/base/rpc.py``).

A deadline crosses the wire as REMAINING seconds in the
``X-Areal-Deadline`` header (the reference's ``DEADLINE_HEADER``), so
clocks never need to agree across hosts: each hop re-anchors against its
own monotonic clock. ``stats`` holds the substrate counters that
``/metrics`` prints as ``areal:rpc_*`` lines. The hedged reads and the
per-peer circuit breakers of the reference are not ported: no port
caller reads from several holders, and the port's gserver manager evicts
a server that a client reports failed.
"""

from __future__ import annotations

import asyncio
import dataclasses
import random
import threading
import time
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple, TypeVar

from areal_tpu_torch.base import env_registry, logging

logger = logging.getLogger("rpc")

T = TypeVar("T")

DEADLINE_HEADER = "X-Areal-Deadline"
MIN_ATTEMPT_S = 0.01


class RpcError(RuntimeError):
    """An RPC that exhausted its policy or its deadline."""


class RpcDeadlineExceeded(RpcError):
    pass


class Deadline:
    """A monotonic-clock budget minted once at the outermost caller and
    decremented implicitly as time passes. Serialized on the wire as
    REMAINING seconds (``X-Areal-Deadline: 12.345``) so clocks never
    need to agree across hosts — each hop re-anchors against its own
    monotonic clock, losing only the network latency of the hop."""

    __slots__ = ("_expires",)

    def __init__(self, expires_monotonic: Optional[float]):
        self._expires = expires_monotonic

    @classmethod
    def after(cls, budget_s: float) -> "Deadline":
        return cls(time.monotonic() + float(budget_s))

    @classmethod
    def from_header_value(cls, value: Optional[str]) -> Optional["Deadline"]:
        if not value:
            return None
        try:
            return cls.after(float(value))
        except ValueError:
            return None

    @classmethod
    def from_headers(cls, headers) -> Optional["Deadline"]:
        """Parse the propagated deadline out of a request's headers
        (any mapping with .get). None when the caller sent none."""
        try:
            return cls.from_header_value(headers.get(DEADLINE_HEADER))
        except Exception:
            return None

    def remaining(self) -> float:
        if self._expires is None:
            return float("inf")
        return self._expires - time.monotonic()

    def expired(self) -> bool:
        return self._expires is not None and self.remaining() <= 0.0

    def bounded(self) -> bool:
        return self._expires is not None

    def header_value(self) -> Optional[str]:
        if self._expires is None:
            return None
        return f"{max(0.0, self.remaining()):.3f}"

    def headers(self, base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
        """``base`` plus the deadline header (omitted when unbounded)."""
        out = dict(base or {})
        v = self.header_value()
        if v is not None:
            out[DEADLINE_HEADER] = v
        return out


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """One declared retry discipline: how many attempts, how long each
    may take, how long to wait between them."""

    attempts: int = 4
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    attempt_timeout_s: float = 30.0
    jitter: float = 0.5  # +-fraction of the computed backoff

    def attempt_timeout(self, deadline: Optional[Deadline]) -> float:
        """The policy cap clipped to the remaining budget; raises
        RpcDeadlineExceeded when the budget cannot fit an attempt."""
        if deadline is None:
            return self.attempt_timeout_s
        rem = deadline.remaining()
        if rem <= MIN_ATTEMPT_S:
            stats.incr("deadline_expired")
            raise RpcDeadlineExceeded(f"deadline expired ({rem:.3f}s remaining)")
        return min(self.attempt_timeout_s, rem)

    def backoff(self, consecutive_failures: int, retry_after: Optional[float] = None,
                deadline: Optional[Deadline] = None) -> float:
        """Jittered exponential backoff after the k-th consecutive
        failure (k >= 1); a server's Retry-After floors it; the
        remaining budget caps it."""
        k = max(1, int(consecutive_failures))
        delay = min(self.backoff_max_s, self.backoff_base_s * (2 ** (k - 1)))
        if self.jitter:
            delay *= 1.0 + self.jitter * (2.0 * random.random() - 1.0)
        if retry_after is not None:
            delay = max(delay, float(retry_after))
        if deadline is not None and deadline.bounded():
            delay = min(delay, max(0.0, deadline.remaining()))
        return delay


def default_policy(**overrides) -> RetryPolicy:
    """The fleet-wide declared policy, tuned by AREAL_RPC_* knobs."""
    kw: Dict[str, Any] = dict(
        attempts=env_registry.get_int("AREAL_RPC_ATTEMPTS"),
        backoff_base_s=env_registry.get_float("AREAL_RPC_BACKOFF_S"),
        backoff_max_s=env_registry.get_float("AREAL_RPC_BACKOFF_MAX_S"),
        attempt_timeout_s=env_registry.get_float("AREAL_RPC_TIMEOUT_S"),
    )
    kw.update(overrides)
    return RetryPolicy(**kw)


def rediscovery_policy(**overrides) -> RetryPolicy:
    """The manager-blip policy shared by partial_rollout and the rollout
    worker: a generous budget and a backoff ceiling high enough not to
    hammer a restarted manager."""
    kw: Dict[str, Any] = dict(
        attempts=env_registry.get_int("AREAL_RPC_REDISCOVERY_ATTEMPTS"),
        backoff_base_s=env_registry.get_float("AREAL_RPC_BACKOFF_S"),
        backoff_max_s=env_registry.get_float("AREAL_RPC_REDISCOVERY_BACKOFF_MAX_S"),
        attempt_timeout_s=env_registry.get_float("AREAL_RPC_TIMEOUT_S"),
    )
    kw.update(overrides)
    return RetryPolicy(**kw)


def shed_backoff(consecutive_sheds: int, retry_after: float, cap: float = 10.0) -> float:
    """The client-side 429 discipline: a jittered wait around the
    server's Retry-After with a mild exponential ramp on consecutive
    sheds. Sheds never touch failure budgets."""
    k = max(1, int(consecutive_sheds))
    delay = min(cap, float(retry_after) * (2 ** min(k - 1, 3)))
    return delay * (0.5 + random.random())


async def retry_async(fn: Callable[[float], Awaitable[T]], *, policy: RetryPolicy,
                      deadline: Optional[Deadline] = None,
                      retryable: Tuple[type, ...] = (OSError, TimeoutError,
                                                     asyncio.TimeoutError, ValueError),
                      what: str = "rpc") -> T:
    """Call ``fn(attempt_timeout)`` under ``policy``: retry the
    ``retryable`` errors with its backoff, raise RpcError when the
    attempts run out."""
    last: Optional[BaseException] = None
    for attempt in range(1, policy.attempts + 1):
        timeout = policy.attempt_timeout(deadline)  # raises when expired
        stats.incr("attempts")
        try:
            return await fn(timeout)
        except retryable as e:
            last = e
            if attempt >= policy.attempts:
                break
            stats.incr("retries")
            logger.debug(f"{what}: attempt {attempt} failed: {e!r}")
            await asyncio.sleep(policy.backoff(attempt, deadline=deadline))
    stats.incr("failures")
    raise RpcError(f"{what}: failed after {policy.attempts} attempt(s): {last!r}") from last


def retry_sync(fn: Callable[[float], T], *, policy: RetryPolicy,
               deadline: Optional[Deadline] = None,
               retryable: Tuple[type, ...] = (OSError, TimeoutError, ValueError),
               what: str = "rpc") -> T:
    """``retry_async`` for callers on plain threads."""
    last: Optional[BaseException] = None
    for attempt in range(1, policy.attempts + 1):
        timeout = policy.attempt_timeout(deadline)  # raises when expired
        stats.incr("attempts")
        try:
            return fn(timeout)
        except retryable as e:
            last = e
            if attempt >= policy.attempts:
                break
            stats.incr("retries")
            logger.debug(f"{what}: attempt {attempt} failed: {e!r}")
            time.sleep(policy.backoff(attempt, deadline=deadline))
    stats.incr("failures")
    raise RpcError(f"{what}: failed after {policy.attempts} attempt(s): {last!r}") from last


class RpcStats:
    """Process-global substrate counters, emitted as areal:rpc_* lines
    by generation_server._h_metrics and the manager /status rpc
    section. Monotonic since process start, like every /metrics
    counter."""

    FIELDS = (
        "attempts", "retries", "failures",
        "hedges", "hedge_wins", "hedge_cancelled", "hedge_failures",
        "deadline_expired", "breaker_rejections", "breaker_opens",
    )

    def __init__(self):
        self._lock = threading.Lock()
        self._c: Dict[str, int] = {f: 0 for f in self.FIELDS}

    def incr(self, field: str, n: int = 1):
        with self._lock:
            self._c[field] += n

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c)



stats = RpcStats()
