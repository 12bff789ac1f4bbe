"""RPC substrate of the port's servers and clients (the port's copy of
``areal_tpu/base/rpc.py``): ``Deadline``, ``RetryPolicy`` with its
declared policies, ``shed_backoff``, ``RpcShed``, the retry loops
``retry_async`` / ``retry_sync`` (a shed floors the backoff on the
server's Retry-After), hedged reads (``hedged_sync`` /
``hedged_async``), per-peer circuit breakers (``CircuitBreaker`` pooled
in a ``BreakerBoard``) and the process-global ``stats``.

A deadline crosses the wire as REMAINING seconds in the
``X-Areal-Deadline`` header (the reference's ``DEADLINE_HEADER``), so
clocks never need to agree across hosts: each hop re-anchors against its
own monotonic clock. ``stats`` holds the substrate counters that
``/metrics`` prints as ``areal:rpc_*`` lines and the gserver manager's
``/status`` rpc section carries.

Hedged reads serve idempotent, hash-verified GETs that several holders
can answer (the weight plane's ``/weights/chunk``): the next holder
launches after ``hedge_delay_s`` of silence, the first success wins and
the losers' results are dropped, so byte accounting cannot count them.
A breaker opens after ``AREAL_RPC_BREAKER_FAILS`` consecutive failures,
lets ONE probe through after ``AREAL_RPC_BREAKER_COOLDOWN_S`` (half-open)
and closes on its success; the gserver manager feeds its board from
client reports, its own posts and its ``/metrics`` polls, and leaves an
open peer out of routing.
"""

from __future__ import annotations

import asyncio
import dataclasses
import random
import threading
import time
from typing import (Any, Awaitable, Callable, Dict, List, Optional, Sequence, Tuple,
                    TypeVar)

from areal_tpu_torch.base import env_registry, logging

logger = logging.getLogger("rpc")

T = TypeVar("T")

DEADLINE_HEADER = "X-Areal-Deadline"
MIN_ATTEMPT_S = 0.01
# asyncio.TimeoutError is spelled out: on Python < 3.11 it is not the
# builtin TimeoutError, and it is what an aiohttp total-timeout raises.
RETRYABLE_DEFAULT = (OSError, TimeoutError, asyncio.TimeoutError, ValueError)


class RpcError(RuntimeError):
    """An RPC that exhausted its policy or its deadline."""


class RpcDeadlineExceeded(RpcError):
    pass


class BreakerOpen(RpcError):
    """The peer's circuit breaker is open; no attempt was made."""

    def __init__(self, peer: str, detail: str = ""):
        super().__init__(f"circuit open for {peer}{': ' if detail else ''}{detail}")
        self.peer = peer


class RpcShed(RpcError):
    """The peer shed the request (429). Deliberate backpressure, not a
    failure: carries the server's Retry-After so the retry loop floors
    its backoff on it."""

    def __init__(self, peer: str, retry_after: float):
        super().__init__(f"{peer} shed request (retry after {retry_after:.2f}s)")
        self.peer = peer
        self.retry_after = float(retry_after)


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
    def unbounded(cls) -> "Deadline":
        return cls(None)

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

    def cap(self, budget_s: float) -> "Deadline":
        """The tighter of this deadline and a fresh ``budget_s`` window:
        a hop bounds its own work without ever extending the caller's."""
        capped = time.monotonic() + float(budget_s)
        if self._expires is None or capped < self._expires:
            return Deadline(capped)
        return Deadline(self._expires)


def ensure_deadline(deadline: Optional[Deadline], default_budget_s: float) -> Deadline:
    """The caller's deadline, or a fresh one of ``default_budget_s``."""
    if deadline is not None:
        return deadline
    return Deadline.after(default_budget_s)


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


def hedge_delay_s() -> float:
    return env_registry.get_float("AREAL_RPC_HEDGE_DELAY_S")


def hedging_enabled() -> bool:
    return env_registry.get_bool("AREAL_RPC_HEDGE")


STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half-open"


class CircuitBreaker:
    """Per-peer closed -> open -> half-open breaker.

    ``fail_threshold`` consecutive failures open the circuit; after
    ``cooldown_s`` ONE probe is allowed through (half-open); its success
    closes the circuit, its failure re-opens it for another cooldown.
    Thread-safe: the manager's poll thread and HTTP loop both touch it."""

    __slots__ = ("peer", "fail_threshold", "cooldown_s", "_lock", "_consecutive",
                 "_opened_at", "_probing", "opens", "rejections")

    def __init__(self, peer: str, fail_threshold: int, cooldown_s: float):
        self.peer = peer
        self.fail_threshold = max(1, int(fail_threshold))
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self._consecutive = 0
        self._opened_at: Optional[float] = None
        self._probing = False
        self.opens = 0
        self.rejections = 0

    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if self._opened_at is None:
            return STATE_CLOSED
        if self._probing or time.monotonic() - self._opened_at >= self.cooldown_s:
            return STATE_HALF_OPEN
        return STATE_OPEN

    def allow(self) -> bool:
        """May a call proceed now? In half-open exactly one caller wins
        the probe slot; the others are rejected until it resolves."""
        with self._lock:
            st = self._state_locked()
            if st == STATE_CLOSED:
                return True
            if st == STATE_HALF_OPEN and not self._probing:
                self._probing = True
                return True
            self.rejections += 1
            stats.incr("breaker_rejections")
            return False

    def record_success(self):
        with self._lock:
            self._consecutive = 0
            self._opened_at = None
            self._probing = False

    def release_probe(self):
        """Give an allow()-granted probe slot back without an outcome (a
        non-retryable application error). A leaked slot would keep the
        breaker half-open and reject every later allow()."""
        with self._lock:
            self._probing = False

    def _reopen_locked(self):
        self._opened_at = time.monotonic()
        self.opens += 1
        stats.incr("breaker_opens")

    def record_failure(self):
        with self._lock:
            self._consecutive += 1
            if self._probing:
                # A failed half-open probe re-opens for a fresh cooldown.
                self._probing = False
                self._reopen_locked()
                return
            if self._opened_at is not None:
                # A record()-fed board (the manager never calls allow()):
                # past the cooldown the breaker is half-open by time and
                # this failure is the failed probe; inside the cooldown
                # the open window stays as it is.
                if time.monotonic() - self._opened_at >= self.cooldown_s:
                    self._reopen_locked()
                return
            if self._consecutive >= self.fail_threshold:
                self._reopen_locked()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self._state_locked(),
                    "consecutive_failures": self._consecutive,
                    "opens": self.opens, "rejections": self.rejections}


class BreakerBoard:
    """All of one process's per-peer breakers. The gserver manager folds
    its board into routing (an open peer is unroutable, like a shedding
    one, and never evicted for it) and shows it on /status."""

    def __init__(self, fail_threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None):
        self.fail_threshold = (int(fail_threshold) if fail_threshold is not None
                               else env_registry.get_int("AREAL_RPC_BREAKER_FAILS"))
        self.cooldown_s = (float(cooldown_s) if cooldown_s is not None
                           else env_registry.get_float("AREAL_RPC_BREAKER_COOLDOWN_S"))
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    def breaker(self, peer: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(peer)
            if br is None:
                br = CircuitBreaker(peer, self.fail_threshold, self.cooldown_s)
                self._breakers[peer] = br
            return br

    def allow(self, peer: str) -> bool:
        return self.breaker(peer).allow()

    def record(self, peer: str, ok: bool):
        br = self.breaker(peer)
        if ok:
            br.record_success()
        else:
            br.record_failure()

    def drop(self, peer: str):
        """Forget a departed peer."""
        with self._lock:
            self._breakers.pop(peer, None)

    def open_peers(self) -> List[str]:
        with self._lock:
            items = list(self._breakers.items())
        return sorted(p for p, b in items if b.state() == STATE_OPEN)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            items = list(self._breakers.items())
        return {p: b.snapshot() for p, b in items}


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

    def reset(self):
        """Test hook only: production counters never reset."""
        with self._lock:
            for f in self.FIELDS:
                self._c[f] = 0


stats = RpcStats()


def _breaker_for(peer: Optional[str], board: Optional[BreakerBoard]
                 ) -> Optional[CircuitBreaker]:
    return board.breaker(peer) if (board is not None and peer) else None


def retry_sync(fn: Callable[[float], T], *, policy: RetryPolicy,
               deadline: Optional[Deadline] = None, peer: Optional[str] = None,
               board: Optional[BreakerBoard] = None,
               retryable: Tuple[type, ...] = RETRYABLE_DEFAULT,
               what: str = "rpc") -> T:
    """Call ``fn(attempt_timeout)`` under ``policy``: retry the
    ``retryable`` errors with its backoff, raise RpcError when the
    attempts run out. The breaker of ``peer`` on ``board`` (when given)
    gates every attempt and records its outcome; a shed proves the peer
    alive and counts as a breaker success."""
    last: Optional[BaseException] = None
    br = _breaker_for(peer, board)
    for attempt in range(1, policy.attempts + 1):
        timeout = policy.attempt_timeout(deadline)  # raises when expired
        if br is not None and not br.allow():
            raise BreakerOpen(peer or "?", what)
        stats.incr("attempts")
        try:
            out = fn(timeout)
        except RpcShed as e:
            last = e
            if br is not None:
                br.record_success()
            if attempt >= policy.attempts:
                break
            stats.incr("retries")
            time.sleep(policy.backoff(attempt, retry_after=e.retry_after, deadline=deadline))
            continue
        except retryable as e:
            last = e
            if br is not None:
                br.record_failure()
            if attempt >= policy.attempts:
                break
            stats.incr("retries")
            logger.debug(f"{what}: attempt {attempt} failed: {e!r}")
            time.sleep(policy.backoff(attempt, deadline=deadline))
            continue
        except BaseException:
            # Neither a peer failure nor a success: free the probe slot.
            if br is not None:
                br.release_probe()
            raise
        if br is not None:
            br.record_success()
        return out
    stats.incr("failures")
    raise RpcError(f"{what}: failed after {policy.attempts} attempt(s): {last!r}") from last


async def retry_async(fn: Callable[[float], Awaitable[T]], *, policy: RetryPolicy,
                      deadline: Optional[Deadline] = None, peer: Optional[str] = None,
                      board: Optional[BreakerBoard] = None,
                      retryable: Tuple[type, ...] = RETRYABLE_DEFAULT,
                      what: str = "rpc") -> T:
    """``retry_sync`` for event-loop callers: the same policy, breaker,
    deadline and shed handling, sleeping on the loop."""
    last: Optional[BaseException] = None
    br = _breaker_for(peer, board)
    for attempt in range(1, policy.attempts + 1):
        timeout = policy.attempt_timeout(deadline)  # raises when expired
        if br is not None and not br.allow():
            raise BreakerOpen(peer or "?", what)
        stats.incr("attempts")
        try:
            out = await fn(timeout)
        except RpcShed as e:
            last = e
            if br is not None:
                br.record_success()
            if attempt >= policy.attempts:
                break
            stats.incr("retries")
            await asyncio.sleep(policy.backoff(attempt, retry_after=e.retry_after,
                                               deadline=deadline))
            continue
        except asyncio.CancelledError:
            if br is not None:
                br.release_probe()
            raise
        except retryable as e:
            last = e
            if br is not None:
                br.record_failure()
            if attempt >= policy.attempts:
                break
            stats.incr("retries")
            logger.debug(f"{what}: attempt {attempt} failed: {e!r}")
            await asyncio.sleep(policy.backoff(attempt, deadline=deadline))
            continue
        except BaseException:
            if br is not None:
                br.release_probe()
            raise
        if br is not None:
            br.record_success()
        return out
    stats.incr("failures")
    raise RpcError(f"{what}: failed after {policy.attempts} attempt(s): {last!r}") from last


def hedged_sync(fns: Sequence[Callable[[], T]], *, hedge_delay: Optional[float] = None,
                deadline: Optional[Deadline] = None, what: str = "hedged") -> Tuple[T, int]:
    """Hedged execution of idempotent fetchers: ``fns[0]`` starts at
    once; each time the race has gone ``hedge_delay`` seconds without a
    winner the next one launches (at once when every launched one has
    failed). The first SUCCESS wins and is returned with its index; the
    losers' results are dropped, never returned, and counted in
    ``hedge_cancelled``. Legs run on daemon threads (a urllib read
    cannot be cancelled; the abandoned socket dies with its thread).
    Raises RpcError once every fn has failed."""
    if not fns:
        raise ValueError("hedged_sync: no fetchers")
    if hedge_delay is None:
        hedge_delay = hedge_delay_s()
    done = threading.Event()
    lock = threading.Lock()
    results: Dict[int, Tuple[bool, Any]] = {}

    def run(i: int):
        try:
            out, ok = fns[i](), True
        except BaseException as e:  # noqa: BLE001 - race bookkeeping
            out, ok = e, False
        with lock:
            results[i] = (ok, out)
        done.set()

    launched = 0

    def launch():
        nonlocal launched
        i = launched
        launched += 1
        if i > 0:
            stats.incr("hedges")
        threading.Thread(target=run, args=(i,), daemon=True, name=f"rpc-hedge-{i}").start()

    launch()
    while True:
        rem = deadline.remaining() if deadline is not None else float("inf")
        if rem <= 0:
            stats.incr("deadline_expired")
            raise RpcDeadlineExceeded(f"{what}: deadline expired mid-race")
        wait = min(hedge_delay, rem) if launched < len(fns) else min(rem, 60.0)
        fired = done.wait(wait)
        with lock:
            done.clear()
            winner = next((i for i, (ok, _) in sorted(results.items()) if ok), None)
            failures = sum(1 for ok, _ in results.values() if not ok)
            if winner is not None:
                losers = launched - 1 - failures
                if losers > 0:
                    stats.incr("hedge_cancelled", losers)
                if winner > 0:
                    stats.incr("hedge_wins")
                return results[winner][1], winner
        if failures >= len(fns):
            # A whole race lost counts once; a leg failure inside a race
            # that a hedge still won does not.
            stats.incr("failures")
            stats.incr("hedge_failures")
            err0 = results[0][1]
            raise RpcError(f"{what}: every hedge failed") from (
                err0 if isinstance(err0, BaseException) else None)
        if launched < len(fns) and (not fired or failures >= launched):
            launch()


async def hedged_async(fns: Sequence[Callable[[], Awaitable[T]]], *,
                       hedge_delay: Optional[float] = None,
                       deadline: Optional[Deadline] = None,
                       what: str = "hedged") -> Tuple[T, int]:
    """``hedged_sync`` for event-loop callers, with real cancellation:
    the first success wins and every other task in flight is cancelled
    (counted in ``hedge_cancelled``), so its bytes never arrive."""
    if not fns:
        raise ValueError("hedged_async: no fetchers")
    if hedge_delay is None:
        hedge_delay = hedge_delay_s()

    async def indexed(i: int):
        return i, await fns[i]()

    inflight: List[asyncio.Task] = [asyncio.ensure_future(indexed(0))]
    launched, failed = 1, 0
    first_err: Optional[BaseException] = None
    try:
        while True:
            rem = deadline.remaining() if deadline is not None else float("inf")
            if rem <= 0:
                stats.incr("deadline_expired")
                raise RpcDeadlineExceeded(f"{what}: deadline expired mid-race")
            can_launch = launched < len(fns)
            wait = min(hedge_delay, rem) if can_launch else min(rem, 60.0)
            done, pending = await asyncio.wait(inflight, timeout=wait,
                                               return_when=asyncio.FIRST_COMPLETED)
            for t in done:
                inflight.remove(t)
                if t.cancelled():
                    failed += 1
                    continue
                if t.exception() is not None:
                    failed += 1
                    if first_err is None:
                        first_err = t.exception()
                    continue
                winner_idx, out = t.result()
                if pending:
                    for p in pending:
                        p.cancel()
                    stats.incr("hedge_cancelled", len(pending))
                    await asyncio.gather(*pending, return_exceptions=True)
                if winner_idx > 0:
                    stats.incr("hedge_wins")
                return out, winner_idx
            if failed >= len(fns):
                stats.incr("failures")
                stats.incr("hedge_failures")
                raise RpcError(f"{what}: every hedge failed") from first_err
            if can_launch and (not done or not inflight):
                stats.incr("hedges")
                inflight.append(asyncio.ensure_future(indexed(launched)))
                launched += 1
    finally:
        for t in inflight:
            if not t.done():
                t.cancel()
