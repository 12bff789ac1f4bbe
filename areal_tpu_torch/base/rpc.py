"""RPC substrate pieces the generation server uses (the port's copy of
``Deadline`` and the process-global ``stats`` of
``areal_tpu/base/rpc.py``).

A deadline crosses the wire as REMAINING seconds in the
``X-Areal-Deadline`` header (the reference's ``DEADLINE_HEADER``), so
clocks never need to agree across hosts: each hop re-anchors against its
own monotonic clock. ``stats`` holds the substrate counters that
``/metrics`` prints as ``areal:rpc_*`` lines; the port makes no outbound
calls yet, so only ``deadline_expired`` moves. The retry, hedge and
breaker machinery of the reference is not ported.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

DEADLINE_HEADER = "X-Areal-Deadline"


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
