"""Worker heartbeats on top of name_resolve (the port's copy of the
producer side of ``areal_tpu/base/health.py``).

Every worker periodically rewrites a small JSON record under
``names.health(exp, trial, member)`` carrying its wall-clock timestamp
and TTL; the record layout is the reference's, so a reference gserver
manager classifies a port server as alive, dead or stopped exactly as it
does a reference one. A beat happens only while the owning poll loop
makes progress (no background thread), so a hung worker goes stale.
Records are written with ``delete_on_exit=False``: a clean exit rewrites
the record with a ``stopped`` marker, a killed worker leaves it stale.
The consumer side (``HealthRegistry``) is not ported.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional

from areal_tpu_torch.base import env_registry, logging, name_resolve, names

logger = logging.getLogger("health")


def default_ttl() -> float:
    """Heartbeat TTL (seconds). AREAL_HEALTH_TTL overrides for tests and
    chaos drills that need sub-second failure detection."""
    return env_registry.get_float("AREAL_HEALTH_TTL")


class Heartbeat:
    """Producer side: one member's periodic lease renewal.

    ``beat()`` is cheap and rate-limited (ttl/3), so callers just invoke
    it from their poll loop every iteration. There is deliberately NO
    background thread: a beat only happens while the owning loop is
    actually making progress, which is what makes hung-worker detection
    possible.
    """

    def __init__(
        self,
        experiment_name: str,
        trial_name: str,
        member: str,
        payload: Optional[Dict] = None,
        ttl: Optional[float] = None,
    ):
        self.member = member
        self.ttl = ttl if ttl is not None else default_ttl()
        self._key = names.health(experiment_name, trial_name, member)
        self._payload = dict(payload or {})
        self._last_beat = 0.0
        self._stopped = False
        self.beat(force=True)

    def beat(self, force: bool = False):
        """Renew the lease (no-op within ttl/3 of the previous beat)."""
        if self._stopped:
            return
        now = time.monotonic()
        if not force and now - self._last_beat < self.ttl / 3:
            return
        record = dict(self._payload)
        record["ts"] = time.time()
        record["ttl"] = self.ttl
        try:
            name_resolve.add(
                self._key,
                json.dumps(record, separators=(",", ":")),
                delete_on_exit=False,
                replace=True,
            )
            self._last_beat = now
        except Exception:
            # A flaky KV write must never take down the worker it is
            # supposed to protect; the next beat retries.
            logger.warning(f"heartbeat write failed for {self.member}",
                           exc_info=True)

    def stop(self):
        """Clean shutdown: rewrite the record with a `stopped` marker so
        consumers can tell a graceful departure (leaves the live set, no
        death handling) from a crash/hang (stale record, death
        handling)."""
        if self._stopped:
            return
        self._stopped = True
        record = dict(self._payload)
        record["ts"] = time.time()
        record["ttl"] = self.ttl
        record["stopped"] = True
        try:
            name_resolve.add(
                self._key,
                json.dumps(record, separators=(",", ":")),
                delete_on_exit=False,
                replace=True,
            )
        except Exception:
            try:
                name_resolve.delete(self._key)
            except Exception:
                pass
