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
The consumer side, ``HealthRegistry``, gives the gserver manager its
alive and stopped views of the fleet; its transition callbacks and watch
thread are not ported.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional

from areal_tpu_torch.base import env_registry, logging, name_resolve, names

logger = logging.getLogger("health")

# A member is dead once its last beat is older than STALE_FACTOR * ttl.
STALE_FACTOR = 3.0


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

    def update_payload(self, **kwargs):
        """Merge fields into the record and rewrite it now (a drain
        advertises itself through the heartbeat)."""
        self._payload.update(kwargs)
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


class HealthRegistry:
    """Consumer side: the alive and stopped members under one prefix."""

    def __init__(self, experiment_name: str, trial_name: str, prefix: str = ""):
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.prefix = prefix

    def _root(self) -> str:
        root = names.health_root(self.experiment_name, self.trial_name)
        return root.rstrip("/") + ("/" + self.prefix if self.prefix else "")

    def _records(self) -> Dict[str, Dict]:
        root = self._root().rstrip("/")
        out: Dict[str, Dict] = {}
        for key in name_resolve.find_subtree(root):
            try:
                record = json.loads(name_resolve.get(key))
            except (name_resolve.NameEntryNotFoundError, ValueError):
                continue
            member = key[len(root):].strip("/")
            if self.prefix:
                member = f"{self.prefix}/{member}" if member else self.prefix
            out[member] = record
        return out

    def classified(self) -> "tuple[Dict[str, Dict], Dict[str, Dict]]":
        """(alive, stopped) from one subtree walk: alive members beat
        within STALE_FACTOR * ttl and did not stop gracefully."""
        now = time.time()
        alive: Dict[str, Dict] = {}
        stopped: Dict[str, Dict] = {}
        for m, r in self._records().items():
            if r.get("stopped"):
                stopped[m] = r
            elif now - float(r.get("ts", 0)) <= float(
                r.get("ttl", default_ttl())
            ) * STALE_FACTOR:
                alive[m] = r
        return alive, stopped

    def snapshot(self) -> Dict[str, Dict]:
        """member -> record for every member alive now."""
        return self.classified()[0]
