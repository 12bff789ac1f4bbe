"""Deterministic chaos injection (the port's copy of what the generation
server and worker call from ``areal_tpu/base/fault_injection.py``).

Production code declares named injection points (one-line calls like
``faults.maybe_fail("gserver.generate")``) that are free no-ops until
armed. An armed point fires a chosen action on its k-th hit: ``raise``
(``FaultInjected``), ``die`` (``os._exit(1)``), ``delay`` (sleep
``delay_s``), ``hang`` (sleep effectively forever), ``flaky`` (raise for
the first ``n`` hits, then succeed) or ``corrupt`` (inert at the plain
points the port has). Arming is in-process (``faults.arm``) or by the
``AREAL_FAULTS`` spec, the reference's format::

    <point>[@<scope>]=<action>[:k=<int>][:n=<int>][:delay=<float>]

The port's points run on request threads, so ``delay`` and ``hang``
stall only the request they hit, as the reference's async points do on
its event loop.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional

from areal_tpu_torch.base import env_registry, logging

logger = logging.getLogger("fault_injection")

_HANG_SECONDS = 3600.0


class FaultInjected(RuntimeError):
    """Raised by an armed injection point (action='raise')."""


class _Arm:
    __slots__ = ("action", "at_hit", "times", "delay_s", "scope",
                 "on_trigger", "fired")

    def __init__(self, action: str, at_hit: int = 1,
                 times: Optional[int] = None,
                 delay_s: float = 0.0, scope: Optional[str] = None,
                 on_trigger: Optional[Callable[[], None]] = None):
        if action not in ("raise", "die", "delay", "hang", "flaky",
                          "corrupt"):
            raise ValueError(f"unknown fault action {action!r}")
        self.action = action
        self.at_hit = max(1, int(at_hit))
        if times is None:
            # flaky's whole point is fail-then-SUCCEED under one knob:
            # the bare spec "<point>=flaky" fails twice then passes.
            times = 2 if action == "flaky" else 1
        self.times = int(times)  # 0 = every hit from at_hit on
        self.delay_s = float(delay_s)
        self.scope = scope
        self.on_trigger = on_trigger
        self.fired = 0

    def should_fire(self, hit: int, scope: Optional[str]) -> bool:
        if self.scope is not None and self.scope != scope:
            return False
        if hit < self.at_hit:
            return False
        return self.times == 0 or self.fired < self.times


class FaultInjector:
    def __init__(self):
        self._lock = threading.Lock()
        self._arms: Dict[str, List[_Arm]] = {}
        self._hits: Dict[str, int] = {}
        self._scope: Optional[str] = None
        self._env_loaded = False

    # -- configuration --------------------------------------------------

    def set_scope(self, scope: str):
        """Identify this process (worker_name) for @scope-filtered arms."""
        with self._lock:
            self._scope = scope

    def arm(self, point: str, action: str = "raise", at_hit: int = 1,
            times: Optional[int] = None, delay_s: float = 0.0,
            scope: Optional[str] = None,
            on_trigger: Optional[Callable[[], None]] = None):
        """Arm `point` to fire `action` on its at_hit-th hit (then for
        `times` consecutive hits; times=0 = forever; None = the
        action's default, 1 for everything but flaky's 2). `on_trigger`
        runs right before the action — chaos tests use it to flip
        auxiliary state (e.g. stop a fake server's heartbeat)
        atomically with the injected failure."""
        with self._lock:
            self._arms.setdefault(point, []).append(
                _Arm(action, at_hit, times, delay_s, scope, on_trigger)
            )

    def reset(self):
        with self._lock:
            self._arms.clear()
            self._hits.clear()
            self._env_loaded = False

    def _ensure_env_loaded(self):
        with self._lock:
            if self._env_loaded:
                return
            self._env_loaded = True
        self.load_env()

    def load_env(self, spec: Optional[str] = None):
        """Parse AREAL_FAULTS (or an explicit spec) into arms. Called
        lazily on the first maybe_fail so spawned workers pick the spec
        up without any bootstrap wiring."""
        if spec is None:
            spec = env_registry.get_str("AREAL_FAULTS")
        with self._lock:
            self._env_loaded = True
        for entry in filter(None, (e.strip() for e in spec.split(";"))):
            try:
                target, _, rhs = entry.partition("=")
                point, _, scope = target.partition("@")
                parts = rhs.split(":")
                action = parts[0]
                kwargs: Dict[str, float] = {}
                for p in parts[1:]:
                    key, _, val = p.partition("=")
                    if key == "k":
                        kwargs["at_hit"] = int(val)
                    elif key == "n":
                        kwargs["times"] = int(val)
                    elif key == "delay":
                        kwargs["delay_s"] = float(val)
                    else:
                        raise ValueError(f"unknown fault option {key!r}")
                self.arm(point.strip(), action=action,
                         scope=scope.strip() or None if scope else None,
                         **kwargs)
            except Exception:
                logger.error(f"bad AREAL_FAULTS entry {entry!r}; ignored",
                             exc_info=True)

    # -- registry-verified dynamic API ----------------------------------
    # The chaos-registry lint checker verifies LITERAL point names
    # statically; sweeps that iterate the registry (the all-points
    # chaos campaign, the manager's HTTP faults_hits query) can't name
    # points literally. These variants are the runtime equivalent of
    # the static check: an undeclared point raises instead of arming a
    # silent no-op, so the "renamed point keeps the test green" failure
    # mode the checker exists for stays impossible.

    @staticmethod
    def check_declared(point: str):
        from areal_tpu_torch.base import fault_points

        if point.startswith(fault_points.TEST_PREFIX):
            return
        if point not in fault_points.REGISTRY:
            raise ValueError(
                f"undeclared chaos point {point!r}: declare it in "
                f"areal_tpu_torch.base.fault_points (or use the reserved "
                f"{fault_points.TEST_PREFIX!r} namespace)"
            )

    def hits_declared(self, point: str) -> int:
        self.check_declared(point)
        return self.hits(point)

    # -- introspection --------------------------------------------------

    def hits(self, point: str) -> int:
        with self._lock:
            return self._hits.get(point, 0)

    def armed_points(self) -> List[str]:
        with self._lock:
            return sorted(self._arms)

    # -- injection points -----------------------------------------------

    def _step(self, point: str) -> Optional[_Arm]:
        """Count a hit; return the arm to fire, if any."""
        self._ensure_env_loaded()
        with self._lock:
            hit = self._hits.get(point, 0) + 1
            self._hits[point] = hit
            for arm in self._arms.get(point, ()):
                if arm.should_fire(hit, self._scope):
                    arm.fired += 1
                    return arm
        return None

    def _fire(self, arm: _Arm, point: str) -> float:
        """Run the non-blocking part of the action; returns seconds the
        caller must sleep (sync and async paths sleep differently)."""
        logger.warning(
            f"fault injection: firing {arm.action!r} at {point!r} "
            f"(hit {self._hits.get(point)})"
        )
        if arm.on_trigger is not None:
            arm.on_trigger()
        if arm.action == "die":
            # Mimic a hard kill: no cleanup, no exit hooks, nonzero code.
            os._exit(1)
        if arm.action in ("raise", "flaky"):
            raise FaultInjected(f"injected fault at {point!r}")
        if arm.action == "delay":
            return arm.delay_s
        if arm.action == "corrupt":
            # Only byte-serving maybe_corrupt sites can corrupt; at a
            # plain maybe_fail point the arm is inert by design (the
            # chaos campaign sweeps every (point, action) pair).
            return 0.0
        return _HANG_SECONDS  # hang

    def maybe_fail(self, point: str):
        """Synchronous injection point. A no-op unless armed."""
        arm = self._step(point)
        if arm is not None:
            time.sleep(self._fire(arm, point))

    async def maybe_fail_async(self, point: str):
        """Async injection point: delay/hang sleep on the event loop so
        the faulted coroutine stalls without blocking its peers."""
        arm = self._step(point)
        if arm is not None:
            import asyncio

            await asyncio.sleep(self._fire(arm, point))


    def maybe_corrupt(self, point: str, data: bytes) -> bytes:
        """Byte-serving injection point: a pass-through unless armed. A
        ``corrupt`` arm flips bytes after every hash was stamped (the
        receiver's sha256 verify must reject and re-fetch); any other
        action fires as at ``maybe_fail``."""
        arm = self._step(point)
        if arm is None:
            return data
        if arm.action == "corrupt":
            logger.warning(
                f"fault injection: corrupting {len(data)} bytes at "
                f"{point!r} (hit {self._hits.get(point)})"
            )
            if arm.on_trigger is not None:
                arm.on_trigger()
            return corrupt_bytes(data)
        time.sleep(self._fire(arm, point))
        return data


def corrupt_bytes(data: bytes) -> bytes:
    """Deterministically flip bytes (first, middle, last) so a
    content-hash verifier must reject the payload; empty payloads pass
    through."""
    if not data:
        return data
    b = bytearray(data)
    for i in {0, len(b) // 2, len(b) - 1}:
        b[i] ^= 0xFF
    return bytes(b)

# Process-global injector: production code imports this singleton so
# tests arm points without plumbing an injector through constructors.
faults = FaultInjector()
