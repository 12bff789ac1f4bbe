"""Worker lifecycle: configure -> poll loop -> exit (the port's copy of
``areal_tpu/system/worker_base.py``).

A worker is a process-long poll loop that beats its heartbeat
(``base/health.py``) every lap. The reference's ZMQ command socket
(``WorkerServer``, ``WorkerControl``) and ``AsyncWorker`` are not ported:
a generation server runs without a control socket.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional

from areal_tpu_torch.base import health, logging, tracing
from areal_tpu_torch.base.fault_injection import faults

logger = logging.getLogger("worker")


@dataclasses.dataclass
class PollResult:
    sample_count: int = 0
    batch_count: int = 0


class Worker:
    """Synchronous worker: subclass `_configure` and `_poll`."""

    def __init__(self):
        self._configured = False
        self._exiting = False
        self.config: Any = None
        self.experiment_name = ""
        self.trial_name = ""
        self.worker_name = ""

    # -- subclass API ---------------------------------------------------
    def _configure(self, config) -> None:
        raise NotImplementedError()

    def _poll(self) -> PollResult:
        raise NotImplementedError()

    def _exit_hook(self):
        pass

    # -- lifecycle ------------------------------------------------------
    def configure(self, config, experiment_name: str = "", trial_name: str = "",
                  worker_name: str = ""):
        self.config = config
        self.experiment_name = experiment_name or getattr(config, "experiment_name", "")
        self.trial_name = trial_name or getattr(config, "trial_name", "")
        self.worker_name = worker_name or getattr(config, "worker_name", "")
        if self.worker_name:
            # Scope env-armed chaos faults (AREAL_FAULTS "@worker" specs)
            # to this worker before any injection point can be hit.
            faults.set_scope(self.worker_name)
            # Label this process's RL-trace shard and scope the default
            # shard dir per experiment/trial (no-op unless
            # AREAL_RL_TRACE=1).
            tracing.configure_worker(
                self.worker_name, self.experiment_name, self.trial_name
            )
        self._configure(config)
        self._configured = True
        if self.experiment_name and self.trial_name and self.worker_name:
            # Fault-domain lease: beaten from the poll loop, so a hung
            # worker (not just a dead one) goes stale and the watchdog /
            # gserver manager can isolate it.
            try:
                self._heartbeat = health.Heartbeat(
                    self.experiment_name,
                    self.trial_name,
                    self.worker_name,
                    payload=self._heartbeat_payload(),
                    ttl=self._heartbeat_ttl(),
                )
            except Exception:
                logger.warning("heartbeat registration failed", exc_info=True)

    def _heartbeat_payload(self) -> Dict[str, Any]:
        """Extra fields for this worker's health record (subclasses add
        e.g. their HTTP address so consumers can map member -> endpoint)."""
        return {"pid": os.getpid()}

    def _heartbeat_ttl(self) -> Optional[float]:
        """Per-role TTL override (None = default_ttl / AREAL_HEALTH_TTL).
        Roles whose poll loop can legitimately block for long stretches
        return a TTL covering that stretch, so the supervisor's stale-
        heartbeat hang detection doesn't fire on healthy blocking."""
        return None

    def _beat(self):
        hb = getattr(self, "_heartbeat", None)
        if hb is not None:
            hb.beat()

    def _stop_heartbeat(self):
        hb = getattr(self, "_heartbeat", None)
        if hb is not None:
            hb.stop()

    def run(self):
        """Poll until completion or `exit()`."""
        assert self._configured, "configure() before run()"
        logger.info("worker %s starts running", self.worker_name)
        try:
            while not self._exiting:
                self._beat()
                faults.maybe_fail("worker.poll")
                r = self._poll()
                if r is None:
                    # Subclass signalled completion.
                    break
                if r.batch_count == 0:
                    time.sleep(0.002)
        finally:
            self._stop_heartbeat()
            self._exit_hook()
            tracing.flush()

    def exit(self):
        self._exiting = True
