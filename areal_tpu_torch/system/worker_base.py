"""Worker lifecycle: configure -> poll loop -> exit, with a control server
(the port's copy of ``areal_tpu/system/worker_base.py``).

A worker is a process-long poll loop that beats its heartbeat
(``base/health.py``) every lap. A controller may reach it through a small
ZMQ REP command socket registered in name_resolve (``WorkerServer``; the
commands are JSON, the reference's, so the reference's ``WorkerControl``
commands a port worker), and the worker mirrors its status there.
``LocalController`` runs workers without one, as the reference's does.
The client side (``WorkerControl``) is not ported: no worker or
controller of either package constructs one. ``AsyncWorker`` polls a
coroutine on one event loop (the rollout worker).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import queue
import threading
import time
from typing import Any, Dict, Optional

import zmq

from areal_tpu_torch.base import health, logging, name_resolve, names, network, tracing
from areal_tpu_torch.base.fault_injection import faults

logger = logging.getLogger("worker")


class WorkerServerStatus(str, enum.Enum):
    READY = "READY"
    RUNNING = "RUNNING"
    PAUSED = "PAUSED"
    COMPLETED = "COMPLETED"
    ERROR = "ERROR"
    EXITING = "EXITING"


@dataclasses.dataclass
class PollResult:
    sample_count: int = 0
    batch_count: int = 0


class WorkerServer:
    """ZMQ REP command socket + status mirror in name_resolve.

    Commands (JSON): {"cmd": "configure"|"start"|"pause"|"exit"|"status",
    "args": {...}}. Replies: {"ok": bool, "result": ...}.
    """

    def __init__(self, experiment_name: str, trial_name: str, worker_name: str):
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.worker_name = worker_name
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.REP)
        self._sock.setsockopt(zmq.LINGER, 0)
        host_ip = network.gethostip()
        port = self._sock.bind_to_random_port(f"tcp://{host_ip}")
        self.address = f"{host_ip}:{port}"
        name_resolve.add(
            names.worker(experiment_name, trial_name, worker_name),
            self.address,
            keepalive_ttl=120,
            replace=True,
        )
        self.set_status(WorkerServerStatus.READY)
        self._commands: "queue.Queue[Dict]" = queue.Queue()
        self._replies: "queue.Queue[Dict]" = queue.Queue()
        self._cmd_seq = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def set_status(self, status: WorkerServerStatus):
        name_resolve.add(
            names.worker_status(self.experiment_name, self.trial_name, self.worker_name),
            status.value,
            keepalive_ttl=240,
            replace=True,
        )

    def _serve(self):
        while not self._stop.is_set():
            if not self._sock.poll(100):
                continue
            try:
                msg = json.loads(self._sock.recv_string())
            except Exception as e:  # malformed command
                self._sock.send_string(json.dumps({"ok": False, "result": str(e)}))
                continue
            self._cmd_seq += 1
            msg["_seq"] = self._cmd_seq
            self._commands.put(msg)
            # Replies are tagged with the command's sequence number so a
            # late reply to a timed-out command can't be mistaken for the
            # answer to the next one.
            reply = None
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline and not self._stop.is_set():
                try:
                    r = self._replies.get(timeout=1)
                except queue.Empty:
                    continue
                if r.get("_seq") == self._cmd_seq:
                    reply = r
                    break
                # stale reply from an earlier timed-out command: discard
            if reply is None:
                reply = {"ok": False, "result": "worker did not handle command"}
            reply.pop("_seq", None)
            self._sock.send_string(json.dumps(reply))

    def try_receive_command(self) -> Optional[Dict]:
        try:
            cmd = self._commands.get_nowait()
        except queue.Empty:
            return None
        self._pending_seq = cmd.get("_seq")
        return cmd

    def post_reply(self, ok: bool, result: Any = None):
        self._replies.put(
            {"ok": ok, "result": result, "_seq": getattr(self, "_pending_seq", None)}
        )

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
        self._sock.close()


def worker_status(experiment_name: str, trial_name: str, worker_name: str) -> Optional[WorkerServerStatus]:
    try:
        v = name_resolve.get(names.worker_status(experiment_name, trial_name, worker_name))
        return WorkerServerStatus(v)
    except name_resolve.NameEntryNotFoundError:
        return None


class Worker:
    """Synchronous worker: subclass `_configure` and `_poll`."""

    def __init__(self, server: Optional[WorkerServer] = None):
        self._server = server
        self._configured = False
        self._running = False
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
        self._running = True
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
        if self._server:
            self._server.set_status(WorkerServerStatus.RUNNING)

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

    def _handle_commands(self):
        if not self._server:
            return
        msg = self._server.try_receive_command()
        if msg is None:
            return
        cmd = msg.get("cmd")
        try:
            if cmd == "pause":
                self._running = False
                self._server.set_status(WorkerServerStatus.PAUSED)
                self._server.post_reply(True)
            elif cmd == "start":
                self._running = True
                self._server.set_status(WorkerServerStatus.RUNNING)
                self._server.post_reply(True)
            elif cmd == "exit":
                self._exiting = True
                self._server.post_reply(True)
            elif cmd == "status":
                self._server.post_reply(True, "RUNNING" if self._running else "PAUSED")
            else:
                self._server.post_reply(False, f"unknown command {cmd!r}")
        except Exception as e:
            self._server.post_reply(False, str(e))

    def run(self):
        """Poll until completion or exit command."""
        assert self._configured, "configure() before run()"
        logger.info("worker %s starts running", self.worker_name)
        try:
            while not self._exiting:
                self._handle_commands()
                self._beat()
                faults.maybe_fail("worker.poll")
                if not self._running:
                    time.sleep(0.05)
                    continue
                r = self._poll()
                if r is None:
                    # Subclass signalled completion.
                    break
                if r.batch_count == 0:
                    time.sleep(0.002)
            if self._server:
                self._server.set_status(WorkerServerStatus.COMPLETED)
        except Exception:
            if self._server:
                self._server.set_status(WorkerServerStatus.ERROR)
            raise
        finally:
            self._stop_heartbeat()
            self._exit_hook()
            tracing.flush()

    def exit(self):
        self._exiting = True


class AsyncWorker(Worker):
    """Worker whose poll is an async coroutine (`_poll_async`)."""

    async def _poll_async(self) -> PollResult:
        raise NotImplementedError()

    def run(self):
        import asyncio

        assert self._configured, "configure() before run()"

        async def _loop():
            while not self._exiting:
                self._handle_commands()
                self._beat()
                await faults.maybe_fail_async("worker.poll")
                if not self._running:
                    await asyncio.sleep(0.05)
                    continue
                r = await self._poll_async()
                if r is None:
                    break
                if r.batch_count == 0:
                    await asyncio.sleep(0.002)

        try:
            asyncio.run(_loop())
            if self._server:
                self._server.set_status(WorkerServerStatus.COMPLETED)
        except Exception:
            if self._server:
                self._server.set_status(WorkerServerStatus.ERROR)
            raise
        finally:
            self._stop_heartbeat()
            self._exit_hook()
            tracing.flush()
