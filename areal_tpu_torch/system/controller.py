"""Experiment controller: spawn workers, run the master, reap results
(the port's copy of ``LocalController`` from
``areal_tpu/system/controller.py``).

Every worker is a separate OS process, started with multiprocessing's
``spawn`` (a fork of a process that holds a CUDA context would break
the child's), the master runs inline in the controller process, and
worker health is watched while the master drives the experiment.
``run(timeout)`` bounds the whole run: past the deadline the master is
interrupted, ``run`` raises ``TimeoutError`` and the workers are torn
down. A worker that dies or raises interrupts the master and ``run``
raises ``RuntimeError``. Workers start in the reference's order: model
workers, generation servers, the gserver manager, rollout workers.

A serving-plane worker (generation server, rollout worker, gserver
manager: ``RESTARTABLE_ROLES``) that dies, raises or hangs is restarted
in place, up to ``max_worker_restarts`` times each; it re-registers,
re-syncs its weights and re-enters rotation. A hang is a process that is
alive but whose heartbeat went stale after this incarnation was last
seen beating (a beat counts only if it carries this incarnation's
``pid``; a worker that never beat or was just restarted gets startup
grace); a hung process is killed and joined before its successor
spawns, so a server's device memory is free again. A graceful
``stopped`` record is a departure, not a death. A trainer-plane role
(model worker), or a role whose budget is spent, ends the run, which
``training/utils.run_experiment`` may relaunch. The multi-host
``ClusterController`` is not ported.

A run that fails (the master raised, a worker died, the deadline) asks
every live worker to leave with SIGTERM, which a port worker takes as
its ``exit()``: its poll loop ends and its exit hook runs (the model
worker's drains its pending checkpoint writes). Workers still alive
after ``FAILED_EXIT_WAIT_S`` are killed. So a relaunch in the same
process (``training/utils.run_experiment``) starts after the last
attempt's workers are gone. The reference waits 30 s for workers that
nothing told to leave, then terminates them.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import signal
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Set

from areal_tpu_torch.api.system_api import ExperimentConfig
from areal_tpu_torch.base import health, logging, name_resolve

logger = logging.getLogger("controller")

# How long the workers get to leave after the master completes: the
# generation servers outlive the trial's COMPLETE for up to 120 s
# (generation_server.LAST_FANOUT_WAIT_S) while the manager fans the last
# version out, which over the weight plane is a whole transfer.
EXIT_WAIT_S = 150.0
# How long the workers of a failed run get to leave after SIGTERM (the
# model worker's exit hook waits up to 60 s for checkpoint writes).
FAILED_EXIT_WAIT_S = 90.0

# Worker roles restarted in place on death or hang. The trainer plane
# (model workers, master) holds in-flight step state that the
# request/reply stream cannot rebuild mid-step, so it escalates to the
# whole-experiment relaunch; the serving plane re-registers, re-syncs
# its weights and re-enters rotation.
RESTARTABLE_ROLES = frozenset({"generation_server", "rollout_worker", "gserver_manager"})


def _run_worker_proc(
    worker_type: str,
    config: Any,
    name_resolve_cfg: Dict,
    env: Dict[str, str],
    error_queue,
):
    """Subprocess entry: reconfigure name_resolve, build + run the worker."""
    worker_name = getattr(config, "worker_name", worker_type)
    try:
        os.environ.update(env)
        name_resolve.reconfigure(**name_resolve_cfg)
        from areal_tpu_torch.system import load_worker

        cls = load_worker(worker_type)
        w = cls()
        # SIGTERM from the controller (a failed run) is a request to leave.
        signal.signal(signal.SIGTERM, lambda *_: w.exit())
        w.configure(
            config,
            experiment_name=config.experiment_name,
            trial_name=config.trial_name,
            worker_name=worker_name,
        )
        w.run()
    except Exception:
        error_queue.put(f"{worker_name}: " + traceback.format_exc())
        raise


@dataclasses.dataclass
class _WorkerRecord:
    worker_type: str
    config: Any
    proc: mp.Process
    restarts: int = 0
    last_restart: float = 0.0
    last_seen_alive: float = 0.0  # last fresh heartbeat (0 = never beat)


class LocalController:
    """Run one trial on this host: subprocess workers + inline master."""

    def __init__(
        self,
        exp_cfg: ExperimentConfig,
        name_resolve_cfg: Optional[Dict] = None,
        worker_env: Optional[Dict[str, str]] = None,
        max_worker_restarts: int = 2,
        restartable_roles: Optional[Set[str]] = None,
    ):
        self.exp_cfg = exp_cfg
        self.name_resolve_cfg = name_resolve_cfg or {"backend": "nfs"}
        self.worker_env = worker_env or {}
        # How many times one worker may be restarted in place before its
        # failure escalates to the whole-experiment relaunch.
        self.max_worker_restarts = max_worker_restarts
        self.restartable_roles = (RESTARTABLE_ROLES if restartable_roles is None
                                  else frozenset(restartable_roles))
        self._workers: Dict[str, _WorkerRecord] = {}
        # Every in-place restart of this run: worker, why, attempt.
        self.restart_log: List[Dict[str, Any]] = []
        # Guarded by _err_lock: appended by the supervisor thread while
        # the main thread drains/raises in run()'s teardown.
        self._pending_errors: List[str] = []
        self._err_lock = threading.Lock()
        self._ctx = mp.get_context("spawn")
        self._errors = self._ctx.Queue()

    @property
    def _procs(self) -> List[mp.Process]:
        return [r.proc for r in self._workers.values()]

    def _spawn(self, worker_type: str, config) -> mp.Process:
        # Spawned children must be able to import areal_tpu_torch before
        # the target function runs (unpickling imports this module), so
        # the repo root has to be on PYTHONPATH at process start.
        import areal_tpu_torch

        repo_root = os.path.dirname(
            os.path.dirname(os.path.abspath(areal_tpu_torch.__file__)))
        existing = os.environ.get("PYTHONPATH", "")
        if repo_root not in existing.split(os.pathsep):
            os.environ["PYTHONPATH"] = (
                repo_root + (os.pathsep + existing if existing else "")
            )
        p = self._ctx.Process(
            target=_run_worker_proc,
            args=(
                worker_type,
                config,
                self.name_resolve_cfg,
                self.worker_env,
                self._errors,
            ),
            daemon=True,
        )
        p.start()
        name = getattr(config, "worker_name", worker_type)
        rec = self._workers.get(name)
        if rec is None:
            self._workers[name] = _WorkerRecord(worker_type, config, p)
        else:  # a restart keeps the record's history
            rec.proc = p
        return p

    def start_workers(self):
        for cfg in self.exp_cfg.model_workers:
            self._spawn("model_worker", cfg)
        for cfg in self.exp_cfg.generation_servers:
            self._spawn("generation_server", cfg)
        if self.exp_cfg.gserver_manager is not None:
            self._spawn("gserver_manager", self.exp_cfg.gserver_manager)
        for cfg in self.exp_cfg.rollout_workers:
            self._spawn("rollout_worker", cfg)

    def _drain_errors(self):
        while True:
            try:
                err = self._errors.get_nowait()
            except Exception:
                return
            with self._err_lock:
                self._pending_errors.append(err)

    def _discard_errors_for(self, worker_name: str) -> int:
        """Drop the queued tracebacks of a worker that is being restarted:
        a handled failure must not fail the run later."""
        with self._err_lock:
            kept, dropped = [], []
            for err in self._pending_errors:
                (dropped if err.startswith(f"{worker_name}: ") else kept).append(err)
            self._pending_errors = kept
        for err in dropped:
            logger.warning(f"restarting {worker_name}; absorbed its failure:\n{err}")
        return len(dropped)

    def check_worker_errors(self):
        self._drain_errors()
        with self._err_lock:
            if self._pending_errors:
                raise RuntimeError(
                    f"worker failed:\n{self._pending_errors[0]}"
                )

    # ------------------------------------------------------------------
    # Supervision: per-worker restart, heartbeat hang detection,
    # escalation to the whole-experiment relaunch, the run's deadline
    # ------------------------------------------------------------------

    def _escalate(self, why: str):
        import _thread

        logger.error(f"{why}; interrupting master")
        self._watchdog_fired = True
        _thread.interrupt_main()

    def _restart_worker(self, name: str, rec: _WorkerRecord, why: str) -> bool:
        """Restart one worker in place. False when the failure must
        escalate instead (role not restartable, budget spent)."""
        if (rec.worker_type not in self.restartable_roles
                or rec.restarts >= self.max_worker_restarts):
            return False
        if rec.proc.is_alive():
            # Hung, not dead: kill the wedged process (and so free its
            # device memory) before its successor allocates.
            rec.proc.kill()
            rec.proc.join(timeout=10)
        rec.restarts += 1
        rec.last_restart = time.monotonic()
        self._discard_errors_for(name)
        self.restart_log.append({"worker": name, "why": why, "attempt": rec.restarts,
                                 "old_pid": rec.proc.pid, "t_ns": time.monotonic_ns()})
        logger.warning(f"restarting {name} ({why}; attempt {rec.restarts}/"
                       f"{self.max_worker_restarts})")
        self._spawn(rec.worker_type, rec.config)
        return True

    def supervise_once(self, registry: Optional[health.HealthRegistry] = None) -> bool:
        """One supervision pass. Returns False once a failure escalated
        (supervision should stop); True to keep supervising."""
        self._drain_errors()
        alive_members, stopped = registry.classified() if registry is not None else ({}, {})
        now = time.monotonic()
        for name, rec in list(self._workers.items()):
            # Only THIS incarnation's beats count: a dead worker's record
            # stays fresh for up to STALE_FACTOR * TTL, and crediting it to
            # the successor would end its startup grace before its first
            # beat (and kill it as hung mid model load).
            if name in alive_members and alive_members[name].get("pid") == rec.proc.pid:
                rec.last_seen_alive = now
            dead = (not rec.proc.is_alive()) and rec.proc.exitcode not in (0, None)
            # Hung: up, but its poll loop stopped beating after this
            # incarnation was last seen alive, and it did not stop
            # gracefully. Judged only for restartable roles: a trainer
            # poll loop may block for minutes in a step.
            hung = (rec.worker_type in self.restartable_roles
                    and rec.proc.is_alive()
                    and rec.last_seen_alive > rec.last_restart
                    and name not in alive_members
                    and name not in stopped)
            if not dead and not hung:
                continue
            why = "process died" if dead else "heartbeat went stale"
            if not self._restart_worker(name, rec, why):
                self._escalate(f"{name} failed ({why})")
                return False
        # Queued tracebacks. One whose process is still alive is a death
        # in flight (a later pass sees the exit) or a leftover of an
        # incarnation already replaced.
        with self._err_lock:
            pending = list(self._pending_errors)
        for err in pending:
            name = err.split(": ", 1)[0]
            rec = self._workers.get(name)
            if rec is not None and rec.proc.is_alive():
                if rec.restarts > 0:
                    self._discard_errors_for(name)
                continue
            if rec is not None and self._restart_worker(name, rec, "raised"):
                continue
            self._escalate(f"worker failure: {name}")
            return False
        return True

    def _watchdog(self, stop_event, deadline: Optional[float] = None):
        """Supervise workers while the inline master runs: restart failed
        serving-plane workers in place; interrupt the master on anything
        else, and at the run's deadline."""
        registry = health.HealthRegistry(self.exp_cfg.experiment_name,
                                         self.exp_cfg.trial_name)
        while not stop_event.wait(0.5):
            if deadline is not None and time.monotonic() > deadline:
                self._deadline_fired = True
                self._escalate("run deadline passed")
                return
            try:
                keep_going = self.supervise_once(registry)
            except Exception:
                logger.warning("supervision pass failed", exc_info=True)
                continue
            if not keep_going:
                return

    def run(self, timeout: Optional[float] = None) -> Dict:
        """Blocking: start workers, run master inline, join everything.
        With `timeout` (seconds), a run past it raises TimeoutError. Call
        it from the main thread: failures and the deadline reach the
        master as an interrupt of the main thread."""
        name_resolve.reconfigure(**self.name_resolve_cfg)
        self._watchdog_fired = False
        self._deadline_fired = False
        deadline = None if timeout is None else time.monotonic() + timeout
        user_interrupt = False
        stop_watchdog = threading.Event()
        watchdog = threading.Thread(
            target=self._watchdog, args=(stop_watchdog, deadline), daemon=True
        )
        self.start_workers()
        watchdog.start()

        from areal_tpu_torch.system.master_worker import MasterWorker

        master = MasterWorker()
        failed = True
        try:
            master.configure(
                self.exp_cfg.master,
                experiment_name=self.exp_cfg.experiment_name,
                trial_name=self.exp_cfg.trial_name,
                worker_name="master",
            )
            master.run()
            failed = False
        except KeyboardInterrupt:
            # Distinguish the two interrupt sources by WHO fired: only
            # the watchdog's interrupt means a worker died (traceback or
            # not) and must become RuntimeError for relaunch-recovery. A
            # genuine Ctrl-C propagates as-is — the terminal delivers
            # SIGINT to the whole process group, so workers also die
            # nonzero, and exit codes alone can't tell the cases apart.
            if self._deadline_fired:
                raise TimeoutError(f"experiment did not finish within {timeout} s")
            if self._watchdog_fired:
                self.check_worker_errors()
                dead = [
                    p.pid for p in self._procs
                    if (not p.is_alive()) and p.exitcode not in (0, None)
                ]
                raise RuntimeError(
                    f"worker process(es) died without a traceback "
                    f"(killed/native crash): pids={dead}"
                )
            user_interrupt = True
            raise
        finally:
            stop_watchdog.set()
            try:
                if not user_interrupt and not self._deadline_fired:
                    # Surface worker failures the watchdog hadn't polled yet
                    # (died in its 0.5s window as the master finished). Only
                    # a genuine Ctrl-C suppresses this — teardown noise from
                    # interrupted workers must not override the user's stop.
                    self.check_worker_errors()
            except BaseException:
                failed = True
                raise
            finally:
                if failed:
                    self.stop_workers(timeout=FAILED_EXIT_WAIT_S)
                else:
                    self.join(timeout=EXIT_WAIT_S)
        return {"global_step": master.step_info.global_step,
                "perf_summary": dict(master.perf_summary),
                "worker_restarts": list(self.restart_log)}

    def stop_workers(self, timeout: float = FAILED_EXIT_WAIT_S):
        """Ask the current incarnation of every worker to leave (SIGTERM),
        then join them."""
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        self.join(timeout=timeout)

    def join(self, timeout: float = 30):
        deadline = time.monotonic() + timeout
        for p in self._procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
        for p in self._procs:
            if p.is_alive():
                logger.warning(f"terminating straggler worker pid={p.pid}")
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self._workers.clear()
