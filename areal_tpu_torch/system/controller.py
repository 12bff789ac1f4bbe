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
workers, generation servers, the gserver manager, rollout workers. The
reference restarts a dead serving-plane worker (server, manager, rollout
worker) in place and detects hung ones by their heartbeats; the port
does neither, so any dead or raising worker ends the run. The
multi-host ``ClusterController`` is not ported.

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

import multiprocessing as mp
import os
import signal
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from areal_tpu_torch.api.system_api import ExperimentConfig
from areal_tpu_torch.base import logging, name_resolve

logger = logging.getLogger("controller")

# How long the workers get to leave after the master completes: the
# generation servers outlive the trial's COMPLETE for up to 120 s
# (generation_server.LAST_FANOUT_WAIT_S) while the manager fans the last
# version out, which over the weight plane is a whole transfer.
EXIT_WAIT_S = 150.0
# How long the workers of a failed run get to leave after SIGTERM (the
# model worker's exit hook waits up to 60 s for checkpoint writes).
FAILED_EXIT_WAIT_S = 90.0

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


class LocalController:
    """Run one trial on this host: subprocess workers + inline master."""

    def __init__(
        self,
        exp_cfg: ExperimentConfig,
        name_resolve_cfg: Optional[Dict] = None,
        worker_env: Optional[Dict[str, str]] = None,
    ):
        self.exp_cfg = exp_cfg
        self.name_resolve_cfg = name_resolve_cfg or {"backend": "nfs"}
        self.worker_env = worker_env or {}
        self._procs: List[mp.Process] = []
        # Guarded by _err_lock: appended by the supervisor thread while
        # the main thread drains/raises in run()'s teardown.
        self._pending_errors: List[str] = []
        self._err_lock = threading.Lock()
        self._ctx = mp.get_context("spawn")
        self._errors = self._ctx.Queue()

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
        self._procs.append(p)
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

    def check_worker_errors(self):
        self._drain_errors()
        with self._err_lock:
            if self._pending_errors:
                raise RuntimeError(
                    f"worker failed:\n{self._pending_errors[0]}"
                )

    # ------------------------------------------------------------------
    # Supervision: a dead or raising worker, or the run's deadline,
    # interrupts the master
    # ------------------------------------------------------------------

    def _escalate(self, why: str):
        import _thread

        logger.error(f"{why}; interrupting master")
        self._watchdog_fired = True
        _thread.interrupt_main()

    def supervise_once(self) -> bool:
        """One supervision pass. Returns False once a failure escalated
        (supervision should stop); True to keep supervising."""
        self._drain_errors()
        for p in self._procs:
            if not p.is_alive() and p.exitcode not in (0, None):
                self._escalate(f"worker pid={p.pid} died (exit code {p.exitcode})")
                return False
        with self._err_lock:
            failed = self._pending_errors[:1]
        if failed:
            self._escalate(f"worker failure: {failed[0].split(': ', 1)[0]}")
            return False
        return True

    def _watchdog(self, stop_event, deadline: Optional[float] = None):
        """Supervise workers while the inline master runs: interrupt the
        master on a worker failure and at the run's deadline."""
        while not stop_event.wait(0.5):
            if deadline is not None and time.monotonic() > deadline:
                self._deadline_fired = True
                self._escalate("run deadline passed")
                return
            try:
                keep_going = self.supervise_once()
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
                "perf_summary": dict(master.perf_summary)}

    def stop_workers(self, timeout: float = FAILED_EXIT_WAIT_S):
        """Ask every live worker to leave (SIGTERM), then join them."""
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
        self._procs.clear()
