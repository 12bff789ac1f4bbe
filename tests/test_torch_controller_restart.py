"""The port's controller restarts a failed serving-plane worker in place.

The two cases of the reference's ``tests/system/test_controller_restart.py``
run against ``areal_tpu_torch.system.controller.LocalController`` with a
port sleeper worker (heartbeat only, spawned through the real subprocess
and supervision machinery):

- a SIGKILLed worker is restarted once without touching its sibling, and
  its next death, past the budget, escalates;
- a worker whose poll loop hangs (an armed ``worker.poll`` fault) stops
  beating and is killed and restarted off its stale heartbeat.

And two of the port's own:

- a role outside the restartable set (the trainer plane) escalates at
  its first death, with no restart;
- a graceful ``stopped`` record (a worker that stopped its heartbeat and
  lives on, or one that exited 0) is a departure: never restarted, never
  escalated.

Timing: the sleepers beat with ``AREAL_HEALTH_TTL=0.3`` (stale after
0.9 s); every wait is bounded by ``_wait_until``.
"""

import dataclasses
import os
import signal
import time
import uuid

import pytest

from areal_tpu_torch.api.system_api import ExperimentConfig
from areal_tpu_torch.base import name_resolve
from areal_tpu_torch.base.health import HealthRegistry
from areal_tpu_torch.system import controller as port_controller
from areal_tpu_torch.system.controller import LocalController
from areal_tpu_torch.system.worker_base import PollResult, Worker

SLEEPER = "tests.test_torch_controller_restart:PortSleeperWorker"


@dataclasses.dataclass
class PortSleeperConfig:
    experiment_name: str = ""
    trial_name: str = ""
    worker_index: int = 0
    stop_heartbeat_after: int = 0  # polls; 0 = never
    exit_after: int = 0  # polls; 0 = never

    @property
    def worker_name(self) -> str:
        return f"sleeper/{self.worker_index}"


class PortSleeperWorker(Worker):
    """Polls forever; observable only through its heartbeat (and the
    ``worker.poll`` fault point of the port's Worker base)."""

    def _configure(self, config: PortSleeperConfig):
        self.cfg = config
        self.polls = 0

    def _poll(self):
        self.polls += 1
        if self.cfg.exit_after and self.polls >= self.cfg.exit_after:
            return None
        if self.cfg.stop_heartbeat_after and self.polls == self.cfg.stop_heartbeat_after:
            self._stop_heartbeat()  # a graceful departure that lingers
        time.sleep(0.02)
        return PollResult(batch_count=0)


def _wait_until(cond, timeout=30.0, interval=0.1, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture
def nr_restore():
    saved = name_resolve._default.repo
    yield
    name_resolve._default.repo = saved


def _controller(tmp_path, exp, trial, extra_env=None, max_restarts=1, roles=(SLEEPER,)):
    cfg = ExperimentConfig(experiment_name=exp, trial_name=trial, master=None)
    env = {"AREAL_HEALTH_TTL": "0.3"}
    env.update(extra_env or {})
    ctl = LocalController(cfg, name_resolve_cfg={"backend": "nfs",
                                                 "record_root": str(tmp_path / "nr")},
                          worker_env=env, max_worker_restarts=max_restarts,
                          restartable_roles=None if roles is None else set(roles))
    name_resolve.reconfigure(**ctl.name_resolve_cfg)
    escalations = []
    ctl._escalate = lambda why: escalations.append(why)
    return ctl, escalations


def _teardown(ctl):
    # The sleepers never leave by themselves (and a hung one ignores
    # SIGTERM): kill them, then reap.
    for p in ctl._procs:
        if p.is_alive():
            p.kill()
    ctl.join(timeout=10)


def _supervise_until(ctl, registry, cond, msg):
    def step():
        ctl.supervise_once(registry)
        return cond()
    _wait_until(step, msg=msg)


def test_watchdog_restarts_single_killed_worker(tmp_path, nr_restore):
    exp, trial = f"restart-{uuid.uuid4().hex[:6]}", "t0"
    ctl, escalations = _controller(tmp_path, exp, trial, max_restarts=1)
    try:
        ctl._spawn(SLEEPER, PortSleeperConfig(exp, trial, 0))
        ctl._spawn(SLEEPER, PortSleeperConfig(exp, trial, 1))
        registry = HealthRegistry(exp, trial)
        _wait_until(lambda: {"sleeper/0", "sleeper/1"} <= set(registry.snapshot()),
                    msg="both workers heartbeating")
        pid0 = ctl._workers["sleeper/0"].proc.pid
        pid1 = ctl._workers["sleeper/1"].proc.pid
        os.kill(pid0, signal.SIGKILL)
        _supervise_until(ctl, registry, lambda: ctl._workers["sleeper/0"].restarts == 1,
                         "restart of sleeper/0")
        rec0, rec1 = ctl._workers["sleeper/0"], ctl._workers["sleeper/1"]
        assert rec0.proc.pid != pid0 and rec0.proc.is_alive()
        assert rec1.proc.pid == pid1 and rec1.proc.is_alive()  # sibling untouched
        assert escalations == []
        _wait_until(lambda: registry.snapshot().get("sleeper/0", {}).get("pid") == rec0.proc.pid,
                    msg="restarted worker heartbeating")
        # Budget spent: the next death escalates instead.
        os.kill(rec0.proc.pid, signal.SIGKILL)
        _supervise_until(ctl, registry, lambda: bool(escalations), "escalation")
        assert "sleeper/0" in escalations[0] and "process died" in escalations[0]
        assert rec0.restarts == 1
        assert rec1.proc.is_alive()
    finally:
        _teardown(ctl)


def test_watchdog_restarts_hung_worker_via_heartbeat(tmp_path, nr_restore):
    exp, trial = f"hang-{uuid.uuid4().hex[:6]}", "t0"
    ctl, escalations = _controller(
        tmp_path, exp, trial, max_restarts=1,
        extra_env={"AREAL_FAULTS": "worker.poll@sleeper/0=hang:k=5"})
    try:
        ctl._spawn(SLEEPER, PortSleeperConfig(exp, trial, 0))
        registry = HealthRegistry(exp, trial)
        _wait_until(lambda: "sleeper/0" in registry.snapshot(), msg="worker heartbeating")
        pid0 = ctl._workers["sleeper/0"].proc.pid
        _supervise_until(ctl, registry, lambda: ctl._workers["sleeper/0"].restarts == 1,
                         "hang-triggered restart")
        assert escalations == []
        rec = ctl._workers["sleeper/0"]
        assert rec.proc.pid != pid0
        # The hung incarnation was killed and reaped before the spawn.
        with pytest.raises(ProcessLookupError):
            os.kill(pid0, 0)
        # The successor (same AREAL_FAULTS, a fresh hit counter) beats
        # again before its own injected hang.
        _wait_until(lambda: registry.snapshot().get("sleeper/0", {}).get("pid") == rec.proc.pid,
                    msg="restarted worker heartbeating")
    finally:
        _teardown(ctl)


def test_trainer_plane_role_escalates_at_once(tmp_path, nr_restore):
    assert "model_worker" not in port_controller.RESTARTABLE_ROLES
    assert port_controller.RESTARTABLE_ROLES == frozenset(
        {"generation_server", "rollout_worker", "gserver_manager"})
    exp, trial = f"trainer-{uuid.uuid4().hex[:6]}", "t0"
    # The default restartable set: the sleeper's role is not in it.
    ctl, escalations = _controller(tmp_path, exp, trial, max_restarts=2, roles=None)
    try:
        ctl._spawn(SLEEPER, PortSleeperConfig(exp, trial, 0))
        registry = HealthRegistry(exp, trial)
        _wait_until(lambda: "sleeper/0" in registry.snapshot(), msg="worker heartbeating")
        os.kill(ctl._workers["sleeper/0"].proc.pid, signal.SIGKILL)
        _supervise_until(ctl, registry, lambda: bool(escalations), "escalation")
        assert ctl._workers["sleeper/0"].restarts == 0
        assert "sleeper/0" in escalations[0]
    finally:
        _teardown(ctl)


@pytest.mark.parametrize("how", ["stopped_and_lingering", "exited_cleanly"])
def test_stopped_record_is_never_restarted(tmp_path, nr_restore, how):
    exp, trial = f"stopped-{uuid.uuid4().hex[:6]}", "t0"
    ctl, escalations = _controller(tmp_path, exp, trial, max_restarts=2)
    cfg = (PortSleeperConfig(exp, trial, 0, stop_heartbeat_after=40)
           if how == "stopped_and_lingering" else PortSleeperConfig(exp, trial, 0, exit_after=40))
    try:
        ctl._spawn(SLEEPER, cfg)
        registry = HealthRegistry(exp, trial)
        _wait_until(lambda: "sleeper/0" in registry.snapshot(), msg="worker heartbeating")
        rec = ctl._workers["sleeper/0"]
        _supervise_until(ctl, registry, lambda: "sleeper/0" in registry.classified()[1],
                         "graceful stop")
        # Well past the stale window (3 x 0.3 s): still no restart.
        t_end = time.monotonic() + 2.0
        while time.monotonic() < t_end:
            assert ctl.supervise_once(registry)
            time.sleep(0.1)
        assert rec.restarts == 0 and escalations == []
        if how == "stopped_and_lingering":
            assert rec.proc.is_alive()
        else:
            rec.proc.join(timeout=30)  # the stopped record comes before the exit
            assert rec.proc.exitcode == 0 and ctl.supervise_once(registry)
            assert rec.restarts == 0 and escalations == []
    finally:
        _teardown(ctl)


def test_run_experiment_passes_worker_restarts(monkeypatch):
    """``worker_restarts`` reaches the controller (it was read by nothing)."""
    from areal_tpu_torch.api.cli_args import AsyncPPOMATHExpConfig
    from areal_tpu_torch.training import utils

    seen = []

    class FakeController:
        def __init__(self, exp_cfg, name_resolve_cfg=None, worker_env=None,
                     max_worker_restarts=None):
            seen.append(max_worker_restarts)

        def run(self, timeout=None):
            return {"global_step": 0}

    monkeypatch.setattr(utils, "LocalController", FakeController)
    monkeypatch.setattr(utils, "make_experiment", lambda kind, cfg: None)
    for n in (0, 3):
        cfg = AsyncPPOMATHExpConfig()
        cfg.worker_restarts = n
        assert utils.run_experiment("async-ppo-math", cfg) == {"global_step": 0}
    assert seen == [0, 3]
