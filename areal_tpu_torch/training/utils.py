"""Experiment launcher with the relaunch loop (the port's copy of
``training/utils.py``): ``key=value`` overrides onto an option dataclass,
then the experiment through ``LocalController``; on a failed run it
relaunches with ``recover_mode="auto"`` up to ``recover_retries`` times,
each attempt a fresh experiment and controller that resume from the
last recover checkpoint. Before a relaunch the failed attempt's workers
are gone (``LocalController`` stops them) and the trial's name_resolve
entries are cleared, so the new workers' addresses are the only ones.
A fault armed in this process (``faults.arm``) keeps its hit count
across attempts. The reference's automatic evaluator is not ported:
``auto_eval`` raises when the experiment is built.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Type

from areal_tpu_torch.api.cli_args import apply_overrides
from areal_tpu_torch.base import constants, logging, name_resolve, names
from areal_tpu_torch.experiments import make_experiment
from areal_tpu_torch.system.controller import LocalController

logger = logging.getLogger("launcher")


def parse_args(cfg_cls: Type, argv=None):
    parser = argparse.ArgumentParser(
        description=f"areal_tpu_torch launcher ({cfg_cls.__name__}). "
        "Overrides: dotted key=value pairs, e.g. actor.path=/ckpt lr=1e-5",
    )
    parser.add_argument("overrides", nargs="*", help="a.b.c=value overrides")
    parser.add_argument(
        "--help-config",
        action="store_true",
        help="list every dotted override path with type/default/help",
    )
    args = parser.parse_args(argv)
    cfg = cfg_cls()
    if args.help_config:
        from areal_tpu_torch.api.cli_args import format_options

        print(format_options(cfg))
        sys.exit(0)
    apply_overrides(cfg, args.overrides)
    return cfg


def run_experiment(experiment_type: str, cfg, worker_env: Optional[dict] = None,
                   timeout: Optional[float] = None) -> dict:
    """Build + run, relaunching with recovery on failure; `timeout`
    (seconds) bounds the whole call, relaunches included."""
    name_resolve_cfg = {"backend": cfg.name_resolve_backend}
    if cfg.name_resolve_root:
        name_resolve_cfg["record_root"] = cfg.name_resolve_root
    constants.set_experiment_trial_names(cfg.experiment_name, cfg.trial_name)
    deadline = None if timeout is None else time.monotonic() + timeout
    attempt = 0
    while True:
        exp_cfg = make_experiment(experiment_type, cfg)
        ctl = LocalController(exp_cfg, name_resolve_cfg=name_resolve_cfg,
                              worker_env=dict(worker_env or {}))
        left = None if deadline is None else max(1.0, deadline - time.monotonic())
        try:
            return ctl.run(timeout=left)
        except Exception:
            attempt += 1
            if (cfg.recover_mode == "disabled" or attempt > cfg.recover_retries
                    or (deadline is not None and time.monotonic() >= deadline)):
                raise
            logger.exception(
                f"experiment failed; relaunching with recovery "
                f"(attempt {attempt}/{cfg.recover_retries})")
            cfg.recover_mode = "auto"
            # The failed attempt's records (worker addresses among them)
            # must not be read by the next one's workers.
            name_resolve.clear_subtree(names.trial_root(cfg.experiment_name, cfg.trial_name))
            time.sleep(2)


def main(experiment_type: str, cfg_cls: Type, argv=None, worker_env: Optional[dict] = None,
         timeout: Optional[float] = None):
    cfg = parse_args(cfg_cls, argv)
    result = run_experiment(experiment_type, cfg, worker_env=worker_env, timeout=timeout)
    logger.info(f"experiment finished: {result}")
    return result
