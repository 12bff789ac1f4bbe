"""Experiment launcher (the port's copy of ``training/utils.py``):
``key=value`` overrides onto an option dataclass, then the experiment
through ``LocalController``. The reference's relaunch-with-recovery loop
and automatic evaluator are not ported: ``recover_mode`` other than
"disabled" and ``auto_eval`` raise when the experiment is built.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Type

from areal_tpu_torch.api.cli_args import apply_overrides
from areal_tpu_torch.base import constants, logging
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
    """Build the experiment and run it once through LocalController;
    `timeout` (seconds) bounds the run."""
    name_resolve_cfg = {"backend": cfg.name_resolve_backend}
    if cfg.name_resolve_root:
        name_resolve_cfg["record_root"] = cfg.name_resolve_root
    constants.set_experiment_trial_names(cfg.experiment_name, cfg.trial_name)
    exp_cfg = make_experiment(experiment_type, cfg)
    ctl = LocalController(exp_cfg, name_resolve_cfg=name_resolve_cfg,
                          worker_env=dict(worker_env or {}))
    return ctl.run(timeout=timeout)


def main(experiment_type: str, cfg_cls: Type, argv=None, worker_env: Optional[dict] = None,
         timeout: Optional[float] = None):
    cfg = parse_args(cfg_cls, argv)
    result = run_experiment(experiment_type, cfg, worker_env=worker_env, timeout=timeout)
    logger.info(f"experiment finished: {result}")
    return result
