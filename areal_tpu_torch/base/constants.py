"""Per-process experiment identity and file layout (the port's copy of
what it calls from ``areal_tpu/base/constants.py``: the experiment and
trial names and the log, recover, save and param-realloc paths, under the
reference's ``AREAL_FILEROOT`` layout; the model-scope registry is not
ported). ``RECOVER_ROOT`` overrides the recover root as the reference's
module-level name does."""

from __future__ import annotations

import getpass
import os
import tempfile
from typing import Optional

from areal_tpu_torch.base import env_registry

_experiment_name: Optional[str] = None
_trial_name: Optional[str] = None

# Explicit override of the recover root (tests and harnesses set it);
# None = <fileroot>/recover.
RECOVER_ROOT: Optional[str] = None


def get_fileroot() -> str:
    # Read at call time: spawned workers import this module while
    # unpickling their config, before the controller's env is applied.
    return (env_registry.get_str("AREAL_FILEROOT")
            or os.path.join(tempfile.gettempdir(), "areal_tpu", getpass.getuser()))


def set_experiment_trial_names(experiment_name: str, trial_name: str):
    global _experiment_name, _trial_name
    _experiment_name = experiment_name
    _trial_name = trial_name


def experiment_name() -> str:
    if _experiment_name is None:
        raise RuntimeError("experiment_name accessed before set_experiment_trial_names")
    return _experiment_name


def trial_name() -> str:
    if _trial_name is None:
        raise RuntimeError("trial_name accessed before set_experiment_trial_names")
    return _trial_name


def _path(kind: str, experiment: Optional[str], trial: Optional[str],
          root: Optional[str] = None) -> str:
    p = os.path.join(root or os.path.join(get_fileroot(), kind),
                     experiment or experiment_name(), trial or trial_name())
    os.makedirs(p, exist_ok=True)
    return p


def get_log_path(experiment: Optional[str] = None, trial: Optional[str] = None) -> str:
    return _path("logs", experiment, trial)


def get_recover_path(experiment: Optional[str] = None, trial: Optional[str] = None) -> str:
    return _path("recover", experiment, trial, RECOVER_ROOT)


def get_save_path(experiment: Optional[str] = None, trial: Optional[str] = None) -> str:
    return _path("checkpoints", experiment, trial)


def get_param_realloc_path(experiment: Optional[str] = None,
                           trial: Optional[str] = None) -> str:
    return _path("param_realloc", experiment, trial)
