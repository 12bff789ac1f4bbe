"""Per-process experiment identity (the port's copy of what it calls from
``areal_tpu/base/constants.py``: the experiment and trial names; the
path helpers and the model-scope registry are not ported)."""

from __future__ import annotations

from typing import Optional

_experiment_name: Optional[str] = None
_trial_name: Optional[str] = None


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
