"""name_resolve key schema (the port's copy of the keys it uses from
``areal_tpu/base/names.py``). The keys are the reference's byte for
byte: a record one package writes is where the other looks for it."""

from __future__ import annotations

USER_NAMESPACE = "areal_tpu"


def trial_root(experiment_name: str, trial_name: str) -> str:
    return f"{USER_NAMESPACE}/{experiment_name}/{trial_name}"


def gen_servers(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/gen_servers"


def gen_server_url(experiment_name: str, trial_name: str, server_id: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/gen_server_url/{server_id}"


def experiment_status(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/experiment_status"


def health(experiment_name: str, trial_name: str, member: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/health/{member}"
