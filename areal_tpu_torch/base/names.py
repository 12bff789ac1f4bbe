"""name_resolve key schema (the port's copy of the keys it uses from
``areal_tpu/base/names.py``). The keys are the reference's byte for
byte: a record one package writes is where the other looks for it."""

from __future__ import annotations

USER_NAMESPACE = "areal_tpu"


def trial_root(experiment_name: str, trial_name: str) -> str:
    return f"{USER_NAMESPACE}/{experiment_name}/{trial_name}"


def worker_status(experiment_name: str, trial_name: str, worker_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/status/{worker_name}"


def worker(experiment_name: str, trial_name: str, worker_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/workers/{worker_name}"


def worker_key(experiment_name: str, trial_name: str, key: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/worker_key/{key}"


def request_reply_stream(experiment_name: str, trial_name: str, stream_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/request_reply_stream/{stream_name}"


def push_pull_stream(experiment_name: str, trial_name: str, stream_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/push_pull_stream/{stream_name}"


def gen_servers(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/gen_servers"


def gen_server_url(experiment_name: str, trial_name: str, server_id: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/gen_server_url/{server_id}"


def gen_server_manager(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/gen_server_manager"


def model_version(experiment_name: str, trial_name: str, model_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/model_version/{model_name}"


def training_samples(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/training_samples"


def experiment_status(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/experiment_status"


def health(experiment_name: str, trial_name: str, member: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/health/{member}"


def health_root(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/health/"


def weight_plane_source(experiment_name: str, trial_name: str, model_name: str) -> str:
    """HTTP origin of the weight-distribution plane for one model role
    (system/weight_plane.py): the trainer-side dump rank (or the gserver
    manager's fallback) registers its URL here."""
    return f"{trial_root(experiment_name, trial_name)}/weight_plane/{model_name}"


def reward_executor_url(experiment_name: str, trial_name: str, executor_id: str) -> str:
    """HTTP endpoint of one pooled reward-executor service
    (system/reward_executor.py). Liveness rides the health registry
    (member ``reward_executor/<id>``); this key is the URL record
    clients resolve when no heartbeat lists the executor."""
    return f"{trial_root(experiment_name, trial_name)}/reward_executor_url/{executor_id}"


def reward_executor_url_root(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/reward_executor_url/"
