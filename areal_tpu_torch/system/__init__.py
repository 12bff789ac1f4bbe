"""The worker system: streams, buffer, workers, data plane (the port's
copy of ``areal_tpu/system/__init__.py``).

``load_worker`` resolves a worker type by the reference's role names.
"""

import importlib

# worker type -> (module, class)
_WORKER_CLASSES = {
    "master_worker": ("areal_tpu_torch.system.master_worker", "MasterWorker"),
    "model_worker": ("areal_tpu_torch.system.model_worker", "ModelWorker"),
    "generation_server": ("areal_tpu_torch.system.generation_server", "GenerationServer"),
    "gserver_manager": ("areal_tpu_torch.system.gserver_manager", "GserverManager"),
    "rollout_worker": ("areal_tpu_torch.system.rollout_worker", "RolloutWorker"),
}

WORKER_TYPES = sorted(_WORKER_CLASSES)


def load_worker(worker_type: str):
    """Resolve a worker type name to its class (lazy import).

    Accepts either a registered role name or a fully-qualified
    "module.path:ClassName" spec, which lets harnesses run custom Worker
    subclasses under the real controller without registering a role."""
    if ":" in worker_type:
        module, cls = worker_type.split(":", 1)
        return getattr(importlib.import_module(module), cls)
    if worker_type not in _WORKER_CLASSES:
        raise ValueError(
            f"unknown worker type {worker_type!r}; available: {WORKER_TYPES}"
        )
    module, cls = _WORKER_CLASSES[worker_type]
    return getattr(importlib.import_module(module), cls)
