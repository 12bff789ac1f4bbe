"""Abstraction records and shard identities (the port's copy of
``areal_tpu/api/config.py``). An *abstraction* is a (type name, kwargs)
pair resolved through a registry at run time, which is how an experiment
selects its model, backend, interface, dataset, agent and environment
declaratively; the
names are the reference's, so one ``ExperimentConfig`` reads the same in
both packages. ``ModelName`` lives in ``api/model_api.py``."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from areal_tpu_torch.api.model_api import ModelName


@dataclasses.dataclass(unsafe_hash=True)
class ModelShardID:
    """One host process's shard of a model deployment: (model, host
    index, host count) plus the reference's mesh spec string. The port
    runs one device a model worker, so a shard is ``host_rank`` 0 of 1."""

    model_name: ModelName = dataclasses.field(default_factory=ModelName)
    host_rank: int = 0
    n_hosts: int = 1
    mesh_spec: str = "d1f1s1t1"

    def __str__(self):
        return f"{self.model_name}:{self.host_rank}of{self.n_hosts}"


@dataclasses.dataclass
class ModelFamily:
    """HF model family tag: which converter/architecture to use."""

    _class: str = "qwen2"
    is_critic: bool = False

    def __str__(self):
        return f"{self._class}{'-critic' if self.is_critic else ''}"


def _abstraction(cls_name: str):
    @dataclasses.dataclass
    class _Abstraction:
        type_: str = "default"
        args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    _Abstraction.__name__ = cls_name
    _Abstraction.__qualname__ = cls_name
    return _Abstraction


ModelAbstraction = _abstraction("ModelAbstraction")
ModelInterfaceAbstraction = _abstraction("ModelInterfaceAbstraction")
ModelBackendAbstraction = _abstraction("ModelBackendAbstraction")
DatasetAbstraction = _abstraction("DatasetAbstraction")
AgentAbstraction = _abstraction("AgentAbstraction")
EnvServiceAbstraction = _abstraction("EnvServiceAbstraction")
