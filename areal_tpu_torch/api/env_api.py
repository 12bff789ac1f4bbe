"""Environment service abstraction (the port's copy of
``areal_tpu/api/env_api.py``)."""

from __future__ import annotations

import abc
from typing import Any, Tuple

from areal_tpu_torch.api.config import EnvServiceAbstraction
from areal_tpu_torch.api.registry import Registry


class EnvironmentService(abc.ABC):

    async def reset(self, seed=None, options=None):
        return None, {}

    @abc.abstractmethod
    async def step(self, action: Any) -> Tuple[Any, float, bool, bool, dict]:
        """Gym-style step; for single-step verification envs the action is
        (qid, answer_strs, task, answer_info) and the success list rides
        in the obs slot."""


ENV_REGISTRY = Registry("environment")


def register_environment(name: str, factory):
    ENV_REGISTRY.register(name, factory)


def make_env(cfg: EnvServiceAbstraction | str, **kwargs) -> EnvironmentService:
    return ENV_REGISTRY.make(cfg, **kwargs)
