"""Agent abstraction for rollout workers (the port's copy of
``areal_tpu/api/agent_api.py``).

An agent turns one prompt into trajectories by exchanging observations
and actions with the generation infrastructure through a pair of asyncio
queues: the agent puts (qid, token_ids, gconfig) requests on `obs_queue`
and awaits `BundledGenerationOutputs` from `act_queue`.
"""

from __future__ import annotations

import abc
import asyncio
from typing import List

from areal_tpu_torch.api.config import AgentAbstraction
from areal_tpu_torch.api.data_api import SequenceSample
from areal_tpu_torch.api.env_api import EnvironmentService
from areal_tpu_torch.api.registry import Registry


class Agent(abc.ABC):

    @abc.abstractmethod
    async def collect_trajectory(
        self,
        prompt: SequenceSample,
        env: EnvironmentService,
        obs_queue: asyncio.Queue,
        act_queue: asyncio.Queue,
    ) -> List[SequenceSample]:
        """Run one episode; returns trajectories to push to the trainer."""


AGENT_REGISTRY = Registry("agent")


def register_agent(name: str, factory):
    AGENT_REGISTRY.register(name, factory)


def make_agent(cfg: AgentAbstraction | str, **kwargs) -> Agent:
    return AGENT_REGISTRY.make(cfg, **kwargs)
