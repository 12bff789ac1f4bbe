"""Null agent: generation without verification (the port's copy of
``areal_tpu/agents/null.py``, registered as "null"). Every trajectory gets
a constant reward, with no env call and no group filtering;
`episode_length` requests a prompt exercise the multi-request servicing
loop."""

from __future__ import annotations

import asyncio
from typing import Any, List, Optional

import numpy as np

from areal_tpu_torch.api.agent_api import Agent, register_agent
from areal_tpu_torch.api.data_api import SequenceSample
from areal_tpu_torch.api.env_api import EnvironmentService
from areal_tpu_torch.agents.common import bundle_to_sample
from areal_tpu_torch.api.model_api import BundledGenerationOutputs, GenerationHyperparameters


class NullAgent(Agent):
    def __init__(
        self,
        gconfig: Optional[GenerationHyperparameters] = None,
        tokenizer: Any = None,
        episode_length: int = 1,
        reward: float = 0.0,
        **gconfig_kwargs,
    ):
        if gconfig is None:
            gconfig = GenerationHyperparameters(**gconfig_kwargs)
        elif isinstance(gconfig, dict):
            gconfig = GenerationHyperparameters(**gconfig)
        self.gconfig = gconfig
        self.episode_length = episode_length
        self.reward = reward

    async def collect_trajectory(
        self,
        prompt: SequenceSample,
        env: EnvironmentService,
        obs_queue: asyncio.Queue,
        act_queue: asyncio.Queue,
    ) -> List[SequenceSample]:
        assert prompt.bs == 1
        qid = prompt.ids[0]
        prompt_ids = np.asarray(prompt.data["packed_prompts"]).tolist()
        samples: List[SequenceSample] = []
        for turn in range(self.episode_length):
            await obs_queue.put((qid, prompt_ids, self.gconfig))
            bundle: BundledGenerationOutputs = await act_queue.get()
            rewards = np.full((len(bundle.seqs),), self.reward, np.float32)
            # Per-turn sample ids: the sequence buffer keys samples by id,
            # so multi-episode trajectories must not collide on qid.
            sid = qid if self.episode_length == 1 else f"{qid}-t{turn}"
            samples.append(bundle_to_sample(sid, bundle, rewards, score=0.0))
        return samples


register_agent("null", NullAgent)
