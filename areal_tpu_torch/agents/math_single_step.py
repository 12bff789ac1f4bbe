"""Single-step math/code RL agent (the port's copy of
``areal_tpu/agents/math_single_step.py``): one prompt -> one group of
generations -> verifier rewards -> one trajectory sample. The agent
never talks HTTP itself: it puts its request on the obs queue and reads
the group from the act queue. Groups whose success rate falls outside
[lb, ub] are dropped.
"""

from __future__ import annotations

import asyncio
from typing import Any, List, Optional

import numpy as np

from areal_tpu_torch.api.agent_api import Agent, register_agent
from areal_tpu_torch.api.data_api import SequenceSample
from areal_tpu_torch.api.env_api import EnvironmentService
from areal_tpu_torch.api.model_api import BundledGenerationOutputs, GenerationHyperparameters
from areal_tpu_torch.base import logging

logger = logging.getLogger("math_agent")


class MathSingleStepAgent(Agent):
    def __init__(
        self,
        gconfig: Optional[GenerationHyperparameters] = None,
        tokenizer: Any = None,
        reward_scaling: float = 1.0,
        reward_bias: float = 0.0,
        correct_reward: float = 5.0,
        wrong_reward: float = -5.0,
        success_rate_lb: float = 0.0,
        success_rate_ub: float = 1.0,
        **gconfig_kwargs,
    ):
        if gconfig is None:
            gconfig = GenerationHyperparameters(**gconfig_kwargs)
        elif isinstance(gconfig, dict):
            gconfig = GenerationHyperparameters(**gconfig)
        self.gconfig = gconfig
        self.tokenizer = tokenizer
        self.reward_scaling = reward_scaling
        self.reward_bias = reward_bias
        self.correct_reward = correct_reward
        self.wrong_reward = wrong_reward
        self.success_rate_lb = success_rate_lb
        self.success_rate_ub = success_rate_ub

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
        await obs_queue.put((qid, prompt_ids, self.gconfig))
        bundle: BundledGenerationOutputs = await act_queue.get()

        task = (prompt.metadata.get("tasks") or ["math"])[0]
        answer_info = (prompt.metadata.get("solutions") or [None])[0]
        answers = [
            self.tokenizer.decode(seq[bundle.prompt_len:])
            for seq in bundle.seqs
        ]
        successes, *_ = await env.step((qid, answers, task, answer_info))

        sr = float(np.mean(successes)) if successes else 0.0
        if not (self.success_rate_lb <= sr <= self.success_rate_ub):
            logger.debug(f"{qid}: degenerate group (sr={sr:.2f}), dropped")
            return []

        rewards = np.asarray(
            [
                (self.correct_reward if ok else self.wrong_reward)
                * self.reward_scaling
                + self.reward_bias
                for ok in successes
            ],
            np.float32,
        )
        from areal_tpu_torch.agents.common import bundle_to_sample

        return [bundle_to_sample(qid, bundle, rewards, score=sr, task=task)]


register_agent("math-single-step", MathSingleStepAgent)
