"""Multi-turn math RL agent (the port's copy of
``areal_tpu/agents/math_multi_turn.py``, registered as "math-multi-turn").

The agent generates an answer, the environment verifies it, and verbal
feedback is appended to the conversation before the next turn
regenerates. Each turn's full sequence (the conversation so far and the
new answer) becomes one packed sequence of the trajectory sample;
per-turn rewards are accumulated backwards with `turn_level_discount`.
``stop_on_success=True`` (the default) ends the episode at the first
correct answer. Logprobs are in the shifted frame (the logprob of the
token at position p stored at p-1), as the single-step agent's.
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

logger = logging.getLogger("math_multi_turn_agent")

CORRECT_FEEDBACK = "Congratulations! You are correct!"
WRONG_FEEDBACK = "Unfortunately your answer is wrong. Let's try again."


class MathMultiTurnAgent(Agent):
    def __init__(
        self,
        gconfig: Optional[GenerationHyperparameters] = None,
        tokenizer: Any = None,
        num_turns: int = 4,
        turn_level_discount: float = 1.0,
        reward_scaling: float = 1.0,
        reward_bias: float = 0.0,
        correct_reward: float = 1.0,
        wrong_reward: float = -1.0,
        stop_on_success: bool = True,
        **gconfig_kwargs,
    ):
        if gconfig is None:
            gconfig = GenerationHyperparameters(**gconfig_kwargs)
        elif isinstance(gconfig, dict):
            gconfig = GenerationHyperparameters(**gconfig)
        # One sequence per turn; grouping happens across episodes.
        self.gconfig = gconfig.new(n=1)
        self.tokenizer = tokenizer
        self.num_turns = num_turns
        self.turn_level_discount = turn_level_discount
        self.reward_scaling = reward_scaling
        self.reward_bias = reward_bias
        self.correct_reward = correct_reward
        self.wrong_reward = wrong_reward
        self.stop_on_success = stop_on_success

    def _encode_feedback(self, text: str) -> List[int]:
        tok = self.tokenizer
        if hasattr(tok, "apply_chat_template"):
            try:
                rendered = "\n" + tok.apply_chat_template(
                    [dict(content=text, role="user")],
                    add_generation_prompt=True,
                    tokenize=False,
                )
                return tok(rendered, add_special_tokens=False)["input_ids"]
            except Exception:  # tokenizer without a chat template
                pass
        return tok("\n" + text + "\n", add_special_tokens=False)["input_ids"]

    async def collect_trajectory(
        self,
        prompt: SequenceSample,
        env: EnvironmentService,
        obs_queue: asyncio.Queue,
        act_queue: asyncio.Queue,
    ) -> List[SequenceSample]:
        await env.reset()
        assert prompt.bs == 1
        qid = prompt.ids[0]
        token_ids = np.asarray(prompt.data["packed_prompts"]).tolist()
        task = (prompt.metadata.get("tasks") or ["math"])[0]
        answer_info = (prompt.metadata.get("solutions") or [None])[0]

        turn_seqs: List[List[int]] = []
        turn_lps: List[np.ndarray] = []
        turn_prompt_lens: List[int] = []
        turn_no_eos: List[bool] = []
        turn_rewards: List[float] = []
        successes: List[bool] = []
        v_start: List[int] = []
        v_end: List[int] = []

        for _turn in range(self.num_turns):
            await obs_queue.put((qid, token_ids, self.gconfig))
            bundle: BundledGenerationOutputs = await act_queue.get()
            seq = list(bundle.seqs[0])
            plen = bundle.prompt_len

            answer = self.tokenizer.decode(seq[plen:])
            ok_list, *_ = await env.step((qid, [answer], task, answer_info))
            ok = bool(ok_list[0])
            successes.append(ok)

            turn_seqs.append(seq)
            turn_lps.append(np.asarray(bundle.logprobs[0], np.float32))
            turn_prompt_lens.append(plen)
            turn_no_eos.append(bool(bundle.no_eos[0]))
            turn_rewards.append(
                (self.correct_reward if ok else self.wrong_reward)
                * self.reward_scaling
                + self.reward_bias
            )
            v_start.append(min(bundle.version_start))
            v_end.append(max(bundle.version_end))

            if ok and self.stop_on_success:
                break
            feedback = CORRECT_FEEDBACK if ok else WRONG_FEEDBACK
            token_ids = seq + self._encode_feedback(feedback)

        # Turn-level discounted returns.
        for i in reversed(range(len(turn_rewards) - 1)):
            turn_rewards[i] += self.turn_level_discount * turn_rewards[i + 1]

        n = len(turn_seqs)
        seq_lens = [len(s) for s in turn_seqs]
        pmask = np.concatenate(
            [
                np.concatenate(
                    [np.ones(p, np.int64), np.zeros(l - p, np.int64)]
                )
                for l, p in zip(seq_lens, turn_prompt_lens)
            ]
        )
        shifted_lps = []
        for seq, lp, plen in zip(turn_seqs, turn_lps, turn_prompt_lens):
            out_lp = np.asarray(lp[plen:], np.float32)
            full = np.zeros(len(seq), np.float32)
            full[plen - 1 : len(seq) - 1] = out_lp
            shifted_lps.append(full)

        sample = SequenceSample(
            ids=[qid],
            keys={
                "packed_input_ids", "prompt_mask", "packed_logprobs",
                "seq_no_eos_mask", "rewards",
            },
            data={
                "packed_input_ids": np.concatenate(
                    [np.asarray(s, np.int32) for s in turn_seqs]
                ),
                "prompt_mask": pmask,
                "packed_logprobs": np.concatenate(shifted_lps),
                "seq_no_eos_mask": np.asarray(
                    [1.0 if x else 0.0 for x in turn_no_eos], np.float32
                ),
                "rewards": np.asarray(turn_rewards, np.float32),
            },
            seqlens={
                "packed_input_ids": [seq_lens],
                "prompt_mask": [seq_lens],
                "packed_logprobs": [seq_lens],
                "seq_no_eos_mask": [[1] * n],
                "rewards": [[1] * n],
            },
            metadata={
                "version_start": [min(v_start)],
                "version_end": [max(v_end)],
                "scores": [float(np.mean(successes))],
                "birth_time": [0],
                # Per-task staleness tag: math rides the TIGHT admission
                # window (AREAL_TASK_STALENESS_WINDOWS).
                "task": [task],
            },
        )
        return [sample]


register_agent("math-multi-turn", MathMultiTurnAgent)
