"""Multi-turn tool-use agent (the port's copy of
``areal_tpu/agents/tool_use.py``, registered as "tool-use").

Each episode is a conversation: the model generates a turn; if the turn
contains a tool call (``<tool:python>code</tool>``, calculator, search)
the ToolEnv runs it and the tool's output text is spliced into the
conversation before the next turn; a turn without a tool call is the
final answer and grades through the same verifiers as the math agents.

Every turn after the first is a SESSION CONTINUATION through the
partial-rollout client: the same qid re-enters the fleet on the
manager's sticky-affinity route, and only the turn delta (the tool
output tokens) is accounted as re-prefill.

A random tiny model never emits tool syntax, so ``scripted_tool_turns``
forces a deterministic tool-call script for the first N turns: what is
exercised is the episode plumbing (the turn loop, the executor pool,
continuation accounting, staleness tags), not the model's tool use.

Beside the reference's ``agent.turn`` and ``tool.call`` spans, each tool
call records a ``tool.result`` event with the observation text (its
first 200 characters).
"""

from __future__ import annotations

import asyncio
import json
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from areal_tpu_torch.api.agent_api import Agent, register_agent
from areal_tpu_torch.api.data_api import SequenceSample
from areal_tpu_torch.api.env_api import EnvironmentService
from areal_tpu_torch.api.model_api import (
    BundledGenerationOutputs,
    GenerationHyperparameters,
)
from areal_tpu_torch.base import logging, tracing

logger = logging.getLogger("tool_use_agent")

_TOOL_RE = re.compile(r"<tool:(\w+)>(.*?)</tool>", re.DOTALL)

# Raw (non-JSON) tool bodies map onto each tool's primary argument.
_BODY_KEY = {"python": "code", "calculator": "expr", "search": "query"}

# The deterministic script harnesses cycle through (one call per turn).
_DEFAULT_SCRIPT: List[Tuple[str, Dict[str, Any]]] = [
    ("python", {"code": "print(6 * 7)"}),
    ("calculator", {"expr": "6 * 7"}),
    ("search", {"query": "answer"}),
]


def parse_tool_call(text: str) -> Optional[Tuple[str, Dict[str, Any]]]:
    """First ``<tool:name>body</tool>`` in the text, as (name, payload).
    A JSON-object body is the payload verbatim; anything else becomes
    the tool's primary argument. None when the text calls no tool."""
    m = _TOOL_RE.search(text)
    if not m:
        return None
    name, body = m.group(1), m.group(2).strip()
    if body.startswith("{"):
        try:
            payload = json.loads(body)
            if isinstance(payload, dict):
                return name, payload
        except ValueError:
            pass
    return name, {_BODY_KEY.get(name, "input"): body}


class ToolUseAgent(Agent):
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
        scripted_tool_turns: int = 0,
        task_tag: str = "agentic",
        **gconfig_kwargs,
    ):
        if gconfig is None:
            gconfig = GenerationHyperparameters(**gconfig_kwargs)
        elif isinstance(gconfig, dict):
            gconfig = GenerationHyperparameters(**gconfig)
        # One sequence per turn; grouping happens across episodes.
        self.gconfig = gconfig.new(n=1)
        self.tokenizer = tokenizer
        self.num_turns = max(1, num_turns)
        self.turn_level_discount = turn_level_discount
        self.reward_scaling = reward_scaling
        self.reward_bias = reward_bias
        self.correct_reward = correct_reward
        self.wrong_reward = wrong_reward
        self.scripted_tool_turns = min(
            scripted_tool_turns, self.num_turns - 1
        )
        self.task_tag = task_tag

    def _encode(self, text: str) -> List[int]:
        return self.tokenizer(
            "\n" + text + "\n", add_special_tokens=False
        )["input_ids"]

    def _tool_call_for_turn(
        self, turn: int, text: str
    ) -> Optional[Tuple[str, Dict[str, Any]]]:
        if turn < self.scripted_tool_turns:
            return _DEFAULT_SCRIPT[turn % len(_DEFAULT_SCRIPT)]
        if turn >= self.num_turns - 1:
            return None  # last turn must answer
        return parse_tool_call(text)

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
        v_start: List[int] = []
        v_end: List[int] = []
        n_tool_calls = 0
        success = False

        for turn in range(self.num_turns):
            with tracing.span(
                "agent.turn", qid=str(qid), turn=turn, task=self.task_tag
            ):
                await obs_queue.put((qid, token_ids, self.gconfig))
                bundle: BundledGenerationOutputs = await act_queue.get()
            seq = list(bundle.seqs[0])
            plen = bundle.prompt_len
            text = self.tokenizer.decode(seq[plen:])

            turn_seqs.append(seq)
            turn_lps.append(np.asarray(bundle.logprobs[0], np.float32))
            turn_prompt_lens.append(plen)
            turn_no_eos.append(bool(bundle.no_eos[0]))
            v_start.append(min(bundle.version_start))
            v_end.append(max(bundle.version_end))

            call = self._tool_call_for_turn(turn, text)
            if call is not None:
                name, payload = call
                with tracing.span(
                    "tool.call", qid=str(qid), tool=name, turn=turn
                ):
                    obs_text, *_ = await env.step(
                        ("tool", str(qid), name, payload)
                    )
                    # The observation itself (a port addition): what the
                    # tool answered, so a run can check its tool traffic.
                    tracing.event(
                        "tool.result", qid=str(qid), tool=name, turn=turn,
                        obs=str(obs_text)[:200],
                    )
                n_tool_calls += 1
                turn_rewards.append(0.0)
                token_ids = seq + self._encode(
                    f"<tool_output>{obs_text}</tool_output>"
                )
                continue

            ok_list, *_ = await env.step(
                ("answer", str(qid), [text], task, answer_info)
            )
            success = bool(ok_list[0])
            turn_rewards.append(
                (self.correct_reward if success else self.wrong_reward)
                * self.reward_scaling
                + self.reward_bias
            )
            break

        # Tool turns earn their keep through the discounted return of
        # the final graded answer (as math_multi_turn does).
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
                "scores": [1.0 if success else 0.0],
                "birth_time": [0],
                # Agentic trajectories ride the LOOSE per-task staleness
                # window; the master's per-task scalars key off this.
                "task": [self.task_tag],
                "turns": [n],
                "tool_calls": [n_tool_calls],
            },
        )
        return [sample]


register_agent("tool-use", ToolUseAgent)
