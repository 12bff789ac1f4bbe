"""Verification environment (the port's copy of ``MathCodeSingleStepEnv``
from ``areal_tpu/agents/envs.py``): a single-step env whose action is
(qid, answer_texts, task, answer_info) and whose observation is the
per-answer success list from the local graders. ``ToolEnv`` (multi-turn
tool use) is not ported.
"""

from __future__ import annotations

import asyncio
import json
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Tuple

from areal_tpu_torch.api.env_api import EnvironmentService, register_environment
from areal_tpu_torch.functioncall.code_verify import code_verify
from areal_tpu_torch.functioncall.math_grader import grade_answer


class MathCodeSingleStepEnv(EnvironmentService):
    def __init__(self, max_workers: int = 8):
        self._pool = ThreadPoolExecutor(max_workers=max_workers)

    def _verify_one(self, task: str, text: str, answer_info: Any) -> bool:
        if task == "code":
            cases = answer_info
            if isinstance(cases, str):
                cases = json.loads(cases)
            return code_verify(text, cases)
        return grade_answer(text, answer_info)

    async def step(self, action) -> Tuple[Any, float, bool, bool, dict]:
        qid, answers, task, answer_info = action
        loop = asyncio.get_running_loop()
        successes: List[bool] = list(
            await asyncio.gather(
                *[
                    loop.run_in_executor(
                        self._pool, self._verify_one, task, a, answer_info
                    )
                    for a in answers
                ]
            )
        )
        return successes, 0.0, True, False, {}


register_environment("math-code-single-step", MathCodeSingleStepEnv)
