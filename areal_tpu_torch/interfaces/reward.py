"""Verifier-based reward interface, math and code (the port's copy of
``areal_tpu/interfaces/reward.py``, registered as "rw-math-code"):
decodes each generated response, grades it against its prompt's answer
(the math grader, or the code verifier by task tag) and emits one reward a
sequence (+5 / -5 by default) and one score a prompt (its share of
correct answers). It runs on the host; no model forward is needed, so
sync PPO's reward shard sits on the mock backend. Grading runs in a
local thread pool, or on the remote verifier service when
``FUNCTIONCALL_SERVICE_DOMAIN`` names one (``functioncall/remote.py``).
"""

from __future__ import annotations

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List

import numpy as np

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import Model, ModelInterface, register_interface
from areal_tpu_torch.functioncall.code_verify import code_verify
from areal_tpu_torch.functioncall.math_grader import grade_answer


def verify_one(task: str, text: str, answer_info: Any) -> bool:
    """Grade one generated answer against its reference (the math grader,
    or the code verifier over the test cases). Shared by the reward MFC
    and the PPO interface's best-of-k selection."""
    if task == "code":
        cases = answer_info
        if isinstance(cases, str):
            cases = json.loads(cases)
        return code_verify(text, cases)
    return grade_answer(text, answer_info)


def verify_all(jobs: List[tuple], max_workers: int = 8) -> List[bool]:
    """Verify (task, text, answer) jobs, in order: against the remote
    verifier service when FUNCTIONCALL_SERVICE_DOMAIN is set (batched, with
    retries), in a local thread pool otherwise."""
    from areal_tpu_torch.functioncall import remote

    if remote.remote_enabled():
        oks: List[bool] = [False] * len(jobs)
        by_task: Dict[str, List[int]] = {}
        for i, (task, _, _) in enumerate(jobs):
            by_task.setdefault(task, []).append(i)
        for task, idxs in by_task.items():
            payloads = []
            for i in idxs:
                _, text, answer = jobs[i]
                key = "test_cases" if task == "code" else "answer"
                payloads.append({"uid": str(i), "solution": text, key: answer})
            for i, ok in zip(idxs, remote.batch_verify(payloads, task)):
                oks[i] = ok
        return oks

    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        return list(ex.map(lambda args: verify_one(*args), jobs))


@dataclasses.dataclass
class MultiTaskRewardInterface(ModelInterface):
    correct_reward: float = 5.0
    wrong_reward: float = -5.0
    max_workers: int = 8
    check_verifier_status: bool = False

    def _verify_one(self, task: str, text: str, answer_info: Any) -> bool:
        return verify_one(task, text, answer_info)

    def _verify_all(self, jobs: List[tuple]) -> List[bool]:
        return verify_all(jobs, max_workers=self.max_workers)

    def inference(
        self, model: Model, input_: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        tokenizer = model.tokenizer
        flat = np.asarray(input_.data["packed_input_ids"])
        pm = np.asarray(input_.data.get("prompt_mask")) if "prompt_mask" in input_.keys else None

        texts: List[str] = []
        offset = 0
        seq_prompt_ids: List[int] = []  # prompt index of each sequence
        for pi, sl in enumerate(input_.seqlens["packed_input_ids"]):
            for l in sl:
                ids = flat[offset: offset + l]
                if pm is not None:
                    ids = ids[pm[offset: offset + l] == 0]  # response only
                texts.append(tokenizer.decode(ids.tolist()))
                seq_prompt_ids.append(pi)
                offset += l

        answers = input_.metadata.get("solutions") or input_.metadata.get("answers")
        tasks = input_.metadata.get("tasks") or ["math"] * input_.bs
        if answers is None:
            raise ValueError("reward interface needs 'solutions'/'answers' metadata")

        jobs = [(tasks[pi], texts[si], answers[pi]) for si, pi in enumerate(seq_prompt_ids)]
        oks = self._verify_all(jobs)
        rewards = np.where(np.asarray(oks), self.correct_reward,
                           self.wrong_reward).astype(np.float32)

        n_per_prompt = [len(sl) for sl in input_.seqlens["packed_input_ids"]]
        return SequenceSample(
            ids=list(input_.ids),
            keys={"rewards"},
            data={"rewards": rewards},
            seqlens={"rewards": [[1] * n for n in n_per_prompt]},
            metadata={
                "scores": [
                    float(np.mean([ok for si, ok in zip(seq_prompt_ids, oks) if si == pi]))
                    for pi in range(input_.bs)
                ]
            },
        )


register_interface("rw-math-code", MultiTaskRewardInterface)
