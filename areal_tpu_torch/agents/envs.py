"""Verification environments (the port's copy of
``areal_tpu/agents/envs.py``).

``MathCodeSingleStepEnv`` is a single-step env whose action is (qid,
answer_texts, task, answer_info) and whose observation is the per-answer
success list from the local graders. ``ToolEnv`` ("tool-use") extends it
to multi-turn tool-use episodes: tool actions (python on the pooled
reward executor, a calculator, a search stub) return observation TEXT
mid-episode; the final answer action grades like the single-step env.
"""

from __future__ import annotations

import ast
import asyncio
import json
import operator
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from areal_tpu_torch.api.env_api import EnvironmentService, register_environment
from areal_tpu_torch.functioncall.code_verify import code_verify, run_one_case
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


# Safe arithmetic for the calculator tool: AST-walked, numbers and
# + - * / // % ** only; never eval() on model output.
_CALC_BIN = {
    ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
    ast.Div: operator.truediv, ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod, ast.Pow: operator.pow,
}
_CALC_UNARY = {ast.USub: operator.neg, ast.UAdd: operator.pos}


def _calc_eval(expr: str) -> float:
    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return node.value
        if isinstance(node, ast.BinOp) and type(node.op) in _CALC_BIN:
            left, right = ev(node.left), ev(node.right)
            if isinstance(node.op, ast.Pow) and abs(right) > 64:
                raise ValueError("exponent too large")
            return _CALC_BIN[type(node.op)](left, right)
        if isinstance(node, ast.UnaryOp) and type(node.op) in _CALC_UNARY:
            return _CALC_UNARY[type(node.op)](ev(node.operand))
        raise ValueError(f"unsupported expression node {type(node).__name__}")

    return ev(ast.parse(expr.strip(), mode="eval"))


class ToolEnv(EnvironmentService):
    """Multi-turn tool-use environment.

    Two action shapes:

    - ``("tool", qid, tool_name, payload)``: run one tool call; the
      observation is the tool's output TEXT, which the agent splices into
      the conversation. The episode continues (done=False).
    - ``("answer", qid, answer_texts, task, answer_info)``: grade the final
      answer as MathCodeSingleStepEnv does; the observation is the
      per-answer success list, done=True.

    The python tool runs on the pooled reward executor when one is
    registered and live (functioncall/remote.py) and in the fork-per-call
    code_verify sandbox otherwise. A tool failure is an observation (the
    model sees the error text), never an exception: a broken tool call
    must not kill the episode.
    """

    def __init__(
        self,
        max_workers: int = 8,
        tool_timeout_s: float = 10.0,
        search_corpus: Optional[Dict[str, str]] = None,
    ):
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self.tool_timeout_s = tool_timeout_s
        self._search_corpus = dict(search_corpus or {})

    # -- tools (each: payload dict -> observation text, sync) ----------

    def _tool_python(self, payload: Dict[str, Any]) -> str:
        code = str(payload.get("code") or "")
        from areal_tpu_torch.functioncall import remote

        pool = remote.get_executor_pool()
        if pool is not None and pool.available():
            res = pool.submit(
                [{"kind": "python", "code": code, "stdin": str(payload.get("stdin") or "")}],
                timeout_s=self.tool_timeout_s,
            )[0]
            if res.get("ok"):
                return res.get("stdout", "")
            return f"error: {res.get('stderr') or res.get('error') or 'failed'}"
        ok, out, err = run_one_case(code, str(payload.get("stdin") or ""),
                                    timeout=self.tool_timeout_s)
        return out if ok else f"error: {err}"

    def _tool_calculator(self, payload: Dict[str, Any]) -> str:
        try:
            return str(_calc_eval(str(payload.get("expr") or "")))
        except Exception as e:
            return f"error: {e}"

    def _tool_search(self, payload: Dict[str, Any]) -> str:
        # A keyed lookup over an injected corpus: the tool-call plumbing
        # (turns, spans, latency) is what the system exercises; a real
        # retrieval backend plugs in here.
        query = str(payload.get("query") or "").strip().lower()
        for key, text in self._search_corpus.items():
            if key.lower() in query or query in key.lower():
                return text
        return "no results"

    def run_tool(self, name: str, payload: Dict[str, Any]) -> str:
        fn = getattr(self, f"_tool_{name}", None)
        if fn is None:
            return f"error: unknown tool {name!r}"
        try:
            return fn(payload)
        except Exception as e:  # a tool crash is an observation, not an abort
            return f"error: {e}"

    def _verify_one(self, task: str, text: str, answer_info: Any) -> bool:
        if task == "code":
            cases = answer_info
            if isinstance(cases, str):
                cases = json.loads(cases)
            return code_verify(text, cases)
        return grade_answer(text, answer_info)

    async def step(self, action) -> Tuple[Any, float, bool, bool, dict]:
        loop = asyncio.get_running_loop()
        if action and action[0] == "tool":
            _, _qid, name, payload = action
            # Blocking tool execution (pool HTTP round trip or local
            # sandbox) off the loop: other live episodes keep being
            # serviced while this one waits on its tool.
            text = await loop.run_in_executor(self._pool, self.run_tool, name, payload or {})
            return text, 0.0, False, False, {"tool": name}
        if action and action[0] == "answer":
            _, qid, answers, task, answer_info = action
        else:  # the single-step shape
            qid, answers, task, answer_info = action
        successes: List[bool] = list(
            await asyncio.gather(
                *[
                    loop.run_in_executor(self._pool, self._verify_one, task, a, answer_info)
                    for a in answers
                ]
            )
        )
        return successes, 0.0, True, False, {}


register_environment("tool-use", ToolEnv)
