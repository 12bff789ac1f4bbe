"""PAL-style python answer execution for offline evaluation (the port's
copy of ``areal_tpu/functioncall/python_answer.py``).

Every candidate program runs in a fresh subprocess under the code
verifier's rlimit and os-neutering guard (``code_verify.run_one_case``),
so a malicious or runaway program cannot touch the evaluator process.

Contract: extract the LAST fenced code block from the model output; if
it defines `solution()`, call it and use the repr of the return value
(PAL convention); otherwise run the block and use the last non-empty
stdout line (tora convention). Returns None when there is no code
block, execution fails, or nothing is produced.
"""

from __future__ import annotations

import re
from typing import Optional

from areal_tpu_torch.functioncall.code_verify import (
    extract_code_block,
    run_one_case,
)

_SOLUTION_DRIVER = """
if __name__ == "__main__":
    _fn = globals().get("solution")
    if _fn is not None:
        _res = _fn()
        print("\\n___PY_ANSWER___")
        print(repr(_res) if not isinstance(_res, str) else _res)
"""

_MARKER = "___PY_ANSWER___"


def _extract_candidate_code(text: str) -> Optional[str]:
    """The program to run: the last COMPLETE fenced block when one
    exists; otherwise the continuation of a fence the PROMPT opened —
    the 'pal' template ends with '```python\\n', so a compliant
    completion is bare code (optionally ending in a closing fence) with
    no opening fence of its own. Prose-only text returns None."""
    block = extract_code_block(text)
    if block is not None:
        return block
    m = re.search(r"```(?:python|py)?[ \t]*\n?", text)
    if m is not None:
        # One unterminated fence (complete blocks were handled above).
        # Opening or closing? A language tag, or nothing before it,
        # means the model OPENED a fence and was truncated — the code
        # is after. Otherwise the prompt opened the fence and this one
        # closes it — the code is before.
        tagged = text[m.start():m.end()].rstrip("\n \t") != "```"
        before = text[: m.start()]
        after = text[m.end():]
        if (tagged or not before.strip()) and after.strip():
            return after
        return before
    # No fence at all (generation hit the token budget before closing):
    # only accept it when it plausibly IS the program — a bare
    # solution() definition — never arbitrary prose.
    if "def solution" in text:
        return text
    return None


def _default_timeout() -> float:
    # Wall time a program, interpreter spawn included; on a loaded
    # machine the spawn alone can take seconds, so AREAL_PYEXEC_TIMEOUT
    # widens it without touching the default.
    from areal_tpu_torch.base import env_registry

    return env_registry.get_float("AREAL_PYEXEC_TIMEOUT")


def execute_python_answer(
    text: str, timeout: Optional[float] = None,
) -> Optional[str]:
    """Run the candidate program in `text` (see
    _extract_candidate_code); return its answer string or None."""
    if timeout is None:
        timeout = _default_timeout()
    code = _extract_candidate_code(text)
    if code is None:
        return None
    has_solution = "def solution" in code
    if has_solution:
        code = code + _SOLUTION_DRIVER
    ok, stdout, _err = run_one_case(code, stdin_data="", timeout=timeout)
    if not ok:
        return None
    if has_solution and _MARKER in stdout:
        tail = stdout.rsplit(_MARKER, 1)[1].strip()
        return tail.splitlines()[0].strip() if tail else None
    lines = [ln.strip() for ln in stdout.splitlines() if ln.strip()]
    return lines[-1] if lines else None


def compare_python_answer(ans: Optional[str], reference) -> bool:
    """Grade an already-executed answer with the math grader's shared
    reference-normalization rule (compare_answers), so text and python
    modes score identically-stored ground truth identically."""
    from areal_tpu_torch.functioncall.math_grader import compare_answers

    return compare_answers(ans, reference)


def grade_python_answer(
    text: str, reference, timeout: Optional[float] = None,
) -> bool:
    """Execute the candidate program and grade its answer."""
    return compare_python_answer(
        execute_python_answer(text, timeout=timeout), reference
    )
