"""Local code-correctness verification (the port's copy of
``areal_tpu/functioncall/code_verify.py``): every case runs the candidate
in a fresh subprocess with CPU and memory rlimits, a kill on timeout and
a preamble that disables the most dangerous host escapes. Standard-input
problems compare stdout token by token (float tolerant); call-based ones
(``fn_name``) call the candidate's function with the case's JSON args.
``code_verify`` returns overall pass/fail, ``run_test_cases`` the
per-case outcomes."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
from typing import Any, Dict, List, Optional, Tuple

DEFAULT_TIMEOUT = 8.0
FLOAT_TOL = 1e-6

_GUARD_PREAMBLE = """\
import resource, sys
resource.setrlimit(resource.RLIMIT_AS, ({mem}, {mem}))
resource.setrlimit(resource.RLIMIT_CPU, ({cpu}, {cpu}))
sys.setrecursionlimit(100000)
import builtins as _b
import os as _os
for _name in ("system", "popen", "execv", "execve", "execvp", "fork",
              "kill", "killpg", "removedirs", "rmdir", "unlink", "remove",
              "rename", "renames", "truncate", "replace", "chmod", "chown"):
    if hasattr(_os, _name):
        setattr(_os, _name, None)
_os.environ.clear()
"""


def extract_code_block(text: str) -> Optional[str]:
    """Last fenced code block (``` or ```python), else None."""
    blocks = re.findall(r"```(?:python|py)?\n(.*?)```", text, re.DOTALL)
    return blocks[-1] if blocks else None


def _driver_for_call(fn_name: str) -> str:
    """Appended to a call-based candidate: call fn with JSON args from
    argv file, print JSON result on the last line."""
    return f"""
if __name__ == "__main__":
    import json as _json, sys as _sys
    _args = _json.loads(_sys.stdin.read())
    _fn = globals().get({fn_name!r})
    if _fn is None and "Solution" in globals():
        _fn = getattr(Solution(), {fn_name!r}, None)
    if _fn is None:
        raise SystemExit("function {fn_name} not found")
    _res = _fn(*_args)
    print("\\n___CALL_RESULT___")
    print(_json.dumps(_res))
"""


def run_one_case(
    code: str,
    stdin_data: str,
    timeout: float = DEFAULT_TIMEOUT,
    fn_name: Optional[str] = None,
    mem_bytes: int = 2 << 30,
) -> Tuple[bool, str, str]:
    """Execute one case in a fresh subprocess; (ok, stdout, err)."""
    preamble = _GUARD_PREAMBLE.format(mem=mem_bytes, cpu=int(timeout) + 2)
    body = preamble + code
    if fn_name:
        body += _driver_for_call(fn_name)
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(body)
        path = f.name
    try:
        proc = subprocess.run(
            [sys.executable, path],
            input=stdin_data,
            capture_output=True,
            text=True,
            timeout=timeout,
            cwd=tempfile.gettempdir(),
        )
        return proc.returncode == 0, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired:
        return False, "", "timeout"
    finally:
        os.unlink(path)


def _tokens_match(a: str, b: str) -> bool:
    if a == b:
        return True
    try:
        return abs(float(a) - float(b)) <= FLOAT_TOL * max(
            1.0, abs(float(b))
        )
    except ValueError:
        return False


def _stdout_matches(got: str, expected: str) -> bool:
    """Line-by-line, token-by-token; numeric tokens compared with float
    tolerance (reference testing_util's custom_compare behavior)."""
    gl = [line.split() for line in got.rstrip().splitlines() if line.strip()]
    el = [
        line.split() for line in expected.rstrip().splitlines() if line.strip()
    ]
    if len(gl) != len(el):
        return False
    for gr, er in zip(gl, el):
        if len(gr) != len(er):
            return False
        if not all(_tokens_match(x, y) for x, y in zip(gr, er)):
            return False
    return True


def _values_match(got: Any, expected: Any) -> bool:
    """Structural compare of call-based results with float tolerance;
    tuples (JSON arrays) and lists compare interchangeably."""
    if isinstance(got, (int, float)) and isinstance(expected, (int, float)):
        return abs(float(got) - float(expected)) <= FLOAT_TOL * max(
            1.0, abs(float(expected))
        )
    if isinstance(got, (list, tuple)) and isinstance(expected, (list, tuple)):
        return len(got) == len(expected) and all(
            _values_match(x, y) for x, y in zip(got, expected)
        )
    if isinstance(got, dict) and isinstance(expected, dict):
        return set(got) == set(expected) and all(
            _values_match(got[k], expected[k]) for k in got
        )
    return got == expected


def normalize_test_cases(obj) -> Tuple[List[Dict[str, Any]], Optional[str]]:
    """Accept the dataset wire format {"inputs": [...], "outputs": [...],
    "fn_name"?} (reference math_code_dataset rows) or an explicit list of
    {input, output} dicts. Returns (cases, fn_name)."""
    if isinstance(obj, str):
        obj = json.loads(obj)
    if isinstance(obj, dict) and "inputs" in obj:
        fn = obj.get("fn_name") or (obj.get("metadata") or {}).get("fn_name")
        return (
            [
                {"input": i, "output": o}
                for i, o in zip(obj["inputs"], obj["outputs"])
            ],
            fn,
        )
    return list(obj), None


def run_test_cases(
    solution_text: str,
    test_cases,
    timeout: float = DEFAULT_TIMEOUT,
    max_cases: Optional[int] = None,
    stop_on_first_failure: bool = False,
) -> List[bool]:
    """Per-case pass/fail for the extracted program (empty list when no
    code block is present). With `stop_on_first_failure`, remaining cases
    after the first failure are recorded False without being run — wrong
    candidates (most early-RL rollouts) must not cost N * timeout."""
    cases, fn_name = normalize_test_cases(test_cases)
    if max_cases is not None:
        cases = cases[:max_cases]
    code = extract_code_block(solution_text)
    if code is None:
        return [False] * len(cases)
    results: List[bool] = []
    for ci, case in enumerate(cases):
        if stop_on_first_failure and results and not results[-1]:
            results.extend([False] * (len(cases) - ci))
            break
        if fn_name:
            args = case.get("input", [])
            ok, out, _ = run_one_case(
                code, json.dumps(args), timeout, fn_name=fn_name
            )
            if not ok or "___CALL_RESULT___" not in out:
                results.append(False)
                continue
            payload = out.rsplit("___CALL_RESULT___", 1)[1].strip()
            try:
                got = json.loads(payload)
            except json.JSONDecodeError:
                results.append(False)
                continue
            expected = case.get("output")
            # dataset wire format wraps the expected value in a 1-list
            if isinstance(expected, list) and len(expected) == 1:
                ok_val = _values_match(got, expected[0]) or _values_match(
                    got, expected
                )
            else:
                ok_val = _values_match(got, expected)
            results.append(bool(ok_val))
        else:
            stdin_data = case.get("input", "")
            if isinstance(stdin_data, list):
                stdin_data = "\n".join(map(str, stdin_data))
            expected = case.get("output", "")
            if isinstance(expected, list):
                expected = "\n".join(map(str, expected))
            ok, out, _ = run_one_case(code, stdin_data, timeout)
            results.append(bool(ok) and _stdout_matches(out, expected))
    return results


def code_verify(
    solution_text: str,
    test_cases,
    timeout: float = DEFAULT_TIMEOUT,
    max_cases: Optional[int] = None,
) -> bool:
    """True if the extracted program passes every case."""
    results = run_test_cases(
        solution_text, test_cases, timeout, max_cases,
        stop_on_first_failure=True,
    )
    return bool(results) and all(results)
