"""Math answer verification: extraction, normalization, equivalence (the
port's copy of ``areal_tpu/functioncall/math_grader.py``).

Final answers are extracted (\\boxed{...}, "the answer is ...", the last
number), LaTeX-normalized and compared: numerically at 1e-4 relative
tolerance with percentage equivalence, element-wise for tuples, sets,
intervals and matrices, through equations and \\pm, and by sympy last:
on the pooled reward executor when one is registered and live
(``functioncall/remote.py``), else in a forked child with a hard
timeout. The module imports no ``torch``: the executor's sandbox
workers import it under their memory limit."""

from __future__ import annotations

import multiprocessing
import re
from typing import Any, List, Optional, Tuple

# The forked child pays a cold sympy import + parse before simplify; on
# a loaded machine (full test suite, busy CI) 3s starves legitimate
# equivalences into False. AREAL_SYMPY_TIMEOUT_S widens the budget
# without touching the production default (tests/conftest.py sets it).
from areal_tpu_torch.base import env_registry

SYMPY_TIMEOUT_S = env_registry.get_float("AREAL_SYMPY_TIMEOUT_S")
REL_TOL = 1e-4


# ---------------------------------------------------------------------------
# Extraction
# ---------------------------------------------------------------------------


def extract_boxed(text: str) -> Optional[str]:
    """Last \\boxed{...} / \\fbox{...} content, brace-aware."""
    best = None
    for m in re.finditer(r"\\(?:boxed|fbox)\s*\{", text):
        start = m.end()
        depth = 1
        i = start
        while i < len(text) and depth:
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
            i += 1
        if depth == 0:
            best = text[start : i - 1]
    return best


def extract_answer(text: str) -> Optional[str]:
    boxed = extract_boxed(text)
    if boxed is not None:
        return boxed
    # "The answer is X" patterns (commas allowed: "1,000,000"), else the
    # last number in the text.
    m = re.findall(
        r"(?:answer is|answer:)\s*([^\n;]+?)(?:\.\s|\.$|$)", text, re.IGNORECASE
    )
    if m:
        return m[-1].strip()
    nums = re.findall(r"-?\d+(?:\.\d+)?(?:/\d+)?", text)
    return nums[-1] if nums else None


def choice_clean(ans: str) -> Optional[str]:
    """Reduce a multiple-choice answer to its letter: "(C)", "C.", "c )"
    and trailing-choice phrasings all become "c"; None if not a choice."""
    s = ans.strip().rstrip(".").strip()
    m = re.fullmatch(r"\(?\s*([A-Ea-e])\s*\)?", s)
    if m:
        return m.group(1).lower()
    return None


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

_LATEX_STRIP = [
    (r"\\left\s*", ""), (r"\\right\s*", ""), (r"\\!", ""), (r"\\,", ""),
    (r"\\;", ""), (r"\\:", ""), (r"~", ""), (r"\\\$", ""), (r"\$", ""),
    (r"\\text\{([^}]*)\}", r"\1"),
    (r"\\mathrm\{([^}]*)\}", r"\1"), (r"\\mbox\{([^}]*)\}", r"\1"),
    (r"\\mathbf\{([^}]*)\}", r"\1"), (r"\\operatorname\{([^}]*)\}", r"\1"),
    (r"\\%", "%"),  # keep a bare % — _to_number reads it as a percentage
    (r"\\cdot", "*"), (r"\\times", "*"), (r"\\div", "/"),
    (r"\\pi", "pi"), (r"\\infty", "oo"), (r"\\infinity", "oo"),
    (r"dollars?", ""), (r"degrees?", ""),
    (r"\^\{\\circ\}", ""), (r"\^\\circ", ""), (r"\\circ", ""),
    (r"\\ ", " "),
]


def normalize_answer(ans: str) -> str:
    s = ans.strip()
    # Protect matrix row separators (\\) from the single-backslash rules.
    s = s.replace("\\\\", "\x00ROW\x00")
    for pat, rep in _LATEX_STRIP:
        s = re.sub(pat, rep, s)
    # \frac{a}{b} -> (a)/(b); \sqrt{a} -> sqrt(a); x^{y} -> x**(y)
    for _ in range(4):
        s = re.sub(r"\\[dt]?frac\{([^{}]*)\}\{([^{}]*)\}", r"((\1)/(\2))", s)
        s = re.sub(r"\\[dt]?frac(\d)(\d)", r"((\1)/(\2))", s)
        s = re.sub(r"\\sqrt\{([^{}]*)\}", r"sqrt(\1)", s)
        s = re.sub(r"\\sqrt(\d)", r"sqrt(\1)", s)
        s = re.sub(r"\^\{([^{}]*)\}", r"**(\1)", s)
    s = s.replace("^", "**")
    # keep matrix markers; everything else: braces -> parens
    parts = re.split(r"(\\(?:begin|end)\{(?:p|b)matrix\})", s)
    parts = [
        p if p.startswith("\\begin") or p.startswith("\\end")
        else p.replace("{", "(").replace("}", ")")
        for p in parts
    ]
    s = "".join(parts)
    s = re.sub(r"\\(?!(begin|end|cup|pm)\b)([a-zA-Z]+)", r"\2", s)
    s = s.replace("\x00ROW\x00", "\\\\")
    s = re.sub(r"\s+", "", s)
    s = s.rstrip(".").lstrip("+")
    # thousands separators: 1,234 / 1,000,000 -> digits (comma followed by
    # exactly three digits); bare pairs like "1,2" stay tuples
    if "(" not in s and "[" not in s:
        while re.search(r"\d,\d{3}(\D|$)", s):
            s = re.sub(r"(\d),(\d{3})(\D|$)", r"\1\2\3", s)
    return s.lower()


# ---------------------------------------------------------------------------
# Structured comparisons
# ---------------------------------------------------------------------------


def _to_number(s: str) -> Optional[float]:
    s = s.strip()
    pct = False
    if s.endswith("%"):
        pct = True
        s = s[:-1]
    try:
        v = float(s)
        return v / 100.0 if pct else v
    except ValueError:
        pass
    m = re.fullmatch(r"\(?\(?(-?\d+(?:\.\d+)?)\)?/\(?(-?\d+(?:\.\d+)?)\)?\)?", s)
    if m:
        denom = float(m.group(2))
        if denom != 0:
            v = float(m.group(1)) / denom
            return v / 100.0 if pct else v
    return None


def _numeric_equal(a: float, b: float) -> bool:
    return abs(a - b) <= REL_TOL * max(1.0, abs(a), abs(b))


def _numeric_equal_with_percent(a: float, b: float) -> bool:
    """Reference grader.py:101: a answer may be given as a percentage of
    the reference (or vice versa)."""
    return any(
        _numeric_equal(a, c) for c in (b, b / 100.0, b * 100.0)
    )


def _split_top_level_commas(s: str) -> List[str]:
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _parse_intervals(s: str) -> Optional[List[Tuple[str, str, str, str]]]:
    """"[2,5)\\cup(7,oo)" -> [("[", "2", "5", ")"), ...]; None if not an
    interval expression. Endpoints may contain balanced parens (e.g.
    normalized fractions)."""
    parts = re.split(r"\\cup|∪", s)
    out = []
    for p in parts:
        p = p.strip()
        if len(p) < 4 or p[0] not in "([" or p[-1] not in ")]":
            return None
        inner = _split_top_level_commas(p[1:-1])
        if len(inner) != 2 or not inner[0] or not inner[1]:
            return None
        out.append((p[0], inner[0], inner[1], p[-1]))
    return out if out else None


def _parse_matrix(s: str) -> Optional[List[List[str]]]:
    m = re.match(
        r"^\\begin\{(?:p|b)matrix\}(.*)\\end\{(?:p|b)matrix\}$", s, re.DOTALL
    )
    if not m:
        return None
    body = m.group(1)
    rows = [r for r in re.split(r"\\\\", body) if r.strip()]
    return [[c.strip() for c in row.split("&")] for row in rows]


def _strip_equation_lhs(s: str) -> str:
    """"x=5" -> "5" when the LHS is a bare variable."""
    m = re.match(r"^[a-z][a-z0-9_]{0,3}=(.+)$", s)
    return m.group(1) if m else s


def _expand_pm(s: str) -> Optional[Tuple[str, str]]:
    if "\\pm" in s:
        return s.replace("\\pm", "+", 1), s.replace("\\pm", "-", 1)
    if "±" in s:
        return s.replace("±", "+", 1), s.replace("±", "-", 1)
    return None


# ---------------------------------------------------------------------------
# Sympy symbolic equivalence (timeout-guarded subprocess)
# ---------------------------------------------------------------------------


def _sympy_equal_raw(a: str, b: str) -> bool:
    try:
        import sympy
        from sympy.parsing.sympy_parser import (
            implicit_multiplication_application,
            parse_expr,
            standard_transformations,
        )

        tf = standard_transformations + (implicit_multiplication_application,)
        ea = parse_expr(a, transformations=tf, evaluate=True)
        eb = parse_expr(b, transformations=tf, evaluate=True)
        if ea == eb:
            return True
        # numeric fallback before the expensive simplify
        try:
            if abs(float(ea.evalf()) - float(eb.evalf())) < 1e-6:
                return True
        except Exception:
            pass
        return bool(sympy.simplify(ea - eb) == 0)
    except Exception:
        return False


def _sympy_worker(a: str, b: str, q) -> None:
    q.put(_sympy_equal_raw(a, b))


def _sympy_equal_local(
    a: str, b: str, timeout: float = SYMPY_TIMEOUT_S
) -> bool:
    """Fork-per-call fallback path: sympy equivalence in a fresh child
    with a hard timeout — simplify() can hang on adversarial model
    outputs, and a stuck reward stalls the whole rollout pipeline
    (reference grader.py:337). Pays a cold sympy import every call; the
    pooled executor path amortizes that, but this MUST keep working
    standalone (no executor fleet in unit tests / small runs)."""
    ctx = multiprocessing.get_context("fork")
    q = ctx.Queue(1)
    p = ctx.Process(target=_sympy_worker, args=(a, b, q), daemon=True)
    try:
        p.start()
        p.join(timeout)
        if p.is_alive():
            p.terminate()
            p.join(1.0)
            return False
        return bool(q.get_nowait()) if not q.empty() else False
    except Exception:
        return False
    finally:
        if p.is_alive():
            p.kill()


def _sympy_equal(a: str, b: str, timeout: float = SYMPY_TIMEOUT_S) -> bool:
    """sympy equivalence, routed through the warm reward-executor pool
    when one is registered (functioncall/remote.py), so a hot grading
    path skips the cold fork and import; falls back to the local
    fork-per-call sandbox when no pool is registered, none is live, or
    the pooled job itself errors (an executor outage must degrade to
    slower grading, never to wrong grades)."""
    if len(a) > 400 or len(b) > 400:  # refuse adversarially long inputs
        return False
    from areal_tpu_torch.functioncall import remote

    pool = remote.get_executor_pool()
    if pool is not None and pool.available():
        res = pool.submit([{"kind": "sympy_equal", "a": a, "b": b}], timeout_s=timeout)[0]
        if res.get("ok"):
            return bool(res.get("equal"))
    return _sympy_equal_local(a, b, timeout)


# ---------------------------------------------------------------------------
# Top-level equivalence
# ---------------------------------------------------------------------------


def answers_equal(given: str, reference: str, tol: float = REL_TOL,
                  _depth: int = 0) -> bool:
    if _depth > 4:
        return False
    ng, nr = normalize_answer(str(given)), normalize_answer(str(reference))
    if not ng and not nr:
        return True
    if ng == nr:
        return True

    # multiple choice: compare letters when the reference is a choice
    cg, cr = choice_clean(str(given)), choice_clean(str(reference))
    if cr is not None and cg is not None:
        return cg == cr

    # numbers (incl. percentage equivalence)
    fg, fr = _to_number(ng), _to_number(nr)
    if fg is not None and fr is not None:
        return _numeric_equal_with_percent(fg, fr)

    # \pm expands to an unordered pair
    for s, other, flip in ((str(given), nr, False), (str(reference), ng, True)):
        pm = _expand_pm(s)
        if pm is not None:
            plus, minus = pm
            both = "(" + plus + "," + minus + ")"
            return answers_equal(
                both if not flip else other,
                other if not flip else both,
                tol, _depth + 1,
            )

    # intervals (bracket kinds must match; endpoints compared recursively).
    # Only binding when BOTH sides parse as intervals — "(1,2)" is also a
    # valid tuple, and a bare "1,2" reference must still match it below.
    ig, ir = _parse_intervals(ng), _parse_intervals(nr)
    if ig is not None and ir is not None:
        if len(ig) != len(ir):
            return False
        return all(
            lg == lr and hg == hr
            and answers_equal(ag, ar, tol, _depth + 1)
            and answers_equal(bg, br, tol, _depth + 1)
            for (lg, ag, bg, hg), (lr, ar, br, hr) in zip(ig, ir)
        )

    # matrices, element-wise; a matrix vs a tuple/list compares flattened
    # (reference grader.py:60 str_to_pmatrix upgrades "{1,2}" answers)
    mg, mr = _parse_matrix(ng), _parse_matrix(nr)
    if mg is not None and mr is not None:
        if len(mg) != len(mr) or any(
            len(a) != len(b) for a, b in zip(mg, mr)
        ):
            return False
        return all(
            answers_equal(a, b, tol, _depth + 1)
            for ra, rb in zip(mg, mr)
            for a, b in zip(ra, rb)
        )
    if (mg is None) != (mr is None):
        flat_m = [c for row in (mg or mr) for c in row]
        other = ng if mg is None else nr
        parts = [p for p in re.split(r"[(),\[\]]", other) if p]
        if len(parts) == len(flat_m):
            return all(
                answers_equal(a, b, tol, _depth + 1)
                for a, b in zip(flat_m, parts)
            )
        return False

    # equations: strip a bare-variable LHS from either side
    sg, sr = _strip_equation_lhs(ng), _strip_equation_lhs(nr)
    if (sg, sr) != (ng, nr):
        return answers_equal(sg, sr, tol, _depth + 1)

    # tuple/set-like answers: compare element-wise
    if ("," in ng) and ("," in nr):
        pg = [p for p in re.split(r"[(),\[\]]", ng) if p]
        pr = [p for p in re.split(r"[(),\[\]]", nr) if p]
        if len(pg) == len(pr) and pg:
            return all(
                answers_equal(x, y, tol, _depth + 1)
                for x, y in zip(pg, pr)
            )

    return _sympy_equal(ng, nr)


def compare_answers(ans: Optional[str], reference_answer: Any) -> bool:
    """Compare an already-extracted answer against the reference
    answer(s): list coercion, \\boxed{} unboxing of solution-form
    ground truth, and the equivalence rules of answers_equal. The ONE
    reference-normalization rule — every grading mode (text, PAL
    python execution) must route through it so identically-stored
    ground truth scores identically."""
    if ans is None:
        return False
    if isinstance(reference_answer, (list, tuple, set)):
        refs = list(reference_answer)
    else:  # str, int, float, ... — answers_equal str()s its inputs
        refs = [reference_answer]
    # Datasets often store ground truth in solution form ("\boxed{42}"):
    # unbox it so it compares against the extracted answer, not the
    # literal \boxed markup.
    refs = [
        b if (b := extract_boxed(str(r))) is not None else r for r in refs
    ]
    return any(answers_equal(ans, r) for r in refs)


def grade_answer(solution_text: str, reference_answer: Any) -> bool:
    """True if the final answer in `solution_text` matches the reference."""
    return compare_answers(
        extract_answer(str(solution_text)), reference_answer
    )
