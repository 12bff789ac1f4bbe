"""The port's agentic rollout pieces against the reference's, on the
same seeded inputs: ``parse_tool_call``, ``_calc_eval`` and ``ToolEnv``'s
observations; the ``ToolUseAgent``, ``MathMultiTurnAgent`` and
``NullAgent`` trajectories, with the same scripted generation bundles fed
to both packages and every ``SequenceSample`` field held equal; the
python-answer verdicts; and ``RewardModelingPairedDataset``'s ids and
tokens. No pooled executor is registered here, so the python tool runs
in the local sandbox in both packages (the executor has its own file).
"""

import asyncio

import numpy as np
import pytest

import chip_smoke
from areal_tpu.agents import envs as jenvs
from areal_tpu.agents import math_multi_turn as jmmt
from areal_tpu.agents import null as jnull
from areal_tpu.agents import tool_use as jtool
from areal_tpu.api import data_api as jdata_api
from areal_tpu.api import model_api as jmodel_api
from areal_tpu.datasets import rw_paired as jrw
from areal_tpu.functioncall import python_answer as jpa
from areal_tpu.functioncall import remote as jremote
from areal_tpu_torch.agents import envs as tenvs
from areal_tpu_torch.agents import math_multi_turn as tmmt
from areal_tpu_torch.agents import null as tnull
from areal_tpu_torch.agents import tool_use as ttool
from areal_tpu_torch.api import data_api as tdata_api
from areal_tpu_torch.api import model_api as tmodel_api
from areal_tpu_torch.api.agent_api import make_agent
from areal_tpu_torch.api.env_api import make_env
from areal_tpu_torch.datasets import rw_paired as trw
from areal_tpu_torch.functioncall import python_answer as tpa
from areal_tpu_torch.functioncall import remote as tremote

PKGS = {
    "ref": dict(envs=jenvs, mmt=jmmt, null=jnull, tool=jtool, data=jdata_api, model=jmodel_api),
    "port": dict(envs=tenvs, mmt=tmmt, null=tnull, tool=ttool, data=tdata_api, model=tmodel_api),
}


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    from transformers import AutoTokenizer

    d = tmp_path_factory.mktemp("tok")
    chip_smoke.tiny_tokenizer(np.random.default_rng(0), str(d), 60)
    return AutoTokenizer.from_pretrained(str(d))


@pytest.fixture(autouse=True)
def no_executor_pool():
    tremote.register_executor_pool(None)
    jremote.register_executor_pool(None)


# ----------------------------------------------------------------------
# Tool parsing, the calculator, the env's observations
# ----------------------------------------------------------------------

TOOL_TEXTS = [
    "no tool here",
    "<tool:python>print(6 * 7)</tool>",
    "first <tool:calculator>2 ** 10</tool> then <tool:search>x</tool>",
    '<tool:python>{"code": "print(1)", "stdin": "3"}</tool>',
    "<tool:python>{not json}</tool>",
    "<tool:unknown_tool> body </tool>",
    "<tool:search>\n  what is the answer \n</tool>",
    "<tool:python>[1, 2]</tool>",
    "<tool:calculator>1+</tool",
]


@pytest.mark.parametrize("text", TOOL_TEXTS)
def test_parse_tool_call_matches_reference(text):
    assert ttool.parse_tool_call(text) == jtool.parse_tool_call(text)


CALC_EXPRS = ["6 * 7", "2 ** 10", "-3 + 4 / 8", "7 // 2 % 3", "+5", "2 ** 65", "1.5 * 4",
              "__import__('os')", "x + 1", "1 / 0", "(1 + 2) * (3 - 4)", "3 ** -2"]


@pytest.mark.parametrize("expr", CALC_EXPRS)
def test_calc_eval_matches_reference(expr):
    def run(f):
        try:
            return ("ok", f(expr))
        except Exception as e:
            return (type(e).__name__, str(e))

    assert run(tenvs._calc_eval) == run(jenvs._calc_eval)


TOOL_CALLS = [
    ("calculator", {"expr": "6 * 7"}),
    ("calculator", {"expr": "2 ** 100"}),
    ("calculator", {}),
    ("search", {"query": "Capital of France"}),
    ("search", {"query": "nothing matches"}),
    ("search", {"query": ""}),
    ("python", {"code": "print(6 * 7)"}),
    ("python", {"code": "import sys; print(sys.stdin.read()[::-1])", "stdin": "abc"}),
    ("python", {"code": "raise ValueError('boom')"}),
    ("nope", {}),
]


@pytest.mark.parametrize("i", range(len(TOOL_CALLS)))
def test_tool_env_observations_match_reference(i):
    name, payload = TOOL_CALLS[i]
    corpus = {"capital of france": "Paris", "answer": "42"}
    envs = [m.ToolEnv(max_workers=2, search_corpus=corpus) for m in (tenvs, jenvs)]
    got, want = (asyncio.run(e.step(("tool", "q0", name, dict(payload)))) for e in envs)
    if name == "python" and "boom" in payload["code"]:
        # The error text carries the sandbox's temporary file name.
        assert got[0].startswith("error:") and want[0].startswith("error:")
        assert "ValueError: boom" in got[0] and "ValueError: boom" in want[0]
        got, want = got[1:], want[1:]
    assert got == want


def test_tool_env_answers_grade_like_the_single_step_env():
    action = ("answer", "q0", ["the answer is \\boxed{42}", "so 41", "\\boxed{6*7}"], "math",
              ["\\boxed{42}"])
    got = asyncio.run(tenvs.ToolEnv().step(action))
    want = asyncio.run(jenvs.ToolEnv().step(action))
    assert got == want and got[0] == [True, False, True] and got[2] is True
    single = asyncio.run(tenvs.ToolEnv().step(action[1:]))
    assert single == got
    assert isinstance(make_env("tool-use"), tenvs.ToolEnv)


# ----------------------------------------------------------------------
# Agent trajectories on scripted bundles
# ----------------------------------------------------------------------


def scripted_outputs(tok, n, seed):
    """`n` generated outputs: seeded token ids, with a boxed answer in
    some of them, each with its logprobs and an EOS flag."""
    rng = np.random.default_rng(seed)
    vocab = len(tok)
    outs = []
    for i in range(n):
        ids = [int(x) for x in rng.integers(2, vocab, int(rng.integers(3, 9)))]
        if i % 3 == 1:
            ids += tok("so \\boxed{42}", add_special_tokens=False)["input_ids"]
        lps = (-rng.random(len(ids)) * 3).astype(np.float32).tolist()
        outs.append((ids, lps, bool(rng.random() < 0.3), i // 2, i // 2 + int(rng.integers(0, 2))))
    return outs


async def drive(agent, env, prompt, outputs, model_mod):
    """Run one episode with a scripted generator on the queues; returns
    (trajectories, the requests the agent made)."""
    obs_q, act_q = asyncio.Queue(), asyncio.Queue()
    requests = []

    async def gen():
        for ids, lps, no_eos, v0, v1 in outputs:
            qid, prompt_ids, gconfig = await obs_q.get()
            requests.append((qid, list(prompt_ids), gconfig.n, gconfig.max_new_tokens))
            seq = list(prompt_ids) + ids
            await act_q.put(model_mod.BundledGenerationOutputs(
                qid=qid, prompt_ids=list(prompt_ids), seqs=[seq],
                logprobs=[[0.0] * len(prompt_ids) + lps], no_eos=[no_eos],
                version_start=[v0], version_end=[v1]))
        await asyncio.Event().wait()

    task = asyncio.create_task(gen())
    try:
        trajs = await agent.collect_trajectory(prompt, env, obs_q, act_q)
    finally:
        task.cancel()
    return trajs, requests


def prompt_sample(data_mod, tok, qid, task="math", solutions=("\\boxed{42}",)):
    ids = np.asarray(tok("what is 6 times 7", add_special_tokens=False)["input_ids"], np.int32)
    return data_mod.SequenceSample(
        ids=[qid], keys={"packed_prompts"}, data={"packed_prompts": ids},
        seqlens={"packed_prompts": [[len(ids)]]},
        metadata={"tasks": [task], "solutions": [list(solutions)]})


def assert_samples_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.ids == w.ids and g.keys == w.keys
        assert g.seqlens == w.seqlens
        assert g.metadata == w.metadata
        for k in w.keys:
            assert np.asarray(g.data[k]).dtype == np.asarray(w.data[k]).dtype, k
            np.testing.assert_array_equal(g.data[k], w.data[k], err_msg=k)


AGENT_CASES = {
    "tool_use_scripted": ("tool", dict(num_turns=3, scripted_tool_turns=2,
                                       turn_level_discount=0.9), 3),
    "tool_use_unscripted": ("tool", dict(num_turns=4, scripted_tool_turns=0), 4),
    "multi_turn": ("mmt", dict(num_turns=3, turn_level_discount=0.8), 3),
    "multi_turn_no_stop": ("mmt", dict(num_turns=3, stop_on_success=False,
                                       reward_scaling=2.0, reward_bias=0.5), 3),
    "null": ("null", dict(episode_length=3, reward=0.25), 3),
}


@pytest.mark.parametrize("case", sorted(AGENT_CASES))
def test_agent_trajectories_match_reference(tok, case):
    kind, kw, n_out = AGENT_CASES[case]
    outputs = scripted_outputs(tok, n_out, seed=len(case))
    results = {}
    for name, m in PKGS.items():
        gconfig = m["model"].GenerationHyperparameters(max_new_tokens=16, n=2)
        cls = {"tool": m["tool"].ToolUseAgent, "mmt": m["mmt"].MathMultiTurnAgent,
               "null": m["null"].NullAgent}[kind]
        agent = cls(gconfig=gconfig, tokenizer=tok, **kw)
        env = (m["envs"].ToolEnv(max_workers=2) if kind == "tool"
               else m["envs"].MathCodeSingleStepEnv(max_workers=2))
        prompt = prompt_sample(m["data"], tok, "q7")
        results[name] = asyncio.run(drive(agent, env, prompt, outputs, m["model"]))
    (got, got_req), (want, want_req) = results["port"], results["ref"]
    assert got_req == want_req
    assert_samples_equal(got, want)
    if kind == "tool":
        meta = got[0].metadata
        assert meta["task"] == ["agentic"] and meta["turns"][0] == len(got_req)
        if case == "tool_use_scripted":
            assert meta["turns"] == [3] and meta["tool_calls"] == [2]
            # Turn k's prompt is turn k-1's sequence plus the tool output.
            for (_, p0, _, _), (_, p1, _, _), out in zip(got_req, got_req[1:], outputs):
                assert p1[:len(p0) + len(out[0])] == p0 + out[0]
                assert "42" in tok.decode(p1[len(p0) + len(out[0]):])
        else:
            # Seeded tokens hold no tool syntax: turn 0 is the answer.
            assert meta["turns"] == [1] and meta["tool_calls"] == [0]
    else:
        assert len(got_req) >= 2


def test_agents_are_registered_under_the_reference_names(tok):
    for name, cls in (("tool-use", ttool.ToolUseAgent), ("math-multi-turn", tmmt.MathMultiTurnAgent),
                      ("null", tnull.NullAgent)):
        assert isinstance(make_agent(name, tokenizer=tok), cls)


# ----------------------------------------------------------------------
# Python answers and the paired reward-modelling dataset
# ----------------------------------------------------------------------

PY_TEXTS = [
    ("```python\ndef solution():\n    return 6 * 7\n```", "42"),
    ("Let me compute.\n```python\nprint(3)\nprint(40 + 2)\n```\nDone.", "\\boxed{42}"),
    ("x = 5\nprint(x * 2)\n```", "10"),
    ("```python\nprint('a')\n", "a"),
    ("no code at all", "1"),
    ("```python\nraise ValueError()\n```", "1"),
    ("def solution():\n    return 0.5", "\\frac{1}{2}"),
]


@pytest.mark.parametrize("i", range(len(PY_TEXTS)))
def test_python_answer_verdicts_match_reference(i):
    text, ref = PY_TEXTS[i]
    got = tpa.execute_python_answer(text, timeout=30.0)
    assert got == jpa.execute_python_answer(text, timeout=30.0)
    assert tpa.compare_python_answer(got, ref) == jpa.compare_python_answer(got, ref)


def test_python_answer_grades():
    assert tpa.grade_python_answer(PY_TEXTS[0][0], "42", timeout=30.0) is True
    assert tpa.grade_python_answer(PY_TEXTS[4][0], "1", timeout=30.0) is False


def test_rw_paired_dataset_matches_reference(tok):
    rng = np.random.default_rng(3)
    words = ["alpha", "beta", "gamma", "delta", "the", "answer", "is"]
    rows = [dict(id=f"r{i}", prompt=" ".join(rng.choice(words, 4)) + " ",
                 pos_answers=[" ".join(rng.choice(words, 3)) for _ in range(k)],
                 neg_answers=[" ".join(rng.choice(words, 2)) for _ in range(k)])
            for i, k in enumerate((1, 3, 2, 4))]
    got = trw.RewardModelingPairedDataset(tdata_api.DatasetUtility(seed=5, tokenizer=tok),
                                          max_length=12, dataset_builder=lambda: [dict(r) for r in rows])
    want = jrw.RewardModelingPairedDataset(jdata_api.DatasetUtility(seed=5, tokenizer=tok),
                                           max_length=12, dataset_builder=lambda: [dict(r) for r in rows])
    assert got.ids == want.ids and sorted(got.ids) == [r["id"] for r in rows]
    for i in range(len(rows)):
        assert_samples_equal([got[i]], [want[i]])
        assert got[i].seqlens["packed_input_ids"][0][0] <= 12
    assert tdata_api.DATASET_REGISTRY.make(
        "rw_pair", util=tdata_api.DatasetUtility(seed=5, tokenizer=tok), max_length=12,
        dataset_builder=lambda: [dict(r) for r in rows]).ids == got.ids
