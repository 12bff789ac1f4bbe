"""Port parity of the rollout half's single-process parts: the math
grader, the prompt dataset and its loader, the single-step math agent,
the gserver manager's quota and staleness counters and its routing, and
the FFD micro-batch packing.

Every check feeds the same inputs to the reference (``areal_tpu``) and
the port (``areal_tpu_torch``) and asks for equal results: verdicts, token
ids, orders, trajectories (``sample_to_json``), JSON bodies and route
choices are discrete, so the tolerance is exact equality. Managers are
built with ``__new__`` and the attributes their routing and counters
read, as ``tests/system/test_routing.py`` builds the reference's.
"""

import asyncio
import collections
import dataclasses
import json
import threading

import numpy as np
import pytest

from areal_tpu.agents.envs import MathCodeSingleStepEnv as RefEnv
from areal_tpu.agents.math_single_step import MathSingleStepAgent as RefAgent
from areal_tpu.api import data_api as rdata
from areal_tpu.api import model_api as rmodel
from areal_tpu.api.system_api import GserverManagerConfig as RefManagerConfig
from areal_tpu.base import datapack as rpack
from areal_tpu.datasets.math_code_prompt import MATHCodePromptDataset as RefDataset
from areal_tpu.functioncall.math_grader import grade_answer as ref_grade
from areal_tpu.ops import host_ops
from areal_tpu.system import gserver_manager as rgm
from areal_tpu_torch.agents.envs import MathCodeSingleStepEnv as PortEnv
from areal_tpu_torch.agents.math_single_step import MathSingleStepAgent as PortAgent
from areal_tpu_torch.api import data_api as tdata
from areal_tpu_torch.api import model_api as tmodel
from areal_tpu_torch.api.system_api import GserverManagerConfig as PortManagerConfig
from areal_tpu_torch.base import datapack as tpack
from areal_tpu_torch.datasets.math_code_prompt import MATHCodePromptDataset as PortDataset
from areal_tpu_torch.functioncall.math_grader import grade_answer as port_grade
from areal_tpu_torch.system import gserver_manager as tgm
from tests import fixtures

GRADE_CASES = [
    ("The answer is \\boxed{42}", ["42"]),
    ("so we get \\boxed{\\frac{1}{2}}", ["0.5"]),
    ("\\boxed{50\\%}", ["0.5"]),
    ("x = 5", ["5"]),
    ("the answer is (C)", ["c"]),
    ("\\boxed{(1, 2)}", ["(1,2)"]),
    ("\\boxed{[0, 1) \\cup (2, 3]}", ["[0,1)\\cup(2,3]"]),
    ("\\boxed{\\begin{pmatrix} 1 & 2 \\\\ 3 & 4 \\end{pmatrix}}", ["[[1,2],[3,4]]"]),
    ("\\boxed{\\sqrt{4}}", ["2"]),
    ("\\boxed{2x + 3x}", ["5x"]),
    ("it is 3.14159", ["\\pi"]),
    ("\\boxed{7}", ["8"]),
    ("no number here", ["1"]),
    ("\\boxed{\\pm 2}", ["2, -2"]),
    ("\\boxed{1000}", ["1,000"]),
    ("\\boxed{\\text{yes}}", ["yes"]),
]


@pytest.mark.parametrize("text,solutions", GRADE_CASES)
def test_grade_answer_matches_reference(text, solutions):
    assert port_grade(text, solutions) == ref_grade(text, solutions)


@pytest.fixture(scope="module")
def prompts(tmp_path_factory):
    """A math/code prompt file and the tiny tokenizer trained on it."""
    tmp = tmp_path_factory.mktemp("prompts")
    rows = fixtures.make_math_code_rows(30, seed=5)
    path = fixtures.write_jsonl(rows, tmp / "prompts.jsonl")
    # The agent's answers below must decode to what the grader reads.
    tok = fixtures.train_tiny_tokenizer([r["prompt"] for r in rows] + ["\\boxed{42} 7"], tmp)
    return path, tok


def _datasets(prompts, seed=7, dp_rank=0, world_size=1, **kw):
    path, tok = prompts
    ref = RefDataset(rdata.DatasetUtility(seed=seed, dp_rank=dp_rank, world_size=world_size,
                                          tokenizer=tok), dataset_path=path, **kw)
    port = PortDataset(tdata.DatasetUtility(seed=seed, dp_rank=dp_rank, world_size=world_size,
                                            tokenizer=tok), dataset_path=path, **kw)
    return ref, port


@pytest.mark.parametrize("dp_rank,world_size", [(0, 1), (1, 3)])
def test_prompt_dataset_matches_reference(prompts, dp_rank, world_size):
    ref, port = _datasets(prompts, dp_rank=dp_rank, world_size=world_size, max_length=12)
    assert len(port) == len(ref) > 0
    assert port.ids == ref.ids
    assert port.prompts == ref.prompts
    for i in range(len(ref)):
        a, b = ref[i], port[i]
        assert tdata.sample_to_json(b) == rdata.sample_to_json(a)


def test_prompt_dataset_filter_matches_reference(prompts):
    ref, port = _datasets(prompts, filter_threshold=0.5, max_filter_percentage=0.3)
    rng = np.random.default_rng(3)
    scores = {i: float(s) for i, s in zip(ref.ids, rng.random(len(ref.ids)))}
    for _ in range(2):
        ref.filter(scores)
        port.filter(scores)
        assert port.active_indices == ref.active_indices
    assert len(port) < len(port.prompts)


def test_packed_data_loader_order_matches_reference(prompts):
    ref, port = _datasets(prompts)
    rl = rdata.PackedDataLoader(ref, batch_size=4, shuffle=True, seed=11)
    pl = tdata.PackedDataLoader(port, batch_size=4, shuffle=True, seed=11)
    for step in range(2 * len(rl) + 1):
        (rb, rlast), (pb, plast) = rl.next_batch(), pl.next_batch()
        assert (pb.ids, plast) == (rb.ids, rlast), step
        # The curriculum filter shrinks the set mid-epoch on both sides.
        if step == 3:
            ref.active_indices.pop(0)
            port.active_indices.pop(0)
    assert pl.state_dict() == rl.state_dict()


def _bundle(pkg, tok, prompt_ids):
    """A fixed group of 3: a correct, a wrong and a truncated answer."""
    answers = ["alpha \\boxed{42}", "beta \\boxed{7}", "gamma"]
    outs = []
    for i, a in enumerate(answers):
        ids = tok(a)["input_ids"]
        outs.append(pkg.APIGenerateOutput(
            qid="q", prompt_ids=list(prompt_ids), input_ids=list(prompt_ids), output_ids=ids,
            output_logprobs=[-0.5 - 0.1 * j for j in range(len(ids))], no_eos=i == 2,
            version_start=1, version_end=2 + i))
    return pkg.BundledGenerationOutputs.from_api_outputs(outs)


async def _episode(agent, env, prompt, bundle):
    obs, act = asyncio.Queue(), asyncio.Queue()

    async def serve():
        qid, prompt_ids, gconfig = await obs.get()
        assert prompt_ids == bundle.prompt_ids and gconfig.n == 3
        await act.put(bundle)

    server = asyncio.create_task(serve())
    trajs = await agent.collect_trajectory(prompt, env, obs, act)
    await server
    return trajs


@pytest.mark.parametrize("lb", [0.0, 0.5])
def test_math_agent_trajectory_matches_reference(prompts, lb):
    _, tok = prompts
    prompt_ids = tok("what is six times seven")["input_ids"]
    meta = dict(tasks=["math"], solutions=[["42"]], query_ids=["q"])
    trajs = {}
    for name, pkg, data, agent_cls, env_cls in (
            ("ref", rmodel, rdata, RefAgent, RefEnv),
            ("port", tmodel, tdata, PortAgent, PortEnv)):
        prompt = data.SequenceSample.from_default(
            ids=["q"], seqlens=[len(prompt_ids)],
            data=dict(packed_prompts=np.asarray(prompt_ids, np.int32)), metadata=dict(meta))
        agent = agent_cls(gconfig=dict(n=3, max_new_tokens=8), tokenizer=tok,
                          success_rate_lb=lb, success_rate_ub=1.0)
        out = asyncio.run(_episode(agent, env_cls(max_workers=2), prompt,
                                   _bundle(pkg, tok, prompt_ids)))
        trajs[name] = [data.sample_to_json(t) for t in out]
    assert trajs["port"] == trajs["ref"]
    # One correct answer in three: a group inside [0, 1] is kept, and one
    # whose success rate is below 0.5 is dropped.
    assert len(trajs["port"]) == (1 if lb == 0.0 else 0)
    if trajs["port"]:
        assert trajs["port"][0]["data"]["rewards"] == [5.0, -5.0, -5.0]


# ---------------------------------------------------------------------------
# The gserver manager
# ---------------------------------------------------------------------------

A, B, C = "http://a:1", "http://b:2", "http://c:3"


def _ref_manager(policy="round_robin", urls=(A, B, C), **cfg_kw):
    m = rgm.GserverManager.__new__(rgm.GserverManager)
    m.cfg = RefManagerConfig(n_servers=len(urls), schedule_policy=policy, **cfg_kw)
    m.server_urls = list(urls)
    m._healthy = set(urls)
    m._rr = 0
    m._lock = threading.Lock()
    m._server_reqs = {u: 0 for u in urls}
    m._server_tokens = {u: 0.0 for u in urls}
    m._server_tokens_pending = {u: 0.0 for u in urls}
    m._server_shed_until = {u: 0.0 for u in urls}
    m._server_shed_total = {u: 0.0 for u in urls}
    m._affinity = collections.OrderedDict()
    m._kv_index_size = 0
    m._prefix_index = collections.OrderedDict()
    m._server_kv_index = {}
    m._server_roles = {u: "unified" for u in urls}
    m._server_queued_toks = {u: 0.0 for u in urls}
    m._server_free_pages = {}
    m._server_total_pages = {}
    m._server_elastic = {}
    m._server_shards = {}
    m._rerole_orig = {}
    m._rerole_log = []
    m._draining = set()
    m._drain_deadline = {}
    m._join_t0 = {}
    m._join_info = {}
    m.weight_version = 0
    return m


def _port_manager(policy="round_robin", urls=(A, B, C), **cfg_kw):
    m = tgm.GserverManager.__new__(tgm.GserverManager)
    m.cfg = PortManagerConfig(n_servers=len(urls), schedule_policy=policy, **cfg_kw)
    m.server_urls = list(urls)
    m._healthy = set(urls)
    m._rr = 0
    m._lock = threading.Lock()
    m._server_reqs = {u: 0 for u in urls}
    m._server_tokens = {u: 0.0 for u in urls}
    m._server_tokens_pending = {u: 0.0 for u in urls}
    m._server_shed_until = {u: 0.0 for u in urls}
    m._server_shed_total = {u: 0.0 for u in urls}
    m._affinity = collections.OrderedDict()
    m.weight_version = 0
    return m


def _script(m, policy):
    """A scripted routing sequence touching every branch the port has:
    base policy placement, load snapshots, qid affinity across a version
    bump, the sticky hint, a shed window and saturation spill, eviction."""
    out = []
    route = lambda **meta: out.append(m._route(meta)[:2])  # noqa: E731
    for i in range(4):
        route(qid=f"s{i}/0", prompt_len=10 * (i + 1), new_token_budget=16)
    m._server_tokens.update({A: 500.0, B: 20.0, C: 90.0})
    m._server_reqs.update({A: 5, B: 1, C: 3})
    m._server_tokens_pending.update({A: 0.0, B: 0.0, C: 0.0})
    for i in range(3):
        route(qid=f"t{i}/0", prompt_len=5, new_token_budget=8)
    m.weight_version = 3
    route(qid="s0/0", prompt_len=50, new_token_budget=16)  # affinity
    route(previous_server_url=C, previous_version=3, prompt_len=5)  # sticky
    route(previous_server_url=C, previous_version=2, prompt_len=5)  # stale hint
    held = m._affinity["s1/0"]
    m._server_shed_until[held] = float("inf")
    route(qid="s1/0", prompt_len=5)  # holder shedding -> spill
    m._server_shed_until[held] = 0.0
    m.cfg.affinity_saturation_requests = 2
    m._server_reqs[held] = 7
    route(qid="s1/0", prompt_len=5)  # holder saturated -> spill
    m._healthy.discard(B)
    m._affinity = collections.OrderedDict((q, u) for q, u in m._affinity.items() if u != B)
    for i in range(3):
        route(qid=f"u{i}/0", prompt_len=7)
    return out


@pytest.mark.parametrize("policy", ["round_robin", "least_requests", "least_token_usage"])
def test_route_choices_match_reference(policy):
    ref = _script(_ref_manager(policy), policy)
    port = _script(_port_manager(policy), policy)
    assert port == ref
    policies = {p for _, p in port}
    assert {"affinity", "sticky", "spill", policy} <= policies


def test_no_healthy_server_matches_reference():
    ref, port = _ref_manager(), _port_manager()
    ref._healthy.clear()
    port._healthy.clear()
    assert port._route({"qid": "x"}) == ref._route({"qid": "x"}) == (None, "none", None, None)


class _Request:
    def __init__(self, body):
        self._body = body

    async def json(self):
        return dict(self._body)


def _counters(m):
    m.rollout_stat = (tgm if isinstance(m, tgm.GserverManager) else rgm).RolloutStat()
    m._worker_slots = {}
    m._training_samples_cache = 0
    calls = [("alloc", "w0")] * 9 + [("finish", "w0", True)] * 3 + [("finish", "w1", False)] \
        + [("alloc", "w1")] * 4 + [("samples", 16), ("version", 1)] + [("alloc", "w0")] * 8 \
        + [("finish", "w0", False)] * 2 + [("alloc", "w1")] * 3 + [("version", 3)] \
        + [("alloc", "w0")] * 2
    bodies = []
    for c in calls:
        if c[0] == "alloc":
            resp = asyncio.run(m._h_allocate(_Request({"worker": c[1]})))
        elif c[0] == "finish":
            resp = asyncio.run(m._h_finish(_Request({"worker": c[1], "accepted": c[2]})))
        elif c[0] == "samples":
            m._training_samples_cache = c[1]
            continue
        else:
            m.weight_version = c[1]
            continue
        bodies.append((json.loads(resp.text), m.rollout_stat.as_dict(), dict(m._worker_slots),
                       m.is_staled()))
    return bodies


@pytest.mark.parametrize("offpolicy,cap", [(0, None), (1, 6), (2, None)])
def test_allocate_finish_staleness_counters_match_reference(offpolicy, cap):
    kw = dict(train_batch_size=4, max_head_offpolicyness=offpolicy, max_concurrent_rollouts=cap)
    ref = _counters(_ref_manager(**kw))
    port = _counters(_port_manager(**kw))
    assert port == ref
    reasons = {b[0].get("reason") for b in port}
    assert "staled" in reasons and True in {b[0]["success"] for b in port}


# ---------------------------------------------------------------------------
# FFD micro-batch packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,capacity,min_groups", [(5, 100, 1), (40, 300, 4), (100, 1000, 3),
                                                    (200, 4096, 8)])
def test_ffd_allocate_matches_reference(n, capacity, min_groups):
    lengths = np.random.default_rng(n).integers(1, capacity // 2, n).tolist()
    lengths[0] = capacity + 7  # oversized: a bin of its own
    port = tpack.ffd_allocate(lengths, capacity, min_groups)
    assert port == rpack.ffd_allocate_py(lengths, capacity, min_groups)
    if host_ops.native_available(wait=True):
        assert port == host_ops.ffd_allocate_native(lengths, capacity, min_groups)


# ---------------------------------------------------------------------------
# The server's HF checkpoint and tokenizer
# ---------------------------------------------------------------------------


def test_server_serves_an_hf_checkpoint_with_its_tokenizer_eos(prompts, tmp_path):
    """``model_path`` loads the HF directory (config and weights, cast to
    the compute dtype the engine serves in) and the tokenizer found there
    gives the engine its EOS, as the reference's model factory reads it."""
    import torch

    from areal_tpu_torch import torch_dtype
    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.system_api import GenerationServerConfig
    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.models.hf import load_hf_model, save_hf_model
    from areal_tpu_torch.models.hf.qwen2 import r1_distill_qwen_1_5b_config
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system.generation_server import GenerationServer

    _, tok = prompts
    cfg = r1_distill_qwen_1_5b_config(n_layers=2, hidden_dim=64, n_q_heads=4, n_kv_heads=2,
                                      head_dim=16, intermediate_dim=128, vocab_size=256,
                                      max_position_embeddings=1024)
    hf_dir = str(tmp_path / "hf")
    save_hf_model(hf_dir, cfg, init_params(cfg, seed=3, device="cpu"), "qwen2")
    tok.save_pretrained(hf_dir)
    saved = name_resolve._default.repo
    name_resolve.reconfigure("nfs", record_root=str(tmp_path / "nr"))
    server = GenerationServer()
    try:
        server._configure(GenerationServerConfig(
            experiment_name="hf", trial_name="t0", device="cpu", max_seq_len=128,
            max_concurrent_requests=2, kv_page_size=16,
            model=ModelAbstraction("tpu_transformer", args=dict(model_path=hf_dir))))
        want_cfg, want = load_hf_model(hf_dir)
        assert dataclasses.asdict(server.engine.cfg) == dataclasses.asdict(want_cfg)
        assert server.engine.eos_token_id == tok.eos_token_id is not None
        got = server.engine.params
        dtype = torch_dtype(want_cfg.compute_dtype)
        for key in ("embedding", "head"):
            assert got[key]["weight"].dtype == dtype
            assert torch.equal(got[key]["weight"], want[key]["weight"].to(dtype))
    finally:
        server._exit_hook()
        name_resolve._default.repo.reset()
        name_resolve._default.repo = saved
