"""Port parity of sync PPO end to end: ``main_sync_ppo``'s ``ppo-math``
experiment and the parts it adds to the port.

- ``PPOActorInterface.generate`` through both packages' engines on the
  same params, greedy, ``gconfig.n=2``: equal keys, seqlens, prompt
  masks and no-EOS masks, the behaviour logprobs in the shifted frame
  (``lp[len(prompt) - 1 : len(full) - 1]``) within atol 1e-4, and the
  version metadata.
- ``_best_of_k``: both packages, fed one fixed list of candidates, keep
  the same ones in the same order.
- The reward interface ("rw-math-code"), "fused-threading" (reward plus
  the reference logprob pass on one model) and ``PromptDataset``: equal
  outputs (rewards and scores exactly, logprobs within 1e-5).
- The param-realloc target of the model worker loads a port raw dump and
  a reference ``engine_state.pkl``; after each, the target's greedy
  tokens equal the reference generator's on the dumped params, and its
  optimizer moments are untouched. The "offload" hook offloads a train
  engine and passes over the mock engine, as the reference's.
- The experiment builds the reference's ``ppo-math`` DFG, shards and
  topology with and without a critic and a reference model; options the
  port lacks raise naming their ROADMAP item; the option dataclasses
  carry every reference field with its default.
- Both packages' ``ppo-math`` under their own ``LocalController``: 2
  greedy steps with a critic (HF checkpoints read through the float32
  family ``qwen2-f32`` of tests/test_torch_workers.py). Every
  ``ppo_actor/*`` and ``ppo_critic/*`` stat of each step within rtol
  1e-3 (atol 1e-6), equal generated sequences, equal rewards. The
  prompts' answers are the numbers below 50, so a response is graded
  right when its last number is one of them and the rewards mix +5 and
  -5 through the real grader. critic@0 is never updated (as in the reference: no hook
  joins it to critic@1): at both steps each package's ``critic_inf``
  values equal the initial critic's on that step's sequences within
  1e-5, and the packages' values agree.
- The launcher: ``python -m areal_tpu_torch.training.main_sync_ppo``
  exits 0 on the CPU, and ``--help-config`` lists the PPO keys.
"""

import dataclasses
import json
import os
import subprocess
import sys
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api import cli_args as rcli
from areal_tpu.api import data_api as rdata
from areal_tpu.api.config import ModelName as RModelName
from areal_tpu.api.model_api import GenerationHyperparameters as RGen
from areal_tpu.api.model_api import Model as RModel
from areal_tpu.base import name_resolve as ref_nr
from areal_tpu.engine.jax_engine import JaxTrainEngine
from areal_tpu.experiments import make_experiment as ref_make_experiment
from areal_tpu.interfaces import fused as rfused
from areal_tpu.interfaces import ppo as rppo
from areal_tpu.interfaces import reward as rreward
from areal_tpu.models import generation as rgen
from areal_tpu.models import hf as rhf
from areal_tpu.models import transformer as rt
from areal_tpu.models.config import TransformerConfig as RConfig
from areal_tpu.system import controller as rctl
from areal_tpu_torch.api import cli_args as tcli
from areal_tpu_torch.api import data_api as tdata
from areal_tpu_torch.api.model_api import GenerationHyperparameters as TGen
from areal_tpu_torch.api.model_api import Model, ModelName
from areal_tpu_torch.base import name_resolve
from areal_tpu_torch.convert import params_from_numpy, params_to_numpy
from areal_tpu_torch.engine.optimizer import OptimizerConfig, tree_leaves
from areal_tpu_torch.engine.torch_engine import TorchTrainEngine
from areal_tpu_torch.experiments import make_experiment
from areal_tpu_torch.interfaces import fused as tfused
from areal_tpu_torch.interfaces import ppo as tppo
from areal_tpu_torch.interfaces import reward as treward
from areal_tpu_torch.models import generation as tgen
from areal_tpu_torch.models import hf as thf
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.system import controller as tctl
from tests import fixtures
from tests.test_torch_workers import (
    CFG,
    F32_FAMILY,
    PortF32ModelWorker,
    RefF32ModelWorker,
    _f32,
)

pytestmark = pytest.mark.serial

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 300
STEPS, BATCH, GROUP, MAX_NEW = 2, 4, 2, 8
ANSWERS = [str(i) for i in range(50)]
for _registry, _get, _register in (
        (thf.HF_FAMILY_REGISTRY, thf.get_family, thf.register_hf_family),
        (rhf.HF_FAMILY_REGISTRY, rhf.get_family, rhf.register_hf_family)):
    if F32_FAMILY not in _registry:
        _register(F32_FAMILY, _f32(_get("qwen2")))


def _tree(seed=0, **over):
    cfg = RConfig(**{**CFG, **over})
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                  rt.init_params(cfg, jax.random.PRNGKey(seed)))


def _math_rows(n, seed=5):
    """Math prompts whose answers are the numbers below 50."""
    rows = [r for r in fixtures.make_math_code_rows(2 * n, seed=seed) if r["task"] == "math"]
    return [dict(r, query_id=f"q{i}", solutions=ANSWERS) for i, r in enumerate(rows[:n])]


def _tokenizer(tmp, rows):
    """A WordPiece tokenizer over a built vocabulary (a trained one's ids
    follow the trainer's hash order, which changes from process to
    process): the numbers 0-59 and the prompts' words, within the model's
    vocabulary."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordPiece
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import PreTrainedTokenizerFast

    words = sorted({w for r in rows for w in r["prompt"].split()})
    vocab = ["[UNK]", "[EOS]", *map(str, range(60)), *words]
    vocab = list(dict.fromkeys(vocab))[:fixtures.VOCAB_SIZE]
    tok = Tokenizer(WordPiece({t: i for i, t in enumerate(vocab)}, unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    path = str(tmp / "tokenizer.json")
    tok.save(path)
    return PreTrainedTokenizerFast(tokenizer_file=path, eos_token="[EOS]", pad_token="[EOS]",
                                   unk_token="[UNK]")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sync")
    rows = _math_rows(12)
    tok = _tokenizer(tmp, rows)
    return dict(tmp=tmp, rows=rows, tok=tok, tree=_tree(0))


def _engines(tree, critic=False):
    cfg = {**CFG, "is_critic": critic}
    jeng = JaxTrainEngine(RConfig(**cfg), jax.tree_util.tree_map(jnp.asarray, tree),
                          optimizer_config=None, row_len_multiple=32)
    teng = TorchTrainEngine(TransformerConfig(**cfg), params_from_numpy(tree, device="cpu"),
                            row_len_multiple=32, device="cpu")
    return jeng, teng


def _prompt_samples(tok, rows):
    """The rows' prompts as each package's dataset sample batch."""
    out = []
    for data_api in (rdata, tdata):
        enc = [tok(r["prompt"])["input_ids"] for r in rows]
        out.append(data_api.SequenceSample.from_default(
            ids=[r["query_id"] for r in rows], seqlens=[len(e) for e in enc],
            data={"packed_prompts": np.concatenate([np.asarray(e, np.int32) for e in enc])},
            metadata=dict(tasks=["math"] * len(rows), solutions=[ANSWERS] * len(rows))))
    return out


def _gen_sample_pair(setup, gen_kw=None):
    jeng, teng = _engines(setup["tree"])
    jsample, tsample = _prompt_samples(setup["tok"], setup["rows"][:3])
    kw = dict(n=GROUP, greedy=True, max_new_tokens=MAX_NEW, **(gen_kw or {}))
    jm = RModel(name=RModelName("actor"), module=jeng, tokenizer=setup["tok"], version=3)
    tm = Model(name=ModelName("actor"), module=teng, tokenizer=setup["tok"], version=3)
    want = rppo.PPOActorInterface(gconfig=dict(kw)).generate(jm, jsample, rdata.MicroBatchSpec())
    got = tppo.PPOActorInterface(gconfig=dict(kw)).generate(tm, tsample, tdata.MicroBatchSpec())
    return got, want, (jm, tm)


def test_actor_generate_assembles_the_reference_sample(setup):
    got, want, _ = _gen_sample_pair(setup)
    assert got.keys == want.keys
    assert got.ids == want.ids and got.metadata == want.metadata
    assert got.metadata["version_start"] == [3] * 3
    for k in sorted(want.keys):
        assert got.seqlens[k] == want.seqlens[k], k
    for k in ("packed_input_ids", "prompt_mask", "seq_no_eos_mask"):
        np.testing.assert_array_equal(got.data[k], want.data[k], err_msg=k)
    np.testing.assert_allclose(got.data["packed_logprobs"], want.data["packed_logprobs"],
                               atol=1e-4)
    # The shifted frame: zeros over the prompt but its last position and
    # at each sequence's last token.
    off = 0
    lp, pm = got.data["packed_logprobs"], got.data["prompt_mask"]
    for n in (n for sl in got.seqlens["packed_input_ids"] for n in sl):
        plen = int(pm[off:off + n].sum())
        assert not lp[off:off + plen - 1].any() and lp[off + n - 1] == 0
        assert (lp[off + plen - 1:off + n - 1] < 0).all()
        off += n


class _NumberTok:
    """Decodes ids as their numbers, so a candidate's last id is its
    answer."""

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


def test_best_of_k_keeps_the_reference_candidates():
    rng = np.random.default_rng(2)
    G, K, n_prompts = 5, 2, 4
    outs = [dict(output_ids=rng.integers(0, 9, int(rng.integers(1, 6))).tolist(),
                 output_logprobs=[-0.5], no_eos=False) for _ in range(G * n_prompts)]
    answers = [["3"], ["7"], ["100"], ["1"]]
    picks = []
    for data_api, iface, model_cls, name_cls in (
            (rdata, rppo.PPOActorInterface, RModel, RModelName),
            (tdata, tppo.PPOActorInterface, Model, ModelName)):
        sample = data_api.SequenceSample.from_default(
            ids=[f"p{i}" for i in range(n_prompts)], seqlens=[2] * n_prompts,
            data={"packed_prompts": np.zeros(2 * n_prompts, np.int32)},
            metadata=dict(solutions=answers))
        itf = iface(generation_size=G, gconfig=dict(n=K))
        model = model_cls(name=name_cls("actor"), module=None, tokenizer=_NumberTok())
        picks.append([outs.index(o) for o in itf._best_of_k(model, sample, outs, K)])
    assert picks[0] == picks[1] and len(picks[0]) == K * n_prompts


def test_reward_fused_and_prompt_dataset_match_reference(setup, tmp_path):
    got, want, (jm, tm) = _gen_sample_pair(setup)
    # The answers ride with the prompts' metadata, as the data manager
    # joins them to the generated sample in a run.
    for s in (got, want):
        s.metadata.update(tasks=["math"] * 3, solutions=[ANSWERS] * 3)
    # The reward interface over the generated sample (real tokenizer).
    r_want = rreward.MultiTaskRewardInterface().inference(jm, want, rdata.MicroBatchSpec())
    r_got = treward.MultiTaskRewardInterface().inference(tm, got, tdata.MicroBatchSpec())
    np.testing.assert_array_equal(r_got.data["rewards"], r_want.data["rewards"])
    assert r_got.seqlens == r_want.seqlens and r_got.metadata == r_want.metadata
    # The verdicts mix: some responses end on a number, some do not.
    assert set(r_want.data["rewards"].tolist()) == {5.0, -5.0}
    # fused-threading: the reward and the reference logprobs on one model.
    members = {"rew": "rw-math-code", "ref": {"type_": "ppo_actor", "args": {}}}
    f_want = rfused.FusedThreadingForwardInterface(interfaces=dict(members)).inference(
        jm, want, rdata.MicroBatchSpec())
    f_got = tfused.FusedThreadingForwardInterface(interfaces=dict(members)).inference(
        tm, got, tdata.MicroBatchSpec())
    assert f_got.keys == f_want.keys == {"rewards", "logprobs"}
    np.testing.assert_array_equal(f_got.data["rewards"], f_want.data["rewards"])
    np.testing.assert_allclose(f_got.data["logprobs"], f_want.data["logprobs"], atol=1e-5)
    # PromptDataset over one jsonl.
    from areal_tpu.datasets.prompt import PromptDataset as RPromptDataset
    from areal_tpu_torch.datasets.prompt import PromptDataset

    path = fixtures.write_jsonl([dict(id=r["query_id"], prompt=r["prompt"])
                                 for r in setup["rows"]], tmp_path / "p.jsonl")
    rds = RPromptDataset(rdata.DatasetUtility(seed=1, tokenizer=setup["tok"]), 6, path)
    tds = PromptDataset(tdata.DatasetUtility(seed=1, tokenizer=setup["tok"]), 6, path)
    assert len(tds) == len(rds) == len(setup["rows"])
    for i in range(len(rds)):
        a, b = tds[i], rds[i]
        assert a.ids == b.ids and a.seqlens == b.seqlens
        np.testing.assert_array_equal(a.data["packed_prompts"], b.data["packed_prompts"])


# ---------------------------------------------------------------------------
# The param-realloc target
# ---------------------------------------------------------------------------


def _greedy(params, plist, seed=0):
    return [o["output_ids"] for o in tgen.generate_tokens(
        params, TransformerConfig(**CFG), plist, TGen(greedy=True, max_new_tokens=10),
        torch.Generator().manual_seed(seed))]


def test_realloc_target_loads_a_raw_dump_and_a_reference_engine_state(tmp_path, monkeypatch):
    from areal_tpu.engine.checkpoint import save_engine_state as ref_save_engine_state
    from areal_tpu_torch.api.system_api import ModelWorkerConfig
    from areal_tpu_torch.base import constants
    from areal_tpu_torch.system.model_worker import ModelWorker
    from areal_tpu_torch.system.weight_transfer import dump_raw_params

    monkeypatch.setenv("AREAL_FILEROOT", str(tmp_path / "fr"))
    exp, trial = f"realloc-{uuid.uuid4().hex[:6]}", "t0"
    target = TorchTrainEngine(TransformerConfig(**CFG), params_from_numpy(_tree(9), device="cpu"),
                              optimizer_config=OptimizerConfig(lr=1e-3), row_len_multiple=32,
                              device="cpu")
    for m in target.optimizer.mu + target.optimizer.nu:
        m.normal_()
    moments = [m.clone() for m in target.optimizer.mu + target.optimizer.nu]
    worker = ModelWorker()
    worker.cfg = ModelWorkerConfig(experiment_name=exp, trial_name=trial, device="cpu")
    worker.models = {"actor@1": Model(name=ModelName("actor", 1), module=target, tokenizer=None)}
    worker._host_rank = {}
    d = os.path.join(constants.get_param_realloc_path(exp, trial), "actor")
    plist = [list(range(3, 12)), [5, 9, 2, 44]]
    hook = {"type": "param_realloc", "source": "actor@0", "target": "actor@1"}

    def stamp(step):
        with open(os.path.join(d, "step.txt"), "w") as f:
            f.write(str(step))

    # A port raw dump (what the port's source writes).
    raw = _tree(1)
    dump_raw_params(params_from_numpy(raw, device="cpu"), d, version=1)
    stamp(1)
    worker._param_realloc(hook, step=1)
    want = [o["output_ids"] for o in rgen.generate_tokens(
        raw, RConfig(**CFG), plist, RGen(greedy=True, max_new_tokens=10),
        jax.random.PRNGKey(0))]
    assert _greedy(target.get_params(), plist) == want
    # A reference engine_state.pkl, which the target prefers when present.
    pkl = _tree(2)
    ref_save_engine_state(JaxTrainEngine(RConfig(**CFG), jax.tree_util.tree_map(jnp.asarray, pkl),
                                         optimizer_config=None, row_len_multiple=32),
                          d, backend="pickle")
    stamp(2)
    worker._param_realloc(hook, step=2)
    for a, b in zip(tree_leaves(params_to_numpy(target.get_params())), tree_leaves(pkl)):
        np.testing.assert_array_equal(a, b)
    want2 = [o["output_ids"] for o in rgen.generate_tokens(
        pkl, RConfig(**CFG), plist, RGen(greedy=True, max_new_tokens=10),
        jax.random.PRNGKey(0))]
    assert _greedy(target.get_params(), plist) == want2 != want
    # Only the params moved.
    for a, b in zip(target.optimizer.mu + target.optimizer.nu, moments):
        assert torch.equal(a, b)


def test_realloc_target_waits_for_the_step_stamp(tmp_path, monkeypatch):
    from areal_tpu_torch.api.system_api import ModelWorkerConfig
    from areal_tpu_torch.system import model_worker as tmw

    monkeypatch.setenv("AREAL_FILEROOT", str(tmp_path / "fr"))
    monkeypatch.setattr(tmw, "REALLOC_WAIT_S", 0.3)
    worker = tmw.ModelWorker()
    worker.cfg = ModelWorkerConfig(experiment_name="x", trial_name="t", device="cpu")
    worker.models = {"actor@1": Model(name=ModelName("actor", 1), module=None, tokenizer=None)}
    worker._host_rank = {}
    with pytest.raises(TimeoutError, match="no fresh dump"):
        worker._param_realloc({"source": "actor@0", "target": "actor@1"}, step=1)


def test_offload_hook_offloads_the_engine_and_passes_over_a_mock(tmp_path):
    from areal_tpu_torch.engine.factories import MockEngine
    from areal_tpu_torch.system.model_worker import ModelWorker

    worker = ModelWorker()
    eng = TorchTrainEngine(TransformerConfig(**CFG), params_from_numpy(_tree(3), device="cpu"),
                           optimizer_config=OptimizerConfig(lr=1e-3), row_len_multiple=32,
                           device="cpu")
    worker.models = {"actor@0": Model(name=ModelName("actor"), module=eng, tokenizer=None),
                     "reward@0": Model(name=ModelName("reward"), module=MockEngine(),
                                       tokenizer=None)}
    worker._exec_hook({"type": "offload"}, "actor@0")
    worker._exec_hook({"type": "offload"}, "reward@0")
    assert eng._offloaded and eng.params is None
    for a, b in zip(tree_leaves(params_to_numpy(eng.get_params())), tree_leaves(_tree(3))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The experiment
# ---------------------------------------------------------------------------


def _overrides(hf_dir, data, critic_dir=None, exp="e", ref=True, extra=()):
    ov = [f"experiment_name={exp}", "trial_name=t0", f"tokenizer_path={hf_dir}",
          f"dataset.path={data}", "dataset.max_length=64", f"train_batch_size={BATCH}",
          f"group_size={GROUP}", f"ppo.gconfig.max_new_tokens={MAX_NEW}",
          "ppo.gconfig.greedy=true", "ppo.ppo_n_minibatches=2",
          f"exp_ctrl.benchmark_steps={STEPS}", "actor.row_len_multiple=32",
          "actor.optimizer.lr=1e-3", "actor.optimizer.warmup_steps_proportion=0.0",
          "ppo.kl_ctl=0.05"]
    ov.append(f"actor.path={hf_dir}" if ref else
              f"actor.config={json.dumps(CFG)}")
    if not ref:
        ov.append("actor.init_from_scratch=true")
    if critic_dir is not None:
        ov += [f"critic.path={critic_dir}", "ppo.disable_value=false",
               "critic.row_len_multiple=32", "critic.optimizer.lr=1e-3",
               "critic.optimizer.warmup_steps_proportion=0.0"]
    return ov + list(extra)


def _norm(x):
    """A config as plain data, None-valued keys and the reference-only
    backend knobs dropped."""
    if dataclasses.is_dataclass(x):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        drop = {"attn_impl", "prefetch_depth", "stats_fetch_interval", "device"}
        return {k: _norm(v) for k, v in x.items() if v is not None and k not in drop}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if hasattr(x, "value") and type(x).__name__ == "ModelInterfaceType":
        return x.value
    if type(x).__name__ == "ModelName":
        return str(x)
    return x


@pytest.mark.parametrize("critic,ref", [(True, True), (False, True), (False, False)])
def test_experiment_builds_the_reference_dfg(setup, critic, ref):
    hf_dir = str(setup["tmp"] / "hf_dfg")
    data = str(setup["tmp"] / "dfg.jsonl")
    ov = _overrides(hf_dir, data, hf_dir if critic else None, ref=ref)
    rcfg, tcfg = rcli.PPOMATHExpConfig(), tcli.PPOMATHExpConfig()
    rcli.apply_overrides(rcfg, ov)
    tcli.apply_overrides(tcfg, ov)
    want, got = ref_make_experiment("ppo-math", rcfg), make_experiment("ppo-math", tcfg)
    names = [r.name for r in got.master.rpcs]
    assert names == [r.name for r in want.master.rpcs]
    assert ("ref_inf" in names) == ref and ("critic_inf" in names) == critic
    for g, w in zip(got.master.rpcs, want.master.rpcs):
        assert _norm(g) == _norm(w), g.name
    assert got.master.model_topos == want.master.model_topos
    (gw,), (ww,) = got.model_workers, want.model_workers
    assert [str(s.id.model_name) for s in gw.shards] == [str(s.id.model_name) for s in ww.shards]
    for gs, ws in zip(gw.shards, ww.shards):
        for part in ("model", "backend", "interface"):
            assert _norm(getattr(gs, part)) == _norm(getattr(ws, part)), (gs.id, part)
    assert _norm(gw.datasets) == _norm(ww.datasets)


@pytest.mark.parametrize("override,item", [
    ("allocation_mode=d2", "item 7"), ("n_model_workers=2", "item 7"),
    ("train_n_hosts=2", "item 7"), ("actor.mesh_spec=d1f2", "item 7"),
    ("actor.moe_dispatch=dense", "item 6.2"), ("actor.prefetch_depth=2", "item 3.4"),
    ("auto_eval=true", "item 8")])
def test_ppo_math_refuses_what_is_not_ported(override, item):
    cfg = tcli.PPOMATHExpConfig()
    tcli.apply_overrides(cfg, ["actor.path=/nonexistent", override])
    with pytest.raises(NotImplementedError, match=item):
        make_experiment("ppo-math", cfg)


@pytest.mark.parametrize("cls", ["PPOHyperparameters", "PPOMATHExpConfig"])
def test_option_dataclasses_carry_the_reference_fields(cls):
    def fields(c):
        obj = c()
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(c)}

    want, got = fields(getattr(rcli, cls)), fields(getattr(tcli, cls))
    assert set(got) - set(want) <= {"device"}
    for k, v in want.items():
        assert k in got, k
        assert _norm(got[k]) == _norm(v), k


class RefSyncWorker(RefF32ModelWorker):
    """Records the outputs of actor_gen, rew_inf and critic_inf."""

    def _handle_mfc(self, req):
        return _record(self, "ref", req, super()._handle_mfc(req))


class PortSyncWorker(PortF32ModelWorker):
    def _handle_mfc(self, req):
        return _record(self, "port", req, super()._handle_mfc(req))


_KEYS = {"actor_gen": ("packed_input_ids", "prompt_mask"), "rew_inf": ("rewards",),
         "critic_inf": ("values",)}


def _record(worker, side, req, reply):
    name = req.data.get("mfc_name")
    if name in _KEYS:
        s = worker.data_manager.gather(req.data["ids"], list(_KEYS[name]))
        step = int(req.data.get("step_info", {}).get("global_step", 0))
        path = os.path.join(os.environ["SYNC_RECORD_DIR"], f"{side}-{name}-{step}.npz")
        np.savez(path, ids=np.asarray(s.ids), seqlens=np.asarray(
            [l for sl in s.seqlens[_KEYS[name][0]] for l in sl]),
            **{k: np.asarray(s.data[k]) for k in _KEYS[name]})
    return reply


class RefSyncController(rctl.LocalController):
    def start_workers(self):
        for cfg in self.exp_cfg.model_workers:
            self._spawn(f"{__name__}:RefSyncWorker", cfg)


class PortSyncController(tctl.LocalController):
    def start_workers(self):
        for cfg in self.exp_cfg.model_workers:
            self._spawn(f"{__name__}:PortSyncWorker", cfg)


def _write_hf(d, tree, tok, critic=False):
    cfg = TransformerConfig(**{**CFG, "is_critic": critic})
    thf.save_hf_model(d, cfg, params_from_numpy(tree, device="cpu"), "qwen2", tokenizer=tok)
    with open(os.path.join(d, "config.json")) as f:
        hf_cfg = json.load(f)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(dict(hf_cfg, model_type=F32_FAMILY), f)


def _run(side, tmp, hf_dir, critic_dir, data, monkeypatch):
    exp = f"sync-{side}-{uuid.uuid4().hex[:6]}"
    fileroot = str(tmp / "fileroot")
    rec = tmp / "records"
    rec.mkdir(parents=True)
    nr_cfg = {"backend": "nfs", "record_root": str(tmp / "nr")}
    monkeypatch.setenv("AREAL_FILEROOT", fileroot)
    ov = _overrides(hf_dir, data, critic_dir, exp=exp)
    if side == "ref":
        cfg = rcli.PPOMATHExpConfig()
        rcli.apply_overrides(cfg, ov)
        exp_cfg, ctl_cls = ref_make_experiment("ppo-math", cfg), RefSyncController
        from areal_tpu.system.function_executor import FunctionExecutor
    else:
        cfg = tcli.PPOMATHExpConfig()
        tcli.apply_overrides(cfg, ov + ["device=cpu"])
        exp_cfg, ctl_cls = make_experiment("ppo-math", cfg), PortSyncController
        from areal_tpu_torch.system.function_executor import FunctionExecutor
    steps = []
    inner = FunctionExecutor.execute_step_sync

    def recording(self):
        steps.append(inner(self))
        return steps[-1]

    monkeypatch.setattr(FunctionExecutor, "execute_step_sync", recording)
    ctl = ctl_cls(exp_cfg, name_resolve_cfg=nr_cfg,
                  worker_env={"JAX_PLATFORMS": "cpu", "AREAL_FILEROOT": fileroot,
                              "SYNC_RECORD_DIR": str(rec)})
    try:
        result = ctl.run(timeout=RUN_TIMEOUT_S)
    finally:
        ctl.join(timeout=30)
    assert result["global_step"] == STEPS
    recs = {f[:-4]: dict(np.load(rec / f)) for f in os.listdir(rec)}
    return steps, recs


@pytest.fixture(scope="module")
def sync_runs(setup):
    tmp = setup["tmp"]
    hf_dir, critic_dir = str(tmp / "hf"), str(tmp / "hf_critic")
    _write_hf(hf_dir, setup["tree"], setup["tok"])
    critic_tree = _tree(4, is_critic=True)
    _write_hf(critic_dir, critic_tree, setup["tok"], critic=True)
    data = fixtures.write_jsonl(setup["rows"], tmp / "math.jsonl")
    saved = ref_nr._default.repo, name_resolve._default.repo
    out = dict(critic_tree=critic_tree)
    try:
        with pytest.MonkeyPatch.context() as mp:
            for side in ("ref", "port"):
                out[side] = _run(side, tmp / side, hf_dir, critic_dir, data, mp)
    finally:
        ref_nr._default.repo, name_resolve._default.repo = saved
    return out


def test_sync_ppo_matches_reference(sync_runs):
    (ref_steps, ref_rec), (port_steps, port_rec) = sync_runs["ref"], sync_runs["port"]
    assert len(ref_steps) == len(port_steps) == STEPS
    for i, (got, want) in enumerate(zip(port_steps, ref_steps)):
        assert sorted(got) == sorted(want)
        for mfc, prefix in (("actor_train", "ppo_actor/"), ("critic_train", "ppo_critic/")):
            keys = sorted(k for k in want[mfc] if k.startswith(prefix))
            assert keys and keys == sorted(k for k in got[mfc] if k.startswith(prefix))
            for k in keys:
                np.testing.assert_allclose(got[mfc][k], want[mfc][k], rtol=1e-3, atol=1e-6,
                                           err_msg=f"step {i + 1} {k}")
    rewards = set()
    for step in range(STEPS):
        for mfc, keys in _KEYS.items():
            a, b = port_rec[f"port-{mfc}-{step}"], ref_rec[f"ref-{mfc}-{step}"]
            assert a["ids"].tolist() == b["ids"].tolist()
            assert a["seqlens"].tolist() == b["seqlens"].tolist()
            for k in keys:
                if k == "values":
                    np.testing.assert_allclose(a[k], b[k], atol=1e-5)
                else:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{mfc} {k}")
        rewards |= set(port_rec[f"port-rew_inf-{step}"]["rewards"].tolist())
    assert rewards == {5.0, -5.0}


def test_first_minibatch_reads_the_generators_logprobs(sync_runs):
    """Step 1's first actor minibatch runs on the weights that generated
    the batch: in float32 the training forward's logprobs of its tokens
    equal the generator's, so the port's three first-minibatch readings
    (the smoke's gate on the generator) sit at their exact values."""
    first = sync_runs["port"][0][0]["actor_train"]
    assert first["ppo_actor_first_mb/abs_logprob_diff"] <= 1e-4
    assert abs(first["ppo_actor_first_mb/approx_kl"]) <= 1e-4
    assert abs(first["ppo_actor_first_mb/importance_weight"] - 1.0) <= 1e-4
    assert "ppo_actor/abs_logprob_diff" not in first


def test_critic_inf_reads_the_initial_critic_at_every_step(sync_runs):
    """critic@0 is never updated: each step's critic_inf values are the
    initial critic's on that step's sequences (denormalized by its
    interface's running statistics, which only critic_train updates), in
    both packages."""
    from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample

    _, teng = _engines(sync_runs["critic_tree"], critic=True)
    critic = Model(name=ModelName("critic", 0), module=teng, tokenizer=None)
    for side in ("ref", "port"):
        recs = sync_runs[side][1]
        for step in range(STEPS):
            gen = recs[f"{side}-actor_gen-{step}"]
            sample = SequenceSample.from_default(
                ids=[f"s{i}" for i in range(len(gen["seqlens"]))],
                seqlens=gen["seqlens"].tolist(),
                data={"packed_input_ids": gen["packed_input_ids"]})
            want = tppo.PPOCriticInterface().inference(
                critic, sample, MicroBatchSpec()).data["values"]
            got = recs[f"{side}-critic_inf-{step}"]["values"]
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=f"{side} step {step}")


def test_main_sync_ppo_runs_on_the_cpu_in_a_subprocess(setup, tmp_path):
    hf_dir = str(tmp_path / "hf")
    thf.save_hf_model(hf_dir, TransformerConfig(**CFG), params_from_numpy(setup["tree"],
                                                                           device="cpu"),
                      "qwen2", tokenizer=setup["tok"])
    data = fixtures.write_jsonl(setup["rows"], tmp_path / "math.jsonl")
    argv = _overrides(hf_dir, data, hf_dir, exp=f"main-{uuid.uuid4().hex[:6]}") + [
        f"name_resolve_root={tmp_path / 'nr'}", "device=cpu", "exp_ctrl.benchmark_steps=1"]
    env = dict(os.environ, AREAL_FILEROOT=str(tmp_path / "fr"))
    proc = subprocess.run([sys.executable, "-m", "areal_tpu_torch.training.main_sync_ppo",
                           *argv], cwd=REPO_ROOT, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "experiment complete after 1 steps" in proc.stdout + proc.stderr
    helped = subprocess.run([sys.executable, "-m", "areal_tpu_torch.training.main_sync_ppo",
                             "--help-config"], cwd=REPO_ROOT, capture_output=True, text=True,
                            timeout=120)
    assert helped.returncode == 0
    for key in ("ppo.gconfig.max_new_tokens", "ppo.generation_size", "critic_inf.n_mbs"):
        assert key in helped.stdout, key
