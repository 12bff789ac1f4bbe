"""Port parity of supervised fine-tuning end to end: ``main_sft``'s
experiment, the HF save and evaluate, and serving what was saved.

- The ``prompt_answer`` datasets of both packages over one jsonl and one
  tokenizer: ids, tokens and prompt masks equal, rows cut at
  ``max_length`` included.
- ``FrequencyControl``: one scripted sequence of checks (step, epoch and
  seconds frequencies, the clock patched) gives the reference's verdicts,
  and ``state_dict`` round-trips.
- ``SFTInterface.evaluate`` on the same params and loader batches:
  ``eval_loss`` within rtol 1e-4, ``eval_n_tokens`` equal.
- The ``sft`` experiment of each package under its own
  ``LocalController``, from one HF directory (seeded weights, the tiny
  tokenizer in it), one jsonl, 3 steps that cross an epoch boundary,
  ``save_freq_steps=1``. Limits: every ``sft/*`` stat of each step within
  rtol 1e-3, atol 1e-6, and each save's update against the reference's
  within ``UPDATE_RTOL`` of tests/test_torch_workers.py (the PPO trainer
  parity limits). The model workers read the directory through the
  family ``qwen2-f32`` of that module (qwen2 with float32 compute). Both
  write the same ``step<version>`` directories, equal ``config.json``
  and the tokenizer; each package loads the other's saves bit-equal.
- Serving the saves: a port server on the port's save (``model_path``)
  and a reference server on the reference's give equal greedy tokens over
  HTTP; a port server started on the initial weights takes the save
  through ``/update_weights_from_disk`` (``"source": "hf"``) and gives the
  same tokens; a pinned version is refused by both servers.
- The masters broadcast "save" and "evaluate" at the same steps under
  ``save_freq_steps=2`` and ``eval_freq_steps=3``.
- Two reference behaviours the port copies: the "evaluate" handler
  passes no eval loader (``TypeError``), and a model built from a config
  has no HF family to save with (``ValueError``); both packages' workers
  reply with the same exception type.
- The launcher: ``python -m areal_tpu_torch.training.main_sft`` exits 0
  on the CPU, and options the port lacks (a device mesh, the input
  pipeline, the multi-host launch) raise ``NotImplementedError`` naming
  their ROADMAP item.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api import cli_args as rcli
from areal_tpu.api import data_api as rdata
from areal_tpu.base import name_resolve as ref_nr
from areal_tpu.base import timeutil as rtime
from areal_tpu.datasets.prompt_answer import PromptAnswerDataset as RefPromptAnswerDataset
from areal_tpu.experiments import make_experiment as ref_make_experiment
from areal_tpu.models import hf as rhf
from areal_tpu_torch.api import cli_args as tcli
from areal_tpu_torch.api import data_api as tdata
from areal_tpu_torch.base import name_resolve
from areal_tpu_torch.base import timeutil as ttime
from areal_tpu_torch.convert import params_from_numpy, params_to_numpy
from areal_tpu_torch.datasets.prompt_answer import PromptAnswerDataset
from areal_tpu_torch.experiments import make_experiment
from areal_tpu_torch.models import hf as thf
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.training import main_sft
from tests import fixtures
from tests.test_torch_workers import (
    CFG,
    F32_FAMILY,
    PortController,
    RefController,
    _check_update,
    _f32,
    _leaves,
)

pytestmark = pytest.mark.serial

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 300
N_ROWS, BATCH, STEPS, MAX_LEN = 20, 8, 3, 24
SERVER_KW = dict(max_concurrent_requests=4, max_seq_len=128, kv_page_size=16,
                 decode_block_steps=4, seed=0)
for _registry, _get, _register in (
        (thf.HF_FAMILY_REGISTRY, thf.get_family, thf.register_hf_family),
        (rhf.HF_FAMILY_REGISTRY, rhf.get_family, rhf.register_hf_family)):
    if F32_FAMILY not in _registry:
        _register(F32_FAMILY, _f32(_get("qwen2")))


@pytest.fixture
def restore_name_resolve():
    saved = ref_nr._default.repo, name_resolve._default.repo
    yield
    ref_nr._default.repo, name_resolve._default.repo = saved


def _tokenizer(tmp, rows):
    return fixtures.train_tiny_tokenizer([r["prompt"] + " " + r["answer"] for r in rows], tmp)


# ---------------------------------------------------------------------------
# Dataset, frequency control, evaluate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bos", [False, True])
def test_prompt_answer_dataset_matches_reference(tmp_path, bos):
    rows = fixtures.make_sft_rows(24, seed=11)
    tok = _tokenizer(tmp_path, rows)
    if bos:
        tok.bos_token = "[UNK]"
    path = fixtures.write_jsonl(rows, tmp_path / "sft.jsonl")
    max_length = 9  # cuts rows inside the answer, some inside the prompt
    got = PromptAnswerDataset(tdata.DatasetUtility(seed=3, dp_rank=1, world_size=2,
                                                   tokenizer=tok), max_length, path)
    want = RefPromptAnswerDataset(rdata.DatasetUtility(seed=3, dp_rank=1, world_size=2,
                                                       tokenizer=tok), max_length, path)
    assert got.ids == want.ids and len(got) == 12
    assert got.tokens == want.tokens
    assert max(map(len, got.tokens)) == max_length
    assert any(m.all() for m in got.prompt_masks)  # a row cut inside its prompt
    for a, b in zip(got.prompt_masks, want.prompt_masks):
        assert a.dtype == b.dtype == bool
        np.testing.assert_array_equal(a, b)
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert g.ids == w.ids and g.seqlens == w.seqlens
        for k in ("packed_input_ids", "prompt_mask"):
            assert g.data[k].dtype == w.data[k].dtype
            np.testing.assert_array_equal(g.data[k], w.data[k])


class _Clock:
    def __init__(self):
        self.now = 100.0

    def monotonic(self):
        return self.now

    perf_counter = monotonic


@pytest.mark.parametrize("freq", [
    dict(frequency_step=3), dict(frequency_epoch=2), dict(frequency_sec=20.0),
    dict(frequency_step=4, frequency_sec=30.0, initial_value=True)])
def test_frequency_control_matches_reference(monkeypatch, freq):
    clock = _Clock()
    monkeypatch.setattr(ttime, "time", clock)
    monkeypatch.setattr(rtime, "time", clock)
    got, want = ttime.FrequencyControl(**freq), rtime.FrequencyControl(**freq)
    rng = np.random.default_rng(0)
    verdicts = []
    for i in range(40):
        clock.now += float(rng.integers(0, 12))
        steps, epochs = int(rng.integers(0, 3)), int(i % 7 == 6)
        verdicts.append((got.check(steps=steps, epochs=epochs),
                         want.check(steps=steps, epochs=epochs)))
        if i == 20:
            state = got.state_dict()
            assert state == want.state_dict()
            got = ttime.FrequencyControl(**freq)
            got.load_state_dict(json.loads(json.dumps(state)))
            want.load_state_dict(state)
            assert got.state_dict() == state
    assert [g for g, _ in verdicts] == [w for _, w in verdicts]
    assert 0 < sum(g for g, _ in verdicts) < len(verdicts)


def test_timer_matches_reference(monkeypatch):
    """Timer's per-name totals under a patched clock: start/stop and
    nested scopes, each stop returning its own interval."""
    clock = _Clock()
    monkeypatch.setattr(ttime, "time", clock)
    monkeypatch.setattr(rtime, "time", clock)
    timers = ttime.Timer(), rtime.Timer()
    steps = []
    for t in timers:
        clock.now = 100.0
        t.start("a")
        clock.now += 2.5
        with t.scope("b"):
            clock.now += 1.25
            with t.scope("c"):
                clock.now += 0.5
        got = [t.stop("a")]
        t.start("a")
        clock.now += 4.0
        got.append(t.stop("a"))
        steps.append(got)
    assert steps[0] == steps[1] == [4.25, 4.0]
    assert timers[0].totals == timers[1].totals == {"a": 8.25, "b": 1.75, "c": 0.5}


def _engines(tree):
    from areal_tpu.engine.jax_engine import JaxTrainEngine
    from areal_tpu.models.config import TransformerConfig as RefConfig
    from areal_tpu_torch.engine.torch_engine import TorchTrainEngine

    jeng = JaxTrainEngine(RefConfig(**CFG), jax.tree_util.tree_map(jnp.asarray, tree),
                          optimizer_config=None, row_len_multiple=32)
    teng = TorchTrainEngine(TransformerConfig(**CFG), params_from_numpy(tree, device="cpu"),
                            row_len_multiple=32, device="cpu")
    return jeng, teng


def test_sft_evaluate_matches_reference(tmp_path):
    from areal_tpu.api.config import ModelName as RefModelName
    from areal_tpu.api.model_api import Model as RefModel
    from areal_tpu.interfaces.sft import SFTInterface as RefSFTInterface
    from areal_tpu.models.config import TransformerConfig as RefConfig
    from areal_tpu.models.transformer import init_params
    from areal_tpu_torch.api.model_api import Model, ModelName
    from areal_tpu_torch.interfaces.sft import SFTInterface

    rows = fixtures.make_sft_rows(20, seed=4)
    tok = _tokenizer(tmp_path, rows)
    path = fixtures.write_jsonl(rows, tmp_path / "sft.jsonl")
    tree = jax.tree_util.tree_map(np.asarray, init_params(RefConfig(**CFG),
                                                          jax.random.PRNGKey(5)))
    jeng, teng = _engines(tree)
    batches = []
    for data_api, cls in ((tdata, PromptAnswerDataset), (rdata, RefPromptAnswerDataset)):
        loader = data_api.PackedDataLoader(
            cls(data_api.DatasetUtility(seed=1, tokenizer=tok), 16, path),
            batch_size=6, shuffle=True, seed=1)
        batches.append([loader.next_batch()[0] for _ in range(len(loader))])
    got = SFTInterface().evaluate(Model(name=ModelName("m"), module=teng, tokenizer=tok),
                                  batches[0])
    want = RefSFTInterface().evaluate(
        RefModel(name=RefModelName("m"), module=jeng, tokenizer=tok), batches[1])
    assert got["eval_n_tokens"] == want["eval_n_tokens"] > 0
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=1e-4)


# ---------------------------------------------------------------------------
# The experiment end to end
# ---------------------------------------------------------------------------


def _argv(exp, hf_dir, data, **ctl):
    return [f"experiment_name={exp}", "trial_name=t0", f"model.path={hf_dir}",
            f"tokenizer_path={hf_dir}", f"dataset.path={data}", f"dataset.max_length={MAX_LEN}",
            f"train_batch_size={BATCH}", "mb_spec_n_mbs=2", "model.row_len_multiple=32",
            "model.prefetch_depth=0", "model.optimizer.lr=1e-3",
            "model.optimizer.warmup_steps_proportion=0.0", f"exp_ctrl.benchmark_steps={STEPS}",
            *(f"exp_ctrl.{k}={v}" for k, v in ctl.items())]


def _run_sft(side, tmp, hf_dir, data, monkeypatch):
    """One ``sft`` experiment; returns (per-step trainDefault stats, save dir)."""
    exp = f"sft-{side}-{uuid.uuid4().hex[:6]}"
    fileroot = str(tmp / "fileroot")
    nr_cfg = {"backend": "nfs", "record_root": str(tmp / "nr")}
    monkeypatch.setenv("AREAL_FILEROOT", fileroot)
    if side == "ref":
        cfg = rcli.SFTExpConfig()
        rcli.apply_overrides(cfg, _argv(exp, hf_dir, data, save_freq_steps=1))
        exp_cfg, ctl_cls = ref_make_experiment("sft", cfg), RefController
        from areal_tpu.system.function_executor import FunctionExecutor
    else:
        cfg = tcli.SFTExpConfig()
        tcli.apply_overrides(cfg, _argv(exp, hf_dir, data, save_freq_steps=1) + ["device=cpu"])
        exp_cfg, ctl_cls = make_experiment("sft", cfg), PortController
        from areal_tpu_torch.system.function_executor import FunctionExecutor
    steps = []
    inner = FunctionExecutor.execute_step_sync

    def recording(self):
        steps.append(inner(self))
        return steps[-1]

    monkeypatch.setattr(FunctionExecutor, "execute_step_sync", recording)
    ctl = ctl_cls(exp_cfg, name_resolve_cfg=nr_cfg,
                  worker_env={"JAX_PLATFORMS": "cpu", "AREAL_FILEROOT": fileroot})
    try:
        result = ctl.run(timeout=RUN_TIMEOUT_S)
    finally:
        ctl.join(timeout=30)
    assert result["global_step"] == STEPS
    return [s["trainDefault"] for s in steps], os.path.join(
        fileroot, "checkpoints", exp, "t0", "default")


@pytest.fixture(scope="module")
def sft_runs(tmp_path_factory):
    """One HF directory, one jsonl, and both packages' runs on them."""
    from areal_tpu.models.config import TransformerConfig as RefConfig
    from areal_tpu.models.transformer import init_params

    tmp = tmp_path_factory.mktemp("sft")
    tree = jax.tree_util.tree_map(np.asarray, init_params(RefConfig(**CFG),
                                                          jax.random.PRNGKey(0)))
    rows = fixtures.make_sft_rows(N_ROWS, seed=3)
    hf_dir = str(tmp / "hf")
    thf.save_hf_model(hf_dir, TransformerConfig(**CFG), params_from_numpy(tree, device="cpu"),
                      "qwen2", tokenizer=_tokenizer(tmp, rows))
    # The family with float32 compute, named by the checkpoint itself (the
    # CLI passes no hf_family): bf16 compute parts JAX and torch beyond the
    # stats limit.
    with open(os.path.join(hf_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    with open(os.path.join(hf_dir, "config.json"), "w") as f:
        json.dump(dict(hf_cfg, model_type=F32_FAMILY), f)
    data = fixtures.write_jsonl(rows, tmp / "sft.jsonl")
    saved = ref_nr._default.repo, name_resolve._default.repo
    out = dict(hf_dir=hf_dir, data=data, init=_leaves(tree), tmp=tmp)
    try:
        with pytest.MonkeyPatch.context() as mp:
            for side in ("ref", "port"):
                out[side] = _run_sft(side, tmp / side, hf_dir, data, mp)
    finally:
        ref_nr._default.repo, name_resolve._default.repo = saved
    return out


def _save_dirs(root):
    return sorted(os.path.relpath(r, root) for r, _, files in os.walk(root)
                  if "model.safetensors" in files)


def test_sft_experiment_matches_reference(sft_runs):
    (ref_steps, ref_root), (port_steps, port_root) = sft_runs["ref"], sft_runs["port"]
    assert len(ref_steps) == len(port_steps) == STEPS
    for i, (got, want) in enumerate(zip(port_steps, ref_steps)):
        keys = sorted(k for k in want if k.startswith("sft/"))
        assert keys and keys == sorted(k for k in got if k.startswith("sft/"))
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6,
                                       err_msg=f"step {i + 1} {k}")

    dirs = _save_dirs(port_root)
    assert dirs == _save_dirs(ref_root) == [f"step{v}/dp0" for v in range(1, STEPS + 1)]
    for d in dirs:
        got_dir, want_dir = os.path.join(port_root, d), os.path.join(ref_root, d)
        read = lambda p: json.load(open(os.path.join(p, "config.json")))  # noqa: E731
        assert read(got_dir) == read(want_dir)
        assert read(got_dir)["model_type"] == "qwen2"
        for side_dir in (got_dir, want_dir):
            assert {"tokenizer.json", "tokenizer_config.json"} <= set(os.listdir(side_dir))
        _, got = thf.load_hf_model(got_dir)
        _, want = thf.load_hf_model(want_dir)
        _check_update(_leaves(params_to_numpy(got)), _leaves(params_to_numpy(want)),
                      sft_runs["init"])


def test_sft_saves_load_in_the_other_package(sft_runs):
    for root in (sft_runs["ref"][1], sft_runs["port"][1]):
        d = os.path.join(root, f"step{STEPS}", "dp0")
        ref_cfg, ref_params = rhf.load_hf_model(d)
        cfg, params = thf.load_hf_model(d)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
        got = _leaves(params_to_numpy(params))
        want = _leaves(jax.tree_util.tree_map(np.asarray, ref_params))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# Serving the saves
# ---------------------------------------------------------------------------


def _post(url, path, payload):
    req = urllib.request.Request(url + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _Server:
    """A generation server of one package, in this process, on an HF
    checkpoint read with float32 compute."""

    def __init__(self, side, model_path):
        exp = f"serve-{side}-{uuid.uuid4().hex[:6]}"
        args = dict(hf_family=F32_FAMILY)
        if side == "ref":
            from areal_tpu.api.config import ModelAbstraction
            from areal_tpu.api.system_api import GenerationServerConfig
            from areal_tpu.system.generation_server import GenerationServer

            import areal_tpu.engine.factories  # noqa: F401  (the reference's model registry)
            extra = {}
        else:
            from areal_tpu_torch.api.config import ModelAbstraction
            from areal_tpu_torch.api.system_api import GenerationServerConfig
            from areal_tpu_torch.system.generation_server import GenerationServer

            extra = dict(device="cpu")
        cfg = GenerationServerConfig(experiment_name=exp, trial_name="t0",
                                     model=ModelAbstraction("tpu_transformer", args=args),
                                     model_path=model_path, **SERVER_KW, **extra)
        self.server = GenerationServer()
        self.server.configure(cfg, experiment_name=exp, trial_name="t0",
                              worker_name=cfg.worker_name)
        self.thread = threading.Thread(target=self.server.run, daemon=True)
        self.thread.start()
        self.url = self.server.address

    def greedy(self, prompts):
        out = []
        for i, p in enumerate(prompts):
            status, reply = _post(self.url, "/generate", {
                "qid": f"g{i}", "input_ids": p, "gconfig": {"max_new_tokens": 8,
                                                            "greedy": True}})
            assert status == 200, reply
            out.append(reply["output_ids"])
        return out

    def close(self):
        self.server.exit()
        self.thread.join(timeout=30)


def test_servers_serve_the_saves_with_equal_tokens(sft_runs, tmp_path, restore_name_resolve):
    ref_nr.reconfigure("nfs", record_root=str(tmp_path / "nr"))
    name_resolve.reconfigure("nfs", record_root=str(tmp_path / "nr"))
    port_save = os.path.join(sft_runs["port"][1], f"step{STEPS}", "dp0")
    ref_save = os.path.join(sft_runs["ref"][1], f"step{STEPS}", "dp0")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, fixtures.VOCAB_SIZE, size=n).tolist() for n in (5, 11, 23)]
    servers = []
    try:
        for side, path in (("port", port_save), ("ref", ref_save),
                           ("port", sft_runs["hf_dir"])):
            servers.append(_Server(side, path))
        port, ref, updated = servers
        want = ref.greedy(prompts)
        assert port.greedy(prompts) == want
        before = updated.greedy(prompts)
        status, upd = _post(updated.url, "/update_weights_from_disk",
                            {"model_path": port_save, "allow_interrupt": True})
        assert status == 200 and upd["success"] and upd["source"] == "hf", upd
        assert updated.greedy(prompts) == want != before
        # A pinned version skips the HF checkpoint (version -1) in both.
        for s in (updated, ref):
            status, reply = _post(s.url, "/update_weights_from_disk",
                                  {"model_path": port_save, "version": 7})
            assert status == 500 and not reply["success"], reply
            assert "no raw dump was available" in reply["error"], reply
    finally:
        for s in servers:
            s.close()


# ---------------------------------------------------------------------------
# The master's broadcasts and the two copied reference behaviours
# ---------------------------------------------------------------------------


def test_masters_broadcast_save_and_evaluate_at_the_same_steps(tmp_path, monkeypatch,
                                                                restore_name_resolve):
    from areal_tpu.api import system_api as rsys
    from areal_tpu.system.master_worker import MasterWorker as RefMasterWorker
    from areal_tpu_torch.api import system_api as tsys
    from areal_tpu_torch.system.master_worker import MasterWorker

    ref_nr.reconfigure("nfs", record_root=str(tmp_path / "nr"))
    name_resolve.reconfigure("nfs", record_root=str(tmp_path / "nr"))
    monkeypatch.setenv("AREAL_FILEROOT", str(tmp_path / "fileroot"))
    calls = {}
    for side, cls, sysapi in (("port", MasterWorker, tsys), ("ref", RefMasterWorker, rsys)):
        exp = f"bcast-{side}-{uuid.uuid4().hex[:6]}"
        master = cls()
        master.configure(sysapi.MasterWorkerConfig(
            experiment_name=exp, trial_name="t0", n_model_workers=0, train_batch_size=4,
            exp_ctrl=sysapi.ExperimentSaveEvalControl(
                save_freq_steps=2, eval_freq_steps=3, benchmark_steps=9)),
            experiment_name=exp, trial_name="t0", worker_name="master")
        seen = calls[side] = []
        ex = master.executor
        monkeypatch.setattr(ex, "execute_step_sync", lambda: {})
        monkeypatch.setattr(master, "_broadcast", lambda h, timeout=3600, m=master, s=seen:
                            s.append((m.step_info.global_step, h)) or [])
        try:
            for i in range(9):
                ex._data_epoch_done = i % 4 == 3  # an epoch ends every fourth step
                master._poll()
        finally:
            master._exit_hook()
    assert calls["port"] == calls["ref"]
    assert [h for _, h in calls["port"]].count("save") == 4
    assert [h for _, h in calls["port"]].count("evaluate") == 3


def _worker_replies(side, hf_dir, model_args):
    """The "evaluate" and "save" replies of one package's model worker,
    configured in this process with one SFT shard."""
    exp = f"mw-{side}-{uuid.uuid4().hex[:6]}"
    if side == "ref":
        from areal_tpu.api import config as cfgapi
        from areal_tpu.api import system_api as sysapi
        from areal_tpu.system import request_reply_stream as rrs
        from areal_tpu.system.model_worker import ModelWorker
        extra = {}
    else:
        from areal_tpu_torch.api import config as cfgapi
        from areal_tpu_torch.api import system_api as sysapi
        from areal_tpu_torch.system import request_reply_stream as rrs
        from areal_tpu_torch.system.model_worker import ModelWorker
        extra = dict(device="cpu")
    name = cfgapi.ModelName("default", 0)
    cfg = sysapi.ModelWorkerConfig(
        experiment_name=exp, trial_name="t0", tokenizer_path=hf_dir, **extra,
        shards=[sysapi.ModelShardSpec(
            id=cfgapi.ModelShardID(name),
            model=cfgapi.ModelAbstraction("tpu_transformer", args=model_args),
            backend=cfgapi.ModelBackendAbstraction("jax_train", args=dict(row_len_multiple=32)),
            interface=cfgapi.ModelInterfaceAbstraction("sft"))])
    worker = ModelWorker()
    worker.configure(cfg, experiment_name=exp, trial_name="t0", worker_name="model_worker/0")
    thread = threading.Thread(target=worker.run, daemon=True)
    thread.start()
    stream = rrs.make_master_stream(exp, "t0")
    try:
        return {h: stream.call(["model_worker/0"], h, timeout=120)[0]
                for h in ("evaluate", "save")}
    finally:
        stream.call(["model_worker/0"], "exit", timeout=60)
        thread.join(timeout=30)
        stream.close()


def test_workers_reply_to_evaluate_and_to_a_config_save_as_the_reference(
        sft_runs, tmp_path, monkeypatch, restore_name_resolve):
    """Evaluate hands the interface no loader (TypeError); a model built
    from a config carries no HF family, so its save raises ValueError. A
    model from an HF directory saves."""
    ref_nr.reconfigure("nfs", record_root=str(tmp_path / "nr"))
    name_resolve.reconfigure("nfs", record_root=str(tmp_path / "nr"))
    monkeypatch.setenv("AREAL_FILEROOT", str(tmp_path / "fileroot"))
    hf_dir = sft_runs["hf_dir"]
    for model_args, save in ((dict(config=dict(CFG)), "ValueError("),
                             (dict(model_path=hf_dir), None)):
        replies = {side: _worker_replies(side, hf_dir, model_args)
                   for side in ("port", "ref")}
        for side, r in replies.items():
            assert r["evaluate"]["error"].startswith("TypeError("), (side, r)
            if save is None:
                assert r["save"] == {"ok": True}, (side, r)
            else:
                assert r["save"]["error"].startswith(save), (side, r)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_main_sft_runs_on_the_cpu_in_a_subprocess(sft_runs, tmp_path):
    """From the port's last save (a plain qwen2 checkpoint with its
    tokenizer): the launcher trains, saves and evaluates."""
    env = dict(os.environ, AREAL_FILEROOT=str(tmp_path / "fileroot"), JAX_PLATFORMS="cpu")
    model = os.path.join(sft_runs["port"][1], f"step{STEPS}", "dp0")
    argv = _argv("launch", model, sft_runs["data"], save_freq_steps=STEPS,
                 eval_freq_steps=2) + [f"name_resolve_root={tmp_path / 'nr'}", "device=cpu"]
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "areal_tpu_torch.training.main_sft", *argv],
                          cwd=REPO_ROOT, env=env, capture_output=True, text=True,
                          timeout=RUN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert time.monotonic() - t0 < RUN_TIMEOUT_S
    save = tmp_path / "fileroot" / "checkpoints" / "launch" / "t0" / "default"
    assert _save_dirs(save) == [f"step{STEPS}/dp0"]


@pytest.mark.parametrize("override,item", [
    ("allocation_mode=d2", "item 7"), ("model.prefetch_depth=2", "item 3.4"),
    ("n_hosts=2", "item 7")])
def test_main_sft_refuses_what_is_not_ported(override, item):
    with pytest.raises(NotImplementedError, match=item):
        main_sft.main(["model.path=/nonexistent", "device=cpu", override])


def test_chip_smoke_sft_phase_rehearses_on_the_cpu():
    """chip_smoke's sft phase at a tiny size on the CPU (the kernels'
    plain versions): main_sft trains, saves and evaluates, the save reads
    a lower eval_loss than the initial weights, and both servers' greedy
    tokens equal an engine's on the saved params."""
    import chip_smoke
    from areal_tpu_torch.models.hf.qwen2 import r1_distill_qwen_1_5b_config

    cfg = r1_distill_qwen_1_5b_config(n_layers=2, hidden_dim=64, n_q_heads=4, n_kv_heads=2,
                                      head_dim=16, intermediate_dim=128, vocab_size=512,
                                      max_position_embeddings=4096)
    sizes = dict(n_rows=12, prompt=(8, 24), answer=(4, 12), max_length=40,
                 train_batch_size=4, steps=3, words=40, row_len=64, max_tokens_per_mb=256,
                 lr=1e-3, slots=4, max_seq_len=256, page=8, chunk=32, n_greedy=2,
                 greedy_lens=(5, 30), greedy_new=4)
    stats = chip_smoke.sft_phase(torch, np.random.default_rng(0), torch.device("cpu"), cfg,
                                 0, "cpu", sizes=sizes)
    assert len(stats["step_e2e_s"]) == 3 and stats["load_s"] > 0
    assert stats["eval"]["saved"]["eval_loss"] < stats["eval"]["initial"]["eval_loss"]
    assert stats["save_bytes"] > 0 and stats["greedy_tokens"] > 0
