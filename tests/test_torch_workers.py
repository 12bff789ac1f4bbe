"""Port parity of the worker system: the same 2-step async PPO trainer
runs under each package's ``LocalController`` on the CPU.

Both start from one HF directory written from numpy params (with a
tokenizer from ``tests.fixtures.train_tiny_tokenizer``, which the
reference's factory loads and the port's ignores), and both are fed the
same trajectories in the same order by a pusher of their own package.
The model workers read the directory through the family ``qwen2-f32``:
qwen2 with float32 compute, registered in each worker process by the
worker subclasses below (bf16 compute in JAX and in torch parts by
0.2-0.4 % on the grad norm of this model, beyond the 1e-3 limit).

Limits: every ``ppo_actor/*`` stat of each step within rtol 1e-3 (atol
1e-6), the PPO interface parity limit of tests/test_torch_interfaces.py.
The realloc dumps are held by their updates, not their params: for each
leaf, ||(port - init) - (ref - init)|| / ||ref - init|| must stay within
UPDATE_RTOL, and the port's dump must have moved from init. Then a port
GenerationServer loaded from the port's dump and a reference server
loaded from the reference's answer greedy requests with equal tokens.
A second test plants the fault the update check exists for: a port
model worker that dumps the params from before its train step, stamped
with the version after it, must fail the check.

Each run is bounded by ``LocalController.run(timeout=RUN_TIMEOUT_S)``,
every socket wait by its own timeout, and the workers are torn down in
``finally``.
"""

import dataclasses
import json
import os
import threading
import time
import urllib.request
import uuid

import jax
import numpy as np
import pytest

from areal_tpu.api import config as rcfg
from areal_tpu.api import data_api as rdata
from areal_tpu.api import dfg as rdfg
from areal_tpu.api import system_api as rsys
from areal_tpu.base import name_resolve as ref_nr
from areal_tpu.system import controller as rctl
from areal_tpu.system import model_worker as rmw
from areal_tpu.system import push_pull_stream as rpps
from areal_tpu.system import weight_transfer as rwt
from areal_tpu_torch.api import config as tcfg
from areal_tpu_torch.api import dfg as tdfg
from areal_tpu_torch.api import system_api as tsys
from areal_tpu_torch.base import name_resolve
from areal_tpu_torch.convert import params_from_numpy
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.hf import save_hf_model
from areal_tpu_torch.system import controller as tctl
from areal_tpu_torch.system import model_worker as tmw
from areal_tpu_torch.system import push_pull_stream as tpps
from areal_tpu_torch.system import weight_transfer as twt
from tests import fixtures

pytestmark = pytest.mark.serial

RUN_TIMEOUT_S = 300
N_PROMPTS, GROUP, STEPS, N_MBS, LR = 4, 2, 2, 2, 1e-4
CFG = dict(n_layers=2, hidden_dim=32, n_q_heads=4, n_kv_heads=2, head_dim=8,
           intermediate_dim=64, vocab_size=fixtures.VOCAB_SIZE, max_position_embeddings=512,
           attn_bias=True, compute_dtype="float32", param_dtype="float32")
# Readings on this model (CPU, float32): sound port runs at most 7.0e-6
# (init and data seed 0) and 1.0e-5 (seed 7) per leaf; the planted stale
# dump at least 0.437, never-trained params 1.
UPDATE_RTOL = 2e-4
F32_FAMILY = "qwen2-f32"
SERVER_KW = dict(max_concurrent_requests=4, max_seq_len=128, kv_page_size=16,
                 decode_block_steps=4, seed=0)


def _f32(family):
    """qwen2 read with float32 compute."""
    base = family.config_from_hf

    def config_from_hf(hf, is_critic=False):
        cfg = base(hf, is_critic)
        cfg.compute_dtype = "float32"
        return cfg

    return dataclasses.replace(family, name=F32_FAMILY, hf_model_type=F32_FAMILY,
                               config_from_hf=config_from_hf)


class RefF32ModelWorker(rmw.ModelWorker):
    def _configure(self, config):
        from areal_tpu.api.model_api import HF_FAMILY_REGISTRY, register_hf_family
        from areal_tpu.models.hf import get_family

        if F32_FAMILY not in HF_FAMILY_REGISTRY:
            register_hf_family(F32_FAMILY, _f32(get_family("qwen2")))
        super()._configure(config)


class PortF32ModelWorker(tmw.ModelWorker):
    def _configure(self, config):
        from areal_tpu_torch.models.hf import HF_FAMILY_REGISTRY, get_family, register_hf_family

        if F32_FAMILY not in HF_FAMILY_REGISTRY:
            register_hf_family(F32_FAMILY, _f32(get_family("qwen2")))
        super()._configure(config)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


class PortStaleDumpModelWorker(PortF32ModelWorker):
    """Planted fault: the realloc dump holds the params from before the
    train step, stamped with the version after it."""

    def _handle_mfc(self, req):
        self._before = _clone(self.models[req.data["model_name"]].module.get_params())
        return super()._handle_mfc(req)

    def _param_realloc(self, hook, step=0):
        module = self.models[hook["source"]].module
        module.get_params = lambda: self._before
        try:
            return super()._param_realloc(hook, step)
        finally:
            del module.get_params


class RefController(rctl.LocalController):
    def start_workers(self):
        for cfg in self.exp_cfg.model_workers:
            self._spawn(f"{__name__}:RefF32ModelWorker", cfg)


class PortController(tctl.LocalController):
    worker = "PortF32ModelWorker"

    def start_workers(self):
        for cfg in self.exp_cfg.model_workers:
            self._spawn(f"{__name__}:{self.worker}", cfg)


class PortStaleDumpController(PortController):
    worker = "PortStaleDumpModelWorker"


def _trajectories(seed=0):
    """STEPS x N_PROMPTS grouped rollouts as JSON, in push order."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(STEPS * N_PROMPTS):
        plen = int(rng.integers(3, 8))
        seqs, pms, lps, lens = [], [], [], []
        for _ in range(GROUP):
            n = plen + int(rng.integers(2, 11))
            seqs.append(rng.integers(1, fixtures.VOCAB_SIZE, size=n))
            pms.append((np.arange(n) < plen).astype(np.int64))
            lp = np.zeros(n, np.float32)
            lp[plen - 1:n - 1] = -np.abs(rng.standard_normal(n - plen)) - 0.1
            lps.append(lp)
            lens.append(n)
        s = rdata.SequenceSample(
            ids=[f"q{i}"],
            keys={"packed_input_ids", "prompt_mask", "packed_logprobs", "rewards",
                  "seq_no_eos_mask"},
            data={"packed_input_ids": np.concatenate(seqs), "prompt_mask": np.concatenate(pms),
                  "packed_logprobs": np.concatenate(lps),
                  "rewards": np.array([5.0, -5.0], np.float32),
                  "seq_no_eos_mask": np.array([0.0, float(i % 2)], np.float32)},
            seqlens={"packed_input_ids": [lens], "prompt_mask": [lens],
                     "packed_logprobs": [lens], "rewards": [[1] * GROUP],
                     "seq_no_eos_mask": [[1] * GROUP]})
        out.append(rdata.sample_to_json(s))
    return out


def _experiment(pkg, exp, hf_dir, device):
    cfg, dfg, sysapi = pkg
    actor = dfg.ModelName("actor", 0)
    train = dfg.MFCDef(
        name="actor_train", model_name=actor, interface_type=dfg.ModelInterfaceType.TRAIN_STEP,
        interface_impl=None, n_seqs=N_PROMPTS,
        input_keys=("packed_input_ids", "prompt_mask", "packed_logprobs", "rewards",
                    "seq_no_eos_mask"),
        post_hooks=[dfg.ParamReallocHook(source=str(actor))])
    model_args = dict(model_path=hf_dir, hf_family=F32_FAMILY, tokenizer_path=hf_dir)
    mw = sysapi.ModelWorkerConfig(
        experiment_name=exp, trial_name="t0", worker_index=0,
        shards=[sysapi.ModelShardSpec(
            id=cfg.ModelShardID(actor),
            model=cfg.ModelAbstraction("tpu_transformer", args=model_args),
            backend=cfg.ModelBackendAbstraction("jax_train", args=dict(
                optimizer=dict(lr=LR, warmup_steps_proportion=0.0), remat=False,
                row_len_multiple=8)),
            interface=cfg.ModelInterfaceAbstraction("ppo_actor", args=dict(
                kl_ctl=0.0, n_minibatches=N_MBS)))],
        tokenizer_path=hf_dir, train_batch_size=N_PROMPTS, stream_dataset=True, **device)
    master = sysapi.MasterWorkerConfig(
        experiment_name=exp, trial_name="t0",
        exp_ctrl=sysapi.ExperimentSaveEvalControl(benchmark_steps=STEPS), rpcs=[train],
        model_topos={str(actor): ["model_worker/0"]}, data_hosts=["model_worker/0"],
        n_model_workers=1, train_batch_size=N_PROMPTS)
    return sysapi.ExperimentConfig(experiment_name=exp, trial_name="t0", master=master,
                                   model_workers=[mw])


def _run(side, tmp, hf_dir, trajs, monkeypatch, ctl_cls=PortController):
    """One trainer run; returns (per-step train stats, dump dir)."""
    if side == "ref":
        pkg, ctl_cls, nr, pps, device = (rcfg, rdfg, rsys), RefController, ref_nr, rpps, {}
        from areal_tpu.system.function_executor import FunctionExecutor
    else:
        pkg, nr, pps, device = (tcfg, tdfg, tsys), name_resolve, tpps, dict(device="cpu")
        from areal_tpu_torch.system.function_executor import FunctionExecutor
    exp = f"{side}-{uuid.uuid4().hex[:6]}"
    fileroot = str(tmp / "fileroot")
    nr_cfg = {"backend": "nfs", "record_root": str(tmp / "nr")}
    monkeypatch.setenv("AREAL_FILEROOT", fileroot)
    steps = []
    inner = FunctionExecutor.execute_step_sync

    def recording(self):
        steps.append(inner(self))
        return steps[-1]

    monkeypatch.setattr(FunctionExecutor, "execute_step_sync", recording)
    ctl = ctl_cls(_experiment(pkg, exp, hf_dir, device), name_resolve_cfg=nr_cfg,
                  worker_env={"JAX_PLATFORMS": "cpu", "AREAL_FILEROOT": fileroot})
    box = {}

    def rollout():
        try:
            pusher = pps.NameResolvingZmqPusher(exp, "t0", pusher_index=0, n_pushers=1,
                                                n_pullers=1, ack=True)
            try:
                for i, t in enumerate(trajs):
                    pusher.push(t, seq=f"0/{i}")
                deadline = time.monotonic() + RUN_TIMEOUT_S
                while pusher.unacked() and time.monotonic() < deadline:
                    pusher.drain_acks()
                    time.sleep(0.02)
                box["unacked"] = pusher.unacked()
            finally:
                pusher.close()
        except Exception as e:
            box["error"] = repr(e)

    nr.reconfigure(**nr_cfg)
    feeder = threading.Thread(target=rollout, daemon=True)
    feeder.start()
    try:
        result = ctl.run(timeout=RUN_TIMEOUT_S)
    finally:
        ctl.join(timeout=30)
        feeder.join(timeout=30)
    assert box == {"unacked": 0}, box
    assert result["global_step"] == STEPS
    return [s["actor_train"] for s in steps], os.path.join(
        fileroot, "param_realloc", exp, "t0", "actor")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree) for k2, v in _leaves(tree[k], f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree, dtype=np.float64)}


def _dump_leaves(load, dump_dir):
    params, version = load(dump_dir)
    assert version == STEPS, version
    return _leaves(params)


def _update_errors(got, want, init):
    """leaf -> ||(got - init) - (want - init)|| / ||want - init||; raises
    if a leaf of `got` or `want` did not move from `init`."""
    assert sorted(got) == sorted(want) == sorted(init)
    out = {}
    for k in want:
        step_got, step_want = got[k] - init[k], want[k] - init[k]
        assert np.linalg.norm(step_want) > 0, f"the reference's {k} did not move"
        assert np.linalg.norm(step_got) > 0, f"{k} did not move from init"
        out[k] = float(np.linalg.norm(step_got - step_want) / np.linalg.norm(step_want))
    return out


def _check_update(got, want, init):
    errs = _update_errors(got, want, init)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= UPDATE_RTOL, f"{worst}: update off by {errs[worst]:.4g} of its norm"


def _post(url, path, payload):
    req = urllib.request.Request(url + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _serve_greedy(side, tmp, dump_dir, prompts):
    """Greedy tokens of a server of `side`'s package loaded from `dump_dir`."""
    exp = f"serve-{side}-{uuid.uuid4().hex[:6]}"
    if side == "ref":
        from areal_tpu.system.generation_server import GenerationServer

        import areal_tpu.engine.factories  # noqa: F401  (the reference's model registry)
        cfg = rsys.GenerationServerConfig(
            experiment_name=exp, trial_name="t0",
            model=rcfg.ModelAbstraction("tpu_transformer", args=dict(config=dict(CFG))),
            **SERVER_KW)
    else:
        from areal_tpu_torch.system.generation_server import GenerationServer

        cfg = tsys.GenerationServerConfig(
            experiment_name=exp, trial_name="t0",
            model=tcfg.ModelAbstraction("tpu_transformer", args=dict(config=dict(CFG))),
            device="cpu", **SERVER_KW)
    server = GenerationServer()
    server.configure(cfg, experiment_name=exp, trial_name="t0", worker_name=cfg.worker_name)
    thread = threading.Thread(target=server.run, daemon=True)
    thread.start()
    try:
        upd = _post(server.address, "/update_weights_from_disk",
                    {"model_path": dump_dir, "allow_interrupt": True, "version": STEPS})
        assert upd["success"] and upd["source"] == "disk_raw", upd
        return [_post(server.address, "/generate", {
            "qid": f"g{i}", "input_ids": p,
            "gconfig": {"max_new_tokens": 8, "greedy": True}})["output_ids"]
            for i, p in enumerate(prompts)]
    finally:
        server.exit()
        thread.join(timeout=30)


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """One HF directory, the trajectories, and the reference's run on
    them, shared by the tests of this module."""
    tmp = tmp_path_factory.mktemp("workers")
    from areal_tpu.models.config import TransformerConfig as RefTransformerConfig
    from areal_tpu.models.transformer import init_params

    tree = jax.tree_util.tree_map(
        np.asarray, init_params(RefTransformerConfig(**CFG), jax.random.PRNGKey(0)))
    hf_dir = str(tmp / "hf")
    save_hf_model(hf_dir, TransformerConfig(**CFG), params_from_numpy(tree, device="cpu"),
                  "qwen2")
    rows = fixtures.make_sft_rows(32, seed=3)
    fixtures.train_tiny_tokenizer([r["prompt"] + " " + r["answer"] for r in rows],
                                  tmp).save_pretrained(hf_dir)
    trajs = _trajectories()
    saved = ref_nr._default.repo, name_resolve._default.repo
    try:
        with pytest.MonkeyPatch.context() as mp:
            steps, dump = _run("ref", tmp / "ref", hf_dir, trajs, mp)
    finally:
        ref_nr._default.repo, name_resolve._default.repo = saved
    return dict(hf_dir=hf_dir, trajs=trajs, init=_leaves(tree), steps=steps, dump=dump,
                params=_dump_leaves(rwt.load_raw_params, dump))


@pytest.fixture
def restore_name_resolve():
    saved = ref_nr._default.repo, name_resolve._default.repo
    yield
    ref_nr._default.repo, name_resolve._default.repo = saved


def test_async_trainer_matches_reference_under_both_controllers(
        ref_run, tmp_path, monkeypatch, restore_name_resolve):
    port_steps, port_dump = _run("port", tmp_path / "port", ref_run["hf_dir"],
                                 ref_run["trajs"], monkeypatch)
    for i, (got, want) in enumerate(zip(port_steps, ref_run["steps"])):
        keys = sorted(k for k in want if k.startswith("ppo_actor/"))
        assert keys and keys == sorted(k for k in got if k.startswith("ppo_actor/"))
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6,
                                       err_msg=f"step {i + 1} {k}")

    got = _dump_leaves(twt.load_raw_params, port_dump)
    _check_update(got, ref_run["params"], ref_run["init"])

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, fixtures.VOCAB_SIZE, size=n).tolist() for n in (5, 11, 23)]
    assert _serve_greedy("port", tmp_path, port_dump, prompts) == \
        _serve_greedy("ref", tmp_path, ref_run["dump"], prompts)


def test_update_check_fails_a_dump_taken_before_the_step(
        ref_run, tmp_path, monkeypatch, restore_name_resolve):
    """The planted faults: a port worker whose dump holds the params from
    before its last train step (stamped with the version after it), and
    params that never trained. Both fail the update check."""
    _, stale_dump = _run("port", tmp_path / "stale", ref_run["hf_dir"], ref_run["trajs"],
                         monkeypatch, ctl_cls=PortStaleDumpController)
    want, init = ref_run["params"], ref_run["init"]
    stale = _dump_leaves(twt.load_raw_params, stale_dump)
    with pytest.raises(AssertionError, match="update off by"):
        _check_update(stale, want, init)
    with pytest.raises(AssertionError, match="did not move from init"):
        _check_update(init, want, init)
