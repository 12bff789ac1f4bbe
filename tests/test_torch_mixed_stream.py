"""A math stream and an agentic stream into one trainer, each package
under its own controller on the CPU.

Two rollout workers feed one buffer: worker 0 the single-step math agent
(one episode in flight, 4-token chunks), worker 1 the tool-use agent (2
turns, the first a scripted python call) through one reward executor of
the run's package. ``AREAL_TASK_STALENESS_WINDOWS=math:2,agentic:-1``:
the math window admits every math sample of a 2-step run, and a window
of -1 drops every agentic sample at admission whose lag (the trainer's
step less the sample's version_end) is 0 or more. Only an episode that
finished on new weights before the master's next step began has a lag
of -1 and passes. So both packages must drop agentic samples and no
math sample, whatever the timing. Each run has its own deadline; no
time is asserted.
"""

import os
import subprocess
import sys
import time
import uuid

import pytest

from tests import fixtures
from tests.system.test_e2e_experiments import TINY_CFG, _mk_tokenizer_files

pytestmark = pytest.mark.serial

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOWS = "math:2,agentic:-1"
DEADLINE_S = 300.0
N_SEQS = 4


def _modules(pkg):
    if pkg == "ref":
        from areal_tpu.api import config, dfg, system_api
        from areal_tpu.base import name_resolve, names
        from areal_tpu.system.controller import LocalController
    else:
        from areal_tpu_torch.api import config, dfg, system_api
        from areal_tpu_torch.base import name_resolve, names
        from areal_tpu_torch.system.controller import LocalController
    return config, dfg, system_api, name_resolve, names, LocalController


def _experiment(pkg, exp, trial, tok_dir, data_path):
    """The reference's mixed-stream run (tests/system/test_mixed_stream_e2e.py),
    built from either package's config classes."""
    config, dfg, sysapi = _modules(pkg)[:3]
    dev = {} if pkg == "ref" else dict(device="cpu")
    actor = dfg.ModelName("actor", 0)
    train = dfg.MFCDef(
        name="actor_train", model_name=actor, interface_type=dfg.ModelInterfaceType.TRAIN_STEP,
        interface_impl=None, n_seqs=N_SEQS,
        input_keys=("packed_input_ids", "prompt_mask", "packed_logprobs", "rewards",
                    "seq_no_eos_mask"),
        post_hooks=[dfg.ParamReallocHook(source=str(actor))])
    model = config.ModelAbstraction("tpu_transformer", args=dict(
        config=TINY_CFG, tokenizer_path=tok_dir, dtype="float32"))
    mw = sysapi.ModelWorkerConfig(
        experiment_name=exp, trial_name=trial, worker_index=0,
        shards=[sysapi.ModelShardSpec(
            id=config.ModelShardID(actor), model=model,
            backend=config.ModelBackendAbstraction("jax_train", args=dict(
                optimizer=dict(lr=1e-4), remat=False, row_len_multiple=8)),
            interface=config.ModelInterfaceAbstraction("ppo_actor", args=dict(kl_ctl=0.0)))],
        tokenizer_path=tok_dir, train_batch_size=N_SEQS, total_train_epochs=1,
        stream_dataset=True, n_pullers=1, **dev)
    master = sysapi.MasterWorkerConfig(
        experiment_name=exp, trial_name=trial,
        exp_ctrl=sysapi.ExperimentSaveEvalControl(total_train_epochs=1, benchmark_steps=2),
        rpcs=[train], model_topos={str(actor): ["model_worker/0"]},
        data_hosts=["model_worker/0"], n_model_workers=1, train_batch_size=N_SEQS)
    dataset = [config.DatasetAbstraction("math_code_prompt", args=dict(dataset_path=data_path))]
    common = dict(experiment_name=exp, trial_name=trial, n_rollout_workers=2, n_pullers=1,
                  datasets=dataset, tokenizer_path=tok_dir)
    math_worker = sysapi.RolloutWorkerConfig(
        worker_index=0, agent=config.AgentAbstraction(
            "math-single-step", args=dict(gconfig=dict(n=1, max_new_tokens=8))),
        env=config.EnvServiceAbstraction("math-code-single-step"), max_concurrent_rollouts=1,
        new_tokens_per_chunk=4, **common)
    tool_worker = sysapi.RolloutWorkerConfig(
        worker_index=1, agent=config.AgentAbstraction("tool-use", args=dict(
            gconfig=dict(max_new_tokens=8), num_turns=2, scripted_tool_turns=1)),
        env=config.EnvServiceAbstraction("tool-use"), max_concurrent_rollouts=4, **common)
    server = sysapi.GenerationServerConfig(
        experiment_name=exp, trial_name=trial, server_index=0, model=model,
        tokenizer_path=tok_dir, max_concurrent_requests=8, max_seq_len=256,
        decode_block_steps=4, prefix_cache_tokens=2048, **dev)
    manager = sysapi.GserverManagerConfig(
        experiment_name=exp, trial_name=trial, model_name="actor", n_servers=1,
        train_batch_size=N_SEQS, max_head_offpolicyness=100)
    return sysapi.ExperimentConfig(
        experiment_name=exp, trial_name=trial, master=master, model_workers=[mw],
        rollout_workers=[math_worker, tool_worker], gserver_manager=manager,
        generation_servers=[server])


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_mixed_math_and_agentic_streams_drop_by_task(tmp_path, monkeypatch, pkg):
    name_resolve, names, LocalController = _modules(pkg)[3:]
    exp, trial = f"mixed-{pkg}-{uuid.uuid4().hex[:6]}", "t0"
    _, tok_dir = _mk_tokenizer_files(tmp_path)
    rows = [r for r in fixtures.make_math_code_rows(16, seed=17) if r["task"] == "math"]
    data_path = fixtures.write_jsonl(rows, tmp_path / "mc.jsonl")
    nr_root = str(tmp_path / "name_resolve")
    env = {"JAX_PLATFORMS": "cpu", "AREAL_FILEROOT": str(tmp_path / "fileroot"),
           "AREAL_HEALTH_TTL": "60", "AREAL_TASK_STALENESS_WINDOWS": WINDOWS}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    name_resolve.reconfigure("nfs", record_root=nr_root)
    package = "areal_tpu" if pkg == "ref" else "areal_tpu_torch"
    executor = subprocess.Popen(
        [sys.executable, "-m", f"{package}.system.reward_executor", "--experiment", exp,
         "--trial", trial, "--index", "0", "--workers", "1", "--name-resolve-root", nr_root],
        env=dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", "")),
        cwd=REPO, stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                name_resolve.get(names.reward_executor_url(exp, trial, "0"))
                break
            except name_resolve.NameEntryNotFoundError:
                time.sleep(0.2)
        ctl = LocalController(_experiment(pkg, exp, trial, tok_dir, data_path),
                              name_resolve_cfg={"backend": "nfs", "record_root": nr_root},
                              worker_env=env)
        result = ctl.run(timeout=DEADLINE_S)
        assert result["global_step"] == 2
        # The master's per-task series (means over the steps that
        # reported them): math trained and never dropped, agentic samples
        # dropped, and an admitted agentic sample (a lag of -1 at
        # admission) trained at most one step behind.
        overlap = result["perf_summary"]["overlap"]
        assert "task_staleness_math" in overlap
        assert "task_stale_dropped_math" not in overlap
        assert overlap.get("task_stale_dropped_agentic", 0.0) >= 1
        assert overlap.get("task_staleness_agentic", 0.0) <= 1
        assert executor.poll() is None
    finally:
        if executor.poll() is None:
            executor.kill()
        executor.wait()
        name_resolve.reconfigure("memory")
