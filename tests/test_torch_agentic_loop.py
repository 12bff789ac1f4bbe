"""Async PPO on tool-use episodes on the CPU, each package under its own
controller.

The port runs through its entry point: ``chip_smoke.async_ppo_phase`` with
``agentic=True`` calls
``areal_tpu_torch.training.main_async_ppo.main(argv)`` with
``agent_type=tool-use`` at a tiny size (2 layers, 16 prompts, 4 episodes
a step of 3 turns, 16 new tokens a turn) beside two port reward executors,
executor 0 armed to die on its first submit; the phase raises unless
every episode ran 3 turns with 2 tool calls and none failed, the python
tool answered 42 through the survivor, the continuation turns
re-prefilled only their deltas, the fanout landed versions 1 and 2 on the
server and every trained episode's lag stayed within the agentic window. The reference runs the same episodes under its
LocalController with two reference executors, executor 0 armed the same
way. Each run has its own deadline; no time is asserted.
"""

import os
import subprocess
import sys
import time
import uuid

import numpy as np
import pytest
import torch

import chip_smoke
from areal_tpu_torch.models.hf.qwen2 import r1_distill_qwen_1_5b_config

pytestmark = pytest.mark.serial

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AGENTIC_TINY = dict(chip_smoke.AGENTIC_SIZES, n_prompts=16, prompt=(8, 32), train_batch_size=4,
                    max_new_tokens=16, slots=8, max_seq_len=256, row_len=256,
                    max_tokens_per_mb=512, n_minibatches=2, words=60, exec_workers=1, page=16)
DEADLINE_S = 300.0


def test_port_trains_tool_use_episodes_through_its_entry_point():
    cfg = r1_distill_qwen_1_5b_config(n_layers=2, hidden_dim=64, n_q_heads=4, n_kv_heads=2,
                                      head_dim=16, intermediate_dim=128, vocab_size=512,
                                      max_position_embeddings=4096)
    stats = chip_smoke.async_ppo_phase(torch, np.random.default_rng(0), torch.device("cpu"),
                                       cfg, 0, "cpu", sizes=AGENTIC_TINY, agentic=True)
    assert stats["global_step"] == 2
    assert stats["episode_turns"] == [3.0, 3.0] and stats["tool_calls"] == [2.0, 2.0]
    assert stats["python_observations"] >= 8
    assert stats["executor0_exit"] == 1
    assert stats["executor_survivor"]["rexec_jobs_total"] >= 8
    assert stats["executor_survivor"]["rexec_job_failures"] == 0
    # Turn 0 re-prefills nothing; turns 1 and 2 the tool output only.
    med = stats["turn_reprefill_median"]
    assert med[0] == 0 and 0 < med[1] < 64 and 0 < med[2] < 64
    assert stats["continuation_reprefill"] < 0.5 * stats["continuation_full_prefill"]
    assert stats["prefix_cache_hits"] > 0
    assert max(stats["task_staleness_agentic"]) <= AGENTIC_TINY["window"]
    assert max(stats["staleness_hist"]) <= AGENTIC_TINY["window"]
    assert stats["server_final_version"] == 2


def _ref_executor(idx, exp, trial, nr_root, extra_env=None):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               JAX_PLATFORMS="cpu", AREAL_HEALTH_TTL="2")
    env.update(extra_env or {})
    return subprocess.Popen(
        [sys.executable, "-m", "areal_tpu.system.reward_executor", "--experiment", exp,
         "--trial", trial, "--index", str(idx), "--workers", "1", "--name-resolve-root",
         nr_root],
        env=env, cwd=REPO, stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)


def test_reference_trains_the_same_episodes_under_its_controller(tmp_path, monkeypatch):
    from areal_tpu.api.config import (AgentAbstraction, DatasetAbstraction,
                                      EnvServiceAbstraction, ModelAbstraction)
    from areal_tpu.api.system_api import (ExperimentConfig, GenerationServerConfig,
                                          GserverManagerConfig, RolloutWorkerConfig)
    from areal_tpu.base import name_resolve, names, tracing
    from areal_tpu.system.controller import LocalController
    from tests import fixtures
    from tests.system.test_async_e2e import _deflaked_env, _trainer_parts
    from tests.system.test_e2e_experiments import _mk_tokenizer_files

    exp, trial = f"tool-{uuid.uuid4().hex[:6]}", "t0"
    _, tok_dir = _mk_tokenizer_files(tmp_path)
    rows = [r for r in fixtures.make_math_code_rows(16, seed=13) if r["task"] == "math"]
    data_path = fixtures.write_jsonl(rows, tmp_path / "mc.jsonl")
    nr_root = str(tmp_path / "name_resolve")
    worker_env = _deflaked_env(tmp_path, monkeypatch)
    monkeypatch.setenv("AREAL_TASK_STALENESS_WINDOWS", "agentic:1")
    worker_env["AREAL_TASK_STALENESS_WINDOWS"] = "agentic:1"
    name_resolve.reconfigure("nfs", record_root=nr_root)
    procs = [_ref_executor(0, exp, trial, nr_root, {"AREAL_FAULTS": "rexec.die=die"}),
             _ref_executor(1, exp, trial, nr_root)]
    model_args, mw, master = _trainer_parts(exp, trial, tok_dir, n_seqs=4)
    cfg = ExperimentConfig(
        experiment_name=exp, trial_name=trial, master=master, model_workers=[mw],
        rollout_workers=[RolloutWorkerConfig(
            experiment_name=exp, trial_name=trial, worker_index=0, n_rollout_workers=1,
            n_pullers=1,
            agent=AgentAbstraction("tool-use", args=dict(
                gconfig=dict(max_new_tokens=8), num_turns=3, scripted_tool_turns=2)),
            env=EnvServiceAbstraction("tool-use"),
            datasets=[DatasetAbstraction("math_code_prompt", args=dict(dataset_path=data_path))],
            tokenizer_path=tok_dir, max_concurrent_rollouts=4)],
        gserver_manager=GserverManagerConfig(
            experiment_name=exp, trial_name=trial, model_name="actor", n_servers=1,
            train_batch_size=4, max_head_offpolicyness=1),
        generation_servers=[GenerationServerConfig(
            experiment_name=exp, trial_name=trial, server_index=0,
            model=ModelAbstraction("tpu_transformer", args=model_args), tokenizer_path=tok_dir,
            max_concurrent_requests=4, max_seq_len=256, decode_block_steps=4,
            prefix_cache_tokens=2048)])
    try:
        deadline, urls = time.monotonic() + 60, {}
        while len(urls) < 2 and time.monotonic() < deadline:
            for i in range(2):
                try:
                    urls[i] = name_resolve.get(names.reward_executor_url(exp, trial, str(i)))
                except name_resolve.NameEntryNotFoundError:
                    pass
            time.sleep(0.2)
        assert len(urls) == 2
        result = LocalController(cfg, name_resolve_cfg={"backend": "nfs", "record_root": nr_root},
                                 worker_env=worker_env).run(timeout=DEADLINE_S)
        assert result["global_step"] == 2
        overlap = result["perf_summary"]["overlap"]
        assert overlap["episode_turns"] == 3.0 and overlap["episode_tool_calls"] == 2.0
        assert overlap["task_staleness_agentic"] <= 1
        assert procs[0].wait(timeout=30) == 1 and procs[1].poll() is None
        metrics = chip_smoke.rexec_metrics(urls[1])
        assert metrics["areal:rexec_jobs_total"] >= 4
        assert metrics["areal:rexec_job_failures"] == 0
    finally:
        chip_smoke.stop_processes(procs)
        tracing.reconfigure()
        name_resolve.reconfigure("memory")
