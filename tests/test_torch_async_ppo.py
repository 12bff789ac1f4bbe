"""The port's async RL loop on the CPU, through its entry point.

``chip_smoke.async_ppo_phase`` runs
``areal_tpu_torch.training.main_async_ppo.main(argv)`` with the
reference's override keys at a tiny size: a GenerationServer, the
gserver manager, a rollout worker (math agent and env over seeded
prompts under a tiny tokenizer) and a model worker training a 2-layer
actor for 2 steps at max_head_offpolicyness 1. The phase itself fails
unless the manager's fanout landed versions 1 and 2 on the server and
every trained sample is within the staleness bound (read from the run's
trace); this test runs it and holds its report to the same facts. No
time is asserted: CPU speed says nothing of the card's.

A second run puts a prefill and a decode server in the fleet (a KV
tier, the prefix cache and the manager's prefix index) and holds the
rollouts to handoffs. The launcher's option surface is checked beside it: ``--help-config``
lists the reference's keys, and options the port lacks raise before any
worker starts.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from areal_tpu_torch.api import cli_args
from areal_tpu_torch.experiments import make_experiment
from areal_tpu_torch.models.hf.qwen2 import r1_distill_qwen_1_5b_config
from areal_tpu_torch.training import main_async_ppo

pytestmark = pytest.mark.serial

TINY_SIZES = dict(n_prompts=16, prompt=(8, 32), train_batch_size=4, group=2, max_new_tokens=16,
                  offpolicy=1, steps=2, slots=8, max_seq_len=256, row_len=256,
                  max_tokens_per_mb=512, n_minibatches=2, words=60)


def test_async_ppo_loop_trains_two_steps_on_cpu():
    cfg = r1_distill_qwen_1_5b_config(n_layers=2, hidden_dim=64, n_q_heads=4, n_kv_heads=2,
                                      head_dim=16, intermediate_dim=128, vocab_size=512,
                                      max_position_embeddings=4096)
    stats = chip_smoke.async_ppo_phase(torch, np.random.default_rng(0), torch.device("cpu"),
                                       cfg, 0, "cpu", sizes=TINY_SIZES)
    assert stats["global_step"] == 2
    # The server ended on the last trained version, through the fanout.
    assert stats["server_final_version"] == 2
    # Every trained sample: train step - version_start within the bound.
    assert sum(stats["staleness_hist"].values()) == 2 * TINY_SIZES["train_batch_size"]
    assert max(stats["staleness_hist"]) <= TINY_SIZES["offpolicy"]
    assert stats["output_tokens"] > 0
    assert np.isfinite(stats["importance_weight_step1"])


def test_async_ppo_loop_trains_through_a_prefill_decode_pair_on_cpu():
    """The same loop with gen_server_roles=prefill,decode, a KV tier, the
    prefix cache and the manager's prefix index: rollouts are handed off
    from the prefill server to the decode server, both servers take both
    versions, and the trainer's two steps land.
    Pages are 8 tokens, so every prompt covers one (a shorter prompt has
    no parked KV to hand off and is served where it prefilled)."""
    cfg = r1_distill_qwen_1_5b_config(n_layers=2, hidden_dim=64, n_q_heads=4, n_kv_heads=2,
                                      head_dim=16, intermediate_dim=128, vocab_size=512,
                                      max_position_embeddings=4096)
    stats = chip_smoke.async_ppo_phase(torch, np.random.default_rng(0), torch.device("cpu"),
                                       cfg, 0, "cpu", sizes=dict(TINY_SIZES, page=8),
                                       disagg=True)
    assert stats["global_step"] == 2 and stats["server_final_version"] == 2
    assert stats["handoff"]["ok"] > 0 and stats["handoff"]["imports"] >= stats["handoff"]["ok"]
    assert max(stats["staleness_hist"]) <= TINY_SIZES["offpolicy"]


def test_help_config_lists_the_reference_keys(capsys):
    with pytest.raises(SystemExit) as e:
        main_async_ppo.main(["--help-config"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for key in ("ppo.max_head_offpolicyness", "ppo.gconfig.max_new_tokens", "actor.path",
                "n_generation_servers", "gen_max_concurrent_requests", "device"):
        assert f"  {key} " in out


@pytest.mark.parametrize("override", [
    "train_n_hosts=2", "auto_eval=true", "allocation_mode=d2", "agent_type=tool-use",
    "gen_weight_shards=0/1", "gen_elastic_fleet=true", "gen_autoscale=true",
    "gen_tensor_parallel=2", "actor.prefetch_depth=2", "ppo.generation_size=8",
    "gen_speculative_draft_len=2",
])
def test_unported_options_raise(override):
    cfg = cli_args.AsyncPPOMATHExpConfig()
    cli_args.apply_overrides(cfg, ["actor.path=/nonexistent", "device=cpu", override])
    with pytest.raises(NotImplementedError, match=override.split("=")[0]):
        make_experiment("async-ppo-math", cfg)


def test_async_ppo_loop_trains_over_the_weight_plane_on_cpu():
    """The same loop with gen_weight_plane=true on the int8 wire, two
    servers at fanout degree 1: the model worker serves its dumps as the
    plane's origin, the manager chains origin -> S0 -> S1, and both
    servers cut over to versions 1 and 2 (the phase checks each version
    landed through the plane and that every second hop came from a
    peer)."""
    cfg = r1_distill_qwen_1_5b_config(n_layers=2, hidden_dim=64, n_q_heads=4, n_kv_heads=2,
                                      head_dim=16, intermediate_dim=128, vocab_size=512,
                                      max_position_embeddings=4096)
    stats = chip_smoke.async_ppo_phase(torch, np.random.default_rng(0), torch.device("cpu"),
                                       cfg, 0, "cpu", sizes=TINY_SIZES, plane=dict(wire="int8"))
    assert stats["global_step"] == 2 and stats["server_final_version"] == 2
    plane = stats["plane"]
    assert plane["wire"] == "int8"
    for step in range(2):
        origin = sum(b[step] for b in plane["bytes_from_origin"].values())
        peers = sum(b[step] for b in plane["bytes_from_peers"].values())
        assert origin == peers > 0  # one payload from the origin, one from the peer
    assert max(stats["staleness_hist"]) <= TINY_SIZES["offpolicy"]
