"""Async PPO math experiment (the port's copy of
``areal_tpu/experiments/async_ppo_math_exp.py``): generation servers,
a gserver manager and rollout workers stream trajectories to a
stream-dataset trainer; the trainer's DFG is {ref_inf?} -> actor_train
with a post-hook param-realloc dump that the manager fans out to the
servers.

The port builds the single-step math agent on one device a worker.
Options whose feature the port lacks raise in ``refuse_unported`` before
any worker starts.
"""

from __future__ import annotations

import dataclasses

from areal_tpu_torch.api.cli_args import AsyncPPOMATHExpConfig, PPOMATHExpConfig
from areal_tpu_torch.api.config import (
    AgentAbstraction,
    EnvServiceAbstraction,
    ModelInterfaceAbstraction,
    ModelShardID,
)
from areal_tpu_torch.api.dfg import MFCDef, ModelInterfaceType, ParamReallocHook
from areal_tpu_torch.api.model_api import ModelName
from areal_tpu_torch.api.system_api import (
    ExperimentConfig,
    GenerationServerConfig,
    GserverManagerConfig,
    ModelShardSpec,
    RolloutWorkerConfig,
)
from areal_tpu_torch.experiments import common as C
from areal_tpu_torch.experiments import register_experiment


def refuse_unported(cfg: AsyncPPOMATHExpConfig):
    """Raise on every option set away from what the port runs."""
    models = {"actor": cfg.actor, "ref": cfg.ref}
    refused = {
        "auto_eval": cfg.auto_eval,
        "allocation_mode": cfg.allocation_mode != "d1",
        "n_model_workers": cfg.n_model_workers != 1,
        "train_n_hosts": cfg.train_n_hosts != 1,
        "critic": cfg.critic is not None,
        "agent_type": cfg.agent_type != "math-single-step",
        "ppo.generation_size": cfg.ppo.generation_size is not None,
        "gen_tensor_parallel": cfg.gen_tensor_parallel != 1,
        "gen_speculative_draft_len": cfg.gen_speculative_draft_len != 0,
        "gen_decode_weight_dtype": cfg.gen_decode_weight_dtype not in (None, "model"),
        "gen_weight_shards": bool(cfg.gen_weight_shards.strip(",")),
        "gen_elastic_fleet": cfg.gen_elastic_fleet,
        "gen_autoscale": cfg.gen_autoscale,
    }
    for role, m in models.items():
        if m is None:
            continue
        refused.update({
            f"{role}.backend": m.backend not in ("jax_train", "jax_inference"),
            f"{role}.attn_impl": m.attn_impl != "auto",
            f"{role}.mesh_spec": m.mesh_spec is not None,
            f"{role}.prefetch_depth": m.prefetch_depth != 0,
            f"{role}.stats_fetch_interval": m.stats_fetch_interval != 1,
            f"{role}.moe_dispatch": m.moe_dispatch is not None,
            f"{role}.moe_capacity_factor": m.moe_capacity_factor is not None,
            f"{role}.moe_aux_loss_coef": m.moe_aux_loss_coef is not None,
        })
    bad = [k for k, v in refused.items() if v]
    if bad:
        raise NotImplementedError(
            f"options not ported yet: {bad} (ROADMAP Queue A): leave them at "
            f"their defaults")


def actor_interface_args(cfg: PPOMATHExpConfig) -> dict:
    """The PPO actor's hyperparameters (the reference's, less the
    generation ones that only the sync experiment's generate MFC reads)."""
    p = cfg.ppo
    # group_size may be set at top level after construction (CLI
    # override), so resolve it here.
    p.group_size = cfg.group_size if cfg.group_size > 1 else p.group_size
    return dict(
        n_minibatches=p.ppo_n_minibatches,
        eps_clip=p.eps_clip,
        c_clip=p.c_clip,
        kl_ctl=p.kl_ctl,
        adaptive_kl_ctl=p.use_adaptive_kl_ctl,
        discount=p.discount,
        gae_lambda=p.gae_lambda,
        max_reward_clip=p.max_reward_clip,
        reward_output_scaling=p.reward_output_scaling,
        reward_output_bias=p.reward_output_bias,
        adv_norm=p.adv_norm,
        group_adv_norm=p.group_adv_norm,
        mask_no_eos_with_zero=p.mask_no_eos_with_zero,
        use_decoupled_loss=p.use_decoupled_loss,
        behav_imp_weight_cap=p.behav_imp_weight_cap,
        token_normalize_scope=p.token_normalize_scope,
    )


def build_async_ppo_math_experiment(cfg: AsyncPPOMATHExpConfig) -> ExperimentConfig:
    refuse_unported(cfg)
    n_workers = 1
    actor = ModelName("actor", 0)
    ref = ModelName("ref", 0)
    use_ref = cfg.ref is not None or (cfg.actor.path is not None and cfg.ppo.kl_ctl != 0.0)
    n_seqs = cfg.train_batch_size
    iface_args = actor_interface_args(cfg)

    train_input_keys = [
        "packed_input_ids", "prompt_mask", "packed_logprobs",
        "rewards", "seq_no_eos_mask",
    ]
    rpcs = []
    if use_ref:
        rpcs.append(MFCDef(
            name="ref_inf",
            model_name=ref,
            interface_type=ModelInterfaceType.INFERENCE,
            interface_impl=ModelInterfaceAbstraction("ppo_actor"),
            n_seqs=n_seqs,
            input_keys=("packed_input_ids", "prompt_mask"),
            output_keys=("logprobs",),
            output_key_remap={"logprobs": "ref_logprobs"},
            mb_spec=C.mb_spec(cfg, cfg.ref_inf),
        ))
        train_input_keys.append("ref_logprobs")
    rpcs.append(MFCDef(
        name="actor_train",
        model_name=actor,
        interface_type=ModelInterfaceType.TRAIN_STEP,
        interface_impl=ModelInterfaceAbstraction("ppo_actor"),
        n_seqs=n_seqs,
        input_keys=tuple(train_input_keys),
        mb_spec=C.mb_spec(cfg, cfg.actor_train),
        post_hooks=[ParamReallocHook(source=str(actor))],
    ))

    shards = [ModelShardSpec(
        id=ModelShardID(actor),
        model=C.model_abstraction(cfg.actor, cfg.tokenizer_path),
        backend=C.backend_abstraction(cfg.actor, train=True),
        interface=ModelInterfaceAbstraction("ppo_actor", args=iface_args),
    )]
    if use_ref:
        ref_cfg = cfg.ref or cfg.actor
        shards.append(ModelShardSpec(
            id=ModelShardID(ref),
            model=C.model_abstraction(ref_cfg, cfg.tokenizer_path),
            backend=C.backend_abstraction(ref_cfg, train=False),
            interface=ModelInterfaceAbstraction("ppo_actor", args=iface_args),
        ))
    workers = [C.base_model_worker(cfg, 0, n_workers, shards, with_dataset=False,
                                   stream_dataset=True)]
    names_ = C.worker_names(n_workers)
    model_topos = {str(actor): names_}
    if use_ref:
        model_topos[str(ref)] = names_
    master = C.base_master(cfg, rpcs, model_topos, n_workers)
    # The prompt dataset lives in the rollout workers: the master sizes
    # its epochs from the prompt count.
    master.dataset_size = C.dataset_line_count(cfg.dataset)

    # Disaggregated prefill/decode: a role per server index from the
    # comma-separated knob, padded with "unified" (the elastic pool).
    roles = [r.strip() or "unified" for r in (cfg.gen_server_roles or "").split(",")]
    roles += ["unified"] * (cfg.n_generation_servers - len(roles))
    gen_servers = [
        GenerationServerConfig(
            experiment_name=cfg.experiment_name,
            trial_name=cfg.trial_name,
            server_index=i,
            model=C.model_abstraction(cfg.actor, cfg.tokenizer_path),
            tokenizer_path=cfg.tokenizer_path or cfg.actor.path,
            max_concurrent_requests=cfg.gen_max_concurrent_requests,
            max_seq_len=cfg.gen_max_seq_len,
            decode_block_steps=cfg.gen_decode_block_steps,
            kv_page_size=cfg.gen_kv_page_size,
            kv_pool_tokens=cfg.gen_kv_pool_tokens,
            prompt_bucket=cfg.gen_prompt_bucket,
            prefill_max_batch=cfg.gen_prefill_max_batch,
            prefill_chunk=cfg.gen_prefill_chunk,
            chunked_prefill_per_lap=cfg.gen_chunked_prefill_per_lap,
            prefix_cache_tokens=cfg.gen_prefix_cache_tokens,
            kv_cache_dtype=cfg.gen_kv_cache_dtype,
            role=roles[i],
            kv_handoff_compress=cfg.gen_kv_handoff_compress,
            kv_tier_bytes=(cfg.gen_kv_tier_mb << 20 if cfg.gen_kv_tier_mb is not None
                           else None),
            kv_tier_disk_dir=cfg.gen_kv_tier_disk_dir,
            kv_spill_dtype=cfg.gen_kv_spill_dtype,
            seed=cfg.seed,
            device=cfg.device,
        )
        for i in range(cfg.n_generation_servers)
    ]
    manager = GserverManagerConfig(
        experiment_name=cfg.experiment_name,
        trial_name=cfg.trial_name,
        model_name=actor.role,
        n_servers=cfg.n_generation_servers,
        schedule_policy=cfg.schedule_policy,
        max_head_offpolicyness=cfg.ppo.max_head_offpolicyness,
        train_batch_size=cfg.train_batch_size,
        max_concurrent_rollouts=cfg.ppo.max_concurrent_rollouts,
        weight_plane=cfg.gen_weight_plane,
        weight_chunk_bytes=cfg.gen_weight_chunk_mb << 20,
        weight_fanout_degree=cfg.gen_weight_fanout,
        weight_cutover_budget_s=cfg.gen_weight_cutover_budget_s,
        weight_wire_dtype=cfg.gen_weight_wire_dtype,
        kv_index_size=cfg.gen_kv_index_size,
        elastic_pools=cfg.gen_elastic_pools,
        prefill_queue_high_tokens=cfg.gen_prefill_queue_high_tokens,
        prefill_queue_low_tokens=cfg.gen_prefill_queue_low_tokens,
        decode_free_page_min_frac=cfg.gen_decode_free_page_min_frac,
        elastic_fleet=cfg.gen_elastic_fleet,
    )
    agent = AgentAbstraction("math-single-step", args=dict(
        gconfig=dataclasses.asdict(cfg.ppo.gconfig.new(n=cfg.ppo.group_size)),
        success_rate_lb=cfg.ppo.success_rate_lb,
        success_rate_ub=cfg.ppo.success_rate_ub,
        reward_scaling=cfg.ppo.reward_output_scaling,
        reward_bias=cfg.ppo.reward_output_bias,
    ))
    rollouts = [
        RolloutWorkerConfig(
            experiment_name=cfg.experiment_name,
            trial_name=cfg.trial_name,
            worker_index=i,
            n_rollout_workers=cfg.n_rollout_workers,
            n_pullers=n_workers,
            model_name=actor.role,
            agent=agent,
            env=EnvServiceAbstraction("math-code-single-step"),
            datasets=[C.dataset_abstraction(cfg.dataset)],
            tokenizer_path=cfg.tokenizer_path or cfg.actor.path,
            new_tokens_per_chunk=cfg.ppo.new_tokens_per_chunk,
            max_concurrent_rollouts=max(
                1, cfg.ppo.max_concurrent_rollouts // cfg.n_rollout_workers),
            seed=cfg.seed,
        )
        for i in range(cfg.n_rollout_workers)
    ]
    return ExperimentConfig(
        experiment_name=cfg.experiment_name,
        trial_name=cfg.trial_name,
        master=master,
        model_workers=workers,
        rollout_workers=rollouts,
        gserver_manager=manager,
        generation_servers=gen_servers,
    )


register_experiment("async-ppo-math", build_async_ppo_math_experiment)
