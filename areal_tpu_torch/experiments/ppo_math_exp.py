"""Sync PPO math experiment (the port's copy of
``areal_tpu/experiments/ppo_math_exp.py``, registered as "ppo-math").

DFG: actor_gen -> {rew_inf, ref_inf?, critic_inf?} ->
{critic_train?, actor_train}, every model colocated on the model worker;
generation runs in-framework in the actor's engine (``TorchTrainEngine.
generate``), the reward shard grades on the host on the mock backend, and
the critic is two engines, critic@0 for ``critic_inf`` and critic@1 for
``critic_train``. As in the reference no param-realloc hook joins them,
so the values come from the initial critic at every step.

The port trains on one device a worker. Options whose feature the port
lacks raise in ``refuse_unported`` before any worker starts, each naming
the ROADMAP Queue A item that brings it.
"""

from __future__ import annotations

import dataclasses
from typing import List

from areal_tpu_torch.api.cli_args import PPOMATHExpConfig
from areal_tpu_torch.api.config import (
    ModelBackendAbstraction,
    ModelInterfaceAbstraction,
    ModelShardID,
)
from areal_tpu_torch.api.dfg import MFCDef, ModelInterfaceType
from areal_tpu_torch.api.model_api import ModelName
from areal_tpu_torch.api.system_api import ExperimentConfig, ModelShardSpec
from areal_tpu_torch.experiments import common as C
from areal_tpu_torch.experiments import register_experiment

_MESH = "ROADMAP Queue A item 7, multi-device"
_KNOBS = "ROADMAP Queue A item 3.4, the engine's last knobs"
_BACKENDS = ("jax_train", "jax_inference", "mock_train", "mock_inference")


def refuse_unported(cfg: PPOMATHExpConfig):
    """Raise on every option set away from what the port runs."""
    refused = {
        "auto_eval": (cfg.auto_eval, "ROADMAP Queue A item 8, evaluation"),
        "allocation_mode": (cfg.allocation_mode != "d1", _MESH),
        "n_model_workers": (cfg.n_model_workers != 1, _MESH),
        "train_n_hosts": (cfg.train_n_hosts != 1, _MESH),
    }
    for role, m in (("actor", cfg.actor), ("ref", cfg.ref), ("critic", cfg.critic)):
        if m is None:
            continue
        refused.update({
            f"{role}.backend": (m.backend not in _BACKENDS, "backends other than the "
                                f"reference's {_BACKENDS}"),
            f"{role}.attn_impl": (m.attn_impl != "auto", _MESH),
            f"{role}.mesh_spec": (m.mesh_spec is not None, _MESH),
            f"{role}.prefetch_depth": (m.prefetch_depth != 0, _KNOBS),
            f"{role}.stats_fetch_interval": (m.stats_fetch_interval != 1, _KNOBS),
        })
        for k in ("moe_dispatch", "moe_capacity_factor", "moe_aux_loss_coef"):
            refused[f"{role}.{k}"] = (getattr(m, k) is not None,
                                      "ROADMAP Queue A item 6.2, MoE")
    bad = [f"{k} ({why})" for k, (hit, why) in refused.items() if hit]
    if bad:
        raise NotImplementedError(
            f"options not ported yet: {bad}: leave them at their defaults")


def actor_interface_args(cfg: PPOMATHExpConfig) -> dict:
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
        generation_size=p.generation_size,
        gconfig=dataclasses.asdict(p.gconfig.new(n=p.group_size)),
    )


def critic_interface_args(cfg: PPOMATHExpConfig) -> dict:
    """The critic's hyperparameters (those it shares with the actor, KL,
    GAE, reward shaping and the token-normalization scope, must agree, or
    value and policy gradients normalize differently)."""
    p = cfg.ppo
    return dict(
        n_minibatches=p.ppo_n_minibatches,
        token_normalize_scope=p.token_normalize_scope,
        value_eps_clip=p.value_eps_clip,
        kl_ctl=p.kl_ctl,
        adaptive_kl_ctl=p.use_adaptive_kl_ctl,
        discount=p.discount,
        gae_lambda=p.gae_lambda,
        max_reward_clip=p.max_reward_clip,
        reward_output_scaling=p.reward_output_scaling,
        reward_output_bias=p.reward_output_bias,
        mask_no_eos_with_zero=p.mask_no_eos_with_zero,
    )


def build_ppo_math_experiment(cfg: PPOMATHExpConfig) -> ExperimentConfig:
    refuse_unported(cfg)
    n_workers = C.resolve_n_workers(cfg)
    actor = ModelName("actor", 0)
    ref = ModelName("ref", 0)
    rew = ModelName("reward", 0)
    critic = ModelName("critic", 0)
    use_critic = not cfg.ppo.disable_value and cfg.critic is not None
    use_ref = cfg.ref is not None or (cfg.actor.path is not None)

    n_seqs = cfg.train_batch_size
    rpcs: List[MFCDef] = [
        MFCDef(
            name="actor_gen",
            model_name=actor,
            interface_type=ModelInterfaceType.GENERATE,
            interface_impl=ModelInterfaceAbstraction("ppo_actor"),
            n_seqs=n_seqs,
            input_keys=("packed_prompts",),
            output_keys=("packed_input_ids", "prompt_mask", "packed_logprobs",
                         "seq_no_eos_mask"),
            balanced_dp=True,
            mb_spec=C.mb_spec(cfg, cfg.actor_gen),
        ),
        MFCDef(
            name="rew_inf",
            model_name=rew,
            interface_type=ModelInterfaceType.INFERENCE,
            interface_impl=ModelInterfaceAbstraction("rw-math-code"),
            n_seqs=n_seqs,
            input_keys=("packed_input_ids", "prompt_mask"),
            output_keys=("rewards",),
            mb_spec=C.mb_spec(cfg, cfg.rew_inf),
        ),
    ]
    train_input_keys = ["packed_input_ids", "prompt_mask", "packed_logprobs", "rewards",
                        "seq_no_eos_mask"]
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
    if use_critic:
        critic_impl = ModelInterfaceAbstraction("ppo_critic", args=critic_interface_args(cfg))
        rpcs.append(MFCDef(
            name="critic_inf",
            model_name=critic,
            interface_type=ModelInterfaceType.INFERENCE,
            interface_impl=critic_impl,
            n_seqs=n_seqs,
            input_keys=("packed_input_ids", "prompt_mask"),
            output_keys=("values",),
            mb_spec=C.mb_spec(cfg, cfg.critic_inf),
        ))
        train_input_keys.append("values")
        rpcs.append(MFCDef(
            name="critic_train",
            model_name=ModelName("critic", 1),
            interface_type=ModelInterfaceType.TRAIN_STEP,
            interface_impl=critic_impl,
            n_seqs=n_seqs,
            input_keys=tuple(train_input_keys),
            mb_spec=C.mb_spec(cfg, cfg.critic_train),
        ))
    rpcs.append(MFCDef(
        name="actor_train",
        model_name=actor,
        interface_type=ModelInterfaceType.TRAIN_STEP,
        interface_impl=ModelInterfaceAbstraction("ppo_actor"),
        n_seqs=n_seqs,
        input_keys=tuple(train_input_keys),
        mb_spec=C.mb_spec(cfg, cfg.actor_train),
    ))

    iface_args = actor_interface_args(cfg)
    workers = []
    for i in range(n_workers):
        shards = [
            ModelShardSpec(
                id=ModelShardID(actor, host_rank=i, n_hosts=n_workers),
                model=C.model_abstraction(cfg.actor, cfg.tokenizer_path),
                backend=C.backend_abstraction(cfg.actor, train=True),
                interface=ModelInterfaceAbstraction("ppo_actor", args=iface_args),
            ),
            ModelShardSpec(
                id=ModelShardID(rew, host_rank=i, n_hosts=n_workers),
                model=C.model_abstraction(cfg.actor, cfg.tokenizer_path),
                backend=ModelBackendAbstraction("mock_inference"),
                interface=ModelInterfaceAbstraction("rw-math-code"),
            ),
        ]
        if use_ref:
            ref_cfg = cfg.ref or cfg.actor
            shards.append(ModelShardSpec(
                id=ModelShardID(ref, host_rank=i, n_hosts=n_workers),
                model=C.model_abstraction(ref_cfg, cfg.tokenizer_path),
                backend=C.backend_abstraction(ref_cfg, train=False),
                interface=ModelInterfaceAbstraction("ppo_actor", args=iface_args),
            ))
        if use_critic:
            for replica in (0, 1):
                shards.append(ModelShardSpec(
                    id=ModelShardID(ModelName("critic", replica), host_rank=i,
                                    n_hosts=n_workers),
                    model=C.model_abstraction(cfg.critic, cfg.tokenizer_path, is_critic=True),
                    backend=C.backend_abstraction(cfg.critic, train=(replica == 1)),
                    interface=ModelInterfaceAbstraction("ppo_critic",
                                                        args=critic_interface_args(cfg)),
                ))
        workers.append(C.base_model_worker(cfg, i, n_workers, shards))

    names = C.worker_names(n_workers)
    model_topos = {str(actor): names, str(rew): names}
    if use_ref:
        model_topos[str(ref)] = names
    if use_critic:
        model_topos[str(ModelName("critic", 0))] = names
        model_topos[str(ModelName("critic", 1))] = names
    master = C.base_master(cfg, rpcs, model_topos, n_workers)
    return ExperimentConfig(
        experiment_name=cfg.experiment_name,
        trial_name=cfg.trial_name,
        master=master,
        model_workers=workers,
    )


register_experiment("ppo-math", build_ppo_math_experiment)
