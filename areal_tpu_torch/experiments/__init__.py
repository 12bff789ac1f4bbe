"""Experiment definitions: option dataclasses -> worker configs + MFC graph
(the port's copy of ``areal_tpu/experiments``). Each experiment is a
pure function from its cli_args dataclass to an ``ExperimentConfig``,
registered by the reference's name: "sft", "ppo-math" (sync PPO) and
"async-ppo-math".
"""

from areal_tpu_torch.api.registry import Registry

EXPERIMENT_REGISTRY = Registry("experiment")


def register_experiment(name: str, builder):
    EXPERIMENT_REGISTRY.register(name, builder)


def make_experiment(name: str, cfg):
    return EXPERIMENT_REGISTRY.make(name, cfg)


from areal_tpu_torch.experiments import (  # noqa: E402,F401
    async_ppo_math_exp,
    ppo_math_exp,
    sft_exp,
)
