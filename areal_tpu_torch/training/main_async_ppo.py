"""Async PPO entry point (the port's copy of ``training/main_async_ppo.py``).

Usage:
    python -m areal_tpu_torch.training.main_async_ppo \
        experiment_name=async-ppo actor.path=/ckpts/qwen \
        dataset.path=/data/math.jsonl ppo.max_head_offpolicyness=4 \
        n_generation_servers=1 n_rollout_workers=1

Runs on the card unless ``device=cpu`` is given.
"""

from areal_tpu_torch.api.cli_args import AsyncPPOMATHExpConfig
from areal_tpu_torch.training.utils import main as _main


def main(argv=None, worker_env=None, timeout=None):
    return _main("async-ppo-math", AsyncPPOMATHExpConfig, argv, worker_env=worker_env,
                 timeout=timeout)


if __name__ == "__main__":
    main()
