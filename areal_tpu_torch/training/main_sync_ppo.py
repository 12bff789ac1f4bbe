"""Sync PPO entry point (the port's copy of ``training/main_sync_ppo.py``).

Usage:
    python -m areal_tpu_torch.training.main_sync_ppo \
        experiment_name=ppo actor.path=/ckpts/qwen dataset.path=/data/math.jsonl \
        ppo.gconfig.max_new_tokens=1024 group_size=8

Builds the ``ppo-math`` experiment (actor, reference, reward and, with
``ppo.disable_value=false critic.path=...``, the critic) on one model
worker and trains it through the relaunch loop of
``training/utils.py``. Runs on the card unless ``device=cpu`` is given.
"""

from areal_tpu_torch.api.cli_args import PPOMATHExpConfig
from areal_tpu_torch.training.utils import main as _main


def main(argv=None, worker_env=None, timeout=None):
    return _main("ppo-math", PPOMATHExpConfig, argv, worker_env=worker_env, timeout=timeout)


if __name__ == "__main__":
    main()
