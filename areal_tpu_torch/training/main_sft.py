"""SFT entry point (the port's copy of ``training/main_sft.py``).

Usage:
    python -m areal_tpu_torch.training.main_sft \
        experiment_name=my-sft model.path=/ckpts/qwen2.5-1.5b \
        dataset.path=/data/sft.jsonl train_batch_size=64 \
        exp_ctrl.save_freq_steps=100

Runs on the card unless ``device=cpu`` is given. The model is saved in
the HF format under ``<fileroot>/checkpoints/<experiment>/<trial>/
default/step<version>/dp0`` at the ``exp_ctrl.save_freq_*`` frequencies.
The reference's pod-scale path (``n_hosts=...``, one process a host over
one global mesh) is not ported.
"""

import sys

from areal_tpu_torch.api.cli_args import SFTExpConfig
from areal_tpu_torch.training.utils import main as _main


def main(argv=None, worker_env=None, timeout=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if any(a.startswith("n_hosts=") for a in argv):
        raise NotImplementedError(
            "the multi-host SFT launch (n_hosts=...) is not ported yet "
            "(ROADMAP Queue A item 7, multi-device)")
    return _main("sft", SFTExpConfig, argv, worker_env=worker_env, timeout=timeout)


if __name__ == "__main__":
    main()
