"""Registry-backed jsonl datasets (the port's copy of
``areal_tpu/datasets``). Importing this package registers
"math_code_prompt", the rollout workers' prompt dataset, and
"prompt_answer", the SFT trainer's; "prompt" and "rw_pair" are not
ported."""

from areal_tpu_torch.datasets import math_code_prompt, prompt_answer  # noqa: F401
