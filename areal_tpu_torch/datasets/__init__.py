"""Registry-backed jsonl datasets (the port's copy of
``areal_tpu/datasets``). Importing this package registers
"math_code_prompt" (the prompts of the RL experiments), "prompt_answer"
(the SFT trainer's), "prompt" and "rw_pair" (paired answers for reward
modelling)."""

from areal_tpu_torch.datasets import (  # noqa: F401
    math_code_prompt,
    prompt,
    prompt_answer,
    rw_paired,
)
