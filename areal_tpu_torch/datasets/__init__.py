"""Registry-backed jsonl datasets (the port's copy of
``areal_tpu/datasets``). Importing this package registers
"math_code_prompt" (the prompts of the RL experiments), "prompt_answer"
(the SFT trainer's) and "prompt"; "rw_pair" is not ported."""

from areal_tpu_torch.datasets import math_code_prompt, prompt, prompt_answer  # noqa: F401
