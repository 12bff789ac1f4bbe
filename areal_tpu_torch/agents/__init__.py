"""Rollout agents and environments (the port's copy of
``areal_tpu/agents``). Importing this package registers the
"math-single-step" agent and the "math-code-single-step" environment;
the multi-turn, tool-use and null agents and ``ToolEnv`` are not ported.
"""

from areal_tpu_torch.agents import envs  # noqa: F401
from areal_tpu_torch.agents import math_single_step  # noqa: F401
