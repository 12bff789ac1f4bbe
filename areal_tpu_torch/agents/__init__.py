"""Rollout agents and environments (the port's copy of
``areal_tpu/agents``). Importing this package registers the agents
"math-single-step", "math-multi-turn", "tool-use" and "null", and the
environments "math-code-single-step" and "tool-use".
"""

from areal_tpu_torch.agents import envs  # noqa: F401
from areal_tpu_torch.agents import math_multi_turn  # noqa: F401
from areal_tpu_torch.agents import math_single_step  # noqa: F401
from areal_tpu_torch.agents import null  # noqa: F401
from areal_tpu_torch.agents import tool_use  # noqa: F401
