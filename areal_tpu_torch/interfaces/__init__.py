# Importing registers the bundled interfaces.
from areal_tpu_torch.interfaces import fused as _fused  # noqa: F401
from areal_tpu_torch.interfaces import ppo as _ppo  # noqa: F401
from areal_tpu_torch.interfaces import reward as _reward  # noqa: F401
from areal_tpu_torch.interfaces import sft as _sft  # noqa: F401
