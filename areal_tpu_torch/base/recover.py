"""Recovery metadata: step counters, frequency-control state, consumed
data (the port's copy of ``areal_tpu/base/recover.py``).

`RecoverInfo` is dumped by the master at each checkpoint barrier and
loaded on relaunch so training resumes where it stopped, with the
samples consumed so far this epoch skipped by id and the rollout
sequences already trained filtered by the ledger.

The record is the reference's pickle: the port writes its classes under
the reference's names (``areal_tpu.base.recover.RecoverInfo``,
``StepInfo``) and reads either package's record back as its own
(``base/pickle_compat.py``), so each package resumes from the other's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

from areal_tpu_torch.base import constants, pickle_compat
from areal_tpu_torch.base.wire_schemas import RECOVER_INFO_V1


@dataclasses.dataclass
class StepInfo:
    epoch: int = 0
    epoch_step: int = 0
    global_step: int = 0

    def next(self):
        return StepInfo(
            epoch=self.epoch,
            epoch_step=self.epoch_step + 1,
            global_step=self.global_step + 1,
        )


@dataclasses.dataclass
class RecoverInfo:
    recover_start: StepInfo = dataclasses.field(default_factory=StepInfo)
    last_step_info: StepInfo = dataclasses.field(default_factory=StepInfo)
    save_ctl_info: Dict[str, Any] = dataclasses.field(default_factory=dict)
    ckpt_ctl_info: Dict[str, Any] = dataclasses.field(default_factory=dict)
    eval_ctl_info: Dict[str, Any] = dataclasses.field(default_factory=dict)
    data_loading_dp_idx: int = 0
    hash_vals_to_ignore: List[int] = dataclasses.field(default_factory=list)
    # Exactly-once sample ledger snapshot (system/wal.py SeqLedger
    # to_dict form): which rollout sequence ids were fully consumed as
    # of this checkpoint barrier, persisted with the step counters.
    consumed_seqs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Per-dataset read cursors (worker_name -> dataloader state dict).
    dataset_cursors: Dict[str, Any] = dataclasses.field(default_factory=dict)


# The reference's names for these classes, written into every record.
_REF_MODULE = "areal_tpu.base.recover"
_NAMES = {StepInfo: (_REF_MODULE, "StepInfo"), RecoverInfo: (_REF_MODULE, "RecoverInfo")}
_CLASSES = {names: cls for cls, names in _NAMES.items()}


def dump_path(experiment: Optional[str] = None, trial: Optional[str] = None) -> str:
    return os.path.join(constants.get_recover_path(experiment, trial), "recover_info.pkl")


def dump(info: RecoverInfo, experiment: Optional[str] = None, trial: Optional[str] = None):
    """Atomic, schema-versioned dump: tmp + fsync + rename + fsync of the
    directory, so a crash mid-write never poisons the next
    ``recover_mode=auto`` start."""
    path = dump_path(experiment, trial)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle_compat.dump({"schema": RECOVER_INFO_V1, "info": info}, f, _NAMES)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dir_fd = os.open(os.path.dirname(path), os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def load(experiment: Optional[str] = None, trial: Optional[str] = None) -> RecoverInfo:
    path = dump_path(experiment, trial)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no recover info at {path}")
    with open(path, "rb") as f:
        payload = pickle_compat.load(f, _CLASSES)
    if isinstance(payload, RecoverInfo):
        # Legacy (pre-schema) record.
        return payload
    schema = payload.get("schema")
    if schema != RECOVER_INFO_V1:
        raise ValueError(f"unsupported recover-info schema {schema!r} at {path}")
    return payload["info"]


def discover_ckpt(model_name: str, experiment=None, trial=None) -> Optional[str]:
    """Latest recover checkpoint directory for a model role, if any."""
    root = os.path.join(constants.get_recover_path(experiment, trial), "ckpt", model_name)
    if not os.path.isdir(root):
        return None
    steps = [d for d in os.listdir(root) if d.isdigit()]
    if not steps:
        return None
    return os.path.join(root, max(steps, key=int))
