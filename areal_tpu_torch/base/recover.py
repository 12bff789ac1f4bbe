"""Step counters of a run (the port's copy of ``StepInfo`` from
``areal_tpu/base/recover.py``). The recover record (``RecoverInfo``),
its dump and its restore are not ported: a master configured to recover
raises."""

from __future__ import annotations

import dataclasses


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
