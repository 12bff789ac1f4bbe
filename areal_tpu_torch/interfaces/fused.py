"""Fused forward interface (the port's copy of
``areal_tpu/interfaces/fused.py``, registered as "fused-threading"): runs
several member interfaces' ``inference`` over the same model and data in
a thread pool and merges their outputs with ``SequenceSample.update_``,
in member-name order, so one model allocation can serve, for example,
both the reward verification and the reference logprob pass."""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import (
    Model,
    ModelInterface,
    make_interface,
    register_interface,
)


@dataclasses.dataclass
class FusedThreadingForwardInterface(ModelInterface):
    interfaces: Dict[str, "ModelInterface | dict"] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        resolved = {}
        for name, itf in self.interfaces.items():
            if isinstance(itf, ModelInterface):
                resolved[name] = itf
            elif isinstance(itf, dict):
                resolved[name] = make_interface(itf.get("type_", name), **itf.get("args", {}))
            else:
                resolved[name] = make_interface(itf)
        self.interfaces = resolved

    def inference(
        self, model: Model, input_: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        with ThreadPoolExecutor(max_workers=max(len(self.interfaces), 1)) as ex:
            futures = {name: ex.submit(itf.inference, model, input_, mb_spec)
                       for name, itf in self.interfaces.items()}
            results = {name: f.result() for name, f in futures.items()}
        out = None
        for name in sorted(results):
            r = results[name]
            if r is None:
                continue
            if out is None:
                out = r
            else:
                out.update_(r)
        return out


register_interface("fused-threading", FusedThreadingForwardInterface)
