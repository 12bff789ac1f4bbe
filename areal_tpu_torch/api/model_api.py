"""Model, engine and interface contracts and the interface registry (the
port's copy of what it calls from ``areal_tpu/api/model_api.py`` and
``areal_tpu/api/config.py``).

`TrainEngine` is what algorithm interfaces program against: `train_batch`
and `forward` over packed `SequenceSample`s with micro-batch specs. In the
port an engine owns a tree of tensors on one device. In-framework
generation, backends and the generation-server API types of the reference
are not ported.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample

# loss_fn(model_out [R, T], rows) -> (loss_sum, aux dict of scalar tensors);
# model_out is the next-token logprobs (LM models) or the values (critics),
# rows carries the packed [R, T] tensor of every data key.
PackedLossFn = Callable[[torch.Tensor, Dict[str, torch.Tensor]],
                        Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclasses.dataclass(unsafe_hash=True, order=True)
class ModelName:
    """A named model replica: role ('actor', 'critic', ...) + replica index."""

    role: str = "default"
    replica_id: int = 0

    def __str__(self):
        return f"{self.role}@{self.replica_id}"


@dataclasses.dataclass
class FinetuneSpec:
    total_train_epochs: int = 1
    dataset_size: int = 0
    train_batch_size: int = 1

    @property
    def steps_per_epoch(self) -> int:
        return max(1, self.dataset_size // max(1, self.train_batch_size))

    @property
    def total_train_steps(self) -> int:
        return self.total_train_epochs * self.steps_per_epoch


class TrainEngine(abc.ABC):
    """What algorithm interfaces call. All data is packed SequenceSamples.

    Implementation: `areal_tpu_torch.engine.torch_engine.TorchTrainEngine`.
    """

    @abc.abstractmethod
    def train_batch(
        self,
        input_: SequenceSample,
        mb_spec: MicroBatchSpec,
        loss_fn: PackedLossFn,
        loss_weight_fn: Callable[[SequenceSample], float],
        token_normalize_scope: str = "global",
        version_steps: Optional[int] = None,
        loss_name: str = "loss",
    ) -> Dict[str, float]:
        """Run forward+backward+update over micro-batches; returns host
        stats. `version_steps` positions the LR schedule (None = the
        engine's own step count)."""

    @abc.abstractmethod
    def forward(
        self,
        input_: SequenceSample,
        mb_spec: MicroBatchSpec,
        output_key: str = "logprobs",
        post_hook: Optional[Callable] = None,
    ) -> Optional[SequenceSample]:
        """Gradient-free forward over micro-batches, gathered to host."""


@dataclasses.dataclass
class Model:
    """A named model hosted by a model worker: engine + tokenizer + version."""

    name: ModelName
    module: Optional[TrainEngine]
    tokenizer: Any
    version: int = 0
    ft_spec: FinetuneSpec = dataclasses.field(default_factory=FinetuneSpec)

    def inc_version(self):
        self.version += 1


class ModelInterface(abc.ABC):
    """Algorithm glue (ppo_actor, ppo_critic, sft, ...)."""

    def inference(
        self, model: Model, input_: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Optional[SequenceSample]:
        raise NotImplementedError()

    def train_step(
        self, model: Model, input_: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict | List[Dict]:
        raise NotImplementedError()


class Registry:
    """Simple name -> factory registry with helpful errors."""

    def __init__(self, kind: str):
        self.kind = kind
        self._factories: Dict[str, Any] = {}

    def register(self, name: str, factory):
        if name in self._factories:
            raise ValueError(f"{self.kind} {name!r} already registered")
        self._factories[name] = factory

    def make(self, name: str, *args, **kwargs):
        if name not in self._factories:
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: {sorted(self._factories)}"
            )
        return self._factories[name](*args, **kwargs)


INTERFACE_REGISTRY = Registry("interface")


def register_interface(name: str, factory):
    INTERFACE_REGISTRY.register(name, factory)


def make_interface(name: str, **kwargs) -> ModelInterface:
    return INTERFACE_REGISTRY.make(name, **kwargs)
