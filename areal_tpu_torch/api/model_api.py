"""Model, engine and interface contracts and the interface registry (the
port's copy of what it calls from ``areal_tpu/api/model_api.py`` and
``areal_tpu/api/config.py``).

`TrainEngine` is what algorithm interfaces program against: `train_batch`
and `forward` over packed `SequenceSample`s with micro-batch specs. In the
port an engine owns a tree of tensors on one device. The model, backend
and interface registries resolve the abstractions of an experiment
config (``api/config.py``) by the reference's names
(``engine/factories.py`` registers ``tpu_transformer``, ``jax_train``
and ``jax_inference``). The generation types (``GenerationHyperparameters``,
``APIGenerateOutput``, ``BundledGenerationOutputs``) are what the rollout
side passes between its partial-rollout client and its agents; an
engine's ``generate`` is the in-framework generation of sync PPO.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.registry import Registry

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

    @classmethod
    def parse(cls, s: str) -> "ModelName":
        if "@" in s:
            role, rid = s.split("@")
            return cls(role=role, replica_id=int(rid))
        return cls(role=s)


@dataclasses.dataclass
class GenerationHyperparameters:
    """Sampling configuration (mirrors reference GenerationHyperparameters)."""

    n: int = 1  # group size: samples per prompt
    max_new_tokens: int = 256
    min_new_tokens: int = 0
    greedy: bool = False
    top_p: float = 1.0
    top_k: int = -1
    temperature: float = 1.0
    stop_token_ids: List[int] = dataclasses.field(default_factory=list)

    def new(self, **kwargs) -> "GenerationHyperparameters":
        d = dataclasses.asdict(self)
        d.update(kwargs)
        return GenerationHyperparameters(**d)


@dataclasses.dataclass
class APIGenerateOutput:
    qid: str
    prompt_ids: List[int] = dataclasses.field(default_factory=list)
    input_ids: List[int] = dataclasses.field(default_factory=list)
    output_ids: List[int] = dataclasses.field(default_factory=list)
    output_logprobs: List[float] = dataclasses.field(default_factory=list)
    no_eos: bool = True  # True if generation stopped for a non-EOS reason
    version_start: int = -1
    version_end: int = -1
    latency: float = 0.0
    # Tokens resubmitted for prefill after interrupts/chunk boundaries:
    # the measured cost of interruptible generation.
    reprefill_tokens: int = 0
    n_interruptions: int = 0


@dataclasses.dataclass
class BundledGenerationOutputs:
    """A prompt group's finished generations, handed to the agent/trainer."""

    qid: str
    prompt_ids: List[int]
    seqs: List[List[int]]  # prompt + answer, per group member
    logprobs: List[List[float]]  # aligned with seqs (prompt positions = 0)
    no_eos: List[bool]
    version_start: List[int]
    version_end: List[int]
    reprefill_tokens: List[int] = dataclasses.field(default_factory=list)
    n_interruptions: List[int] = dataclasses.field(default_factory=list)

    @classmethod
    def from_api_outputs(
        cls, outputs: List[APIGenerateOutput]
    ) -> "BundledGenerationOutputs":
        assert len({o.qid for o in outputs}) == 1
        prompt = outputs[0].prompt_ids
        return cls(
            qid=outputs[0].qid,
            prompt_ids=list(prompt),
            seqs=[list(o.prompt_ids) + list(o.output_ids) for o in outputs],
            logprobs=[[0.0] * len(o.prompt_ids) + list(o.output_logprobs) for o in outputs],
            no_eos=[o.no_eos for o in outputs],
            version_start=[o.version_start for o in outputs],
            version_end=[o.version_end for o in outputs],
            reprefill_tokens=[o.reprefill_tokens for o in outputs],
            n_interruptions=[o.n_interruptions for o in outputs],
        )

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_ids)


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

    @abc.abstractmethod
    def generate(
        self,
        input_: SequenceSample,
        mb_spec: MicroBatchSpec,
        tokenizer: Any,
        gconfig: "GenerationHyperparameters",
    ) -> List[Dict[str, Any]]:
        """In-framework generation (the sync PPO path): one dict of
        ``output_ids``, ``output_logprobs`` and ``no_eos`` a sequence."""


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

    def save(self, model: Model, save_dir: str):
        pass

    def evaluate(self, model: Model, eval_dataloader) -> Dict:
        return {}

    def inference(
        self, model: Model, input_: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Optional[SequenceSample]:
        raise NotImplementedError()

    def train_step(
        self, model: Model, input_: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict | List[Dict]:
        raise NotImplementedError()


class ModelBackend(abc.ABC):
    """Wraps a bare Model with an engine (optimizer state etc.)."""

    @abc.abstractmethod
    def initialize(self, model: Model, spec: FinetuneSpec) -> Model:
        ...

    def save(self, model: Model, save_dir: str):
        pass

    def load(self, model: Model, load_dir: str):
        pass


MODEL_REGISTRY = Registry("model")
INTERFACE_REGISTRY = Registry("interface")
BACKEND_REGISTRY = Registry("backend")


def register_model(name: str, factory):
    MODEL_REGISTRY.register(name, factory)


def make_model(cfg, **kwargs) -> Model:
    return MODEL_REGISTRY.make(cfg, **kwargs)


def register_interface(name: str, factory):
    INTERFACE_REGISTRY.register(name, factory)


def make_interface(cfg, **kwargs) -> ModelInterface:
    return INTERFACE_REGISTRY.make(cfg, **kwargs)


def register_backend(name: str, factory):
    BACKEND_REGISTRY.register(name, factory)


def make_backend(cfg, **kwargs) -> ModelBackend:
    return BACKEND_REGISTRY.make(cfg, **kwargs)
