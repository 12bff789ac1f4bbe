"""Model and backend factories wired into the registries (the port's
copy of ``areal_tpu/engine/factories.py``): ``make_model
("tpu_transformer")`` builds a config and params (random from a seed, or
an HF checkpoint directory), and the backends wrap them into engines:
``jax_train`` (a ``TorchTrainEngine`` with AdamW), ``jax_inference``
(gradient-free) and ``mock_train`` / ``mock_inference`` (``MockEngine``,
shape-correct outputs with no device work: sync PPO's reward shard runs
on it, its interface grading on the host). The registry names are the
reference's, so one experiment config reads the same in both packages.
A backend's ``save`` / ``load`` write and read the engine's recover
checkpoint.

The tokenizer is the named one, else the HF checkpoint's own, as in the
reference. Differences from the reference: the device comes from the
model worker's config, random init draws from the port's
``init_params`` with ``init_seed`` (the reference folds the model name
into a JAX key, so seeded random weights differ between the packages:
share weights through ``model_path``), and a mesh (``mesh_spec``,
``device_ids``) raises: one engine runs on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from areal_tpu_torch.api.data_api import SequenceSample, load_hf_tokenizer
from areal_tpu_torch.api.model_api import (
    FinetuneSpec,
    GenerationHyperparameters,
    Model,
    ModelBackend,
    ModelName,
    TrainEngine,
    register_backend,
    register_model,
)
from areal_tpu_torch.engine.optimizer import OptimizerConfig
from areal_tpu_torch.engine.torch_engine import TorchTrainEngine
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.transformer import init_params


def make_transformer_model(
    name: ModelName | str = "default",
    tokenizer_path: Optional[str] = None,
    model_path: Optional[str] = None,
    config: Optional[Dict[str, Any]] = None,
    is_critic: bool = False,
    mesh_spec: Optional[str] = None,
    device_ids: Optional[List[int]] = None,
    hf_family: Optional[str] = None,
    dtype: str = "bfloat16",
    init_seed: int = 1,
    device: str = "cuda",
) -> Model:
    """A Model whose config and params are stashed for the backend.

    Either `model_path` (HF checkpoint dir; config, weights and family
    read from it) or `config` (TransformerConfig fields, random init)
    must be given. The engine carries the HF family (``hf_family``, else
    the one the checkpoint's config names; None from a config), which
    ``save`` needs to write the HF format. `dtype` is accepted as the
    reference's signature has it and is not used, as there."""
    if mesh_spec is not None or device_ids is not None:
        raise NotImplementedError(
            "device meshes are not ported: one engine runs on one device "
            "(ROADMAP Queue A item 7)")
    if isinstance(name, str):
        name = ModelName.parse(name)
    if model_path is not None:
        from areal_tpu_torch.models.hf import family_from_hf_config, load_hf_config, load_hf_model

        if hf_family is None:
            hf_family = family_from_hf_config(load_hf_config(model_path)).name
        cfg, params = load_hf_model(model_path, is_critic=is_critic, family=hf_family)
        tokenizer_path = tokenizer_path or model_path
    else:
        if config is None:
            raise ValueError("need model_path or config")
        cfg = TransformerConfig(**{**config, "is_critic": is_critic})
        params = init_params(cfg, seed=init_seed, device="cpu")
    tokenizer = load_hf_tokenizer(tokenizer_path) if tokenizer_path else None
    model = Model(name=name, module=None, tokenizer=tokenizer)
    model._raw = dict(cfg=cfg, params=params, device=device,  # consumed by backends
                      hf_family=hf_family)
    return model


register_model("tpu_transformer", make_transformer_model)


@dataclasses.dataclass
class JaxTrainBackend(ModelBackend):
    """Wraps a model into a training ``TorchTrainEngine`` (the reference's
    name for its training backend)."""

    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    remat: bool = True
    row_len_multiple: int = 128
    max_row_len: Optional[int] = None

    def __post_init__(self):
        if isinstance(self.optimizer, dict):
            self.optimizer = OptimizerConfig(**self.optimizer)

    def _engine(self, raw: Dict, optimizer_config, total_train_steps: int, remat):
        return TorchTrainEngine(
            raw["cfg"], raw["params"], optimizer_config=optimizer_config,
            total_train_steps=total_train_steps, remat=remat,
            row_len_multiple=self.row_len_multiple, max_row_len=self.max_row_len,
            hf_family=raw["hf_family"], device=raw["device"])

    def initialize(self, model: Model, spec: FinetuneSpec) -> Model:
        model.module = self._engine(model._raw, self.optimizer,
                                    max(1, spec.total_train_steps), self.remat)
        del model._raw  # the engine holds the params on its device now
        model.ft_spec = spec
        return model

    def save(self, model: Model, save_dir: str):
        """A recover checkpoint of the engine (engine/checkpoint.py)."""
        from areal_tpu_torch.engine.checkpoint import save_engine_state

        save_engine_state(model.module, save_dir)

    def load(self, model: Model, load_dir: str):
        from areal_tpu_torch.engine.checkpoint import load_engine_state

        load_engine_state(model.module, load_dir)


@dataclasses.dataclass
class JaxInferenceBackend(JaxTrainBackend):
    """Gradient-free engine for reference and reward models."""

    def initialize(self, model: Model, spec: FinetuneSpec) -> Model:
        model.module = self._engine(model._raw, None, 1, False)
        del model._raw
        model.ft_spec = spec
        return model


register_backend("jax_train", JaxTrainBackend)
register_backend("jax_inference", JaxInferenceBackend)


class MockEngine(TrainEngine):
    """Compute-free engine for control-plane work and sync PPO's reward
    shard (the reference's ``MockEngine``): deterministic, shape-correct
    outputs with no device work."""

    def __init__(self, seed: int = 0, vocab_size: int = 128):
        self.seed = seed
        self.vocab_size = vocab_size
        self.version = 0
        self.n_train_calls = 0

    def train_batch(self, input_, mb_spec, loss_fn, loss_weight_fn,
                    token_normalize_scope="global", version_steps=0,
                    loss_name="loss"):
        self.n_train_calls += 1
        self.version += 1
        return {
            f"{loss_name}/loss": 1.0 / self.n_train_calls,
            f"{loss_name}/n_tokens": float(input_.total_seqlen()),
        }

    def forward(self, input_, mb_spec, output_key="logprobs", post_hook=None):
        key = input_._main_key()
        seqlens = input_.seqlens[key]
        total = sum(sum(sl) for sl in seqlens)
        rng = np.random.RandomState(self.seed + total)
        data = rng.uniform(-1, 0, size=(total,)).astype(np.float32)
        return SequenceSample(
            ids=list(input_.ids),
            keys={output_key},
            data={output_key: data},
            seqlens={output_key: [list(sl) for sl in seqlens]},
        )

    def generate(self, input_, mb_spec, tokenizer, gconfig: GenerationHyperparameters):
        key = "packed_prompts" if "packed_prompts" in input_.keys else input_._main_key()
        plens = [sum(sl) for sl in input_.seqlens[key]]
        outs = []
        rng = np.random.RandomState(self.seed + sum(plens))
        for _ in plens:
            for _ in range(gconfig.n):
                glen = int(rng.randint(1, max(2, gconfig.max_new_tokens)))
                outs.append(dict(
                    output_ids=rng.randint(0, self.vocab_size, size=glen).tolist(),
                    output_logprobs=(-rng.uniform(0, 1, size=glen)).astype(np.float32),
                    no_eos=bool(rng.rand() < 0.2),
                ))
        return outs

    def get_params(self):
        return {}

    def set_params(self, params):
        pass


@dataclasses.dataclass
class MockTrainBackend(ModelBackend):
    """Wraps a model into a ``MockEngine``. The model's weights, which
    ``make_model`` loaded on the host (sync PPO's reward shard is built
    from the actor's checkpoint for its tokenizer), are dropped here; the
    reference's backend leaves them on the model."""

    seed: int = 0
    vocab_size: int = 128

    def initialize(self, model: Model, spec: FinetuneSpec) -> Model:
        model.module = MockEngine(seed=self.seed, vocab_size=self.vocab_size)
        model.__dict__.pop("_raw", None)
        model.ft_spec = spec
        return model


register_backend("mock_train", MockTrainBackend)
register_backend("mock_inference", MockTrainBackend)
