"""Model and backend factories wired into the registries (the port's
copy of ``areal_tpu/engine/factories.py``): ``make_model
("tpu_transformer")`` builds a config and params (random from a seed, or
an HF checkpoint directory), and the backends wrap them into engines:
``jax_train`` (a ``TorchTrainEngine`` with AdamW) and ``jax_inference``
(gradient-free). The registry names are the reference's, so one
experiment config reads the same in both packages.

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

from areal_tpu_torch.api.data_api import load_hf_tokenizer
from areal_tpu_torch.api.model_api import (
    FinetuneSpec,
    Model,
    ModelBackend,
    ModelName,
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
    must be given. `dtype` is accepted as the reference's signature has
    it and is not used, as there."""
    if mesh_spec is not None or device_ids is not None:
        raise NotImplementedError(
            "device meshes are not ported: one engine runs on one device "
            "(ROADMAP Queue A item 7)")
    if isinstance(name, str):
        name = ModelName.parse(name)
    if model_path is not None:
        from areal_tpu_torch.models.hf import load_hf_model

        cfg, params = load_hf_model(model_path, is_critic=is_critic, family=hf_family)
        tokenizer_path = tokenizer_path or model_path
    else:
        if config is None:
            raise ValueError("need model_path or config")
        cfg = TransformerConfig(**{**config, "is_critic": is_critic})
        params = init_params(cfg, seed=init_seed, device="cpu")
    tokenizer = load_hf_tokenizer(tokenizer_path) if tokenizer_path else None
    model = Model(name=name, module=None, tokenizer=tokenizer)
    model._raw = dict(cfg=cfg, params=params, device=device)  # consumed by backends
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
            device=raw["device"])

    def initialize(self, model: Model, spec: FinetuneSpec) -> Model:
        model.module = self._engine(model._raw, self.optimizer,
                                    max(1, spec.total_train_steps), self.remat)
        del model._raw  # the engine holds the params on its device now
        model.ft_spec = spec
        return model


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
