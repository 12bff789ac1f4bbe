"""Shared experiment-building helpers (the port's copy of what the PPO
and SFT experiments call from ``areal_tpu/experiments/common.py``). One
model worker drives one device, so there is no mesh or allocation
arithmetic: every shard is host 0 of 1 (the experiments refuse other
allocations before they build)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from areal_tpu_torch.api.cli_args import (
    BaseExperimentConfig,
    DatasetConfig,
    ModelTrainEvalConfig,
)
from areal_tpu_torch.api.config import (
    DatasetAbstraction,
    ModelAbstraction,
    ModelBackendAbstraction,
)
from areal_tpu_torch.api.data_api import MicroBatchSpec
from areal_tpu_torch.api.system_api import (
    MasterWorkerConfig,
    ModelShardSpec,
    ModelWorkerConfig,
)


def model_abstraction(m: ModelTrainEvalConfig, tokenizer_path: Optional[str],
                      is_critic: bool = False) -> ModelAbstraction:
    args: Dict = dict(
        tokenizer_path=tokenizer_path or m.path,
        is_critic=is_critic or m.is_critic,
        dtype=m.dtype,
    )
    if m.path and not m.init_from_scratch:
        args["model_path"] = m.path
    else:
        assert m.config is not None, "need model config for scratch init"
        args["config"] = dict(m.config)
    return ModelAbstraction("tpu_transformer", args=args)


def resolve_n_workers(cfg: BaseExperimentConfig) -> int:
    """The model worker count: ``train_n_hosts`` when above 1, else
    ``n_model_workers`` (the reference also reads the data axis of the
    allocation, which the port does not parse: anything but "d1" is
    refused before the build)."""
    if int(getattr(cfg, "train_n_hosts", 1) or 1) > 1:
        return int(cfg.train_n_hosts)
    return cfg.n_model_workers


def backend_abstraction(m: ModelTrainEvalConfig, train: bool = True) -> ModelBackendAbstraction:
    if m.backend.startswith("mock"):
        return ModelBackendAbstraction(m.backend)
    name = "jax_train" if train else "jax_inference"
    args = dict(
        remat=m.remat,
        row_len_multiple=m.row_len_multiple,
        max_row_len=m.max_row_len,
    )
    if train:
        args["optimizer"] = dataclasses.asdict(m.optimizer)
    return ModelBackendAbstraction(name, args=args)


def dataset_abstraction(d: DatasetConfig) -> DatasetAbstraction:
    args = dict(d.args)
    if d.path is not None:
        args.setdefault("dataset_path", d.path)
    if d.max_length is not None and d.type_ in ("prompt_answer", "prompt", "rw_pair"):
        args.setdefault("max_length", d.max_length)
    return DatasetAbstraction(d.type_, args=args)


def mb_spec(cfg: BaseExperimentConfig, mfc=None) -> MicroBatchSpec:
    """Global micro-batch spec, optionally overridden per MFC."""
    n_mbs = cfg.mb_spec_n_mbs
    max_tokens = cfg.mb_spec_max_tokens
    if mfc is not None:
        if mfc.n_mbs is not None:
            n_mbs = mfc.n_mbs
        if mfc.max_tokens_per_mb is not None:
            max_tokens = mfc.max_tokens_per_mb
    return MicroBatchSpec(n_mbs=n_mbs, max_tokens_per_mb=max_tokens)


def worker_names(n: int) -> List[str]:
    return [f"model_worker/{i}" for i in range(n)]


def base_model_worker(
    cfg: BaseExperimentConfig,
    index: int,
    n_workers: int,
    shards: List[ModelShardSpec],
    with_dataset: bool = True,
    stream_dataset: bool = False,
) -> ModelWorkerConfig:
    return ModelWorkerConfig(
        experiment_name=cfg.experiment_name,
        trial_name=cfg.trial_name,
        worker_index=index,
        shards=shards,
        datasets=[dataset_abstraction(cfg.dataset)] if with_dataset else [],
        tokenizer_path=cfg.tokenizer_path,
        dataset_dp_rank=index,
        dataset_dp_size=n_workers,
        train_batch_size=cfg.train_batch_size,
        total_train_epochs=resolved_total_train_epochs(cfg),
        seed=cfg.seed,
        stream_dataset=stream_dataset,
        n_pullers=n_workers if stream_dataset else 1,
        weight_plane=bool(getattr(cfg, "gen_weight_plane", False)),
        weight_chunk_bytes=int(getattr(cfg, "gen_weight_chunk_mb", 8)) << 20,
        weight_wire_dtype=getattr(cfg, "gen_weight_wire_dtype", None),
        device=cfg.device,
    )


def dataset_line_count(dataset_cfg) -> int:
    """Number of usable samples in a jsonl prompt dataset (0 if unknown);
    the async experiment sizes its epochs master-side with it."""
    path = getattr(dataset_cfg, "path", None)
    if not path:
        return 0
    try:
        if getattr(dataset_cfg, "type_", None) == "math_code_prompt":
            from areal_tpu_torch.datasets.math_code_prompt import load_metadata

            id2info, _ = load_metadata(path)
            return len(id2info)
        with open(path, "rb") as f:
            return sum(1 for line in f if line.strip())
    except (OSError, AssertionError):
        return 0


def resolved_total_train_epochs(cfg: BaseExperimentConfig) -> int:
    """`exp_ctrl.total_train_epochs` when set, else the top-level
    `total_train_epochs`."""
    if cfg.exp_ctrl.total_train_epochs is not None:
        return cfg.exp_ctrl.total_train_epochs
    return cfg.total_train_epochs


def base_master(cfg: BaseExperimentConfig, rpcs, model_topos, n_workers: int) -> MasterWorkerConfig:
    exp_ctrl = dataclasses.replace(
        cfg.exp_ctrl, total_train_epochs=resolved_total_train_epochs(cfg)
    )
    return MasterWorkerConfig(
        experiment_name=cfg.experiment_name,
        trial_name=cfg.trial_name,
        exp_ctrl=exp_ctrl,
        rpcs=rpcs,
        model_topos=model_topos,
        data_hosts=worker_names(n_workers),
        n_model_workers=n_workers,
        train_batch_size=cfg.train_batch_size,
        recover_mode=cfg.recover_mode,
    )
