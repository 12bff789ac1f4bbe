"""SFT experiment (the port's copy of ``areal_tpu/experiments/sft_exp.py``):
one model worker loads the prompt/answer dataset and runs the
``trainDefault`` MFC (the "sft" interface) over ``packed_input_ids`` and
``prompt_mask`` every step; the master broadcasts "save", "ckpt" and
"evaluate" at the ``exp_ctrl`` frequencies, and ``recover_mode`` "auto"
or "resume" resumes from the last recover checkpoint.

The port trains on one device a worker. Options whose feature the port
lacks raise in ``refuse_unported`` before any worker starts, each naming
the ROADMAP Queue A item that brings it.
"""

from __future__ import annotations

from areal_tpu_torch.api.cli_args import SFTExpConfig
from areal_tpu_torch.api.config import ModelInterfaceAbstraction, ModelShardID
from areal_tpu_torch.api.dfg import MFCDef, ModelInterfaceType
from areal_tpu_torch.api.model_api import ModelName
from areal_tpu_torch.api.system_api import ExperimentConfig, ModelShardSpec
from areal_tpu_torch.experiments import common as C
from areal_tpu_torch.experiments import register_experiment

_MESH = "ROADMAP Queue A item 7, multi-device"
_KNOBS = "ROADMAP Queue A item 3.4, the engine's last knobs"


def refuse_unported(cfg: SFTExpConfig):
    """Raise on every option set away from what the port runs."""
    m = cfg.model
    refused = {
        "auto_eval": (cfg.auto_eval, "ROADMAP Queue A item 8, evaluation"),
        "allocation_mode": (cfg.allocation_mode != "d1", _MESH),
        "n_model_workers": (cfg.n_model_workers != 1, _MESH),
        "train_n_hosts": (cfg.train_n_hosts != 1, _MESH),
        "model.backend": (m.backend != "jax_train", "SFT on the mock engine is not ported"),
        "model.attn_impl": (m.attn_impl != "auto", _MESH),
        "model.mesh_spec": (m.mesh_spec is not None, _MESH),
        "model.prefetch_depth": (m.prefetch_depth != 0, _KNOBS),
        "model.stats_fetch_interval": (m.stats_fetch_interval != 1, _KNOBS),
    }
    for k in ("moe_dispatch", "moe_capacity_factor", "moe_aux_loss_coef"):
        refused[f"model.{k}"] = (getattr(m, k) is not None, "ROADMAP Queue A item 6.2, MoE")
    bad = [f"{k} ({why})" for k, (hit, why) in refused.items() if hit]
    if bad:
        raise NotImplementedError(
            f"options not ported yet: {bad}: leave them at their defaults")


def build_sft_experiment(cfg: SFTExpConfig) -> ExperimentConfig:
    refuse_unported(cfg)
    n_workers = 1
    model_name = ModelName("default", 0)
    train = MFCDef(
        name="trainDefault",
        model_name=model_name,
        interface_type=ModelInterfaceType.TRAIN_STEP,
        interface_impl=ModelInterfaceAbstraction("sft"),
        n_seqs=cfg.train_batch_size,
        input_keys=("packed_input_ids", "prompt_mask"),
        mb_spec=C.mb_spec(cfg),
    )
    shards = [ModelShardSpec(
        id=ModelShardID(model_name),
        model=C.model_abstraction(cfg.model, cfg.tokenizer_path),
        backend=C.backend_abstraction(cfg.model, train=True),
        interface=ModelInterfaceAbstraction("sft"),
    )]
    workers = [C.base_model_worker(cfg, 0, n_workers, shards)]
    master = C.base_master(cfg, [train], {str(model_name): C.worker_names(n_workers)},
                           n_workers)
    return ExperimentConfig(
        experiment_name=cfg.experiment_name,
        trial_name=cfg.trial_name,
        master=master,
        model_workers=workers,
    )


register_experiment("sft", build_sft_experiment)
