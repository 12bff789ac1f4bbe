"""Model worker: hosts model shards and the trajectory stream, executes
MFCs (the port's copy of ``areal_tpu/system/model_worker.py``).

One model worker drives one device (``ModelWorkerConfig.device``; a CUDA
device without a card raises) and acts as one DP rank of every model it
hosts. Request handlers:

- "spec": dataset size + readiness handshake
- "fetch": next batch of pulled trajectories -> DataManager, reply metadata
- "mfc": execute pre-hooks (data_transfer pulls, param_realloc, ...),
  assemble the input batch, run the interface method, store outputs,
  reply meta + stats
- "clear_data_cache": per-step sample GC
- "exit": leave the poll loop

Besides the reference's stats, each MFC's reply carries the launches of
every CUDA kernel of the port during that MFC (``launches/<kernel>``,
summed across DP workers), so a run shows that its trainer went through
the kernels.

Not ported yet, each refused with ``NotImplementedError``: the "save",
"ckpt", "restore" and "evaluate" handlers and hooks, "offload", the
"generate" MFC, the param-realloc target branch (weights loaded from
another replica), dataset loaders (``datasets`` without
``stream_dataset``), the multi-host train group, the weight plane and
its int8 wire. Per-prompt ``scores`` in an MFC's output merge into the
shared eval-score file (``system/eval_scores.py``), as in the reference.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

from areal_tpu_torch import kernels, resolve_device
from areal_tpu_torch.api.data_api import MicroBatchSpec
from areal_tpu_torch.api.model_api import (
    FinetuneSpec,
    Model,
    ModelName,
    make_backend,
    make_interface,
    make_model,
)
from areal_tpu_torch.api.system_api import ModelWorkerConfig
from areal_tpu_torch.base import (
    constants,
    datapack,
    logging,
    metrics_registry,
    monitor,
    name_resolve,
    names,
    seeding,
    stats_tracker,
    tracing,
)
from areal_tpu_torch.system import eval_scores
from areal_tpu_torch.system import request_reply_stream as rrs
from areal_tpu_torch.system.data_manager import DataManager
from areal_tpu_torch.system.redistributor import RedistribStep
from areal_tpu_torch.system.worker_base import PollResult, Worker

logger = logging.getLogger("model_worker")

# Handlers and hooks of the reference that the port does not serve yet,
# with the ROADMAP item that brings each.
_NOT_PORTED = {
    "save": "Queue A item 3 (save to HF format)",
    "ckpt": "Queue A item 3 (engine-state checkpoint)",
    "restore": "Queue A item 3 (engine-state checkpoint)",
    "evaluate": "Queue A item 3 (SFTInterface.evaluate)",
    "offload": "Queue A item 3 (offload)",
    "generate": "Queue A item 3 (TrainEngine.generate)",
}


def _not_ported(what: str):
    return NotImplementedError(
        f"model worker {what!r} is not ported yet (ROADMAP {_NOT_PORTED[what]})")


class ModelWorker(Worker):
    def _configure(self, config: ModelWorkerConfig):
        refused = {
            "datasets without stream_dataset (the rollout slice's dataset loaders)":
                bool(config.datasets) and not config.stream_dataset,
            "train_n_hosts > 1 (Queue A item 7)": int(config.train_n_hosts or 1) > 1,
            "weight_plane (Queue A item 2.3)": bool(config.weight_plane),
            "weight_wire_dtype (Queue A item 2.3)": config.weight_wire_dtype is not None,
        }
        bad = [k for k, v in refused.items() if v]
        if bad:
            raise NotImplementedError(f"model worker options not ported yet: {bad}")
        self.cfg = config
        self.device = resolve_device(config.device)
        constants.set_experiment_trial_names(
            config.experiment_name, config.trial_name
        )
        seeding.set_random_seed(config.seed, config.worker_name)
        # Import factories/interfaces so registries are populated.
        import areal_tpu_torch.engine.factories  # noqa: F401
        import areal_tpu_torch.interfaces.ppo  # noqa: F401
        import areal_tpu_torch.interfaces.sft  # noqa: F401

        self.stream = rrs.make_worker_stream(
            config.experiment_name, config.trial_name, config.worker_name
        )
        self.data_manager = DataManager(
            config.experiment_name, config.trial_name, config.worker_name
        )

        self._dataset = None
        if config.stream_dataset:
            from areal_tpu_torch.system.stream_dataset import PullerStreamDataset

            self._dataset = PullerStreamDataset(
                config.experiment_name,
                config.trial_name,
                puller_index=config.dataset_dp_rank,
            )

        # Models.
        self.models: Dict[str, Model] = {}
        self.interfaces: Dict[str, Any] = {}
        dataset_size = len(self._dataset) * config.dataset_dp_size if self._dataset is not None else 0
        self._host_rank: Dict[str, int] = {}
        for shard in config.shards:
            mn = shard.id.model_name
            self._host_rank[str(mn)] = shard.id.host_rank
            ft_spec = FinetuneSpec(
                total_train_epochs=config.total_train_epochs,
                dataset_size=dataset_size,
                train_batch_size=config.train_batch_size,
            )
            model = make_model(shard.model, name=mn, device=str(self.device))
            model = make_backend(shard.backend).initialize(model, ft_spec)
            self.models[str(mn)] = model
            self.interfaces[str(mn)] = make_interface(shard.interface)
        logger.info(
            f"{config.worker_name} configured on {self.device}: "
            f"models={list(self.models)}, dataset_size={dataset_size}"
        )

    # ------------------------------------------------------------------
    # Handlers
    # ------------------------------------------------------------------

    def _handle_spec(self, req):
        # LOCAL size only; the master sums across data hosts.
        local = len(self._dataset) if self._dataset is not None else 0
        return {"dataset_size": local, "models": list(self.models)}

    def _handle_fetch(self, req):
        if self._dataset is None:
            return {"meta": None, "epoch_done": False}
        batch = self._dataset.poll_batch()
        if batch is None:
            return {"meta": None, "epoch_done": False}
        self.data_manager.store(batch)
        return {"meta": batch.meta(), "epoch_done": False}

    def _exec_hook(self, hook: Dict, model_name: str, step: int = 0) -> Optional[float]:
        """Run one hook; a param_realloc returns its dump seconds."""
        htype = hook.get("type")
        if htype == "data_transfer":
            steps = [RedistribStep(**s) for s in hook["plan"]]
            self.data_manager.redistribute(steps)
        elif htype in ("save", "evaluate", "offload"):
            raise _not_ported(htype)
        elif htype == "param_realloc":
            return self._param_realloc(hook, step)
        else:
            raise ValueError(f"unknown hook {hook!r}")

    def _handle_mfc(self, req) -> Dict:
        d = req.data
        model_name = d["model_name"]
        model = self.models[model_name]
        interface = self.interfaces[model_name]

        step = int(d.get("step_info", {}).get("global_step", 0))
        # Pre-hooks: data transfer plan is embedded in the request.
        if d.get("plan"):
            self.data_manager.redistribute(
                [RedistribStep(**s) for s in d["plan"]]
            )
        for hook in req.pre_hooks:
            self._exec_hook(hook, model_name, step)

        input_ = self.data_manager.gather(d["ids"], d["input_keys"])
        if d.get("input_key_remap"):
            input_.remap_keys_(d["input_key_remap"])
        mb_spec = MicroBatchSpec(**d["mb_spec"])

        itype = d["interface_type"]
        mn = ModelName.parse(model_name)
        launches_before = dict(kernels.launches)
        t0 = time.monotonic()
        # Worker-side MFC execution span, parented under the master's
        # MFC span (trace_ctx rides the request payload).
        with tracing.span(
            f"mfc.{d.get('mfc_name', itype)}",
            ctx=tracing.extract(req.trace_ctx),
            itype=itype,
            model=model_name,
            step=step,
            n_seqs=len(d["ids"]),
        ):
            if itype == "generate":
                raise _not_ported("generate")
            elif itype == "inference":
                out = interface.inference(model, input_, mb_spec)
                stats = {}
            elif itype == "train_step":
                res = interface.train_step(model, input_, mb_spec)
                out = None
                stats = res[-1] if isinstance(res, list) else res
            else:
                raise ValueError(f"bad interface_type {itype!r}")
        # Stats recorded through the tracker during the interface call ship
        # with their declared reduce types so the master merges MIN/MAX/SUM
        # stats correctly across DP workers (merge_worker_stats).
        stats = dict(stats or {})
        tracked, ttypes = stats_tracker.export(return_types=True)
        stats.update(tracked)
        stats[metrics_registry.PERF_SEC] = time.monotonic() - t0
        for k, n in kernels.launches.items():
            stats[f"launches/{k}"] = float(n - launches_before[k])
            ttypes[f"launches/{k}"] = "sum"
        stats["__reduce_types__"] = ttypes
        # Device-memory telemetry and OOM guard after every MFC (zeros on
        # the CPU, so always logged).
        mem = monitor.device_memory_stats([self.device] if self.device.type == "cuda" else [])
        stats.update(metrics_registry.perf_mem_stats(mem))
        monitor.check_memory_kill_threshold(mem)
        cfg = getattr(model.module, "model_cfg", None)
        if cfg is not None:
            in_lens = [
                l for sl in input_.seqlens[input_._main_key()] for l in sl
            ]
            # Packing density over this MFC's input lengths (the analytic
            # FFD estimate: the port's engine does not report it).
            row_mult = getattr(model.module, "row_len_multiple", None)
            if itype in ("train_step", "inference") and in_lens and row_mult:
                stats[metrics_registry.PERF_PACKING_EFFICIENCY] = datapack.packing_density(
                    in_lens,
                    row_len_multiple=row_mult,
                    max_row_len=getattr(model.module, "max_row_len", None),
                )
            stats[metrics_registry.PERF_FLOPS] = float(monitor.mfc_flops(cfg, itype, in_lens))

        output_meta = None
        if out is not None:
            # Per-prompt eval scores feed the dataset curriculum filter:
            # merged into the shared score file and popped, so they do
            # not ride into downstream MFC inputs.
            scores = out.metadata.pop("scores", None)
            if scores:
                eval_scores.merge_scores(
                    self.cfg.experiment_name, self.cfg.trial_name,
                    dict(zip(out.ids, scores)))
            if d.get("output_key_remap"):
                out.remap_keys_(d["output_key_remap"])
            self.data_manager.store(out)
            output_meta = out.meta()

        for hook in req.post_hooks:
            dump_s = self._exec_hook(hook, model_name, step)
            if dump_s is not None:
                stats["param_realloc/dump_s"] = dump_s

        if itype == "train_step" and self._host_rank.get(model_name, 0) == 0:
            # Publish AFTER post-hooks: the param-realloc dump the gserver
            # manager fans out must be on disk before the version appears,
            # or servers would load the previous step's weights under the
            # new version number. Only DP rank 0 publishes (and dumps).
            self._publish_version(mn)

        return {"stats": stats, "output_meta": output_meta}

    def _publish_version(self, model_name: ModelName):
        model = self.models[str(model_name)]
        name_resolve.add(
            names.model_version(
                self.cfg.experiment_name, self.cfg.trial_name, model_name.role
            ),
            str(model.version),
            replace=True,
        )

    def _param_realloc(self, hook: Dict, step: int = 0) -> Optional[float]:
        """Disk-mediated weight hand-off: the source model's DP rank 0
        writes the raw dump of its params, stamped with `model.version`
        (the value `_publish_version` announces next; a generation server
        verifies that the dump it loads holds the version it asked for),
        then `step.txt` with the global step, and returns the dump's
        seconds. Only the disk dump is written (no tmpfs mirror)."""
        from areal_tpu_torch.system.weight_transfer import dump_raw_params

        src, dst = hook.get("source"), hook.get("target")
        if dst is not None:
            raise NotImplementedError(
                "param_realloc into a target replica is not ported yet (sync PPO's "
                "generation replica, ROADMAP Queue A item 3)")
        model = self.models.get(src) if src is not None else None
        if model is None or self._host_rank.get(src, 0) != 0:
            return None
        role = ModelName.parse(src).role
        d = os.path.join(
            constants.get_param_realloc_path(self.cfg.experiment_name, self.cfg.trial_name),
            role,
        )
        dump_s = dump_raw_params(model.module.get_params(), d, version=model.version)
        logger.info(
            f"param_realloc dump for {role} step {step}: raw dump "
            f"v{model.version} {dump_s:.3f}s"
        )
        tmp = os.path.join(d, "step.txt.tmp")
        with open(tmp, "w") as f:
            f.write(str(step))
        os.replace(tmp, os.path.join(d, "step.txt"))
        return dump_s

    # ------------------------------------------------------------------

    def _poll(self) -> Optional[PollResult]:
        try:
            req = self.stream.poll(block=True, timeout_ms=50)
        except rrs.NoMessage:
            return PollResult(batch_count=0)
        try:
            h = req.handle_name
            if h == "spec":
                resp = self._handle_spec(req)
            elif h == "fetch":
                resp = self._handle_fetch(req)
            elif h == "mfc":
                resp = self._handle_mfc(req)
            elif h in ("save", "ckpt", "restore", "evaluate"):
                raise _not_ported(h)
            elif h == "clear_data_cache":
                self.data_manager.clear(req.data)
                resp = {"ok": True}
            elif h == "exit":
                self.stream.reply_to(req, {"ok": True})
                self.exit()
                return PollResult(batch_count=1)
            else:
                resp = {"error": f"unknown handle {h!r}"}
        except Exception as e:
            logger.exception(f"error handling {req.handle_name}")
            resp = {"error": repr(e)}
        self.stream.reply_to(req, resp)
        return PollResult(batch_count=1)

    def _exit_hook(self):
        try:
            self.stream.close()
            self.data_manager.close()
            if self._dataset is not None:
                self._dataset.close()
        except Exception:
            pass
