"""Model worker: hosts model shards and the trajectory stream, executes
MFCs (the port's copy of ``areal_tpu/system/model_worker.py``).

One model worker drives one device (``ModelWorkerConfig.device``; a CUDA
device without a card raises) and acts as one DP rank of every model it
hosts. Request handlers:

- "spec": dataset size + readiness handshake
- "fetch": next dataloader batch (or of pulled trajectories) ->
  DataManager, reply metadata
- "mfc": execute pre-hooks (data_transfer pulls, param_realloc,
  offload, ...), assemble the input batch, run the interface method
  (generate, inference or train_step), store outputs, reply meta + stats
- "save": each model in the HF format under
  ``<save path>/<role>/step<version>/dp<worker index>``
- "evaluate": each interface's ``evaluate``
- "ckpt": each model's engine state (``engine/checkpoint.py``) under
  ``<recover path>/<role>/dp<worker index>``, the dataloader's cursor
  (``dataloader_<worker index>.json``), then the stream dataset's WAL
  compacted against the previous recover record
- "restore": each model's engine state back, the curriculum indices,
  the dataloader's cursor and a restart of its epoch
- "clear_data_cache": per-step sample GC
- "exit": leave the poll loop

At exit the worker drains its pending checkpoint writes, then leaves an
exit record (``<log path>/exit_records/<worker>.json``, a port
addition): its kernel launches, peak device memory, each shard's build
seconds (model, backend and interface), each checkpoint's step-loop
stall, the async writer's last write seconds and pending count after the
drain, and the restore's seconds.

Besides the reference's stats, each MFC's reply carries the launches of
every CUDA kernel of the port during that MFC (``launches/<kernel>``,
summed across DP workers), so a run shows that its trainer went through
the kernels.

As in the reference, "evaluate" hands each interface no eval loader
(``iface.evaluate(model, None)``): the SFT interface raises ``TypeError``
on it and the reply carries the error, which the master drops.

A param-realloc hook with a target waits (at most 300 s) for the
source's ``step.txt`` to reach the MFC's step, then loads the source's
dump into the target: the reference's ``engine_state.pkl`` when the
directory holds one (the port's own dumps write none), else the raw dump;
only the params move. The "offload" hook moves an engine's params and
optimizer moments to host memory until its next call. The multi-host
train group is refused with ``NotImplementedError``. With
``weight_plane`` the dump rank serves its dumps as the weight plane's
origin (system/weight_plane.py). Per-prompt ``scores`` in an MFC's output merge into the
shared eval-score file (``system/eval_scores.py``), as in the reference.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from areal_tpu_torch import kernels, resolve_device
from areal_tpu_torch.api import data_api
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
    network,
    recover,
    seeding,
    stats_tracker,
    tracing,
)
from areal_tpu_torch.system import eval_scores
from areal_tpu_torch.system import request_reply_stream as rrs
from areal_tpu_torch.system.data_manager import DataManager
from areal_tpu_torch.system.redistributor import RedistribStep
from areal_tpu_torch.system.worker_base import PollResult, Worker, write_exit_record

logger = logging.getLogger("model_worker")

# How long a param-realloc target waits for its source's dump.
REALLOC_WAIT_S = 300


class ModelWorker(Worker):
    def _configure(self, config: ModelWorkerConfig):
        if int(config.train_n_hosts or 1) > 1:
            raise NotImplementedError(
                "model worker option not ported yet: train_n_hosts > 1 (ROADMAP Queue A item 7)")
        self.cfg = config
        self._wp_sources: Dict[str, Any] = {}
        self._ckpt_log: List[Dict[str, Any]] = []
        self._restore_s: Optional[float] = None
        self.device = resolve_device(config.device)
        constants.set_experiment_trial_names(
            config.experiment_name, config.trial_name
        )
        seeding.set_random_seed(config.seed, config.worker_name)
        # Import factories/interfaces so registries are populated.
        import areal_tpu_torch.datasets  # noqa: F401
        import areal_tpu_torch.engine.factories  # noqa: F401
        import areal_tpu_torch.interfaces  # noqa: F401

        self.stream = rrs.make_worker_stream(
            config.experiment_name, config.trial_name, config.worker_name
        )
        self.data_manager = DataManager(
            config.experiment_name, config.trial_name, config.worker_name
        )

        # Datasets (only on data-hosting workers).
        self.dataloader = None
        self._dataset = None
        if config.stream_dataset:
            from areal_tpu_torch.system.stream_dataset import PullerStreamDataset

            self._dataset = PullerStreamDataset(
                config.experiment_name,
                config.trial_name,
                puller_index=config.dataset_dp_rank,
            )
        elif config.datasets:
            tokenizer = (data_api.load_hf_tokenizer(config.tokenizer_path)
                         if config.tokenizer_path else None)
            util = data_api.DatasetUtility(
                seed=config.seed,
                dp_rank=config.dataset_dp_rank,
                world_size=config.dataset_dp_size,
                tokenizer=tokenizer,
            )
            # As in the reference (which has no ConcatDataset), the first
            # dataset is the one loaded.
            self._dataset = [data_api.make_dataset(d, util) for d in config.datasets][0]
            self.dataloader = data_api.PackedDataLoader(
                self._dataset,
                batch_size=max(1, config.train_batch_size // config.dataset_dp_size),
                shuffle=config.shuffle_dataset,
                seed=config.seed,
            )

        # Models.
        self.models: Dict[str, Model] = {}
        self.interfaces: Dict[str, Any] = {}
        self.backends: Dict[str, Any] = {}
        dataset_size = len(self._dataset) * config.dataset_dp_size if self._dataset is not None else 0
        self._host_rank: Dict[str, int] = {}
        self._shard_init_s: Dict[str, float] = {}
        for shard in config.shards:
            t0 = time.monotonic()
            mn = shard.id.model_name
            self._host_rank[str(mn)] = shard.id.host_rank
            ft_spec = FinetuneSpec(
                total_train_epochs=config.total_train_epochs,
                dataset_size=dataset_size,
                train_batch_size=config.train_batch_size,
            )
            model = make_model(shard.model, name=mn, device=str(self.device))
            backend = make_backend(shard.backend)
            model = backend.initialize(model, ft_spec)
            self.models[str(mn)] = model
            self.backends[str(mn)] = backend
            self.interfaces[str(mn)] = make_interface(shard.interface)
            self._shard_init_s[str(mn)] = time.monotonic() - t0
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
        if self.dataloader is not None:
            batch, epoch_done = self.dataloader.next_batch()
            if epoch_done:
                # Curriculum step at the epoch boundary: drop prompts the
                # policy already solves; the dataloader sees the size
                # change and reshuffles.
                eval_scores.apply_filter(
                    self._dataset,
                    self.cfg.experiment_name,
                    self.cfg.trial_name,
                    tag=f"data{self.cfg.worker_index}",
                    # Floor at the per-rank fetch batch: fewer would starve
                    # the master's batch assembly.
                    min_size=self.dataloader.batch_size,
                )
        else:
            batch = self._dataset.poll_batch()
            epoch_done = False
            if batch is None:
                return {"meta": None, "epoch_done": False}
        self.data_manager.store(batch)
        return {"meta": batch.meta(), "epoch_done": epoch_done}

    def _exec_hook(self, hook: Dict, model_name: str, step: int = 0) -> Optional[float]:
        """Run one hook; a param_realloc returns its dump seconds."""
        htype = hook.get("type")
        if htype == "data_transfer":
            steps = [RedistribStep(**s) for s in hook["plan"]]
            self.data_manager.redistribute(steps)
        elif htype == "save":
            self._save_model(model_name)
        elif htype == "evaluate":
            self._evaluate_model(model_name)
        elif htype == "offload":
            model = self.models.get(model_name)
            if model is not None and hasattr(model.module, "offload"):
                # Free the idle model's device memory; the engine
                # restores lazily on its next call.
                model.module.offload()
            else:
                logger.debug("offload hook: engine has no offload; no-op")
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
                out = interface.generate(model, input_, mb_spec)
                stats = {}
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
            out_lens = None
            if out is not None and itype == "generate":
                out_lens = [l for sl in out.seqlens[out._main_key()] for l in sl]
            stats[metrics_registry.PERF_FLOPS] = float(
                monitor.mfc_flops(cfg, itype, in_lens, out_lens))
            if itype == "generate" and out_lens:
                # Group sampling replicates each prompt gconfig.n times in
                # the output: subtract each prompt once per replica.
                group = (len(out_lens) // len(in_lens)
                         if in_lens and len(out_lens) % len(in_lens) == 0 else 1)
                stats[metrics_registry.PERF_GEN_TOKENS] = float(
                    sum(out_lens) - group * sum(in_lens))

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

    def _save_model(self, model_name: Optional[str] = None):
        for mn, model in self.models.items():
            if model_name is not None and mn != model_name:
                continue
            save_dir = os.path.join(
                constants.get_save_path(self.cfg.experiment_name, self.cfg.trial_name),
                ModelName.parse(mn).role,
                f"step{model.version}",
                f"dp{self.cfg.worker_index}",
            )
            self.interfaces[mn].save(model, save_dir)

    def _ckpt_dir(self, mn: str) -> str:
        return os.path.join(
            constants.get_recover_path(self.cfg.experiment_name, self.cfg.trial_name),
            ModelName.parse(mn).role,
            f"dp{self.cfg.worker_index}",
        )

    def _dataloader_state_path(self) -> str:
        return os.path.join(
            constants.get_recover_path(self.cfg.experiment_name, self.cfg.trial_name),
            f"dataloader_{self.cfg.worker_index}.json",
        )

    def _handle_ckpt(self, req):
        from areal_tpu_torch.engine.checkpoint import ckpt_stats

        for mn, model in self.models.items():
            d = self._ckpt_dir(mn)
            self.backends[mn].save(model, d)
            self._ckpt_log.append(
                {"dir": d, "stall_ms": ckpt_stats["areal:train_ckpt_stall_ms"]})
        if self.dataloader is not None:
            state_path = self._dataloader_state_path()
            # Atomic like every other recovery artifact: a kill mid-write
            # leaves the previous cursor, not a torn file.
            tmp = state_path + f".tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(self.dataloader.state_dict(), f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, state_path)
        self._compact_stream_wal()
        return {"ok": True}

    def _compact_stream_wal(self):
        """Checkpoint-barrier WAL truncation, one barrier behind: drop
        journaled rollouts whose seqs the PREVIOUS durable recover record
        already marked consumed (the master writes this barrier's record
        after this handler returns; truncation may lag the durable
        ledger, never lead it)."""
        dataset = self._dataset
        if dataset is None or not hasattr(dataset, "compact_wal"):
            return
        try:
            info = recover.load(self.cfg.experiment_name, self.cfg.trial_name)
        except (FileNotFoundError, ValueError):
            return
        from areal_tpu_torch.system.wal import SeqLedger

        snapshot = getattr(info, "consumed_seqs", None)
        if not snapshot:
            return
        try:
            dropped = dataset.compact_wal(SeqLedger.from_dict(snapshot))
            if dropped:
                logger.info("WAL compaction dropped %d consumed record(s)", dropped)
        except Exception:
            logger.exception("WAL compaction failed (journal kept as-is)")

    def _handle_restore(self, req):
        from areal_tpu_torch.engine.checkpoint import has_engine_state

        t0 = time.monotonic()
        for mn, model in self.models.items():
            d = self._ckpt_dir(mn)
            if has_engine_state(d):
                self.backends[mn].load(model, d)
        if self.dataloader is not None:
            # Curriculum state first: the dataloader snapshot records the
            # FILTERED dataset size, so indices must be restored before
            # load_state_dict's size check.
            eval_scores.restore_indices(
                self._dataset,
                self.cfg.experiment_name,
                self.cfg.trial_name,
                tag=f"data{self.cfg.worker_index}",
            )
            state_path = self._dataloader_state_path()
            if os.path.exists(state_path):
                with open(state_path) as f:
                    self.dataloader.load_state_dict(json.load(f))
                self.dataloader.restart_epoch()
        self._restore_s = time.monotonic() - t0
        return {"ok": True}

    def _evaluate_model(self, model_name: Optional[str] = None):
        stats = {}
        for mn, model in self.models.items():
            if model_name is not None and mn != model_name:
                continue
            stats[mn] = self.interfaces[mn].evaluate(model, None)
        return stats

    def _param_realloc(self, hook: Dict, step: int = 0) -> Optional[float]:
        """Disk-mediated weight hand-off between model replicas. A source
        hosted here (DP rank 0) dumps first (``_realloc_dump``, whose
        seconds this returns); then a target hosted here loads the
        source's dump (``_realloc_load``)."""
        src, dst = hook.get("source"), hook.get("target")
        dump_s = None
        if src is not None and src in self.models and self._host_rank.get(src, 0) == 0:
            dump_s = self._realloc_dump(src, step)
        if dst is not None and dst in self.models:
            self._realloc_load(src, dst, step)
        return dump_s

    def _realloc_load(self, src: Optional[str], dst: str, step: int):
        """Load the source role's dump into the target once its
        ``step.txt`` reaches ``step`` (at most ``REALLOC_WAIT_S``): the
        reference's ``engine_state.pkl`` when the directory holds one, else
        the raw dump. Only the params move; the target's optimizer state
        stays."""
        from areal_tpu_torch.engine.checkpoint import load_state_file
        from areal_tpu_torch.system.weight_transfer import load_raw_params

        role = ModelName.parse(src).role if src else ModelName.parse(dst).role
        d = os.path.join(
            constants.get_param_realloc_path(self.cfg.experiment_name, self.cfg.trial_name),
            role,
        )
        stamp = os.path.join(d, "step.txt")
        deadline = time.monotonic() + REALLOC_WAIT_S
        while True:
            try:
                with open(stamp) as f:
                    if int(f.read().strip() or -1) >= step:
                        break
            except (FileNotFoundError, ValueError):
                pass
            if time.monotonic() > deadline:
                raise TimeoutError(f"param_realloc: no fresh dump for {role} (step {step}) "
                                   f"within {REALLOC_WAIT_S}s")
            time.sleep(0.05)
        if os.path.exists(os.path.join(d, "engine_state.pkl")):
            params = load_state_file(d)["params"]
        else:
            got = load_raw_params(d)
            if got is None:
                raise FileNotFoundError(
                    f"param_realloc: neither engine_state.pkl nor a complete raw dump in {d}")
            params = got[0]
        self.models[dst].module.set_params(params)
        logger.info(f"param_realloc load {role} -> {dst} at step {step} from {d}")

    def _realloc_dump(self, src: str, step: int) -> float:
        """The source model's DP rank 0 writes the raw dump of its params,
        stamped with `model.version` (the value `_publish_version`
        announces next; a generation server verifies that the dump it
        loads holds the version it asked for), with its chunk index at the
        plane's chunk size and, with `weight_wire_dtype`, the int8
        companion; with `weight_plane` it serves the dump dir as the
        plane's origin; then it writes `step.txt` with the global step and
        returns the dump's seconds. Only the disk dump is written (no
        tmpfs mirror, no ``engine_state.pkl``)."""
        from areal_tpu_torch.system.weight_transfer import dump_raw_params

        model = self.models[src]
        role = ModelName.parse(src).role
        d = os.path.join(
            constants.get_param_realloc_path(self.cfg.experiment_name, self.cfg.trial_name),
            role,
        )
        dump_s = dump_raw_params(model.module.get_params(), d, version=model.version,
                                 chunk_bytes=self.cfg.weight_chunk_bytes,
                                 wire_dtype=self.cfg.weight_wire_dtype)
        logger.info(
            f"param_realloc dump for {role} step {step}: raw dump "
            f"v{model.version} {dump_s:.3f}s"
        )
        if self.cfg.weight_plane:
            self._ensure_weight_plane_source(role, d)
        tmp = os.path.join(d, "step.txt.tmp")
        with open(tmp, "w") as f:
            f.write(str(step))
        os.replace(tmp, os.path.join(d, "step.txt"))
        return dump_s

    def _ensure_weight_plane_source(self, role: str, dump_dir: str):
        """Start (once per role) the trainer-side origin of the weight
        plane over the role's dump dir and register its URL for the
        manager."""
        if role in self._wp_sources:
            return
        from areal_tpu_torch.system.weight_plane import WeightPlaneSource

        src = WeightPlaneSource(dump_dir, chunk_bytes=self.cfg.weight_chunk_bytes,
                                host=network.gethostip()).start()
        src.register(self.cfg.experiment_name, self.cfg.trial_name, role)
        self._wp_sources[role] = src
        logger.info(f"weight-plane source for {role} at {src.address} over {dump_dir}")

    def _write_exit_record(self):
        import torch

        from areal_tpu_torch.engine.checkpoint import writer_stats

        write_exit_record(self.cfg.experiment_name, self.cfg.trial_name, self.worker_name, {
            "worker": self.worker_name,
            "launches": dict(kernels.launches),
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(self.device)
                                  if self.device.type == "cuda" else 0),
            "shard_init_s": self._shard_init_s,
            "ckpt": self._ckpt_log,
            "ckpt_writer": writer_stats(),
            "restore_s": self._restore_s,
        })

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
            elif h == "save":
                self._save_model()
                resp = {"ok": True}
            elif h == "evaluate":
                resp = self._evaluate_model()
            elif h == "ckpt":
                resp = self._handle_ckpt(req)
            elif h == "restore":
                resp = self._handle_restore(req)
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
            # A clean exit must not abandon an in-flight async checkpoint
            # write (the daemon writer dies with the process).
            from areal_tpu_torch.engine.checkpoint import wait_pending_writes

            wait_pending_writes(timeout=60)
        except Exception:
            logger.exception("pending checkpoint writes not drained on exit")
        try:
            self._write_exit_record()
        except Exception:
            logger.warning("exit record not written", exc_info=True)
        try:
            for src in self._wp_sources.values():
                src.close()
            self.stream.close()
            self.data_manager.close()
            if self._dataset is not None:
                self._dataset.close()
        except Exception:
            pass
