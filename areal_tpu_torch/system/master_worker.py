"""Master worker: drives one DFG traversal per train step (the port's
copy of ``areal_tpu/system/master_worker.py``): configure the stream,
buffer and executor, then per poll run a step, log its perf summary and
publish the experiment status, broadcast "save", "ckpt" and "evaluate"
to the model workers at the ``exp_ctrl`` frequencies
(``base/timeutil.py``), each "ckpt" followed by the recover record
(``base/recover.py``); tell the model workers to exit at the end. As in
the reference, a worker's reply to a broadcast is not read: one that
answers with an error does not stop the run.

With ``recover_mode`` "auto" or "resume" the master loads the recover
record at configure (a missing one is a fresh start), takes back its
step counters, frequency controls, the ids consumed this epoch and the
sequence ledger, and sends "restore" to the data hosts and model
workers. As in the reference, it resumes at ``last_step_info.next()``:
the first step after a resume counts one more than the steps trained.
The reference sends "restore" to a worker once for each of its roles
(data host, model worker); the port sends it once a worker (the
handler is idempotent).

Not ported yet: the tensorboard and wandb sinks and the merged RL-trace
summary.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from areal_tpu_torch.api.dfg import build_graph
from areal_tpu_torch.api.system_api import MasterWorkerConfig
from areal_tpu_torch.base import (
    constants, logging, name_resolve, names, recover, timeutil, tracing,
)
from areal_tpu_torch.base import metrics_registry as mreg
from areal_tpu_torch.base.fault_injection import faults
from areal_tpu_torch.base.recover import RecoverInfo, StepInfo
from areal_tpu_torch.system import request_reply_stream as rrs
from areal_tpu_torch.system.buffer import AsyncIOSequenceBuffer
from areal_tpu_torch.system.function_executor import FunctionExecutor
from areal_tpu_torch.system.model_function_call import RPCCorountineControl
from areal_tpu_torch.system.worker_base import PollResult, Worker

logger = logging.getLogger("master_worker")


class MasterWorker(Worker):
    def _configure(self, config: MasterWorkerConfig):
        self.cfg = config
        constants.set_experiment_trial_names(
            config.experiment_name, config.trial_name
        )
        self.stream = rrs.make_master_stream(
            config.experiment_name, config.trial_name
        )
        self.graph = build_graph(config.rpcs)
        self.buffer = AsyncIOSequenceBuffer(
            config.rpcs, max_size=config.buffer_max_size
        )
        self.ctrl = RPCCorountineControl()
        self.executor = FunctionExecutor(
            graph=self.graph,
            stream=self.stream,
            buffer=self.buffer,
            model_topos=config.model_topos,
            data_hosts=config.data_hosts,
            ctrl=self.ctrl,
            experiment_name=config.experiment_name,
            trial_name=config.trial_name,
        )

        ctl = config.exp_ctrl
        self.save_ctl = timeutil.FrequencyControl(
            frequency_epoch=ctl.save_freq_epochs,
            frequency_step=ctl.save_freq_steps,
            frequency_sec=ctl.save_freq_secs,
        )
        self.ckpt_ctl = timeutil.FrequencyControl(
            frequency_epoch=ctl.ckpt_freq_epochs,
            frequency_step=ctl.ckpt_freq_steps,
            frequency_sec=ctl.ckpt_freq_secs,
        )
        self.eval_ctl = timeutil.FrequencyControl(
            frequency_epoch=ctl.eval_freq_epochs,
            frequency_step=ctl.eval_freq_steps,
            frequency_sec=ctl.eval_freq_secs,
        )

        self.step_info = StepInfo()
        self._steps_per_epoch = max(
            1, config.dataset_size // max(1, config.train_batch_size)
        ) if config.dataset_size else None
        # Derive epoch boundaries from _steps_per_epoch only when the
        # dataset size was configured explicitly (async experiments: the
        # prompt dataset lives in rollout workers and the stream dataset
        # never reports epoch_done). Sync runs get real boundaries from
        # the dataloader; deriving there too would double-count.
        self._derive_epoch_boundary = bool(config.dataset_size)
        self._total_steps_cap = ctl.benchmark_steps
        self._start_time = time.monotonic()
        # Cumulative throughput accounting (effective trained tokens over
        # end-to-end seconds). Filled by _log_step_perf; returned through
        # the controller's run() result.
        self.perf_summary = {
            "steps": 0, "total_e2e_s": 0.0, "train_tokens": 0.0,
            "wall_s": 0.0,
            # Per-step [e2e_s, train_tokens] so benchmark consumers can
            # drop warm-up steps from the rate.
            "history": [],
            # Per-step {mfc name: stats} as the model workers reported
            # them (the port's own key; bounded runs only, as history).
            "mfc_stats": [],
            # Input-pipeline health (running means over steps that
            # reported): how dense the packed batches are and how much
            # of the step the host blocked on pack/H2D vs dispatch gaps.
            "overlap": {},
        }
        # metric -> [sum, count] (running, NOT a per-step list: an
        # open-ended RL run must not grow it for the process lifetime).
        self._overlap_acc: Dict[str, List[float]] = {}

        # Wait for every model worker to finish its lazy setup.
        handlers = [f"model_worker/{i}" for i in range(config.n_model_workers)]
        specs = self.stream.call(handlers, "spec", timeout=600)
        self._dataset_size = sum(
            s.get("dataset_size", 0) for s in specs if isinstance(s, dict)
        )
        if self._dataset_size and not self._steps_per_epoch:
            self._steps_per_epoch = max(
                1, self._dataset_size // max(1, config.train_batch_size)
            )
        logger.info(
            f"master configured: {len(config.rpcs)} MFCs, "
            f"{config.n_model_workers} model workers, "
            f"dataset size {self._dataset_size}"
        )

        if config.recover_mode in ("auto", "resume"):
            self._maybe_recover()

        name_resolve.add(
            names.experiment_status(config.experiment_name, config.trial_name),
            "RUNNING",
            replace=True,
        )

    # ------------------------------------------------------------------

    def _maybe_recover(self):
        try:
            info = recover.load(self.cfg.experiment_name, self.cfg.trial_name)
        except FileNotFoundError:
            logger.info("no recover info found; fresh start")
            return
        self.step_info = info.last_step_info.next()
        self.save_ctl.load_state_dict(info.save_ctl_info)
        self.ckpt_ctl.load_state_dict(info.ckpt_ctl_info)
        self.eval_ctl.load_state_dict(info.eval_ctl_info)
        self.buffer.ignore_ids |= set(info.hash_vals_to_ignore)
        # Re-arm the exactly-once ledger from the same durable cut the
        # engine state was taken at (getattr: a pre-ledger record
        # unpickles without the field).
        self.buffer.seed_consumed_seqs(getattr(info, "consumed_seqs", None))
        workers = list(dict.fromkeys(self.cfg.data_hosts + self._all_model_workers()))
        req = self.stream.request(workers, "restore", [None] * len(workers))
        self.stream.gather(req, timeout=600)
        logger.info(f"recovered at step {self.step_info.global_step}")

    def _all_model_workers(self) -> List[str]:
        return [f"model_worker/{i}" for i in range(self.cfg.n_model_workers)]

    def _recover_save(self):
        info = RecoverInfo(
            recover_start=self.step_info,
            last_step_info=self.step_info,
            save_ctl_info=self.save_ctl.state_dict(),
            ckpt_ctl_info=self.ckpt_ctl.state_dict(),
            eval_ctl_info=self.eval_ctl.state_dict(),
            hash_vals_to_ignore=sorted(self.buffer.consumed_this_epoch),
            # The consumed-seq watermark commits with the step counters
            # (one fsynced rename in recover.dump); model workers compact
            # their WALs against this record at the NEXT ckpt barrier.
            consumed_seqs=self.buffer.consumed_seqs(),
        )
        recover.dump(info, self.cfg.experiment_name, self.cfg.trial_name)

    def _broadcast(self, handle: str, timeout: float = 3600):
        workers = self._all_model_workers()
        return self.stream.call(workers, handle, timeout=timeout)

    # ------------------------------------------------------------------

    def _poll(self) -> Optional[PollResult]:
        # Chaos injection point: arming this simulates a master-plane
        # failure, which must escalate to the whole-experiment relaunch
        # (the master is NOT a restartable fault domain).
        faults.maybe_fail("master.step")
        t0 = time.monotonic()
        epoch_before = self.step_info.epoch

        # Keep the shared coroutine-control step info (shipped in every
        # MFC request: param-realloc stamps, trace attributes) in sync
        # with the authoritative counter.
        self.ctrl.step_info.update(
            epoch=self.step_info.epoch,
            epoch_step=self.step_info.epoch_step,
            global_step=self.step_info.global_step,
        )
        self.buffer.current_train_step = self.step_info.global_step
        with tracing.span(
            "master.step", step=self.step_info.global_step
        ):
            stats = self.executor.execute_step_sync()

        epoch_boundary = self.executor.epoch_done
        if (
            not epoch_boundary
            and self._derive_epoch_boundary
            and self._steps_per_epoch
        ):
            # Async runs: derive the boundary from the configured prompt
            # dataset size so epoch-based save/eval frequencies and
            # total_train_epochs terminate them too.
            epoch_boundary = (
                self.step_info.epoch_step + 1 >= self._steps_per_epoch
            )
        self.step_info.epoch_step += 1
        self.step_info.global_step += 1
        if epoch_boundary:
            self.step_info.epoch += 1
            self.step_info.epoch_step = 0
            self.buffer.on_epoch_boundary()

        e2e = time.monotonic() - t0
        logger.info(
            f"step {self.step_info.global_step} "
            f"(epoch {self.step_info.epoch}.{self.step_info.epoch_step}) "
            f"e2e={e2e:.3f}s stats={ {k: {kk: round(vv, 5) for kk, vv in v.items()} for k, v in stats.items()} }"
        )
        self._log_step_perf(e2e)

        epochs_inc = self.step_info.epoch - epoch_before
        if self.save_ctl.check(steps=1, epochs=epochs_inc):
            self._broadcast("save")
        if self.ckpt_ctl.check(steps=1, epochs=epochs_inc):
            self._broadcast("ckpt")
            self._recover_save()
        if self.eval_ctl.check(steps=1, epochs=epochs_inc):
            self._broadcast("evaluate")

        done = False
        if self._total_steps_cap is not None:
            done = self.step_info.global_step >= self._total_steps_cap
        elif self.step_info.epoch >= (self.cfg.exp_ctrl.total_train_epochs or 1):
            done = True
        if done:
            self.experiment_complete_exit()
            return None
        return PollResult(sample_count=1, batch_count=1)

    def _log_step_perf(self, e2e: float):
        """Per-step performance telemetry: `timeperf/e2e`, per-MFC wall
        time, analytic TFLOP/s, the input-pipeline series, logged as one
        `benchmark:` line."""
        mfc_stats = dict(self.executor.ctrl.mfc_stats)
        self.executor.ctrl.mfc_stats = {}
        scalars = {"timeperf/e2e": e2e}
        total_flops = 0.0
        for name, st in mfc_stats.items():
            for k, v in st.items():
                if not isinstance(v, (int, float)):
                    continue
                if k == mreg.PERF_ELAPSED:
                    scalars[f"timeperf/{name}"] = v
                elif k == mreg.PERF_TFLOPS:
                    scalars[f"tflops/{name}"] = v
                elif k == mreg.PERF_FLOPS:
                    total_flops += v
                elif k == mreg.PERF_GEN_TOKENS_PER_SEC:
                    scalars[f"gen_tokens_per_sec/{name}"] = v
                elif k in (
                    mreg.PERF_PACKING_EFFICIENCY,
                    mreg.PERF_H2D_WAIT_MS,
                    mreg.PERF_DISPATCH_GAP_MS,
                    mreg.PERF_OVERLAP_EVENTS,
                    # Rollout-pipeline series: episode e2e latency
                    # percentiles + interruption re-prefill tokens, from
                    # trajectory metadata (async runs only).
                    mreg.PERF_ROLLOUT_E2E_P50_MS,
                    mreg.PERF_ROLLOUT_E2E_P95_MS,
                    mreg.PERF_REPREFILL_TOKENS,
                    # MoE router health: realized drop rate, entropy,
                    # hottest-expert load, a2a volume.
                    mreg.PERF_MOE_DROP_RATE,
                    mreg.PERF_MOE_ROUTER_ENTROPY,
                    mreg.PERF_MOE_EXPERT_OVERLOAD,
                    mreg.PERF_MOE_A2A_BYTES,
                    # Agentic episodes: turn/tool-call volume, the
                    # per-task staleness means and the per-task
                    # admission drops.
                    mreg.PERF_EPISODE_TURNS,
                    mreg.PERF_EPISODE_TOOL_CALLS,
                    mreg.PERF_TASK_STALENESS_MATH,
                    mreg.PERF_TASK_STALENESS_AGENTIC,
                    mreg.PERF_TASK_STALE_DROPPED_MATH,
                    mreg.PERF_TASK_STALE_DROPPED_AGENTIC,
                ):
                    # Input-pipeline telemetry: per-MFC series + running
                    # mean in perf_summary["overlap"].
                    metric = k[len("perf/"):]
                    scalars[f"{metric}/{name}"] = v
                    acc = self._overlap_acc.setdefault(metric, [0.0, 0])
                    acc[0] += v
                    acc[1] += 1
                elif not k.startswith("perf/"):
                    scalars[k] = v
        if total_flops:
            scalars["tflops/e2e"] = total_flops / e2e / 1e12
        self.perf_summary["steps"] += 1
        self.perf_summary["total_e2e_s"] += e2e
        self.perf_summary["wall_s"] = time.monotonic() - self._start_time
        # Effective trained tokens: every train interface reports an
        # additive <name>/n_tokens (e.g. ppo_actor/n_tokens).
        step_tokens = sum(
            v for k, v in scalars.items()
            if k.endswith("/n_tokens") and isinstance(v, (int, float))
        )
        self.perf_summary["train_tokens"] += step_tokens
        # Per-step history only for bounded benchmark runs; an
        # open-ended RL run would grow it for the process lifetime.
        if self._total_steps_cap is not None:
            self.perf_summary["history"].append([e2e, step_tokens])
            self.perf_summary["mfc_stats"].append(mfc_stats)
        self.perf_summary["overlap"] = {
            m: float(s / n) for m, (s, n) in self._overlap_acc.items() if n
        }
        perf_keys = [
            k for k in sorted(scalars)
            if k.startswith((
                "timeperf/", "tflops/", "gen_tokens_per_sec/",
                "packing_efficiency/", "h2d_wait_ms/", "dispatch_gap_ms/",
                "overlap_events/", "rollout_e2e_p50_ms/",
                "rollout_e2e_p95_ms/", "reprefill_tokens/",
                "moe_drop_rate/", "moe_router_entropy/",
                "moe_expert_overload/", "moe_a2a_bytes/",
            ))
        ]
        logger.info(
            "benchmark: "
            + " ".join(f"{k}={scalars[k]:.4g}" for k in perf_keys)
        )

    def experiment_complete_exit(self):
        """Signal completion + tell workers to exit."""
        logger.info(
            f"experiment complete after {self.step_info.global_step} steps "
            f"({time.monotonic() - self._start_time:.1f}s)"
        )
        name_resolve.add(
            names.experiment_status(
                self.cfg.experiment_name, self.cfg.trial_name
            ),
            "COMPLETE",
            replace=True,
        )
        try:
            self._broadcast("exit", timeout=60)
        except Exception:
            logger.warning("some workers did not ack exit", exc_info=True)

    def _exit_hook(self):
        try:
            self.stream.close()
        except Exception:
            pass
