"""The PyTorch train + inference engine (counterpart of
``areal_tpu/engine/jax_engine.py``: ``JaxTrainEngine``).

``train_batch`` runs micro-batch gradient accumulation and one optimizer
step: each micro-batch's sequences are packed into [R, T] rows, the model
runs to hidden states, the fused chunked-vocab op turns them into
next-token logprobs (the [R, T, V] logits never exist), the loss function
reduces them, and the gradients are summed in float32 in micro-batch
order. The sum is scaled by 1 / global_denom, its global norm taken, and
AdamW applied with the learning rate of the schedule at ``version_steps``.
Nothing is fetched from the device until the one packed stats vector at
the end.

Loss functions are callables ``loss_fn(model_out, rows) -> (loss_sum,
aux_dict)`` where ``model_out`` is the per-token next-token logprobs
[R, T] (LM models) or values [R, T] (critics), and ``rows`` carries the
packed [R, T] tensors of every data key (token-aligned keys scattered,
per-sequence scalars broadcast across their span).

The engine owns its parameter tensors and updates them in place.
``generate`` runs the in-framework generator (``models/generation.py``)
on the engine's params, seeded from the call counter as the reference
seeds its key. ``offload`` copies the params and the AdamW moments to
host memory (pinned for a CUDA engine) and frees the device copies; the
next engine call restores them (``_ensure_loaded``), and while offloaded
``get_params`` / ``get_opt_state`` answer from the host copies. Not
ported: meshes, the overlapped input pipeline, ``warm``, the MoE terms of
the loss and the cached stats fetch. The state a checkpoint holds
(``engine/checkpoint.py``) comes from ``get_params``, ``get_opt_state``
(optax's layout), ``rng_state`` and ``version``, as the reference's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch import resolve_device
from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import GenerationHyperparameters, PackedLossFn, TrainEngine
from areal_tpu_torch.engine.optimizer import (
    AdamW, OptimizerConfig, as_tensor, global_norm, make_lr_schedule, tree_leaves,
)
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.generation import generate_tokens
from areal_tpu_torch.models.packing import PackedBatch, pack_sequences
from areal_tpu_torch.models.transformer import forward as model_forward
from areal_tpu_torch.ops.loss import fused_next_token_logprobs


def _to_device_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device_tree(v, device) for k, v in tree.items()}
    return as_tensor(tree).detach().to(device).requires_grad_(True)


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: into pinned memory from a CUDA tensor (the
    copy runs on the current stream; the caller synchronizes), a clone
    from a CPU one."""
    t = t.detach()
    if t.device.type == "cpu":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return _host_copy(tree)


class TorchTrainEngine(TrainEngine):

    def __init__(
        self,
        model_cfg: TransformerConfig,
        params: Dict[str, Any],
        optimizer_config: Optional[OptimizerConfig] = None,
        total_train_steps: int = 1000,
        remat: Any = "full",  # "full" | "none" (bools ok)
        row_len_multiple: int = 128,
        max_row_len: Optional[int] = None,
        hf_family: Optional[str] = None,
        device="cuda",
    ):
        if model_cfg.moe is not None:
            raise NotImplementedError("MoE models are not ported yet")
        self.model_cfg = model_cfg
        # The HF family the weights map through; SFTInterface.save needs it.
        self.hf_family = hf_family
        self.device = resolve_device(device)
        self.remat = remat
        self.row_len_multiple = row_len_multiple
        self.max_row_len = max_row_len
        self.params = _to_device_tree(params, self.device)
        self.optimizer: Optional[AdamW] = None
        self._lr_schedule = None
        # LR-schedule position when callers do not pass version_steps (one
        # optimizer step per train_batch).
        self._lr_steps = 0
        # The reference's counters (rng_state): generate calls (each
        # seeds its sampler) and train_batch calls.
        self._gen_calls = 0
        self._train_calls = 0
        # As the reference's engine: set to 0 here and by a checkpoint
        # load, never advanced (Model.version counts the trained steps).
        self.version = 0
        # offload(): the host copies of the params and of the AdamW
        # moments (the optimizer's mu / nu lists hold them meanwhile).
        self._offloaded = False
        self._host_params = None
        if optimizer_config is not None:
            self.optimizer = AdamW(optimizer_config, tree_leaves(self.params))
            self._lr_schedule = make_lr_schedule(optimizer_config, total_train_steps)

    # ------------------------------------------------------------------
    # Batch building
    # ------------------------------------------------------------------

    def _build_rows(
        self, sample: SequenceSample, keys: Optional[List[str]] = None
    ) -> Tuple[PackedBatch, Dict[str, np.ndarray]]:
        """Pack the main token key into rows; scatter/broadcast other keys."""
        main_key = sample._main_key()
        flat_main = sample.data[main_key]
        lens_per_seq: List[int] = []
        seqs: List[np.ndarray] = []
        offset = 0
        for sl in sample.seqlens[main_key]:
            for l in sl:
                seqs.append(np.asarray(flat_main[offset : offset + l]))
                lens_per_seq.append(l)
                offset += l
        batch = pack_sequences(
            seqs,
            row_len_multiple=self.row_len_multiple,
            max_row_len=self.max_row_len,
        )
        rows: Dict[str, np.ndarray] = {
            "input_ids": batch.input_ids,
            "segment_ids": batch.segment_ids,
            "positions": batch.positions,
        }
        total_main = sum(lens_per_seq)
        for k in keys if keys is not None else sample.keys:
            if k == main_key or sample.data.get(k) is None:
                continue
            d = np.asarray(sample.data[k])
            if d.shape[0] == total_main:
                # Token-aligned: split per sequence in main-key order.
                per_seq, off = [], 0
                for l in lens_per_seq:
                    per_seq.append(d[off : off + l])
                    off += l
                rows[k] = batch.scatter_per_token(per_seq)
            elif d.shape[0] == len(lens_per_seq):
                # Per-sequence scalar: broadcast across each span.
                per_seq = [np.full((l,), d[i]) for i, l in enumerate(lens_per_seq)]
                rows[k] = batch.scatter_per_token(per_seq)
            else:
                raise ValueError(
                    f"key {k!r} length {d.shape[0]} aligns with neither tokens "
                    f"({total_main}) nor sequences ({len(lens_per_seq)})"
                )
        return batch, rows

    def _device_rows(self, rows: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Rows as tensors on the engine's device, 64-bit types narrowed to
        32 bits (what the reference's device transfer does)."""
        out = {}
        for k, v in rows.items():
            v = np.asarray(v)
            if v.dtype == np.int64:
                v = v.astype(np.int32)
            elif v.dtype == np.float64:
                v = v.astype(np.float32)
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
        return out

    # ------------------------------------------------------------------
    # Train
    # ------------------------------------------------------------------

    def _head_weight(self, p):
        if self.model_cfg.tied_embeddings:
            return p["embedding"]["weight"].T
        return p["head"]["weight"]

    def _model_out(self, rows, output: str, remat) -> torch.Tensor:
        """Next-token logprobs [R, T] (the fused chunked-vocab path over
        hidden states), critic values [R, T] or raw logits [R, T, V]."""
        fuse = output == "logprobs" and not self.model_cfg.is_critic
        out = model_forward(
            self.params, self.model_cfg,
            rows["input_ids"], rows["segment_ids"], rows["positions"],
            output="hidden" if fuse else "logits", remat=remat, device=self.device,
        )
        if fuse:
            out = fused_next_token_logprobs(
                out, self._head_weight(self.params),
                rows["input_ids"], rows["segment_ids"],
            )
        return out

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
        """Forward + backward over micro-batches, one optimizer step, no
        host sync until the single packed-stats fetch at the end.

        `version_steps` is the LR-schedule position: the schedule value
        there scales this step's update, so every PPO minibatch update of
        one version trains at that version's LR. Adam's bias correction
        still counts actual optimizer updates. `None` falls back to the
        engine's own train_batch count. The applied value is reported as
        `<loss_name>/lr`.

        `token_normalize_scope='dp'` is per-data-parallel-shard
        normalization; on one device it equals `'global'`.
        """
        if self.optimizer is None:
            raise RuntimeError("engine built without optimizer")
        self._ensure_loaded()
        if token_normalize_scope not in ("global", "dp"):
            raise ValueError(f"unknown token_normalize_scope {token_normalize_scope!r}")
        lr_pos = self._lr_steps if version_steps is None else int(version_steps)
        self._lr_steps += 1
        self._train_calls += 1
        lr = float(self._lr_schedule(lr_pos))
        mbs, _, _ = input_.split(mb_spec)
        global_denom = max(float(sum(loss_weight_fn(mb) for mb in mbs)), 1.0)

        leaves = tree_leaves(self.params)
        grads: List[Optional[torch.Tensor]] = [None] * len(leaves)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        aux_sum: Dict[str, torch.Tensor] = {}
        for mb in mbs:
            _, rows_np = self._build_rows(mb)
            rows = self._device_rows(rows_np)
            out = self._model_out(
                rows, "values" if self.model_cfg.is_critic else "logprobs", self.remat)
            loss, aux = loss_fn(out, rows)
            loss.backward()
            # Float32 accumulation in micro-batch order.
            for i, p in enumerate(leaves):
                g, p.grad = p.grad, None
                if g is None:  # a leaf the loss does not reach
                    g = torch.zeros_like(p)
                if grads[i] is None:
                    grads[i] = g.float()
                else:
                    grads[i].add_(g)
            loss_sum = loss_sum + loss.detach().float()
            for k, v in aux.items():
                v = v.detach().float()
                aux_sum[k] = aux_sum[k] + v if k in aux_sum else v

        with torch.no_grad():
            for g in grads:
                g.mul_(1.0 / global_denom)
            gnorm = global_norm(grads)
            self.optimizer.apply(leaves, grads, gnorm, lr)
            # Every scalar stat in one vector: one device fetch per step.
            aux_keys = sorted(aux_sum)
            packed = torch.stack([loss_sum, gnorm] + [aux_sum[k] for k in aux_keys])
        p = packed.cpu().tolist()
        stats = {
            f"{loss_name}/loss": p[0] / global_denom,
            f"{loss_name}/grad_norm": p[1],
            f"{loss_name}/n_tokens": global_denom,
            f"{loss_name}/n_mbs": float(len(mbs)),
            f"{loss_name}/lr": lr,
        }
        for k, v in zip(aux_keys, p[2:]):
            if k.startswith("mean:"):
                # Micro-batch-mean stats (fractions / rates): summed over
                # the accumulation, so divide by the micro-batch count.
                stats[f"{loss_name}/{k[len('mean:'):]}"] = v / len(mbs)
            else:
                stats[f"{loss_name}/{k}"] = v / global_denom
        return stats

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------

    @torch.no_grad()
    def forward(
        self,
        input_: SequenceSample,
        mb_spec: MicroBatchSpec,
        output_key: str = "logprobs",
        output: Optional[str] = None,
        post_hook: Optional[Callable] = None,
    ) -> SequenceSample:
        """Gradient-free forward; returns a SequenceSample keyed
        `output_key` with per-token arrays aligned to the main key."""
        self._ensure_loaded()
        output = output or ("values" if self.model_cfg.is_critic else "logprobs")
        main_key = input_._main_key()
        per_mb_flat: List[np.ndarray] = []
        mb_seqlens: List[List[int]] = []
        mbs, _, bwd_indices = input_.split(mb_spec)
        for mb in mbs:
            batch, rows = self._build_rows(mb, keys=[main_key])
            out_rows = self._model_out(self._device_rows(rows), output, "none")
            per_mb_flat.append(batch.gather_flat(out_rows.float().cpu().numpy()))
            mb_seqlens.append(mb.seqlens_of())
        merged = SequenceSample.reorder_output(
            np.concatenate(per_mb_flat, axis=0), mb_seqlens, bwd_indices)
        out = SequenceSample(
            ids=list(input_.ids),
            keys={output_key},
            data={output_key: merged},
            seqlens={output_key: [list(sl) for sl in input_.seqlens[main_key]]},
        )
        if post_hook is not None:
            out = post_hook(out)
        return out

    # ------------------------------------------------------------------
    # Generation
    # ------------------------------------------------------------------

    def generate(
        self,
        input_: SequenceSample,
        mb_spec: MicroBatchSpec,
        tokenizer: Any,
        gconfig: GenerationHyperparameters,
    ) -> List[Dict[str, Any]]:
        """Generate for each prompt, replicated ``gconfig.n`` times, in one
        batch (``mb_spec`` is not read, as in the reference). Returns the
        raw per-sequence dicts; the PPO interface assembles them. The
        sampler is seeded from the call counter, advanced before the call
        (the reference's ``PRNGKey(_gen_calls)``)."""
        main_key = input_._main_key()
        flat = np.asarray(input_.data[main_key])
        prompts: List[List[int]] = []
        offset = 0
        for sl in input_.seqlens[main_key]:
            for l in sl:
                prompts.append(flat[offset: offset + l].astype(np.int32).tolist())
                offset += l
        expanded = [p for p in prompts for _ in range(gconfig.n)]
        self._gen_calls += 1
        self._ensure_loaded()
        generator = torch.Generator(device=self.device).manual_seed(self._gen_calls)
        eos = getattr(tokenizer, "eos_token_id", None) if tokenizer is not None else None
        return generate_tokens(self.params, self.model_cfg, expanded, gconfig, generator,
                               eos_token_id=eos)

    # ------------------------------------------------------------------
    # State
    # ------------------------------------------------------------------

    def _moments_to(self, fn):
        if self.optimizer is not None:
            self.optimizer.mu = [fn(m) for m in self.optimizer.mu]
            self.optimizer.nu = [fn(m) for m in self.optimizer.nu]

    @torch.no_grad()
    def offload(self):
        """Copy the params and the AdamW moments to host memory (pinned
        for a CUDA engine) and drop the device copies, freeing the card
        for the models colocated on this worker; the next engine call
        restores them (``_ensure_loaded``)."""
        if self._offloaded:
            return
        self._host_params = _host_tree(self.params)
        self._moments_to(_host_copy)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.params = None
        self._offloaded = True

    def _ensure_loaded(self):
        if not self._offloaded:
            return
        self.params = _to_device_tree(self._host_params, self.device)
        self._moments_to(lambda m: m.to(self.device))
        self._host_params = None
        self._offloaded = False

    def get_params(self):
        """The engine's own parameter tensors (updated in place by
        train_batch); while offloaded, the host copies (every caller
        copies to the host anyway, and a restore could crowd the model
        the offload made room for)."""
        if self._offloaded:
            return self._host_params
        return self.params

    def drop_offloaded_state(self):
        """Discard the offloaded host copies without restoring them, for a
        caller about to set both params and optimizer state (a checkpoint
        load): the params stay unset until ``set_params``, and the moments
        come back as zeros on the device for ``set_opt_state`` to fill."""
        if not self._offloaded:
            return
        self._moments_to(lambda m: torch.zeros(m.shape, dtype=m.dtype, device=self.device))
        self._host_params = None
        self._offloaded = False

    def set_params(self, params):
        """Replace the weights (torch or numpy leaves); optimizer state
        stays. While offloaded, the moments come back to the device (a
        param realloc swaps weights only) and the host params are
        dropped."""
        if self._offloaded:
            self._moments_to(lambda m: m.to(self.device))
            self._host_params = None
            self._offloaded = False
        self.params = _to_device_tree(params, self.device)

    def get_opt_state(self):
        """The optimizer state in optax's layout (``AdamW.optax_state``:
        the moments are the optimizer's own tensors, the host copies while
        offloaded), or None without an optimizer."""
        if self.optimizer is None:
            return None
        return self.optimizer.optax_state(self.get_params())

    def set_opt_state(self, state):
        """Take back a state in ``get_opt_state``'s layout."""
        if self.optimizer is None:
            raise RuntimeError("engine built without optimizer")
        self.optimizer.load_optax_state(state)

    def rng_state(self) -> dict:
        """The call counters a restored engine continues from (the
        reference's keys)."""
        return {
            "gen_calls": int(self._gen_calls),
            "train_calls": int(self._train_calls),
            "lr_steps": int(self._lr_steps),
        }

    def load_rng_state(self, state: dict):
        self._gen_calls = int(state.get("gen_calls", 0))
        self._train_calls = int(state.get("train_calls", 0))
        self._lr_steps = int(state.get("lr_steps", self._lr_steps))
