"""PPO actor / critic algorithm interfaces (counterpart of
``areal_tpu/interfaces/ppo.py``).

generate -> rollout sample assembly (sync PPO: ``TrainEngine.generate``,
with best-of-k selection under ``generation_size``; the async loop's
rollouts come from the serving engine instead); inference -> proximal
logprob recompute; train_step -> rewards (KL penalty + clipped task score)
-> GAE -> advantage normalization (global or per prompt group) ->
minibatched decoupled-PPO updates through the engine. Beside the
reference's stats, the actor's train step records three readings of its
first minibatch through the stats tracker only (``ppo_actor_first_mb/``
``importance_weight``, ``approx_kl`` and ``abs_logprob_diff``, each a mean
over its response tokens). At a sync step that minibatch runs on the
weights that generated the batch, so they compare the generator's
logprobs with the training forward's on the same tokens. The importance
weight cannot show a wrong generator: over tokens sampled from the
generator's distribution q its expectation is 1 whatever q is. The KL
estimate (KL(q || p) in expectation) and the mean |difference| do not
cancel so.

Data-layout conventions (all token-aligned keys live in the shifted frame
of next_token_logprobs: position t scores token t+1):
- packed_input_ids: prompt + response tokens, grouped per prompt id
- prompt_mask: 1 on prompt token positions
- packed_logprobs: behavior logprobs from generation
- logprobs: proximal logprobs recomputed at train time (decoupled PPO)
- ref_logprobs: reference-model logprobs
- values: critic values (absent in group-reward / GRPO mode)
- rewards: per-sequence task scores; seq_no_eos_mask: per-sequence
- version_start / version_end: per-sequence weight versions (staleness)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import (
    GenerationHyperparameters,
    Model,
    ModelInterface,
    register_interface,
)
from areal_tpu_torch.base import stats_tracker
from areal_tpu_torch.interfaces import functional as F
from areal_tpu_torch.ops.gae import packed_gae
from areal_tpu_torch.ops.loss import masked_normalization, shift_left


def response_scoring_mask(segment_ids, prompt_mask):
    """[R, T] 1.0 where position t scores a response token (t+1)."""
    seg = segment_ids
    return ((shift_left(seg, 0) == seg) & (seg > 0)
            & (shift_left(prompt_mask, 1) == 0)).float()


def last_response_position_mask(resp_mask):
    """[R, T] 1.0 at the final scoring position of each segment."""
    return resp_mask * (1.0 - shift_left(resp_mask, 0))


@dataclasses.dataclass
class PPOActorInterface(ModelInterface):
    n_minibatches: int = 4
    # 'global' | 'dp': per-data-parallel-shard gradient normalization; the
    # same thing on one device.
    token_normalize_scope: str = "global"
    eps_clip: float = 0.2
    c_clip: Optional[float] = None
    kl_ctl: float = 0.1
    adaptive_kl_ctl: bool = False
    adaptive_kl_target: float = 6.0
    adaptive_kl_horizon: float = 10000.0
    discount: float = 1.0
    gae_lambda: float = 1.0
    max_reward_clip: float = 20.0
    reward_output_scaling: float = 1.0
    reward_output_bias: float = 0.0
    adv_norm: bool = True
    group_adv_norm: bool = False
    mask_no_eos_with_zero: bool = False
    use_decoupled_loss: bool = False
    behav_imp_weight_cap: Optional[float] = None
    temperature: float = 1.0
    # Best-of-k: sample `generation_size` responses per prompt, verify
    # them, and keep only the top `gconfig.n` (by score, longer first on
    # ties) for training.
    generation_size: Optional[int] = None
    gconfig: GenerationHyperparameters = dataclasses.field(
        default_factory=GenerationHyperparameters)

    def __post_init__(self):
        if isinstance(self.gconfig, dict):
            self.gconfig = GenerationHyperparameters(**self.gconfig)
        if self.adaptive_kl_ctl:
            self.kl_controller = F.AdaptiveKLController(
                self.kl_ctl, self.adaptive_kl_target, self.adaptive_kl_horizon
            )
        else:
            self.kl_controller = F.FixedKLController(self.kl_ctl)

    # ------------------------------------------------------------------
    # Generate (sync PPO; the async loop's rollouts come from the servers)
    # ------------------------------------------------------------------

    def _best_of_k(
        self, model: Model, input_: SequenceSample, outs: List[Dict], k: int
    ) -> List[Dict]:
        """Sample-then-select: verify all `generation_size` candidates of
        each prompt and keep the k best, scores descending with longer
        generations breaking ties. The answers ride in the sample's
        metadata ('solutions')."""
        from areal_tpu_torch.interfaces.reward import verify_all

        g = self.generation_size
        tasks = input_.metadata.get("tasks") or ["math"] * input_.bs
        answers = input_.metadata.get("solutions") or input_.metadata.get("answers")
        if answers is None:
            raise ValueError(
                "generation_size > gconfig.n needs 'solutions'/'answers' "
                "metadata to score candidates")
        jobs = [
            (tasks[pi], model.tokenizer.decode(outs[pi * g + ci]["output_ids"]), answers[pi])
            for pi in range(input_.bs)
            for ci in range(g)
        ]
        oks = verify_all(jobs)
        selected: List[Dict] = []
        for pi in range(input_.bs):
            cand = outs[pi * g: (pi + 1) * g]
            scored = [(1.0 if oks[pi * g + ci] else 0.0, len(o["output_ids"]), ci)
                      for ci, o in enumerate(cand)]
            scored.sort(key=lambda t: (t[0], t[1]), reverse=True)
            selected.extend(cand[ci] for _, _, ci in scored[:k])
        return selected

    def generate(
        self, model: Model, input_: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        engine = model.module
        n = self.gconfig.n
        if self.generation_size is not None and self.generation_size > n:
            gcfg = dataclasses.replace(self.gconfig, n=self.generation_size)
            outs = engine.generate(input_, mb_spec, model.tokenizer, gcfg)
            outs = self._best_of_k(model, input_, outs, n)
        else:
            outs = engine.generate(input_, mb_spec, model.tokenizer, self.gconfig)
        prompt_key = "packed_prompts" if "packed_prompts" in input_.keys else input_._main_key()
        flat_prompts = np.asarray(input_.data[prompt_key])
        plens = [sum(sl) for sl in input_.seqlens[prompt_key]]
        offsets = np.concatenate([[0], np.cumsum(plens)])

        seqs, pmask, blogp, no_eos = [], [], [], []
        group_lens: List[List[int]] = []
        for pi in range(input_.bs):
            prompt = flat_prompts[offsets[pi]: offsets[pi + 1]].astype(np.int64)
            lens = []
            for gi in range(n):
                o = outs[pi * n + gi]
                full = np.concatenate([prompt, np.asarray(o["output_ids"], np.int64)])
                lens.append(len(full))
                seqs.append(full)
                pm = np.zeros(len(full), np.int64)
                pm[: len(prompt)] = 1
                pmask.append(pm)
                # Shifted frame: generated token i (absolute position
                # len(prompt) + i) is scored at len(prompt) + i - 1.
                lp = np.zeros(len(full), np.float32)
                lp[len(prompt) - 1: len(full) - 1] = o["output_logprobs"]
                blogp.append(lp)
                no_eos.append(1.0 if o["no_eos"] else 0.0)
            group_lens.append(lens)

        return SequenceSample(
            ids=list(input_.ids),
            keys={"packed_input_ids", "prompt_mask", "packed_logprobs", "seq_no_eos_mask"},
            data={
                "packed_input_ids": np.concatenate(seqs),
                "prompt_mask": np.concatenate(pmask),
                "packed_logprobs": np.concatenate(blogp),
                "seq_no_eos_mask": np.asarray(no_eos, np.float32),
            },
            seqlens={
                "packed_input_ids": group_lens,
                "prompt_mask": group_lens,
                "packed_logprobs": group_lens,
                "seq_no_eos_mask": [[1] * n for _ in range(input_.bs)],
            },
            metadata={
                "version_start": [model.version] * input_.bs,
                "version_end": [model.version] * input_.bs,
            },
        )

    # ------------------------------------------------------------------
    # Inference: recompute logprobs under the current (proximal) policy
    # ------------------------------------------------------------------

    def inference(
        self, model: Model, input_: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        return model.module.forward(input_, mb_spec, output_key="logprobs")

    # ------------------------------------------------------------------
    # Train
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _prep(self, rows: Dict[str, torch.Tensor], kl_coef: float):
        """Whole-batch (advantages, returns, response mask, KL sum) on the
        device, from packed rows."""
        resp_mask = response_scoring_mask(rows["segment_ids"], rows["prompt_mask"])
        last_mask = last_response_position_mask(resp_mask)
        zeros = torch.zeros_like(resp_mask)
        values = rows.get("values")
        has_critic = values is not None
        if values is None:
            values = zeros
        no_eos = rows["seq_no_eos_mask"]
        ref_logprobs = rows.get("ref_logprobs", zeros)
        rewards = F.packed_rewards(
            kl_coef=kl_coef,
            clip_reward_value=self.max_reward_clip,
            score=rows["rewards"] * self.reward_output_scaling + self.reward_output_bias,
            logprobs=rows["packed_logprobs"],
            ref_logprobs=ref_logprobs,
            response_mask=resp_mask,
            last_response_mask=last_mask,
            mask_no_eos_with_zero=self.mask_no_eos_with_zero,
            no_eos_mask=no_eos,
        )
        # GAE runs over the scoring region only: restricting the segment
        # ids to scoring positions makes each segment end at its last
        # scoring position, which is where the bootstrap value V(s_T) must
        # enter the recursion for truncated (no-EOS) sequences.
        score_seg = rows["segment_ids"] * resp_mask.to(rows["segment_ids"].dtype)
        # Bootstrap for truncated sequences: V(s_{T+1}), the critic value
        # at the final token position, one to the right of the last
        # scoring position (values are token-aligned).
        bootstrap = (
            shift_left(values, 0) * last_mask * no_eos if has_critic else zeros
        )
        adv, ret = packed_gae(
            rewards * resp_mask,
            values * resp_mask,
            score_seg,
            bootstrap,
            gamma=self.discount,
            lam=self.gae_lambda,
        )
        adv = adv * resp_mask
        ret = ret * resp_mask
        kl_sum = ((rows["packed_logprobs"] - ref_logprobs) * resp_mask).sum()
        if self.adv_norm and not self.group_adv_norm:
            adv = masked_normalization(adv, resp_mask)
        return adv, ret, resp_mask, kl_sum

    def _prep_flat(self, engine, input_: SequenceSample, kl_coef: float):
        """``_prep`` on the whole batch, gathered back to the packed 1D
        layout of ``input_`` in one device fetch: (batch, advantages,
        returns, response mask, KL sum)."""
        batch, rows = engine._build_rows(input_)
        adv, ret, resp, kl_sum = self._prep(engine._device_rows(rows), kl_coef)
        R, T = adv.shape
        fetched = torch.cat(
            [adv.reshape(-1), ret.reshape(-1), resp.reshape(-1), kl_sum.reshape(1)]
        ).cpu().numpy()
        adv, ret, resp = (fetched[i * R * T:(i + 1) * R * T].reshape(R, T) for i in range(3))
        return (batch, batch.gather_flat(adv), batch.gather_flat(ret),
                batch.gather_flat(resp), float(fetched[-1]))

    def train_step(
        self, model: Model, input_: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict:
        engine = model.module
        kl_coef = self.kl_controller.value

        # 1) Whole-batch advantage computation on device.
        batch, adv_flat, ret_flat, resp_flat, kl_sum = self._prep_flat(
            engine, input_, kl_coef)

        # 2) Optional group normalization (GRPO): per prompt group over
        #    response positions.
        if self.adv_norm and self.group_adv_norm:
            adv_flat = adv_flat.copy()
            offset = 0
            for sl in input_.seqlens["packed_input_ids"]:
                glen = sum(sl)
                idx = np.arange(offset, offset + glen)[resp_flat[offset : offset + glen] > 0]
                if idx.size > 1:
                    vals = adv_flat[idx]
                    adv_flat[idx] = (vals - vals.mean()) / (vals.std() + 1e-5)
                offset += glen
        train_sample = input_
        train_sample.update_(
            SequenceSample(
                ids=list(input_.ids),
                keys={"advantages"},
                data={"advantages": adv_flat.astype(np.float32)},
                seqlens={
                    "advantages": [list(sl) for sl in input_.seqlens["packed_input_ids"]]
                },
            )
        )

        # 3) Minibatched PPO updates.
        mb_inputs, *_ = train_sample.split(MicroBatchSpec(n_mbs=self.n_minibatches))
        use_decoupled = self.use_decoupled_loss and "logprobs" in train_sample.keys

        def actor_loss(lp, rows):
            # `lp` is the fused next-token logprobs [R, T] computed by the
            # engine (logits never materialized).
            mask = response_scoring_mask(rows["segment_ids"], rows["prompt_mask"])
            loss_w = mask * rows["dp_loss_scale"] if "dp_loss_scale" in rows else mask
            loss_sum, st = F.actor_loss_fn(
                logprobs=lp,
                old_logprobs=rows["packed_logprobs"],
                advantages=rows["advantages"],
                eps_clip=self.eps_clip,
                loss_mask=loss_w,
                c_clip=self.c_clip,
                proximal_logprobs=rows["logprobs"] if use_decoupled else None,
                behav_imp_weight_cap=self.behav_imp_weight_cap if use_decoupled else None,
                stats_mask=mask,
            )
            # Approx KL(new || behavior) for monitoring.
            st["approx_kl"] = ((rows["packed_logprobs"] - lp) * mask).sum()
            st["abs_logprob_diff"] = ((rows["packed_logprobs"] - lp).abs() * mask).sum()
            return loss_sum, st

        all_stats = []
        for mb in mb_inputs:
            st = engine.train_batch(
                mb, MicroBatchSpec(n_mbs=1, max_tokens_per_mb=mb_spec.max_tokens_per_mb),
                loss_fn=actor_loss, loss_weight_fn=_n_response_tokens,
                token_normalize_scope=self.token_normalize_scope,
                version_steps=model.version, loss_name="ppo_actor",
            )
            all_stats.append(st)
        # Kept out of the aggregate, which holds the reference's keys.
        abs_diff = [st.pop("ppo_actor/abs_logprob_diff") for st in all_stats]
        model.inc_version()

        n_resp = float(np.sum(resp_flat))
        mean_kl = kl_sum / max(n_resp, 1.0)
        self.kl_controller.update(mean_kl, int(n_resp))

        agg = {k: float(np.mean([s[k] for s in all_stats])) for k in all_stats[0]}
        agg.update(
            {
                "ppo_actor/kl": mean_kl,
                "ppo_actor/kl_coef": kl_coef,
                "ppo_actor/adv_mean": float(
                    np.sum(adv_flat * resp_flat) / max(n_resp, 1.0)
                ),
                "ppo_actor/ret_mean": float(
                    np.sum(ret_flat * resp_flat) / max(n_resp, 1.0)
                ),
                "ppo_actor/reward_mean": float(np.mean(input_.data["rewards"]))
                if input_.data.get("rewards") is not None else 0.0,
                "ppo_actor/n_tokens": float(batch.total_tokens),
            }
        )
        # Staleness accounting.
        vs = input_.metadata.get("version_start")
        ve = input_.metadata.get("version_end")
        if vs:
            agg["ppo_actor/head_offpolicyness"] = float(model.version - 1 - np.min(vs))
            agg["ppo_actor/tail_offpolicyness"] = float(model.version - 1 - np.max(ve))
        stats_tracker.scalar(**agg)
        first = all_stats[0]
        stats_tracker.scalar(**{
            "ppo_actor_first_mb/importance_weight": first["ppo_actor/importance_weight"],
            "ppo_actor_first_mb/approx_kl": first["ppo_actor/approx_kl"],
            "ppo_actor_first_mb/abs_logprob_diff": abs_diff[0],
        })
        return agg

    def save(self, model: Model, save_dir: str):
        from areal_tpu_torch.interfaces.sft import SFTInterface

        SFTInterface.save(self, model, save_dir)  # the same HF export


def _n_response_tokens(mb: SequenceSample) -> float:
    pm = np.asarray(mb.data["prompt_mask"])
    total, offset = 0, 0
    for sl in mb.seqlens["prompt_mask"]:
        for l in sl:
            total += int(np.sum(pm[offset + 1 : offset + l] == 0))
            offset += l
    return float(total)


@dataclasses.dataclass
class PPOCriticInterface(ModelInterface):
    n_minibatches: int = 4
    token_normalize_scope: str = "global"
    value_eps_clip: float = 0.2
    kl_ctl: float = 0.1
    adaptive_kl_ctl: bool = False
    adaptive_kl_target: float = 6.0
    adaptive_kl_horizon: float = 10000.0
    discount: float = 1.0
    gae_lambda: float = 1.0
    max_reward_clip: float = 20.0
    reward_output_scaling: float = 1.0
    reward_output_bias: float = 0.0
    value_norm: bool = True
    mask_no_eos_with_zero: bool = False

    def __post_init__(self):
        self.rms = F.RunningMeanStd()
        # Mirrors the actor's controller so returns use the same (possibly
        # drifting) KL coefficient: both see the same per-step observed KL.
        if self.adaptive_kl_ctl:
            self.kl_controller = F.AdaptiveKLController(
                self.kl_ctl, self.adaptive_kl_target, self.adaptive_kl_horizon
            )
        else:
            self.kl_controller = F.FixedKLController(self.kl_ctl)
        # Returns must be computed with the same reward transform as the
        # actor's advantages.
        self._helper = PPOActorInterface(
            discount=self.discount, gae_lambda=self.gae_lambda,
            kl_ctl=self.kl_ctl, max_reward_clip=self.max_reward_clip,
            reward_output_scaling=self.reward_output_scaling,
            reward_output_bias=self.reward_output_bias,
            adv_norm=False, mask_no_eos_with_zero=self.mask_no_eos_with_zero,
        )

    def inference(
        self, model: Model, input_: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        out = model.module.forward(input_, mb_spec, output_key="values", output="values")
        if self.value_norm:
            out.data["values"] = self.rms.denormalize(out.data["values"])
        return out

    def train_step(
        self, model: Model, input_: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict:
        engine = model.module
        # Returns are recomputed exactly like the actor does.
        _, _, ret_flat, resp_flat, kl_sum = self._helper._prep_flat(
            engine, input_, self.kl_controller.value)
        if self.value_norm:
            self.rms.update(ret_flat, mask=resp_flat > 0)
            norm_ret = np.where(resp_flat > 0, self.rms.normalize(ret_flat), 0.0)
            old_values = np.where(
                resp_flat > 0,
                self.rms.normalize(np.asarray(input_.data["values"])),
                0.0,
            )
        else:
            norm_ret = ret_flat
            old_values = np.asarray(input_.data["values"])

        sl = [list(s) for s in input_.seqlens["packed_input_ids"]]
        input_.update_(
            SequenceSample(
                ids=list(input_.ids), keys={"returns", "old_values_norm"},
                data={
                    "returns": norm_ret.astype(np.float32),
                    "old_values_norm": old_values.astype(np.float32),
                },
                seqlens={"returns": sl, "old_values_norm": sl},
            )
        )

        def critic_loss(values, rows):
            mask = response_scoring_mask(rows["segment_ids"], rows["prompt_mask"])
            loss_w = mask * rows["dp_loss_scale"] if "dp_loss_scale" in rows else mask
            return F.critic_loss_fn(
                value=values,
                old_value=rows["old_values_norm"],
                target_value=rows["returns"],
                value_eps_clip=self.value_eps_clip,
                loss_mask=loss_w,
                stats_mask=mask,
            )

        mb_inputs, *_ = input_.split(MicroBatchSpec(n_mbs=self.n_minibatches))
        all_stats = []
        for mb in mb_inputs:
            st = engine.train_batch(
                mb, MicroBatchSpec(n_mbs=1, max_tokens_per_mb=mb_spec.max_tokens_per_mb),
                loss_fn=critic_loss, loss_weight_fn=_n_response_tokens,
                token_normalize_scope=self.token_normalize_scope,
                version_steps=model.version, loss_name="ppo_critic",
            )
            all_stats.append(st)
        model.inc_version()
        n_resp = float(np.sum(resp_flat))
        self.kl_controller.update(kl_sum / max(n_resp, 1.0), int(n_resp))
        agg = {k: float(np.mean([s[k] for s in all_stats])) for k in all_stats[0]}
        stats_tracker.scalar(**agg)
        return agg


register_interface("ppo_actor", PPOActorInterface)
register_interface("ppo_critic", PPOCriticInterface)
