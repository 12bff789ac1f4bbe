"""SFT algorithm interface (counterpart of ``areal_tpu/interfaces/sft.py``):
the train step, the response-token loss over an eval loader's batches,
and the HF-format save."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import Model, ModelInterface, register_interface
from areal_tpu_torch.base import stats_tracker


def sft_row_loss(lp, rows):
    """Next-token CE over response tokens (prompt_mask == 1 marks prompts).

    `lp` is the engine-supplied fused next-token logprobs [R, T]."""
    seg = rows["segment_ids"]
    pm = rows["prompt_mask"]
    next_seg = torch.cat([seg[:, 1:], torch.zeros_like(seg[:, :1])], dim=1)
    next_pm = torch.cat([pm[:, 1:], torch.ones_like(pm[:, :1])], dim=1)
    mask = ((next_seg == seg) & (seg > 0) & (next_pm == 0)).float()
    n_tokens = mask.sum()
    if "dp_loss_scale" in rows:
        mask = mask * rows["dp_loss_scale"]
    return -(lp * mask).sum(), {"n_response_tokens": n_tokens}


def sft_loss_weight(mb: SequenceSample) -> float:
    """Number of loss (response) tokens in a micro-batch."""
    pm = np.asarray(mb.data["prompt_mask"])
    total = 0
    offset = 0
    for sl in mb.seqlens["prompt_mask"]:
        for l in sl:
            # mask[t] = next token is response (the loss's shifted frame)
            total += int(np.sum(pm[offset + 1 : offset + l] == 0))
            offset += l
    return float(total)


@dataclasses.dataclass
class SFTInterface(ModelInterface):
    token_normalize_scope: str = "global"

    def train_step(
        self, model: Model, input_: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict:
        stats = model.module.train_batch(
            input_,
            mb_spec,
            loss_fn=sft_row_loss,
            loss_weight_fn=sft_loss_weight,
            token_normalize_scope=self.token_normalize_scope,
            version_steps=model.version,
            loss_name="sft",
        )
        model.inc_version()
        stats_tracker.scalar(**stats)
        return stats

    def evaluate(self, model: Model, eval_dataloader) -> Dict:
        """Mean next-token loss over the response tokens of every batch
        that ``eval_dataloader`` yields, and their count."""
        engine = model.module
        total_loss, total_tokens = 0.0, 0.0
        for batch in eval_dataloader:
            out = engine.forward(batch, MicroBatchSpec(), output_key="logprobs")
            pm = np.asarray(batch.data["prompt_mask"]).astype(bool)
            lp = np.asarray(out.data["logprobs"])
            # Shifted frame: position t scores token t+1.
            offset = 0
            for sl in batch.seqlens["prompt_mask"]:
                for l in sl:
                    resp_next = ~pm[offset + 1 : offset + l]
                    total_loss += float(-np.sum(lp[offset : offset + l - 1][resp_next]))
                    total_tokens += float(resp_next.sum())
                    offset += l
        return {
            "eval_loss": total_loss / max(total_tokens, 1.0),
            "eval_n_tokens": total_tokens,
        }

    def save(self, model: Model, save_dir: str):
        """The model as an HF checkpoint directory, with its tokenizer."""
        from areal_tpu_torch.models.hf import save_hf_model

        engine = model.module
        family = getattr(engine, "hf_family", None)
        if family is None:
            raise ValueError(
                "engine has no hf_family set; pass hf_family= when building "
                "the TorchTrainEngine so save() knows which HF weight mapping "
                "to use (silently guessing would corrupt the checkpoint)"
            )
        save_hf_model(save_dir, engine.model_cfg, engine.get_params(), family,
                      tokenizer=model.tokenizer)


register_interface("sft", SFTInterface)
