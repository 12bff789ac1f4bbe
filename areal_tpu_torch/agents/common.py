"""Shared trajectory assembly for rollout agents (the port's copy of
``areal_tpu/agents/common.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from areal_tpu_torch.api.data_api import SequenceSample
from areal_tpu_torch.api.model_api import BundledGenerationOutputs


def bundle_to_sample(
    qid: str, bundle: BundledGenerationOutputs, rewards: np.ndarray,
    score: float, task: Optional[str] = None,
) -> SequenceSample:
    """Assemble one grouped trajectory SequenceSample from a generation
    bundle (the packed-keys layout every RL interface consumes; logprobs
    in the PPO shifted frame — the generated token at abs position p is
    scored at p-1)."""
    n = len(bundle.seqs)
    seq_lens = [len(s) for s in bundle.seqs]
    plen = bundle.prompt_len
    pmask = np.concatenate(
        [
            np.concatenate(
                [np.ones(plen, np.int64), np.zeros(l - plen, np.int64)]
            )
            for l in seq_lens
        ]
    )
    shifted_lps = []
    for seq, lp in zip(bundle.seqs, bundle.logprobs):
        out_lp = np.asarray(lp[plen:], np.float32)
        full = np.zeros(len(seq), np.float32)
        full[plen - 1 : len(seq) - 1] = out_lp
        shifted_lps.append(full)
    return SequenceSample(
        ids=[qid],
        keys={
            "packed_input_ids", "prompt_mask", "packed_logprobs",
            "seq_no_eos_mask", "rewards",
        },
        data={
            "packed_input_ids": np.concatenate(
                [np.asarray(s, np.int32) for s in bundle.seqs]
            ),
            "prompt_mask": pmask,
            "packed_logprobs": np.concatenate(shifted_lps),
            "seq_no_eos_mask": np.asarray(
                [1.0 if x else 0.0 for x in bundle.no_eos], np.float32
            ),
            "rewards": rewards,
        },
        seqlens={
            "packed_input_ids": [seq_lens],
            "prompt_mask": [seq_lens],
            "packed_logprobs": [seq_lens],
            "seq_no_eos_mask": [[1] * n],
            "rewards": [[1] * n],
        },
        metadata={
            "version_start": [min(bundle.version_start)],
            "version_end": [max(bundle.version_end)],
            "scores": [score],
            "birth_time": [0],
            # Per-task staleness tag (buffer admission windows +
            # per-task master scalars); None -> untagged, global gate
            # only.
            **({"task": [task]} if task is not None else {}),
        },
    )
