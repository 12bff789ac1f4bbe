"""Paired pos/neg answer dataset for reward modelling (the port's copy of
``areal_tpu/datasets/rw_paired.py``, registered as "rw_pair").

jsonl rows need "prompt", "pos_answers", "neg_answers" (equal-length lists).
Each item packs up to `max_pairs_per_prompt` (pos, neg) sequence pairs:
`packed_input_ids` holds the 2*group_size sequences back to back (each
prompt+answer), `group_factor` weighs the pairwise loss, `prompt_lens`
records the shared prompt length.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from areal_tpu_torch.api import data_api
from areal_tpu_torch.base import logging

logger = logging.getLogger("rw_paired_dataset")


class RewardModelingPairedDataset:
    def __init__(
        self,
        util: data_api.DatasetUtility,
        max_length: int,
        max_pairs_per_prompt: int = 2,
        dataset_path: Optional[str] = None,
        dataset_builder: Optional[Callable[[], List[Dict]]] = None,
    ):
        self.util = util
        tok = util.tokenizer
        data = data_api.load_shuffle_split_dataset(util, dataset_path, dataset_builder)
        self.max_pairs_per_prompt = max_pairs_per_prompt
        self.ids = [str(x["id"]) for x in data]
        # Pair selection must be a pure function of (seed, dp_rank, idx):
        # a shared stateful RNG would make re-reads and checkpoint-recovery
        # replays return different pairs.
        self._seed_base = (util.seed * 1_000_003 + util.dp_rank) % (2**31 - 1)

        eos = tok.eos_token or ""
        self.prompt_lens: List[int] = []
        self.pos_tokens: List[List[List[int]]] = []
        self.neg_tokens: List[List[List[int]]] = []
        for x in data:
            assert len(x["pos_answers"]) == len(x["neg_answers"]) > 0, x["id"]
            ptoks = tok(x["prompt"], truncation=True, max_length=max_length)["input_ids"]
            self.prompt_lens.append(len(ptoks))
            enc = lambda ans: tok(
                x["prompt"] + ans + eos, truncation=True, max_length=max_length
            )["input_ids"]
            self.pos_tokens.append([enc(a) for a in x["pos_answers"]])
            self.neg_tokens.append([enc(a) for a in x["neg_answers"]])
        logger.info(f"RewardModelingPairedDataset: {len(self.ids)} prompts")

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx: int) -> data_api.SequenceSample:
        n_pairs = len(self.pos_tokens[idx])
        group_size = min(self.max_pairs_per_prompt, n_pairs)
        rng = np.random.RandomState((self._seed_base + idx * 9973) % (2**31 - 1))
        pair_idx = rng.choice(n_pairs, group_size, replace=False)

        seqs: List[int] = []
        input_lens: List[int] = []
        for i in pair_idx:
            for toks in (self.pos_tokens[idx][i], self.neg_tokens[idx][i]):
                seqs.extend(toks)
                input_lens.append(len(toks))

        return data_api.SequenceSample(
            ids=[self.ids[idx]],
            keys={"packed_input_ids", "group_factor", "prompt_lens"},
            data=dict(
                packed_input_ids=np.asarray(seqs, dtype=np.int32),
                group_factor=np.full((1,), 1.0 / group_size, dtype=np.float32),
                prompt_lens=np.asarray([self.prompt_lens[idx]], dtype=np.int32),
            ),
            seqlens={
                "packed_input_ids": [input_lens],
                "group_factor": [[1]],
                "prompt_lens": [[1]],
            },
        )


data_api.register_dataset("rw_pair", RewardModelingPairedDataset)
