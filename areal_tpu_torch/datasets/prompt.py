"""Plain prompt dataset for RL (the port's copy of
``areal_tpu/datasets/prompt.py``, registered as "prompt").

jsonl rows need a "prompt" key and an optional "id"; each sample holds
the tokenized prompt as ``packed_prompts``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from areal_tpu_torch.api import data_api
from areal_tpu_torch.base import logging

logger = logging.getLogger("prompt_dataset")


class PromptDataset:
    def __init__(
        self,
        util: data_api.DatasetUtility,
        max_length: Optional[int] = None,
        dataset_path: Optional[str] = None,
        dataset_builder: Optional[Callable[[], List[Dict]]] = None,
    ):
        self.util = util
        data = data_api.load_shuffle_split_dataset(util, dataset_path, dataset_builder)
        enc = util.tokenizer(
            [x["prompt"] for x in data],
            truncation=max_length is not None,
            max_length=max_length,
            padding=False,
            return_length=True,
            return_attention_mask=False,
        )
        self.ids = [str(x["id"]) for x in data]
        self.prompts: List[List[int]] = enc["input_ids"]
        self.prompt_lengths = [len(p) for p in self.prompts]
        logger.info(f"PromptDataset: {len(self.prompts)} prompts (dp={util.dp_rank})")

    def __len__(self):
        return len(self.prompts)

    def __getitem__(self, idx: int) -> data_api.SequenceSample:
        return data_api.SequenceSample.from_default(
            ids=[self.ids[idx]],
            seqlens=[self.prompt_lengths[idx]],
            data=dict(packed_prompts=np.asarray(self.prompts[idx], dtype=np.int32)),
        )


data_api.register_dataset("prompt", PromptDataset)
