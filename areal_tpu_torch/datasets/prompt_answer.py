"""Prompt+answer dataset for SFT (the port's copy of
``areal_tpu/datasets/prompt_answer.py``).

jsonl rows need "prompt" and "answer". Each sample holds
``packed_input_ids`` (BOS + prompt + answer + EOS, cut to ``max_length``)
and a boolean ``prompt_mask``, True over the prompt tokens (the SFT loss
masks them out).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from areal_tpu_torch.api import data_api
from areal_tpu_torch.base import logging

logger = logging.getLogger("prompt_answer_dataset")


class PromptAnswerDataset:
    def __init__(
        self,
        util: data_api.DatasetUtility,
        max_length: int,
        dataset_path: Optional[str] = None,
        dataset_builder: Optional[Callable[[], List[Dict]]] = None,
    ):
        self.util = util
        tok = util.tokenizer
        data = data_api.load_shuffle_split_dataset(util, dataset_path, dataset_builder)
        self.ids = [str(x["id"]) for x in data]
        # Prompt and answer are tokenized apart, so the prompt's span is a
        # prefix of the sequence by construction (a joint tokenization can
        # merge tokens across the boundary). No special tokens on either
        # half: a tokenizer that appends a suffix token would plant it
        # between prompt and answer. BOS is added back by hand.
        enc = dict(truncation=True, max_length=max_length, padding=False,
                   return_attention_mask=False, add_special_tokens=False)
        prompt_enc = tok([x["prompt"] for x in data], **enc)
        answer_enc = tok([x["answer"] for x in data], **enc)
        bos_ids = [tok.bos_token_id] if tok.bos_token_id is not None else []
        eos_ids = [tok.eos_token_id] if tok.eos_token_id is not None else []
        self.tokens: List[List[int]] = []
        self.prompt_masks: List[np.ndarray] = []
        for prompt_ids, answer_ids in zip(prompt_enc["input_ids"], answer_enc["input_ids"]):
            prompt_ids = bos_ids + prompt_ids
            seq_ids = (prompt_ids + answer_ids + eos_ids)[:max_length]
            plen = min(len(prompt_ids), len(seq_ids))
            mask = np.zeros(len(seq_ids), dtype=bool)
            mask[:plen] = True
            self.tokens.append(seq_ids)
            self.prompt_masks.append(mask)
        lens = [len(t) for t in self.tokens]
        plens = [int(m.sum()) for m in self.prompt_masks]
        logger.info(
            f"PromptAnswerDataset: #seqs={len(self.tokens)}, "
            f"avg prompt len={np.mean(plens):.1f}, "
            f"avg answer len={np.mean(lens) - np.mean(plens):.1f}"
        )

    def __len__(self):
        return len(self.tokens)

    def __getitem__(self, idx: int) -> data_api.SequenceSample:
        toks = np.asarray(self.tokens[idx], dtype=np.int32)
        return data_api.SequenceSample.from_default(
            ids=[self.ids[idx]],
            seqlens=[len(toks)],
            data=dict(packed_input_ids=toks, prompt_mask=self.prompt_masks[idx]),
        )


data_api.register_dataset("prompt_answer", PromptAnswerDataset)
