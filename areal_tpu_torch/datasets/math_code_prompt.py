"""Math/code RL prompt dataset with curriculum filtering (the port's copy
of ``areal_tpu/datasets/math_code_prompt.py``).

jsonl rows need "prompt", "query_id", "task" in {math, stem, code} (a
missing task defaults to math); math rows carry "solutions" (reference
answers), code rows "input_output" (JSON test cases). Invalid rows are
skipped with a warning. Each sample holds `packed_prompts` and `task_ids`
(an index into data_api.RL_TASKS), optional `base_scores`, and the
verifier's inputs in its metadata. `filter(eval_scores)` drops at most
`max_filter_percentage` of the active prompts whose score exceeds
`filter_threshold`, highest first.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import numpy as np

from areal_tpu_torch.api import data_api
from areal_tpu_torch.base import logging

logger = logging.getLogger("math_code_dataset")


def _validate_math(d: Dict) -> Dict:
    assert d["task"] in ("math", "stem")
    d["query_id"] = str(d["query_id"])
    assert isinstance(d["prompt"], str)
    assert isinstance(d["solutions"], list)
    assert all(isinstance(s, str) for s in d["solutions"])
    return d


def _validate_code(d: Dict) -> Dict:
    assert d["task"] == "code"
    d["query_id"] = str(d["query_id"])
    d.setdefault("problem_id", d["query_id"])
    assert isinstance(d["prompt"], str)
    io = json.loads(d["input_output"]) if isinstance(d["input_output"], str) else d["input_output"]
    assert len(io["inputs"]) == len(io["outputs"])
    return d


def load_metadata(path: str) -> Tuple[Dict[str, Dict], Dict[str, int]]:
    """id->row mapping for reward verification, with per-task counts."""
    assert str(path).endswith(".jsonl"), path
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    id2info: Dict[str, Dict] = {}
    task_cnt: Dict[str, int] = defaultdict(int)
    omit = defaultdict(int)
    for d in rows:
        d.setdefault("task", "math")
        try:
            d = _validate_code(d) if d["task"] == "code" else _validate_math(d)
        except Exception:
            omit[d["task"]] += 1
            continue
        id2info[d["query_id"]] = d
        task_cnt[d["task"]] += 1
    if omit:
        logger.warning(f"math_code dataset: ignored invalid rows {dict(omit)}")
    return id2info, dict(task_cnt)


class MATHCodePromptDataset:
    def __init__(
        self,
        util: data_api.DatasetUtility,
        max_length: Optional[int] = None,
        dataset_path: Optional[str] = None,
        dataset_builder: Optional[Callable[[], List[Dict]]] = None,
        filter_threshold: float = 1e4,
        max_filter_percentage: float = 0.0,
    ):
        self.util = util
        # Read + validate the FULL dataset once, then split: every rank must
        # agree on the kept row set and on whether base_scores exist (a
        # per-slice decision would give ranks inconsistent key sets).
        if dataset_path is not None:
            assert str(dataset_path).endswith(".jsonl"), dataset_path
            with open(dataset_path) as f:
                rows = [json.loads(line) for line in f if line.strip()]
        else:
            rows = dataset_builder()
        valid = []
        omit: Dict[str, int] = defaultdict(int)
        for d in rows:
            d.setdefault("task", "math")
            try:
                valid.append(
                    _validate_code(d) if d["task"] == "code" else _validate_math(d)
                )
            except Exception:
                omit[d["task"]] += 1
        if omit:
            logger.warning(f"math_code dataset: ignored invalid rows {dict(omit)}")
        has_base_scores = bool(valid) and all("scores" in d for d in valid)
        data = data_api.load_shuffle_split_dataset(util, None, lambda: valid)

        enc = util.tokenizer(
            [x["prompt"] for x in data],
            truncation=False,
            padding=False,
            return_attention_mask=False,
        )
        keep = [
            i
            for i, ids in enumerate(enc["input_ids"])
            if max_length is None or len(ids) <= max_length
        ]
        self.prompts: List[List[int]] = [enc["input_ids"][i] for i in keep]
        self.prompt_lengths = [len(p) for p in self.prompts]
        # Unique per-(row, dp_rank) ids, as in the reference (:138-140).
        self.ids = [
            f"{data[i]['query_id']}@idx:{i}-{util.dp_rank}" for i in keep
        ]
        self.task_ids = [data_api.RL_TASKS.index(data[i].get("task", "math")) for i in keep]
        self.tasks = [data[i]["task"] for i in keep]
        self.query_ids = [data[i]["query_id"] for i in keep]
        # What the reward verifier needs per prompt: reference answers for
        # math, testcases for code (reference keeps a global id2info instead;
        # carrying it in sample metadata keeps the reward worker stateless).
        self.answer_infos = [
            data[i]["input_output"] if data[i]["task"] == "code" else data[i]["solutions"]
            for i in keep
        ]
        self.base_scores = (
            [float(np.mean(data[i]["scores"])) for i in keep]
            if has_base_scores
            else None
        )
        self.active_indices = list(range(len(self.prompts)))
        self.filter_threshold = filter_threshold
        self.max_filter_percentage = max_filter_percentage
        logger.info(
            f"MATHCodePromptDataset: {len(self.prompts)} prompts (dp={util.dp_rank})"
        )

    def __len__(self):
        return len(self.active_indices)

    def __getitem__(self, idx: int) -> data_api.SequenceSample:
        idx = self.active_indices[idx]
        d = dict(
            packed_prompts=np.asarray(self.prompts[idx], dtype=np.int32),
            task_ids=np.asarray([self.task_ids[idx]], dtype=np.int64),
        )
        if self.base_scores is not None:
            d["base_scores"] = np.asarray([self.base_scores[idx]], dtype=np.float32)
        return data_api.SequenceSample.from_default(
            ids=[self.ids[idx]],
            seqlens=[self.prompt_lengths[idx]],
            data=d,
            metadata=dict(
                tasks=[self.tasks[idx]],
                solutions=[self.answer_infos[idx]],
                query_ids=[self.query_ids[idx]],
            ),
        )

    def filter(self, eval_scores: Dict[Hashable, float]):
        """Curriculum filter: drop up to max_filter_percentage of active
        prompts whose eval score exceeds filter_threshold (highest first)."""
        removable = {}
        for pos, idx in enumerate(self.active_indices):
            score = eval_scores.get(self.ids[idx])
            if score is not None and score > self.filter_threshold:
                removable[pos] = score
        n = int(len(self.active_indices) * self.max_filter_percentage)
        to_remove = sorted(removable, key=removable.__getitem__, reverse=True)[:n]
        for pos in sorted(to_remove, reverse=True):
            self.active_indices.pop(pos)
        logger.info(
            f"math_code filter: removed {len(to_remove)}, "
            f"{len(self.active_indices)} remain"
        )


data_api.register_dataset("math_code_prompt", MATHCodePromptDataset)
