"""Curriculum eval-score store: per-prompt success rates -> dataset filter
(the port's copy of ``areal_tpu/system/eval_scores.py``).

Rollout workers (and a model worker whose MFC output carries per-prompt
``scores``) merge their local {id: score} slice into one shared JSON file
under an fcntl lock; at each epoch boundary the dataset-hosting worker
feeds the merged scores to ``dataset.filter`` and snapshots the
surviving ``active_indices`` so a restart resumes the same curriculum.
"""

from __future__ import annotations

import fcntl
import json
import os
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np

from areal_tpu_torch.base import constants, logging

logger = logging.getLogger("eval_scores")

_SCORES_FILE = "dataset_eval_scores.json"
_INDICES_DIR = "dataset_indices"


def scores_path(experiment_name: str, trial_name: str) -> str:
    return os.path.join(
        constants.get_save_path(experiment_name, trial_name), _SCORES_FILE
    )


@contextmanager
def _locked(path: str):
    lock = path + ".lock"
    with open(lock, "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)


def merge_scores(
    experiment_name: str, trial_name: str, scores: Dict[str, float]
) -> None:
    """Merge a local {sample_id: score} slice into the shared file
    (read-modify-write + atomic rename under an exclusive lock)."""
    if not scores:
        return
    path = scores_path(experiment_name, trial_name)
    with _locked(path):
        merged: Dict[str, float] = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    merged = json.load(f)
            except (json.JSONDecodeError, OSError):
                logger.warning(f"corrupt {path}; rebuilding from this slice")
        merged.update({str(k): float(v) for k, v in scores.items()})
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(merged, f)
        os.replace(tmp, path)


def load_scores(
    experiment_name: str, trial_name: str
) -> Optional[Dict[str, float]]:
    path = scores_path(experiment_name, trial_name)
    if not os.path.exists(path):
        return None
    with _locked(path):
        try:
            with open(path) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            return None


def _indices_path(experiment_name: str, trial_name: str, tag: str) -> str:
    d = os.path.join(
        constants.get_save_path(experiment_name, trial_name), _INDICES_DIR
    )
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{tag}.npy")


def apply_filter(
    dataset, experiment_name: str, trial_name: str, tag: str,
    min_size: int = 0,
) -> bool:
    """Epoch-boundary curriculum step: feed the merged scores to
    `dataset.filter` and snapshot the surviving indices so a recovery
    restart resumes with the same curriculum state. Returns whether the
    filter ran (it doesn't when no scores have been recorded yet).

    `min_size` floors the curriculum: once the active set is at (or one
    filter call could take it below) the per-rank fetch batch size, the
    batch assembler could never fill a training batch again and the
    master would livelock fetching — so the caller passes its batch size
    and filtering stops there."""
    if not hasattr(dataset, "filter"):
        return False
    if min_size and len(dataset) <= min_size:
        logger.info(
            f"curriculum filter skipped ({tag}): active set {len(dataset)} "
            f"already at floor {min_size}"
        )
        return False
    scores = load_scores(experiment_name, trial_name)
    if not scores:
        return False
    n = len(dataset)
    if min_size and hasattr(dataset, "max_filter_percentage"):
        # Clamp this call's drop budget so the active set can't fall
        # through the floor (filter removes at most int(n * pct)).
        orig = dataset.max_filter_percentage
        dataset.max_filter_percentage = min(orig, (n - min_size) / n)
        try:
            dataset.filter(scores)
        finally:
            dataset.max_filter_percentage = orig
    else:
        dataset.filter(scores)
    np.save(
        _indices_path(experiment_name, trial_name, tag),
        np.asarray(dataset.active_indices, dtype=np.int64),
    )
    return True


def restore_indices(
    dataset, experiment_name: str, trial_name: str, tag: str
) -> bool:
    """Recovery: reload the filtered-index snapshot taken by apply_filter
    (reference model_worker.py:368-385 / rollout_worker.py:122-134)."""
    if not hasattr(dataset, "filter"):
        return False
    path = _indices_path(experiment_name, trial_name, tag)
    if not os.path.exists(path):
        return False
    indices: List[int] = np.load(path).tolist()
    logger.info(
        f"restoring curriculum indices ({tag}): "
        f"{len(dataset.active_indices)} -> {len(indices)}"
    )
    dataset.active_indices = indices
    return True
