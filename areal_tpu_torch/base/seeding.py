"""Deterministic per-key seeding (the port's copy of
``areal_tpu/base/seeding.py``): one experiment-level base seed plus a
stable per-key offset. It seeds Python's ``random``, numpy and torch,
and snapshots the Python and numpy generators for a checkpoint
(``state_dict`` / ``load_state``, the reference's layout, so either
package restores the other's); the reference's ``prng_key`` (a JAX key)
has no counterpart here."""

from __future__ import annotations

import hashlib
import random

import numpy as np
import torch


def _hash_key(key: str) -> int:
    return int(hashlib.sha256(key.encode()).hexdigest(), 16) % (2**31)


_BASE_SEED = 0
_SEED_FROM = "default"


def set_random_seed(base_seed: int, key: str):
    """Seed python, numpy and torch for this process from (seed, key)."""
    global _BASE_SEED, _SEED_FROM
    _BASE_SEED = base_seed
    _SEED_FROM = key
    seed = base_seed + _hash_key(key)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)



def get_seed() -> int:
    return _BASE_SEED


def get_shuffle_seed(key: str = "shuffle") -> int:
    return (_BASE_SEED + _hash_key(f"{_SEED_FROM}/{key}")) % (2**31)


def state_dict() -> dict:
    """This process's host generator state for a checkpoint: the (base
    seed, key) identity and the live Python and numpy generator states."""
    return {
        "base_seed": _BASE_SEED,
        "seed_from": _SEED_FROM,
        "python_random": random.getstate(),
        "numpy_random": np.random.get_state(),
    }


def load_state(state: dict):
    """Restore a ``state_dict()`` snapshot."""
    global _BASE_SEED, _SEED_FROM
    _BASE_SEED = int(state["base_seed"])
    _SEED_FROM = state["seed_from"]
    random.setstate(state["python_random"])
    np.random.set_state(state["numpy_random"])
