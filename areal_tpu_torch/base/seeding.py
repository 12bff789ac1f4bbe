"""Deterministic per-key seeding (the port's copy of
``areal_tpu/base/seeding.py``): one experiment-level base seed plus a
stable per-key offset. It seeds Python's ``random``, numpy and torch;
the reference's ``prng_key`` (a JAX key) has no counterpart here."""

from __future__ import annotations

import hashlib
import random

import numpy as np
import torch


def _hash_key(key: str) -> int:
    return int(hashlib.sha256(key.encode()).hexdigest(), 16) % (2**31)


def set_random_seed(base_seed: int, key: str):
    """Seed python, numpy and torch for this process from (seed, key)."""
    seed = base_seed + _hash_key(key)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)

