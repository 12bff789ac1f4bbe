"""Frequency controllers and a stopwatch (the port's copy of
``areal_tpu/base/timeutil.py``).

``FrequencyControl`` gates periodic actions (save, evaluate, checkpoint)
by step count, epoch count and/or wall seconds; its ``state_dict`` is
plain data, so it can ride a recover record.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class FrequencyControl:
    """``check()`` returns True when any configured frequency elapses.

    frequency_epoch: every N epochs (the ``epochs`` argument).
    frequency_step: every N steps (the ``steps`` argument).
    frequency_sec: when this many wall seconds passed since the last hit.
    initial_value: whether the very first check hits.
    """

    frequency_epoch: Optional[int] = None
    frequency_step: Optional[int] = None
    frequency_sec: Optional[float] = None
    initial_value: bool = False

    def __post_init__(self):
        self._last_time = time.monotonic()
        self._steps = 0
        self._epochs = 0
        self._first = True
        self._total_steps = 0

    def check(self, steps: int = 1, epochs: int = 0) -> bool:
        self._steps += steps
        self._epochs += epochs
        self._total_steps += steps
        if self._first:
            self._first = False
            if self.initial_value:
                self._reset()
                return True
        hit = False
        if self.frequency_step is not None and self._steps >= self.frequency_step:
            hit = True
        if self.frequency_epoch is not None and self._epochs >= self.frequency_epoch:
            hit = True
        if (
            self.frequency_sec is not None
            and time.monotonic() - self._last_time >= self.frequency_sec
        ):
            hit = True
        if hit:
            self._reset()
        return hit

    def _reset(self):
        self._steps = 0
        self._epochs = 0
        self._last_time = time.monotonic()

    def state_dict(self):
        return dict(
            steps=self._steps,
            epochs=self._epochs,
            total_steps=self._total_steps,
            first=self._first,
        )

    def load_state_dict(self, state):
        self._steps = state["steps"]
        self._epochs = state["epochs"]
        self._total_steps = state["total_steps"]
        self._first = state["first"]
        self._last_time = time.monotonic()


class Timer:
    """Stopwatch accumulating named durations; ``scope(name)`` is a
    context manager."""

    def __init__(self):
        self.totals = {}
        self._starts = {}

    def start(self, name: str):
        self._starts[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        dt = time.perf_counter() - self._starts.pop(name)
        self.totals[name] = self.totals.get(name, 0.0) + dt
        return dt

    class _Scope:
        def __init__(self, timer, name):
            self.timer, self.name = timer, name

        def __enter__(self):
            self.timer.start(self.name)
            return self

        def __exit__(self, *exc):
            self.timer.stop(self.name)

    def scope(self, name: str) -> "Timer._Scope":
        return Timer._Scope(self, name)
