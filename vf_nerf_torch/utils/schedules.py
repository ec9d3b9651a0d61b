"""Standalone learning-rate schedules (port of
``vf_nerf_tpu/utils/schedules.py``; reference
``utils/learning_rate_scheduler.py:7-122``). The training step uses the
facade's per-step exponential decay (``models/nerf.py``); these are the
reference's utilities. ``as_schedule()`` is each one as a function of the
step count, computed in float32 as the JAX package's ``as_optax()``
schedules compute it."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Union

import numpy as np

StateDict = Dict[str, Union[float, int]]


def _f32_decay(lr: float, rate: float, exponent) -> float:
    """``lr · rate^exponent`` in float32."""
    return float(np.float32(lr) * np.power(np.float32(rate),
                                           np.float32(exponent)))


@dataclass
class ConstantLearningRateSchedule:
    """Reference ``:41-63``."""

    learning_rate: float

    def get_learning_rate(self, epoch: int) -> float:
        return self.learning_rate

    def load_state_dict(self, state: StateDict) -> None:
        self.learning_rate = state["learning_rate"]

    def as_schedule(self) -> Callable[[int], float]:
        return lambda count: float(np.float32(self.learning_rate))


@dataclass
class StepLearningRateSchedule:
    """Reference ``:66-97``: lr · decay^(epoch // frequency)."""

    learning_rate: float
    frequency: int
    decay_rate: float

    def get_learning_rate(self, epoch: int) -> float:
        return self.learning_rate * (self.decay_rate **
                                     (epoch // self.frequency))

    def load_state_dict(self, state: StateDict) -> None:
        self.learning_rate = state["learning_rate"]
        self.frequency = state["frequency"]
        self.decay_rate = state["decay_rate"]

    def as_schedule(self) -> Callable[[int], float]:
        """optax ``exponential_decay(staircase=True)``."""
        return lambda count: _f32_decay(self.learning_rate, self.decay_rate,
                                        count // self.frequency)


@dataclass
class ExponentialRateSchedule:
    """Reference ``:100-122``: lr · decay^epoch."""

    learning_rate: float
    decay_rate: float

    def get_learning_rate(self, epoch: int) -> float:
        return self.learning_rate * (self.decay_rate ** epoch)

    def load_state_dict(self, state: StateDict) -> None:
        self.learning_rate = state["learning_rate"]
        self.decay_rate = state["decay_rate"]

    def as_schedule(self) -> Callable[[int], float]:
        """optax ``exponential_decay(transition_steps=1)``."""
        return lambda count: _f32_decay(self.learning_rate, self.decay_rate,
                                        count)
