"""Parameter schedules (a copy of ``ray_tpu/rllib/utils/schedules.py``;
reference: rllib/utils/schedules/ — Constant, Linear, Piecewise,
Exponential)."""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple


class Schedule:
    def value(self, t: int) -> float:
        raise NotImplementedError

    def __call__(self, t: int) -> float:
        return self.value(t)


class ConstantSchedule(Schedule):
    def __init__(self, value: float):
        self._v = value

    def value(self, t: int) -> float:
        return self._v


class LinearSchedule(Schedule):
    def __init__(self, schedule_timesteps: int, initial_p: float = 1.0,
                 final_p: float = 0.0):
        self.T = schedule_timesteps
        self.initial = initial_p
        self.final = final_p

    def value(self, t: int) -> float:
        frac = min(max(t, 0) / self.T, 1.0)
        return self.initial + frac * (self.final - self.initial)


class ExponentialSchedule(Schedule):
    def __init__(self, schedule_timesteps: int, initial_p: float = 1.0,
                 decay_rate: float = 0.1):
        self.T = schedule_timesteps
        self.initial = initial_p
        self.decay = decay_rate

    def value(self, t: int) -> float:
        return self.initial * self.decay ** (t / self.T)


class PiecewiseSchedule(Schedule):
    def __init__(self, endpoints: Sequence[Tuple[int, float]],
                 outside_value: float = None):
        self.endpoints = sorted(endpoints)
        self.outside_value = outside_value

    def value(self, t: int) -> float:
        for (l, lv), (r, rv) in zip(self.endpoints, self.endpoints[1:]):
            if l <= t < r:
                alpha = (t - l) / (r - l)
                return lv + alpha * (rv - lv)
        if t < self.endpoints[0][0] or self.outside_value is None:
            if t >= self.endpoints[-1][0]:
                return self.endpoints[-1][1]
            return self.endpoints[0][1]
        return self.outside_value
