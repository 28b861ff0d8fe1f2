"""Connectors: typed, serializable obs/action preprocessing pipelines.

Reference: rllib/connectors/connector.py:83,141 (Connector/AgentConnector
with to_state/from_state for checkpointing) + agent/action pipelines.
These make a policy deployable without the sampling stack.

A copy of ``ray_tpu/rllib/connectors.py`` (numpy only), which the port may
not import.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from ray_tpu_torch.rllib.utils.filters import MeanStdFilter


class Connector:
    def __call__(self, data: Any) -> Any:
        raise NotImplementedError

    def to_state(self) -> Tuple[str, Any]:
        return type(self).__name__, None

    @staticmethod
    def from_state(name: str, state: Any) -> "Connector":
        cls = _REGISTRY[name]
        return cls._from_state(state)

    @classmethod
    def _from_state(cls, state):
        return cls()


class FlattenObs(Connector):
    def __call__(self, obs):
        obs = np.asarray(obs)
        return obs.reshape(obs.shape[0], -1) if obs.ndim > 2 else obs


class ClipReward(Connector):
    def __init__(self, limit: float = 1.0):
        self.limit = limit

    def __call__(self, reward):
        return np.clip(reward, -self.limit, self.limit)

    def to_state(self):
        return "ClipReward", self.limit

    @classmethod
    def _from_state(cls, state):
        return cls(state)


class NormalizeObs(Connector):
    """Mean-std filter connector (cross-worker syncable via filter deltas)."""

    def __init__(self, shape: Tuple[int, ...]):
        self.filter = MeanStdFilter(shape)

    def __call__(self, obs):
        return self.filter(np.asarray(obs))

    def to_state(self):
        st = self.filter.stat
        return "NormalizeObs", {
            "shape": self.filter.shape, "n": st.n,
            "mean": st.mean.tolist(), "m2": st.m2.tolist()}

    @classmethod
    def _from_state(cls, state):
        c = cls(tuple(state["shape"]))
        c.filter.stat.n = state["n"]
        c.filter.stat.mean = np.asarray(state["mean"])
        c.filter.stat.m2 = np.asarray(state["m2"])
        return c


class ClipAction(Connector):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, action):
        return np.clip(action, self.low, self.high)

    def to_state(self):
        return "ClipAction", (self.low, self.high)

    @classmethod
    def _from_state(cls, state):
        return cls(*state)


class ConnectorPipeline(Connector):
    def __init__(self, connectors: List[Connector]):
        self.connectors = list(connectors)

    def __call__(self, data):
        for c in self.connectors:
            data = c(data)
        return data

    def to_state(self):
        return "ConnectorPipeline", [c.to_state() for c in self.connectors]

    @classmethod
    def _from_state(cls, state):
        return cls([Connector.from_state(n, s) for n, s in state])


_REGISTRY: Dict[str, type] = {
    c.__name__: c for c in
    (FlattenObs, ClipReward, NormalizeObs, ClipAction, ConnectorPipeline)
}
