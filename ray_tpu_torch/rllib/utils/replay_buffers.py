"""Replay buffers (a copy of ``ray_tpu/rllib/utils/replay_buffers.py``:
the module is numpy, and the port imports nothing of the JAX package;
reference: rllib/utils/replay_buffers/ + rllib/execution/segment_tree.py):
uniform ReplayBuffer and PrioritizedReplayBuffer over sum/min segment
trees.

The trees carry BOTH the scalar reference ops (``__setitem__`` /
``find_prefixsum_idx`` — the textbook per-item loops) and vectorized
batch ops (``set_many`` / ``find_prefixsum_idx_many`` — one numpy
level-by-level descent for a whole batch of draws, one bottom-up
propagation wave for a whole batch of priority writes).  The vectorized
ops are float-identical to running the scalar ops in sequence (same
float64 arithmetic in the same order down each root-to-leaf path), which
tests/test_torch_replay_plane.py pins at fixed seed, against the JAX
package's copy too; they are what the distributed replay plane's shards
run per sample/update batch."""
from __future__ import annotations

import random
from typing import Any, List, Optional

import numpy as np

from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


class SegmentTree:
    def __init__(self, capacity: int, op, neutral: float):
        assert capacity > 0 and capacity & (capacity - 1) == 0, \
            "capacity must be a power of 2"
        self.capacity = capacity
        self.op = op
        self.tree = np.full(2 * capacity, neutral, np.float64)
        self.neutral = neutral

    def __setitem__(self, idx: int, val: float):
        idx += self.capacity
        self.tree[idx] = val
        idx //= 2
        while idx >= 1:
            self.tree[idx] = self.op(self.tree[2 * idx], self.tree[2 * idx + 1])
            idx //= 2

    def __getitem__(self, idx: int) -> float:
        return float(self.tree[idx + self.capacity])

    def set_many(self, idxs: np.ndarray, vals: np.ndarray) -> None:
        """Batched ``self[i] = v``: write all leaves, then recompute each
        touched internal node exactly once per level (one wave up the
        tree) instead of one root-walk per item.  Duplicate indices keep
        the LAST value, matching the sequential scalar loop."""
        idxs = np.asarray(idxs, np.int64)
        vals = np.asarray(vals, np.float64)
        if idxs.size == 0:
            return
        # Deterministic last-write-wins under duplicates: unique() on the
        # reversed stream keeps each index's final value.
        rev_idx = idxs[::-1]
        uniq, first_pos = np.unique(rev_idx, return_index=True)
        leaves = uniq + self.capacity
        self.tree[leaves] = vals[::-1][first_pos]
        nodes = np.unique(leaves >> 1)
        while nodes.size and nodes[0] >= 1:
            self.tree[nodes] = self.op(self.tree[2 * nodes],
                                       self.tree[2 * nodes + 1])
            nodes = np.unique(nodes >> 1)

    def value_many(self, idxs: np.ndarray) -> np.ndarray:
        """Batched leaf read."""
        return self.tree[np.asarray(idxs, np.int64) + self.capacity]

    def reduce(self) -> float:
        return float(self.tree[1])


class SumSegmentTree(SegmentTree):
    def __init__(self, capacity: int):
        super().__init__(capacity, np.add, 0.0)

    def find_prefixsum_idx(self, prefixsum: float) -> int:
        idx = 1
        while idx < self.capacity:
            if self.tree[2 * idx] > prefixsum:
                idx = 2 * idx
            else:
                prefixsum -= self.tree[2 * idx]
                idx = 2 * idx + 1
        return idx - self.capacity

    def find_prefixsum_idx_many(self, prefixsums: np.ndarray) -> np.ndarray:
        """Batched prefix-sum descent: one level of the tree per numpy
        step for the WHOLE batch.  Per-item arithmetic is identical to
        the scalar walk (same compares, same float64 subtractions in the
        same order), so draws match the scalar reference bit-for-bit."""
        ps = np.asarray(prefixsums, np.float64).copy()
        if ps.size == 0:
            return np.zeros(0, np.int64)
        idx = np.ones(ps.shape, np.int64)
        while idx[0] < self.capacity:  # all lanes descend in lockstep
            left = self.tree[2 * idx]
            go_left = left > ps
            ps = np.where(go_left, ps, ps - left)
            idx = np.where(go_left, 2 * idx, 2 * idx + 1)
        return idx - self.capacity


class MinSegmentTree(SegmentTree):
    def __init__(self, capacity: int):
        super().__init__(capacity, np.minimum, float("inf"))


class ReplayBuffer:
    def __init__(self, capacity: int = 10000, seed: Optional[int] = None):
        self.capacity = capacity
        self._storage: List[Any] = []
        self._next_idx = 0
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self._storage)

    def add(self, item: Any):
        if self._next_idx >= len(self._storage):
            self._storage.append(item)
        else:
            self._storage[self._next_idx] = item
        self._next_idx = (self._next_idx + 1) % self.capacity

    def sample(self, num_items: int) -> SampleBatch:
        idxes = [self.rng.randrange(len(self._storage))
                 for _ in range(num_items)]
        return SampleBatch.concat_samples([self._storage[i] for i in idxes])


class PrioritizedReplayBuffer(ReplayBuffer):
    def __init__(self, capacity: int = 10000, alpha: float = 0.6,
                 seed: Optional[int] = None):
        super().__init__(capacity, seed)
        cap2 = 1
        while cap2 < capacity:
            cap2 *= 2
        self._sum = SumSegmentTree(cap2)
        self._min = MinSegmentTree(cap2)
        self._max_priority = 1.0
        self.alpha = alpha

    def add(self, item: Any, priority: Optional[float] = None):
        idx = self._next_idx
        super().add(item)
        p = (priority if priority is not None else self._max_priority)
        self._sum[idx] = p ** self.alpha
        self._min[idx] = p ** self.alpha

    def _draw_masses(self, num_items: int) -> np.ndarray:
        """The draw sequence: one rng.random() per item (kept scalar so
        vectorized and reference sampling consume the seed identically)."""
        total = self._sum.reduce()
        return np.array([self.rng.random() * total
                         for _ in range(num_items)], np.float64)

    def sample(self, num_items: int, beta: float = 0.4):
        """Returns (batch, idxes, is_weights).  One vectorized descent
        for the whole batch of draws + one vectorized weight computation
        (the scalar-loop reference survives as sample_reference)."""
        masses = self._draw_masses(num_items)
        idxes_arr = self._sum.find_prefixsum_idx_many(masses)
        total = self._sum.reduce()
        n = len(self._storage)
        p_min = self._min.reduce() / total
        max_weight = (p_min * n) ** (-beta)
        p_sample = self._sum.value_many(idxes_arr) / total
        weights = ((p_sample * n) ** (-beta) / max_weight).astype(np.float32)
        idxes = [int(i) for i in idxes_arr]
        batch = SampleBatch.concat_samples([self._storage[i] for i in idxes])
        return batch, idxes, weights

    def sample_reference(self, num_items: int, beta: float = 0.4):
        """The pre-vectorization scalar loop, kept as the regression
        oracle: tests assert sample() returns identical draws/weights for
        an identically-seeded buffer."""
        idxes = []
        total = self._sum.reduce()
        for _ in range(num_items):
            mass = self.rng.random() * total
            idxes.append(self._sum.find_prefixsum_idx(mass))
        p_min = self._min.reduce() / total
        max_weight = (p_min * len(self._storage)) ** (-beta)
        weights = np.array([
            ((self._sum[i] / total) * len(self._storage)) ** (-beta)
            / max_weight
            for i in idxes
        ], np.float32)
        batch = SampleBatch.concat_samples([self._storage[i] for i in idxes])
        return batch, idxes, weights

    def update_priorities(self, idxes: List[int], priorities: np.ndarray):
        """Batched priority write: two set_many waves (sum + min trees)
        instead of two root-walks per item."""
        idx_arr = np.asarray(idxes, np.int64)
        p = np.maximum(np.asarray(priorities, np.float64), 1e-6)
        pa = p ** self.alpha
        self._sum.set_many(idx_arr, pa)
        self._min.set_many(idx_arr, pa)
        if p.size:
            self._max_priority = max(self._max_priority, float(p.max()))

    def update_priorities_reference(self, idxes: List[int],
                                    priorities: np.ndarray):
        """Scalar reference for update_priorities (regression oracle)."""
        for i, p in zip(idxes, priorities):
            p = float(max(p, 1e-6))
            self._sum[i] = p ** self.alpha
            self._min[i] = p ** self.alpha
            self._max_priority = max(self._max_priority, p)
