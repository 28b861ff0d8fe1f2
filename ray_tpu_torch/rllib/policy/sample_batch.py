"""SampleBatch: the RL data container (reference:
rllib/policy/sample_batch.py:96; MultiAgentBatch :1218).

A copy of ``ray_tpu/rllib/policy/sample_batch.py`` (numpy only), which
the port may not import.  What differs: ``as_jax`` is ``to_tensors(device)``
and ``gather`` resolves through ``ray_tpu_torch.get_many``."""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

# Canonical columns (reference SampleBatch.OBS etc.)
OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
NEXT_OBS = "new_obs"
VF_PREDS = "vf_preds"
ACTION_LOGP = "action_logp"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"
EPS_ID = "eps_id"


class SampleBatch(dict):
    """Dict of equally-long numpy arrays."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if not isinstance(v, np.ndarray):
                self[k] = np.asarray(v)

    def __len__(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    @property
    def count(self) -> int:
        return len(self)

    @staticmethod
    def gather(refs: List[Any]) -> List["SampleBatch"]:
        """Fetch a burst of SampleBatch ObjectRefs with ONE batched
        resolve round trip (ray_tpu_torch.get_many) instead of one head
        request per ref — the rollout-gather hot path."""
        import ray_tpu_torch

        return ray_tpu_torch.get_many(refs)

    @staticmethod
    def gather_concat(refs: List[Any]) -> "SampleBatch":
        """gather() + concat into one training batch."""
        return SampleBatch.concat_samples(SampleBatch.gather(refs))

    @staticmethod
    def _check_columns(batches: List["SampleBatch"]) -> set:
        keys = set(batches[0].keys())
        for b in batches[1:]:
            if set(b.keys()) != keys:
                # Loud, not silent: dropping the odd column loses training
                # data; indexing it would KeyError mid-concatenate.
                raise ValueError(
                    "concat_samples requires identical columns; got "
                    f"{sorted(keys)} vs {sorted(b.keys())}")
        return keys

    @staticmethod
    def concat_samples(batches: List["SampleBatch"]) -> "SampleBatch":
        if not batches:
            return SampleBatch()
        keys = SampleBatch._check_columns(batches)
        return SampleBatch({
            k: np.concatenate([b[k] for b in batches]) for k in keys})

    @staticmethod
    def concat_samples_into(batches: List["SampleBatch"],
                            out: Optional["SampleBatch"]) -> "SampleBatch":
        """``concat_samples`` with destination reuse: when ``out`` (a
        previous result) already has matching shapes/dtypes, fragment rows
        are copied into its arrays instead of allocating a fresh batch —
        the streaming consumer concatenates one train batch per iteration,
        so reuse removes a full batch-sized allocation + GC churn from the
        per-iteration hot path.  The caller must be done with ``out``'s
        previous contents (the learner has consumed them)."""
        if not batches:
            return SampleBatch()
        keys = SampleBatch._check_columns(batches)
        total = sum(len(b) for b in batches)
        result: Dict[str, np.ndarray] = {}
        for k in keys:
            first = np.asarray(batches[0][k])
            shape = (total,) + first.shape[1:]
            dst = None
            if out is not None:
                prev = out.get(k)
                if prev is not None and prev.shape == shape \
                        and prev.dtype == first.dtype:
                    dst = prev
            if dst is None:
                dst = np.empty(shape, first.dtype)
            pos = 0
            for b in batches:
                arr = b[k]
                dst[pos:pos + len(arr)] = arr
                pos += len(arr)
            result[k] = dst
        return SampleBatch(result)

    def shuffle(self, seed: Optional[int] = None) -> "SampleBatch":
        idx = np.random.default_rng(seed).permutation(len(self))
        return SampleBatch({k: v[idx] for k, v in self.items()})

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})

    def minibatches(self, size: int) -> Iterator["SampleBatch"]:
        for s in range(0, len(self) - size + 1, size):
            yield self.slice(s, s + size)

    def split_by_episode(self) -> List["SampleBatch"]:
        if EPS_ID not in self:
            return [self]
        out = []
        ids = self[EPS_ID]
        boundaries = np.flatnonzero(np.diff(ids)) + 1
        start = 0
        for b in list(boundaries) + [len(self)]:
            out.append(self.slice(start, b))
            start = b
        return out

    def to_tensors(self, device) -> Dict[str, Any]:
        """Every column as a torch tensor on ``device`` (a copy; the
        batch's arrays may be read-only views of the object store)."""
        import torch

        return {k: torch.tensor(v, device=device) for k, v in self.items()}

    # ---- sequence support (reference: SampleBatch.seq_lens +
    # rllib/policy/rnn_sequencing.py pad_batch_to_sequences_of_same_size) ----
    def to_sequences(self, max_seq_len: int,
                     states: Optional[List[str]] = None
                     ) -> "SampleBatch":
        """Chunk episodes into sequences of <= max_seq_len, pad to the
        fixed length, and add a ``seq_lens`` column.  Output columns have
        shape [num_seqs, max_seq_len, ...] (zero-padded); state columns
        (if named) keep only each sequence's FIRST row ([num_seqs, ...]) —
        the reference's state_in semantics.  The fixed [S, T, ...] layout
        is what a jit-compiled recurrent loss wants: one compilation for
        every batch."""
        states = states or []
        seqs: List[SampleBatch] = []
        for ep in self.split_by_episode():
            for s in range(0, len(ep), max_seq_len):
                seqs.append(ep.slice(s, min(s + max_seq_len, len(ep))))
        if not seqs or all(len(sq) == 0 for sq in seqs):
            # Keep the schema: empty [0, T, ...] columns compose with
            # non-empty sequence batches (concat) instead of key-erroring.
            out = {}
            for k, v in self.items():
                v = np.asarray(v)
                out[k] = (np.zeros((0,) + v.shape[1:], v.dtype)
                          if k in states else
                          np.zeros((0, max_seq_len) + v.shape[1:], v.dtype))
            out["seq_lens"] = np.zeros((0,), np.int32)
            return SampleBatch(out)
        out: Dict[str, np.ndarray] = {}
        for k in seqs[0].keys():
            if k in states:
                out[k] = np.stack([sq[k][0] for sq in seqs])
                continue
            first = np.asarray(seqs[0][k])
            padded = np.zeros((len(seqs), max_seq_len) + first.shape[1:],
                              first.dtype)
            for i, sq in enumerate(seqs):
                padded[i, : len(sq)] = sq[k]
            out[k] = padded
        out["seq_lens"] = np.asarray([len(sq) for sq in seqs], np.int32)
        return SampleBatch(out)

    @staticmethod
    def sequence_mask(seq_lens: np.ndarray, max_seq_len: int) -> np.ndarray:
        """[S, T] 0/1 mask from seq_lens — multiply into per-step losses
        so padding contributes nothing."""
        return (np.arange(max_seq_len)[None, :]
                < np.asarray(seq_lens)[:, None]).astype(np.float32)


class MultiAgentBatch:
    """Per-policy batches (reference: policy/sample_batch.py
    MultiAgentBatch — concat, timeslice, and the agent→policy grouping
    builder the rollout path uses)."""

    def __init__(self, policy_batches: Dict[str, SampleBatch], env_steps: int):
        self.policy_batches = policy_batches
        self._env_steps = env_steps

    def env_steps(self) -> int:
        return self._env_steps

    def agent_steps(self) -> int:
        return sum(len(b) for b in self.policy_batches.values())

    @staticmethod
    def from_agent_batches(agent_batches: Dict[Any, SampleBatch],
                           policy_mapping_fn: Callable[[Any], str],
                           env_steps: int) -> "MultiAgentBatch":
        """Group per-agent batches under their policies (the
        policy_mapping_fn contract; shared-policy training maps every
        agent to one id)."""
        grouped: Dict[str, List[SampleBatch]] = {}
        for agent_id, batch in agent_batches.items():
            grouped.setdefault(policy_mapping_fn(agent_id), []).append(batch)
        return MultiAgentBatch(
            {pid: SampleBatch.concat_samples(bs)
             for pid, bs in grouped.items()}, env_steps)

    @staticmethod
    def concat_samples(batches: List["MultiAgentBatch"]
                       ) -> "MultiAgentBatch":
        policies: Dict[str, List[SampleBatch]] = {}
        steps = 0
        for mb in batches:
            steps += mb.env_steps()
            for pid, b in mb.policy_batches.items():
                policies.setdefault(pid, []).append(b)
        return MultiAgentBatch(
            {pid: SampleBatch.concat_samples(bs)
             for pid, bs in policies.items()}, steps)

    def __repr__(self):
        sizes = {p: len(b) for p, b in self.policy_batches.items()}
        return f"MultiAgentBatch(env_steps={self._env_steps}, {sizes})"
