"""Version-stamped sequence batches for the RLHF rollout plane (copy of
``ray_tpu/rllib/evaluation/sequence_batch.py``; numpy only).

The RLHF loop's unit of experience is a *sequence rollout*: a prompt,
the tokens the serving engine sampled after it, the behavior logprob of
every sampled token (captured by the engine's decode step — no second
forward pass), and the weight version each token was sampled under
(``LLMEngine.swap_weights`` stamps).  This module is the bridge between
the engine's per-request rollout dicts and the learner's fixed-shape
arrays:

- :class:`SequenceRollout` — one rollout record plus its scalar reward.
- :func:`split_fresh` — the ``max_weight_staleness`` consumption gate
  (the rollout plane's rule applied to sequences): a rollout is
  consumable iff its OLDEST token is within ``max_staleness`` versions
  of the learner's current weights; staler rollouts are dropped, never
  silently trained on.
- :class:`SequenceBatch` — padded ``[B, L]`` arrays (tokens, response
  mask, behavior logprobs, version stamps, rewards) at a FIXED width, so
  the learner's step sees one shape.

Mixed-version rollouts (a hot swap landed mid-request) are fine by
construction: the PPO ratio is per-token and each token's behavior
logprob is exact for the weights that actually sampled it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class SequenceRollout:
    """One engine rollout (see ``LLMEngine.rollout``) plus its reward."""

    prompt: List[int]
    tokens: List[int]
    logprobs: List[float]
    versions: List[int]
    reward: Optional[float] = None

    @classmethod
    def from_engine(cls, record: Dict) -> "SequenceRollout":
        return cls(prompt=list(record["prompt"]),
                   tokens=list(record["tokens"]),
                   logprobs=list(record["logprobs"]),
                   versions=list(record["versions"]))

    @property
    def min_version(self) -> int:
        return min(self.versions) if self.versions else 0

    @property
    def max_version(self) -> int:
        return max(self.versions) if self.versions else 0

    def __len__(self) -> int:
        return len(self.prompt) + len(self.tokens)


def split_fresh(rollouts: Sequence[SequenceRollout], current_version: int,
                max_staleness: int
                ) -> Tuple[List[SequenceRollout], List[SequenceRollout]]:
    """(fresh, stale) under the staleness gate: a rollout is fresh iff
    every token was sampled within ``max_staleness`` versions of
    ``current_version``."""
    fresh, stale = [], []
    for r in rollouts:
        if current_version - r.min_version <= max_staleness:
            fresh.append(r)
        else:
            stale.append(r)
    return fresh, stale


class SequenceBatch:
    """Fixed-shape learner view of a rollout list.

    ``tokens`` [B, L] int32 (prompt + response, zero-padded),
    ``response_mask`` [B, L] f32 (1.0 exactly on sampled-token
    positions), ``behavior_logp`` [B, L] f32 (0 where masked),
    ``versions`` [B, L] int32 (stamps; 0 where masked), ``rewards``
    [B] f32.  ``L`` is ``pad_to``, constant across loop iterations.
    """

    FIELDS = ("tokens", "response_mask", "behavior_logp", "versions")

    def __init__(self, tokens: np.ndarray, response_mask: np.ndarray,
                 behavior_logp: np.ndarray, versions: np.ndarray,
                 rewards: np.ndarray):
        self.tokens = tokens
        self.response_mask = response_mask
        self.behavior_logp = behavior_logp
        self.versions = versions
        self.rewards = rewards

    @classmethod
    def from_rollouts(cls, rollouts: Sequence[SequenceRollout],
                      pad_to: int) -> "SequenceBatch":
        if not rollouts:
            raise ValueError("empty rollout list")
        B = len(rollouts)
        longest = max(len(r) for r in rollouts)
        if longest > pad_to:
            raise ValueError(
                f"rollout of length {longest} exceeds pad_to={pad_to}")
        tokens = np.zeros((B, pad_to), np.int32)
        mask = np.zeros((B, pad_to), np.float32)
        logp = np.zeros((B, pad_to), np.float32)
        vers = np.zeros((B, pad_to), np.int32)
        rewards = np.zeros((B,), np.float32)
        for i, r in enumerate(rollouts):
            p, n = len(r.prompt), len(r.tokens)
            tokens[i, :p] = r.prompt
            tokens[i, p:p + n] = r.tokens
            mask[i, p:p + n] = 1.0
            logp[i, p:p + n] = r.logprobs
            vers[i, p:p + n] = r.versions
            rewards[i] = 0.0 if r.reward is None else float(r.reward)
        return cls(tokens, mask, logp, vers, rewards)

    def as_dict(self) -> Dict[str, np.ndarray]:
        return {"tokens": self.tokens, "response_mask": self.response_mask,
                "behavior_logp": self.behavior_logp,
                "versions": self.versions, "rewards": self.rewards}

    def __len__(self) -> int:
        return self.tokens.shape[0]

    @property
    def num_response_tokens(self) -> int:
        return int(self.response_mask.sum())
