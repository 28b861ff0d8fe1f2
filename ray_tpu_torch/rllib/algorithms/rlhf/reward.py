"""Reward scoring for the RLHF loop, riding ``@serve.batch`` (copy of
``ray_tpu/rllib/algorithms/rlhf/reward.py``).

A reward model is just another serving workload: scoring requests
arrive per rollout but want to execute batched.  ``RewardScorer``
wraps any ``(prompt_tokens, response_tokens) -> float`` function behind
the serve-plane batcher (``ray_tpu_torch.serve.batching.batch``): concurrent
``score`` calls — the loop fans rollouts out over a small thread pool —
are auto-collected into one batched evaluation, exactly how a learned
reward model on a device wants to be fed.  Deploy the scorer under
``@serve.deployment`` for a remote replica set, or use it in-process.

Two toy preference rewards ship for the benchmarks: a target-token
reward (fraction of response tokens equal to a target — "positive
sentiment" reduced to its testable core) and a token-set variant.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Sequence

from ray_tpu_torch.serve.batching import batch as serve_batch


def target_token_reward(target_token: int) -> Callable:
    """Reward = fraction of response tokens equal to ``target_token`` —
    a dense, noiseless preference signal: the optimal policy emits the
    target every step, so a learning curve on it is unambiguous."""
    t = int(target_token)

    def fn(prompt: Sequence[int], response: Sequence[int]) -> float:
        if not len(response):
            return 0.0
        return sum(1 for tok in response if int(tok) == t) / len(response)

    return fn


def token_set_reward(positive: Sequence[int]) -> Callable:
    """Reward = fraction of response tokens inside ``positive`` (the
    toy "positive sentiment" set)."""
    pos = {int(t) for t in positive}

    def fn(prompt: Sequence[int], response: Sequence[int]) -> float:
        if not len(response):
            return 0.0
        return sum(1 for tok in response if int(tok) in pos) / len(response)

    return fn


class RewardScorer:
    """Batched reward scorer (one ``@serve.batch`` entry point).

    ``score((prompt, response))`` blocks for one scalar; concurrent
    callers batch.  ``score_rollouts`` is the loop-facing helper: fan a
    rollout list over a thread pool (creating the concurrency the
    batcher collects), write each reward onto its rollout, return the
    list.  ``observed_batch_sizes`` proves batching happened."""

    def __init__(self, reward_fn: Callable, score_parallelism: int = 8):
        self._fn = reward_fn
        self._parallelism = max(1, int(score_parallelism))
        self.observed_batch_sizes: List[int] = []

    @serve_batch(max_batch_size=32, batch_wait_timeout_s=0.005)
    def score(self, items: List) -> List[float]:
        self.observed_batch_sizes.append(len(items))
        return [float(self._fn(p, r)) for p, r in items]

    def score_rollouts(self, rollouts) -> List[float]:
        if len(rollouts) == 1:
            rewards = [self.score((rollouts[0].prompt, rollouts[0].tokens))]
        else:
            with ThreadPoolExecutor(
                    max_workers=min(self._parallelism, len(rollouts)),
                    thread_name_prefix="rtpu-reward") as pool:
                rewards = list(pool.map(
                    lambda r: self.score((r.prompt, r.tokens)), rollouts))
        for r, rew in zip(rollouts, rewards):
            r.reward = float(rew)
        return rewards

    def close(self):
        """Release the underlying batcher's stage thread."""
        from ray_tpu_torch.serve import batching

        batching.close_instance_batchers(self)
