"""RLHFLoop: train and serve in one cluster, generation never drains
(counterpart of ``ray_tpu/rllib/algorithms/rlhf/loop.py``).

Topology:

    prompt dataset ──> flow.Stage (rollout producer, depth-bounded)
                           │  engine.generate_rollouts: continuous
                           │  batching amortizes the decode; every token
                           │  carries (behavior logprob, weight version)
                           ▼
    staleness gate (max_weight_staleness over version stamps)
                           ▼
    RewardScorer (@serve.batch)  ──>  SeqPPOLearner (run_ppo_sgd,
                           clip + adam, on the card)
                           ▼
    engine.swap_weights(ref, version): token-boundary hot swap of a CPU
    copy of the lm state dict, put once with ``ray_tpu_torch.put`` when a
    runtime is up (an in-process engine without one takes the state
    dict itself).

The rollout producer is a ``flow.Stage`` worker thread, so while the
learner runs SGD on batch *i* the engine is already decoding batch *i+1*
(``gen_busy_frac_during_sgd`` in the step metrics: the engine's work
seconds over the SGD window).  ``overlap=False`` runs the stage inline:
the drain-then-train baseline.

Staleness: a hot swap lands mid-request by design, so rollouts can mix
versions.  Per-token behavior logprobs make the PPO ratio exact
regardless; the ``max_weight_staleness`` gate bounds how far behind
consumed experience may lag, dropping (never silently training on) older
batches.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ray_tpu_torch.rllib.evaluation.sequence_batch import (
    SequenceBatch,
    SequenceRollout,
)


def _bucket(n: int) -> int:
    b = 8
    while b < n:
        b <<= 1
    return b


@dataclasses.dataclass
class RLHFConfig:
    """Knobs for :class:`RLHFLoop` (defaults are test-scale)."""

    rollouts_per_step: int = 8
    max_new_tokens: int = 16
    temperature: float = 1.0
    top_p: float = 1.0
    seed: int = 0
    # PPO
    lr: float = 1e-3
    clip_param: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    grad_clip: Optional[float] = 1.0
    num_sgd_iter: int = 2
    minibatch_size: Optional[int] = None
    # plane wiring
    max_weight_staleness: int = 2
    pipeline_depth: int = 1
    overlap: bool = True
    score_parallelism: int = 8
    pad_to: Optional[int] = None  # default: bucket(max prompt + max_new)
    # training-plane plans (more than one device in the learner's process:
    # ROADMAP Queue 1 item 6, what is left)
    num_devices: Optional[int] = None
    zero_sharding: str = "off"
    quantized_collectives: str = "off"
    # the learner's device: CUDA unless "cpu"
    device: Optional[str] = None


class RLHFLoop:
    """One PPO iteration per ``step()``; generation overlaps SGD.

    ``engine`` is a started :class:`~ray_tpu_torch.serve.LLMEngine` (or a
    :class:`~ray_tpu_torch.rllib.algorithms.rlhf.RemoteEngine`) serving
    ``model.lm``'s weights at version 0; ``model`` is the
    :class:`~ray_tpu_torch.models.GPT2WithValue` actor-critic, which the
    learner moves to ``config.device`` and trains in place; ``reward`` is
    a ``(prompt, response) -> float`` callable (wrapped in a
    :class:`RewardScorer`) or an existing scorer."""

    def __init__(self, engine, model, prompts: Sequence[Sequence[int]],
                 reward: Callable, config: Optional[RLHFConfig] = None):
        from ray_tpu_torch.parallel import flow
        from ray_tpu_torch.rllib.algorithms.rlhf.ppo_seq import SeqPPOLearner
        from ray_tpu_torch.rllib.algorithms.rlhf.reward import RewardScorer

        self.config = c = config or RLHFConfig()
        self.engine = engine
        self._prompts = [list(map(int, p)) for p in prompts]
        if not self._prompts:
            raise ValueError("empty prompt dataset")
        max_len = max(len(p) for p in self._prompts) + c.max_new_tokens
        self.pad_to = int(c.pad_to or _bucket(max_len))
        if self.pad_to < max_len:
            raise ValueError(f"pad_to={self.pad_to} < longest possible "
                             f"sequence {max_len}")
        self.learner = SeqPPOLearner(
            model, batch_size=c.rollouts_per_step, pad_to=self.pad_to,
            lr=c.lr, clip_param=c.clip_param, vf_coeff=c.vf_coeff,
            entropy_coeff=c.entropy_coeff, grad_clip=c.grad_clip,
            num_sgd_iter=c.num_sgd_iter, minibatch_size=c.minibatch_size,
            num_devices=c.num_devices, zero_sharding=c.zero_sharding,
            quantized_collectives=c.quantized_collectives, seed=c.seed,
            device=c.device)
        self.scorer = reward if isinstance(reward, RewardScorer) \
            else RewardScorer(reward, c.score_parallelism)
        self._version = engine.weight_version
        self._seed_counter = 0
        self._prompt_cursor = 0
        self.stale_batches_dropped = 0
        self.steps_done = 0
        # The rollout producer: workers=1 generates batch i+1 on a
        # background thread while step() trains on batch i (the
        # overlap); workers=0 is the inline drain-then-train baseline.
        self._gen = flow.Stage(
            self._batch_source(), self._generate,
            depth=max(1, int(c.pipeline_depth)),
            workers=1 if c.overlap else 0,
            name="rlhf_rollout", export_metrics=False)

    # ---- rollout production (stage worker thread) --------------------
    def _batch_source(self):
        from ray_tpu_torch.serve.sampling import SamplingParams

        c = self.config
        while True:
            batch = []
            for _ in range(c.rollouts_per_step):
                prompt = self._prompts[self._prompt_cursor
                                       % len(self._prompts)]
                self._prompt_cursor += 1
                samp = SamplingParams(
                    temperature=c.temperature, top_p=c.top_p,
                    seed=c.seed * 1_000_003 + self._seed_counter)
                self._seed_counter += 1
                batch.append((prompt, samp))
            yield batch

    def _generate(self, batch) -> Dict[str, Any]:
        t0 = time.monotonic()
        prompts = [p for p, _ in batch]
        sampling = [s for _, s in batch]
        recs = self.engine.generate_rollouts(
            prompts, self.config.max_new_tokens, sampling=sampling)
        rollouts = [SequenceRollout.from_engine(r) for r in recs]
        return {"rollouts": rollouts, "gen_start": t0,
                "gen_end": time.monotonic()}

    def _swap_payload(self):
        """The new lm weights as the engine takes them: a ref to a CPU
        copy (one put) when a runtime is up, else the state dict."""
        import ray_tpu_torch

        state = self.learner.lm_state_dict()
        if not ray_tpu_torch.is_initialized():
            return state
        return ray_tpu_torch.put({k: v.detach().cpu()
                                  for k, v in state.items()})

    # ---- one PPO iteration (caller thread) ---------------------------
    def step(self) -> Dict[str, Any]:
        c = self.config
        while True:
            item = next(self._gen)
            rollouts: List[SequenceRollout] = item["rollouts"]
            # Batch-granular staleness gate: the batch was generated as
            # one window, so it is consumable iff its oldest token is
            # fresh enough (keeps the learner's [B, L] shape constant).
            oldest = min(r.min_version for r in rollouts)
            if self._version - oldest <= c.max_weight_staleness:
                break
            self.stale_batches_dropped += 1
        rewards = self.scorer.score_rollouts(rollouts)
        batch = SequenceBatch.from_rollouts(rollouts, self.pad_to)
        sgd_t0 = time.monotonic()
        work0 = self.engine.stats()["work_seconds"]
        metrics = self.learner.update(batch.as_dict())
        sgd_t1 = time.monotonic()
        work1 = self.engine.stats()["work_seconds"]

        self._version += 1
        put_t0 = time.monotonic()
        payload = self._swap_payload()
        swap_t0 = time.monotonic()
        self.engine.swap_weights(payload, self._version, timeout=120.0)
        swap_s = time.monotonic() - swap_t0

        self.steps_done += 1
        metrics.update({
            "reward_mean": float(np.mean(rewards)),
            "reward_max": float(np.max(rewards)),
            "weight_version": self._version,
            "stale_batches_dropped": self.stale_batches_dropped,
            "gen_window": (item["gen_start"], item["gen_end"]),
            "sgd_window": (sgd_t0, sgd_t1),
            "sgd_seconds": sgd_t1 - sgd_t0,
            "swap_seconds": swap_s,
            "swap_put_seconds": swap_t0 - put_t0,
            "gen_busy_frac_during_sgd": (
                (work1 - work0) / max(sgd_t1 - sgd_t0, 1e-9)),
            "response_tokens": batch.num_response_tokens,
        })
        return metrics

    def run(self, num_steps: int) -> List[Dict[str, Any]]:
        return [self.step() for _ in range(num_steps)]

    @property
    def weight_version(self) -> int:
        return self._version

    def close(self):
        self._gen.close()
        self.scorer.close()
