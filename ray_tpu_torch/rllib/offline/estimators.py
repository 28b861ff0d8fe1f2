"""Off-policy evaluation estimators (counterpart of
``ray_tpu/rllib/offline/estimators.py``; reference:
rllib/offline/estimators/importance_sampling.py:14 and
weighted_importance_sampling.py:16): estimate the target policy's
episode return from behavior-policy data via per-step likelihood ratios.

Inputs are episodes: each a SampleBatch carrying ``rewards``,
``action_logp`` (behavior policy log-probs at sampling time) and the
TARGET policy's log-probs for the same (obs, action) pairs, supplied by a
``target_logp_fn(batch) -> [T] array``.  Vectorized numpy in float64, a
copy of the JAX package's.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


class _Estimator:
    def __init__(self, gamma: float = 1.0):
        self.gamma = gamma

    def _ratios_and_returns(self, episodes: List[SampleBatch],
                            target_logp_fn: Callable):
        """Per-episode cumulative ratio rho_{0:T} and discounted return."""
        rhos, rets = [], []
        for ep in episodes:
            t_logp = np.asarray(target_logp_fn(ep), dtype=np.float64)
            b_logp = np.asarray(ep["action_logp"], dtype=np.float64)
            # Product of per-step ratios, in log space for stability.
            rhos.append(np.exp(np.sum(t_logp - b_logp)))
            r = np.asarray(ep["rewards"], dtype=np.float64)
            disc = self.gamma ** np.arange(len(r))
            rets.append(float(np.sum(r * disc)))
        return np.asarray(rhos), np.asarray(rets)

    def estimate(self, episodes: List[SampleBatch],
                 target_logp_fn: Callable) -> Dict[str, float]:
        raise NotImplementedError


class ImportanceSampling(_Estimator):
    """V^pi ≈ mean(rho_ep * return_ep) — unbiased, high variance."""

    def estimate(self, episodes, target_logp_fn) -> Dict[str, float]:
        rhos, rets = self._ratios_and_returns(episodes, target_logp_fn)
        vals = rhos * rets
        return {"v_target": float(vals.mean()),
                "v_behavior": float(rets.mean()),
                "v_gain": float(vals.mean() / rets.mean())
                if rets.mean() else float("nan"),
                "std": float(vals.std())}


class WeightedImportanceSampling(_Estimator):
    """V^pi ≈ sum(rho_ep * return_ep) / sum(rho_ep) — biased, lower
    variance (self-normalized)."""

    def estimate(self, episodes, target_logp_fn) -> Dict[str, float]:
        rhos, rets = self._ratios_and_returns(episodes, target_logp_fn)
        denom = rhos.sum()
        v = float((rhos * rets).sum() / denom) if denom > 0 else float("nan")
        return {"v_target": v,
                "v_behavior": float(rets.mean()),
                "v_gain": v / float(rets.mean()) if rets.mean()
                else float("nan"),
                "effective_sample_size":
                    float(denom ** 2 / np.maximum((rhos ** 2).sum(), 1e-12))}
