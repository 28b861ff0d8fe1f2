"""Process-separated rollout engine for the RLHF loop (counterpart of
``ray_tpu/rllib/algorithms/rlhf/rollout_engine.py``).

:class:`EngineHost` is the actor body hosting one ``LLMEngine`` replica
(weights built seeded from ``build_model``, the serving-replica idiom;
the learner starts from the same weights through
``GPT2WithValue.init_from_lm``), and :class:`RemoteEngine` is the
driver-side client with exactly the surface
:class:`~ray_tpu_torch.rllib.algorithms.rlhf.loop.RLHFLoop` uses
(``generate_rollouts`` / ``swap_weights`` / ``stats`` /
``recent_step_stamps`` / ``weight_version``), so the loop runs unchanged
against either.

A worker that asks for no GPU sees none (``CUDA_VISIBLE_DEVICES=""``),
so the engine's actor asks for a share of the card (``num_gpus``, 0.5 by
default: a fraction below 1 shares the card with the learner's process
and other such workers); an engine on the CPU (``device="cpu"``) asks
for ``num_gpus=0``.

The weight path is the versioned one-put broadcast: the loop ``put``s a
CPU copy of the new ``lm`` state dict once; the ref rides
``swap_weights.remote`` to the engine (the runtime materializes it in the
actor, and the engine copies it to its model between decode steps).
Decode-step stamps compare across processes because ``time.monotonic``
is CLOCK_MONOTONIC, system-wide on Linux.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional


class EngineHost:
    """Actor body: one LLMEngine replica in its own process."""

    def __init__(self, model_kind: str = "gpt2",
                 config_kw: Optional[dict] = None, seed: int = 0,
                 device=None, **engine_kw):
        from ray_tpu_torch.serve.llm_engine import LLMEngine, build_model

        model = build_model(model_kind, config_kw, seed, device)
        self.engine = LLMEngine(model, device=device, **engine_kw)

    def generate_rollouts(self, prompts, max_new_tokens: int = 16,
                          eos_id: Optional[int] = None,
                          sampling: Optional[list] = None
                          ) -> List[Dict[str, Any]]:
        return self.engine.generate_rollouts(prompts, max_new_tokens,
                                             eos_id, sampling=sampling)

    def swap_weights(self, params, version: int) -> int:
        return self.engine.swap_weights(params, version, timeout=120.0)

    def weight_version(self) -> int:
        return self.engine.weight_version

    def stats(self) -> Dict[str, Any]:
        return self.engine.stats()

    def recent_step_stamps(self) -> List[float]:
        return self.engine.recent_step_stamps()

    def drain(self) -> bool:
        self.engine.close()
        return True


class RemoteEngine:
    """Driver-side client over an :class:`EngineHost` actor.

    ``max_concurrency`` on the actor lets ``swap_weights``/``stats``
    land while a ``generate_rollouts`` call is mid-decode: the hot swap
    must reach the engine loop during generation, not after."""

    def __init__(self, model_kind: str = "gpt2",
                 config_kw: Optional[dict] = None, seed: int = 0,
                 num_gpus: float = 0.5, **engine_kw):
        import ray_tpu_torch

        self._actor = ray_tpu_torch.remote(EngineHost).options(
            max_concurrency=8, num_gpus=num_gpus).remote(
                model_kind, config_kw, seed, **engine_kw)
        self._rt = ray_tpu_torch

    def generate_rollouts(self, prompts, max_new_tokens: int = 16,
                          eos_id: Optional[int] = None,
                          sampling: Optional[list] = None,
                          timeout: float = 600.0):
        return self._rt.get(
            self._actor.generate_rollouts.remote(
                prompts, max_new_tokens, eos_id, sampling),
            timeout=timeout)

    def swap_weights(self, params, version: int,
                     timeout: float = 120.0) -> int:
        return self._rt.get(
            self._actor.swap_weights.remote(params, version),
            timeout=timeout)

    @property
    def weight_version(self) -> int:
        return self._rt.get(self._actor.weight_version.remote(),
                            timeout=60.0)

    def stats(self) -> Dict[str, Any]:
        return self._rt.get(self._actor.stats.remote(), timeout=60.0)

    def recent_step_stamps(self) -> List[float]:
        return self._rt.get(self._actor.recent_step_stamps.remote(),
                            timeout=60.0)

    def close(self):
        try:
            self._rt.get(self._actor.drain.remote(), timeout=30.0)
        except Exception:
            pass
        try:
            self._rt.kill(self._actor)
        except Exception:
            pass
