"""Seeded sampling for the LLM decode engine (counterpart of
``ray_tpu/serve/sampling.py``).

The rule that makes sampling compatible with recompute preemption and
with token-identity checks: the token sampled at absolute position ``t``
of a request depends only on ``(request seed, t, logits)``, never on how
the engine batched or scheduled the step that produced it.

The JAX package draws with ``fold_in(PRNGKey(seed), t)`` (threefry).
PyTorch cannot reproduce those bits.  Here each sampled row draws its
Gumbel noise from a CPU ``torch.Generator`` seeded with a 64-bit mix of
``(seed, t)``: the same rule, other bits.  So the port's sampling is held
to the JAX package by distribution, and greedy decode by token identity;
within the port, the engine and ``NaiveLM`` sample bitwise alike.

``temperature == 0`` selects argmax (greedy), the engine default.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs.

    temperature: 0.0 = greedy argmax; > 0 softmax-temperature sampling.
    top_p: nucleus truncation: sample only from the smallest set of
        tokens whose cumulative probability reaches ``top_p`` (1.0 = no
        truncation).  Applied after temperature scaling.
    seed: the per-request seed; the token at absolute position t is drawn
        from a generator seeded with ``(seed, t)``.
    """

    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0

    def validate(self) -> "SamplingParams":
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        return self


GREEDY = SamplingParams()


def top_p_mask(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Boolean [.., V] nucleus mask: True for the tokens in the smallest
    set whose cumulative probability (descending order) reaches
    ``top_p`` [..].  The most probable token is always kept.  Ties are
    broken by a stable descending sort, as in the JAX package."""
    probs = torch.softmax(logits.float(), dim=-1)
    order = torch.argsort(-probs, dim=-1, stable=True)
    sorted_probs = probs.gather(-1, order)
    csum = sorted_probs.cumsum(-1)
    # Keep a token while the mass accumulated BEFORE it is < top_p.
    keep_sorted = (csum - sorted_probs) < top_p[..., None]
    return torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)


def draw_seed(seed: int, position: int) -> int:
    """64-bit generator seed for the token at ``position`` (SplitMix64's
    finalizer over the pair)."""
    x = ((seed & _MASK64) * 0x9E3779B97F4A7C15 + (position & _MASK64)) \
        & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def sample_tokens_with_logprobs(logits: torch.Tensor,
                                positions: torch.Tensor,
                                temperature: torch.Tensor,
                                top_p: torch.Tensor, seeds: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw one token per row and its behavior logprob.

    logits: [N, V]; positions: [N] absolute position of the token being
    generated; temperature, top_p: [N] float; seeds: [N] int.  Rows with
    ``temperature <= 0`` take the argmax.  Returns ``(tokens [N] int64,
    logps [N] fp32)``; the logprob is the raw log-softmax of the logits
    at the chosen token (temperature 1, no nucleus truncation)."""
    logits = logits.float()
    tokens = logits.argmax(dim=-1)
    temps = temperature.tolist()
    rows = [i for i, t in enumerate(temps) if t > 0.0]
    if rows:
        idx = torch.tensor(rows, device=logits.device)
        scaled = logits[idx] / temperature[idx].float().clamp_min(
            1e-6)[:, None]
        masked = torch.where(top_p_mask(scaled, top_p[idx].float()), scaled,
                             torch.full((), float("-inf"),
                                        device=logits.device))
        pos, sd = positions.tolist(), seeds.tolist()
        noise = torch.empty((len(rows), logits.shape[-1]))
        for n, i in enumerate(rows):
            gen = torch.Generator().manual_seed(draw_seed(int(sd[i]),
                                                          int(pos[i])))
            noise[n].uniform_(generator=gen)
        gumbel = -torch.log(-torch.log(noise.to(logits.device)))
        tokens[idx] = (masked + gumbel).argmax(dim=-1)
    logps = torch.log_softmax(logits, dim=-1).gather(
        -1, tokens[:, None])[:, 0]
    return tokens, logps


def sample_tokens(logits, positions, temperature, top_p, seeds
                  ) -> torch.Tensor:
    """Token-only form of :func:`sample_tokens_with_logprobs`."""
    return sample_tokens_with_logprobs(logits, positions, temperature,
                                       top_p, seeds)[0]
