"""V-trace off-policy correction (IMPALA; counterpart of
``ray_tpu/rllib/utils/vtrace.py``).  A reversed loop over T with the JAX
scan's body, operation for operation, as ``gae_torch`` is."""
from __future__ import annotations

import torch


@torch.no_grad()
def vtrace(behaviour_logp: torch.Tensor, target_logp: torch.Tensor,
           rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
           last_value: torch.Tensor, gamma: float = 0.99,
           clip_rho: float = 1.0, clip_c: float = 1.0):
    """All inputs time-major ``[T, N]``; ``last_value`` ``[N]``.  Returns
    ``(vs, pg_advantages)``, ``[T, N]``: value targets for the critic and
    importance-corrected advantages for the policy gradient.  Neither
    carries a gradient (the JAX function stops both)."""
    rhos = torch.exp(target_logp - behaviour_logp)
    clipped_rhos = torch.clamp(rhos, max=clip_rho)
    clipped_cs = torch.clamp(rhos, max=clip_c)
    nonterminal = 1.0 - dones.to(torch.float32)

    values_tp1 = torch.cat([values[1:], last_value[None]], 0)
    deltas = clipped_rhos * (rewards + gamma * values_tp1 * nonterminal
                             - values)
    vs_minus_v = torch.empty_like(deltas)
    acc = torch.zeros_like(last_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + gamma * nonterminal[t] * clipped_cs[t] * acc
        vs_minus_v[t] = acc
    vs = values + vs_minus_v

    vs_tp1 = torch.cat([vs[1:], last_value[None]], 0)
    pg_adv = clipped_rhos * (rewards + gamma * vs_tp1 * nonterminal - values)
    return vs, pg_adv
