"""Mixture-of-Experts: top-k routing and expert-parallel dispatch/combine
(counterpart of ``ray_tpu/ops/moe.py``).

Routing is top-k over the router's softmax, the chosen probabilities
renormalized over the selected experts, with a static per-expert capacity
``C = ceil(k * N * capacity_factor / E)``; tokens past an expert's
capacity drop (Switch semantics: the residual stream carries them).

The JAX package builds dense one-hot masks ``[N, E, C]`` and moves
tokens with einsums against them.  Each slot ``(e, c)`` holds at most one
token, so those einsums copy rows: here the same function is computed by
index.  ``dispatch_slots`` gives each (token, choice) its flat slot
``e * C + c`` (``E * C``, a zero row, when dropped) and its gate;
dispatch gathers the tokens into ``[E, C, d]`` and combine gathers each
token's expert outputs back and sums them weighted by the gates.  At
GPT-2 small's width and B=8 S=1024 the dense masks would be 671 MB each
per layer.  ``dispatch_combine_masks`` still builds the dense masks, for
the tests that hold them to JAX's.

- ``moe_apply``: the whole expert set on this process's tokens.
- ``moe_apply_expert_parallel``: the JAX ``shard_map`` body, per rank of
  a ``torch.distributed`` group (the mesh's ``expert`` axis, one process
  a rank): dispatch locally, one all-to-all to trade expert groups so
  each rank runs only its resident experts on every peer's tokens, the
  FFN, and the inverse all-to-all.  Both all-to-alls are differentiable
  (the tiled all-to-all is its own adjoint).  Its result equals
  ``moe_apply`` on each rank's token shard at that shard's capacity.
- ``make_expert_parallel_moe``: the counterpart of the ``shard_map``
  wrapper; it takes the full expert stacks and gives each rank its slice.
- ``moe_apply_token_sharded``: ``moe_apply`` over a batch whose tokens
  are sharded over a ``data`` or ``sequence`` group while the experts are
  not, as GSPMD runs the JAX package's dense MoE on such a mesh: the
  capacity and the slot order are the global batch's.

The priority of the slots is JAX's: every first choice takes its slot,
in token order, before any second choice does.  Top-k breaks ties toward
the lower expert index, as ``lax.top_k`` does (a stable sort).  The
expert FFN's gelu is the tanh approximation (``jax.nn.gelu``'s default).
Plain PyTorch: the JAX module has no Pallas kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops.collectives import (
    all_gather_rows,
    all_to_all,
    rank_of,
    world_of,
)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.bfloat16

    def capacity(self, num_tokens: int) -> int:
        return max(1, int(math.ceil(
            self.top_k * num_tokens * self.capacity_factor
            / self.num_experts)))


def router_probs(x: torch.Tensor, w_router: torch.Tensor) -> torch.Tensor:
    """x: [N, d] tokens, w_router: [d, E] -> probs [N, E] fp32."""
    return torch.softmax(x.float() @ w_router.float(), dim=-1)


def top_k_gates(probs: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates [N, k] renormalized over the chosen experts, experts [N, k]
    in descending probability, ties to the lower index)."""
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return top_p, top_i


def dispatch_slots(probs: torch.Tensor, cfg: MoEConfig, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slots [N, k] int64, gates [N, k]): choice j of token n goes to
    flat slot ``e * capacity + c`` of its expert e, or to ``E * capacity``
    when the expert is full (its gate is then 0).  Slots are taken per
    choice in priority order, in token order within a choice."""
    n, e = probs.shape
    top_p, top_i = top_k_gates(probs, cfg.top_k)
    experts = torch.arange(e, device=probs.device)[:, None]
    base = torch.zeros(e, dtype=torch.int64, device=probs.device)
    slots, gates = [], []
    for j in range(cfg.top_k):
        choice = top_i[:, j]
        onehot = (choice[None, :] == experts).to(torch.int32)   # [E, N]
        # Each token's place among this pass's tokens of its expert: a
        # scan along the last dim (on the card a scan over the first dim
        # of an [N, E] tensor with few columns is ~1.4 ms a call).
        rank = onehot.cumsum(1, dtype=torch.int32).gather(
            0, choice[None, :])[0] - 1
        pos_t = rank + base[choice]                               # [N]
        keep = pos_t < capacity
        slots.append(torch.where(keep, choice * capacity + pos_t,
                                 e * capacity))
        gates.append(top_p[:, j] * keep)
        base = base + onehot.sum(1)
    return torch.stack(slots, 1), torch.stack(gates, 1)


def dispatch_combine_masks(probs: torch.Tensor, cfg: MoEConfig,
                           capacity: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense dispatch one-hot and combine weights, each [N, E, C], as
    the JAX package builds them (for the tests; ``moe_apply`` works by
    index)."""
    n, e = probs.shape
    slots, gates = dispatch_slots(probs, cfg, capacity)
    dispatch = probs.new_zeros(n, e * capacity + 1)
    combine = probs.new_zeros(n, e * capacity + 1)
    rows = torch.arange(n, device=probs.device)
    for j in range(cfg.top_k):
        dispatch[rows, slots[:, j]] += 1.0
        combine[rows, slots[:, j]] += gates[:, j]
    shape = (n, e, capacity)
    return (dispatch[:, :-1].reshape(shape),
            combine[:, :-1].reshape(shape))


def dispatch_tokens(x: torch.Tensor, slots: torch.Tensor,
                    num_experts: int, capacity: int) -> torch.Tensor:
    """Tokens into expert groups: [N, d] -> [E, C, d], an empty slot
    zero (JAX's ``einsum("nec,nd->ecd", dispatch, x)``)."""
    n, d = x.shape
    size = num_experts * capacity
    token_of = torch.full((size + 1,), n, dtype=torch.int64,
                          device=x.device)
    token_of.scatter_(0, slots.reshape(-1),
                      torch.arange(n, device=x.device).repeat_interleave(
                          slots.shape[1]))
    padded = torch.cat([x, x.new_zeros(1, d)])
    # index_select, whose gradient is index_add_, not indexing, whose
    # gradient sorts the indices (~2 ms a call at GPT-2 small's width).
    return padded.index_select(0, token_of[:size]).reshape(
        num_experts, capacity, d)


def combine_tokens(out: torch.Tensor, slots: torch.Tensor,
                   gates: torch.Tensor) -> torch.Tensor:
    """Expert outputs back to tokens: [E, C, d] -> [N, d], each token's
    choices weighted by their gates (JAX's ``einsum("nec,ecd->nd",
    combine, out)``)."""
    d = out.shape[-1]
    flat = torch.cat([out.reshape(-1, d), out.new_zeros(1, d)])
    y = flat.index_select(0, slots[:, 0]) * gates[:, 0, None].to(out.dtype)
    for j in range(1, slots.shape[1]):
        y = y + flat.index_select(0, slots[:, j]) \
            * gates[:, j, None].to(out.dtype)
    return y


def moe_ffn(expert_inputs: torch.Tensor, w_in: torch.Tensor,
            w_out: torch.Tensor, act=None) -> torch.Tensor:
    """Per-expert MLP. expert_inputs [E, C, d], w_in [E, d, f], w_out
    [E, f, d] -> [E, C, d]."""
    h = torch.bmm(expert_inputs, w_in)
    h = F.gelu(h, approximate="tanh") if act is None else act(h)
    return torch.bmm(h, w_out)


def moe_apply(x: torch.Tensor, w_router: torch.Tensor, w_in: torch.Tensor,
              w_out: torch.Tensor, cfg: MoEConfig,
              capacity: Optional[int] = None) -> torch.Tensor:
    """MoE on a flat token batch x [N, d] -> [N, d], in x's dtype."""
    n = x.shape[0]
    capacity = capacity or cfg.capacity(n)
    slots, gates = dispatch_slots(router_probs(x, w_router), cfg, capacity)
    expert_inputs = dispatch_tokens(x, slots, cfg.num_experts, capacity)
    out = moe_ffn(expert_inputs, w_in.to(x.dtype), w_out.to(x.dtype))
    return combine_tokens(out, slots, gates)


def moe_apply_expert_parallel(x: torch.Tensor, w_router: torch.Tensor,
                              w_in_local: torch.Tensor,
                              w_out_local: torch.Tensor, cfg: MoEConfig,
                              capacity: int, group=None) -> torch.Tensor:
    """One rank of the expert-parallel MoE (the JAX ``shard_map`` body).

    x [N_local, d] is this rank's token shard; w_in_local/w_out_local
    [E/ep, d, f]/[E/ep, f, d] are this rank's experts (rank r holds
    experts ``r*E/ep`` to ``(r+1)*E/ep``); w_router is the same on every
    rank.  Equals ``moe_apply`` on each rank's shard with the full expert
    set at ``capacity``."""
    ep = world_of(group)
    e, per = cfg.num_experts, cfg.num_experts // max(ep, 1)
    if e % ep or w_in_local.shape[0] != per:
        raise ValueError(f"{e} experts over {ep} ranks: each rank holds "
                         f"{e / ep} experts, got {w_in_local.shape[0]}")
    slots, gates = dispatch_slots(router_probs(x, w_router), cfg, capacity)
    expert_inputs = dispatch_tokens(x, slots, e, capacity)   # [E, C, d]
    d = x.shape[-1]
    if ep > 1:
        # [E, C, d] -> rows [ep, E/ep, C, d] -> each rank's experts'
        # tokens from every peer, in rank order: [E/ep, ep * C, d].
        got = all_to_all(expert_inputs.reshape(ep, per, capacity, d), group)
        expert_inputs = got.transpose(0, 1).reshape(per, ep * capacity, d)
    out = moe_ffn(expert_inputs, w_in_local.to(x.dtype),
                  w_out_local.to(x.dtype))
    if ep > 1:
        rows = out.reshape(per, ep, capacity, d).transpose(0, 1)
        out = all_to_all(rows.contiguous(), group).reshape(e, capacity, d)
    return combine_tokens(out, slots, gates)


def make_expert_parallel_moe(mesh, cfg: MoEConfig, num_tokens_per_shard: int,
                             axis_name: str = "expert"):
    """``fn(x, w_router, w_in, w_out)`` for this rank of ``mesh``: x is
    the rank's token shard [num_tokens_per_shard, d], w_in/w_out the full
    expert stacks [E, d, f]/[E, f, d] (the same on every rank, as JAX's
    global arrays); the rank runs its slice of them over the axis's
    process group.  The gradient of the slices the rank does not hold is
    zero there: an all-reduce over the axis completes it."""
    group = mesh.axis_group(axis_name)
    ep = mesh.shape.get(axis_name, 1)
    idx = mesh.coords.get(axis_name, 0)
    if cfg.num_experts % ep:
        raise ValueError(f"{cfg.num_experts} experts do not divide over "
                         f"{ep} ranks of {axis_name!r}")
    per = cfg.num_experts // ep
    capacity = cfg.capacity(num_tokens_per_shard)

    def fn(x, w_router, w_in, w_out):
        return moe_apply_expert_parallel(
            x, w_router, w_in[idx * per:(idx + 1) * per],
            w_out[idx * per:(idx + 1) * per], cfg, capacity, group)

    return fn


def moe_apply_token_sharded(x: torch.Tensor, w_router: torch.Tensor,
                            w_in: torch.Tensor, w_out: torch.Tensor,
                            cfg: MoEConfig, group=None,
                            rows: int = 1) -> torch.Tensor:
    """``moe_apply`` over the global token batch, for one rank of a group
    over which the tokens are sharded: x [N_local, d] is this rank's part
    of ``rows`` runs of global tokens (``rows=1``: the batch split by rows,
    the ``data`` layout; ``rows=B``: each of the B sequences split by
    position, the ``sequence`` layout).  Every rank gathers the global
    tokens, runs ``moe_apply`` on them at the global capacity (the same
    routing everywhere) and keeps its own rows.  Only this rank's tokens
    carry a gradient: another rank's outputs do not depend on them."""
    n, me = world_of(group), rank_of(group)
    if n == 1:
        return moe_apply(x, w_router, w_in, w_out, cfg)
    d = x.shape[-1]
    parts = list(all_gather_rows(x.detach(), group).unbind(0))
    parts[me] = x
    tokens = torch.stack(parts).reshape(n, rows, -1, d).transpose(0, 1)
    y = moe_apply(tokens.reshape(-1, d), w_router, w_in, w_out, cfg)
    return y.reshape(rows, n, -1, d)[:, me].reshape(-1, d)


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    cfg: MoEConfig) -> dict:
    """normal(0.02) router and expert weights, fp32, drawn on the CPU from
    ``generator`` (the JAX init's distribution, not its values)."""
    e = cfg.num_experts
    return {name: torch.randn(shape, generator=generator) * 0.02
            for name, shape in (("w_router", (d_model, e)),
                                ("w_in", (e, d_model, d_ff)),
                                ("w_out", (e, d_ff, d_model)))}
