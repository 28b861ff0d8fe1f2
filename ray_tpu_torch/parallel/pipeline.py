"""Pipeline parallelism inside one program: a GPipe microbatch schedule
over a ``pipe`` mesh axis (counterpart of ``ray_tpu/parallel/pipeline.py``).

The JAX package runs the whole pipeline as one SPMD program: every device
holds one stage's weights, activations rotate along the ring by
``ppermute``, and autodiff through the scan yields the reversed-ring
backward.  The port does what it does for every multi-device program: a
process per rank.  Each rank of the mesh's ``pipe`` line
(``Mesh.axis_group("pipe")``) runs its stage; the rotation is a
point-to-point shift to the next rank, wrapped in an ``autograd.Function``
whose backward shifts the cotangent back to the previous rank (the
backward ring of ``parallel/ring_attention.py``); the last stage's
outputs reach every rank through a masked all-reduce, whose backward
passes each rank's cotangent through unchanged (the loss is computed once,
on the replicated output).  Every rank calls ``pipeline_apply`` with the
same arguments, as every device runs the JAX program.  The MPMD pipeline
across gangs is ``parallel/mpmd_pipeline.py``.

Constraint: all stages share one activation shape [mb, ...].
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ray_tpu_torch.ops.collectives import _wire
from ray_tpu_torch.parallel.zero import tree_flatten, tree_unflatten


def stack_stage_params(per_stage_params: list) -> Any:
    """Stack per-stage trees along a new leading 'stage' axis."""
    _, first, treedef = tree_flatten(per_stage_params[0])
    leaves = [tree_flatten(p)[1] for p in per_stage_params]
    return tree_unflatten(treedef, [
        torch.stack([torch.as_tensor(ls[i]) for ls in leaves])
        for i in range(len(first))])


def _stage_slice(stacked: Any, i: int) -> Any:
    _, leaves, treedef = tree_flatten(stacked)
    return tree_unflatten(treedef, [x[i] for x in leaves])


def _send_recv(x: torch.Tensor, group, n: int, me: int,
               hop: int) -> torch.Tensor:
    """Send ``x`` to rank ``me + hop`` of the line; return what rank
    ``me - hop`` sent."""
    import torch.distributed as dist

    def global_rank(r):
        return dist.get_global_rank(group, r % n)

    send = _wire(x.contiguous(), group)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, global_rank(me + hop), group),
           dist.P2POp(dist.irecv, recv, global_rank(me - hop), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device)


class _Shift(torch.autograd.Function):
    """``ppermute`` by one along the ring, differentiable: the cotangent
    travels the other way."""

    @staticmethod
    def forward(ctx, x, group, n, me):
        ctx.ring = (group, n, me)
        return _send_recv(x, group, n, me, +1)

    @staticmethod
    def backward(ctx, dy):
        group, n, me = ctx.ring
        return _send_recv(dy, group, n, me, -1), None, None, None


class _ReplicateFromLast(torch.autograd.Function):
    """``psum(outputs * mask)`` over the line, with the loss taken once on
    the replicated result: each rank's cotangent goes back through the
    mask unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        out = _wire(x.clone(), group)
        dist.all_reduce(out, group=group)
        return out.to(x.device)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stacked_params: Any, x_micro: torch.Tensor, mesh=None,
                   axis: str = "pipe", remat: bool = True) -> torch.Tensor:
    """Run ``stage_fn`` as an n-stage pipeline over the mesh's ``pipe`` axis.

    ``stage_fn(params_i, x: [mb, ...]) -> [mb, ...]``; ``stacked_params``
    a tree with a leading stage axis of the axis's size; ``x_micro``
    ``[n_micro, mb, ...]``.  Returns ``[n_micro, mb, ...]``, the same on
    every rank of the line.  Rank i uses slot i of ``stacked_params``, so
    the gradient of ``stacked_params`` on rank i is its stage's (the
    shard a device holds in the JAX program).  Without a ``pipe`` axis
    (``mesh`` None or without it) the stages run one after another on
    each microbatch.  ``remat`` recomputes the stage function in the
    backward (``torch.utils.checkpoint``)."""
    if mesh is None or axis not in mesh.shape or mesh.shape[axis] == 1:
        n_stages = tree_flatten(stacked_params)[1][0].shape[0]
        outs = []
        for x in x_micro:
            for i in range(n_stages):
                x = stage_fn(_stage_slice(stacked_params, i), x)
            outs.append(x)
        return torch.stack(outs)

    n_stages = mesh.shape[axis]
    group = mesh.axis_group(axis)
    idx = mesh.coords[axis]
    n_micro = x_micro.shape[0]
    params = _stage_slice(stacked_params, idx)
    if remat:
        from torch.utils.checkpoint import checkpoint

        def fn(p, s):
            return checkpoint(stage_fn, p, s, use_reentrant=False)
    else:
        fn = stage_fn

    first = torch.tensor(idx == 0, device=x_micro.device)
    state = torch.zeros_like(x_micro[0])
    outs = []
    for t in range(n_micro + n_stages - 1):
        # Stage 0 injects microbatch t (clamped; its output is masked
        # when t >= n_micro).  A where, not a branch: every rank's graph
        # then holds every shift, so the backward shifts pair up.
        state = torch.where(first, x_micro[min(t, n_micro - 1)], state)
        out = fn(params, state)
        if t >= n_stages - 1:
            outs.append(out)
        state = _Shift.apply(out, group, n_stages, idx)
    last = float(idx == n_stages - 1)
    return _ReplicateFromLast.apply(torch.stack(outs) * last, group)


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """[B, ...] -> [n_micro, B/n_micro, ...]"""
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible by {n_micro}")
    return x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))
