"""Quantized cross-replica collectives (counterpart of
``ray_tpu/ops/collectives.py``; EQuARX-style, arxiv 2506.17615).

Gradient all-reduce is the data-parallel hot wire: at fp32 a ring
all-reduce moves ``2*(W-1)/W * 4`` bytes per element per replica.  These
helpers trade that for **block-scaled int8**: values are quantized in
fixed-size blocks against the block's absmax (one fp32 scale per block,
~1.6% overhead at the default 256-element block), moved as int8, and the
reduction is computed in fp32 *after* dequantization, so int8 overflow is
impossible and replicas stay bitwise identical (every rank dequantizes the
same received bytes).

Where the JAX package calls these inside a ``shard_map`` body over a named
mesh axis, the port calls them in each rank's eager step over a
``torch.distributed`` process group (``group=None`` is the default
group):

- ``quantized_reduce_scatter_mean(rows, group)``: the ZeRO-2 wire
  (``ray_tpu_torch.parallel.zero``).  ``rows`` is the ``[W, chunk]`` view
  of the local flat gradient; each rank ends with the fp32 **mean** of its
  own chunk, summed in rank order.  One int8 ``all_to_all`` plus the
  scales' ``all_to_all``.
- ``all_to_all(rows, group)``: the differentiable all-to-all of the
  expert-parallel MoE and of Ulysses attention.
- ``quantized_pmean(tree, group)``: drop-in for a mean all-reduce over a
  gradient tree: reduce-scatter in int8, re-quantize each rank's reduced
  chunk, ``all_gather`` the int8 chunks, dequantize identically
  everywhere.

The quantization itself is plain elementwise PyTorch (in the JAX package
it is plain ``jnp``, not a Pallas kernel).  Rounding is round-to-nearest
(half to even, as ``jnp.round``) by default; pass a ``torch.Generator``
for stochastic rounding (``floor(v + u)``, unbiased).

A gloo group moves a CUDA tensor through host memory; ``_wire`` does that
staging explicitly, so every collective here runs on any gloo build, and
an NCCL group moves the tensors where they are.  Each collective is
bounded by the group's timeout (``init_process_group(timeout=...)``).

``comm_bytes_accounting`` and ``int8_wire_bytes`` are the analytic byte
model, copied unchanged; the numpy twins are the serving tier's host
format (``serve/prefill.py`` keeps its own copy for the KV-page wire).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

DEFAULT_BLOCK = 256
_EPS = 1e-12  # all-zero blocks: scale 0 would divide 0/0


def _pad_to_blocks(flat: torch.Tensor, block: int) -> torch.Tensor:
    pad = (-flat.shape[-1]) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(flat.shape[:-1] + (pad,))],
                         dim=-1)
    return flat


def quantize_block_int8(x: torch.Tensor, block: int = DEFAULT_BLOCK,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize the trailing dim of ``x`` in ``block``-sized groups.

    Returns ``(q, scales)``: ``q`` int8 with the trailing dim padded up to
    a block multiple, ``scales`` fp32 of shape ``x.shape[:-1] +
    (nblocks,)`` such that ``q * scale ~ x`` (zeros quantize to exactly 0,
    so padding never leaks into a reduction).  With ``generator`` the
    rounding is stochastic (``floor(v + u)``, u ~ U[0, 1) drawn on
    ``x``'s device), which is unbiased."""
    flat = _pad_to_blocks(x.float(), block)
    blocks = flat.reshape(x.shape[:-1] + (-1, block))
    absmax = blocks.abs().amax(dim=-1)
    scales = absmax / 127.0
    v = blocks / (scales[..., None] + _EPS)
    if generator is not None:
        v = torch.floor(v + torch.rand(v.shape, generator=generator,
                                       device=v.device))
    else:
        v = torch.round(v)
    q = v.clamp(-127, 127).to(torch.int8)
    return q.reshape(x.shape[:-1] + (-1,)), scales


def dequantize_block_int8(q: torch.Tensor, scales: torch.Tensor, n: int,
                          dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_block_int8``: trailing dim cut back to
    ``n`` elements."""
    block = q.shape[-1] // scales.shape[-1]
    blocks = q.reshape(q.shape[:-1] + (scales.shape[-1], block))
    out = blocks.float() * scales[..., None]
    return out.reshape(q.shape[:-1] + (-1,))[..., :n].to(dtype)


# ---- the process group's wire ----
def world_of(group=None) -> int:
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def rank_of(group=None) -> int:
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the group's backend moves it: a gloo group gets CUDA
    tensors staged in host memory (contiguous), NCCL takes them where they
    are."""
    import torch.distributed as dist

    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.cpu()
    return x


def all_to_all_rows(rows: torch.Tensor, group=None) -> torch.Tensor:
    """``[W, ...]`` rows, row i sent to rank i; returns the ``[W, ...]``
    rows received, row j from rank j (``jax.lax.all_to_all`` with
    ``split_axis=concat_axis=0``, untiled)."""
    import torch.distributed as dist

    send = _wire(rows, group)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.to(rows.device)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_rows`` with its gradient: the all-to-all of equal
    rows is its own adjoint (row j of rank i's result is row i of rank
    j's input), so the backward sends the gradient's rows back the same
    way."""

    @staticmethod
    def forward(ctx, rows, group):
        ctx.group = group
        return all_to_all_rows(rows, group)

    @staticmethod
    def backward(ctx, grad):
        return all_to_all_rows(grad, ctx.group), None


def all_to_all(rows: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable ``all_to_all_rows`` (the expert-parallel MoE's and
    Ulysses attention's ``lax.all_to_all``)."""
    return _AllToAll.apply(rows, group)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: ``[W, *x.shape]``, the
    same bytes on every rank."""
    import torch.distributed as dist

    send = _wire(x, group)
    parts = [torch.empty_like(send) for _ in range(world_of(group))]
    dist.all_gather(parts, send, group=group)
    return torch.stack(parts).to(x.device)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ranks of ``x``, taken as an ``all_gather`` and a chain
    of adds in rank order, so every rank holds the same bits whatever the
    backend's reduction order."""
    got = all_gather_rows(x, group)
    acc = got[0]
    for i in range(1, got.shape[0]):
        acc = acc + got[i]
    return acc


def broadcast_(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Overwrite ``x`` in place with rank ``src``'s value."""
    import torch.distributed as dist

    send = _wire(x, group)
    dist.broadcast(send, src=src, group=group)
    if send is not x:
        with torch.no_grad():
            x.copy_(send)
    return x


def quantized_reduce_scatter_mean(rows: torch.Tensor, group=None,
                                  block: int = DEFAULT_BLOCK,
                                  generator: Optional[torch.Generator] = None
                                  ) -> torch.Tensor:
    """int8 reduce-scatter of the mean over ``group``.

    ``rows`` is the local ``[W, chunk]`` contribution (row i destined for
    rank i).  Each rank quantizes its rows, ``all_to_all``s the int8
    payload and the scales, and dequant-sums the W received rows in fp32
    in rank order, returning its own ``[chunk]`` fp32 mean.  The sum is
    exact in fp32 (never accumulated in int8), so the only error is the
    per-element quantization of each contribution."""
    w, chunk = rows.shape
    q, scales = quantize_block_int8(rows, block, generator)
    q = all_to_all_rows(q, group)
    scales = all_to_all_rows(scales, group)
    got = dequantize_block_int8(q, scales, chunk)  # [W, chunk] fp32
    acc = got[0]
    for i in range(1, w):
        acc = acc + got[i]
    return acc / w


def quantized_all_gather(x: torch.Tensor, group=None,
                         block: int = DEFAULT_BLOCK,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """all_gather ``[chunk]`` shards as int8: returns the concatenated
    ``[W * chunk]`` fp32 vector, identical on every rank."""
    n = x.shape[-1]
    q, scales = quantize_block_int8(x, block, generator)
    q = all_gather_rows(q, group)              # [W, padded]
    scales = all_gather_rows(scales, group)
    return dequantize_block_int8(q, scales, n).reshape(-1)


def ravel_tree(tree: Any) -> Tuple[torch.Tensor, Callable]:
    """One flat vector of a tree's tensor leaves (dict keys sorted, as
    ``jax.flatten_util.ravel_pytree``), in their common dtype, and the
    function that cuts such a vector back into the tree."""
    from ray_tpu_torch.parallel.zero import tree_flatten, tree_unflatten

    _, leaves, treedef = tree_flatten(tree)
    dtype = leaves[0].dtype
    for leaf in leaves[1:]:
        dtype = torch.promote_types(dtype, leaf.dtype)
    flat = torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves])
    shapes = [(leaf.shape, leaf.dtype) for leaf in leaves]

    def unravel(vec: torch.Tensor) -> Any:
        out, at = [], 0
        for shape, dt in shapes:
            n = int(torch.Size(shape).numel())
            out.append(vec[at:at + n].reshape(shape).to(dt))
            at += n
        return tree_unflatten(treedef, out)

    return flat, unravel


def quantized_pmean(tree: Any, group=None, block: int = DEFAULT_BLOCK,
                    generator: Optional[torch.Generator] = None) -> Any:
    """Drop-in mean all-reduce over a tree with the int8 wire format.

    Reduce-scatter (int8), requantize the reduced chunk, all_gather
    (int8), dequantize; every rank dequantizes the same gathered bytes, so
    the result is bitwise identical across the group, the invariant the
    replicated-parameter update depends on.  With ``generator`` the
    gather leg draws from a generator seeded from it and the rank, so its
    rounding is decorrelated from the scatter leg's."""
    world = world_of(group)
    flat, unravel = ravel_tree(tree)
    n = flat.shape[0]
    dtype = flat.dtype
    chunk = -(-n // world)  # ceil: equal chunks, tail zero-padded
    rows = torch.cat([flat.float(), flat.new_zeros(
        world * chunk - n, dtype=torch.float32)]).reshape(world, chunk)
    g2 = None
    if generator is not None:
        seed = int(torch.randint(2 ** 62, (1,), generator=generator,
                                 device=generator.device).item())
        g2 = torch.Generator(device=flat.device)
        g2.manual_seed(seed + rank_of(group))
    mine = quantized_reduce_scatter_mean(rows, group, block, generator)
    full = quantized_all_gather(mine, group, block, g2)[:n]
    return unravel(full.to(dtype))


# ---- analytic wire accounting (ring collectives, bytes per replica) ----
def _scale_bytes(n: int, block: int) -> float:
    return 4.0 * (-(-n // block))


def int8_wire_bytes(n_elems: int, block: int = DEFAULT_BLOCK) -> int:
    """Bytes a block-scaled int8 payload of ``n_elems`` fp32 elements
    puts on the wire (int8 values + one fp32 scale per block), assuming
    the block divides the trailing dim so no padding ships."""
    return int(n_elems + _scale_bytes(n_elems, block))


def comm_bytes_accounting(n_params: int, world: int, *,
                          zero_sharding: str = "off",
                          quantized: str = "off",
                          block: int = DEFAULT_BLOCK) -> dict:
    """Bytes moved per replica per optimizer update, by configuration.

    Ring cost model: all-reduce = 2*(W-1)/W * payload; reduce-scatter and
    all-gather = (W-1)/W * payload each.  ``grad_comm_bytes`` is the
    gradient-reduction wire; ``param_comm_bytes`` is the ZeRO param
    all-gather (fp32/native: only gradients are quantized, the EQuARX
    recipe); ``baseline_fp32_allreduce_bytes`` is what the replicated
    fp32 path moves, the denominator of ``reduction_vs_fp32``.  The
    numbers are the JAX package's (the same model, copied)."""
    n, w = float(n_params), int(world)
    frac = (w - 1) / w if w > 1 else 0.0
    elem = 1.0 if quantized == "int8" else 4.0
    scales = _scale_bytes(int(-(-n_params // max(1, world))), block) \
        if quantized == "int8" else 0.0
    baseline = 2.0 * frac * 4.0 * n
    if zero_sharding == "opt+grads":
        # One reduce-scatter of the grads.
        grad = frac * (elem * n + (scales * w if quantized == "int8" else 0))
        param = frac * 4.0 * n
    elif zero_sharding == "opt":
        # Full grad all-reduce (RS + AG when quantized), then shard update.
        grad = (2.0 * frac * (elem * n + scales * w)
                if quantized == "int8" else baseline)
        param = frac * 4.0 * n
    else:
        grad = (2.0 * frac * (elem * n + scales * w)
                if quantized == "int8" else baseline)
        param = 0.0
    return {
        "grad_comm_bytes": grad,
        "param_comm_bytes": param,
        "baseline_fp32_allreduce_bytes": baseline,
        "reduction_vs_fp32": (baseline / grad) if grad else 1.0,
    }


# ---- host-side (numpy) twins, bitwise with the torch versions ----
def quantize_block_int8_np(x, block: int = DEFAULT_BLOCK):
    """Numpy twin of :func:`quantize_block_int8` (deterministic rounding
    only): ``(q int8, scales fp32)``, the trailing axis padded up to a
    block multiple."""
    import numpy as np

    x = np.asarray(x, np.float32)
    pad = (-x.shape[-1]) % block
    if pad:
        x = np.concatenate(
            [x, np.zeros(x.shape[:-1] + (pad,), np.float32)], axis=-1)
    blocks = x.reshape(x.shape[:-1] + (-1, block))
    absmax = np.max(np.abs(blocks), axis=-1)
    scales = (absmax / 127.0).astype(np.float32)
    v = blocks / (scales[..., None] + _EPS)
    q = np.clip(np.round(v), -127, 127).astype(np.int8)
    return q.reshape(x.shape[:-1] + (-1,)), scales


def dequantize_block_int8_np(q, scales, n: int, dtype=None):
    """Numpy twin of :func:`dequantize_block_int8`."""
    import numpy as np

    q = np.asarray(q)
    scales = np.asarray(scales, np.float32)
    block = q.shape[-1] // scales.shape[-1]
    blocks = q.reshape(q.shape[:-1] + (scales.shape[-1], block))
    out = blocks.astype(np.float32) * scales[..., None]
    out = out.reshape(q.shape[:-1] + (-1,))[..., :n]
    return out.astype(dtype) if dtype is not None else out

