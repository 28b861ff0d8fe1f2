"""Sequence parallelism: ring attention and Ulysses all-to-all
(counterpart of ``ray_tpu/parallel/ring_attention.py``).

The JAX package runs both inside a ``shard_map`` over the mesh's
``sequence`` axis.  The port runs one process a rank: each rank calls
these with its own shard ``[B, L/n, H, D]`` of q, k and v (rank r holds
positions ``r*L/n`` to ``(r+1)*L/n``), over the axis's process group
(``Mesh.axis_group``), and gets its shard of the output.

- **Ring**: the K/V shards travel round the ring by point-to-point sends
  while each rank folds them into the online-softmax recurrence
  (``ops.attention.blockwise_update``) for its own queries; no rank ever
  holds the whole sequence's K/V.  The causal mask comes from global
  positions, and a block wholly above the diagonal is passed on without
  being computed (it would add exactly nothing).  Autograd does not pass
  through ``send``/``recv``, so the ring is a ``torch.autograd.Function``
  whose backward runs the ring again: each K/V block travels with its
  dK/dV accumulators, every rank adds its queries' share, and one last
  send brings the accumulators home.  That is the computation JAX's
  autodiff of ``scan`` + ``ppermute`` does.
- **Ulysses**: an all-to-all swaps the sharded axis from sequence to
  heads, exact local attention runs on whole sequences, and the inverse
  all-to-all swaps back; the all-to-all is its own adjoint, so the
  backward is the inverse swap.  Needs ``num_heads % n == 0``.

With no ``sequence`` axis in the mesh both fall back to
``mha_attention``, as JAX's do.  A gloo group moves CUDA tensors through
host memory (``ops.collectives._wire``).

The package exports ``ring_attention`` under this module's own name, and
importing the module binds the module there: so the module is callable
as the function, and ``from ray_tpu_torch.parallel import
ring_attention`` works whichever import came first.
"""
from __future__ import annotations

import sys
import types
from typing import Optional

import torch

from ray_tpu_torch.ops.attention import (
    NEG_INF,
    blockwise_update,
    finalize_blockwise,
    mha_attention,
)
from ray_tpu_torch.ops.collectives import _wire, all_to_all


def _shift(x: torch.Tensor, group, n: int, me: int) -> torch.Tensor:
    """Send ``x`` to the next rank on the ring; return the previous
    rank's."""
    import torch.distributed as dist

    def global_rank(r):
        return r if group is None else dist.get_global_rank(group, r)

    send = _wire(x, group)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, global_rank((me + 1) % n), group),
           dist.P2POp(dist.irecv, recv, global_rank((me - 1) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device)


def _block_mask(me: int, src: int, lq: int, lk: int, causal: bool,
                device):
    """(skip, mask) for queries of shard ``me`` against keys of shard
    ``src`` by global position (query p sees key j when p >= j): skip a
    block nothing sees; mask None when everything does."""
    if not causal or me * lq >= src * lk + lk - 1:
        return False, None
    if me * lq + lq - 1 < src * lk:
        return True, None
    q_pos = me * lq + torch.arange(lq, device=device)
    k_pos = src * lk + torch.arange(lk, device=device)
    return False, q_pos[:, None] >= k_pos[None, :]


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, n, me, causal, scale):
        b, lq, h, d = q.shape
        lk = k.shape[1]
        o = torch.zeros(b, lq, h, d, dtype=torch.float32, device=q.device)
        l = torch.zeros(b, h, lq, dtype=torch.float32, device=q.device)
        m = torch.full((b, h, lq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        kv = torch.stack([k, v])
        for t in range(n):
            skip, mask = _block_mask(me, (me - t) % n, lq, lk, causal,
                                     q.device)
            if not skip:
                o, l, m = blockwise_update(q, kv[0], kv[1], o, l, m, mask,
                                           sm_scale=scale)
            if t < n - 1:
                kv = _shift(kv, group, n, me)
        out = finalize_blockwise(o, l).to(q.dtype)
        # A row that saw no key keeps l = 0: its LSE is +inf, so every P
        # of the backward is exactly 0 there.
        lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                          torch.full_like(l, float("inf")))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (group, n, me, causal, scale)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        group, n, me, causal, scale = ctx.ring
        lq, lk = q.shape[1], k.shape[1]
        q32, do = q.float(), d_out.float()
        delta = (do * out.float()).sum(-1).transpose(1, 2)[..., None]
        dq = torch.zeros_like(q32)
        # The block and its dK/dV accumulators travel together: [4, B,
        # Lk, H, D] = k, v, dk, dv (fp32; a bf16 k or v is exact in it).
        blk = torch.cat([torch.stack([k, v]).float(),
                         torch.zeros(2, *k.shape, dtype=torch.float32,
                                     device=k.device)])
        for t in range(n):
            skip, mask = _block_mask(me, (me - t) % n, lq, lk, causal,
                                     q.device)
            if not skip:
                kb, vb = blk[0], blk[1]
                s = torch.einsum("bqhd,bkhd->bhqk", q32, kb) * scale
                if mask is not None:
                    s = s.masked_fill(~mask[None, None], NEG_INF)
                p = torch.exp(s - lse[..., None])
                p = p.masked_fill(s <= NEG_INF / 2, 0.0)
                dp = torch.einsum("bqhd,bkhd->bhqk", do, vb)
                ds = p * (dp - delta) * scale
                dq += torch.einsum("bhqk,bkhd->bqhd", ds, kb)
                blk[2] += torch.einsum("bhqk,bqhd->bkhd", ds, q32)
                blk[3] += torch.einsum("bhqk,bqhd->bkhd", p, do)
            if t < n - 1:
                blk = _shift(blk, group, n, me)
        # After n - 1 sends each block sits one rank before its owner.
        acc = _shift(blk[2:].contiguous(), group, n, me) if n > 1 \
            else blk[2:]
        return (dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype),
                None, None, None, None, None)


def _axis(mesh, axis: str):
    """(group, size, this rank's index) of ``axis``."""
    return mesh.axis_group(axis), mesh.shape[axis], mesh.coords[axis]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis: str = "sequence", causal: bool = True,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over this rank's shards [B, L/n, H, D] of q, k, v
    (``ray_tpu/parallel/ring_attention.py:64``); returns this rank's
    shard of the output.  Differentiable.  The JAX function's
    ``batch_axes`` has no counterpart: each rank already holds only its
    batch rows."""
    if axis not in mesh.axis_names:
        # Degenerate mesh (one rank on the axis): plain attention.
        return mha_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    group, n, me = _axis(mesh, axis)
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    return _Ring.apply(q, k, v, group, n, me, causal, scale)


def _swap_in(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[B, L/n, H, D] -> [B, L, H/n, D]: rank r gets head group r of every
    rank's sequence shard, the shards in rank order."""
    b, ls, h, d = x.shape
    rows = x.reshape(b, ls, n, h // n, d).permute(2, 0, 1, 3, 4)
    got = all_to_all(rows.contiguous(), group)
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * ls, h // n, d)


def _swap_out(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[B, L, H/n, D] -> [B, L/n, H, D]: the inverse of ``_swap_in``."""
    b, l, hn, d = x.shape
    rows = x.reshape(b, n, l // n, hn, d).permute(1, 0, 2, 3, 4)
    got = all_to_all(rows.contiguous(), group)
    return got.permute(1, 2, 0, 3, 4).reshape(b, l // n, n * hn, d)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis: str = "sequence", causal: bool = True,
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """Ulysses sequence parallelism over this rank's shards
    (``ray_tpu/parallel/ring_attention.py:109``): all-to-all to whole
    sequences of H/n heads, the plain attention path, all-to-all back.
    Requires ``num_heads % n == 0``."""
    if axis not in mesh.axis_names:
        return mha_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    group, n, _ = _axis(mesh, axis)
    if q.shape[2] % n:
        raise ValueError(
            f"num_heads {q.shape[2]} not divisible by axis size {n}")
    if n == 1:
        return mha_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                             use_flash=False)
    out = mha_attention(_swap_in(q, group, n), _swap_in(k, group, n),
                        _swap_in(v, group, n), causal=causal,
                        sm_scale=sm_scale, use_flash=False)
    return _swap_out(out, group, n)


class _CallableModule(types.ModuleType):
    def __call__(self, *args, **kwargs):
        return ring_attention(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule
