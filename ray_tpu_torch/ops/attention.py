"""Attention ops (counterpart of ``ray_tpu/ops/attention.py``).

``mha_attention`` dispatches long self-attention on CUDA tensors to the
hand-written Hopper flash-attention kernels and everything else to the
plain PyTorch path.  The forward is ``csrc/flash_fwd.cu`` (the port of
the TPU kernel ``_flash_fwd_kernel``); its gradient is ``_FlashAttention``
(in place of ``_flash``'s custom VJP), whose backward launches
``csrc/flash_bwd.cu`` (the ports of ``_flash_dq_kernel`` and
``_flash_dkv_kernel``).  ``cached_attention`` is the engine's decode
path; the JAX package runs it as plain XLA, so it stays plain PyTorch here.
``blockwise_update`` and ``finalize_blockwise`` are the online-softmax
recurrence that ring attention folds its K/V blocks with (plain jnp in
the JAX package too).

On CPU tensors ``flash_attention`` and its gradient compute their plain
versions (``flash_attention_reference`` and
``flash_attention_backward_reference``); on CUDA tensors they launch the
kernels or raise.  There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp() NaN-free
# Lq and Lk must be multiples of the kernel's tile (kBlockQ and kBlockK in
# csrc/flash_fwd.cu, whose C entry refuses other lengths too).
FLASH_TILE = 64
# Launches of each hand-written kernel in this process, counted by the
# wrappers where they launch; chip_smoke.py zeroes and reads them.
LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, sm_scale: Optional[float] = None,
                  use_flash: Optional[bool] = None) -> torch.Tensor:
    """Multi-head attention. q,k,v: [B, L, H, D] -> [B, L, H, D].

    With ``use_flash=None`` the dispatch conditions are the JAX package's,
    with "the tensor is on CUDA" in place of "the backend is not the CPU".
    The length crossover (lq >= 1024, or a score matrix over 512 MiB) was
    measured on a TPU and is kept so that the same calls reach the
    kernel; the H100's own crossover is in PERF.md.  ``use_flash=True``
    always calls ``flash_attention`` (the kernels on CUDA tensors, their
    plain versions on CPU tensors) and ``False`` always the plain path.
    A kernel failure raises: unlike the JAX package, there is no fallback
    to the plain path."""
    b, lq, h, _ = q.shape
    lk = k.shape[1]
    score_bytes = b * h * lq * lk * q.element_size()
    if use_flash is None:
        use_flash = (q.is_cuda
                     and lq % 128 == 0 and lk % 128 == 0
                     and (lq >= 1024 or score_bytes > 512 * 1024 * 1024)
                     # The flash mask is diagonal-aligned; the plain
                     # path's is bottom-right-aligned for lq != lk
                     # (decode).
                     and (not causal or lq == lk))
    if use_flash:
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    return _plain_attention(q, k, v, causal, sm_scale)


def _plain_attention(q, k, v, causal, sm_scale):
    """Counterpart of ``_xla_attention``: scores in the storage dtype, fp32
    softmax, causal mask bottom-right aligned (``tril(k=lk-lq)``)."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        mask = torch.ones(lq, lk, dtype=torch.bool,
                          device=q.device).tril(lk - lq)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s.float(), dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def cached_attention(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_lengths: torch.Tensor,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention for the incremental-decode path: T new tokens attend to a
    per-sequence cached prefix plus themselves (causally).

    q, k_new, v_new: [B, T, H(q/kv), D], at absolute positions
    ``cache_lengths[b] + t``.  k_cache, v_cache: [B, S, Hkv, D], of which
    only the first ``cache_lengths[b]`` rows are valid (the rest is
    masked, so gathered pages need no zeroing).  With Hkv < H the
    key/value heads are repeated GQA-style after the concatenation.
    S == 0 is plain causal self-attention (the prefill case)."""
    b, t, h, d = q.shape
    s = k_cache.shape[1]
    k = torch.cat([k_cache, k_new], dim=1) if s else k_new
    v = torch.cat([v_cache, v_new], dim=1) if s else v_new
    if k.shape[2] != h:  # GQA: expand kv heads to query heads
        rep = h // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = sm_scale if sm_scale is not None else d ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale  # [B,H,T,S+T]
    j = torch.arange(s + t, device=q.device)
    i = torch.arange(t, device=q.device)
    # Key j is visible to query i when it is a valid cache row
    # (j < len[b]) or a causally-earlier new token (j - S <= i).
    mask = torch.where(j[None, None, :] < s,
                       j[None, None, :] < cache_lengths[:, None, None],
                       (j[None, None, :] - s) <= i[None, :, None])
    scores = scores.masked_fill(~mask[:, None], NEG_INF)
    p = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


# ---------------------------------------------------------------------------
# Online-softmax block update (the flash recurrence), shared by ring
# attention: numerically safe when a block is fully masked.
# ---------------------------------------------------------------------------
def blockwise_update(q, k_blk, v_blk, o, l, m, mask=None,
                     sm_scale: Optional[float] = None):
    """One step of the flash-attention recurrence
    (``ray_tpu/ops/attention.py:129``).

    q: [B, Lq, H, D]; k_blk/v_blk: [B, Lk, H, D]; o: [B, Lq, H, D] fp32
    unnormalized accumulator; l: [B, H, Lq] running denominator; m:
    [B, H, Lq] running max; mask: optional [Lq, Lk] bool (True = attend).
    A row masked so far keeps m = NEG_INF and l = 0, o = 0."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk).float() * scale
    if mask is not None:
        s = s.masked_fill(~mask[None, None], NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    p = p.masked_fill(s <= NEG_INF / 2, 0.0)
    l_new = l * corr + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v_blk.dtype), v_blk)
    o_new = o * corr.transpose(1, 2)[..., None].to(o.dtype) + pv
    return o_new, l_new, m_new


def finalize_blockwise(o, l):
    """Normalize the accumulator; fully-masked rows return zeros."""
    denom = l.transpose(1, 2)[..., None]
    return torch.where(denom > 0, o / denom.to(o.dtype).clamp_min(1e-30),
                       torch.zeros((), dtype=o.dtype, device=o.device))


# ---------------------------------------------------------------------------
# Flash attention: the Hopper kernels, their plain versions, and the
# autograd Function that joins the forward to the backward.
# ---------------------------------------------------------------------------
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    return_lse: bool = False):
    """Fused attention, differentiable. q: [B, Lq, H, D], k, v:
    [B, Lk, H, D] -> O [B, Lq, H, D] (and, with ``return_lse``, the fp32
    row log-sum-exp [B*H, Lq], row ``b*H + h``, which carries no
    gradient).

    The causal mask is diagonal-aligned (row >= col), as in the TPU
    kernels.  Raises ``ValueError`` for a length that is not a multiple of
    the kernels' tile (``FLASH_TILE``) and for causal with lq != lk.

    With grad enabled and an input that requires a gradient, the call
    goes through ``_FlashAttention``: the forward also writes the LSE, and
    the backward recomputes P from it (the flash backward).  Otherwise
    only O is computed (and the LSE if asked for), as JAX's primal path
    does.  CPU tensors take the plain versions; CUDA tensors launch
    ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (bf16 or fp32, D in
    {64, 128}, last dimension contiguous) or raise.
    """
    _check_qkv(q, k, v)
    lq, lk = q.shape[1], k.shape[1]
    if lq % FLASH_TILE or lk % FLASH_TILE:
        raise ValueError(f"sequence lengths ({lq},{lk}) must be multiples "
                         f"of the kernel's tile ({FLASH_TILE})")
    if causal and lq != lk:
        # The kernel's causal mask is rows >= cols (self-attention); the
        # plain path bottom-right-aligns the triangle for lq != lk.
        raise ValueError(f"causal flash attention requires lq == lk (got "
                         f"{lq} vs {lk}); use the plain path for "
                         f"decode-style windows")
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    devices = {q.device.type, k.device.type, v.device.type}
    if devices != {"cpu"} and (devices != {"cuda"} or len(
            {q.device, k.device, v.device}) != 1):
        raise ValueError(f"q, k, v must be on one CUDA device or all on the "
                         f"CPU (got {q.device}, {k.device}, {v.device})")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = _FlashAttention.apply(q, k, v, causal, scale)
        return (out, lse) if return_lse else out
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, causal, scale, return_lse)
    return flash_attention_reference(q, k, v, causal, scale, return_lse)


class _FlashAttention(torch.autograd.Function):
    """``_flash``'s custom VJP: the forward saves (q, k, v, O, LSE); the
    backward computes (dq, dk, dv) from them and dO.  On CUDA tensors the
    two passes launch the kernels (``flash_fwd`` with the LSE, then
    ``flash_dq`` and ``flash_dkv``); on CPU tensors they run the plain
    versions, so the CPU tests exercise this glue (LSE, Delta, layout)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if q.is_cuda:
            out, lse = _flash_fwd_cuda(q, k, v, causal, scale, True)
        else:
            out, lse = flash_attention_reference(q, k, v, causal, scale,
                                                 True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, d_out, _d_lse):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = _flash_bwd_cuda if q.is_cuda else \
            flash_attention_backward_reference
        dq, dk, dv = bwd(q, k, v, out, lse, d_out, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def _check_qkv(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, L, H, D]")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or \
            q.shape[2:] != k.shape[2:]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_kernel_operands(**tensors):
    """The kernels' common refusals: one dtype (bf16 or fp32), head_dim 64
    or 128, a contiguous last dimension, and the alignment of the dtype's
    route.  bf16 (the wgmma kernels, fed by TMA): the base pointer
    16-byte aligned and the other strides multiples of 16 bytes (8
    elements).  fp32 (the FMA kernels, 4 elements at a time along D): the
    base pointer and the other strides multiples of 4 elements."""
    dtypes = {x.dtype for x in tensors.values()}
    if len(dtypes) != 1 or not dtypes <= set(_DTYPE_CODES):
        raise ValueError(f"the flash kernels take bf16 or fp32 operands of "
                         f"one dtype (got {sorted(map(str, dtypes))})")
    dtype = dtypes.pop()
    d = next(iter(tensors.values())).shape[-1]
    if d not in (64, 128):
        raise ValueError(f"the flash kernels take head_dim 64 or 128, "
                         f"got {d}")
    if dtype == torch.bfloat16:
        step, rule = 8, ("bf16 (TMA): the base pointer and the other "
                         "strides must be multiples of 16 bytes")
    else:
        step, rule = 4, ("fp32: the base pointer and the other strides "
                         "must be multiples of 4 elements")
    for name, x in tensors.items():
        if x.stride(3) != 1:
            raise ValueError(f"{name}: the last dim must be contiguous "
                             f"(strides {x.stride()})")
        if any(x.stride(i) % step for i in range(3)) or \
                x.data_ptr() % (step * x.element_size()):
            raise ValueError(f"{name}: {rule} (strides {x.stride()}, base "
                             f"pointer {x.data_ptr() % 16} bytes past a "
                             f"16-byte boundary)")


def _raise_on(lib, name, err):
    if err != 0:
        msg = ("arguments the kernel does not take" if err == -1 else
               lib.rtt_cuda_error_string(err).decode())
        raise RuntimeError(f"{name} launch failed ({err}): {msg}")


def _flash_fwd_cuda(q, k, v, causal, scale, return_lse):
    from ray_tpu_torch.ops import _build

    b, lq, h, d = q.shape
    lk = k.shape[1]
    _check_kernel_operands(q=q, k=k, v=v)
    lib = _build.load("flash_fwd")
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, lq), dtype=torch.float32,
                      device=q.device) if return_lse else None
    strides = (ctypes.c_longlong * 9)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rtt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            _DTYPE_CODES[q.dtype], b, h, lq, lk, d, strides, float(scale),
            int(causal), stream)
    _raise_on(lib, "flash_fwd", err)
    LAUNCHES["flash_fwd"] += 1
    return (out, lse) if return_lse else out


def _flash_bwd_cuda(q, k, v, out, lse, d_out, causal, scale):
    """Launch ``rtt_flash_dq`` then ``rtt_flash_dkv`` on the current
    stream; returns new contiguous (dq, dk, dv) [B, L, H, D]."""
    d_out, lse, delta = _bwd_operands(q, k, v, out, lse, d_out, causal)
    dq = _flash_dq_cuda(q, k, v, d_out, lse, delta, causal, scale)
    dk, dv = _flash_dkv_cuda(q, k, v, d_out, lse, delta, causal, scale)
    return dq, dk, dv


def _bwd_operands(q, k, v, out, lse, d_out, causal):
    """Check the backward's operands and return (dO, LSE, Delta) as the
    kernels take them: q, k, v may be strided views (the fused QKV
    output); dO is made contiguous if it is not; Delta = rowsum(dO * O)
    is computed here in fp32, as JAX computes it outside Pallas, laid
    out like the LSE ([B*H, Lq], row b*H + h)."""
    b, lq, h, _ = q.shape
    lk = k.shape[1]
    if lq % FLASH_TILE or lk % FLASH_TILE or (causal and lq != lk):
        raise ValueError(f"the backward kernels take lengths that are "
                         f"multiples of {FLASH_TILE}, and lq == lk when "
                         f"causal (got {lq}, {lk})")
    d_out = d_out.contiguous()
    if d_out.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"dO {tuple(d_out.shape)} and O "
                         f"{tuple(out.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    if len({x.device for x in (q, k, v, out, lse, d_out)}) != 1:
        raise ValueError("q, k, v, O, LSE and dO must be on one CUDA device")
    _check_kernel_operands(q=q, k=k, v=v, dO=d_out)
    lse = lse.float().contiguous()
    if lse.shape != (b * h, lq):
        raise ValueError(f"lse must be [B*H, Lq] = {(b * h, lq)}, got "
                         f"{tuple(lse.shape)}")
    # contiguous(): with B == 1 the reshape is a strided view.
    delta = (d_out.float() * out.float()).sum(-1).transpose(1, 2) \
        .reshape(b * h, lq).contiguous()
    for name, x in (("lse", lse), ("delta", delta)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return d_out, lse, delta


def _bwd_args(q, k, v, d_out, lse, delta, causal, scale):
    """(inputs, shape) arguments of rtt_flash_dq and rtt_flash_dkv."""
    b, lq, h, d = q.shape
    strides = (ctypes.c_longlong * 12)(
        *(x.stride(i) for x in (q, k, v, d_out) for i in range(3)))
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    shape = (_DTYPE_CODES[q.dtype], b, h, lq, k.shape[1], d, strides,
             float(scale), int(causal))
    return inputs, shape


def _flash_dq_cuda(q, k, v, d_out, lse, delta, causal, scale):
    """One launch of ``rtt_flash_dq`` on operands from ``_bwd_operands``."""
    from ray_tpu_torch.ops import _build

    lib = _build.load("flash_bwd")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    inputs, shape = _bwd_args(q, k, v, d_out, lse, delta, causal, scale)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rtt_flash_dq(*inputs, dq.data_ptr(), *shape, stream)
    _raise_on(lib, "flash_dq", err)
    LAUNCHES["flash_dq"] += 1
    return dq


def _flash_dkv_cuda(q, k, v, d_out, lse, delta, causal, scale):
    """One launch of ``rtt_flash_dkv`` on operands from
    ``_bwd_operands``."""
    from ray_tpu_torch.ops import _build

    lib = _build.load("flash_bwd")
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    inputs, shape = _bwd_args(q, k, v, d_out, lse, delta, causal, scale)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rtt_flash_dkv(*inputs, dk.data_ptr(), dv.data_ptr(),
                                *shape, stream)
    _raise_on(lib, "flash_dkv", err)
    LAUNCHES["flash_dkv"] += 1
    return dk, dv


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              sm_scale: Optional[float] = None,
                              return_lse: bool = False):
    """The plain PyTorch version of the flash forward kernel: the same O
    and LSE, with the same diagonal-aligned causal mask, computed in fp32
    over the whole score matrix.  Fully-masked rows give O = 0, as the
    kernel's ``l`` floor does."""
    b, lq, h, d = q.shape
    scale = sm_scale if sm_scale is not None else d ** -0.5
    s = _masked_scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p.masked_fill(s <= NEG_INF / 2, 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l_safe, v.float()).to(q.dtype)
    if not return_lse:
        return out
    lse = (m + torch.log(l_safe))[..., 0].reshape(b * h, lq)
    return out, lse


def _masked_scores(q, k, causal, scale):
    """fp32 S * scale [B, H, Lq, Lk], NEG_INF above the diagonal."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        rows = torch.arange(lq, device=q.device)[:, None]
        cols = torch.arange(lk, device=q.device)[None, :]
        s = s.masked_fill(rows < cols, NEG_INF)
    return s


def flash_attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor, out: torch.Tensor,
                                       lse: torch.Tensor,
                                       d_out: torch.Tensor,
                                       causal: bool = True,
                                       sm_scale: Optional[float] = None):
    """The plain PyTorch version of the two backward kernels: (dq, dk, dv)
    from q, k, v [B, L, H, D], the forward's O, its fp32 LSE [B*H, Lq] and
    dO, over the whole score matrix, with the kernels' rounding points:

    - Delta = rowsum(dO * O) in fp32;
    - P = exp(S * scale - LSE), zeroed where the masked score is
      <= NEG_INF/2 (P is not renormalised);
    - dP = dO V^T;
    - dS = P * (dP - Delta) * scale, rounded to the storage dtype before
      dS K and dS^T Q;
    - dV = P^T dO with P rounded to the storage dtype first;
    - dq, dk, dv returned in q's, k's and v's dtype."""
    b, lq, h, d = q.shape
    scale = sm_scale if sm_scale is not None else d ** -0.5
    dtype = q.dtype
    do32 = d_out.float()
    delta = (do32 * out.float()).sum(-1).transpose(1, 2)[..., None]
    s = _masked_scores(q, k, causal, scale)
    p = torch.exp(s - lse.float().reshape(b, h, lq, 1))
    if causal:
        p = p.masked_fill(s <= NEG_INF / 2, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v.float())
    ds = (p * (dp - delta) * scale).to(dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dtype).float(), do32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
