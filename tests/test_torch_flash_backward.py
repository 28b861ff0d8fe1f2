"""The port's flash-attention backward against the JAX package's.

The same inputs, made with numpy from a seed, go through the JAX function
and its PyTorch counterpart on the CPU.  The Pallas kernels run in
interpret mode, as tests/test_flash_attention.py runs them.  On CPU
tensors the port's ``_FlashAttention`` runs the plain versions of the
kernels (``flash_attention_reference`` with the LSE, then
``flash_attention_backward_reference``), so these tests hold the
Function's glue (the saved LSE, Delta, the [B*H, L] layout) and the
plain backward, which the Hopper kernels are held against on the card
(``tests/test_torch_flash_kernel.py`` and ``chip_smoke.py``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn

# fp32: two implementations of the same fp32 sums in different orders.
# Gradients here are O(1-10) and sum over up to 256 keys or queries, so
# 1e-5 absolute plus 1e-5 relative holds with margin (measured <= 2.4e-6).
ATOL = RTOL = 1e-5
# bf16, per (b, l, h) row: |dX - dX_jax| <= 2^-5 of the row's largest
# |dX_jax|.  Both sides round dS (and P for dV) to bf16 at the same points
# and then round the fp32 result to bf16, where two fp32 values a few
# ulps apart can land one bf16 ulp (at most 2^-7 of the row's largest
# value) apart; the bound is four such ulps.  A row whose gradient
# cancels to ~0 (the first causal row of dq: P = 1 and dP = Delta up to
# rounding) has only rounding noise, so its denominator is floored at
# 2^-8 of the tensor's largest |dX_jax|.
BF16_ROW_REL = 2.0 ** -5
# And at least 99% of the bf16 elements are bitwise equal: they differ
# only where the two summation orders straddle a rounding boundary
# (~0.1% of elements measured), while a rounding point moved (dS or P
# kept in fp32) changes ~40% of them.
BF16_EQUAL_FRACTION = 0.99


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _fold(x):
    """[B, L, H, D] -> [B*H, L, D], as _flash_fwd folds its inputs."""
    b, l, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, l, d)


def _unfold(x, b):
    """[B*H, L, D] -> [B, L, H, D] as float32 numpy."""
    x = np.asarray(x.astype(jnp.float32))
    bh, l, d = x.shape
    return np.array(x.reshape(b, bh // b, l, d).transpose(0, 2, 1, 3))


def _bf16_row_error(got, want):
    diff = np.abs(got - want)
    row = np.abs(want).max(-1, keepdims=True)
    floor = 2.0 ** -8 * np.abs(want).max()
    return (diff / np.maximum(row, floor)).max()


def _jax_grads(q, k, v, causal):
    def loss(q, k, v):
        return jnp.sum(jnp.sin(jattn.flash_attention(
            q, k, v, causal=causal, interpret=True)))

    return jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("causal,lq,lk,d", [
    (True, 128, 128, 64), (False, 128, 128, 64),
    (True, 256, 256, 64), (False, 256, 256, 64),
    (True, 256, 256, 128), (False, 256, 256, 128),
    (False, 128, 256, 64), (False, 256, 128, 64)])
def test_flash_gradients_match_jax(causal, lq, lk, d):
    """d/d(q, k, v) of sum(sin(O)) through the port's flash_attention (the
    _FlashAttention Function on CPU tensors) == jax.grad of the JAX
    package's flash_attention in interpret mode, including non-causal
    lq != lk each way."""
    b, h = 2, 2
    q, k, v = _arrays(lq + 3 * lk + d, (b, lq, h, d), (b, lk, h, d),
                      (b, lk, h, d))
    want = _jax_grads(q, k, v, causal)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = dict(tattn.LAUNCHES)
    out = tattn.flash_attention(tq, tk, tv, causal=causal)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    torch.sin(out).sum().backward()
    assert tattn.LAUNCHES == before  # CPU tensors: no kernel
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=RTOL, err_msg=f"d{name}")


def _jax_backward(q, k, v, do, causal, dtype):
    """JAX's _flash_fwd (with the LSE) and _flash_bwd in interpret mode on
    the same inputs: (O, LSE, dO) as the port takes them, and (dq, dk, dv)
    [B, L, H, D] float32."""
    b, length = q.shape[:2]
    jq, jk, jv, jdo = (jnp.asarray(x).astype(dtype) for x in (q, k, v, do))
    bq, bk = jattn._auto_blocks(length, length)
    out, lse, (qf, kf, vf) = jattn._flash_fwd(jq, jk, jv, causal, None, bq,
                                              bk, True, with_lse=True)
    grads = jattn._flash_bwd(qf, kf, vf, out, lse, _fold(jdo), causal, None,
                             bq, bk, True)
    inputs = [_unfold(_fold(x), b) for x in (jq, jk, jv)]
    inputs += [_unfold(out, b), np.array(lse), _unfold(_fold(jdo), b)]
    return inputs, [_unfold(g, b) for g in grads]


def _torch(x, dtype):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_backward_reference_matches_pallas_kernels(causal, d):
    """flash_attention_backward_reference == JAX's _flash_bwd (the dq and
    dkv Pallas kernels, interpret mode) on the same O, LSE and dO: the
    exact function the Hopper kernels compute."""
    b, h, length = 2, 2, 256
    arrays = _arrays(d + causal, *[(b, length, h, d)] * 4)
    (q, k, v, out, lse, do), want = _jax_backward(*arrays, causal,
                                                  jnp.float32)
    got = tattn.flash_attention_backward_reference(
        *(torch.from_numpy(x) for x in (q, k, v, out, lse, do)), causal)
    for g, ref, name in zip(got, want, "qkv"):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), ref, atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")


# D = 64 keeps the ids the test had before D = 128 was added.
@pytest.mark.parametrize("causal,d", [
    pytest.param(True, 64, id="True"), pytest.param(False, 64, id="False"),
    pytest.param(True, 128, id="True-128"),
    pytest.param(False, 128, id="False-128")])
def test_backward_reference_matches_pallas_kernels_bf16(causal, d):
    """The same pair in bf16: the rounding points (dS to bf16 before dS K
    and dS^T Q, P to bf16 before P^T dO, the outputs in bf16) match the
    TPU kernels'.  D = 128 is the Hopper kernels' two-slab case (a head
    row spans two 64-column swizzled slabs).  Bounds: see BF16_ROW_REL
    and BF16_EQUAL_FRACTION."""
    b, h, length = 2, 2, 256
    arrays = _arrays(7 + causal + (d != 64) * 64, *[(b, length, h, d)] * 4)
    (q, k, v, out, lse, do), want = _jax_backward(*arrays, causal,
                                                  jnp.bfloat16)
    bf = torch.bfloat16
    got = tattn.flash_attention_backward_reference(
        _torch(q, bf), _torch(k, bf), _torch(v, bf), _torch(out, bf),
        torch.from_numpy(np.array(lse)), _torch(do, bf), causal)
    for g, ref, name in zip(got, want, "qkv"):
        assert g.dtype == bf
        g = g.float().numpy()
        assert _bf16_row_error(g, ref) <= BF16_ROW_REL, f"d{name}"
        assert (g == ref).mean() >= BF16_EQUAL_FRACTION, f"d{name}"


@pytest.mark.parametrize("causal,lq,lk", [(True, 128, 128),
                                          (False, 128, 128),
                                          (False, 128, 256),
                                          (False, 256, 128)])
def test_backward_reference_matches_torch_autograd(causal, lq, lk):
    """flash_attention_backward_reference (P recomputed from the LSE)
    == torch.autograd through flash_attention_reference (the plain
    forward), in fp32: a check that does not share the LSE-recompute
    design."""
    b, h, d = 2, 2, 64
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(
        lq + lk + causal, (b, lq, h, d), (b, lk, h, d), (b, lk, h, d),
        (b, lq, h, d)))
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    out = tattn.flash_attention_reference(qs, ks, vs, causal=causal)
    out.backward(do)
    with torch.no_grad():
        o, lse = tattn.flash_attention_reference(q, k, v, causal=causal,
                                                 return_lse=True)
    got = tattn.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                   causal)
    for g, ref, name in zip(got, (qs.grad, ks.grad, vs.grad), "qkv"):
        np.testing.assert_allclose(g.numpy(), ref.numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=f"d{name}")


def test_no_grad_path_skips_the_function_and_the_lse():
    """Without a gradient to take, flash_attention computes O alone, as
    JAX's primal path does; return_lse on the gradient path returns an
    LSE that carries no gradient."""
    q, k, v = (torch.from_numpy(x) for x in _arrays(3, *[(1, 128, 2, 64)]
                                                    * 3))
    out = tattn.flash_attention(q, k, v)
    assert out.grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert tattn.flash_attention(qg, k, v).grad_fn is None
    out, lse = tattn.flash_attention(qg, k, v, return_lse=True)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    assert not lse.requires_grad
    torch.testing.assert_close(out, tattn.flash_attention_reference(
        q, k, v), rtol=0, atol=0)


@pytest.mark.parametrize("b", [1, 2])
def test_backward_operands_are_laid_out_for_the_kernels(b):
    """What the CUDA wrapper hands the backward kernels, checked on CPU
    tensors: dO made contiguous, LSE and Delta = rowsum(dO * O)
    contiguous fp32 [B*H, Lq] with row b*H + h (B == 1 included, where a
    reshape alone would leave a strided view), and the refusals."""
    h, length, d = 3, 128, 64
    qkv, o, do = (torch.from_numpy(x) for x in _arrays(
        b, (b, length, 3 * h * d), (b, length, h, d), (b, length, h, d)))
    q, k, v = (x.reshape(b, length, h, d) for x in qkv.split(h * d, -1))
    lse = torch.from_numpy(_arrays(b + 1, (b * h, length))[0])
    d_out, lse_k, delta = tattn._bwd_operands(
        q, k, v, o, lse, do.transpose(1, 2).contiguous().transpose(1, 2),
        True)
    assert d_out.is_contiguous() and torch.equal(d_out, do)
    assert lse_k.is_contiguous() and torch.equal(lse_k, lse)
    assert delta.is_contiguous() and delta.shape == (b * h, length)
    want = (do * o).sum(-1)  # [B, L, H]
    for bi in range(b):
        for hi in range(h):
            torch.testing.assert_close(delta[bi * h + hi], want[bi, :, hi])
    with pytest.raises(ValueError, match="head_dim"):
        tattn._bwd_operands(q[..., :32], k[..., :32], v[..., :32],
                            o[..., :32], lse, do[..., :32], True)
    with pytest.raises(ValueError, match="multiples"):
        tattn._bwd_operands(q[:, :96], k[:, :96], v[:, :96], o[:, :96],
                            lse[:, :96], do[:, :96], True)
    with pytest.raises(ValueError, match="one dtype"):
        tattn._bwd_operands(q, k.double(), v, o, lse, do, True)
    with pytest.raises(ValueError, match="lse"):
        tattn._bwd_operands(q, k, v, o, lse[:, :64], do, True)
