"""The port's Hopper flash-attention kernels against their plain versions.

The kernels (the forward, and the dq and dkv backward) run only on an
NVIDIA card: they have no CPU mode, so these tests carry the ``cuda``
marker and skip without one.  The file imports
no JAX, so it also runs on a machine with a card and no JAX:
``python -m pytest tests/test_torch_flash_kernel.py -m cuda -q``."""
import pytest
import torch

from ray_tpu_torch.ops import attention as tattn


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -5)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("b,length", [(2, 256), (1, 192), (1, 320)])
def test_flash_kernel_matches_reference_on_cuda(dtype, tol, causal, d,
                                                fused, b, length):
    """The Hopper kernel against its plain version on the card, on
    contiguous q/k/v and on the model's views of a fused QKV output, at
    L = 256 and at lengths that are odd multiples of the 64-row tile (3
    and 5 tiles, B = 1), which no tile of the kernels may round up.
    fp32: max |dO| <= 1e-4, for the kernel's own summation order.  bf16:
    in each (b, q, h) row, |dO| <= 2^-5 of the row's largest |O_ref|: the
    kernel rounds P to bf16 before P.V as the TPU kernel does (about 2^-8
    of the row's |O|), and the two bf16 roundings of O can land one ulp
    (2^-7 of the row's largest |O|) apart."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(d)
    qkv = torch.randn(b, length, 3 * 4 * d, device="cuda",
                      generator=gen).to(dtype)
    q, k, v = (x.reshape(b, length, 4, d)
               for x in qkv.split(4 * d, dim=-1))
    if not fused:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    with torch.no_grad():
        o, lse = tattn.flash_attention(q, k, v, causal=causal,
                                       return_lse=True)
        o_r, lse_r = tattn.flash_attention_reference(q, k, v, causal=causal,
                                                     return_lse=True)
    torch.cuda.synchronize()
    diff = (o.float() - o_r.float()).abs()
    if dtype == torch.bfloat16:
        diff = diff / o_r.float().abs().amax(-1, keepdim=True)
    assert diff.max().item() <= tol
    assert (lse - lse_r).abs().max().item() <= 1e-4
    # An input that requires a gradient goes through the autograd
    # Function (the backward kernels), not a refusal.
    out = tattn.flash_attention(q.detach().requires_grad_(), k, v,
                                causal=causal)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"


def _bwd_error(g, ref):
    """fp32: max |dX|.  bf16: |dX| over the largest |dX_ref| of its row,
    that denominator floored at 2^-8 of the tensor's largest |dX_ref| (a
    row that cancels to ~0, such as dq's first causal row, holds only
    rounding noise)."""
    diff = (g.float() - ref.float()).abs()
    if g.dtype == torch.float32:
        return diff.max().item()
    ref = ref.float().abs()
    row = ref.amax(-1, keepdim=True).clamp_min(2.0 ** -8 * ref.max())
    return (diff / row).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -5)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("length", [256, 192, 320])
def test_flash_backward_kernels_match_reference_on_cuda(dtype, tol, causal,
                                                        d, fused, b, length):
    """The dq and dkv kernels, through _FlashAttention's backward, against
    flash_attention_backward_reference on the same (q, k, v, O, LSE, dO),
    on contiguous q/k/v and on the views of a fused QKV output, at B = 1
    and 2 (B = 1 lays Delta out through another reshape), at L = 256 and
    at 3 and 5 tiles.  fp32:
    max |dX| <= 1e-4 (summation order).  bf16: |dX| <= 2^-5 of its row's
    largest |dX_ref| (both round dS and P to bf16 at the same points; the
    bf16 outputs can land one ulp, 2^-7 of the row's largest value,
    apart)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(d + 1)
    qkv = torch.randn(b, length, 3 * 4 * d, device="cuda",
                      generator=gen).to(dtype)
    q, k, v = (x.reshape(b, length, 4, d)
               for x in qkv.split(4 * d, dim=-1))
    if not fused:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    d_out = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    before = dict(tattn.LAUNCHES)
    out, lse = tattn.flash_attention(qg, kg, vg, causal=causal,
                                     return_lse=True)
    out.backward(d_out)
    assert tattn.LAUNCHES["flash_dq"] == before["flash_dq"] + 1
    assert tattn.LAUNCHES["flash_dkv"] == before["flash_dkv"] + 1
    with torch.no_grad():
        want = tattn.flash_attention_backward_reference(
            q, k, v, out.detach(), lse, d_out, causal)
    torch.cuda.synchronize()
    for g, ref in zip((qg.grad, kg.grad, vg.grad), want):
        assert g.dtype == dtype and g.shape == ref.shape
        assert _bwd_error(g, ref) <= tol


@pytest.mark.cuda
def test_bf16_routes_are_the_tensor_core_kernels_on_cuda():
    """The C entries route every bf16 kernel (forward, dq, dkv) to its
    wgmma kernel and every fp32 kernel to its FMA kernel; a step in each
    dtype launches each kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from ray_tpu_torch.ops import _build
    libs = {"flash_fwd": _build.load("flash_fwd"),
            "flash_dq": _build.load("flash_bwd"),
            "flash_dkv": _build.load("flash_bwd")}
    routes = {(name, str(dtype)[6:]):
              getattr(lib, f"rtt_{name}_route")(code).decode()
              for name, lib in libs.items()
              for dtype, code in tattn._DTYPE_CODES.items()}
    assert routes == {
        ("flash_fwd", "bfloat16"): "wgmma", ("flash_fwd", "float32"): "fma",
        ("flash_dq", "bfloat16"): "wgmma", ("flash_dq", "float32"): "fma",
        ("flash_dkv", "bfloat16"): "wgmma", ("flash_dkv", "float32"): "fma"}
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.randn(1, 128, 3 * 2 * 64, device="cuda").to(dtype)
        leaves = [x.reshape(1, 128, 2, 64).detach().requires_grad_()
                  for x in qkv.split(2 * 64, dim=-1)]
        before = dict(tattn.LAUNCHES)
        tattn.flash_attention(*leaves, causal=True).float().sum().backward()
        torch.cuda.synchronize()
        assert {n: tattn.LAUNCHES[n] - before[n] for n in before} == {
            "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_dq_is_bitwise_deterministic_on_cuda(causal, d):
    """Two launches of the bf16 dq kernel on the same operands give
    bitwise-equal dq: each dQ tile has one writer that sums its K tiles in
    a fixed order (no atomics), which a design that accumulated dQ from
    several blocks would lose."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(d + 2)
    qkv = torch.randn(2, 320, 3 * 4 * d, device="cuda",
                      generator=gen).to(torch.bfloat16)
    q, k, v = (x.reshape(2, 320, 4, d) for x in qkv.split(4 * d, dim=-1))
    d_out = torch.randn(q.shape, device="cuda",
                        generator=gen).to(torch.bfloat16)
    scale = d ** -0.5
    with torch.no_grad():
        out, lse = tattn._flash_fwd_cuda(q, k, v, causal, scale, True)
        ops = tattn._bwd_operands(q, k, v, out, lse, d_out, causal)
        first = tattn._flash_dq_cuda(q, k, v, *ops, causal, scale)
        second = tattn._flash_dq_cuda(q, k, v, *ops, causal, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(first.float()).all()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))
