"""The port's Hopper flash-attention kernel against its plain version.

The kernel runs only on an NVIDIA card: it has no CPU mode, so these
tests carry the ``cuda`` marker and skip without one.  The file imports
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
def test_flash_kernel_matches_reference_on_cuda(dtype, tol, causal, d,
                                                fused):
    """The Hopper kernel against its plain version on the card, on
    contiguous q/k/v and on the model's views of a fused QKV output.
    fp32: max |dO| <= 1e-4, for the kernel's own summation order.  bf16:
    in each (b, q, h) row, |dO| <= 2^-5 of the row's largest |O_ref|: the
    kernel rounds P to bf16 before P.V as the TPU kernel does (about 2^-8
    of the row's |O|), and the two bf16 roundings of O can land one ulp
    (2^-7 of the row's largest |O|) apart."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(d)
    qkv = torch.randn(2, 256, 3 * 4 * d, device="cuda",
                      generator=gen).to(dtype)
    q, k, v = (x.reshape(2, 256, 4, d) for x in qkv.split(4 * d, dim=-1))
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
    with pytest.raises(NotImplementedError):
        tattn.flash_attention(q.detach().requires_grad_(), k, v,
                              causal=causal)
