"""What the port's kernel wrappers accept before a launch, and the build's
cache key.  Both are plain Python around the CUDA kernels, so they run
here on CPU tensors, without a card or nvcc.  JAX-free."""
import shutil

import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as tattn


def _fused_qkv(d, dtype, b=2, length=128, h=12):
    """GPT-2's q, k, v: the split thirds of one [B, L, 3*H*D] output."""
    qkv = torch.zeros(b, length, 3 * h * d, dtype=dtype)
    return [x.reshape(b, length, h, d) for x in qkv.split(h * d, dim=-1)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
def test_accepts_gpt2_fused_qkv_views(d, dtype):
    """The model's views (k and v start H*D elements in, the L stride is
    3*H*D) meet both routes' rules, so training never copies them."""
    q, k, v = _fused_qkv(d, dtype)
    tattn._check_kernel_operands(q=q, k=k, v=v)
    tattn._check_kernel_operands(q=q, k=k, v=v, dO=q.contiguous())


def test_refuses_bf16_view_offset_by_four_elements():
    """4 bf16 elements are 8 bytes: the FMA route took that, TMA does
    not, so the wrapper raises before the launch and names the rule."""
    buf = torch.zeros(1, 128, 12 * 64 + 4, dtype=torch.bfloat16)
    q = buf[..., 4:].reshape(1, 128, 12, 64)
    assert q.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="bf16 .TMA.*16 bytes"):
        tattn._check_kernel_operands(q=q, k=q, v=q)


def test_refuses_bf16_stride_off_sixteen_bytes():
    """An L stride of 3*H*D + 4 elements (8 bytes past a multiple of 16)
    is refused in bf16; the base pointer alone is not the whole rule."""
    buf = torch.zeros(1, 128, 3 * 12 * 64 + 4, dtype=torch.bfloat16)
    q = buf[..., :12 * 64].unflatten(-1, (12, 64))
    assert q.stride(1) % 8 == 4 and q.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        tattn._check_kernel_operands(q=q, k=q, v=q)


def test_fp32_keeps_the_four_element_rule():
    """The fp32 FMA route reads 4 elements (16 bytes) at a time: a view 4
    elements in passes, one 2 elements in is refused with the fp32 rule."""
    buf = torch.zeros(1, 128, 12 * 64 + 4, dtype=torch.float32)
    ok = buf[..., 4:].unflatten(-1, (12, 64))
    tattn._check_kernel_operands(q=ok, k=ok, v=ok)
    bad = buf[..., 2:2 + 12 * 64].unflatten(-1, (12, 64))
    with pytest.raises(ValueError, match="fp32: .*4 elements"):
        tattn._check_kernel_operands(q=bad, k=bad, v=bad)


def test_refuses_strided_last_dim():
    q = torch.zeros(1, 128, 12, 128, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="last dim must be contiguous"):
        tattn._check_kernel_operands(q=q, k=q, v=q)


def test_both_sources_include_the_sm90_header():
    for name in _build.SIGNATURES:
        assert [p.name for p in _build.included_headers(name)] == \
            ["sm90.cuh"], name


def test_digest_follows_source_and_headers(tmp_path):
    """The build's cache key changes when the source or a header it
    includes changes, and only then: an edited header rebuilds."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    names = list(_build.SIGNATURES)
    before = {n: _build.source_digest(n, csrc) for n in names}
    assert before == {n: _build.source_digest(n, _build.CSRC)
                      for n in names}
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.source_digest(n, csrc) for n in names}
    assert all(after[n] != before[n] for n in names)
    src = csrc / "flash_fwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.source_digest("flash_fwd", csrc) != after["flash_fwd"]
    assert _build.source_digest("flash_bwd", csrc) == after["flash_bwd"]
