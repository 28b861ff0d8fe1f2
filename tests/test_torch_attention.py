"""The port's attention ops against the JAX package's.

The same inputs, made with numpy from a seed, go through the JAX function
and its PyTorch counterpart.  The Pallas flash kernel runs in interpret
mode, as tests/test_flash_attention.py runs it on the CPU.  Every
comparison is in fp32; the tolerance 1e-5 covers the different
summation orders of two fp32 implementations of the same sums.  The
Hopper kernel itself runs only on a card
(``tests/test_torch_flash_kernel.py``)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn

ATOL = 1e-5  # fp32: summation order differs between XLA and PyTorch


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("length,d", [(128, 64), (256, 64), (256, 128)])
def test_flash_reference_matches_pallas_kernel(causal, length, d):
    """flash_attention_reference (what the port's flash_attention runs on
    CPU tensors) == the Pallas kernel in interpret mode: O, and the LSE of
    _flash_fwd(with_lse=True)."""
    b, h = 2, 2
    (jq, jk, jv), (tq, tk, tv) = _both(_arrays(
        length + d, *[(b, length, h, d)] * 3))
    o_j = jattn.flash_attention(jq, jk, jv, causal=causal, interpret=True)
    bq, bk = jattn._auto_blocks(length, length)
    _, lse_j, _ = jattn._flash_fwd(jq, jk, jv, causal, None, bq, bk, True,
                                   with_lse=True)
    launches = tattn.LAUNCHES["flash_fwd"]
    o_t, lse_t = tattn.flash_attention(tq, tk, tv, causal=causal,
                                       return_lse=True)
    assert tattn.LAUNCHES["flash_fwd"] == launches  # CPU: no kernel
    assert lse_t.shape == (b * h, length)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=ATOL)


@pytest.mark.parametrize("lq,lk", [(128, 256), (256, 128)])
def test_flash_reference_noncausal_unequal_lengths(lq, lk):
    """Non-causal lq != lk, including lq > lk (the case the TPU kernel's
    clamped loop bound protects)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_arrays(
        lq * 3 + lk, (1, lq, 2, 64), (1, lk, 2, 64), (1, lk, 2, 64)))
    o_j = jattn.flash_attention(jq, jk, jv, causal=False, interpret=True)
    o_t = tattn.flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL)


@pytest.mark.parametrize("causal,lq,lk", [(True, 16, 16), (False, 16, 16),
                                          (True, 4, 12), (False, 5, 9)])
def test_plain_attention_matches_xla(causal, lq, lk):
    """_plain_attention == _xla_attention, including the bottom-right
    aligned causal mask for lq != lk."""
    (jq, jk, jv), (tq, tk, tv) = _both(_arrays(
        lq + 7 * lk, (2, lq, 3, 8), (2, lk, 3, 8), (2, lk, 3, 8)))
    o_j = jattn._xla_attention(jq, jk, jv, causal, None)
    o_t = tattn._plain_attention(tq, tk, tv, causal, None)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL)


@pytest.mark.parametrize("t,s,h,hkv", [(1, 8, 4, 4), (3, 8, 4, 4),
                                       (2, 8, 4, 2), (5, 0, 4, 4),
                                       (5, 0, 4, 2)])
def test_cached_attention_matches_jax(t, s, h, hkv):
    """Padded caches (rows past each length hold garbage), multi-token
    windows, GQA (Hkv < H) and S == 0 (plain causal self-attention)."""
    b, d = 2, 8
    arrays = _arrays(t * 100 + s * 10 + hkv, (b, t, h, d), (b, t, hkv, d),
                     (b, t, hkv, d), (b, s, hkv, d), (b, s, hkv, d))
    lengths = np.array([min(3, s), s], np.int32)
    (jq, jkn, jvn, jkc, jvc), (tq, tkn, tvn, tkc, tvc) = _both(arrays)
    o_j = jattn.cached_attention(jq, jkn, jvn, jkc, jvc,
                                 jnp.asarray(lengths))
    o_t = tattn.cached_attention(tq, tkn, tvn, tkc, tvc,
                                 torch.from_numpy(lengths).long())
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL)


def test_mha_attention_on_cpu_takes_plain_path():
    """At a length where CUDA tensors would go to the kernel (1024), CPU
    tensors take the plain path: same result as _plain_attention, no
    kernel launch."""
    (_, _, _), (tq, tk, tv) = _both(_arrays(5, *[(1, 1024, 1, 64)] * 3))
    launches = tattn.LAUNCHES["flash_fwd"]
    out = tattn.mha_attention(tq, tk, tv, causal=True)
    assert tattn.LAUNCHES["flash_fwd"] == launches
    assert torch.equal(out, tattn._plain_attention(tq, tk, tv, True, None))


def test_flash_attention_refusals():
    """Both refusals of the JAX flash_attention stay ValueErrors: a
    length that is not a multiple of the tile, and causal with lq != lk."""
    q = torch.zeros(1, 96, 2, 64)
    with pytest.raises(ValueError, match="multiples"):
        tattn.flash_attention(q, q, q, causal=False)
    q, k = torch.zeros(1, 128, 2, 64), torch.zeros(1, 256, 2, 64)
    with pytest.raises(ValueError, match="lq == lk"):
        tattn.flash_attention(q, k, k, causal=True)
