"""Elementwise/normalization building blocks (counterpart of
``ray_tpu/ops/layers.py``).  Plain PyTorch: these run outside any
kernel in the JAX package too.  The JAX module's ``rms_norm`` and its
interleaved-pair ``rope`` have no caller there (its Llama carries its own
RMSNorm and rotate-half rope, ported in ``models/llama.py``), so they are
not ported."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, as ``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh")


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Two-pass LayerNorm computed in fp32 and cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dtype)
