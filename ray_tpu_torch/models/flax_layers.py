"""Linear and convolution layers that start and pad as flax's do.

The JAX package builds its RL networks from ``flax.linen.Dense`` and
``nn.Conv``.  Two of their defaults differ from PyTorch's, and both matter
to the port:

- Initialisation: flax draws kernels from ``lecun_normal`` (a normal
  truncated at two standard deviations, variance 1 / fan_in, its std
  divided by 0.87962566103423978 so that the truncated draw keeps that
  variance) and sets biases to 0; PyTorch's default is Kaiming-uniform.
  ``dense`` and ``SameConv2d`` skip PyTorch's init and draw flax's from
  the caller's generator, so the port learns from the same starting
  distribution (not the same bits).
- Padding: ``nn.Conv`` pads ``'SAME'``: the output is ceil(in / stride),
  the padding it needs is split with the smaller half before.  At stride
  2 that split is asymmetric (21 -> 11 by a 4x4 kernel pads 1 before and
  2 after), which ``nn.Conv2d``'s symmetric ``padding=`` cannot express.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# The std of a standard normal truncated to [-2, 2].
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``lecun_normal()``: variance scaling 1 / fan_in, truncated
    normal, in place."""
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def dense(in_features: int, out_features: int,
          generator: Optional[torch.Generator] = None,
          bias: bool = True) -> nn.Linear:
    """An ``nn.Linear`` initialised as ``flax.linen.Dense`` is (``bias``
    is its ``use_bias``)."""
    layer = nn.utils.skip_init(nn.Linear, in_features, out_features,
                               bias=bias)
    lecun_normal_(layer.weight, in_features, generator)
    if bias:
        with torch.no_grad():
            layer.bias.zero_()
    return layer


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of one spatial dim under ``'SAME'``, as
    ``lax.padtype_to_pads`` computes it."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` (NCHW) with flax's ``'SAME'`` padding and init."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, device=None):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=0, device=device)

    @classmethod
    def build(cls, in_channels: int, out_channels: int, kernel_size: int,
              stride: int = 1,
              generator: Optional[torch.Generator] = None) -> "SameConv2d":
        """A square-kernel conv initialised as ``nn.Conv`` is (HWIO
        fan_in = kernel² · in_channels)."""
        conv = nn.utils.skip_init(cls, in_channels, out_channels,
                                  kernel_size, stride)
        lecun_normal_(conv.weight, in_channels * kernel_size ** 2, generator)
        with torch.no_grad():
            conv.bias.zero_()
        return conv

    def out_size(self, size: int) -> int:
        return -(-size // self.stride[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = (
            same_padding(n, k, s) for n, k, s in
            zip(x.shape[-2:], self.kernel_size, self.stride))
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            (top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), self.weight,
                        self.bias, self.stride)
