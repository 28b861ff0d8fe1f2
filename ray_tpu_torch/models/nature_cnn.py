"""Pixel trunks for RL (counterpart of ``ray_tpu/models/nature_cnn.py``).

Both take NHWC frames ``[B, H, W, C]``, as the JAX package's envs give
them, copy them once at the entry into NCHW-contiguous fp32 memory, and
run the convolutions on contiguous NCHW tensors: cuDNN's fp32 kernels
are NCHW, and on a channels-last view they transpose every operand to
NCHW and back.  The flattened features are in NHWC order (h, w, c), as
``x.reshape((B, -1))`` flattens them in flax, so converted Dense kernels
line up row for row; that flatten copies the last activation once.

``NatureCNN`` on 84x84 frames: three ``'SAME'`` convs, 84 -> 21 (8x8
stride 4, padded 2/2), 21 -> 11 (4x4 stride 2, padded 1/2), 11 -> 11 (3x3,
padded 1/1), so the Dense takes 11 * 11 * 64 = 7744 features, not the
3136 of an unpadded Nature CNN.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.flax_layers import SameConv2d, dense


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC frames (any dtype) -> NCHW-contiguous fp32, cast and copied in
    one pass."""
    return x.permute(0, 3, 1, 2).to(torch.float32,
                                    memory_format=torch.contiguous_format)


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class NatureCNN(nn.Module):
    """Nature-DQN trunk.  uint8 frames are divided by 255 on entry."""

    def __init__(self, obs_shape: Sequence[int], out_dim: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, w, c = obs_shape
        self.conv_0 = SameConv2d.build(c, 32, 8, 4, generator)
        self.conv_1 = SameConv2d.build(32, 64, 4, 2, generator)
        self.conv_2 = SameConv2d.build(64, 64, 3, 1, generator)
        for conv in (self.conv_0, self.conv_1, self.conv_2):
            h, w = conv.out_size(h), conv.out_size(w)
        self.flat_dim = h * w * 64
        self.dense_0 = dense(self.flat_dim, out_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, C] uint8 or float -> [B, out_dim]."""
        scale = x.dtype == torch.uint8
        x = _nchw(x)
        if scale:
            x = x / 255.0
        x = F.relu(self.conv_0(x))
        x = F.relu(self.conv_1(x))
        x = F.relu(self.conv_2(x))
        return F.relu(self.dense_0(_flatten_nhwc(x)))


class MinAtarCNN(nn.Module):
    """Small-board trunk (10x10-class boards): one 3x3 ``'SAME'`` conv and
    a Dense.  As in the JAX package, its input is cast, not scaled."""

    def __init__(self, obs_shape: Sequence[int], out_dim: int = 128,
                 features: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, w, c = obs_shape
        self.conv_0 = SameConv2d.build(c, features, 3, 1, generator)
        self.dense_0 = dense(h * w * features, out_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv_0(_nchw(x)))
        return F.relu(self.dense_0(_flatten_nhwc(x)))
