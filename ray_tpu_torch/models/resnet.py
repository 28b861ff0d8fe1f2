"""ResNet family in PyTorch: ResNet-18/50 and the CIFAR stem variant
(counterpart of ``ray_tpu/models/resnet.py``).

For the Train configuration "ResNet-50 on CIFAR-10 (train_loop_per_worker)"
(BASELINE.json).  The numerics follow the flax model, so that converted
weights (``convert.resnet_params_from_jax``) give the same logits, loss,
gradients and batch statistics:

- the input is NHWC, as in JAX; inside, tensors are NCHW views of
  channels-last memory;
- convolutions run in ``config.dtype`` (bf16 by default) over fp32
  weights, with flax's ``"SAME"`` padding, which is asymmetric for a
  strided conv on an even input (a 3x3 stride-2 conv pads 0 before and
  1 after; the 7x7 stride-2 stem at 224 pads 2 and 3): the padding is
  explicit, ``nn.Conv2d``'s symmetric one would give another result.
  The stem's 3x3 stride-2 ``max_pool`` pads the same way with -inf;
- ``BatchNorm`` is flax's (momentum 0.9, epsilon 1e-5, fp32): batch
  statistics with the one-pass variance ``max(E[x^2] - E[x]^2, 0)``, and
  the running variance updated with that **biased** variance (torch's
  ``BatchNorm2d`` would take the unbiased one).  In train mode the
  forward updates the running buffers in place, as torch's BatchNorm
  does; ``resnet_loss_fn`` returns them;
- the last BN of each block starts with a zero scale, and BN and the head
  run in fp32;
- ``ResNet(config, generator)`` draws flax's initializers from a CPU
  ``torch.Generator`` (lecun-normal conv and head kernels, zero biases).

Plain PyTorch: the JAX module has no Pallas kernel, so the convolutions
are cuDNN's through ``F.conv2d``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)  # resnet50
    num_classes: int = 10
    num_filters: int = 64
    bottleneck: bool = True
    cifar_stem: bool = False  # 3x3 stem, no maxpool (32x32 inputs)
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def resnet18(cls, **kw):
        return cls(stage_sizes=(2, 2, 2, 2), bottleneck=False, **kw)

    @classmethod
    def resnet50(cls, **kw):
        return cls(**kw)

    @classmethod
    def resnet50_cifar(cls, **kw):
        return cls(cifar_stem=True, **kw)

    @classmethod
    def tiny(cls, **kw):
        return cls(stage_sizes=(1, 1), bottleneck=False, num_filters=8,
                   cifar_stem=True, **kw)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``"SAME"`` padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int,
              value: float = 0.0) -> torch.Tensor:
    top, bottom = same_pads(x.shape[2], kernel, stride)
    left, right = same_pads(x.shape[3], kernel, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator):
    """flax's lecun_normal: truncated normal (2 std) of variance
    1/fan_in (a conv's fan-in is in * kh * kw)."""
    std = (1.0 / w[0].numel()) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False, padding="SAME", dtype=dtype)``: a
    kernel [out, in, k, k] (HWIO -> OIHW of flax's), input and kernel
    cast to ``dtype``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.kernel, self.stride, self.dtype = kernel, stride, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pad_same(x.to(self.dtype), self.kernel, self.stride)
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)``
    over NCHW: ``weight``/``bias`` are flax's ``scale``/``bias``,
    ``running_mean``/``running_var`` its ``batch_stats`` ``mean``/``var``."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, zero_scale: bool = False):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.full((features,),
                                              0.0 if zero_scale else 1.0))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            mean = x.mean((0, 2, 3))
            var = ((x * x).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]


class ResNetBlock(nn.Module):
    """A basic or bottleneck block with flax's auto-names: ``conv_{j}`` and
    ``bn_{j}`` are ``Conv_{j}`` and ``BatchNorm_{j}``, the projection of
    the residual (when the shape changes) the last pair."""

    def __init__(self, cin: int, filters: int, stride: int, bottleneck: bool,
                 dtype: torch.dtype):
        super().__init__()
        if bottleneck:
            shapes = ((cin, filters, 1, 1), (filters, filters, 3, stride),
                      (filters, 4 * filters, 1, 1))
            out = 4 * filters
        else:
            shapes = ((cin, filters, 3, stride), (filters, filters, 3, 1))
            out = filters
        self.n = len(shapes)
        for j, (a, b, k, s) in enumerate(shapes):
            setattr(self, f"conv_{j}", Conv(a, b, k, s, dtype))
            setattr(self, f"bn_{j}", BatchNorm(b, zero_scale=j == self.n - 1))
        self.project = cin != out or stride != 1
        if self.project:
            setattr(self, f"conv_{self.n}", Conv(cin, out, 1, stride, dtype))
            setattr(self, f"bn_{self.n}", BatchNorm(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for j in range(self.n):
            y = getattr(self, f"bn_{j}")(getattr(self, f"conv_{j}")(y))
            if j < self.n - 1:
                y = F.relu(y)
        residual = x
        if self.project:
            residual = getattr(self, f"bn_{self.n}")(
                getattr(self, f"conv_{self.n}")(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """``forward(images [B, H, W, C]) -> logits [B, classes]`` fp32.
    ``train()``/``eval()`` select the batch or the running statistics
    (flax's ``train=True``/``False``)."""

    def __init__(self, config: ResNetConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        self.config = c
        self.stem = Conv(3, c.num_filters, 3 if c.cifar_stem else 7,
                         1 if c.cifar_stem else 2, c.dtype)
        self.stem_bn = BatchNorm(c.num_filters)
        blocks, cin = [], c.num_filters
        for i, n_blocks in enumerate(c.stage_sizes):
            for j in range(n_blocks):
                filters = c.num_filters * 2 ** i
                blocks.append(ResNetBlock(cin, filters,
                                          2 if i > 0 and j == 0 else 1,
                                          c.bottleneck, c.dtype))
                cin = 4 * filters if c.bottleneck else filters
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, c.num_classes)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        gen = generator or torch.Generator().manual_seed(0)
        for module in self.modules():
            if isinstance(module, Conv):
                w = torch.empty(module.weight.shape)
                _lecun_normal_(w, gen)
                module.weight.copy_(w)
        w = torch.empty(self.head.weight.shape)
        _lecun_normal_(w, gen)
        self.head.weight.copy_(w)
        self.head.bias.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        c = self.config
        x = images.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        x = F.relu(self.stem_bn(self.stem(x)))
        if not c.cifar_stem:
            x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
        for block in self.blocks:
            x = block(x)
        x = x.float().mean((2, 3))
        return F.linear(x, self.head.weight.float(), self.head.bias.float())


def batch_stats(model: ResNet) -> Dict[str, torch.Tensor]:
    """The running statistics (name -> buffer), flax's ``batch_stats``."""
    return dict(model.named_buffers())


def resnet_loss_fn(model: ResNet, batch):
    """Softmax cross-entropy in train mode (``ray_tpu.models.resnet.
    resnet_loss_fn``): batch ``{"image": [B, H, W, C], "label": [B]}``.
    Returns ``(loss, (batch_stats, accuracy))``; the forward has updated
    the running statistics, which ``batch_stats`` are."""
    model.train()
    logits = model(batch["image"])
    labels = batch["label"].long()
    loss = F.cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, (batch_stats(model), acc)
