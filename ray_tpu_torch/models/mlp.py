"""Plain MLP, the RL policy trunk for flat observations (counterpart of
``ray_tpu/models/mlp.py``).  Layers are named ``dense_{i}`` and ``out``
as in flax, tanh between them, initialised as flax initialises."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ray_tpu_torch.models.flax_layers import dense


class MLP(nn.Module):
    """``in_dim`` is explicit: torch layers need their input width at
    construction, where flax infers it from the first call."""

    def __init__(self, in_dim: int, features: Sequence[int] = (64, 64),
                 out_dim: int = 1, activation: Callable = torch.tanh,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.num_hidden = len(features)
        widths = (in_dim, *features)
        for i, (a, b) in enumerate(zip(widths, widths[1:])):
            self.add_module(f"dense_{i}", dense(a, b, generator))
        self.out = dense(widths[-1], out_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        for i in range(self.num_hidden):
            x = self.activation(getattr(self, f"dense_{i}")(x))
        return self.out(x)
