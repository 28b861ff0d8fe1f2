"""Training-step helpers (counterpart of
``ray_tpu/train/jax/train_loop_utils.py``).

``adamw`` is the optimizer the JAX package's GPT-2 training step uses
(``optax.adamw(3e-4)``), with optax's defaults; ``make_train_step`` is the
counterpart of ``compile_donated_step``.  Nothing here picks a device:
the step runs where the model's parameters are.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable

import torch


def adamw(parameters: Iterable[torch.nn.Parameter],
          learning_rate: float = 3e-4) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` with ``optax.adamw``'s defaults, which are
    not torch's: betas (0.9, 0.999), eps 1e-8 (added outside the square
    root, optax's ``eps_root`` 0), weight decay 1e-4 (torch's default is
    1e-2), and decay on every parameter (optax's ``mask=None``: biases,
    LayerNorm scales and embeddings included).

    The two updates agree algebraically.  optax computes
    ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` with the bias-
    corrected moments and the parameter before the step; torch first
    decays ``p -= lr * wd * p`` (decoupled, on that same parameter) and
    then subtracts ``lr * m_hat / (sqrt(v_hat) + eps)``.  They differ only
    in fp32 rounding."""
    return torch.optim.AdamW(parameters, lr=learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor]
                    ) -> Callable[[Any], torch.Tensor]:
    """``step(batch) -> loss``: one forward, backward and optimizer update
    of ``model`` on ``batch``, with ``loss = loss_fn(model, batch)``.

    Counterpart of ``compile_donated_step``, which jits the step with the
    carry (params and optimizer state) donated so that XLA updates the
    weights in place.  Here the carry is updated in place by the optimizer
    itself, which is what donation buys in JAX, and PyTorch runs eagerly,
    so there is nothing to compile.  The loss comes back as a 0-d tensor
    on the model's device, detached: the step never waits for the device,
    and the caller reads the loss when it wants a barrier."""

    def step(batch) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
