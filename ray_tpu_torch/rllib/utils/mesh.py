"""The single-device part of ``ray_tpu/rllib/utils/mesh.py``.

The JAX package runs the Anakin step as one SPMD program over a ``data``
mesh, with gradients and moments ``pmean``-ed across it.  On one device
(``num_devices`` None or 1) every ``pmean`` is the identity, which is all
the port does so far: more devices, ``zero_sharding`` and
``quantized_collectives`` raise ``NotImplementedError`` (ROADMAP, Queue 1
item 6, data parallelism).
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch

_LATER = ("is not ported yet: the port's Anakin step runs on one device "
          "(ROADMAP, Queue 1 item 6, data parallelism)")


def normalize_global(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Mean/std normalisation over the whole batch (on one device the
    global moments are the local ones)."""
    m = x.mean()
    var = ((x - m) ** 2).mean()
    return (x - m) / (var.sqrt() + eps)


def setup_data_mesh(config, num_envs: int) -> int:
    """The number of devices the step runs on: 1.  ``num_devices`` None
    or 1 is the single-device path; anything else raises."""
    d = getattr(config, "num_devices", None)
    if d is not None and int(d) < 1:
        raise ValueError(f"num_devices must be >= 1, got {d}")
    if d is not None and int(d) > 1:
        raise NotImplementedError(f"num_devices={d} {_LATER}")
    return 1


def reject_data_mesh(config, path: str) -> None:
    """A path with no data-parallel step refuses ``num_devices`` (and the
    knobs that ride that step) loudly: running on one device while the
    user believes the step is N-way data-parallel is the worst failure."""
    if getattr(config, "num_devices", None) is not None:
        raise NotImplementedError(
            f"resources(num_devices=...) is not implemented for {path}: "
            "no data-parallel learner yet (ROADMAP, Queue 1 item 6)")
    if getattr(config, "zero_sharding", "off") != "off" or \
            getattr(config, "quantized_collectives", "off") != "off":
        raise NotImplementedError(
            f"zero_sharding/quantized_collectives are not implemented for "
            f"{path}: they ride the data-parallel learner (ROADMAP, Queue 1 "
            f"item 6)")


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: the gradients as they are when their
    global norm is below ``max_norm``, else ``g / norm * max_norm``.
    (``torch.nn.utils.clip_grad_norm_`` scales by ``max / (norm + 1e-6)``,
    another function.)  Decided on the device, without a host sync."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


def build_update_plan(config, lr: float, grad_clip: Optional[float],
                      params: Iterable[torch.nn.Parameter]
                      ) -> Tuple[Callable[[Sequence[torch.Tensor]], None],
                                 torch.optim.Adam]:
    """The default branch of the JAX plan: ``clip_by_global_norm(grad_clip)``
    (when ``grad_clip`` is set) then ``adam(lr)``.  Returns
    ``(update_fn, optimizer)``; ``update_fn(grads)`` applies one update to
    ``params`` in place.  ``torch.optim.Adam`` with betas (0.9, 0.999)
    and eps 1e-8 is ``optax.adam``'s update (eps outside the root)."""
    for knob, off in (("zero_sharding", "off"),
                      ("quantized_collectives", "off")):
        value = getattr(config, knob, off) or off
        if value != off:
            raise NotImplementedError(f"{knob}={value!r} {_LATER}")
    params = list(params)
    optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def update_fn(grads: Sequence[torch.Tensor]) -> None:
        if grad_clip:
            grads = clip_by_global_norm(grads, grad_clip)
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()

    return update_fn, optimizer
