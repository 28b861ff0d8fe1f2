"""TorchLearner / LearnerGroup: gradient updates on the learner's device
(counterpart of ``ray_tpu/rllib/core/learner.py``; reference: the
new-stack RLTrainer/TrainerRunner, rllib/core/rl_trainer/rl_trainer.py:51,
trainer_runner.py:24).

The JAX ``JaxLearner`` keeps params and optimizer state on a mesh and
runs one jitted update; ``TorchLearner`` keeps the module and its
optimizer on one device (``config.device``: CUDA unless the CPU is asked
for) and runs the update eagerly.  The update plan is the JAX learner's
``optax.chain(clip_by_global_norm(grad_clip or 1e9), adam(lr))``.

Not ported yet: ``DistributedLearnerGroup``, one learner process per host
behind a ``MeshGroup`` (ROADMAP, Queue 1 item 6).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.utils.mesh import build_update_plan

Batch = Dict[str, Any]
LossFn = Callable[[torch.nn.Module, Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def metrics_to_host(metrics: Dict[str, Any]) -> Dict[str, float]:
    """One device-to-host read of a metrics dict (0-d tensors from
    ``TorchLearner.update``) into plain floats."""
    names = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = {k: v for k, v in metrics.items() if k not in names}
    if names:
        values = torch.stack([metrics[k].float() for k in names]).tolist()
        out.update(zip(names, values))
    return out


def _to_device(batch: Batch, device: torch.device
               ) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``.  Arrays the object store
    handed out read-only are copied first; on the CPU the others are
    shared, not copied."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if not v.flags.writeable:
            v = v.copy()
        out[k] = torch.from_numpy(v).to(device)
    return out


class TorchLearner:
    """Holds a module and its optimizer on ``device``; ``update(batch)``
    runs one step of ``loss_fn(module, batch) -> (loss, aux)``:
    gradient, global-norm clip, Adam (betas 0.9/0.999, eps 1e-8 outside
    the root, as ``optax.adam``)."""

    def __init__(self, module: torch.nn.Module, loss_fn: LossFn,
                 lr: float = 5e-5, grad_clip: Optional[float] = None,
                 device=None):
        self.device = resolve_device(device)
        self.module = module.to(self.device)
        self.loss_fn = loss_fn
        self._params = list(self.module.parameters())
        self._update, self.optimizer = build_update_plan(
            None, lr, grad_clip or 1e9, self._params)

    def update(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """One update on ``batch`` (numpy arrays).  The metrics
        stay on the device: read them with ``metrics_to_host``, once an
        iteration, not once a minibatch."""
        loss, aux = self.loss_fn(self.module, _to_device(batch, self.device))
        self._update(torch.autograd.grad(loss, self._params))
        return {"total_loss": loss.detach(),
                **{k: v.detach() for k, v in aux.items()}}

    def get_weights(self) -> Dict[str, torch.Tensor]:
        """The module's state dict, copied to the CPU (a copy on the CPU
        too, so later updates leave it as it was)."""
        return {k: v.detach().to("cpu", copy=True)
                for k, v in self.module.state_dict().items()}

    def set_weights(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Load a state dict into the module; the optimizer state stays,
        as the JAX learner keeps its ``opt_state``."""
        self.module.load_state_dict(state_dict)


class LearnerGroup:
    """Single-host form: one in-process learner.  For more than one
    host, see ``DistributedLearnerGroup``."""

    def __init__(self, learner: TorchLearner):
        self.learner = learner

    def update(self, batch):
        return self.learner.update(batch)

    def get_weights(self):
        return self.learner.get_weights()

    def shutdown(self):
        pass


class DistributedLearnerGroup:
    """One learner process per host, gang-scheduled as a ``MeshGroup``:
    not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DistributedLearnerGroup is not ported yet: it needs the "
            "MeshGroup learner gang and the checkpoint coordinator "
            "(ROADMAP, Queue 1 item 6)")
