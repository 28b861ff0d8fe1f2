"""Training-step helpers (counterpart of
``ray_tpu/train/jax/train_loop_utils.py``).

``adamw`` is the optimizer the JAX package's GPT-2 training step uses
(``optax.adamw(3e-4)``), with optax's defaults; ``make_train_step`` is the
counterpart of ``compile_donated_step``.  Nothing here picks a device:
the step runs where the model's parameters are.
``prepare_device_iterator`` is the Train loop's ingest: host batches
moved to the device on a background thread (``data.prefetch``).

Data parallelism over the gang's process group (``TorchConfig`` forms
it): ``get_mesh`` is the group with named axes (``parallel.mesh.Mesh``),
``prepare_train_state`` makes every rank hold rank 0's parameters,
``prepare_batch`` cuts a global host batch down to this rank's slice,
and ``compile_zero_step`` builds the ZeRO step (``parallel.zero``).
``prepare_model`` wraps the model in ``DistributedDataParallel`` when the
gang has more than one worker: DDP broadcasts rank 0's parameters when it
wraps, and averages the gradients over the group in the backward, before
the optimizer's step.
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


def get_mesh(spec=None, group=None):
    """The mesh of this training group: its process group with
    ``spec``'s axes (default ``{"data": -1}``: pure data parallelism
    over every worker)."""
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    return make_mesh(spec or MeshSpec({"data": -1}), group)


def prepare_train_state(params: Any, mesh, annotations=None, rules=None):
    """Make every rank hold rank 0's parameters (a broadcast in place),
    cut to this rank's slice where ``annotations`` map a dim to the data
    axes: the counterpart of placing params on the mesh."""
    from ray_tpu_torch.parallel.sharding import shard_params

    return shard_params(params, mesh, rules, annotations)


def prepare_batch(batch: Any, mesh):
    """This rank's slice of a global host batch: every leaf's leading dim
    cut over the mesh's data axes (``batch_sharding``)."""
    from ray_tpu_torch.parallel.sharding import batch_sharding
    from ray_tpu_torch.parallel.zero import tree_flatten, tree_unflatten

    _, leaves, treedef = tree_flatten(batch)
    return tree_unflatten(treedef, [
        batch_sharding(mesh, len(getattr(x, "shape", (0,)))).place(x)
        for x in leaves])


def compile_zero_step(grad_fn, tx, params, mesh=None, *,
                      zero_sharding: str = "opt+grads",
                      quantized_collectives: str = "off",
                      should_shard=None):
    """A ZeRO data-parallel train step over the mesh's group (arxiv
    2004.13336, with the EQuARX int8 wire; see ``parallel.zero``).

    ``grad_fn(params, batch) -> (loss, grads)`` on this rank's LOCAL batch
    (e.g. ``torch.autograd.grad`` of the model's loss; ``grads`` a tree
    like ``params``).  ``tx`` is an optimizer factory (``tx(tensors) ->
    torch.optim.Optimizer``, or ``zero.chain(...)``).  Returns ``(step,
    opt_state, info)``: ``step(params, opt_state, batch) -> (params,
    opt_state, loss)`` runs the gradient, reduce-scatters it (int8 when
    ``quantized_collectives="int8"``), updates this rank's 1/N shard and
    all-gathers the fresh parameters into ``params`` in place (what the
    JAX step's donated carry buys), the loss averaged over the group;
    ``opt_state`` is this rank's optimizer share; ``info`` is the
    memory and wire envelope (``zero_opt_bytes_per_replica``,
    ``grad_comm_bytes``, ...).

    ``tx`` must be elementwise (Adam, AdamW, SGD); for gradient-norm
    clipping chain ``zero.zero_clip_by_global_norm``.  At a world of one
    no collective runs: the update is the plain one on a flat copy."""
    from ray_tpu_torch.ops import collectives
    from ray_tpu_torch.parallel import zero as zero_mod

    if mesh is None:
        mesh = get_mesh()
    world = mesh.shape.get(zero_mod.DATA_AXIS, 1)
    if world != mesh.world:
        raise ValueError(f"compile_zero_step needs a pure data mesh; "
                         f"{mesh.shape} has {mesh.world} ranks")
    zu = zero_mod.build_zero_update(
        params, tx, world, zero_sharding=zero_sharding,
        quantized=quantized_collectives, group=mesh.group,
        should_shard=should_shard)
    info = zero_mod.export_zero_metrics(
        zu.sharder, tx, zero_sharding=zero_sharding,
        quantized=quantized_collectives)

    def step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        loss = loss.detach()
        if world > 1:
            loss = collectives.all_reduce_sum(loss, mesh.group) / world
        params, opt_state = zu.update(grads, opt_state, params)
        return params, opt_state, loss

    return step, zu.init_opt(params, mesh.rank), info


def prepare_model(model: torch.nn.Module) -> torch.nn.Module:
    """The model as this worker trains it (reference: prepare_model's DDP
    wrap).  In a gang of one worker that is the model itself; in a larger
    gang, ``DistributedDataParallel`` over the gang's process group (its
    parameters are rank 0's from the wrap on, and ``backward`` averages
    the gradients over the group)."""
    import torch.distributed as dist

    from ray_tpu_torch.air import session

    if session.get_world_size() <= 1:
        return model
    if not dist.is_initialized():
        raise RuntimeError("prepare_model in a gang of "
                           f"{session.get_world_size()} workers needs the "
                           "gang's process group (TorchTrainer forms it)")
    device = next(model.parameters()).device
    return torch.nn.parallel.DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None)


def prepare_device_iterator(host_batches, device=None, prefetch: int = 2,
                            mesh=None):
    """Wrap any iterable of host batches (dicts of numpy arrays) in the
    background device prefetcher (``data.prefetch.DevicePrefetcher``),
    the same machinery as ``Dataset.iter_device_batches``; ``device``
    None means CUDA.  With ``mesh`` each batch is first cut to this
    rank's slice (``prepare_batch``)."""
    from ray_tpu_torch.data.prefetch import DevicePrefetcher

    if mesh is not None:
        host_batches = (prepare_batch(b, mesh) for b in host_batches)
    return DevicePrefetcher(host_batches, device=device, prefetch=prefetch)
