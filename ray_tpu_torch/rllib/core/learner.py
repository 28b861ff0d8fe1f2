"""TorchLearner / LearnerGroup: gradient updates on the learner's device
(counterpart of ``ray_tpu/rllib/core/learner.py``; reference: the
new-stack RLTrainer/TrainerRunner, rllib/core/rl_trainer/rl_trainer.py:51,
trainer_runner.py:24).

The JAX ``JaxLearner`` keeps params and optimizer state on a mesh and
runs one jitted update; ``TorchLearner`` keeps the module and its
optimizer on one device (``config.device``: CUDA unless the CPU is asked
for) and runs the update eagerly.  The update plan is the JAX learner's
``optax.chain(clip_by_global_norm(grad_clip or 1e9), adam(lr))``.

``DistributedLearnerGroup`` runs one learner process per rank behind a
``MeshGroup``.  Where the JAX learner's mesh spans every host after the
rendezvous and XLA reduces the gradients in the jitted update, a rank's
``TorchLearner`` is switched to data parallelism (``data_parallel``):
it takes rank 0's weights, trains on its slice of each batch, and
averages the gradients (and the metrics) over the group before the
update, as one ``all_gather`` summed in rank order, so every rank applies
the same update and the weights stay bit-identical across ranks.
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
        self._group, self._world, self._rank = None, 1, 0

    def data_parallel(self, group=None) -> None:
        """Train as one rank of ``group`` (None: the default process
        group): take rank 0's weights now; from then on ``update`` trains
        on this rank's slice of each batch and averages the gradients and
        metrics over the group."""
        from ray_tpu_torch.ops import collectives

        self._group = group
        self._world = collectives.world_of(group)
        self._rank = collectives.rank_of(group)
        if self._world > 1:
            for t in self.module.state_dict().values():
                collectives.broadcast_(t, 0, group)

    def _slice(self, batch: Batch) -> Batch:
        """This rank's rows of every array whose leading dim divides over
        the group (the rest whole, as the JAX learner replicates them)."""
        out = {}
        for k, v in batch.items():
            n = int(np.shape(v)[0]) if np.ndim(v) else 0
            if n and n % self._world == 0:
                step = n // self._world
                v = v[self._rank * step:(self._rank + 1) * step]
            out[k] = v
        return out

    def _group_mean(self, tensors):
        """The mean over the group of each tensor, from one flat buffer."""
        from ray_tpu_torch.ops import collectives

        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        flat = collectives.all_reduce_sum(flat, self._group) / self._world
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
            at += t.numel()
        return out

    def update(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """One update on ``batch`` (numpy arrays).  The metrics
        stay on the device: read them with ``metrics_to_host``, once an
        iteration, not once a minibatch."""
        if self._world > 1:
            batch = self._slice(batch)
        loss, aux = self.loss_fn(self.module, _to_device(batch, self.device))
        grads = torch.autograd.grad(loss, self._params)
        metrics = [loss.detach()] + [v.detach() for v in aux.values()]
        if self._world > 1:
            grads = self._group_mean(list(grads))
            metrics = self._group_mean(metrics)
        self._update(grads)
        return dict(zip(["total_loss", *aux], metrics))

    def get_weights(self) -> Dict[str, torch.Tensor]:
        """The module's state dict, copied to the CPU (a copy on the CPU
        too, so later updates leave it as it was)."""
        return {k: v.detach().to("cpu", copy=True)
                for k, v in self.module.state_dict().items()}

    def set_weights(self, state_dict: Dict[str, Any]) -> None:
        """Load a state dict (tensors or numpy arrays) into the module;
        the optimizer state stays, as the JAX learner keeps its
        ``opt_state``."""
        self.module.load_state_dict(
            {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
             for k, v in state_dict.items()})


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


def _build_learner(state, factory):
    learner = factory()
    learner.data_parallel()
    state["learner"] = learner
    return True


def _learner_update(state, batch):
    # Cross-process boundary: results are pickled, so fetch to host here
    # (one batched transfer per update call).
    return metrics_to_host(state["learner"].update(batch))


def _learner_update_device(state, batch):
    # Pipelined form: metrics stay on the device (0-d tensors); the
    # MeshWorker host-converts them only on fetch steps, so the
    # in-between steps never pay a device read or a payload pickle.
    return state["learner"].update(batch)


def _learner_get_weights(state):
    return state["learner"].get_weights()


def _learner_set_weights(state, weights):
    state["learner"].set_weights(weights)
    return True


def _learner_shard_save(state, root, step, sync):
    """Per-rank sharded checkpoint of the learner params: one bounded
    device→host snapshot, then chunk/hash/write — synchronously, or on
    this rank's background persist thread (``sync=False``), so a save
    riding the step pipeline releases its slot after the snapshot and
    never stalls the donated update stream."""
    import os

    from ray_tpu_torch.checkpoint.saver import ShardWriter

    rank = int(os.environ.get("RTTP_RANK", "0"))
    world = int(os.environ.get("RTTP_WORLD_SIZE", "1"))
    writer = state.get("_ckpt_writer")
    if writer is None or writer.root != root:
        writer = ShardWriter(root, rank, world)
        state["_ckpt_writer"] = writer
    snap = writer.snapshot(state["learner"].module.state_dict())
    if sync:
        writer.persist(snap, step)
    else:
        writer.persist_async(snap, step)
    return {"rank": rank, "step": int(step)}


def _learner_shard_restore(state, root, step):
    """Restore this rank's learner params from the latest (or given)
    committed manifest.  Params are replicated across the gang, so every
    rank loads the full tree — which is also why an N-rank checkpoint
    restores onto an M-rank gang unchanged (resharded restore)."""
    from ray_tpu_torch.checkpoint.restore import restore_tree

    learner = state["learner"]
    learner.set_weights(
        restore_tree(root, step=step, target=learner.get_weights()))
    return True


class DistributedLearnerGroup:
    """Multi-rank LearnerGroup: one learner process per rank, gang-
    scheduled as a MeshGroup whose ranks form one process group; each
    rank's ``TorchLearner`` trains on its slice of every batch and
    averages the gradients over the group (``TorchLearner.data_parallel``),
    the counterpart of the JAX learner's mesh spanning every host.

    ``learner_factory`` must be a picklable zero-arg callable returning a
    ``TorchLearner``; it runs once inside each rank's process after the
    rendezvous.  ``resources_per_host`` is each rank's bundle (``{"CPU":
    1}`` by default; ``{"GPU": 0.5}`` puts two ranks on one card, over
    gloo; ``{"GPU": 1}`` a card a rank, over NCCL).

    Fault tolerance: with ``max_group_restarts > 0`` a rank death during
    ``update()`` triggers a gang rebuild (see MeshGroup's fault-tolerance
    docs); the ``on_restart`` hook re-materializes the learner in every
    fresh host process and re-broadcasts the last driver-cached weights
    (``checkpoint_weights()`` refreshes the cache), so training resumes
    instead of silently restarting from a re-initialized policy.
    """

    def __init__(self, learner_factory, num_hosts=1,
                 resources_per_host=None, max_group_restarts: int = 0,
                 pipeline_depth: int = 0, metrics_interval: int = 1,
                 checkpoint_root: Optional[str] = None,
                 checkpoint_keep: Optional[int] = None):
        from ray_tpu_torch.parallel.mesh_group import MeshGroup

        # Elastic range: num_hosts may be (min, max); the gang starts at
        # max and resize() keeps it inside the range.
        if isinstance(num_hosts, (tuple, list)):
            self.min_hosts, self.max_hosts = int(num_hosts[0]), \
                int(num_hosts[1])
            num_hosts = self.max_hosts
        else:
            self.min_hosts = self.max_hosts = int(num_hosts)
        self._factory = learner_factory
        self._last_weights = None
        self._last_metrics: Optional[Dict[str, float]] = None
        self._weight_steps: set = set()
        self._pipeline = None
        # Sharded checkpointing (checkpoint_root set): every rank persists
        # its own shard into the store; the driver only commits manifests.
        self._ckpt_root = checkpoint_root
        self._ckpt_keep = checkpoint_keep
        self._ckpt_step = 0
        self._ckpt_pipe_steps: Dict[int, Tuple[int, bool]] = {}
        self._committer = None
        self.group = MeshGroup(num_hosts, resources_per_host,
                               max_group_restarts=max_group_restarts,
                               pipeline_depth=max(1, pipeline_depth))
        if checkpoint_root is not None:
            from ray_tpu_torch.checkpoint.coordinator import AsyncCommitter

            self._committer = AsyncCommitter()
            # In-flight async saves die with a gang rebuild — cancel their
            # commits so a half-persisted step can never publish.
            self.group.add_restart_hook(
                lambda g: self._committer.cancel_pending())
        self.group.run_stateful(_build_learner, learner_factory)
        if pipeline_depth > 0:
            # Zero-sync hot path: updates stream through a bounded window,
            # the driver never blocks per step, and metrics arrive every
            # metrics_interval-th step (see mesh_group.StepPipeline).
            self._pipeline = self.group.pipeline(
                depth=pipeline_depth, metrics_interval=metrics_interval,
                on_restart=self._on_restart, on_result=self._on_pipe_result)

    def _on_restart(self, group):
        """After a gang rebuild the new host processes hold empty state:
        re-build the learner on every rank, then restore the latest
        COMMITTED sharded checkpoint (when a checkpoint_root is set and
        holds one — per-rank disk reads, no driver broadcast), falling
        back to re-broadcasting the last driver-cached weights."""
        import ray_tpu_torch

        group.run_stateful(_build_learner, self._factory)
        if self._ckpt_root is not None:
            from ray_tpu_torch.checkpoint import manifest as mf

            if mf.latest_committed_step(self._ckpt_root) is not None:
                group.run_stateful(_learner_shard_restore,
                                   self._ckpt_root, None)
                return
        if self._last_weights is not None:
            # One put, num_hosts borrowers: each rank resolves the same
            # store object zero-copy instead of the submit path
            # serializing the weights once per host.
            group.run_stateful(_learner_set_weights,
                               ray_tpu_torch.put(self._last_weights))

    def _commit_sharded(self, step: int) -> None:
        from ray_tpu_torch.checkpoint import manifest as mf
        from ray_tpu_torch.checkpoint.coordinator import commit_when_complete

        pending = (self._committer.pending_steps()
                   if self._committer is not None else [])
        commit_when_complete(self._ckpt_root, step, self.group.num_hosts,
                             in_progress=pending)
        if self._ckpt_keep:
            try:
                mf.evict_steps(self._ckpt_root, self._ckpt_keep)
            except Exception:
                pass

    def checkpoint_weights(self, step: Optional[int] = None):
        """Checkpoint the current policy.

        With a ``checkpoint_root``: a per-rank SHARDED save — every host
        snapshots and persists its own shard, the driver commits the
        manifest — so save cost no longer scales with a full-weights
        gather to the driver.  Returns the committed manifest.

        Without one (legacy): pull rank-0 weights into the driver-side
        restore cache and return them."""
        if self._ckpt_root is not None:
            if step is None:
                self._ckpt_step += 1
                step = self._ckpt_step
            else:
                self._ckpt_step = max(self._ckpt_step, int(step))
            if self._pipeline is not None:
                # Ride the step pipeline: the save serializes with the
                # (donating) in-flight updates instead of racing them.
                idx = self._pipeline.submit(_learner_shard_save,
                                            self._ckpt_root, step, True,
                                            fetch=True)
                self._ckpt_pipe_steps[idx] = (step, True)
                self._pipeline.flush()
            else:
                self.group.run_stateful(_learner_shard_save,
                                        self._ckpt_root, step, True)
                self._commit_sharded(step)
            from ray_tpu_torch.checkpoint import manifest as mf

            return mf.read_manifest(self._ckpt_root, step)
        self._last_weights = self.group.run_rank_stateful(
            0, _learner_get_weights)
        return self._last_weights

    def update(self, batch) -> Dict[str, float]:
        """Every rank receives the batch and trains on its slice;
        metrics are averaged over the group, so rank 0's are returned."""
        import ray_tpu_torch

        # One serialization + one store object shared by all hosts (a ref
        # arg resolves zero-copy per host) instead of num_hosts copies.
        batch_ref = ray_tpu_torch.put(batch)
        results = self.group.run_stateful(_learner_update, batch_ref,
                                          on_restart=self._on_restart)
        return results[0]

    def resize(self, num_hosts: int) -> None:
        """Elastically rebuild the learner gang at ``num_hosts`` hosts
        (clamped to the configured ``(min, max)`` range) at an update
        boundary: capture the live rank-0 weights, rebuild the gang
        (fresh processes + rendezvous), re-materialize the learner on
        every rank and re-broadcast the weights as ONE put."""
        import ray_tpu_torch

        n = max(self.min_hosts, min(self.max_hosts, int(num_hosts)))
        if n == self.group.num_hosts:
            return
        if self._pipeline is not None:
            raise RuntimeError(
                "resize() needs the lockstep path (pipeline_depth=0): an "
                "in-flight step window cannot straddle two world sizes")
        self._last_weights = self.group.run_rank_stateful(
            0, _learner_get_weights)
        self.group.resize(n)
        self.group.run_stateful(_build_learner, self._factory)
        self.group.run_stateful(_learner_set_weights,
                                ray_tpu_torch.put(self._last_weights))

    # ---- pipelined update stream (pipeline_depth > 0) ----
    def _on_pipe_result(self, idx: int, res) -> None:
        if idx in self._ckpt_pipe_steps:
            step, synchronous = self._ckpt_pipe_steps.pop(idx)
            if res is None:
                return  # save step lost to a gang restart replay edge
            if synchronous:
                # sync persist ran inside the pipeline step: every shard
                # file already exists, commit is immediate.
                self._commit_sharded(step)
            else:
                # async persist: rank background threads are still
                # writing; a driver thread commits when the shards land.
                self._committer.commit_async(
                    self._ckpt_root, step, self.group.num_hosts,
                    on_commit=lambda m: self._post_async_commit(step))
            return
        if res is None:
            return  # non-fetch step: metrics stayed on device
        if idx in self._weight_steps:
            self._weight_steps.discard(idx)
            self._last_weights = res[0]
        else:
            self._last_metrics = res[0]

    def _post_async_commit(self, step: int) -> None:
        if self._ckpt_keep:
            try:
                from ray_tpu_torch.checkpoint import manifest as mf

                mf.evict_steps(self._ckpt_root, self._ckpt_keep)
            except Exception:
                pass

    def update_async(self, batch) -> Optional[Dict[str, float]]:
        """Pipelined update: dispatches the step and returns immediately
        (blocking only when the in-flight window is full), so the driver
        never gates device compute.  Returns the LATEST drained metrics —
        which lag the submitted step by up to pipeline_depth steps — or
        None before the first fetch step drains."""
        import ray_tpu_torch
        from ray_tpu_torch.util import tracing

        if self._pipeline is None:
            raise RuntimeError(
                "pipelined updates need pipeline_depth > 0 at construction")
        # Driver API boundary: each update step (batch put + gang
        # dispatch + drain spans) rides one distributed trace, rooted
        # at this span.
        with tracing.span("learner.update_async"):
            batch_ref = ray_tpu_torch.put(batch)
            self._pipeline.submit(_learner_update_device, batch_ref)
        return self._last_metrics

    def checkpoint_weights_async(self, step: Optional[int] = None) -> None:
        """Non-blocking checkpoint: rides the step pipeline, so it
        serializes with the (donating) update steps instead of racing
        them, and the driver never blocks.

        With a ``checkpoint_root``: a per-rank sharded save — the pipeline
        step only pays the bounded host snapshot; chunk writes ride each
        rank's background persist thread and a driver thread commits the
        manifest when every shard lands (two-phase: a crash mid-persist
        leaves the previous committed checkpoint as the latest).

        Without one (legacy): a rank-0 weights fetch that lands in the
        driver-side restore cache when its pipeline slot drains."""
        if self._pipeline is None:
            raise RuntimeError(
                "pipelined snapshots need pipeline_depth > 0")
        if self._ckpt_root is not None:
            if step is None:
                self._ckpt_step += 1
                step = self._ckpt_step
            else:
                self._ckpt_step = max(self._ckpt_step, int(step))
            idx = self._pipeline.submit(_learner_shard_save,
                                        self._ckpt_root, step, False,
                                        fetch=True)
            self._ckpt_pipe_steps[idx] = (step, False)
            return
        idx = self._pipeline.submit(_learner_get_weights, fetch=True)
        self._weight_steps.add(idx)

    def flush_updates(self) -> Optional[Dict[str, float]]:
        """Drain every in-flight pipelined step AND publish any pending
        async checkpoint commits; returns the final metrics (the barrier
        to call at iteration end)."""
        if self._pipeline is not None:
            self._pipeline.flush()
        self.flush_checkpoints()
        return self._last_metrics

    def flush_checkpoints(self) -> None:
        """Barrier for async sharded saves: joins rank persist threads
        and pending manifest commits (re-raising a failed commit)."""
        if self._ckpt_root is None:
            return
        from ray_tpu_torch.checkpoint.coordinator import _rank_wait_persisted

        self.group.run_stateful(_rank_wait_persisted, 120.0)
        self._committer.flush()

    def restore_latest(self, step: Optional[int] = None) -> Optional[int]:
        """Restore every rank's learner from the latest (or given)
        committed manifest under ``checkpoint_root``.  Works across gang
        sizes: an N-rank save restores onto this M-rank group (replicated
        params — each rank reads the full tree from the store).  Returns
        the restored step, or None when the store has no commit."""
        if self._ckpt_root is None:
            raise RuntimeError("restore_latest needs checkpoint_root")
        from ray_tpu_torch.checkpoint import manifest as mf

        if step is None:
            step = mf.latest_committed_step(self._ckpt_root)
            if step is None:
                return None
        if self._pipeline is not None:
            self._pipeline.flush()
        self.group.run_stateful(_learner_shard_restore, self._ckpt_root,
                                step, on_restart=self._on_restart)
        self._ckpt_step = max(self._ckpt_step, int(step))
        return int(step)

    def get_weights(self):
        if self._pipeline is not None:
            # Order the read after every in-flight donated update.
            self._pipeline.flush()
        return self.group.run_rank_stateful(0, _learner_get_weights)

    def set_weights(self, weights):
        import ray_tpu_torch

        if self._pipeline is not None:
            # run_stateful bypasses the pipeline's sequence gate: drain
            # first so the broadcast can't interleave with queued updates.
            self._pipeline.flush()
        self._last_weights = weights
        # Broadcast through the object plane: one serialization + one
        # store object shared by every host (same pattern as update()).
        self.group.run_stateful(_learner_set_weights,
                                ray_tpu_torch.put(weights),
                                on_restart=self._on_restart)

    def shutdown(self):
        if self._pipeline is not None:
            try:
                self._pipeline.close(flush=False)
            except Exception:
                pass
            self._pipeline = None
        if self._committer is not None:
            # Workers are about to die: saves that haven't committed yet
            # become orphans for the next save's GC, never partial reads.
            self._committer.cancel_pending()
        self.group.shutdown()
