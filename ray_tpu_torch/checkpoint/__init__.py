"""Distributed sharded async checkpointing.

Each rank of a gang snapshots its LOCAL pytree shard to host memory (a
bounded pause, off the device step path) and persists it in the background
into a shared store; a two-phase commit — per-rank shard files first, then
one atomic ``MANIFEST.json`` rename — guarantees a reader never observes a
partial checkpoint.  Chunked content addressing dedups unchanged state
across consecutive saves, and per-array ``global_shape``/``index`` metadata
lets an N-rank checkpoint restore onto an M-rank gang (elastic resize).

Store layout (one directory tree, typically on shared storage)::

    <root>/
      chunks/<hh>/<hash>            content-addressed chunk store
      steps/step_<NNNNNNNN>/
          rank_<RRRRR>.json         per-rank shard metadata (phase 1)
          checkpoint.pkl            (dict-kind checkpoints only)
          MANIFEST.json             atomic commit marker (phase 2)

A checkpoint EXISTS iff its ``MANIFEST.json`` exists; shard files without a
manifest are an aborted save, garbage-collected by the next committed one.

Copied from ``ray_tpu/checkpoint/__init__.py`` (the JAX package).
``coordinator.py`` (``DistributedCheckpointer``, ``AsyncCommitter``,
``commit_when_complete``) drives a ``MeshGroup`` gang's saves.
"""
from ray_tpu_torch.checkpoint.chunks import ChunkStore, default_chunk_bytes  # noqa: F401
from ray_tpu_torch.checkpoint.manifest import (  # noqa: F401
    commit_manifest,
    committed_steps,
    evict_steps,
    gc_chunks,
    gc_orphans,
    latest_committed_step,
    read_manifest,
    step_dir,
)
from ray_tpu_torch.checkpoint.saver import (  # noqa: F401
    ShardWriter,
    persist_dict_checkpoint,
    save_tree,
)
from ray_tpu_torch.checkpoint.coordinator import (  # noqa: F401
    AsyncCommitter,
    DistributedCheckpointer,
    commit_when_complete,
)
from ray_tpu_torch.checkpoint.restore import (  # noqa: F401
    assemble_arrays,
    restore_tree,
)
from ray_tpu_torch.checkpoint.tree import (  # noqa: F401
    axis0_restore_index,
    axis0_shard_index,
    flatten_with_paths,
    unflatten_like,
)
