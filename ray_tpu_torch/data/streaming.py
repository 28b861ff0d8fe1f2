"""Streaming Dataset executor: bounded-memory operator pipelines
(counterpart of ``ray_tpu/data/streaming.py``).

Reference: ray.data's StreamingExecutor
(python/ray/data/_internal/execution/streaming_executor.py:31 — run the
operator DAG with backpressure against object-store memory) and the
push-based shuffle (_internal/push_based_shuffle.py).

Design:

- A StreamingDataset is a list of *source thunks* (each submits one remote
  task producing a block) plus a chain of per-block stages.  Nothing runs
  at build time.
- The executor keeps at most W block-chains in flight.  W comes from a
  byte budget: the first completed block's directory size (the head's
  ``object_info`` request) divides the store budget — backpressure
  against store capacity, not a guessed constant.
- Per-block stages chain through object refs with NO barrier (the item
  flows stage-to-stage as soon as its predecessor finishes).
  Intermediate refs are dropped immediately so each block's scratch
  memory frees as soon as the next stage consumes it; consumed output
  blocks free as the iterator advances.
- random_shuffle is a window-scoped two-phase shuffle: each block in the
  window splits its rows into P random parts, each output block
  concatenates one part from every input, then shuffles rows locally
  (one task an output block, ``_exchange``; one window's blocks and
  outputs in the store at a time).  The driver only ever holds refs.
  (The shuffle radius is the window, not the whole dataset;
  ``full=True`` is the push-based full shuffle.)

Blocks are dicts of numpy columns (``data/block.py``); the draws are the
reference's numpy draws, so under one seed the port's order is the JAX
package's bit for bit.  ``iter_device_batches`` puts batches on CUDA
unless given ``device="cpu"``.

Copied from ``ray_tpu/data/streaming.py`` (the JAX package).
"""
from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Iterator, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import block as block_mod
from ray_tpu_torch.data import execution


@ray_tpu_torch.remote
def _apply_stage(blk, op, block_index):
    # The SAME per-block kernel the eager plan executor runs
    # (data/execution.py): streaming results are byte-identical to eager
    # ones by construction.
    return execution.apply_op(blk, op, block_index)


@ray_tpu_torch.remote
def _fused_read_apply(reader, path: str, columns, stages, block_index):
    """Operator fusion (the logical optimizer's one rewrite that matters
    for this executor): read + every chained per-block stage execute in
    ONE task, so a read→map→filter pipeline costs one store write per
    block instead of one per stage (reference: the Read→MapBatches fusion
    in data/_internal/logical/optimizers.py)."""
    return execution.apply_ops(reader(path, columns), stages, block_index)


@ray_tpu_torch.remote
def _partition_block(blk, num_parts: int, seed: int):
    """Map side of the shuffle: split rows into num_parts random parts."""
    n = block_mod.block_num_rows(blk)
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, num_parts, n)
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    bounds = np.searchsorted(sorted_assign, np.arange(num_parts + 1))
    taken = block_mod.block_take(blk, order)
    return tuple(block_mod.block_slice(taken, int(a), int(b))
                 for a, b in zip(bounds, bounds[1:]))


@ray_tpu_torch.remote
def _exchange(j: int, seed: int, combine_seed: int, *blks):
    """Output ``j`` of a window's exchange: part ``j`` of every block of
    the window (the rows ``_partition_block`` with ``seed + i`` sends
    there, in their order), concatenated, its rows then permuted."""
    p = len(blks)
    parts = []
    for i, blk in enumerate(blks):
        assign = np.random.default_rng(seed + i).integers(
            0, p, block_mod.block_num_rows(blk))
        parts.append(block_mod.block_take(blk, np.flatnonzero(assign == j)))
    out = block_mod.concat_blocks(parts)
    rng = np.random.default_rng(combine_seed)
    order = rng.permutation(block_mod.block_num_rows(out))
    return block_mod.block_take(out, order)


@ray_tpu_torch.remote
def _merge_parts(*parts):
    """Push-shuffle merge: fold a round of mapper parts into the
    partition's accumulator (reference: the merge stage of
    push_based_shuffle.py — merges pipeline WITH the map rounds, so
    mapper outputs never pile up as thousands of tiny store objects)."""
    return block_mod.concat_blocks([p for p in parts if p is not None])


@ray_tpu_torch.remote
def _finalize_partition(seed: int, blk):
    if blk is None:
        return block_mod.block_from_items([])
    rng = np.random.default_rng(seed)
    return block_mod.block_take(
        blk, rng.permutation(block_mod.block_num_rows(blk)))


class StreamingDataset:
    """Lazy, bounded-memory dataset pipeline.

    Build with ``read_streaming``/``from_source_thunks`` or
    ``Dataset.streaming()``; chain ``map_batches``/``filter``/
    ``random_shuffle``; consume with ``iter_batches``/
    ``iter_device_batches``/``count``.
    """

    def __init__(self, source_thunks: List[Callable[[], Any]],
                 stages: Optional[list] = None,
                 store_budget: Optional[int] = None,
                 max_inflight_blocks: Optional[int] = None):
        self._sources = list(source_thunks)
        self._stages = list(stages or [])
        self.store_budget = store_budget or 128 * 1024 * 1024
        self.max_inflight_blocks = max_inflight_blocks

    # ---------------- construction ----------------
    @staticmethod
    def from_source_thunks(thunks, **kw) -> "StreamingDataset":
        return StreamingDataset(thunks, **kw)

    @staticmethod
    def read(paths, fmt: str, columns=None, **kw) -> "StreamingDataset":
        from ray_tpu_torch.data.datasource import (
            expand_paths,
            resolve_datasource,
        )

        reader = resolve_datasource(fmt)
        # Structured descriptors (not opaque thunks) so the planner can
        # fuse the read with downstream per-block stages into one task.
        sources = [("read", reader, p, columns) for p in expand_paths(paths)]
        return StreamingDataset(sources, **kw)

    def _derive(self, stages) -> "StreamingDataset":
        return StreamingDataset(self._sources, stages, self.store_budget,
                                self.max_inflight_blocks)

    def map_batches(self, fn, batch_format: str = "numpy"
                    ) -> "StreamingDataset":
        return self._derive(self._stages + [("map_batches", fn,
                                             batch_format)])

    def filter(self, fn) -> "StreamingDataset":
        return self._derive(self._stages + [("filter", fn, "numpy")])

    def random_shuffle(self, seed: Optional[int] = None,
                       full: bool = False) -> "StreamingDataset":
        """``full=False``: window-scoped two-phase shuffle (mixing radius
        = the in-flight window — cheap, bounded, the right default for
        epoch-style ML shuffling).  ``full=True``: push-based FULL
        shuffle — every output block draws from every input block
        (reference semantics, push_based_shuffle.py); the dataset is
        accumulated across P partition accumulators (spilling past the
        store budget) while scratch stays round-bounded."""
        if self._shuffle_stages:
            # Only shuffles[0] executes; silently dropping a second
            # (possibly full-radius) shuffle would be a wrong-results bug.
            raise ValueError("this pipeline already has a shuffle stage; "
                             "chain at most one random_shuffle")
        kind = "push_shuffle" if full else "shuffle"
        return self._derive(self._stages + [(kind, seed, None)])

    def explain(self) -> str:
        """The logical plan after fusion, one operator per line."""
        per_block = [s[0] for s in self._per_block_stages]
        fused_reads = sum(1 for s in self._sources
                          if isinstance(s, tuple) and s[0] == "read")
        lines = []
        if fused_reads:
            fused = " -> ".join(["read"] + per_block)
            lines.append(f"Fused[{fused}] x{fused_reads} sources "
                         "(1 task/block)")
        else:
            lines.append(f"Sources x{len(self._sources)}")
            for s in per_block:
                lines.append(f"  -> {s} (1 task/block)")
        for s in self._stages:
            if s[0] == "shuffle":
                lines.append("  -> shuffle[window-scoped]")
            elif s[0] == "push_shuffle":
                lines.append("  -> shuffle[push-based, full radius]")
        return "\n".join(lines)

    # ---------------- execution ----------------
    def _window_size(self, first_ref) -> int:
        """Blocks in flight, from the store budget and a measured block
        size (backpressure against capacity, streaming_executor.py:31)."""
        if self.max_inflight_blocks is not None:
            return max(1, self.max_inflight_blocks)
        from ray_tpu_torch._private.worker import global_worker

        info = None
        try:
            info = global_worker.transport.request(
                "object_info", {"oid": first_ref.id})
        except Exception:  # no head to ask: the fallback below
            pass
        if not info or not info.get("size"):
            return 4
        # Half the budget: map stages briefly hold input+output per block.
        return max(2, int(self.store_budget * 0.5 // max(1, info["size"])))

    def _chain_source(self, src, block_index: int = 0):
        """Materialize one source with every per-block stage applied:
        structured read sources fuse read+stages into ONE task; opaque
        thunks fall back to a task per stage."""
        stages = self._per_block_stages
        if isinstance(src, tuple) and src[0] == "read":
            _, reader, path, columns = src
            return _fused_read_apply.remote(reader, path, columns, stages,
                                            block_index)
        ref = src()
        for op in stages:
            ref = _apply_stage.remote(ref, op, block_index)
        return ref

    @property
    def _per_block_stages(self):
        return [s for s in self._stages
                if s[0] not in ("shuffle", "push_shuffle")]

    @property
    def _shuffle_stages(self):
        return [s for s in self._stages
                if s[0] in ("shuffle", "push_shuffle")]

    def iter_block_refs(self) -> Iterator[Any]:
        """The executor: yields output block refs, ≤ window in flight
        (a :class:`ray_tpu_torch.parallel.flow.RefStream` holds the
        bound; the window shuffle reads one window at a time).  The
        caller must drop each yielded ref to release its memory."""
        from ray_tpu_torch.parallel import flow

        shuffles = self._shuffle_stages
        indexed = iter(enumerate(self._sources))
        first = next(indexed, None)
        if first is None:
            return
        first_ref = self._chain_source(first[1], first[0])
        # Measure the first (fused) output block to size the window.
        ray_tpu_torch.wait([first_ref], num_returns=1, timeout=300)
        window = self._window_size(first_ref)
        if shuffles and shuffles[0][0] == "shuffle":
            primed = [first_ref]
            del first_ref
            yield from self._window_shuffle_refs(primed, indexed, window,
                                                 shuffles[0][1])
            return
        thunks = (lambda s=s, i=i: self._chain_source(s, i)
                  for i, s in indexed)
        stream = flow.RefStream(thunks, depth=window, prime=[first_ref],
                                name="streaming_data")
        del first_ref
        try:
            if shuffles:
                yield from self._push_shuffle_refs(stream, window,
                                                   shuffles[0][1])
                return
            for ref in stream:
                yield ref
                del ref
        finally:
            # Abandoned iteration (dead consumer, early break) releases
            # every in-flight ref — the flow drain contract.
            stream.close()

    def _window_shuffle_refs(self, primed, indexed, window, seed_base):
        """Window-scoped shuffle: ``window`` consecutive blocks at a time
        go through the two-phase exchange, output ``j`` taking part ``j``
        of every block and permuting its rows (``_exchange``).  The groups,
        the seeds and the rows out are the reference's.  The port reads
        the next window only once the consumer has taken this window's
        outputs and their releases have gone to the head, and no map
        side's parts are stored, so the store holds one window's blocks
        and their outputs: within the budget, each half of it.  (The
        reference keeps the next window in flight during the exchange and
        stores the parts besides.)"""
        from ray_tpu_torch._private.worker import global_worker

        # A local-mode worker frees at once and has no queue to drain.
        drain = getattr(global_worker, "_drain_ref_gc_queue", None)
        rng = random.Random(seed_base)
        group_idx = 0
        while True:
            # The last window's outputs are dropped by now: send their
            # releases to the head before this window's blocks exist.
            if drain is not None:
                drain()
            # ``primed`` is emptied in place: the caller's list must not
            # keep the first block alive.
            group = primed[:] + [
                self._chain_source(s, i)
                for i, s in itertools.islice(indexed, window - len(primed))]
            primed.clear()
            if not group:
                return
            seed0 = (seed_base if seed_base is not None
                     else rng.randrange(2**31))
            base = seed0 + group_idx * 100003
            outs = [_exchange.remote(j, base, base + 7 + j, *group)
                    for j in range(len(group))]
            del group
            while outs:
                ref = outs.pop(0)
                yield ref
                del ref
            group_idx += 1

    def _push_shuffle_refs(self, stream, window, seed_base):
        """Push-based FULL shuffle (reference: push_based_shuffle.py's
        pipelined map+merge rounds).  Map tasks partition each block into
        P parts; after every window-sized round the parts FOLD into P
        per-partition accumulators (one merge task each), so live scratch
        is one round of parts — never the full P x num_blocks part
        matrix.  The accumulators jointly hold the whole dataset (the
        store spills past its budget; a full shuffle cannot emit row one
        until the last input row is seen), and finalize permutes each
        partition into an output block."""
        P = max(1, len(self._sources))
        rng = random.Random(seed_base)
        seed0 = (seed_base if seed_base is not None
                 else rng.randrange(2**31))
        accs: List[Any] = [None] * P
        parts_held: List[List[Any]] = [[] for _ in range(P)]
        blk_idx = 0
        # Fold cadence: merging every round would rewrite the whole
        # accumulated prefix each round (O(dataset x rounds) IO); holding
        # up to ~8 mapped blocks' parts per fold amortizes that while
        # keeping scratch bounded to fold_every rounds of parts.
        fold_every = max(1, 8 // max(1, window))
        rounds_since_fold = 0

        def fold():
            folded = []
            for j in range(P):
                if not parts_held[j]:
                    continue
                prev = [accs[j]] if accs[j] is not None else []
                accs[j] = _merge_parts.remote(*prev, *parts_held[j])
                parts_held[j] = []
                folded.append(accs[j])
            # Barrier: the held part refs die when these merges land.
            if folded:
                ray_tpu_torch.wait(folded, num_returns=len(folded),
                                   timeout=600)

        while True:
            batch = list(itertools.islice(stream, window))
            if not batch:
                break
            for b in batch:
                if P == 1:
                    # Single partition: no exchange needed — the block IS
                    # its one part (num_returns=1 would wrap the kernel's
                    # tuple return as a single tuple-valued object).
                    parts_held[0].append(b)
                    blk_idx += 1
                    continue
                parts = _partition_block.options(num_returns=P).remote(
                    b, P, seed0 + blk_idx)
                blk_idx += 1
                for j in range(P):
                    parts_held[j].append(parts[j])
            del batch
            rounds_since_fold += 1
            if rounds_since_fold >= fold_every:
                fold()
                rounds_since_fold = 0
        fold()
        for j in range(P):
            have = [accs[j]] if accs[j] is not None else []
            if not have:
                continue
            out = _finalize_partition.remote(seed0 + 31 + j, accs[j])
            accs[j] = None
            yield out
            del out

    def iter_batches(self, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False) -> Iterator[Any]:
        from ray_tpu_torch.data.dataset import _batches

        return _batches(self.iter_block_refs(), batch_size, batch_format,
                        drop_last)

    def iter_device_batches(self, batch_size: int = 256, device=None,
                            prefetch: int = 2) -> Iterator[Any]:
        """Device-resident batches with background host-to-device
        prefetch: the object-store block fetch, batch assembly and the
        copy to ``device`` (None: CUDA, through pinned memory and a side
        stream) run on a producer thread feeding a bounded queue, so the
        transfer overlaps the consumer's step (prefetch=0: inline).  The
        returned iterator supports close() and joins its thread on GC —
        see ray_tpu_torch.data.prefetch."""
        from ray_tpu_torch.data.prefetch import DevicePrefetcher

        return DevicePrefetcher(self.iter_batches(batch_size, "numpy"),
                                device=device, prefetch=prefetch)

    def count(self) -> int:
        from ray_tpu_torch.data.dataset import _count_block

        total = 0
        for ref in self.iter_block_refs():
            total += ray_tpu_torch.get(_count_block.remote(ref))
            del ref
        return total
