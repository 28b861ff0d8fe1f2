"""Cost-balanced pipeline-stage splitting for the LM families (copied
from ``ray_tpu/models/pipeline_split.py``: pure Python, the same bounds).

Both ``models/gpt2.py`` and ``models/llama.py`` split their decoder into
``num_stages * virtual_per_rank`` chunks for the MPMD pipeline
(``parallel/mpmd_pipeline.py``): blocks are partitioned by COST, not
count: the embedding lookup is nearly free but the LM-head matmul costs
``vocab_params / block_params`` block-equivalents (5+ blocks at small
widths), so the head-owning chunk gets proportionally fewer blocks.  The
embedding is pinned to chunk 0 and the head to the last chunk; with
interleaving (``virtual_per_rank > 1``) chunk c is owned by physical
stage ``c % num_stages``, which puts the embedding on stage 0 and the
head on the last stage (the Megatron assignment).
"""
from __future__ import annotations

from typing import List, Tuple


def balance_chunks(num_blocks: int, num_chunks: int, *,
                   embed_cost: float, head_cost: float
                   ) -> List[Tuple[int, int]]:
    """Partition ``num_blocks`` transformer blocks into ``num_chunks``
    contiguous ``(start, stop)`` ranges balanced by cumulative cost.

    Chunk 0 additionally carries ``embed_cost`` and the last chunk
    ``head_cost`` (in block-equivalents).  Every middle chunk owns at
    least one block; the first and last chunks may be block-free (an
    embedding-only or head-only chunk — how a tiny model still splits
    into ``S * v`` chunks), so up to ``num_blocks + 2`` chunks fit."""
    if num_chunks < 1:
        raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
    if num_chunks > num_blocks + 2:
        raise ValueError(
            f"cannot split {num_blocks} blocks into {num_chunks} chunks "
            "(middles need >= 1 block; only the embed/head chunks may be "
            "block-free)")
    per = (embed_cost + num_blocks + head_cost) / num_chunks
    bounds: List[Tuple[int, int]] = []
    start, cum = 0, embed_cost
    for c in range(num_chunks - 1):
        target = (c + 1) * per
        stop = start
        # Leave >= 1 block for every LATER middle chunk (indices
        # c+1 .. num_chunks-2).
        later_middles = max(0, num_chunks - 2 - c)
        max_stop = num_blocks - later_middles
        while stop < max_stop and cum + 1.0 <= target + 0.5:
            stop += 1
            cum += 1.0
        if stop == start and 0 < c and start < max_stop:
            stop, cum = start + 1, cum + 1.0  # middles own >= 1 block
        bounds.append((start, stop))
        start = stop
    bounds.append((start, num_blocks))
    return bounds


def chunk_flags(num_chunks: int):
    """``(first, last)`` flag pairs per chunk index."""
    return [(c == 0, c == num_chunks - 1) for c in range(num_chunks)]
