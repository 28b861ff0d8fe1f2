"""CUDA graphs of the Anakin steps' device work.

On an H100's host an eager launch call costs ~60 µs, more than the
card's work in the small RL networks' updates (SAC's 64 updates took
1.5 s an iteration eager there, 59 ms from their graphs).  ``CapturedCalls`` replays such work from a
CUDA graph: a call reads and writes only tensors that never move (the
caller draws its random numbers into static tensors before the call), so
a graph captured once replays the same work on their current values.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

Metrics = Dict[str, torch.Tensor]


class CapturedCalls:
    """Runs ``fn() -> Metrics`` eagerly on the CPU.  On CUDA
    (``use_graphs``) each variant (``kind``) runs ``WARMUP`` calls eagerly
    on a side stream (lazy initialisations, such as an optimizer's state,
    must not happen in a capture), is captured at the next and replayed
    from then on; each variant keeps its own memory pool.  The outputs of
    a replayed call are the graph's own tensors, overwritten by its next
    replay: a caller that keeps them clones them."""

    WARMUP = 3

    def __init__(self, device):
        self.use_graphs = torch.device(device).type == "cuda"
        self.graphs: Dict[Any, torch.cuda.CUDAGraph] = {}
        self.outs: Dict[Any, Metrics] = {}
        self.warm: Dict[Any, int] = {}
        self.replays = 0

    def run(self, fn: Callable[[], Metrics], kind=None) -> Metrics:
        if not self.use_graphs:
            return fn()
        if kind in self.graphs:
            self.graphs[kind].replay()
            self.replays += 1
            return self.outs[kind]
        if self.warm.get(kind, 0) < self.WARMUP:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                out = fn()
            torch.cuda.synchronize()
            self.warm[kind] = self.warm.get(kind, 0) + 1
            return out
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.outs[kind] = fn()
        self.graphs[kind] = graph
        graph.replay()
        self.replays += 1
        return self.outs[kind]


def capturable_adam(optimizer: torch.optim.Optimizer, device) -> None:
    """On CUDA, Adam's step count on the device (``capturable``), which a
    CUDA graph of the update needs; on the CPU as it is."""
    if torch.device(device).type == "cuda":
        for group in optimizer.param_groups:
            group["capturable"] = True
