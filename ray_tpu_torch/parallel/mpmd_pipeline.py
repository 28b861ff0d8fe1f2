"""MPMD pipeline parallelism: model stages owned by separate processes,
activations flowing store-to-store, driven by an async (interleaved) 1F1B
schedule (counterpart of ``ray_tpu/parallel/mpmd_pipeline.py``).

Reference papers: "Scaling Deep Learning Training with MPMD Pipeline
Parallelism" (arxiv 2412.14374), GPipe (arxiv 1811.06965) for the
microbatch decomposition, Megatron-LM's interleaved virtual-stage schedule
for the bubble shrink, and EQuARX (arxiv 2506.17615) for the block-scaled
int8 wire.  The pipeline inside one program is ``parallel/pipeline.py``;
this module is the cross-process form.

The design is the JAX package's, four legs:

1. **Stage workers.**  Each pipeline stage holds the parameters and the
   optimizer of the model chunks it owns (:class:`StageCore`).  Where the
   JAX stage runs the forward under ``jax.vjp`` inside jit and keeps the
   pullback between its compiled forward and backward, the port's forward
   keeps the chunk output's autograd graph, keyed by (slot, microbatch):
   the residuals stay on the device between the forward and the backward,
   with no recompute.  ``bwd`` calls ``torch.autograd.backward(y, dy)``
   and frees the graph; the gradients accumulate in the parameters'
   ``.grad`` with the microbatch weights of the reference, and
   ``apply_grads`` scales and steps.  The optimizer is a factory over the
   chunk's parameter tensors (``optimizer(list_of_tensors) ->
   torch.optim.Optimizer``: ``functools.partial(adamw, learning_rate=...)``
   from ``train.torch``, or ``lambda ps: torch.optim.SGD(ps, lr)``), the
   convention of ``parallel/zero.py``.

2. **Stage gangs.**  With ``gang_hosts=G`` each stage is a
   :class:`~ray_tpu_torch.parallel.mesh_group.MeshGroup` gang of G
   processes forming one ``torch.distributed`` group (gloo or NCCL by the
   backend rule of ``mesh_group.process_group_backend``): parameters are
   replicated over the gang, each microbatch is cut into G equal slices,
   rank r of stage k ships its slice to rank r of stage k+1 (cotangents
   chain back the same edges), the last chunk's loss is averaged over the
   gang, and the gradients are averaged at ``apply_grads``: an all-reduce,
   or under ``zero_sharding`` the reduce-scatter of ``parallel/zero.py``,
   which also shards the optimizer 1/G over the gang.  Stage ops ride the
   ``MeshWorker`` sequence gate, so every rank runs the same schedule in
   the same order and the collectives pair up.  The JAX package's
   ``spmd_devices`` (several devices inside one stage process) raises:
   a stage's data parallelism in the port is a process per rank, the
   decision of ROADMAP Queue 1 item 6; ``gang_hosts`` takes its place.

3. **Async interleaved 1F1B schedule.**  The driver never touches
   tensors: chunk c's forward output *ref* is chunk c+1's input (and
   cotangent refs chain back), so activations move store-to-store while
   the driver only wires the DAG.  ``virtual_per_rank=v`` assigns v
   non-contiguous model chunks to each physical stage (chunk c lives on
   stage ``c % S``) and the per-stage op order interleaves them (Megatron's
   interleaved 1F1B); :func:`simulate_schedule` predicts the bubble
   analytically and the ``mpmd_bubble_fraction`` gauge measures it.
   ``v=1`` keeps the textbook 1F1B order.

4. **Quantized inter-stage wire.**  ``wire_dtype="int8"`` ships
   activations and cotangents in the EQuARX block-scaled int8 format
   (``ops/collectives.py``; one fp32 scale per block, the block sized to
   divide the hidden dim so no padding ships): about 4x fewer bytes.
   ``wire_dtype="fp32"`` (the default) ships the tensors as they are; the
   ``mpmd_wire_bytes`` meter counts the shipped bytes against the logical
   fp32 bytes either way.

Step streaming and fault tolerance are the reference's: ``submit_step``
keeps ``step_window`` whole steps in flight; ``max_restarts > 0`` arms
store-resident snapshots, and a stage (or gang rank) death tears every
stage down, respawns them with a generation bump, restores the confirmed
snapshot and re-dispatches every step since, in order.

The pipeline runs on CUDA unless given ``device="cpu"``; on CUDA each
stage process asks for an equal share of the cluster's cards, so two
stages on one card share it.  ``stats()["jit_cache"]`` has no XLA cache behind it: it
counts the step callables each stage built for its chunks (forward,
backward, apply), which stay the same after the first step.
"""
from __future__ import annotations

import collections
import concurrent.futures
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.parallel.flow import Window as InflightWindow
from ray_tpu_torch.parallel.mesh_group import MeshGroup, gang_get

# Blocking driver<->stage syncs on the lockstep dispatch paths
# (train_step / get_params).  The async streaming path (submit_step and
# windowed drains) leaves it untouched.
_MPMD_SYNCS = {"count": 0}

_SPMD_DEVICES = (
    "spmd_devices > 1 (several devices inside one stage process) is not "
    "ported: the port's data parallelism is a process per rank (ROADMAP "
    "Queue 1 item 6); make each stage a gang of processes with gang_hosts")


def mpmd_driver_sync_count() -> int:
    """Blocking per-step driver syncs performed by the lockstep MPMD
    paths since process start.  The async 1F1B stream adds zero."""
    return _MPMD_SYNCS["count"]


def _note_sync() -> None:
    _MPMD_SYNCS["count"] += 1


def _default_optimizer(params):
    """``optax.sgd(1e-2)``, the reference's default."""
    import torch

    return torch.optim.SGD(params, lr=1e-2)


# ---------------------------------------------------------------------------
# Schedules (pure Python, copied from the JAX package)
# ---------------------------------------------------------------------------

def stage_schedule(schedule: str, num_stages: int, num_microbatches: int,
                   stage: int, virtual_per_rank: int = 1) -> List[tuple]:
    """Per-stage op order ``[("F"|"B", chunk, mb), ...]``.

    ``chunk`` is the GLOBAL virtual-stage index in ``[0, S*v)``; physical
    stage ``k`` owns the non-contiguous chunks ``{k, k+S, ..., k+(v-1)S}``
    (Megatron's interleaved assignment; for ``v=1`` chunk == stage).

    ``"1f1b"``, ``v=1``: textbook warmup of ``S - 1 - stage`` forwards,
    strict one-forward-one-backward alternation, backward cooldown; at
    most ``S - stage`` microbatches ever hold residuals on this stage.
    ``v>1``: the interleaved schedule: microbatches advance in groups of
    S through each chunk slot, warmup is ``2*(S-1-k) + (v-1)*S`` forward
    ops, then strict 1F1B alternation; requires ``M % S == 0`` (the
    Megatron constraint: groups must tile the microbatch count).
    ``"gpipe"``: all forwards (chunks ascending) then all backwards
    (descending), the naive baseline; holds every residual."""
    S, M, k, v = num_stages, num_microbatches, stage, virtual_per_rank
    if v < 1:
        raise ValueError(f"virtual_per_rank must be >= 1, got {v}")
    if schedule == "gpipe":
        ops = [("F", slot * S + k, m) for slot in range(v) for m in range(M)]
        ops += [("B", slot * S + k, m) for slot in reversed(range(v))
                for m in range(M)]
        return ops
    if schedule != "1f1b":
        raise ValueError(f"schedule must be 1f1b|gpipe, got {schedule!r}")
    if v == 1:
        warm = min(S - 1 - k, M)
        ops = [("F", k, m) for m in range(warm)]
        f, b = warm, 0
        while b < M:
            if f < M:
                ops.append(("F", k, f))
                f += 1
            ops.append(("B", k, b))
            b += 1
        return ops
    if M % S != 0:
        raise ValueError(
            f"interleaved schedule (virtual_per_rank={v}) requires "
            f"num_microbatches % num_stages == 0, got M={M}, S={S}")
    total = M * v

    def f_op(i: int) -> tuple:
        grp, within = divmod(i, S * v)
        slot, moff = divmod(within, S)
        return ("F", slot * S + k, grp * S + moff)

    def b_op(i: int) -> tuple:
        grp, within = divmod(i, S * v)
        slot = (v - 1) - within // S
        return ("B", slot * S + k, grp * S + within % S)

    warm = min(2 * (S - 1 - k) + (v - 1) * S, total)
    ops = [f_op(i) for i in range(warm)]
    f, b = warm, 0
    while b < total:
        if f < total:
            ops.append(f_op(f))
            f += 1
        ops.append(b_op(b))
        b += 1
    return ops


def simulate_schedule(schedule: str, num_stages: int, num_microbatches: int,
                      virtual_per_rank: int = 1, *, cost_f: float = 1.0,
                      cost_b: float = 2.0) -> dict:
    """Event-driven unit-cost simulation of a pipeline schedule.

    Validates feasibility (raises on deadlock: an op whose producer can
    never run) and returns the analytic envelope the real run should
    approach: ``makespan``, per-stage busy time, and ``bubble_fraction``
    = ``1 - sum(busy) / (S * makespan)``."""
    S, M, v = num_stages, num_microbatches, virtual_per_rank
    C = S * v
    queues = [collections.deque(
        stage_schedule(schedule, S, M, k, v)) for k in range(S)]
    total = sum(len(q) for q in queues)
    done: Dict[tuple, float] = {}   # (op, chunk, mb) -> finish time
    free = [0.0] * S
    busy = [0.0] * S
    while total:
        progressed = False
        for k in range(S):
            q = queues[k]
            while q:
                op, c, m = q[0]
                if op == "F":
                    dep = None if c == 0 else ("F", c - 1, m)
                else:
                    dep = None if c == C - 1 else ("B", c + 1, m)
                if dep is not None and dep not in done:
                    break
                ready = done.get(dep, 0.0) if dep is not None else 0.0
                cost = cost_f if op == "F" else cost_b
                start = max(free[k], ready)
                done[(op, c, m)] = start + cost
                free[k] = start + cost
                busy[k] += cost
                q.popleft()
                total -= 1
                progressed = True
        if not progressed:
            raise RuntimeError(
                f"{schedule} schedule deadlocked (S={S}, M={M}, v={v}): "
                f"{total} ops can never run")
    makespan = max(free)
    return {
        "makespan": makespan,
        "busy": busy,
        "bubble_fraction": 1.0 - sum(busy) / (S * makespan)
        if makespan > 0 else 0.0,
    }


# ---------------------------------------------------------------------------
# host <-> device trees
# ---------------------------------------------------------------------------

def _host(x):
    """A tensor as a host value that pickles as it is: a numpy array (a
    CPU tensor for the dtypes numpy lacks)."""
    import torch

    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.clone()
        return x.numpy().copy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _device(x, device):
    """Inverse of ``_host``: numpy arrays and CPU tensors onto ``device``
    (integer arrays as int64, the index dtype)."""
    import torch

    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
        t = torch.from_numpy(x if x.flags.writeable else x.copy())
        if not t.is_floating_point():
            t = t.long()
        return t.to(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _device(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_device(v, device) for v in x)
    return x


def _nbytes(x) -> int:
    return int(x.nbytes)


class _Upstream:
    """A gang rank's input from another stage, as a ref the op resolves
    itself once its turn at the sequence gate comes: a rank then holds no
    thread per input still being produced upstream, and fetches each one
    when the op that needs it runs."""
    __slots__ = ("ref",)

    def __init__(self, ref):
        self.ref = ref


def _upstream(x, timeout: Optional[float]):
    if isinstance(x, _Upstream):
        return ray_tpu_torch.get(x.ref, timeout=timeout)
    return x


# ---------------------------------------------------------------------------
# StageCore: the in-process stage engine (shared by the solo actor and
# the gang ranks)
# ---------------------------------------------------------------------------

class StageCore:
    """One pipeline stage's chunks, optimizers and schedule state, for
    the v model chunks this physical stage owns.

    ``chunk_fns[slot]`` is the fn of global chunk ``slot * S + stage_id``:
    ``fn(params, x)`` for middle chunks, ``loss_fn(params, x, target)``
    for the last global chunk; ``params`` a dict of tensors.
    ``chunk_params[slot]`` is such a dict (of tensors or numpy arrays) or
    a zero-arg factory run here (XL-scale parameters never visit the
    driver).  ``device`` is where the chunk runs: CUDA by default (raising
    where there is none), "cpu" only when asked for.

    ``gang_size > 1``: this process is rank ``gang_rank`` of a
    ``torch.distributed`` group (the default group of a ``MeshGroup``
    rank); its microbatches are its slices, its loss and gradients are
    averaged over the group.  ``zero_sharding`` ("opt" or "opt+grads")
    shards the optimizer over the group (``parallel/zero.py``).

    ``wire_dtype="int8"``: non-first inputs and non-last outputs cross
    the stage boundary as block-scaled int8; cotangents use the producing
    edge's format symmetrically."""

    def __init__(self, chunk_fns: Sequence[Callable],
                 chunk_params: Sequence[Any], optimizer=None, *,
                 stage_id: int = 0, num_stages: int = 1,
                 virtual_per_rank: int = 1, wire_dtype: str = "fp32",
                 wire_block: int = 256, spmd_devices: int = 0,
                 zero_sharding: str = "off", gang_rank: int = 0,
                 gang_size: int = 1, device: Optional[str] = None,
                 fetch_timeout: Optional[float] = None,
                 restore_from: Any = None):
        import torch

        from ray_tpu_torch._device import resolve_device

        self._torch = torch
        self.stage_id = int(stage_id)
        self.num_stages = int(num_stages)
        self.v = int(virtual_per_rank)
        self.num_chunks = self.num_stages * self.v
        self.gang_rank = int(gang_rank)
        self.gang_size = int(gang_size)
        if wire_dtype not in ("fp32", "int8"):
            raise ValueError(f"wire_dtype must be fp32|int8, "
                             f"got {wire_dtype!r}")
        if spmd_devices and int(spmd_devices) > 1:
            raise NotImplementedError(_SPMD_DEVICES)
        if zero_sharding != "off" and self.gang_size <= 1:
            raise ValueError(
                "zero_sharding requires gang_hosts > 1 (the optimizer "
                "shards over the stage's gang)")
        self.wire_dtype = wire_dtype
        self.wire_block = int(wire_block)
        self.fetch_timeout = fetch_timeout
        if len(chunk_fns) != self.v or len(chunk_params) != self.v:
            raise ValueError(
                f"stage {stage_id} expected {self.v} chunk fns/params, "
                f"got {len(chunk_fns)}/{len(chunk_params)}")
        self.fns = list(chunk_fns)
        self.tx = optimizer or _default_optimizer
        if not callable(self.tx):
            raise TypeError(
                f"optimizer must be a factory over a chunk's parameter "
                f"tensors (tensors -> torch.optim.Optimizer), got "
                f"{type(self.tx).__name__}")
        self.device = resolve_device(device)
        self.params = [self._place(p() if callable(p) else p)
                       for p in chunk_params]

        # --- step callables, one triplet per owned chunk ---
        self._fwd: List[Callable] = []
        self._bwd: List[Callable] = []
        self._apply: List[Callable] = []
        self._zero: List[Any] = [None] * self.v
        self._zero_info: List[Any] = [None] * self.v
        self.opt_state: List[Any] = []
        for slot in range(self.v):
            self._build_chunk(slot, zero_sharding)
        if restore_from is not None:
            self.restore(restore_from)

        # --- schedule state ---
        # (slot, mb) -> (output with its graph, input, weight, step)
        self._resid: Dict[tuple, tuple] = {}
        self._step_count = 0
        # --- per-step observability ---
        self._ops: List[dict] = []
        self._peak_inflight = 0
        self._act_bytes = 0    # logical fp32 boundary bytes
        self._wire_bytes = 0   # bytes actually shipped through the store

    # ---- chunk program construction ----
    def _place(self, tree) -> Dict[str, Any]:
        """A chunk's parameters as fp32 leaf tensors on the device, each
        requiring grad."""
        torch = self._torch
        out = {}
        for k, v in dict(tree).items():
            t = torch.as_tensor(np.asarray(v)) if not isinstance(
                v, torch.Tensor) else v.detach()
            out[k] = t.to(self.device, torch.float32).clone() \
                .requires_grad_(True)
        return out

    def _global_chunk(self, slot: int) -> int:
        return slot * self.num_stages + self.stage_id

    def _is_last_chunk(self, slot: int) -> bool:
        return self._global_chunk(slot) == self.num_chunks - 1

    def _wire_block_for(self, n: int) -> int:
        """Largest block <= wire_block that divides n: the quantized
        payload then pads nothing."""
        wb = max(1, self.wire_block)
        if n <= wb:
            return n
        for d in range(wb, 0, -1):
            if n % d == 0:
                return d
        return n

    def _build_chunk(self, slot: int, zero_sharding: str):
        from ray_tpu_torch.ops import collectives as coll

        torch = self._torch
        gc = self._global_chunk(slot)
        first = gc == 0
        last = self._is_last_chunk(slot)
        in_wire = (not first) and self.wire_dtype == "int8"
        out_wire = (not last) and self.wire_dtype == "int8"
        fn = self.fns[slot]
        core = self
        group = None  # the gang's default process group

        def dequant(payload):
            q, s = payload["q"], payload["s"]
            return coll.dequantize_block_int8(q, s, q.shape[-1],
                                              torch.float32)

        def quant(y):
            q, s = coll.quantize_block_int8(
                y, core._wire_block_for(y.shape[-1]))
            return {"q": q, "s": s}

        def fwd_impl(params, x, *extra):
            """-> (output to ship or loss, graph output, graph input)."""
            if in_wire:
                x = dequant(x)
            if not first:
                x = x.detach().requires_grad_(True)
            with torch.enable_grad():
                y = fn(params, x, *extra)
            if last:
                loss = y.detach()
                if core.gang_size > 1:
                    loss = coll.all_reduce_sum(loss, group) / core.gang_size
                return loss, y, x
            ship = y.detach()
            return (quant(ship) if out_wire else ship), y, x

        def bwd_impl(y, x, dy):
            if out_wire:
                dy = dequant(dy)
            torch.autograd.backward(y, dy.to(y.dtype))
            if first:
                return None
            dx = x.grad
            return quant(dx) if in_wire else dx

        def apply_impl(params, opt, scale):
            leaves = list(params.values())
            with torch.no_grad():
                grads = [torch.zeros_like(p) if p.grad is None else p.grad
                         for p in leaves]
                if scale != 1.0:
                    grads = [g * scale for g in grads]
                if core.gang_size > 1:
                    grads = [coll.all_reduce_sum(g, group) / core.gang_size
                             for g in grads]
                for p, g in zip(leaves, grads):
                    p.grad = g
                opt.step()
            for p in leaves:
                p.grad = None
            return opt

        self._fwd.append(fwd_impl)
        self._bwd.append(bwd_impl)
        if zero_sharding != "off":
            self._build_zero_apply(slot, zero_sharding)
        else:
            self._apply.append(apply_impl)
            self.opt_state.append(self.tx(list(self.params[slot].values())))

    def _build_zero_apply(self, slot: int, zero_sharding: str):
        """Per-chunk ZeRO optimizer (parallel/zero.py): state sharded 1/G
        over the gang; the update reduce-scatters the gradient (the mean
        over the gang) itself."""
        from ray_tpu_torch.parallel import zero as zero_mod

        torch = self._torch
        zu = zero_mod.build_zero_update(
            self.params[slot], self.tx, self.gang_size,
            zero_sharding=zero_sharding)
        self._zero[slot] = zu
        self._zero_info[slot] = zero_mod.export_zero_metrics(
            zu.sharder, self.tx, zero_sharding=zero_sharding,
            quantized="off")

        def apply_impl(params, opt, scale):
            with torch.no_grad():
                grads = {k: (torch.zeros_like(p) if p.grad is None
                             else p.grad) * scale
                         for k, p in params.items()}
                zu.update(grads, opt, params)
            for p in params.values():
                p.grad = None
            return opt

        self._apply.append(apply_impl)
        self.opt_state.append(zu.init_opt(self.params[slot],
                                          self.gang_rank))

    # ---- host<->device plumbing ----
    def _wire_in(self, payload):
        """Host wire payload (this rank's slice) -> device."""
        return _device(payload, self.device)

    def _wire_out(self, y) -> Any:
        """Device boundary value -> host wire payload + byte accounting."""
        if isinstance(y, dict) and "q" in y:
            q, s = _host(y["q"]), _host(y["s"])
            self._act_bytes += q.size * 4          # logical fp32 bytes
            self._wire_bytes += _nbytes(q) + _nbytes(s)
            return {"q": q, "s": s}
        out = _host(y)
        self._act_bytes += _nbytes(out)
        self._wire_bytes += _nbytes(out)
        return out

    def _record(self, kind: str, step: int, mb: int, t0: float, t1: float):
        self._ops.append({"kind": kind, "stage": self.stage_id,
                          "step": step, "mb": mb, "start": t0, "end": t1})

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self._torch.cuda.synchronize(self.device)

    # ---- schedule ops (driver-dispatched, executed in strict order) ----
    def fwd(self, step: int, slot: int, mb: int, x, target=None,
            weight: float = 1.0):
        """Forward one microbatch through chunk ``slot``; its graph (the
        residuals) stays here.  Middle chunks return the (possibly
        int8-packed) activation slice; the last chunk its scalar loss."""
        from ray_tpu_torch._private import chaos

        chaos.maybe_die("mpmd_fwd", self.stage_id)
        last = self._is_last_chunk(slot)
        t_in0 = time.time()
        x_dev = self._wire_in(_upstream(x, self.fetch_timeout))
        extra = ()
        if last:
            if target is None:
                raise ValueError("last chunk forward requires a target")
            extra = (self._wire_in(target),)
        t0 = time.time()
        out, y, x_in = self._fwd[slot](self.params[slot], x_dev, *extra)
        self._sync()
        t1 = time.time()
        self._resid[(slot, mb)] = (y, x_in, float(weight), step)
        self._peak_inflight = max(self._peak_inflight, len(self._resid))
        self._record("X", step, mb, t_in0, t0)
        self._record("F", step, mb, t0, t1)
        if last:
            return float(out)
        out = self._wire_out(out)
        self._record("X", step, mb, t1, time.time())
        return out

    def bwd(self, step: int, slot: int, mb: int, dy=None):
        """Backward one microbatch on chunk ``slot``: consume the stored
        graph, accumulate the parameter gradients, ship the input
        cotangent upstream (chunk 0 returns a token)."""
        from ray_tpu_torch._private import chaos

        chaos.maybe_die("mpmd_bwd", self.stage_id)
        y, x_in, weight, fwd_step = self._resid.pop((slot, mb))
        if fwd_step != step:
            raise RuntimeError(
                f"stage {self.stage_id}: bwd(step={step}, slot={slot}, "
                f"mb={mb}) found residuals of step {fwd_step}: schedule "
                "corrupted")
        gc = self._global_chunk(slot)
        t_in0 = time.time()
        if dy is None:
            # Last chunk: d(loss)/d(loss), scaled by this microbatch's
            # weight (its row share of the global batch) so ragged
            # microbatches accumulate exact full-batch gradients.
            dy = self._torch.tensor(weight, dtype=self._torch.float32,
                                    device=self.device)
        else:
            dy = self._wire_in(_upstream(dy, self.fetch_timeout))
        t0 = time.time()
        dx = self._bwd[slot](y, x_in, dy)
        self._sync()
        t1 = time.time()
        self._record("X", step, mb, t_in0, t0)
        self._record("B", step, mb, t0, t1)
        if gc == 0:
            return mb
        out = self._wire_out(dx)
        self._record("X", step, mb, t1, time.time())
        return out

    def apply_grads(self, scale: float = 1.0) -> dict:
        """Optimizer step on every owned chunk's accumulated gradients;
        returns this step's observability payload."""
        from ray_tpu_torch._private import chaos

        chaos.maybe_die("mpmd_apply", self.stage_id)
        if self._resid:
            raise RuntimeError(
                f"stage {self.stage_id}: apply with {len(self._resid)} "
                "unconsumed residuals: schedule corrupted")
        t0 = time.time()
        for slot in range(self.v):
            self.opt_state[slot] = self._apply[slot](
                self.params[slot], self.opt_state[slot], float(scale))
        self._sync()
        t1 = time.time()
        self._step_count += 1
        self._record("A", self._step_count - 1, -1, t0, t1)
        out = self.stats()
        self._ops = []
        self._peak_inflight = 0
        return out

    def stats(self) -> dict:
        out = {
            "stage": self.stage_id,
            "rank": self.gang_rank,
            "steps": self._step_count,
            "peak_inflight": self._peak_inflight,
            "act_bytes": self._act_bytes,
            "wire_bytes": self._wire_bytes,
            "ops": list(self._ops),
            "busy_s": sum(o["end"] - o["start"] for o in self._ops
                          if o["kind"] in ("F", "B", "A")),
            # Step callables built for the owned chunks: no retrace
            # cache exists in eager PyTorch; the count stays put.
            "jit_cache": {"fwd": len(self._fwd), "bwd": len(self._bwd),
                          "apply": len(self._apply)},
        }
        if self._zero_info[0] is not None:
            out["zero_opt_bytes_per_replica"] = sum(
                zi["zero_opt_bytes_per_replica"] for zi in self._zero_info)
            out["replicated_opt_bytes"] = sum(
                zi["replicated_opt_bytes"] for zi in self._zero_info)
        return out

    # ---- lifecycle / fault tolerance ----
    def reset(self):
        """Drop partial schedule state after a failed step: stale
        gradients must not leak into the next optimizer update."""
        self._resid.clear()
        for p in self.params:
            for t in p.values():
                t.grad = None
        self._ops = []
        self._peak_inflight = 0
        return True

    def snapshot(self):
        """Host copy of (per-chunk params, per-chunk optimizer state,
        step).  A ZeRO-sharded state is all-gathered to its global tree
        first (``zero.gather_opt_state``), so every gang rank snapshots
        the same bytes and any rank's ref can restore any future rank."""
        from ray_tpu_torch.parallel import zero as zero_mod

        params = [_host(p) for p in self.params]
        opts = []
        for slot in range(self.v):
            opt = self.opt_state[slot]
            if self._zero[slot] is not None:
                opts.append(_host(zero_mod.gather_opt_state(opt)))
            else:
                opts.append(_host(opt.state_dict()))
        return (params, opts, self._step_count)

    def restore(self, snap):
        params, opts, step_count = snap
        torch = self._torch
        for slot in range(self.v):
            with torch.no_grad():
                for k, t in self.params[slot].items():
                    t.copy_(_device(params[slot][k], self.device))
            if self._zero[slot] is not None:
                self.opt_state[slot].load_global_tree(opts[slot])
            else:
                self.opt_state[slot].load_state_dict(
                    _device(opts[slot], "cpu"))
        self._step_count = int(step_count)
        return True

    def get_params(self):
        """Host params (dicts of numpy arrays); the per-chunk list for
        v > 1, the bare dict for v == 1."""
        out = [_host(p) for p in self.params]
        return out[0] if self.v == 1 else out


@ray_tpu_torch.remote
class PipelineStage:
    """One single-process pipeline stage: a :class:`StageCore` behind an
    actor boundary (the ``gang_hosts=1`` deployment).  Methods execute
    in strict submission order (the actor is single-threaded), which is
    what makes the driver-side schedule an execution order."""

    def __init__(self, chunk_fns, chunk_params, optimizer=None, *,
                 stage_id: int = 0, num_stages: int = 1,
                 virtual_per_rank: int = 1, generation: int = 0,
                 wire_dtype: str = "fp32", wire_block: int = 256,
                 spmd_devices: int = 0, zero_sharding: str = "off",
                 device: Optional[str] = None, restore_from: Any = None):
        import os

        from ray_tpu_torch._private import chaos

        os.environ[chaos.GENERATION_ENV] = str(generation)
        if not isinstance(chunk_fns, (list, tuple)):
            chunk_fns, chunk_params = [chunk_fns], [chunk_params]
        self.core = StageCore(
            list(chunk_fns), list(chunk_params), optimizer,
            stage_id=stage_id, num_stages=num_stages,
            virtual_per_rank=virtual_per_rank, wire_dtype=wire_dtype,
            wire_block=wire_block, spmd_devices=spmd_devices,
            zero_sharding=zero_sharding, device=device,
            restore_from=restore_from)
        self.stage_id = self.core.stage_id

    def fwd(self, step, slot, mb, x, target=None, weight: float = 1.0):
        return self.core.fwd(step, slot, mb, x, target, weight)

    def bwd(self, step, slot, mb, dy=None):
        return self.core.bwd(step, slot, mb, dy)

    def apply_grads(self, scale: float = 1.0) -> dict:
        return self.core.apply_grads(scale)

    def stats(self) -> dict:
        return self.core.stats()

    def ping(self) -> int:
        return self.stage_id

    def reset(self):
        return self.core.reset()

    def snapshot(self):
        return self.core.snapshot()

    def restore(self, snap):
        return self.core.restore(snap)

    def get_params(self):
        return self.core.get_params()

    def run(self, fn: Callable, *args, **kwargs):
        """``fn(core, *args, **kwargs)`` in the stage's process, in order
        with its schedule ops: a reading of the stage's state (its
        device's memory, a counter) where it lives."""
        return fn(self.core, *args, **kwargs)


# ---- gang-rank entry points (run inside MeshWorker.pipeline_step with
# the worker's state dict: importable module functions, never closures) ----

def _gang_stage_setup(state, kwargs: dict, restore_snap=None):
    from ray_tpu_torch.parallel.mpmd_pipeline import StageCore

    state["mpmd_core"] = StageCore(restore_from=restore_snap, **kwargs)
    return True


def _gang_stage_op(state, op: str, *args, **kwargs):
    return getattr(state["mpmd_core"], op)(*args, **kwargs)


# ---------------------------------------------------------------------------
# Driver-side stage handles
# ---------------------------------------------------------------------------

class _SoloStage:
    """Driver handle for a single-actor stage (width 1)."""

    width = 1

    def __init__(self, actor):
        self.actor = actor

    def submit(self, op: str, per_rank_args: Sequence[tuple],
               **kwargs) -> List[Any]:
        return [getattr(self.actor, op).remote(*per_rank_args[0], **kwargs)]

    def ping_refs(self) -> List[Any]:
        return [self.actor.ping.remote()]

    def resync(self) -> None:
        pass  # solo actors have no sequence gate to clear

    def kill(self) -> None:
        try:
            ray_tpu_torch.kill(self.actor)
        except Exception:
            pass


class _GangStage:
    """Driver handle for a stage gang: every op is one gated
    ``MeshWorker.pipeline_step`` per rank at the next sequence position,
    so all ranks execute the identical op order, which keeps each rank's
    collectives matched with its peers'.  Inputs from other stages go as
    ``_Upstream`` refs, fetched by the op when its turn comes."""

    def __init__(self, group: MeshGroup):
        self.group = group
        self.width = group.num_hosts
        self._seq = 0

    def submit(self, op: str, per_rank_args: Sequence[tuple],
               **kwargs) -> List[Any]:
        args_per_rank = [(_gang_stage_op, op) + tuple(
            _Upstream(v) if isinstance(v, ray_tpu_torch.ObjectRef) else v
            for v in a) for a in per_rank_args]
        refs = self.group.submit_ordered(self._seq, args_per_rank,
                                         kwargs=kwargs)
        self._seq += 1
        return refs

    def setup(self, kwargs_base: dict, restore: Optional[List[Any]],
              timeout: float) -> None:
        self.group.seek_ranks(0)
        self._seq = 0
        per_rank = []
        for r in range(self.width):
            kw = dict(kwargs_base, gang_rank=r, gang_size=self.width)
            per_rank.append((_gang_stage_setup, kw,
                             None if restore is None else restore[r]))
        refs = self.group.submit_ordered(self._seq, per_rank)
        self._seq += 1
        gang_get(refs, timeout=timeout)

    def ping_refs(self) -> List[Any]:
        return [w.ping.remote() for w in self.group.workers]

    def resync(self) -> None:
        """Clear a poisoned sequence gate (a failed op fails every later
        queued op on its rank) so post-abort dispatch can resume."""
        self.group.seek_ranks(self._seq)

    def kill(self) -> None:
        try:
            self.group.shutdown()
        except Exception:
            pass


class _StepRec:
    """One submitted step: the host microbatches (for replay), the refs
    the driver drains, and bookkeeping flags.  ``aux_refs`` pins every
    intermediate activation/cotangent ref until the step drains: dropping
    them at dispatch would let ref-gc free a store-resident activation
    before its consumer stage resolved it."""
    __slots__ = ("idx", "xs", "ts", "weights", "loss_refs", "apply_refs",
                 "aux_refs", "snap", "drained", "trace_ctx")

    def __init__(self, idx, xs, ts, weights, snap):
        self.idx = idx
        self.xs = xs
        self.ts = ts
        self.weights = weights
        self.loss_refs: List[Any] = []
        self.apply_refs: List[Any] = []
        self.aux_refs: List[Any] = []
        self.snap = snap
        self.drained = False
        # One distributed trace per step (minted at dispatch, reused for
        # replay re-dispatch and the mpmd_stage_* spans at drain).
        self.trace_ctx = None


def _mpmd_metrics():
    """Lazy metric handles (internal_kv needs a connected driver)."""
    from ray_tpu_torch.util.metrics import Counter, Gauge, Meter

    return {
        "bubble": Gauge("mpmd_bubble_fraction",
                        "1 - busy/(stages*wall) of the last drained step"),
        "steps": Counter("mpmd_steps_total", "pipeline train steps drained"),
        "replays": Counter("mpmd_replays_total",
                           "gang restarts absorbed by schedule replay"),
        "act_bytes": Meter("mpmd_activation_bytes",
                           "logical fp32 activation/cotangent bytes at "
                           "the stage boundaries"),
        "wire": Meter("mpmd_wire_bytes",
                      "activation/cotangent bytes actually shipped "
                      "through the object store (int8 wire shrinks "
                      "these ~4x vs mpmd_activation_bytes)"),
        "idle": Gauge("mpmd_stage_idle_frac",
                      "per-stage idle fraction of the last drained step",
                      tag_keys=("stage",)),
        "inflight": Gauge("mpmd_peak_inflight_microbatches",
                          "peak microbatches holding residuals on any "
                          "stage in the last drained step"),
    }


class MPMDPipeline:
    """Driver-side async (interleaved) 1F1B schedule over stage actors or
    stage gangs.

    ``stage_fns``: ``num_stages * virtual_per_rank`` chunk callables in
    GLOBAL chunk order; the last must be ``loss_fn(params, x, target) ->
    scalar``.  Chunk c is owned by physical stage ``c % num_stages``.
    ``init_params``: per-chunk dicts of tensors or numpy arrays, OR
    zero-arg factories (run on the stage).  ``optimizer``: a factory over
    a chunk's parameter tensors (SGD at 1e-2 when None).
    ``stage_options``: per-stage StageCore kwargs (``zero_sharding``).

    - ``virtual_per_rank=v``: interleaved virtual stages.
    - ``wire_dtype="int8"``: block-scaled int8 activations and cotangents
      on the inter-stage wire.
    - ``gang_hosts=G``: every stage a G-process ``MeshGroup`` gang.
    - ``device``: "cuda" (the default) or "cpu"; on CUDA every stage
      process asks for an equal share of the cluster's cards (at most
      one).

    Lockstep use::

        pipe = MPMDPipeline([f0, loss_fn], [p0, p1], num_microbatches=4)
        loss = pipe.train_step(x, t)        # one blocking sync per step

    Streaming use (the zero-sync hot path)::

        for x, t in batches:
            pipe.submit_step(x, t)          # <= step_window in flight
        losses = pipe.flush()               # [(step_idx, loss), ...]

    Fault tolerance: ``max_restarts > 0`` arms snapshotting (every
    ``snapshot_interval`` steps, store-resident) and replay: a stage or
    gang-rank death respawns every stage from the latest confirmed
    snapshot and re-dispatches every step since, in order."""

    def __init__(self, stage_fns: Sequence[Callable],
                 init_params: Sequence[Any], optimizer=None,
                 num_microbatches: int = 4,
                 stage_options: Optional[List[dict]] = None, *,
                 schedule: str = "1f1b", virtual_per_rank: int = 1,
                 wire_dtype: str = "fp32", wire_block: int = 256,
                 gang_hosts: int = 1, device: Optional[str] = None,
                 step_window: int = 2, max_restarts: int = 0,
                 snapshot_interval: int = 1,
                 drain_timeout: Optional[float] = None,
                 bootstrap_timeout: float = 180.0,
                 export_metrics: bool = True):
        from ray_tpu_torch._device import resolve_device

        v = max(1, int(virtual_per_rank))
        if len(stage_fns) % v != 0:
            raise ValueError(
                f"{len(stage_fns)} chunk fns do not tile "
                f"virtual_per_rank={v}")
        n = len(stage_fns) // v
        if len(init_params) != len(stage_fns):
            raise ValueError("one params pytree per chunk fn")
        if schedule not in ("1f1b", "gpipe"):
            raise ValueError(f"schedule must be 1f1b|gpipe, got {schedule!r}")
        if v > 1 and int(num_microbatches) % n != 0:
            raise ValueError(
                f"interleaved schedule needs num_microbatches divisible "
                f"by num_stages ({num_microbatches} % {n} != 0)")
        if wire_dtype not in ("fp32", "int8"):
            raise ValueError(f"wire_dtype must be fp32|int8, "
                             f"got {wire_dtype!r}")
        for opts in stage_options or []:
            if int(opts.get("spmd_devices") or 0) > 1:
                raise NotImplementedError(_SPMD_DEVICES)
        self.num_stages = n
        self.virtual_per_rank = v
        self.num_chunks = n * v
        self.num_microbatches = int(num_microbatches)
        self.schedule = schedule
        self.wire_dtype = wire_dtype
        self.wire_block = int(wire_block)
        self.gang_hosts = max(1, int(gang_hosts))
        self.device = resolve_device(device).type
        self.stage_gpus = self._stage_gpus()
        self.step_window = max(1, int(step_window))
        self.max_restarts = int(max_restarts)
        self.snapshot_interval = max(1, int(snapshot_interval))
        self.drain_timeout = drain_timeout
        self.bootstrap_timeout = bootstrap_timeout
        self.restart_count = 0
        self._stage_fns = list(stage_fns)
        self._init_params = list(init_params)
        self._optimizer = optimizer
        self._stage_opts = list(stage_options or [{} for _ in range(n)])
        if len(self._stage_opts) != n:
            raise ValueError(f"stage_options must have one entry per "
                             f"PHYSICAL stage ({n}), got "
                             f"{len(self._stage_opts)}")
        self._generation = 0
        self.stages: List[Any] = []       # solo actor handles (width 1)
        self._gangs: List[MeshGroup] = []  # stage gangs (width > 1)
        self._handles: List[Any] = []
        self._spawn_stages(restore_refs=None)

        self._window: InflightWindow = InflightWindow(self.step_window)
        self._replay: collections.deque = collections.deque()  # _StepRec
        self._results: List[tuple] = []
        self._next_idx = 0
        self._snap: Optional[tuple] = None          # (idx, [[refs]/stage])
        self._pending_snap: Optional[tuple] = None
        self._last_report: Optional[dict] = None
        self._act_bytes_total = 0
        self._wire_bytes_total = 0
        self._busy_total = 0.0
        self._wall_total = 0.0
        self._peak_window = 0
        self._metrics = None
        if export_metrics:
            try:
                self._metrics = _mpmd_metrics()
            except Exception:
                self._metrics = None

    def _stage_gpus(self) -> float:
        """The card share each stage process asks for: 0 on the CPU; on
        CUDA the cluster's cards spread over the ``num_stages *
        gang_hosts`` processes, at most one each."""
        if self.device != "cuda":
            return 0.0
        cards = float(ray_tpu_torch.cluster_resources().get("GPU", 0.0))
        if cards <= 0:
            raise RuntimeError(
                "an MPMD pipeline on CUDA needs GPUs in the cluster "
                "(ray_tpu_torch.init(num_gpus=...)); pass device='cpu' to "
                "run the stages on the CPU")
        return min(1.0, cards / (self.num_stages * self.gang_hosts))

    # ---- stage fn / param assignment ----
    def _chunks_of(self, k: int) -> List[int]:
        return [slot * self.num_stages + k
                for slot in range(self.virtual_per_rank)]

    def _stage_kwargs(self, k: int) -> dict:
        return dict(
            stage_id=k, num_stages=self.num_stages,
            virtual_per_rank=self.virtual_per_rank,
            wire_dtype=self.wire_dtype, wire_block=self.wire_block,
            device=self.device, **self._stage_opts[k])

    # ---- gang lifecycle ----
    def _spawn_stages(self, restore_refs) -> None:
        n = self.num_stages
        fns = [[self._stage_fns[c] for c in self._chunks_of(k)]
               for k in range(n)]
        params = [[self._init_params[c] for c in self._chunks_of(k)]
                  for k in range(n)]
        if self.gang_hosts == 1:
            opts = {"num_gpus": self.stage_gpus} if self.stage_gpus else {}
            self.stages = [
                PipelineStage.options(**opts).remote(
                    fns[k], params[k], self._optimizer,
                    generation=self._generation,
                    restore_from=None if restore_refs is None
                    else restore_refs[k][0],
                    **self._stage_kwargs(k))
                for k in range(n)
            ]
            self._handles = [_SoloStage(a) for a in self.stages]
            return
        # One MeshGroup gang per stage, all spawned at once (placement,
        # the workers' start and the rendezvous are the slow part and
        # independent), then every gang's setup at once.
        res = {"CPU": 1.0}
        if self.stage_gpus:
            res["GPU"] = self.stage_gpus
        # Every op of the steps in flight waits for its turn on its own
        # thread of a rank (the sequence gate), and a ping keeps a spare:
        # a rank whose threads all wait behind an op still queued (its
        # producer late, or failed upstream) would never run it.
        ops = 2 * self.virtual_per_rank * self.num_microbatches + 2
        depth = (self.step_window + 1) * ops
        self.stages = []
        with concurrent.futures.ThreadPoolExecutor(n) as pool:
            self._gangs = list(pool.map(
                lambda _: MeshGroup(self.gang_hosts,
                                    resources_per_host=dict(res),
                                    bootstrap_timeout=self.bootstrap_timeout,
                                    pipeline_depth=depth), range(n)))
            self._handles = [_GangStage(g) for g in self._gangs]
            list(pool.map(lambda k: self._handles[k].setup(
                dict(self._stage_kwargs(k), chunk_fns=fns[k],
                     chunk_params=params[k], optimizer=self._optimizer,
                     fetch_timeout=self.drain_timeout),
                None if restore_refs is None else restore_refs[k],
                timeout=self.bootstrap_timeout), range(n)))

    def _teardown_stages(self) -> None:
        for h in self._handles:
            h.kill()
        self.stages = []
        self._gangs = []
        self._handles = []

    def _dead_stages(self, deadline: float = 15.0) -> List[int]:
        """Bounded ping fan-out over every rank of every stage; returns
        the stage ids with any dead/unresponsive rank."""
        refs, owner = [], []
        for k, h in enumerate(self._handles):
            for r in h.ping_refs():
                refs.append(r)
                owner.append(k)
        try:
            gang_get(refs, timeout=deadline)
            return []
        except exc.MeshGroupError as e:
            return sorted({owner[i] for i in e.failed_ranks})
        except Exception:
            return list(range(self.num_stages))

    # ---- batch slicing ----
    def _rank_split(self, arr: np.ndarray, width: int) -> List[np.ndarray]:
        if width == 1:
            return [arr]
        return np.split(arr, width)

    # ---- schedule dispatch (pure ref wiring: no tensors, no waits) ----
    def _dispatch_step(self, rec: _StepRec) -> None:
        from ray_tpu_torch import observability as obs

        minted = False
        if rec.trace_ctx is None and obs.enabled():
            # Join the caller's trace when one is live; mint a fresh
            # per-step root else.
            rec.trace_ctx = obs.get_context()
            if rec.trace_ctx is None:
                rec.trace_ctx = obs.mint_context()
                minted = True
        if rec.trace_ctx is not None:
            # Dispatch inside the step's trace: every stage submit below
            # inherits it, so one training step assembles into one
            # cross-process timeline.
            from ray_tpu_torch._private import profiling

            t0 = time.perf_counter()
            with obs.use_context(rec.trace_ctx):
                self._dispatch_step_inner(rec)
            # A freshly minted step records its dispatch AS the trace
            # root: the stage actors' execute spans parent to the root
            # id, and flow arrows need that span to exist.
            profiling.record_span("mpmd_step_dispatch", t0,
                                  time.perf_counter(), step=rec.idx,
                                  _trace_ctx=rec.trace_ctx, _root=minted)
            return
        self._dispatch_step_inner(rec)

    def _dispatch_step_inner(self, rec: _StepRec) -> None:
        if rec.snap:
            refs = [h.submit("snapshot", [() for _ in range(h.width)])
                    for h in self._handles]
            self._pending_snap = (rec.idx, refs)
        S, M, v = self.num_stages, len(rec.xs), self.virtual_per_rank
        C = self.num_chunks
        queues = [collections.deque(
            stage_schedule(self.schedule, S, M, k, v)) for k in range(S)]
        acts: Dict[tuple, List[Any]] = {}
        cots: Dict[tuple, List[Any]] = {}
        classic = self.schedule == "1f1b" and v == 1
        window = InflightWindow(S if classic else M)
        rec.loss_refs, rec.apply_refs = [], []
        aux: List[Any] = []
        remaining = sum(len(q) for q in queues)
        while remaining:
            progressed = False
            for k in range(S):
                q = queues[k]
                h = self._handles[k]
                while q:
                    op, c, m = q[0]
                    slot = c // S
                    if op == "F":
                        if c == 0:
                            srcs = self._rank_split(rec.xs[m], h.width)
                        else:
                            srcs = acts.get((c - 1, m))
                            if srcs is None:
                                break
                        if c == 0:
                            window.append(m)
                            self._peak_window = max(self._peak_window,
                                                    len(window))
                            if classic and window.over_depth:
                                raise RuntimeError(
                                    "1F1B scheduler admitted more than "
                                    f"{window.depth} microbatches")
                        if c == C - 1:
                            tgt = self._rank_split(rec.ts[m], h.width)
                            refs = h.submit(
                                "fwd",
                                [(rec.idx, slot, m, srcs[r], tgt[r],
                                  float(rec.weights[m]))
                                 for r in range(h.width)])
                            rec.loss_refs.append(refs[0])
                            aux += refs[1:]
                        else:
                            refs = h.submit(
                                "fwd",
                                [(rec.idx, slot, m, srcs[r])
                                 for r in range(h.width)])
                            acts[(c, m)] = refs
                    else:  # "B"
                        if c == C - 1:
                            dys: Optional[List[Any]] = None
                        else:
                            dys = cots.get((c + 1, m))
                            if dys is None:
                                break
                        if c == 0:
                            window.remove(m)
                        refs = h.submit(
                            "bwd",
                            [(rec.idx, slot, m,
                              None if dys is None else dys[r])
                             for r in range(h.width)])
                        cots[(c, m)] = refs
                    q.popleft()
                    remaining -= 1
                    progressed = True
            if not progressed:
                raise RuntimeError(
                    f"{self.schedule} schedule deadlocked with "
                    f"{remaining} ops pending (S={S}, M={M}, v={v})")
        for h in self._handles:
            rec.apply_refs += h.submit("apply_grads",
                                       [() for _ in range(h.width)])
        rec.aux_refs = aux + [r for refs in list(acts.values())
                              + list(cots.values()) for r in refs]

    def _split_batch(self, x, target):
        M = self.num_microbatches
        if len(x) < M:
            raise ValueError(
                f"batch of {len(x)} rows cannot fill num_microbatches={M} "
                "(an empty microbatch means a NaN loss, not an error)")
        if len(x) != len(target):
            raise ValueError("x and target row counts differ")
        width = self._handles[0].width if self._handles else 1
        if width > 1 and len(x) % (M * width) != 0:
            raise ValueError(
                f"gang mode needs batch % (num_microbatches * gang_hosts) "
                f"== 0 so every rank gets an equal slice; got "
                f"{len(x)} % ({M} * {width}) != 0")
        xs = np.array_split(np.asarray(x), M)
        ts = np.array_split(np.asarray(target), M)
        # True per-microbatch weights: grad accumulation and the reported
        # loss weight each microbatch by its ACTUAL row share, so ragged
        # splits (len(x) % M != 0) match the full-batch gradients.
        weights = np.asarray([len(xb) for xb in xs], np.float64) / len(x)
        return xs, ts, weights

    # ---- streaming API (the zero-sync hot path) ----
    def submit_step(self, x: np.ndarray, target: np.ndarray) -> int:
        """Dispatch one full schedule asynchronously; blocks (draining
        the oldest step) only once more than ``step_window`` steps are in
        flight.  Returns the step index."""
        xs, ts, weights = self._split_batch(x, target)
        idx = self._next_idx
        self._next_idx += 1
        snap = self.max_restarts > 0 and (
            self._snap is None and self._pending_snap is None
            or (self._pending_snap is None
                and idx - self._snap[0] >= self.snapshot_interval))
        rec = _StepRec(idx, xs, ts, weights, snap)
        self._dispatch_step(rec)
        self._replay.append(rec)
        self._window.append(rec)
        while self._window.over_depth:
            self._drain_one()
        return idx

    def flush(self) -> List[tuple]:
        """Drain every in-flight step; returns all accumulated
        ``(step_idx, loss)`` pairs (destructive read)."""
        while self._window:
            self._drain_one()
        out, self._results = self._results, []
        return out

    def train_step(self, x: np.ndarray, target: np.ndarray) -> float:
        """Lockstep step: submit + drain everything, return THIS step's
        weighted mean microbatch loss."""
        _note_sync()
        idx = self.submit_step(x, target)
        drained = dict(self.flush())
        return drained[idx]

    # ---- drain + recovery ----
    def _drain_one(self) -> None:
        rec = self._window.peek()
        while True:
            try:
                vals = gang_get(rec.loss_refs + rec.apply_refs,
                                timeout=self.drain_timeout)
                break
            except exc.MeshGroupError as e:
                self._recover(e)
            except exc.RayTpuError:
                # A user exception, or a task poisoned by an upstream
                # stage death (a TaskError, not an actor error).  Tell
                # them apart with a bounded ping fan-out.
                dead = self._dead_stages()
                if dead:
                    self._recover(exc.MeshGroupError(
                        f"pipeline stage(s) {dead} died mid-step",
                        failed_ranks={d: exc.ActorDiedError(
                            f"stage {d} unresponsive") for d in dead}))
                    continue
                self._abort()
                raise
        M = len(rec.loss_refs)
        losses, rank_stats = vals[:M], vals[M:]
        loss = float(np.dot(rec.weights, np.asarray(losses, np.float64)))
        self._window.popleft()
        rec.drained = True
        rec.aux_refs = []  # consumers finished: release the pins
        self._results.append((rec.idx, loss))
        self._ingest_stats(rec, rank_stats)
        # Snapshot confirmation: this step drained, so every op queued
        # before it, the snapshot included, executed.
        if self._pending_snap is not None and \
                rec.idx >= self._pending_snap[0]:
            self._snap = self._pending_snap
            self._pending_snap = None
            while self._replay and self._replay[0].idx < self._snap[0]:
                self._replay.popleft()
        elif self.max_restarts == 0:
            while self._replay and self._replay[0].drained:
                self._replay.popleft()

    def _recover(self, cause: exc.MeshGroupError) -> None:
        """All-or-nothing stage restart + in-order schedule replay."""
        from ray_tpu_torch import observability as obs

        obs.flight_record(f"mpmd_gang_restart: {cause}")
        if self.restart_count >= self.max_restarts:
            cause.restarts = self.restart_count
            self._abort(teardown=False)
            raise cause
        self.restart_count += 1
        self._generation += 1
        self._teardown_stages()
        restore = [list(refs) for refs in self._snap[1]] \
            if self._snap is not None else None
        self._pending_snap = None  # its refs died with the old stages
        self._spawn_stages(restore_refs=restore)
        for rec in self._replay:
            if rec.snap and self._snap is not None \
                    and rec.idx <= self._snap[0]:
                rec.snap = False  # already restored from this snapshot
            self._dispatch_step(rec)
        if self._metrics is not None:
            try:
                self._metrics["replays"].inc()
            except Exception:
                pass

    def _abort(self, teardown: bool = False) -> None:
        """Drop in-flight schedule state after an unrecoverable error so
        a retry doesn't double-apply; stages reset their gradients."""
        self._window.clear()
        self._replay.clear()
        self._pending_snap = None
        if teardown:
            self._teardown_stages()
            return
        for h in self._handles:
            try:
                h.resync()
                gang_get(h.submit("reset", [() for _ in range(h.width)]),
                         timeout=30.0)
            except Exception:
                pass

    # ---- observability ----
    def _merge_rank_stats(self, rank_stats: Sequence[dict]) -> List[dict]:
        """Fold per-rank apply payloads into one dict per stage: rank 0
        carries the spans/watermarks (ranks run the identical schedule),
        boundary bytes sum across ranks (each ships its own slice)."""
        width = self._handles[0].width if self._handles else 1
        out = []
        for k in range(self.num_stages):
            group = list(rank_stats[k * width:(k + 1) * width])
            st = dict(group[0])
            st["act_bytes"] = sum(g["act_bytes"] for g in group)
            st["wire_bytes"] = sum(g["wire_bytes"] for g in group)
            out.append(st)
        return out

    def _ingest_stats(self, rec: _StepRec, rank_stats: Sequence[dict]):
        try:
            stage_stats = self._merge_rank_stats(rank_stats)
            ops = [o for st in stage_stats for o in st["ops"]]
            wall = (max(o["end"] for o in ops)
                    - min(o["start"] for o in ops)) if ops else 0.0
            busy = [st["busy_s"] for st in stage_stats]
            bubble = 1.0 - sum(busy) / (self.num_stages * wall) \
                if wall > 0 else 0.0
            act_bytes = sum(st["act_bytes"] for st in stage_stats) \
                - self._act_bytes_total
            wire_bytes = sum(st["wire_bytes"] for st in stage_stats) \
                - self._wire_bytes_total
            self._act_bytes_total += act_bytes
            self._wire_bytes_total += wire_bytes
            self._busy_total += sum(busy)
            self._wall_total += wall
            self._last_report = {
                "step": rec.idx,
                "bubble_fraction": bubble,
                "wall_s": wall,
                "busy_s": busy,
                "peak_inflight": {st["stage"]: st["peak_inflight"]
                                  for st in stage_stats},
                "jit_cache": {st["stage"]: st["jit_cache"]
                              for st in stage_stats},
                "act_bytes": act_bytes,
                "wire_bytes": wire_bytes,
                "ops": {st["stage"]: st["ops"] for st in stage_stats},
            }
            from ray_tpu_torch._private import profiling

            for o in ops:
                profiling.record_span(
                    {"F": "mpmd_stage_fwd", "B": "mpmd_stage_bwd",
                     "A": "mpmd_stage_apply", "X": "mpmd_stage_transfer"}
                    [o["kind"]], o["start"], o["end"], stage=o["stage"],
                    step=o["step"], mb=o["mb"], _trace_ctx=rec.trace_ctx)
            if self._metrics is not None:
                m = self._metrics
                m["bubble"].set(bubble)
                m["steps"].inc()
                m["act_bytes"].mark(float(act_bytes))
                m["wire"].mark(float(wire_bytes))
                m["inflight"].set(float(max(
                    st["peak_inflight"] for st in stage_stats)))
                for st, b in zip(stage_stats, busy):
                    idle = 1.0 - b / wall if wall > 0 else 0.0
                    m["idle"].set(idle, tags={"stage": str(st["stage"])})
        except Exception:
            pass  # observability is best-effort, never the step path

    def last_step_report(self) -> Optional[dict]:
        """Observability payload of the most recently drained step."""
        return self._last_report

    def stats(self) -> dict:
        rep = self._last_report or {}
        return {
            "num_stages": self.num_stages,
            "virtual_per_rank": self.virtual_per_rank,
            "num_microbatches": self.num_microbatches,
            "schedule": self.schedule,
            "wire_dtype": self.wire_dtype,
            "gang_hosts": self.gang_hosts,
            "device": self.device,
            "steps_submitted": self._next_idx,
            "steps_inflight": len(self._window),
            "restarts": self.restart_count,
            "bubble_fraction": rep.get("bubble_fraction"),
            "peak_inflight": rep.get("peak_inflight"),
            "jit_cache": rep.get("jit_cache"),
            "activation_bytes": self._act_bytes_total,
            "wire_bytes": self._wire_bytes_total,
            "wire_reduction_vs_fp32": (
                self._act_bytes_total / self._wire_bytes_total
                if self._wire_bytes_total else 1.0),
            "act_gb_per_s": (self._act_bytes_total / self._wall_total / 1e9
                             if self._wall_total > 0 else 0.0),
            "driver_peak_window": self._peak_window,
        }

    # ---- params access (lockstep paths) ----
    def get_params(self) -> List[Any]:
        """Host params per GLOBAL chunk (length ``num_stages * v``; for
        v=1 one dict per stage).  Gang mode reads rank 0 (params are
        replicated across the gang)."""
        _note_sync()
        self.flush()
        per_stage = gang_get(
            [h.submit("get_params", [() for _ in range(h.width)])[0]
             for h in self._handles])
        out = []
        for c in range(self.num_chunks):
            k, slot = c % self.num_stages, c // self.num_stages
            got = per_stage[k]
            out.append(got[slot] if self.virtual_per_rank > 1 else got)
        return out

    def stop(self):
        try:
            if self._window:
                self.flush()
        except Exception:
            pass
        self._teardown_stages()

    def __enter__(self) -> "MPMDPipeline":
        return self

    def __exit__(self, exc_type, exc_val, tb) -> None:
        if exc_type is not None:
            self._abort(teardown=True)
        else:
            self.stop()
