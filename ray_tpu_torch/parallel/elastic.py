"""Elastic data parallelism: grow or shrink a live ZeRO data-parallel
gang mid-run (counterpart of ``ray_tpu/parallel/elastic.py``).

- :class:`ElasticMeshGroup` drives a MeshGroup-hosted data-parallel run
  whose rank count floats inside ``num_hosts=(min, max)``.  A **grow**
  (the caller offers capacity) and a **notice shrink**
  (``preemption_notice``) both land at a step boundary: the gang
  snapshots, is rebuilt at the new size, receives ONE versioned
  ``ray_tpu_torch.put`` of the weights, and the ZeRO optimizer shards
  re-partition N->M through the assembled ``(total,)`` form, with no
  disk round trip.  A **lease expiry** (SIGKILL, no notice) surfaces as a
  MeshGroupError; the survivors' size is fitted, the gang rebuilds from
  the last boundary snapshot, and the steps since are *replayed*
  deterministically: ``steps_lost == 0`` by construction.

- The step (:func:`build_elastic_step`) is **slot-deterministic**: the
  global batch is a fixed number of ``slots`` microbatches whatever the
  world size, each slot's gradient is computed by the same per-slot
  program (one forward and backward at the slot's shape), the per-slot
  flat gradients are all-gathered into global slot order, and the mean is
  one fixed chain of adds over ``slots``, the same on every rank.  The
  optimizer then runs per LANE at a fixed lane width: the sharder is built
  at lane granularity (``2 * slots`` lanes at every gang size) and each
  rank's optimizer holds its lanes as separate tensors, so every element
  sees the same update at any world.  All cross-rank collectives are pure
  data movement, so the parameter trajectory is **bitwise identical for
  every world size that divides ``slots``**, which is what lets a gang
  killed at lease expiry finish bitwise-equal to an unkilled run.
  :func:`reference_trajectory` is that run, in one process.

In the JAX package ``world`` is a mesh of virtual devices in one process
or several; here a gang rank is a process, and the in-process reference
(:class:`LocalElastic`) runs ``world`` ranks' shares side by side over
one set of parameters (the per-slot program once per slot, each rank's
lane optimizer on its lanes), which is the gang's computation without
the collectives.  The autoscaler's gang policy (``autoscaler.py``, ROADMAP
Queue 1 item 9) is not ported: ``offer_capacity`` takes offers from its
caller.

``grad_clip`` applies a world-invariant global-norm clip over the
unpadded gradient (``zero.zero_clip_by_global_norm``'s norm is a sum
whose operand layout depends on the world).
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import chaos
from ray_tpu_torch.ops import collectives
from ray_tpu_torch.parallel import mesh_group as mg
from ray_tpu_torch.parallel import zero

logger = logging.getLogger(__name__)


# ---- the slot-deterministic step ----
def _slot_grads(loss_fn: Callable, sharder: zero.ZeroSharder, params: Any,
                batch: Any, n: int):
    """(losses [n], flat grads [n, padded], replicated grads (each
    [n, ...])) of ``n`` slots of ``batch``, one identical program a slot."""
    _, leaves, _ = zero.tree_flatten(params)
    _, b_leaves, b_def = zero.tree_flatten(batch)
    losses, flats, repls = [], [], []
    for s in range(n):
        mb = zero.tree_unflatten(b_def, [x[s] for x in b_leaves])
        loss = loss_fn(params, mb)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, torch.autograd.grad(
                     loss, leaves, allow_unused=True))]
        flat, repl = sharder.split(zero.tree_unflatten(sharder.treedef,
                                                       grads))
        losses.append(loss.detach().float())
        flats.append(flat)
        repls.append(repl)
    return (torch.stack(losses), torch.stack(flats),
            tuple(torch.stack([r[i] for r in repls])
                  for i in range(len(repls[0]))))


def _combine(losses, flats, repls, slots: int, sharder: zero.ZeroSharder,
             grad_clip: Optional[float]):
    """The global mean over ``slots`` as an ordered chain of binary adds
    (NOT ``sum``, whose association may depend on the layout), then the
    optional world-invariant clip."""

    def slot_sum(stacked):
        acc = stacked[0]
        for s in range(1, slots):
            acc = acc + stacked[s]
        return acc

    loss = slot_sum(losses) / np.float32(slots)
    g_full = slot_sum(flats) / np.float32(slots)
    g_repl = tuple(slot_sum(r) / np.float32(slots) for r in repls)
    if grad_clip is not None:
        sq = g_full[: sharder.total].float().square().sum()
        for r in g_repl:
            sq = sq + r.float().square().sum()
        norm = torch.sqrt(sq)
        scale = torch.where(norm < np.float32(grad_clip),
                            torch.ones((), device=norm.device),
                            np.float32(grad_clip) / norm)
        g_full = (g_full.float() * scale).to(g_full.dtype)
        g_repl = tuple((r.float() * scale).to(r.dtype) for r in g_repl)
    return loss, g_full, g_repl


def _lane_update(opt: zero.ZeroOptState, sharder: zero.ZeroSharder,
                 params: Any, g_full, g_repl) -> torch.Tensor:
    """Apply the optimizer to the lanes ``opt`` owns (its rows of the
    lane-granular flat vector) and the replicated leaves; returns the
    fresh lanes ``[k, lane]``."""
    k = len(opt.rows)
    lo = opt.first_row
    p_flat, p_repl = sharder.split(params)
    with torch.no_grad():
        for row, src in zip(opt.rows, sharder.rows(p_flat)[lo:lo + k]):
            row.copy_(src)
        for mine, p in zip(opt.repl, p_repl):
            mine.copy_(p)
    g_rows = sharder.rows(g_full.to(sharder.dtype))[lo:lo + k]
    opt.apply(list(g_rows), g_repl)
    return torch.stack(opt.rows)


def build_elastic_step(loss_fn: Callable, sharder: zero.ZeroSharder,
                       *, slots: int, world: Optional[int] = None,
                       group=None,
                       grad_clip: Optional[float] = None) -> Callable:
    """The ZeRO data-parallel step of one rank whose parameter trajectory
    is bitwise-invariant to the gang's size.

    ``step(params, opt, batch) -> (params, opt, loss)``: ``batch`` holds
    this rank's ``slots / world`` slots (leading dim), ``opt`` its lane
    optimizer (``sharder.init_opt_state(tx, params, rank,
    rows_per_rank=sharder.world // world)``: the optimizer lives there,
    so unlike the JAX package's this function takes no ``tx``), ``params``
    a tree of leaf tensors that require grad, updated in place.
    ``sharder`` is built at lane granularity (``sharder.world`` lanes,
    the same count at every gang size)."""
    world = collectives.world_of(group) if world is None else int(world)
    lanes = sharder.world
    if slots % world:
        raise ValueError(f"slots={slots} not divisible by world={world}")
    if lanes % world:
        raise ValueError(
            f"lane count {lanes} not divisible by world={world}")

    def step(params, opt, batch):
        losses, flats, repls = _slot_grads(loss_fn, sharder, params, batch,
                                           slots // world)
        if world > 1:
            losses = collectives.all_gather_rows(losses, group).reshape(
                slots)
            flats = collectives.all_gather_rows(flats, group).reshape(
                slots, sharder.padded)
            repls = tuple(collectives.all_gather_rows(r, group).reshape(
                (slots,) + r.shape[1:]) for r in repls)
        loss, g_full, g_repl = _combine(losses, flats, repls, slots,
                                        sharder, grad_clip)
        mine = _lane_update(opt, sharder, params, g_full, g_repl)
        if world > 1:
            mine = collectives.all_gather_rows(mine, group)
        new = sharder.merge(mine.reshape(sharder.padded), opt.repl)
        return zero._write_back(params, new), opt, loss

    return step


# ---- host <-> rank helpers ----
def _device_params(params_host: Any, device) -> Any:
    """A host tree as leaf tensors on ``device`` that require grad."""
    return zero.tree_map_with_path(
        lambda kp, x: zero._as_tensor(x).to(device).clone()
        .requires_grad_(True), params_host)


def _host(tree: Any) -> Any:
    """A tree's tensors copied to the host (other leaves as they are)."""
    return zero.tree_map_with_path(
        lambda kp, x: x.detach().to("cpu", copy=True)
        if isinstance(x, torch.Tensor) else x, tree)


def _build_engine(spec: Dict[str, Any], params_host: Any,
                  opt_assembled: Any, world: int, ranks, group) -> dict:
    """The per-incarnation machinery, shared verbatim by the gang's ranks
    and the in-process ``LocalElastic``: the parameters on the device, a
    lane-granular sharder (``2 * slots`` lanes: a FIXED count whatever the
    gang's size, so the opt layout and each lane's update are the same at
    every world), and one lane optimizer for each rank in ``ranks``."""
    from ray_tpu_torch._device import resolve_device

    device = resolve_device(spec.get("device"))
    tx = spec["tx_factory"]()
    if zero._split_tx(tx)[0]:
        raise ValueError("the elastic step clips with grad_clip; tx must "
                         "be a plain optimizer factory")
    sharder = zero.ZeroSharder(params_host, 2 * spec["slots"],
                               should_shard=spec.get("should_shard"))
    params = _device_params(params_host, device)
    k = sharder.world // world
    opts = []
    for rank in ranks:
        opt = sharder.init_opt_state(tx, params, rank, rows_per_rank=k)
        if opt_assembled is not None:
            opt.load_global_tree(sharder.reshard_opt_state(opt_assembled))
        opts.append(opt)
    step = build_elastic_step(spec["loss_fn"], sharder,
                              slots=spec["slots"], world=world, group=group,
                              grad_clip=spec.get("grad_clip"))
    return {"sharder": sharder, "params": params, "opts": opts,
            "step": step, "world": world, "device": device}


# ---- worker-side functions (module-level: pickled by reference) ----
def _elastic_setup(state, spec, params_host, opt_assembled, step0, version):
    """Build/rebuild a rank's elastic engine from the driver snapshot.
    Runs on every rank via ``run_stateful``; ``params_host`` and
    ``opt_assembled`` arrive as ONE ``ray_tpu_torch.put`` ref each."""
    # One intra-op thread on every rank: a CPU reduction's bits depend on
    # how many threads split it, and world invariance needs every rank to
    # run the same program as reference_trajectory's.
    torch.set_num_threads(1)
    rank, world = collectives.rank_of(), collectives.world_of()
    engine = _build_engine(spec, params_host, opt_assembled, world, [rank],
                           None)
    state.clear()
    state.update(engine, rank=rank, spec=spec, step_idx=int(step0),
                 version=int(version))
    return {"rank": rank, "world": world, "step": int(step0),
            "version": int(version)}


def _elastic_step_fn(state, step_idx):
    """One global step at index ``step_idx`` (the driver replays indices
    after a recovery; ``batch_fn(step_idx)`` makes replay deterministic).
    The ``elastic_step`` chaos op fires HERE: a SIGKILL at this point is
    the no-notice lease-expiry drill."""
    chaos.maybe_die("elastic_step", state["rank"])
    slots, world = state["spec"]["slots"], state["world"]
    per = slots // world
    lo = state["rank"] * per
    batch = zero.tree_map_with_path(
        lambda kp, x: zero._as_tensor(np.asarray(x)[lo:lo + per]).to(
            state["device"]), state["spec"]["batch_fn"](int(step_idx)))
    state["params"], _, loss = state["step"](state["params"],
                                             state["opts"][0], batch)
    state["step_idx"] = int(step_idx) + 1
    return float(loss.item())


def _elastic_snapshot_fn(state):
    """Boundary snapshot: gather the sharded opt state (a collective:
    EVERY rank participates, which is how survivors obtain a doomed
    rank's lanes), then rank 0 assembles the world-agnostic form and
    returns it with the params, on the host."""
    opt_global = zero.gather_opt_state(state["opts"][0])
    if state["rank"] != 0:
        return None
    return {"step": state["step_idx"],
            "params": _host(state["params"]),
            "opt": _host(zero.assemble_opt(opt_global,
                                           state["sharder"].total))}


def _elastic_params_host(state):
    return _host(state["params"])


# ---- in-process reference runner ----
class LocalElastic:
    """The elastic engine in one process: the *reference implementation*
    the gang is bitwise-compared against.  It holds ``world`` ranks' lane
    optimizers over one set of parameters; a step computes every slot's
    gradient once and lets each rank's optimizer update its lanes, which
    is the gang's computation without the collectives.  ``resize`` runs
    the gang's snapshot -> assemble -> reshard protocol."""

    def __init__(self, loss_fn: Callable, params_factory: Callable,
                 tx_factory: Callable, batch_fn: Callable, *,
                 slots: int = 4, world: int = 1,
                 grad_clip: Optional[float] = None,
                 should_shard: Optional[Callable] = None, device=None):
        self.spec = {"loss_fn": loss_fn, "tx_factory": tx_factory,
                     "batch_fn": batch_fn, "slots": slots,
                     "grad_clip": grad_clip, "should_shard": should_shard,
                     "device": device}
        self._params_host = params_factory()
        self.step_idx = 0
        self.losses: List[float] = []
        self._mount(world, opt_assembled=None)

    def _mount(self, world: int, opt_assembled):
        if self.spec["slots"] % world:
            raise ValueError(f"world={world} does not divide slots="
                             f"{self.spec['slots']}")
        e = _build_engine(self.spec, self._params_host, opt_assembled,
                          world, range(world), None)
        self.sharder, self.params, self.opts = (e["sharder"], e["params"],
                                                e["opts"])
        self.device = e["device"]
        self.world = world

    def step(self) -> float:
        slots = self.spec["slots"]
        batch = zero.tree_map_with_path(
            lambda kp, x: zero._as_tensor(np.asarray(x)).to(self.device),
            self.spec["batch_fn"](self.step_idx))
        losses, flats, repls = _slot_grads(self.spec["loss_fn"],
                                           self.sharder, self.params, batch,
                                           slots)
        loss, g_full, g_repl = _combine(losses, flats, repls, slots,
                                        self.sharder,
                                        self.spec["grad_clip"])
        lanes = torch.cat([_lane_update(opt, self.sharder, self.params,
                                        g_full, g_repl)
                           for opt in self.opts])
        new = self.sharder.merge(lanes.reshape(self.sharder.padded),
                                 self.opts[0].repl)
        zero._write_back(self.params, new)
        self.step_idx += 1
        loss = float(loss.item())
        self.losses.append(loss)
        return loss

    def opt_global(self) -> Any:
        """The GLOBAL opt tree: every rank's lanes, in rank order."""
        trees = [zero.tree_flatten(opt.local_tree()) for opt in self.opts]
        paths, first, treedef = trees[0]
        return zero.tree_unflatten(treedef, [
            torch.cat([t[1][i] for t in trees])
            if (zero._is_shard_path(kp) and zero._ndim(x) >= 2) else x
            for i, (kp, x) in enumerate(zip(paths, first))])

    def resize(self, world: int):
        """Snapshot -> assembled opt form -> remount at ``world``."""
        if world == self.world:
            return
        assembled = zero.assemble_opt(self.opt_global(), self.sharder.total)
        self._params_host = _host(self.params)
        self._mount(world, opt_assembled=assembled)

    def params_host(self) -> Any:
        return _host(self.params)


def reference_trajectory(loss_fn: Callable, params_factory: Callable,
                         tx_factory: Callable, batch_fn: Callable, *,
                         steps: int, slots: int = 4, world: int = 1,
                         grad_clip: Optional[float] = None,
                         resize_plan: Optional[Dict[int, int]] = None,
                         device=None) -> Dict[str, Any]:
    """Run ``steps`` elastic steps in-process and return ``{"params",
    "losses"}``.  ``resize_plan={step: new_world}`` reshards mid-run at
    the given step boundaries; by slot-determinism the final params are
    bitwise-independent of the plan."""
    le = LocalElastic(loss_fn, params_factory, tx_factory, batch_fn,
                      slots=slots, world=world, grad_clip=grad_clip,
                      device=device)
    for s in range(steps):
        if resize_plan and s in resize_plan:
            le.resize(resize_plan[s])
        le.step()
    return {"params": le.params_host(),
            "losses": np.asarray(le.losses, dtype=np.float64)}


# ---- the driver-side elastic gang ----
class ElasticMeshGroup:
    """A data-parallel training gang whose rank count floats inside
    ``num_hosts=(min, max)`` without ever losing a step.

    Resizes are full gang rebuilds at a step boundary (a process group is
    fixed-size): the driver keeps a boundary snapshot ``{step, params,
    assembled opt}``, broadcasts it as one versioned
    ``ray_tpu_torch.put`` per tree, and the new gang re-chunks the opt
    state onto its world via ``reshard_opt_state``.  ``resources_per_host``
    is each rank's bundle (``{"GPU": 0.5}``: two ranks share a card over
    gloo); ``device`` is where a rank trains (None: CUDA).  Grows and
    notice-shrinks snapshot first (graceful — the doomed rank still
    participates in the snapshot collective); a lease
    expiry (rank SIGKILLed with no notice) is caught as a
    MeshGroupError, the surviving count is fitted to an allowed size,
    and the missed steps are replayed deterministically from
    ``batch_fn`` — ``elastic_steps_lost_total`` stays 0 by construction.
    Transport aborts (the gloo TCP race) rebuild at the SAME size under
    their own budget and are not counted as shrinks."""

    def __init__(self, loss_fn: Callable, params_factory: Callable,
                 tx_factory: Callable, batch_fn: Callable, *,
                 num_hosts: Tuple[int, int] = (1, 2),
                 initial_hosts: Optional[int] = None,
                 slots: int = 4, grad_clip: Optional[float] = None,
                 should_shard: Optional[Callable] = None,
                 snapshot_interval: int = 1,
                 resources_per_host: Optional[Dict[str, float]] = None,
                 bootstrap_timeout: float = 120.0,
                 transport_restart_budget: int = 2, device=None):
        if isinstance(num_hosts, int):
            num_hosts = (num_hosts, num_hosts)
        lo, hi = int(num_hosts[0]), int(num_hosts[1])
        if not (1 <= lo <= hi):
            raise ValueError(f"bad num_hosts range {num_hosts}")
        self.allowed_hosts = [h for h in range(lo, hi + 1)
                              if slots % h == 0]
        if not self.allowed_hosts:
            raise ValueError(
                f"no host count in [{lo}, {hi}] divides slots={slots}")
        self.min_hosts, self.max_hosts = lo, hi
        self.slots = slots
        self.snapshot_interval = max(1, int(snapshot_interval))
        self.transport_restart_budget = int(transport_restart_budget)
        self._mg_kwargs = dict(resources_per_host=resources_per_host,
                               bootstrap_timeout=bootstrap_timeout,
                               max_group_restarts=0)
        self.spec = {"loss_fn": loss_fn, "tx_factory": tx_factory,
                     "batch_fn": batch_fn, "slots": slots,
                     "grad_clip": grad_clip, "should_shard": should_shard,
                     "device": device}
        self._step = 0          # global steps completed
        self._gang_step = 0     # next index the live gang will execute
        self._gang_calls = 0    # elastic_step invocations this incarnation
        self._version = 0
        self._snapshot = {"step": 0, "params": params_factory(),
                          "opt": None}
        self._pending_resize: Optional[int] = None
        self._notices: List[Tuple[int, float]] = []
        self._pending_steps = 0
        self.counters: Dict[str, float] = {
            "elastic_grows_total": 0, "elastic_shrinks_total": 0,
            "elastic_notice_shrinks_total": 0,
            "elastic_expiry_shrinks_total": 0,
            "elastic_transport_rebuilds_total": 0,
            "elastic_reshard_seconds_total": 0.0,
            "elastic_replayed_steps_total": 0,
            "elastic_steps_lost_total": 0,
            "elastic_weight_puts_total": 0,
        }
        self.hosts = self._fit(initial_hosts if initial_hosts is not None
                               else self.allowed_hosts[-1])
        self.group = mg.MeshGroup(num_hosts=self.hosts, **self._mg_kwargs)
        self._setup_gang()

    # ---- sizing ----
    def _fit(self, target: int) -> int:
        """Largest allowed host count <= target (floor: the smallest
        allowed size — a gang never dissolves below min)."""
        ok = [h for h in self.allowed_hosts if h <= target]
        return ok[-1] if ok else self.allowed_hosts[0]

    # ---- gang (re)build ----
    def _setup_gang(self):
        snap = self._snapshot
        self._version += 1
        # One put per rebuild; the N gang ranks resolve these refs
        # concurrently, which the transfer plane turns into a striped
        # cooperative broadcast (receivers serve each other's landed
        # ranges) — rebuild cost stays ~O(snapshot/BW) as the gang grows.
        params_ref = ray_tpu_torch.put(snap["params"])
        opt_ref = ray_tpu_torch.put(snap["opt"]) if snap["opt"] is not None \
            else None
        self.counters["elastic_weight_puts_total"] += 1
        self.group.run_stateful(_elastic_setup, self.spec, params_ref,
                                opt_ref, snap["step"], self._version)
        self._gang_step = snap["step"]
        self._gang_calls = 0

    def _resize_to(self, n: int):
        t0 = time.monotonic()
        self.group.resize(n)
        self.hosts = n
        self._setup_gang()
        self.counters["elastic_reshard_seconds_total"] += \
            time.monotonic() - t0
        self._export_metrics()

    def _refresh_snapshot(self, force: bool = False):
        if not force and self._step % self.snapshot_interval:
            return
        out = self.group.run_stateful(_elastic_snapshot_fn)
        snap = next(s for s in out if s is not None)
        self._snapshot = snap

    # ---- elasticity signals ----
    def request_resize(self, target: int):
        """Ask for a new size; applied at the next step boundary."""
        self._pending_resize = self._fit(int(target))

    def offer_capacity(self, spare_hosts: int):
        """Autoscaler hook: grow into ``spare_hosts`` extra hosts."""
        if spare_hosts > 0:
            self.request_resize(self.hosts + int(spare_hosts))

    def preemption_notice(self, rank: int, deadline_s: float = 30.0):
        """A host will disappear in ``deadline_s``: shrink gracefully at
        the next step boundary (the doomed rank still participates in
        the boundary snapshot — survivors get its opt chunk for free)."""
        self._notices.append((int(rank), time.monotonic() + deadline_s))

    def arm_lease_expiry(self, rank: int, after_steps: int):
        """The no-notice drill: schedule a SIGKILL of ``rank`` at the
        ``after_steps``-th future elastic step via the chaos plane (spot
        reclaim with zero warning — recovery must come from the
        snapshot + replay path, not a goodbye collective)."""
        # Chaos invocation counts start from zero when a schedule is
        # (re)armed, so nth counts elastic steps from NOW.
        spec = f"elastic_step:{rank}:{int(after_steps)}:*"
        ray_tpu_torch.get(self.group.workers[rank].setup_env.remote(
            {chaos.KILL_SCHEDULE_ENV: spec}))

    def pending_steps(self) -> int:
        """Steps queued behind the gang (the autoscaler gang policy's
        scale signal)."""
        return self._pending_steps

    # ---- the step loop ----
    def step(self) -> float:
        """Advance the run by exactly one global step, absorbing any
        pending resize (boundary) and any gang failure (recovery +
        deterministic replay) along the way."""
        self._apply_pending()
        target = self._step + 1
        loss = None
        while True:
            try:
                while self._gang_step < target:
                    idx = self._gang_step
                    loss = self.group.run_stateful(_elastic_step_fn, idx)[0]
                    if idx < self._step:
                        self.counters["elastic_replayed_steps_total"] += 1
                    self._gang_step += 1
                    self._gang_calls += 1
                break
            except exc.MeshGroupError as e:
                self._recover(e)
        self._step = target
        self._refresh_snapshot()
        return loss

    def run(self, steps: int) -> List[float]:
        losses = []
        for _ in range(steps):
            self._pending_steps = steps - len(losses)
            losses.append(self.step())
        self._pending_steps = 0
        return losses

    def _apply_pending(self):
        if self._notices:
            doomed = {r for r, _ in self._notices}
            self._notices = []
            self._refresh_snapshot(force=True)
            n = self._fit(self.hosts - len(doomed))
            if n < self.hosts:
                self.counters["elastic_shrinks_total"] += 1
                self.counters["elastic_notice_shrinks_total"] += 1
                logger.info("elastic: notice shrink %d -> %d hosts",
                            self.hosts, n)
                self._resize_to(n)
            self._pending_resize = None
            return
        if self._pending_resize is not None:
            n, self._pending_resize = self._pending_resize, None
            if n == self.hosts:
                return
            self._refresh_snapshot(force=True)
            if n > self.hosts:
                self.counters["elastic_grows_total"] += 1
                logger.info("elastic: grow %d -> %d hosts", self.hosts, n)
            else:
                self.counters["elastic_shrinks_total"] += 1
                self.counters["elastic_notice_shrinks_total"] += 1
            self._resize_to(n)

    def _recover(self, err: exc.MeshGroupError):
        """A gang failure mid-step: transport aborts rebuild at the same
        size (bounded); real rank death shrinks to the surviving fit.
        Either way the gang restarts from the boundary snapshot and the
        driver replays the missed indices — nothing is lost."""
        if mg.is_transport_abort(err):
            if self.counters["elastic_transport_rebuilds_total"] >= \
                    self.transport_restart_budget:
                raise err
            self.counters["elastic_transport_rebuilds_total"] += 1
            logger.warning("elastic: transport abort, rebuilding %d-host "
                           "gang in place: %s", self.hosts, err)
            self._resize_to(self.hosts)
            return
        # Peers of a dead rank surface as transport-classified TaskErrors
        # (their collective was poisoned); only non-transport failures are
        # actual corpses when sizing the surviving gang.
        ranks = getattr(err, "failed_ranks", None) or {}
        dead = [r for r, e in ranks.items()
                if not mg.is_transport_abort(e)] or list(ranks) or [0]
        failed = len(dead)
        survivors = max(self.hosts - failed, 0)
        n = self._fit(survivors)
        self.counters["elastic_shrinks_total"] += 1
        self.counters["elastic_expiry_shrinks_total"] += 1
        logger.warning("elastic: lease expiry (%d rank(s) dead), shrink "
                       "%d -> %d hosts: %s", failed, self.hosts, n, err)
        self._resize_to(n)

    # ---- introspection ----
    def params_host(self) -> Any:
        return self.group.run_rank_stateful(0, _elastic_params_host)

    def stats(self) -> Dict[str, Any]:
        return {"hosts": self.hosts, "step": self._step,
                "version": self._version, **self.counters}

    def _export_metrics(self):
        try:
            from ray_tpu_torch.util.metrics import Counter, Gauge

            for name, val in self.counters.items():
                if name.endswith("_total"):
                    c = Counter(name, "elastic gang lifecycle")
                    delta = val - c.value()
                    if delta > 0:
                        c.inc(delta)
            Gauge("elastic_gang_hosts", "current elastic gang size").set(
                self.hosts)
        except Exception:  # driver not connected / kv unavailable
            pass

    def shutdown(self):
        self._export_metrics()
        self.group.shutdown()
