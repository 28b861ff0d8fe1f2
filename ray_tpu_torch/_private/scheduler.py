"""Cluster scheduler: resource vectors, scheduling policies, placement groups.

Re-implements the reference's two-level scheduling *decision* layer —
ClusterResourceScheduler over resource vectors with hybrid/spread/
node-affinity/PG-bundle policies (src/ray/raylet/scheduling/
cluster_resource_scheduler.h:44, scheduling/policy/*.h) and the placement
group manager's 2-phase bundle reservation (src/ray/gcs/gcs_server/
gcs_placement_group_manager.h:222) — as one in-head component.  Dispatch to
workers (the reference's LocalTaskManager) lives in raylet.py.

TPU-specific: "TPU" is a first-class resource alongside CPU/memory, and
nodes carry topology labels (slice id, host index within slice) so the mesh
bootstrap layer (ray_tpu/parallel/mesh_group.py) can gang-schedule one worker
per TPU host with STRICT_PACK-per-slice semantics.

Copied from ``ray_tpu/_private/scheduler.py`` (the JAX package).
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import NodeID, PlacementGroupID
from ray_tpu_torch._private.task_spec import SchedulingStrategy, TaskSpec

_EPS = 1e-9


class NodeResources:
    __slots__ = ("node_id", "total", "available", "labels")

    def __init__(self, node_id: NodeID, total: Dict[str, float], labels=None):
        self.node_id = node_id
        self.total = dict(total)
        self.available = dict(total)
        self.labels = labels or {}

    def fits(self, demand: Dict[str, float]) -> bool:
        return all(self.available.get(k, 0.0) + _EPS >= v for k, v in demand.items())

    def feasible(self, demand: Dict[str, float]) -> bool:
        return all(self.total.get(k, 0.0) + _EPS >= v for k, v in demand.items())

    def allocate(self, demand: Dict[str, float]):
        for k, v in demand.items():
            self.available[k] = self.available.get(k, 0.0) - v

    def release(self, demand: Dict[str, float]):
        for k, v in demand.items():
            self.available[k] = min(self.total.get(k, 0.0),
                                    self.available.get(k, 0.0) + v)

    def utilization(self) -> float:
        worst = 0.0
        for k, tot in self.total.items():
            if tot > 0:
                worst = max(worst, 1.0 - self.available.get(k, 0.0) / tot)
        return worst


class Bundle:
    __slots__ = ("index", "resources", "node_id")

    def __init__(self, index: int, resources: Dict[str, float]):
        self.index = index
        self.resources = dict(resources)
        self.node_id: Optional[NodeID] = None


class PlacementGroupInfo:
    __slots__ = ("pg_id", "bundles", "strategy", "state", "name",
                 "bundle_available", "creator")

    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]],
                 strategy: str, name: str = ""):
        self.pg_id = pg_id
        self.bundles = [Bundle(i, b) for i, b in enumerate(bundles)]
        self.strategy = strategy  # PACK | SPREAD | STRICT_PACK | STRICT_SPREAD
        self.state = "PENDING"  # PENDING | CREATED | REMOVED | INFEASIBLE
        self.name = name
        # Per-bundle remaining resources, for tasks scheduled into the PG.
        self.bundle_available: List[Dict[str, float]] = []
        self.creator = None


class ClusterScheduler:
    """Thread-safe resource ledger + policy engine."""

    def __init__(self):
        self._lock = threading.RLock()
        self.nodes: Dict[NodeID, NodeResources] = {}
        self.placement_groups: Dict[PlacementGroupID, PlacementGroupInfo] = {}
        # Round-robin cursor for SPREAD scheduling.
        self._spread_cursor = 0
        # Node shapes an attached autoscaler can launch (reference:
        # infeasible tasks stay pending when the autoscaler's node types
        # could satisfy them — resource_demand_scheduler feasibility).
        # Set by StandardAutoscaler; empty means no autoscaler.  Instance
        # state: two heads in one process must not share capacity.
        self.external_capacity: list = []
        # Arg-locality policy knobs (reference: the locality-aware lease
        # policy, locality_aware_lease_policy.h): resident arg bytes
        # outrank utilization once a host holds at least min_bytes.
        from ray_tpu_torch._private.config import CONFIG

        self.locality_enabled: bool = CONFIG.locality_scheduling
        self.locality_min_bytes: int = CONFIG.locality_min_bytes

    # ----- membership -----
    def add_node(self, node_id: NodeID, resources: Dict[str, float], labels=None):
        with self._lock:
            self.nodes[node_id] = NodeResources(node_id, resources, labels)

    def remove_node(self, node_id: NodeID) -> List[PlacementGroupInfo]:
        """Drop a node; demote placement groups that had a bundle there
        back to PENDING, releasing the SURVIVING bundles' reservations so
        the re-reservation pass doesn't double-allocate them.  Returns
        the demoted groups (the head requeues them for re-reservation)."""
        demoted: List[PlacementGroupInfo] = []
        with self._lock:
            self.nodes.pop(node_id, None)
            for pg in self.placement_groups.values():
                if pg.state != "CREATED" or not any(
                        b.node_id == node_id for b in pg.bundles):
                    continue
                for b in pg.bundles:
                    if b.node_id is not None and b.node_id != node_id:
                        n = self.nodes.get(b.node_id)
                        if n is not None:
                            n.release(b.resources)
                    b.node_id = None
                pg.bundle_available = []
                pg.state = "PENDING"  # needs re-reservation
                demoted.append(pg)
        return demoted

    def available_resources(self) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = defaultdict(float)
            for n in self.nodes.values():
                for k, v in n.available.items():
                    out[k] += v
            return dict(out)

    def total_resources(self) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = defaultdict(float)
            for n in self.nodes.values():
                for k, v in n.total.items():
                    out[k] += v
            return dict(out)

    # ----- task placement -----
    def pick_node(self, spec: TaskSpec,
                  preferred: Optional[NodeID] = None,
                  locality: Optional[Dict[NodeID, float]] = None
                  ) -> Optional[NodeID]:
        """Returns a node id and reserves the task's resources on it, or None
        if nothing fits right now.  Raises Infeasible if no node could ever
        fit the demand.

        ``locality`` maps node -> bytes of the task's ObjectRef args
        already resident on that node's host; above ``locality_min_bytes``
        it outranks utilization in the default policy (NODE_AFFINITY and
        PLACEMENT_GROUP placements are explicit and stay untouched; a
        soft affinity that falls back to the default policy keeps the
        locality signal)."""
        st = spec.scheduling_strategy
        with self._lock:
            if st.kind == "PLACEMENT_GROUP":
                return self._pick_in_pg(spec)
            if st.kind == "NODE_AFFINITY":
                node = self.nodes.get(st.node_id)
                if node is None:
                    if st.soft:
                        return self._pick_default(spec, None, locality)
                    raise Infeasible(f"node {st.node_id} not in cluster")
                if node.fits(spec.resources):
                    node.allocate(spec.resources)
                    return node.node_id
                return self._pick_default(spec, None, locality) if st.soft \
                    else None
            if st.kind == "SPREAD":
                return self._pick_spread(spec)
            return self._pick_default(spec, preferred, locality)

    def _check_feasible(self, spec: TaskSpec):
        if any(n.feasible(spec.resources) for n in self.nodes.values()):
            return
        for cap in self.external_capacity:
            if all(cap.get(k, 0.0) >= v
                   for k, v in spec.resources.items()):
                return  # the autoscaler can launch a node for this
        raise Infeasible(
            f"no node can ever satisfy {spec.resources}; "
            f"cluster totals {dict(self.total_resources())}"
        )

    def _pick_default(self, spec: TaskSpec, preferred: Optional[NodeID],
                      locality: Optional[Dict[NodeID, float]] = None
                      ) -> Optional[NodeID]:
        """Hybrid policy: prefer the caller's node until it passes a
        utilization threshold, then pack by score (reference:
        scheduling/policy/hybrid_scheduling_policy.h).  Resident arg
        bytes dominate the score once a host holds locality_min_bytes
        of them — below the threshold pure utilization packing wins, so
        tiny args never unbalance the cluster."""
        self._check_feasible(spec)
        if preferred is not None:
            n = self.nodes.get(preferred)
            if n is not None and n.fits(spec.resources) and n.utilization() < 0.5:
                n.allocate(spec.resources)
                return n.node_id
        if not (self.locality_enabled and locality):
            locality = None
        best, best_score = None, None
        for n in self.nodes.values():
            if not n.fits(spec.resources):
                continue
            loc = locality.get(n.node_id, 0.0) if locality else 0.0
            if loc < self.locality_min_bytes:
                loc = 0.0
            # pack: most resident bytes, then highest utilization
            score = (loc, n.utilization(), n.node_id.binary())
            if best is None or score > best_score:
                best, best_score = n, score
        if best is not None:
            best.allocate(spec.resources)
            return best.node_id
        return None

    def _pick_spread(self, spec: TaskSpec) -> Optional[NodeID]:
        self._check_feasible(spec)
        nodes = sorted(self.nodes.values(), key=lambda n: n.node_id.binary())
        for i in range(len(nodes)):
            n = nodes[(self._spread_cursor + i) % len(nodes)]
            if n.fits(spec.resources):
                self._spread_cursor = (self._spread_cursor + i + 1) % len(nodes)
                n.allocate(spec.resources)
                return n.node_id
        return None

    def _pick_in_pg(self, spec: TaskSpec) -> Optional[NodeID]:
        st = spec.scheduling_strategy
        pg = self.placement_groups.get(st.placement_group_id)
        if pg is None or pg.state != "CREATED":
            raise Infeasible(f"placement group {st.placement_group_id} not ready")
        indices = (range(len(pg.bundles)) if st.bundle_index < 0
                   else [st.bundle_index])
        for i in indices:
            avail = pg.bundle_available[i]
            if all(avail.get(k, 0.0) + _EPS >= v for k, v in spec.resources.items()):
                for k, v in spec.resources.items():
                    avail[k] = avail.get(k, 0.0) - v
                return pg.bundles[i].node_id
        return None

    def reacquire(self, node_id: NodeID, spec: TaskSpec):
        """Re-take a blocked worker's resources on unblock (reference:
        TaskUnblocked re-acquisition — may oversubscribe; availability can
        go negative until something completes)."""
        with self._lock:
            st = spec.scheduling_strategy
            if st.kind == "PLACEMENT_GROUP":
                pg = self.placement_groups.get(st.placement_group_id)
                if pg is not None and pg.state == "CREATED":
                    for b in pg.bundles:
                        if b.node_id == node_id:
                            avail = pg.bundle_available[b.index]
                            for k, v in spec.resources.items():
                                avail[k] = avail.get(k, 0.0) - v
                            return
                return
            n = self.nodes.get(node_id)
            if n is not None:
                n.allocate(spec.resources)

    def return_resources(self, node_id: NodeID, spec: TaskSpec):
        with self._lock:
            st = spec.scheduling_strategy
            if st.kind == "PLACEMENT_GROUP":
                pg = self.placement_groups.get(st.placement_group_id)
                if pg is not None and pg.state == "CREATED":
                    for b in pg.bundles:
                        if b.node_id == node_id:
                            avail = pg.bundle_available[b.index]
                            ok = True
                            for k, v in spec.resources.items():
                                if avail.get(k, 0.0) + v > b.resources.get(k, 0.0) + _EPS:
                                    ok = False
                            if ok:
                                for k, v in spec.resources.items():
                                    avail[k] = avail.get(k, 0.0) + v
                                return
                return
            n = self.nodes.get(node_id)
            if n is not None:
                n.release(spec.resources)

    # ----- placement groups (2-phase: reserve all or roll back) -----
    def create_placement_group(self, pg: PlacementGroupInfo) -> bool:
        """Try to reserve every bundle atomically (reference 2-phase commit:
        gcs_placement_group_scheduler.h). Returns True if CREATED."""
        with self._lock:
            if not self._reserve_bundles(pg):
                return False
            pg.bundle_available = [dict(b.resources) for b in pg.bundles]
            pg.state = "CREATED"
            self.placement_groups[pg.pg_id] = pg
            return True

    def _reserve_bundles(self, pg: PlacementGroupInfo) -> bool:
        reserved: List[Tuple[NodeResources, Bundle]] = []

        def rollback():
            for n, b in reserved:
                n.release(b.resources)
                b.node_id = None

        strategy = pg.strategy
        nodes = sorted(self.nodes.values(),
                       key=lambda n: -n.utilization())  # pack onto busy nodes first
        if strategy in ("STRICT_PACK",):
            for n in self.nodes.values():
                if _fits_sum(n, [b.resources for b in pg.bundles]):
                    for b in pg.bundles:
                        n.allocate(b.resources)
                        b.node_id = n.node_id
                        reserved.append((n, b))
                    return True
            return False
        used_nodes: set = set()
        for b in pg.bundles:
            placed = False
            for n in nodes:
                if strategy == "STRICT_SPREAD" and n.node_id in used_nodes:
                    continue
                if strategy == "SPREAD" and n.node_id in used_nodes:
                    continue  # prefer new nodes; fall back below
                if n.fits(b.resources):
                    n.allocate(b.resources)
                    b.node_id = n.node_id
                    reserved.append((n, b))
                    used_nodes.add(n.node_id)
                    placed = True
                    break
            if not placed and strategy == "SPREAD":
                for n in nodes:  # soft spread: reuse nodes if needed
                    if n.fits(b.resources):
                        n.allocate(b.resources)
                        b.node_id = n.node_id
                        reserved.append((n, b))
                        placed = True
                        break
            if not placed:
                rollback()
                return False
        return True

    def remove_placement_group(self, pg_id: PlacementGroupID):
        with self._lock:
            pg = self.placement_groups.pop(pg_id, None)
            if pg is None or pg.state != "CREATED":
                return
            for b in pg.bundles:
                n = self.nodes.get(b.node_id)
                if n is not None:
                    n.release(b.resources)
            pg.state = "REMOVED"

    def pg_feasible(self, pg: PlacementGroupInfo) -> bool:
        with self._lock:
            if pg.strategy == "STRICT_SPREAD":
                return len(self.nodes) >= len(pg.bundles) and all(
                    any(n.feasible(b.resources) for n in self.nodes.values())
                    for b in pg.bundles
                )
            if pg.strategy == "STRICT_PACK":
                demand: Dict[str, float] = defaultdict(float)
                for b in pg.bundles:
                    for k, v in b.resources.items():
                        demand[k] += v
                return any(n.feasible(dict(demand)) for n in self.nodes.values())
            return all(
                any(n.feasible(b.resources) for n in self.nodes.values())
                for b in pg.bundles
            )


def _fits_sum(node: NodeResources, demands: List[Dict[str, float]]) -> bool:
    """Whether the summed demand of all bundles fits the node right now."""
    total: Dict[str, float] = defaultdict(float)
    for d in demands:
        for k, v in d.items():
            total[k] += v
    return all(node.available.get(k, 0.0) + _EPS >= v
               for k, v in total.items())


class Infeasible(Exception):
    pass
