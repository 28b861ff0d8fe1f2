"""Placement groups (reference: python/ray/util/placement_group.py:128).

Copied from ``ray_tpu/util/placement_group.py`` (the JAX package).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import PlacementGroupID

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]],
                 strategy: str):
        self.id = pg_id
        self.bundle_specs = bundles
        self.strategy = strategy

    def ready(self, timeout: Optional[float] = None):
        """Block until all bundles are reserved (reference returns an
        ObjectRef; here a blocking call — wrap with .remote if needed)."""
        from ray_tpu_torch._private.worker import global_worker

        return global_worker.transport.request(
            "pg_ready", {"pg_id": self.id, "timeout": timeout})

    def wait(self, timeout_seconds: float = 30) -> bool:
        try:
            self.ready(timeout=timeout_seconds)
            return True
        except Exception:
            return False

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs, self.strategy))


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "") -> PlacementGroup:
    from ray_tpu_torch._private.worker import global_worker

    if global_worker is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    pg_id = PlacementGroupID.from_random()
    pg = PlacementGroup(pg_id, bundles, strategy)
    # Fire the reservation; resolution is observed via pg.ready()/wait().
    import threading

    def create():
        try:
            global_worker.transport.request(
                "create_pg",
                {"pg_id": pg_id, "bundles": bundles, "strategy": strategy,
                 "name": name})
        except Exception:
            pass  # surfaced on ready()

    threading.Thread(target=create, daemon=True).start()
    return pg


def remove_placement_group(pg: PlacementGroup):
    from ray_tpu_torch._private.worker import global_worker

    global_worker.transport.request("remove_pg", {"pg_id": pg.id})


def get_current_placement_group() -> Optional[PlacementGroup]:
    return None  # populated for tasks running inside a PG in a later round
