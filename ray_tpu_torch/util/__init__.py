"""Utility APIs (reference: python/ray/util/).

Copied from ``ray_tpu/util/__init__.py`` (the JAX package).
"""
from ray_tpu_torch.util.placement_group import (  # noqa: F401
    PlacementGroup,
    get_current_placement_group,
    placement_group,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import (  # noqa: F401
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)


def __getattr__(name):
    import importlib

    if name in ("collective", "actor_pool", "queue", "metrics", "iter",
                "multiprocessing", "joblib"):
        return importlib.import_module(f"ray_tpu_torch.util.{name}")
    raise AttributeError(name)
