"""Autoscaling policy (copy of ``ray_tpu/serve/autoscaling.py``;
reference: serve/_private/autoscaling_policy.py:10-49)."""
from __future__ import annotations

import math


def calculate_desired_num_replicas(current_num_replicas: int,
                                   avg_queued_per_replica: float,
                                   target_queued_per_replica: float = 1.0,
                                   min_replicas: int = 1,
                                   max_replicas: int = 10,
                                   smoothing_factor: float = 1.0) -> int:
    if current_num_replicas == 0:
        return min_replicas
    error_ratio = avg_queued_per_replica / max(target_queued_per_replica, 1e-9)
    desired = math.ceil(current_num_replicas
                        * (1 + (error_ratio - 1) * smoothing_factor))
    return max(min_replicas, min(max_replicas, desired))
