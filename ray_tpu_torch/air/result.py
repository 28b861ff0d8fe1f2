"""Result object returned by trainers/tuner (reference: ray.air.Result).

Copied from ``ray_tpu/air/result.py`` (the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint


@dataclasses.dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint] = None
    error: Optional[BaseException] = None
    metrics_history: Optional[List[Dict[str, Any]]] = None

    @property
    def metrics_dataframe(self):
        import pandas as pd

        return pd.DataFrame(self.metrics_history or [self.metrics])
