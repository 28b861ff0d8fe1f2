"""Step helpers (counterpart of ``ray_tpu/train/jax``)."""
from ray_tpu_torch.train.torch.train_loop_utils import (  # noqa: F401
    adamw,
    make_train_step,
)
