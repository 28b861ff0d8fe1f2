"""The torch trainer and its step helpers (counterpart of
``ray_tpu/train/jax``; reference: python/ray/train/torch/
torch_trainer.py)."""
from ray_tpu_torch.train.base_trainer import DataParallelTrainer
from ray_tpu_torch.train.torch.config import TorchConfig  # noqa: F401
from ray_tpu_torch.train.torch.train_loop_utils import (  # noqa: F401
    AsyncMetrics,
    adamw,
    compile_zero_step,
    get_mesh,
    make_train_step,
    prepare_batch,
    prepare_device_iterator,
    prepare_model,
    prepare_train_state,
)


class TorchTrainer(DataParallelTrainer):
    """DataParallelTrainer whose gang forms one ``torch.distributed``
    process group (``TorchConfig``): the counterpart of ``JaxTrainer``."""

    def __init__(self, train_loop_per_worker, *, torch_config=None, **kw):
        kw.setdefault("backend_config", torch_config or TorchConfig())
        super().__init__(train_loop_per_worker, **kw)
