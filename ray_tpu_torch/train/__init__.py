"""Distributed training of the port (counterpart of ``ray_tpu/train``;
reference: python/ray/train/): the trainers over a gang of worker actors,
the backend executor, the one-GPU step helpers, and the predictors."""
from ray_tpu_torch.train.backend import Backend, BackendConfig, TestConfig  # noqa: F401
from ray_tpu_torch.train.base_trainer import (  # noqa: F401
    BaseTrainer,
    DataParallelTrainer,
)
from ray_tpu_torch.train.torch import (  # noqa: F401
    TorchConfig,
    TorchTrainer,
    adamw,
    make_train_step,
)
from ray_tpu_torch.train._internal.backend_executor import (  # noqa: F401
    BackendExecutor,
    TrainingWorkerError,
)
from ray_tpu_torch.train._internal.worker_group import WorkerGroup  # noqa: F401
from ray_tpu_torch.train.predictor import (  # noqa: F401
    BatchPredictor,
    Predictor,
    TorchPredictor,
)
