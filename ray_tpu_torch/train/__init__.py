"""Training of the port (counterpart of ``ray_tpu/train``): the one-GPU
step helpers so far; the Train stack (trainers over worker actors, the
session, dataset shards, device prefetch) follows with the runtime."""
from ray_tpu_torch.train.torch import adamw, make_train_step  # noqa: F401
