"""Model zoo of the port (counterpart of ``ray_tpu/models``): GPT-2 so
far; Llama and the rest follow in later slices."""
from ray_tpu_torch.models.gpt2 import (  # noqa: F401
    GPT2,
    GPT2Config,
    gpt2_loss_fn,
)
