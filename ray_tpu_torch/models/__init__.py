"""Model zoo of the port (counterpart of ``ray_tpu/models``): GPT-2
(its MoE variant and its RLHF actor-critic ``GPT2WithValue``), the Llama
family, ResNet, and the RL trunks ``MLP``, ``NatureCNN`` and
``MinAtarCNN``."""
from ray_tpu_torch.models.gpt2 import (  # noqa: F401
    GPT2,
    GPT2Config,
    GPT2WithValue,
    gpt2_loss_fn,
)
from ray_tpu_torch.models.llama import (  # noqa: F401
    Llama,
    LlamaConfig,
    llama_loss_fn,
)
from ray_tpu_torch.models.mlp import MLP  # noqa: F401
from ray_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    ResNetConfig,
    resnet_loss_fn,
)
from ray_tpu_torch.models.nature_cnn import MinAtarCNN, NatureCNN  # noqa: F401
