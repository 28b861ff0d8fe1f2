"""Model zoo of the port (counterpart of ``ray_tpu/models``): GPT-2
(its MoE variant, its RLHF actor-critic ``GPT2WithValue`` and its
pipeline chunks ``GPT2Stage``/``split_stages``), the Llama family (with
``LlamaStage``), ResNet, and the RL trunks ``MLP``, ``NatureCNN`` and
``MinAtarCNN``."""
from ray_tpu_torch.models.gpt2 import (  # noqa: F401
    GPT2,
    GPT2Config,
    GPT2Stage,
    GPT2WithValue,
    gpt2_loss_fn,
    split_stages,
)
from ray_tpu_torch.models.llama import (  # noqa: F401
    Llama,
    LlamaConfig,
    LlamaStage,
    llama_loss_fn,
)
from ray_tpu_torch.models.mlp import MLP  # noqa: F401
from ray_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    ResNetConfig,
    resnet_loss_fn,
)
from ray_tpu_torch.models.nature_cnn import MinAtarCNN, NatureCNN  # noqa: F401
