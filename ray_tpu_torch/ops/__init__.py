"""Ops of the port: plain PyTorch layers and attention, and the
hand-written Hopper kernels under ``csrc/`` (built at first use by
``_build.py``)."""
from ray_tpu_torch.ops.attention import (  # noqa: F401
    cached_attention,
    flash_attention,
    flash_attention_reference,
    mha_attention,
)
from ray_tpu_torch.ops.layers import gelu, layer_norm  # noqa: F401
