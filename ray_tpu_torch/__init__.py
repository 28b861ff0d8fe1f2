"""ray_tpu_torch: the PyTorch/CUDA port of ``ray_tpu`` for NVIDIA Hopper.

The layout mirrors the JAX package (``ops/attention.py`` here is the
counterpart of ``ray_tpu/ops/attention.py``, and so on).  The port
imports ``torch`` and never JAX or anything of ``ray_tpu``.  Every entry
point runs on ``cuda`` unless the caller passes ``device="cpu"``; asking
for CUDA where there is none raises rather than running on the CPU.
"""
from ray_tpu_torch._device import resolve_device  # noqa: F401
