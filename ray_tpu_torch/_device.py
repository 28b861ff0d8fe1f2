"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means CUDA.  A CUDA device that does not exist raises
    ``RuntimeError``: the port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was asked for (the default when no device is "
            f"given) but torch.cuda.is_available() is False; pass "
            f"device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
