"""Carry GPT-2 weights from the JAX package's flax param tree to the port.

``gpt2_params_from_jax`` takes the tree as numpy arrays (it needs no
JAX) and returns a ``state_dict`` for ``ray_tpu_torch.models.GPT2``.  The
names are those of ``ray_tpu/models/gpt2.py::_AXIS_BY_NAME``:

- ``h_{i}/ln_1|ln_2/{scale,bias}`` -> ``h.{i}.ln_1|ln_2.{weight,bias}``;
- ``h_{i}/attn_qkv|attn_proj|mlp_fc|mlp_proj/{kernel [in, out], bias}``
  -> ``h.{i}.<name>.{weight [out, in] (transposed), bias}``;
- ``wte`` and ``wpe`` as they are; ``ln_f`` as a LayerNorm.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_DENSE = ("attn_qkv", "attn_proj", "mlp_fc", "mlp_proj")
_NORMS = ("ln_1", "ln_2")


def _norm(prefix: str, sub: Mapping[str, Any], out: Dict[str, torch.Tensor]):
    if set(sub) != {"scale", "bias"}:
        raise KeyError(f"{prefix}: expected scale/bias, got {sorted(sub)}")
    out[f"{prefix}.weight"] = _tensor(sub["scale"])
    out[f"{prefix}.bias"] = _tensor(sub["bias"])


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def gpt2_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax GPT-2 params (nested dict of numpy arrays) -> port state_dict.
    Raises ``KeyError`` on a name it does not know, so no parameter is
    dropped silently."""
    out: Dict[str, torch.Tensor] = {}
    for name, sub in tree.items():
        if name in ("wte", "wpe"):
            out[name] = _tensor(sub)
        elif name == "ln_f":
            _norm("ln_f", sub, out)
        elif re.fullmatch(r"h_\d+", name):
            i = int(name[2:])
            for layer, p in sub.items():
                prefix = f"h.{i}.{layer}"
                if layer in _NORMS:
                    _norm(prefix, p, out)
                elif layer in _DENSE:
                    if set(p) != {"kernel", "bias"}:
                        raise KeyError(f"{prefix}: expected kernel/bias, "
                                       f"got {sorted(p)}")
                    out[f"{prefix}.weight"] = _tensor(np.asarray(p["kernel"]).T)
                    out[f"{prefix}.bias"] = _tensor(p["bias"])
                else:
                    raise KeyError(f"unknown GPT-2 layer {name}/{layer}")
        else:
            raise KeyError(f"unknown GPT-2 parameter {name!r}")
    return out
