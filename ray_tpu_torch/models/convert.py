"""Carry weights from the JAX package's flax param trees to the port.

Both functions take the tree as numpy arrays (they need no JAX) and
return a ``state_dict``.

``gpt2_params_from_jax``, for ``ray_tpu_torch.models.GPT2``, with the
names of ``ray_tpu/models/gpt2.py::_AXIS_BY_NAME``:

- ``h_{i}/ln_1|ln_2/{scale,bias}`` -> ``h.{i}.ln_1|ln_2.{weight,bias}``;
- ``h_{i}/attn_qkv|attn_proj|mlp_fc|mlp_proj/{kernel [in, out], bias}``
  -> ``h.{i}.<name>.{weight [out, in] (transposed), bias}``;
- ``wte`` and ``wpe`` as they are; ``ln_f`` as a LayerNorm.

``actor_critic_from_flax``, for ``ray_tpu_torch.rllib.DiscreteActorCritic``
(and for a lone ``MLP``, ``NatureCNN`` or ``MinAtarCNN``):

- ``NatureCNN_0`` / ``MinAtarCNN_0`` -> ``trunk``; ``Conv_{i}`` ->
  ``conv_{i}`` with the kernel HWIO -> OIHW; ``Dense_{i}`` -> ``dense_{i}``;
- every Dense kernel ``[in, out]`` -> ``Linear.weight`` ``[out, in]``;
- ``pi``, ``vf``, ``pi_mlp``, ``vf_mlp``, ``dense_{i}`` and ``out`` keep
  their names.
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


_RL_RENAMES = {"NatureCNN_0": "trunk", "MinAtarCNN_0": "trunk"}
_RL_MODULES = re.compile(r"pi|vf|pi_mlp|vf_mlp|out|dense_\d+|conv_\d+|trunk")


def actor_critic_from_flax(tree: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """flax RL params (``module.init``'s output or its ``"params"``) ->
    port state_dict.  Raises ``KeyError`` on a name it does not know."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(sub: Mapping[str, Any], prefix: str):
        if set(sub) == {"kernel", "bias"}:
            kernel = np.asarray(sub["kernel"])
            if kernel.ndim == 4:  # HWIO -> OIHW
                kernel = kernel.transpose(3, 2, 0, 1)
            elif kernel.ndim == 2:  # [in, out] -> [out, in]
                kernel = kernel.T
            else:
                raise KeyError(f"{prefix}: kernel of rank {kernel.ndim}")
            out[f"{prefix}.weight"] = _tensor(kernel)
            out[f"{prefix}.bias"] = _tensor(sub["bias"])
            return
        for name, child in sub.items():
            name = _RL_RENAMES.get(name, re.sub(
                r"^(Conv|Dense)_(\d+)$",
                lambda m: f"{m.group(1).lower()}_{m.group(2)}", name))
            if not _RL_MODULES.fullmatch(name) or not isinstance(
                    child, Mapping):
                raise KeyError(f"unknown RL parameter {prefix}/{name}")
            walk(child, f"{prefix}.{name}" if prefix else name)

    walk(tree, "")
    return out
