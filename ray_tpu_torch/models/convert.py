"""Carry weights from the JAX package's flax param trees to the port,
and between the port's own models.

The ``*_from_jax``/``*_from_flax`` functions take the tree as numpy
arrays (they need no JAX) and return a ``state_dict``.

``gpt2_params_from_jax``, for ``ray_tpu_torch.models.GPT2``, with the
names of ``ray_tpu/models/gpt2.py::_AXIS_BY_NAME``:

- ``h_{i}/ln_1|ln_2/{scale,bias}`` -> ``h.{i}.ln_1|ln_2.{weight,bias}``;
- ``h_{i}/attn_qkv|attn_proj|mlp_fc|mlp_proj/{kernel [in, out], bias}``
  -> ``h.{i}.<name>.{weight [out, in] (transposed), bias}``;
- ``wte`` and ``wpe`` as they are; ``ln_f`` as a LayerNorm;
- for ``GPT2WithValue`` (the RLHF actor-critic): ``lm/...`` -> ``lm.``
  plus the names above, ``value_head/{kernel [h, 1], bias [1]}`` ->
  ``value_head.{weight [1, h] (transposed), bias}``.

``llama_params_from_jax``, for ``ray_tpu_torch.models.Llama``, with the
names of ``ray_tpu/models/llama.py``:

- ``embed/embedding`` [V, h] -> ``embed``;
- ``layer_{i}/attn/{q,k,v,o}_proj/kernel`` and
  ``layer_{i}/mlp/{gate,up,down}_proj/kernel`` [in, out] ->
  ``layers.{i}.attn|mlp.<name>.weight`` [out, in] (transposed; no bias);
- ``layer_{i}/attn_norm|mlp_norm/scale`` -> ``layers.{i}.<norm>.weight``,
  ``final_norm/scale`` -> ``final_norm.weight``;
- ``lm_head/kernel`` [h, V] -> ``lm_head.weight`` [V, h].

``actor_critic_from_flax``, for ``ray_tpu_torch.rllib.DiscreteActorCritic``
(and for a lone ``MLP``, ``NatureCNN`` or ``MinAtarCNN``):

- ``NatureCNN_0`` / ``MinAtarCNN_0`` -> ``trunk``; ``Conv_{i}`` ->
  ``conv_{i}`` with the kernel HWIO -> OIHW; ``Dense_{i}`` -> ``dense_{i}``;
- every Dense kernel ``[in, out]`` -> ``Linear.weight`` ``[out, in]``;
- ``pi``, ``vf``, ``pi_mlp``, ``vf_mlp``, ``dense_{i}`` and ``out`` keep
  their names.

``recurrent_actor_critic_from_flax``, for
``ray_tpu_torch.rllib.algorithms.ppo_rnn.RecurrentActorCritic``:
``embed_{pi,vf}`` (MLP) or ``cnn_{pi,vf}`` (CNN) and the heads as above;
each ``OptimizedLSTMCell`` ``lstm_{pi,vf}`` (Dense layers ``ii if ig io``
without bias, ``hi hf hg ho`` with bias) becomes one ``nn.LSTMCell``:
``weight_ih`` the input kernels stacked in the order i, f, g, o,
``weight_hh`` the recurrent ones, ``bias_hh`` their biases, ``bias_ih``
zeros.

``attention_actor_critic_from_flax``, for
``ray_tpu_torch.rllib.algorithms.ppo_attn.AttentionActorCritic``:
``pos_{pi,vf}`` as they are; in each ``block_{tag}_{i}``, the
LayerNorms' ``scale`` -> ``weight``, the GRU gates' Dense kernels, and
the attention's ``query``/``key``/``value`` kernels ``[d, heads,
head_dim]`` (bias ``[heads, head_dim]``) and ``out`` kernel ``[heads,
head_dim, d]``, flattened to ``[in, out]`` and transposed.

``replay_family_from_flax``, for the replay family's networks in
``ray_tpu_torch.rllib.algorithms`` (``dqn.QNetwork``,
``sac.SquashedGaussianPolicy``, ``td3.DeterministicPolicy``: a flax
``MLP`` at the top, ``{"params": {dense_{i}, out}}``, becomes ``net``;
``sac.TwinQ``: ``{"q1": {"params": ...}, "q2": ...}`` becomes ``q1``,
``q2``), the Dense kernels transposed.

``layerskip_draft`` builds the speculative-decoding draft of
``bench.py::bench_serving_spec`` (``:768-774``) from a target GPT-2: one
layer, with copies of the target's ``wte``, ``wpe``, ``h.0`` and
``ln_f``.
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
    """flax GPT-2 (or ``GPT2WithValue``) params (nested dict of numpy
    arrays) -> port state_dict.  Raises ``KeyError`` on a name it does not
    know, so no parameter is dropped silently."""
    out: Dict[str, torch.Tensor] = {}
    for name, sub in tree.items():
        if name == "lm":
            out.update({f"lm.{k}": t
                        for k, t in gpt2_params_from_jax(sub).items()})
        elif name == "value_head":
            if set(sub) != {"kernel", "bias"}:
                raise KeyError(f"value_head: expected kernel/bias, got "
                               f"{sorted(sub)}")
            out["value_head.weight"] = _tensor(np.asarray(sub["kernel"]).T)
            out["value_head.bias"] = _tensor(sub["bias"])
        elif name in ("wte", "wpe"):
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


_LLAMA_DENSE = {"attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
                "mlp": ("gate_proj", "up_proj", "down_proj")}


def _only(prefix: str, sub: Mapping[str, Any], leaf: str):
    if not isinstance(sub, Mapping) or set(sub) != {leaf}:
        raise KeyError(f"{prefix}: expected {leaf}, got "
                       f"{sorted(sub) if isinstance(sub, Mapping) else sub}")
    return sub[leaf]


def llama_params_from_jax(tree: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """flax Llama params (nested dict of numpy arrays) -> port
    state_dict.  Raises ``KeyError`` on a name it does not know, so no
    parameter is dropped silently."""
    out: Dict[str, torch.Tensor] = {}
    for name, sub in tree.items():
        if name == "embed":
            out["embed"] = _tensor(_only(name, sub, "embedding"))
        elif name == "final_norm":
            out["final_norm.weight"] = _tensor(_only(name, sub, "scale"))
        elif name == "lm_head":
            out["lm_head.weight"] = _tensor(
                np.asarray(_only(name, sub, "kernel")).T)
        elif re.fullmatch(r"layer_\d+", name):
            i = int(name[6:])
            for part, p in sub.items():
                prefix = f"layers.{i}.{part}"
                if part in ("attn_norm", "mlp_norm"):
                    out[f"{prefix}.weight"] = _tensor(
                        _only(f"{name}/{part}", p, "scale"))
                elif part in _LLAMA_DENSE:
                    for dense, kp in p.items():
                        if dense not in _LLAMA_DENSE[part]:
                            raise KeyError(f"unknown Llama layer "
                                           f"{name}/{part}/{dense}")
                        out[f"{prefix}.{dense}.weight"] = _tensor(np.asarray(
                            _only(f"{name}/{part}/{dense}", kp,
                                  "kernel")).T)
                else:
                    raise KeyError(f"unknown Llama layer {name}/{part}")
        else:
            raise KeyError(f"unknown Llama parameter {name!r}")
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
    _rl_walk(tree, out, "", lambda *args: False, known=_RL_MODULES)
    return out


def _rl_walk(tree: Mapping[str, Any], out: Dict[str, torch.Tensor],
             prefix: str, leaf, known=None) -> None:
    """Walks a flax RL param tree into ``out``: a Dense or Conv leaf dict
    (``kernel`` and an optional ``bias``) becomes ``.weight``/``.bias``;
    ``leaf(prefix, name, child, out)`` may claim any other entry
    (returning True) before the walk descends into it.  With ``known``
    (a pattern), a module name it does not match raises ``KeyError``;
    without, a name the port's module lacks fails its
    ``load_state_dict``."""
    for name, child in tree.items():
        if leaf(prefix, name, child, out):
            continue
        name = _RL_RENAMES.get(name, re.sub(
            r"^(Conv|Dense)_(\d+)$",
            lambda m: f"{m.group(1).lower()}_{m.group(2)}", name))
        path = f"{prefix}.{name}" if prefix else name
        if not isinstance(child, Mapping) or (
                known is not None and not known.fullmatch(name)):
            raise KeyError(f"unknown RL parameter {path}")
        if "kernel" in child:
            if not set(child) <= {"kernel", "bias"}:
                raise KeyError(f"{path}: expected kernel/bias, got "
                               f"{sorted(child)}")
            kernel = np.asarray(child["kernel"])
            if kernel.ndim == 4:  # HWIO -> OIHW
                kernel = kernel.transpose(3, 2, 0, 1)
            elif kernel.ndim == 2:
                kernel = kernel.T
            else:
                raise KeyError(f"{path}: kernel of rank {kernel.ndim}")
            out[f"{path}.weight"] = _tensor(kernel)
            if "bias" in child:
                out[f"{path}.bias"] = _tensor(child["bias"])
        else:
            _rl_walk(child, out, path, leaf)


_LSTM_GATES = "ifgo"


def _lstm_leaf(prefix, name, child, out) -> bool:
    if not re.fullmatch(r"lstm_(pi|vf)", name):
        return False
    want = {f"i{g}" for g in _LSTM_GATES} | {f"h{g}" for g in _LSTM_GATES}
    if set(child) != want:
        raise KeyError(f"{name}: expected {sorted(want)}, got "
                       f"{sorted(child)}")
    size = np.asarray(child["hi"]["kernel"]).shape[1]
    out[f"{name}.weight_ih"] = _tensor(np.concatenate(
        [np.asarray(child[f"i{g}"]["kernel"]).T for g in _LSTM_GATES]))
    out[f"{name}.weight_hh"] = _tensor(np.concatenate(
        [np.asarray(child[f"h{g}"]["kernel"]).T for g in _LSTM_GATES]))
    out[f"{name}.bias_hh"] = _tensor(np.concatenate(
        [np.asarray(child[f"h{g}"]["bias"]) for g in _LSTM_GATES]))
    out[f"{name}.bias_ih"] = torch.zeros(4 * size)
    return True


def recurrent_actor_critic_from_flax(tree: Mapping[str, Any]
                                     ) -> Dict[str, torch.Tensor]:
    """flax ``RecurrentActorCritic`` params -> port state_dict."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    _rl_walk(tree, out, "", _lstm_leaf)
    return out


def _attention_leaf(prefix, name, child, out) -> bool:
    path = f"{prefix}.{name}" if prefix else name
    if re.fullmatch(r"pos_(pi|vf)", name):
        out[path] = _tensor(child)
        return True
    if re.fullmatch(r"LayerNorm_\d+", name):
        _norm(path, child, out)
        return True
    if name in ("query", "key", "value", "out") and prefix.endswith(".mha"):
        kernel = np.asarray(child["kernel"])
        d_in = kernel.shape[0] if name != "out" else -1
        flat = (kernel.reshape(d_in, -1) if name != "out"
                else kernel.reshape(-1, kernel.shape[-1]))
        out[f"{path}.weight"] = _tensor(flat.T)
        out[f"{path}.bias"] = _tensor(np.asarray(child["bias"]).reshape(-1))
        return True
    return False


def attention_actor_critic_from_flax(tree: Mapping[str, Any]
                                     ) -> Dict[str, torch.Tensor]:
    """flax ``AttentionActorCritic`` params -> port state_dict."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    _rl_walk(tree, out, "", _attention_leaf)
    return out


_REPLAY_MODULES = re.compile(r"net|q1|q2")


def replay_family_from_flax(tree: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """flax params of ``QNetwork``, ``SquashedGaussianPolicy``,
    ``DeterministicPolicy`` (``init``'s output) or ``TwinQ`` -> port
    state_dict.  Raises ``KeyError`` on a name it does not know."""
    if set(tree) == {"params"}:
        heads = {"net": tree["params"]}
    elif set(tree) == {"q1", "q2"}:
        heads = {}
        for name, head in tree.items():
            if set(head) != {"params"}:
                raise KeyError(f"{name}: expected params, got {sorted(head)}")
            heads[name] = head["params"]
    else:
        raise KeyError(f"unknown replay-family tree {sorted(tree)}")
    out: Dict[str, torch.Tensor] = {}
    _rl_walk(heads, out, "", lambda *args: False, known=_REPLAY_MODULES)
    return out


def layerskip_draft(target):
    """The LayerSkip draft of a ``GPT2`` target: the target's config cut
    to one layer, holding copies of its ``wte``, ``wpe``, first block and
    ``ln_f``, on the target's device.  The tensors are copied, not shared,
    as in the JAX bench (``draft_params`` is a tree of its own): a later
    ``swap_weights`` of the target leaves the draft as it was."""
    import dataclasses

    from ray_tpu_torch.models.gpt2 import GPT2

    cfg = dataclasses.replace(target.config, num_layers=1)
    keep = {name: t for name, t in target.state_dict().items()
            if name.split(".")[0] in ("wte", "wpe", "ln_f")
            or name.startswith("h.0.")}
    draft = GPT2(cfg).to(next(target.parameters()).device)
    draft.load_state_dict(keep)  # copies into the draft's own tensors
    return draft.eval()
