"""Carry weights from the JAX package's flax param trees to the port,
and between the port's own models.

The ``*_from_jax``/``*_from_flax`` functions take the tree as numpy
arrays (they need no JAX) and return a ``state_dict``.

``gpt2_params_from_jax``, for ``ray_tpu_torch.models.GPT2``, with the
names of ``ray_tpu/models/gpt2.py::_AXIS_BY_NAME``:

- ``h_{i}/ln_1|ln_2/{scale,bias}`` -> ``h.{i}.ln_1|ln_2.{weight,bias}``;
- ``h_{i}/attn_qkv|attn_proj|mlp_fc|mlp_proj/{kernel [in, out], bias}``
  -> ``h.{i}.<name>.{weight [out, in] (transposed), bias}``;
- ``h_{i}/moe_router|moe_w_in|moe_w_out`` (the MoE blocks) ->
  ``h.{i}.<name>`` as they are (the einsums use them untransposed);
- ``wte`` and ``wpe`` as they are; ``ln_f`` as a LayerNorm;
- ``h_scan`` (the layer stack of a model of ``scan_layers_threshold``
  layers or more: every leaf stacked on a leading layer axis) unstacked
  into ``h_{i}`` first (``unstack_layers``);
- a ``GPT2Stage`` chunk's tree has the same names, its blocks at their
  global index, plus the untied ``lm_head`` [V, d] of the last chunk,
  taken as it is (a ``LlamaStage`` chunk has ``Llama``'s names, so
  ``llama_params_from_jax`` reads it);
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

The rest of RLlib:

- ``es_flat_from_jax``: ES's flat vector (``ravel_pytree`` of the flax
  ``MLP``'s params: layers in sorted name order, each ``bias`` then its
  ``kernel`` ``[in, out]`` row-major), or any ``[..., dim]`` rows of such
  vectors (ES's noise), -> the port's order (``parameters_to_vector``:
  each layer's ``[out, in]`` weight, then its bias).  The map is a
  permutation of coordinates, so the elementwise ES update commutes with
  it;
- ``qmix_from_flax``: QMIX's ``{"agent": {"params"}, "mixer": {"w1",
  "b1", "w2", "b2"}}`` -> ``QMixNet``'s ``agent.*`` and
  ``mixer.hyper_{w1,b1,w2,b2}.*``;
- ``dyna_q_from_flax``: Dyna-Q's Q network and dynamics model (two
  ``{"params"}`` trees of a flax ``MLP``) -> the ``q.net.*`` and
  ``model.net.*`` of ``DynaQLearner.checkpoint_state``;
- BC's and MARWIL's module (MARWIL's value head is its ``vf_mlp``) is a
  ``DiscreteActorCritic``: ``actor_critic_from_flax``.

``resnet_params_from_jax``, for ``ray_tpu_torch.models.ResNet``, from
flax's ``params`` and ``batch_stats``:

- ``stem/kernel`` and each ``ResNetBlock_{i}/Conv_{j}/kernel`` (HWIO) ->
  ``stem.weight`` and ``blocks.{i}.conv_{j}.weight`` (OIHW);
- ``stem_bn`` and ``ResNetBlock_{i}/BatchNorm_{j}``: ``scale``/``bias``
  -> ``weight``/``bias``, and from ``batch_stats`` ``mean``/``var`` ->
  ``running_mean``/``running_var``;
- ``head/{kernel [in, out], bias}`` -> ``head.{weight (transposed),
  bias}``.

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
_MOE = ("moe_router", "moe_w_in", "moe_w_out")


def _norm(prefix: str, sub: Mapping[str, Any], out: Dict[str, torch.Tensor]):
    if set(sub) != {"scale", "bias"}:
        raise KeyError(f"{prefix}: expected scale/bias, got {sorted(sub)}")
    out[f"{prefix}.weight"] = _tensor(sub["scale"])
    out[f"{prefix}.bias"] = _tensor(sub["bias"])


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def gpt2_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax GPT-2 (``GPT2WithValue``, or a ``GPT2Stage`` chunk's) params
    (nested dict of numpy arrays) -> port state_dict.  Raises ``KeyError``
    on a name it does not know, so no parameter is dropped silently."""
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
        elif name == "lm_head" and not isinstance(sub, Mapping):
            out["lm_head"] = _tensor(sub)
        elif name == "h_scan":
            out.update(gpt2_params_from_jax(unstack_layers(sub)))
        elif re.fullmatch(r"h_\d+", name):
            i = int(name[2:])
            for layer, p in sub.items():
                prefix = f"h.{i}.{layer}"
                if layer in _NORMS:
                    _norm(prefix, p, out)
                elif layer in _MOE:
                    out[prefix] = _tensor(p)
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


def unstack_layers(scan_tree: Mapping[str, Any], prefix: str = "h_"
                   ) -> Dict[str, Any]:
    """A flax ``nn.scan`` layer stack (every leaf stacked on a leading
    layer axis, GPT-2's ``h_scan``) as per-layer trees ``{prefix}{i}``."""
    def leaves(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,), np.asarray(v)

    flat = list(leaves(scan_tree))
    depth = {a.shape[0] for _, a in flat}
    if len(depth) != 1:
        raise KeyError(f"layer stack with ragged leading axes {depth}")
    out: Dict[str, Any] = {}
    for i in range(depth.pop()):
        for path, a in flat:
            node = out.setdefault(f"{prefix}{i}", {})
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = a[i]
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
    parameter is dropped silently.  A ``LlamaStage`` tree has the same
    names (blocks at their global index, the chunk's own ``embed``,
    ``final_norm`` and ``lm_head`` where it has them)."""
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


def _es_layout(obs_dim: int, hiddens, num_actions: int):
    widths = (obs_dim, *hiddens, num_actions)
    names = [f"dense_{i}" for i in range(len(hiddens))] + ["out"]
    return names, dict(zip(names, zip(widths, widths[1:])))


def es_flat_from_jax(flat, obs_dim: int, hiddens, num_actions: int
                     ) -> torch.Tensor:
    """ES's flat vector(s) ``[..., dim]`` in ``ravel_pytree``'s order ->
    the port's (see the module's docstring)."""
    x = np.asarray(flat, np.float32)
    lead = x.shape[:-1]
    names, dims = _es_layout(obs_dim, hiddens, num_actions)
    parts, off = {}, 0
    for name in sorted(names):  # ravel_pytree's key order
        a, b = dims[name]
        parts[name, "bias"] = x[..., off:off + b]
        off += b
        parts[name, "kernel"] = x[..., off:off + a * b].reshape(lead + (a, b))
        off += a * b
    if off != x.shape[-1]:
        raise ValueError(f"flat vector of {x.shape[-1]}, the MLP has {off}")
    out = []
    for name in names:
        a, b = dims[name]
        out.append(np.swapaxes(parts[name, "kernel"], -1, -2).reshape(
            lead + (a * b,)))
        out.append(parts[name, "bias"])
    return torch.from_numpy(np.ascontiguousarray(np.concatenate(out, -1)))


def _params_of(tree: Mapping[str, Any], what: str) -> Mapping[str, Any]:
    if set(tree) != {"params"}:
        raise KeyError(f"{what}: expected params, got {sorted(tree)}")
    return tree["params"]


def qmix_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """QMIX's flax params -> ``QMixNet`` state_dict."""
    if set(tree) != {"agent", "mixer"}:
        raise KeyError(f"unknown QMIX tree {sorted(tree)}")
    mixer = tree["mixer"]
    if set(mixer) != {"w1", "b1", "w2", "b2"}:
        raise KeyError(f"unknown QMIX mixer {sorted(mixer)}")
    heads = {"agent": _params_of(tree["agent"], "agent"),
             "mixer": {f"hyper_{k}": _params_of(v, f"mixer/{k}")
                       for k, v in mixer.items()}}
    out: Dict[str, torch.Tensor] = {}
    _rl_walk(heads, out, "", lambda *args: False)
    return out


def dyna_q_from_flax(q_tree: Mapping[str, Any], model_tree: Mapping[str, Any]
                     ) -> Dict[str, torch.Tensor]:
    """Dyna-Q's flax Q network and dynamics model -> the state of
    ``DynaQLearner.checkpoint_state``."""
    out: Dict[str, torch.Tensor] = {}
    for prefix, tree in (("q", q_tree), ("model", model_tree)):
        _rl_walk({"net": _params_of(tree, prefix)}, out, prefix,
                 lambda *args: False)
    return out


def _resnet_norm(prefix, params, stats, out):
    _norm(prefix, params, out)
    if set(stats) != {"mean", "var"}:
        raise KeyError(f"{prefix}: expected mean/var, got {sorted(stats)}")
    out[f"{prefix}.running_mean"] = _tensor(stats["mean"])
    out[f"{prefix}.running_var"] = _tensor(stats["var"])


def _conv_kernel(prefix, p, out):
    if set(p) != {"kernel"}:
        raise KeyError(f"{prefix}: expected kernel, got {sorted(p)}")
    out[f"{prefix}.weight"] = _tensor(
        np.asarray(p["kernel"]).transpose(3, 2, 0, 1))


def resnet_params_from_jax(params: Mapping[str, Any],
                           batch_stats: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """flax ResNet ``params`` and ``batch_stats`` (nested dicts of numpy
    arrays) -> port state_dict.  Raises ``KeyError`` on a name it does
    not know."""
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        if name == "stem":
            _conv_kernel("stem", sub, out)
        elif name == "stem_bn":
            _resnet_norm("stem_bn", sub, batch_stats["stem_bn"], out)
        elif name == "head":
            out["head.weight"] = _tensor(np.asarray(sub["kernel"]).T)
            out["head.bias"] = _tensor(sub["bias"])
        elif re.fullmatch(r"ResNetBlock_\d+", name):
            i = int(name.rsplit("_", 1)[1])
            for layer, p in sub.items():
                kind, j = layer.rsplit("_", 1)
                if kind == "Conv":
                    _conv_kernel(f"blocks.{i}.conv_{j}", p, out)
                elif kind == "BatchNorm":
                    _resnet_norm(f"blocks.{i}.bn_{j}", p,
                                 batch_stats[name][layer], out)
                else:
                    raise KeyError(f"unknown ResNet layer {name}/{layer}")
        else:
            raise KeyError(f"unknown ResNet parameter {name!r}")
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
