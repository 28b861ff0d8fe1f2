"""GPT-2 in PyTorch (counterpart of ``ray_tpu/models/gpt2.py``).

The numerics follow the flax model so that converted weights give the
same logits:

- LayerNorm runs in fp32 with flax's epsilon (1e-6, torch's default is
  1e-5) and flax's one-pass variance, and returns fp32;
- Dense layers compute in the compute dtype (``config.dtype``, bf16 by
  default) over fp32 parameters;
- the embedding sum and the residual stream are in the compute dtype;
- the fused QKV output is split into contiguous thirds, then reshaped to
  [B, L, H, D];
- the LM head is tied to ``wte``: its matmul runs in the compute dtype
  and the logits are promoted to fp32.

Attention goes through ``ops.attention``: ``mha_attention`` (the Hopper
flash kernels on long CUDA inputs, differentiable) for the full-context
forward, and ``cached_attention`` for the incremental-decode path.  An
``attn_fn(q, k, v)`` given to ``GPT2`` or ``Block`` replaces
``mha_attention`` in the full-context forward (``ring_attention`` over a
``sequence`` axis, with the rank's ``positions``).

With ``GPT2Config.moe`` set, every block's dense MLP becomes a top-k
routed expert MLP (``ops.moe``): parameters ``moe_router`` [d, E],
``moe_w_in`` [E, d, f] and ``moe_w_out`` [E, f, d], fp32.  Its input is
``ln_2``'s fp32 output, so the router, the dispatch and the expert FFN
run in fp32 in a bf16 model too; only the sum is cast to the compute
dtype.  The block calls ``moe_fn(tokens, w_router, w_in, w_out, moe)``,
``moe_apply`` by default; the ``expert`` layout passes the
expert-parallel one (``make_expert_parallel_moe``), where the JAX
package gets the same placement from GSPMD.

``gpt2_loss_fn`` is the training objective.  ``GPT2WithValue`` is the
RLHF actor-critic: a ``GPT2`` named ``lm`` plus an fp32 value head over
its post-``ln_f`` hidden state.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import cached_attention, mha_attention
from ray_tpu_torch.ops.layers import gelu
from ray_tpu_torch.ops.moe import MoEConfig, moe_apply


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    max_position_embeddings: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    hidden_size: int = 768
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16
    # From this depth the full-context forward recomputes each block in
    # the backward (the JAX package's remat layer stack).
    scan_layers_threshold: int = 24
    # Mixture-of-Experts in place of every block's dense MLP.
    moe: Optional[MoEConfig] = None

    @classmethod
    def gpt2_small(cls, **kw):  # 125M
        return cls(**kw)

    @classmethod
    def moe_tiny(cls, num_experts: int = 8, top_k: int = 2, **kw):
        kw.setdefault("moe", MoEConfig(num_experts=num_experts, top_k=top_k))
        return cls.tiny(**kw)

    @classmethod
    def gpt2_medium(cls, **kw):  # 350M
        return cls(num_layers=24, num_heads=16, hidden_size=1024, **kw)

    @classmethod
    def gpt2_xl(cls, **kw):  # 1.5B
        return cls(num_layers=48, num_heads=25, hidden_size=1600, **kw)

    @classmethod
    def tiny(cls, **kw):  # test-sized
        kw.setdefault("vocab_size", 512)
        kw.setdefault("max_position_embeddings", 128)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 2)
        kw.setdefault("hidden_size", 64)
        return cls(**kw)

    @classmethod
    def draft_of(cls, target: "GPT2Config", num_layers: int = 1,
                 num_heads: Optional[int] = None,
                 hidden_size: Optional[int] = None, **kw):
        """A speculative-decoding draft config for ``target``: the same
        vocab, context length and dtype (what the engine requires), the
        rest shrunk; by default one layer at half width."""
        heads = num_heads or max(1, target.num_heads // 2)
        hidden = hidden_size or max(heads * 8, target.hidden_size // 2)
        hidden -= hidden % heads  # head_dim must divide
        return cls(vocab_size=target.vocab_size,
                   max_position_embeddings=target.max_position_embeddings,
                   num_layers=num_layers, num_heads=heads,
                   hidden_size=hidden, dtype=target.dtype, **kw)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: fp32 statistics with the
    one-pass variance ``max(E[x^2] - E[x]^2, 0)``, epsilon 1e-6, fp32
    output."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


def _dense(layer: nn.Linear, x: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: input, kernel and bias (if the
    layer has one) cast to the compute dtype."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class Block(nn.Module):
    def __init__(self, config: GPT2Config, attn_fn: Optional[Callable] = None,
                 moe_fn: Optional[Callable] = None):
        super().__init__()
        c = config
        self.config = c
        self.attn_fn = attn_fn
        self.moe_fn = moe_fn or moe_apply
        d, f = c.hidden_size, c.mlp_ratio * c.hidden_size
        self.ln_1 = LayerNorm(d)
        self.attn_qkv = nn.Linear(d, 3 * d)
        self.attn_proj = nn.Linear(d, d)
        self.ln_2 = LayerNorm(d)
        if c.moe is None:
            self.mlp_fc = nn.Linear(d, f)
            self.mlp_proj = nn.Linear(f, d)
        else:
            e = c.moe.num_experts
            self.moe_router = nn.Parameter(torch.zeros(d, e))
            self.moe_w_in = nn.Parameter(torch.zeros(e, d, f))
            self.moe_w_out = nn.Parameter(torch.zeros(e, f, d))

    def forward(self, x: torch.Tensor, kv=None):
        """``kv = (k_cache, v_cache, lengths)`` switches the block to the
        incremental-decode path: attention runs against the cached prefix
        and the block also returns this step's (k, v) projections, which
        the caller writes into its page pool."""
        c = self.config
        h = self.ln_1(x)
        qkv = _dense(self.attn_qkv, h, c.dtype)
        q, k, v = qkv.split(c.hidden_size, dim=-1)
        b, l, _ = q.shape
        q = q.reshape(b, l, c.num_heads, c.head_dim)
        k = k.reshape(b, l, c.num_heads, c.head_dim)
        v = v.reshape(b, l, c.num_heads, c.head_dim)
        if kv is not None:
            k_cache, v_cache, lengths = kv
            attn = cached_attention(q, k, v, k_cache, v_cache, lengths)
        elif self.attn_fn is not None:
            attn = self.attn_fn(q, k, v)
        else:
            attn = mha_attention(q, k, v, causal=True)
        attn = attn.reshape(b, l, c.hidden_size)
        x = x + _dense(self.attn_proj, attn, c.dtype)
        h = self.ln_2(x)
        if c.moe is None:
            h = gelu(_dense(self.mlp_fc, h, c.dtype))
            x = x + _dense(self.mlp_proj, h, c.dtype)
        else:
            out = self.moe_fn(h.reshape(b * l, -1), self.moe_router,
                              self.moe_w_in, self.moe_w_out, c.moe)
            x = x + out.reshape(b, l, -1).to(c.dtype)
        if kv is not None:
            return x, (k, v)
        return x


class GPT2(nn.Module):
    """GPT-2 language model with fp32 parameters.  ``wte`` [V, d] and
    ``wpe`` [P, d] are plain parameters (the head is tied to ``wte``).
    ``attn_fn`` and ``moe_fn`` go to every block.

    At ``num_layers >= config.scan_layers_threshold`` (24 by default:
    GPT-2 medium and deeper) the full-context forward runs each block
    under ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the
    block's activations are dropped after the forward and recomputed in
    the backward, the JAX package's ``nn.remat(Block)`` under its layer
    scan.  The layers stay a ``ModuleList`` (``h.{i}``); a JAX tree of
    that depth stacks them as ``h_scan``, which
    ``convert.gpt2_params_from_jax`` unstacks.  The recompute runs each
    block's attention forward twice a step.  Incremental decode at that
    depth raises, as in the JAX package."""

    def __init__(self, config: GPT2Config, attn_fn: Optional[Callable] = None,
                 moe_fn: Optional[Callable] = None):
        super().__init__()
        c = config
        self.config = c
        self.wte = nn.Parameter(torch.zeros(c.vocab_size, c.hidden_size))
        self.wpe = nn.Parameter(torch.zeros(c.max_position_embeddings,
                                            c.hidden_size))
        self.h = nn.ModuleList(Block(c, attn_fn, moe_fn)
                               for _ in range(c.num_layers))
        self.ln_f = LayerNorm(c.hidden_size)

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                kv_caches: Optional[Sequence[Tuple[torch.Tensor,
                                                   torch.Tensor]]] = None,
                kv_lengths: Optional[torch.Tensor] = None,
                return_hidden: bool = False):
        """Full context: input_ids [B, L] -> logits [B, L, vocab] fp32;
        with ``return_hidden`` also the post-``ln_f`` hidden state
        [B, L, hidden] fp32 (the value head's input in
        ``GPT2WithValue``).  ``positions`` [B, L], when given, index
        ``wpe`` (a ``sequence`` rank's shard starts past 0).

        Incremental decode (``kv_caches`` given): ``positions`` [B, L] are
        the absolute positions of the new tokens (they index ``wpe``),
        ``kv_caches`` is a per-layer list of (k, v), each [B, S, H, D], of
        which the first ``kv_lengths[b]`` rows are valid; returns (logits,
        new_kvs), new_kvs being the per-layer (k, v) of this call
        [B, L, H, D] for the caller to append to its cache."""
        c = self.config
        l = input_ids.shape[1]
        pos = self.wpe[None, :l] if positions is None else \
            self.wpe[positions]
        x = self.wte[input_ids].to(c.dtype) + pos.to(c.dtype)
        decode = kv_caches is not None
        remat = c.num_layers >= c.scan_layers_threshold
        if decode and remat:
            raise NotImplementedError(
                "incremental decode is unrolled-layers only; lower "
                "scan_layers_threshold applies to training compiles")
        if decode and return_hidden:
            raise NotImplementedError(
                "return_hidden is a full-context (training) path")
        new_kvs: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for i, block in enumerate(self.h):
            if decode:
                x, nkv = block(x, kv=(kv_caches[i][0], kv_caches[i][1],
                                      kv_lengths))
                new_kvs.append(nkv)
            elif remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        x = self.ln_f(x)
        logits = torch.einsum("bld,vd->blv", x.to(c.dtype),
                              self.wte.to(c.dtype)).float()
        if decode:
            return logits, new_kvs
        if return_hidden:
            return logits, x
        return logits


class GPT2WithValue(nn.Module):
    """GPT-2 plus a scalar value head: the RLHF actor-critic
    (``ray_tpu/models/gpt2.py:219``).

    The policy is a plain :class:`GPT2` named ``lm``, so
    ``state_dict()`` entries under ``lm.`` are exactly what a serving
    engine of the same config takes in ``swap_weights``.  The value head
    is one fp32 linear over the post-``ln_f`` hidden state, its weight
    drawn from ``normal(0.01)`` on ``generator`` (a CPU generator; seeded
    0 when none is given) and its bias zero, so early value estimates do
    not swamp the policy gradient.  The ``lm`` starts at zeros: load
    weights with :meth:`init_from_lm` (or ``load_state_dict``).

    ``forward(input_ids) -> (logits [B, L, V] fp32, values [B, L] fp32)``;
    ``values[:, t]`` estimates the return from the state after token t."""

    def __init__(self, config: GPT2Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.lm = GPT2(config)
        self.value_head = nn.Linear(config.hidden_size, 1)
        self._init_value_head(generator)

    @torch.no_grad()
    def _init_value_head(self, generator: Optional[torch.Generator] = None):
        gen = generator or torch.Generator().manual_seed(0)
        w = torch.empty(self.value_head.weight.shape)
        w.normal_(0.0, 0.01, generator=gen)
        self.value_head.weight.copy_(w)
        self.value_head.bias.zero_()

    def forward(self, input_ids: torch.Tensor):
        logits, hidden = self.lm(input_ids, return_hidden=True)
        v = F.linear(hidden.float(), self.value_head.weight.float(),
                     self.value_head.bias.float())
        return logits, v[..., 0]

    def init_from_lm(self, lm_state, generator: Optional[torch.Generator]
                     = None) -> "GPT2WithValue":
        """Load ``lm_state`` (a ``GPT2`` state dict, e.g. the weights a
        serving engine already holds) into ``lm`` and draw a fresh value
        head from ``generator``; returns the module."""
        self.lm.load_state_dict(lm_state, strict=True)
        self._init_value_head(generator)
        return self


def gpt2_loss_fn(model: GPT2, batch) -> torch.Tensor:
    """Next-token cross-entropy (``ray_tpu.models.gpt2.gpt2_loss_fn``):
    batch ``{"input_ids": [B, L]}``, labels the shifted inputs; the mean
    over the B*(L-1) positions of -log_softmax of the fp32 logits.  The
    ids may be any integer dtype (the JAX bench feeds int32 tokens);
    ``cross_entropy`` takes its targets as int64."""
    ids = batch["input_ids"]
    logits = model(ids)[:, :-1]
    return F.cross_entropy(logits.flatten(0, 1),
                           ids[:, 1:].flatten().long())


# ---------------------------------------------------------------------------
# pipeline stages (``ray_tpu/models/gpt2.py:270-405``)
# ---------------------------------------------------------------------------
def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax's lecun_normal for a torch Linear weight [out, in]: a normal
    truncated at 2 std, of variance 1/fan_in."""
    std = (1.0 / w.shape[1]) ** 0.5 / 0.87962566103423978
    torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                generator=gen)


class GPT2Stage(nn.Module):
    """One pipeline chunk of a split GPT-2 (see :func:`split_stages`).

    The first chunk owns ``wte``/``wpe`` and takes token ids; middle
    chunks take and give hidden states; the last owns ``ln_f`` and the LM
    head ``lm_head`` [V, d] and gives fp32 logits.  The head is untied from
    ``wte``: a split puts them in different processes.  The blocks keep
    their global index: ``h.{i}`` for ``i`` in ``range(*blocks)``, the
    names of ``GPT2``'s state dict."""

    def __init__(self, config: GPT2Config, first: bool, last: bool,
                 blocks: Tuple[int, int]):
        super().__init__()
        c = config
        self.config, self.first, self.last = c, first, last
        self.blocks = tuple(blocks)
        if first:
            self.wte = nn.Parameter(torch.zeros(c.vocab_size, c.hidden_size))
            self.wpe = nn.Parameter(torch.zeros(c.max_position_embeddings,
                                                c.hidden_size))
        self.h = nn.ModuleDict({str(i): Block(c)
                                for i in range(*self.blocks)})
        if last:
            self.ln_f = LayerNorm(c.hidden_size)
            self.lm_head = nn.Parameter(torch.zeros(c.vocab_size,
                                                    c.hidden_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.config
        if self.first:
            l = x.shape[1]
            x = self.wte[x].to(c.dtype) + self.wpe[None, :l].to(c.dtype)
        else:
            x = x.to(c.dtype)
        for block in self.h.values():
            x = block(x)
        if self.last:
            x = self.ln_f(x)
            return torch.einsum("bld,vd->blv", x.to(c.dtype),
                                self.lm_head.to(c.dtype)).float()
        return x

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """flax's initializers, drawn from ``generator`` in the order of
        ``named_parameters``: normal(0.02) for ``wte`` and ``lm_head``,
        normal(0.01) for ``wpe``, lecun-normal Dense kernels, zero biases,
        LayerNorm scale one and bias zero."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name in ("wte", "lm_head"):
                p.normal_(0.0, 0.02, generator=generator)
            elif name == "wpe":
                p.normal_(0.0, 0.01, generator=generator)
            elif ".ln_" in name or name.startswith("ln_f"):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "weight":
                _lecun_normal_(p, generator)
            else:
                p.zero_()


def _stage_ce_loss(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Next-token CE on a microbatch (the objective of ``gpt2_loss_fn``)."""
    return F.cross_entropy(logits[:, :-1].flatten(0, 1),
                           ids[:, 1:].flatten().long())


def gpt2_head_cost(config: GPT2Config) -> float:
    """LM-head cost in block-equivalents: a GPT-2 block is ~12*h^2
    params/FLOP-units, the head matmul vocab*h."""
    return config.vocab_size / (12.0 * config.hidden_size)


class StageFn:
    """``fn(params, x[, target])`` of one pipeline chunk: ``params`` a
    dict of tensors named as the chunk module's state dict, run through
    ``torch.func.functional_call``.  The module is made on the meta
    device at first call, in the process that calls (a stage actor), so
    the function pickles as its config and carries no weights.  The last
    chunk returns the scalar CE loss against ``target``; the others their
    output cast to ``boundary_dtype``."""

    def __init__(self, module_cls, config, first: bool, last: bool,
                 blocks: Tuple[int, int], boundary_dtype: torch.dtype,
                 loss_fn: Callable):
        self.module_cls, self.config = module_cls, config
        self.first, self.last, self.blocks = first, last, tuple(blocks)
        self.boundary_dtype, self.loss_fn = boundary_dtype, loss_fn
        self._module = None

    def __getstate__(self):
        return dict(self.__dict__, _module=None)

    def module(self) -> nn.Module:
        if self._module is None:
            with torch.device("meta"):
                self._module = self.module_cls(self.config, self.first,
                                               self.last, self.blocks)
        return self._module

    def __call__(self, params, x, target=None):
        out = torch.func.functional_call(self.module(), params, (x,))
        if self.last:
            return self.loss_fn(out, target)
        return out.to(self.boundary_dtype)


class StageInit:
    """``init()`` of one pipeline chunk: the chunk's parameters as a dict
    of fp32 CPU tensors, drawn where it is called from a
    ``torch.Generator`` seeded ``seed`` (the chunk's ``seed + c``)."""

    def __init__(self, module_cls, config, first: bool, last: bool,
                 blocks: Tuple[int, int], seed: int):
        self.module_cls, self.config = module_cls, config
        self.first, self.last, self.blocks = first, last, tuple(blocks)
        self.seed = int(seed)

    def __call__(self):
        module = self.module_cls(self.config, self.first, self.last,
                                 self.blocks)
        module.init_params(torch.Generator().manual_seed(self.seed))
        return {k: v.detach() for k, v in module.state_dict().items()}


def split_module(module_cls, config, num_layers: int, head_cost: float,
                 num_stages: int, virtual_per_rank: int,
                 boundary_dtype: torch.dtype, seed: int, loss_fn: Callable):
    """The ``split_stages`` of either LM family: ``num_stages *
    virtual_per_rank`` chunks balanced by cost, as ``(stage_fns,
    init_fns)`` in global chunk order."""
    from ray_tpu_torch.models.pipeline_split import (balance_chunks,
                                                     chunk_flags)

    if num_stages < 1:
        raise ValueError(f"num_stages must be >= 1, got {num_stages}")
    n = num_stages * max(1, int(virtual_per_rank))
    bounds = balance_chunks(num_layers, n, embed_cost=0.3,
                            head_cost=head_cost)
    stage_fns, init_fns = [], []
    for k, (first, last) in enumerate(chunk_flags(n)):
        stage_fns.append(StageFn(module_cls, config, first, last, bounds[k],
                                 boundary_dtype, loss_fn))
        init_fns.append(StageInit(module_cls, config, first, last,
                                  bounds[k], seed + k))
    return stage_fns, init_fns


def split_stages(config: GPT2Config, num_stages: int, *,
                 virtual_per_rank: int = 1,
                 boundary_dtype: torch.dtype = torch.float32, seed: int = 0):
    """Split a GPT-2 config into ``num_stages * virtual_per_rank``
    pipeline chunks for
    :class:`ray_tpu_torch.parallel.mpmd_pipeline.MPMDPipeline`.

    Blocks are partitioned by cost (``models/pipeline_split.py``): the
    LM head costs ``vocab/(12*hidden)`` block-equivalents, so the
    head-owning chunk gets fewer blocks.  With ``virtual_per_rank=v`` the
    chunks interleave over the stages (chunk c on stage ``c % S``).
    Returns ``(stage_fns, init_fns)`` in global chunk order:
    ``stage_fns[c](params, x[, target])`` (a :class:`StageFn`; the last
    returns the scalar loss) and ``init_fns[c]()`` (a :class:`StageInit`)
    building that chunk's parameters where it is called: run them on the
    stage actors, so that an XL-scale chunk never visits the driver.
    Activations cross chunk boundaries as ``boundary_dtype`` (fp32 by
    default)."""
    return split_module(GPT2Stage, config, config.num_layers,
                        gpt2_head_cost(config), num_stages,
                        virtual_per_rank, boundary_dtype, seed,
                        _stage_ce_loss)
