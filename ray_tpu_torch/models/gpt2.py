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
forward, and ``cached_attention`` for the incremental-decode path.
``gpt2_loss_fn`` is the training objective.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ray_tpu_torch.ops.attention import cached_attention, mha_attention
from ray_tpu_torch.ops.layers import gelu


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    max_position_embeddings: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    hidden_size: int = 768
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def gpt2_small(cls, **kw):  # 125M
        return cls(**kw)

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
    def __init__(self, config: GPT2Config):
        super().__init__()
        c = config
        self.config = c
        d = c.hidden_size
        self.ln_1 = LayerNorm(d)
        self.attn_qkv = nn.Linear(d, 3 * d)
        self.attn_proj = nn.Linear(d, d)
        self.ln_2 = LayerNorm(d)
        self.mlp_fc = nn.Linear(d, c.mlp_ratio * d)
        self.mlp_proj = nn.Linear(c.mlp_ratio * d, d)

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
        else:
            attn = mha_attention(q, k, v, causal=True)
        attn = attn.reshape(b, l, c.hidden_size)
        x = x + _dense(self.attn_proj, attn, c.dtype)
        h = self.ln_2(x)
        h = gelu(_dense(self.mlp_fc, h, c.dtype))
        x = x + _dense(self.mlp_proj, h, c.dtype)
        if kv is not None:
            return x, (k, v)
        return x


class GPT2(nn.Module):
    """GPT-2 language model with fp32 parameters.  ``wte`` [V, d] and
    ``wpe`` [P, d] are plain parameters (the head is tied to ``wte``)."""

    def __init__(self, config: GPT2Config):
        super().__init__()
        c = config
        self.config = c
        self.wte = nn.Parameter(torch.zeros(c.vocab_size, c.hidden_size))
        self.wpe = nn.Parameter(torch.zeros(c.max_position_embeddings,
                                            c.hidden_size))
        self.h = nn.ModuleList(Block(c) for _ in range(c.num_layers))
        self.ln_f = LayerNorm(c.hidden_size)

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                kv_caches: Optional[Sequence[Tuple[torch.Tensor,
                                                   torch.Tensor]]] = None,
                kv_lengths: Optional[torch.Tensor] = None):
        """Full context: input_ids [B, L] -> logits [B, L, vocab] fp32.

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
        new_kvs: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for i, block in enumerate(self.h):
            if decode:
                x, nkv = block(x, kv=(kv_caches[i][0], kv_caches[i][1],
                                      kv_lengths))
                new_kvs.append(nkv)
            else:
                x = block(x)
        x = self.ln_f(x)
        logits = torch.einsum("bld,vd->blv", x.to(c.dtype),
                              self.wte.to(c.dtype)).float()
        if decode:
            return logits, new_kvs
        return logits


def gpt2_loss_fn(model: GPT2, batch) -> torch.Tensor:
    """Next-token cross-entropy (``ray_tpu.models.gpt2.gpt2_loss_fn``):
    batch ``{"input_ids": [B, L]}``, labels the shifted inputs; the mean
    over the B*(L-1) positions of -log_softmax of the fp32 logits."""
    ids = batch["input_ids"]
    logits = model(ids)[:, :-1]
    return F.cross_entropy(logits.flatten(0, 1), ids[:, 1:].flatten())
