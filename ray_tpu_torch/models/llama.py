"""Llama-family decoder in PyTorch (counterpart of
``ray_tpu/models/llama.py``): RMSNorm, rotary positions, grouped-query
attention, a SwiGLU MLP, no biases, an LM head untied from the embedding.

The numerics follow the flax model so that converted weights give the
same logits:

- ``RMSNorm`` takes the variance in fp32, then multiplies x by the rsqrt
  cast to x's dtype, then by the scale cast to x's dtype (the norm is not
  computed in fp32 throughout);
- rope is rotate-half: the last dim splits into two halves (not
  interleaved even/odd pairs), with cos and sin cast to x's dtype;
- Dense layers compute in the compute dtype (``config.dtype``, bf16 by
  default) over fp32 parameters, and the embedding and the residual
  stream are in the compute dtype;
- grouped-query attention repeats each K/V head for its ``rep`` query
  heads with ``repeat_interleave`` (query head i reads K/V head
  i // rep, as ``jnp.repeat`` on the head axis) before ``mha_attention``;
  the decode path keeps K/V at ``num_kv_heads`` and ``cached_attention``
  expands them after the concatenation;
- the LM head runs in fp32 on the fp32 cast of the final norm's output,
  and the logits are fp32.

``LlamaStage``, ``_stage_ce_loss`` and ``split_stages`` (the pipeline
split of the JAX module) wait for the pipeline (ROADMAP Queue 1 item 8);
``split_stages`` raises, naming it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ray_tpu_torch.models.gpt2 import _dense, gpt2_loss_fn
from ray_tpu_torch.ops.attention import cached_attention, mha_attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_position_embeddings: int = 2048
    num_layers: int = 8
    num_heads: int = 8
    num_kv_heads: int = 4          # < num_heads: grouped-query attention
    hidden_size: int = 512
    intermediate_size: Optional[int] = None  # default ~8/3 * hidden
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # None: mha_attention's dispatch by device and length; True: always
    # flash_attention; False: always the plain path.
    use_flash: Optional[bool] = None

    @classmethod
    def tiny(cls, **kw):  # test-sized
        kw.setdefault("vocab_size", 256)
        kw.setdefault("max_position_embeddings", 64)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("num_kv_heads", 2)
        kw.setdefault("hidden_size", 64)
        return cls(**kw)

    @classmethod
    def llama_1b(cls, **kw):
        """~1.1B-parameter GQA config, the TinyLlama-1.1B shape: 22
        layers, width 2048, 32 query heads over 4 K/V heads, SwiGLU
        5632, vocab 32000, context 2048."""
        kw.setdefault("vocab_size", 32000)
        kw.setdefault("max_position_embeddings", 2048)
        kw.setdefault("num_layers", 22)
        kw.setdefault("num_heads", 32)
        kw.setdefault("num_kv_heads", 4)
        kw.setdefault("hidden_size", 2048)
        kw.setdefault("intermediate_size", 5632)
        return cls(**kw)

    @classmethod
    def draft_of(cls, target: "LlamaConfig", num_layers: int = 1,
                 num_heads: Optional[int] = None,
                 num_kv_heads: Optional[int] = None,
                 hidden_size: Optional[int] = None, **kw):
        """A speculative-decoding draft config for ``target``: the same
        vocab, context length and dtype (what the engine requires), the
        rest shrunk; by default one layer at half width, the GQA ratio
        kept."""
        heads = num_heads or max(1, target.num_heads // 2)
        kvh = num_kv_heads or max(
            1, heads * target.num_kv_heads // target.num_heads)
        heads -= heads % kvh  # query heads must group evenly over K/V heads
        hidden = hidden_size or max(heads * 8, target.hidden_size // 2)
        hidden -= hidden % heads
        return cls(vocab_size=target.vocab_size,
                   max_position_embeddings=target.max_position_embeddings,
                   num_layers=num_layers, num_heads=heads,
                   num_kv_heads=kvh, hidden_size=hidden,
                   rope_theta=target.rope_theta, dtype=target.dtype, **kw)

    @property
    def block_params(self) -> int:
        """Parameters of one decoder block: q and o at h^2, k and v at
        h^2 * kv/heads, three SwiGLU matrices at h*mlp, two RMSNorm
        scales."""
        h, m = self.hidden_size, self.mlp_dim
        kv = self.num_kv_heads / self.num_heads
        return int(h * h * (2 + 2 * kv) + 3 * h * m + 2 * h)

    @property
    def n_params(self) -> int:
        """Total parameter count (embedding, blocks, final norm, head)."""
        h = self.hidden_size
        return int(2 * self.vocab_size * h + h
                   + self.num_layers * self.block_params)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_dim(self) -> int:
        if self.intermediate_size is not None:
            return self.intermediate_size
        # The 2/3 * 4h SwiGLU sizing, rounded up to a multiple of 32.
        raw = int(self.hidden_size * 8 / 3)
        return ((raw + 31) // 32) * 32


class RMSNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().square().mean(-1, keepdim=True)
        norm = x * torch.rsqrt(var + self.eps).to(x.dtype)
        return norm * self.weight.to(x.dtype)


def rope_tables(length: int, head_dim: int, theta: float,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos and sin tables [length, head_dim / 2]."""
    freqs = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    angles = torch.arange(length, dtype=torch.float32,
                          device=device)[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half rope on x [B, L, H, D]: the halves (x1, x2) of the last
    dim become (x1 cos - x2 sin, x2 cos + x1 sin).  cos and sin are
    [L, D/2] (positions from zero, the full-context path) or [B, L, D/2]
    (each token's absolute position, the decode path)."""
    x1, x2 = x.chunk(2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        c = config
        self.config = c
        hd = c.head_dim
        self.q_proj = nn.Linear(c.hidden_size, c.num_heads * hd, bias=False)
        self.k_proj = nn.Linear(c.hidden_size, c.num_kv_heads * hd,
                                bias=False)
        self.v_proj = nn.Linear(c.hidden_size, c.num_kv_heads * hd,
                                bias=False)
        self.o_proj = nn.Linear(c.num_heads * hd, c.hidden_size, bias=False)

    def forward(self, x: torch.Tensor, rope, kv=None):
        """``rope`` = (cos, sin) for these tokens, as ``apply_rope`` takes
        them.  ``kv = (k_cache, v_cache, lengths)`` switches to the
        incremental-decode path, which also returns this step's post-rope
        (k, v) at ``num_kv_heads`` for the caller's pages."""
        c = self.config
        b, l, _ = x.shape
        hd = c.head_dim
        q = _dense(self.q_proj, x, c.dtype).reshape(b, l, c.num_heads, hd)
        k = _dense(self.k_proj, x, c.dtype).reshape(b, l, c.num_kv_heads, hd)
        v = _dense(self.v_proj, x, c.dtype).reshape(b, l, c.num_kv_heads, hd)
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
        if kv is not None:
            k_cache, v_cache, lengths = kv
            out = cached_attention(q, k, v, k_cache, v_cache, lengths)
        else:
            kf, vf = k, v
            if c.num_kv_heads != c.num_heads:
                rep = c.num_heads // c.num_kv_heads
                kf = k.repeat_interleave(rep, dim=2)
                vf = v.repeat_interleave(rep, dim=2)
            out = mha_attention(q, kf, vf, causal=True,
                                use_flash=c.use_flash)
        out = _dense(self.o_proj, out.reshape(b, l, c.num_heads * hd),
                     c.dtype)
        return (out, (k, v)) if kv is not None else out


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        c = config
        self.config = c
        self.gate_proj = nn.Linear(c.hidden_size, c.mlp_dim, bias=False)
        self.up_proj = nn.Linear(c.hidden_size, c.mlp_dim, bias=False)
        self.down_proj = nn.Linear(c.mlp_dim, c.hidden_size, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.config.dtype
        gate = _dense(self.gate_proj, x, dt)
        # jax.nn.silu's rounding points: sigmoid rounded to the compute
        # dtype, then the product (F.silu rounds only once).
        h = gate * torch.sigmoid(gate) * _dense(self.up_proj, x, dt)
        return _dense(self.down_proj, h, dt)


class LlamaBlock(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        c = config
        self.attn_norm = RMSNorm(c.hidden_size, c.rms_eps)
        self.attn = LlamaAttention(c)
        self.mlp_norm = RMSNorm(c.hidden_size, c.rms_eps)
        self.mlp = LlamaMLP(c)

    def forward(self, x: torch.Tensor, rope, kv=None):
        new_kv = None
        if kv is not None:
            attn, new_kv = self.attn(self.attn_norm(x), rope, kv)
        else:
            attn = self.attn(self.attn_norm(x), rope)
        x = x + attn
        x = x + self.mlp(self.mlp_norm(x))
        return (x, new_kv) if kv is not None else x


class Llama(nn.Module):
    """Llama language model with fp32 parameters: ``embed`` [V, h], the
    blocks ``layers.{i}``, ``final_norm`` and the untied ``lm_head``."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        c = config
        self.config = c
        self.embed = nn.Parameter(torch.zeros(c.vocab_size, c.hidden_size))
        self.layers = nn.ModuleList(LlamaBlock(c)
                                    for _ in range(c.num_layers))
        self.final_norm = RMSNorm(c.hidden_size, c.rms_eps)
        self.lm_head = nn.Linear(c.hidden_size, c.vocab_size, bias=False)

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                kv_caches: Optional[Sequence[Tuple[torch.Tensor,
                                                   torch.Tensor]]] = None,
                kv_lengths: Optional[torch.Tensor] = None):
        """Full context: input_ids [B, L] -> logits [B, L, vocab] fp32.

        Incremental decode (``kv_caches`` given), the contract of
        ``GPT2.forward``: ``positions`` [B, L] are the new tokens'
        absolute positions (rope is taken there, from tables of
        ``max_position_embeddings``), ``kv_caches`` a per-layer list of
        (k, v) [B, S, num_kv_heads, D] of which the first
        ``kv_lengths[b]`` rows are valid; returns (logits, new_kvs), the
        per-layer post-rope (k, v) [B, L, num_kv_heads, D] of this call.
        The rope tables are computed once a call, for every layer."""
        c = self.config
        x = self.embed[input_ids].to(c.dtype)
        decode = kv_caches is not None
        if decode:
            cos, sin = rope_tables(c.max_position_embeddings, c.head_dim,
                                   c.rope_theta, x.device)
            rope = (cos[positions], sin[positions])
        else:
            rope = rope_tables(input_ids.shape[1], c.head_dim, c.rope_theta,
                               x.device)
        new_kvs: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for i, block in enumerate(self.layers):
            if decode:
                x, nkv = block(x, rope, (kv_caches[i][0], kv_caches[i][1],
                                         kv_lengths))
                new_kvs.append(nkv)
            else:
                x = block(x, rope)
        x = self.final_norm(x)
        logits = F.linear(x.float(), self.lm_head.weight)
        if decode:
            return logits, new_kvs
        return logits


def llama_loss_fn(model: Llama, batch) -> torch.Tensor:
    """Next-token cross-entropy (``ray_tpu.models.llama.llama_loss_fn``):
    the objective of ``gpt2_loss_fn``, the mean over the B*(L-1)
    positions of -log_softmax of the fp32 logits."""
    return gpt2_loss_fn(model, batch)


def llama_head_cost(config: LlamaConfig) -> float:
    """The LM head's cost in block-equivalents: ``vocab*h`` over a block's
    ``h^2*(2 + 2*kv/heads) + 3*h*mlp`` (and its two norm scales), the
    pipeline split's cost model."""
    return (config.vocab_size * config.hidden_size) / config.block_params


def split_stages(config: LlamaConfig, num_stages: int, **kw):
    """The pipeline split of a Llama (``LlamaStage`` chunks for the MPMD
    pipeline) is not ported yet: it needs the pipeline, ROADMAP Queue 1
    item 8."""
    raise NotImplementedError(
        "split_stages (LlamaStage chunks for the MPMD pipeline) needs the "
        "pipeline, not ported yet (ROADMAP Queue 1 item 8)")
