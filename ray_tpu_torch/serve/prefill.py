"""Disaggregated prefill, in-process (counterpart of
``ray_tpu/serve/prefill.py``): a prefill worker computes a prompt's KV
pages and the decode engine adopts them at a later token boundary, so a
long prompt does not stall the decode batch while it is prefilled.

Copied from the JAX package, which the port may not import:

- ``pack_pages``/``unpack_pages``, the KV page wire: ``native`` ships
  fp32 numpy (exact for fp32 and bf16 caches, so adopted pages are the
  bits a local prefill writes), ``int8`` block-scales the head_dim axis
  with ``quantize_block_int8_np``/``dequantize_block_int8_np``, copied
  from ``ray_tpu/ops/collectives.py`` (same padding, round-half-to-even
  and fp32 scales, so the bytes are equal);
- ``PrefillWorker``, which runs a bucketed full prefill on its own copy
  of the model (on ``device``: CUDA unless ``device="cpu"``) and returns
  the pages of the uncached tail with the sampled next token;
- ``_PrefillJob`` and ``PrefillClient`` with the ``"local"`` kind (the
  worker's ``prefill`` runs on one background thread) and the
  ``"actor"`` kind (a ``PrefillWorker`` actor of ``ray_tpu_torch``'s
  runtime); the engine polls the job between decode steps;
- the object plane: with ``use_object_plane`` (by default, when the
  process drives a runtime it started) the page arrays ride
  ``put_many`` and the payload carries their refs, which the client
  resolves with ``get_many``.

Not ported: prefill through a Serve deployment (kind ``"deployment"``),
which needs the Serve control plane (ROADMAP Queue 1 item 9); it raises,
naming it.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.serve.sampling import SamplingParams

_SERVE = ("needs the Serve control plane, not ported yet (ROADMAP Queue 1 "
          "item 9)")


def _plane_up() -> bool:
    """Whether this process drives a runtime it started (the default of
    ``use_object_plane``; an actor's worker does not)."""
    import ray_tpu_torch

    return ray_tpu_torch.is_initialized()

# ---------------------------------------------------------------------------
# Block-int8 quantization, numpy (copy of ray_tpu/ops/collectives.py's
# quantize_block_int8_np / dequantize_block_int8_np)
# ---------------------------------------------------------------------------
DEFAULT_BLOCK = 256
_EPS = 1e-12


def quantize_block_int8_np(x, block: int = DEFAULT_BLOCK):
    """Per-block symmetric int8: ``(q int8, scales fp32)`` with the
    trailing axis padded up to a block multiple."""
    x = np.asarray(x, np.float32)
    pad = (-x.shape[-1]) % block
    if pad:
        x = np.concatenate(
            [x, np.zeros(x.shape[:-1] + (pad,), np.float32)], axis=-1)
    blocks = x.reshape(x.shape[:-1] + (-1, block))
    absmax = np.max(np.abs(blocks), axis=-1)
    scales = (absmax / 127.0).astype(np.float32)
    v = blocks / (scales[..., None] + _EPS)
    q = np.clip(np.round(v), -127, 127).astype(np.int8)
    return q.reshape(x.shape[:-1] + (-1,)), scales


def dequantize_block_int8_np(q, scales, n: int, dtype=None):
    """Inverse of :func:`quantize_block_int8_np`, cut back to ``n``."""
    q = np.asarray(q)
    scales = np.asarray(scales, np.float32)
    block = q.shape[-1] // scales.shape[-1]
    blocks = q.reshape(q.shape[:-1] + (scales.shape[-1], block))
    out = blocks.astype(np.float32) * scales[..., None]
    out = out.reshape(q.shape[:-1] + (-1,))[..., :n]
    return out.astype(dtype) if dtype is not None else out


# ---------------------------------------------------------------------------
# KV page wire format
# ---------------------------------------------------------------------------
def pack_pages(k: np.ndarray, v: np.ndarray,
               wire_dtype: str = "native") -> Dict[str, Any]:
    """Pack [L, n_pages, ps, Hkv, D] K/V page arrays for the wire:
    ``native`` fp32 (exact), or ``int8`` block-scaled over head_dim
    (~3.5-4x smaller; approximate, so the engine does not publish such
    pages into the exact prefix cache)."""
    k = np.asarray(k, np.float32)
    v = np.asarray(v, np.float32)
    fp32_bytes = int(k.nbytes + v.nbytes)
    if wire_dtype == "native":
        payload = {"fmt": "native", "k": k, "v": v}
    elif wire_dtype == "int8":
        block = k.shape[-1]
        kq, ks = quantize_block_int8_np(k, block)
        vq, vs = quantize_block_int8_np(v, block)
        payload = {"fmt": "int8", "kq": kq, "ks": ks, "vq": vq, "vs": vs,
                   "block": block, "n": k.shape[-1]}
    else:
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}")
    wire = sum(int(a.nbytes) for a in payload.values()
               if isinstance(a, np.ndarray))
    payload["wire_bytes"] = wire
    payload["fp32_bytes"] = fp32_bytes
    return payload


_WIRE_ARRAYS = {"native": ("k", "v"), "int8": ("kq", "ks", "vq", "vs")}


def unpack_pages(payload: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
    if payload["fmt"] == "native":
        return payload["k"], payload["v"]
    n = int(payload["n"])
    k = dequantize_block_int8_np(payload["kq"], payload["ks"], n)
    v = dequantize_block_int8_np(payload["vq"], payload["vs"], n)
    return k, v


class PrefillWorker:
    """Stateless bucketed-prefill worker, in-process.

    It builds its own model with ``build_model(model_kind, config_kw,
    seed)`` (so it holds the weights of an engine built from the same
    arguments) on ``device``, runs the engine's full prefill at the
    prompt's power-of-two bucket, and returns the per-position KV chopped
    into pages on the host, with the next token sampled by the request's
    seeded sampler.  It runs in-process or as an actor
    (``ray_tpu_torch.remote(num_gpus=1)(PrefillWorker).remote(...)``)."""

    def __init__(self, model_kind: str = "gpt2",
                 config_kw: Optional[dict] = None, seed: int = 0,
                 page_size: int = 16, max_ctx: Optional[int] = None,
                 wire_dtype: str = "native",
                 use_object_plane: Optional[bool] = None, device=None):
        from ray_tpu_torch.serve.llm_engine import build_model

        self.device = resolve_device(device)
        self._model = build_model(model_kind, config_kw, seed, self.device)
        c = self._model.config
        self.page_size = int(page_size)
        self.max_ctx = int(max_ctx or c.max_position_embeddings)
        self.wire_dtype = wire_dtype
        self._use_plane = use_object_plane
        self.num_layers = c.num_layers
        self.kv_heads = getattr(c, "num_kv_heads", c.num_heads)
        self.head_dim = c.head_dim
        self._buckets = set()
        self._stats = {"requests": 0, "tokens": 0, "wire_bytes": 0,
                       "fp32_bytes": 0, "seconds": 0.0}

    def _bucket_for(self, p: int) -> int:
        b = 8
        while b < p:
            b <<= 1
        return min(b, self.max_ctx)

    def prefill(self, tokens, start: int = 0, temperature: float = 0.0,
                top_p: float = 1.0, seed: int = 0) -> Dict[str, Any]:
        """KV for ``tokens``; returns the pages covering positions
        ``[start, len(tokens))`` (``start`` is the engine's cached-prefix
        length, page-aligned: attention needs the whole prompt, the wire
        only the uncached tail) and the sampled next token.  With the
        object plane the page arrays ride ``put_many`` and the payload
        carries their refs."""
        from ray_tpu_torch.serve.llm_engine import _full_forward, _sample_one

        t0 = time.perf_counter()
        tokens = [int(t) for t in np.asarray(tokens).reshape(-1)]
        p = len(tokens)
        if not p:
            raise ValueError("empty prompt")
        if start % self.page_size:
            raise ValueError(f"start {start} is not page-aligned "
                             f"(page_size {self.page_size})")
        bucket = self._bucket_for(p)
        self._buckets.add(bucket)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            logits, newk, newv = _full_forward(self._model, tokens, bucket,
                                               self.device)
            nxt, nxt_logp = _sample_one(
                logits[p - 1], p, SamplingParams(temperature, top_p, seed))
            ps = self.page_size
            n0, n1 = start // ps, math.ceil(p / ps)
            shape = (self.num_layers, n1 * ps, self.kv_heads, self.head_dim)
            bk = torch.zeros(shape, dtype=torch.float32, device=self.device)
            bv = torch.zeros_like(bk)
            bk[:, :p] = newk[:, :p]
            bv[:, :p] = newv[:, :p]
            pages = (self.num_layers, n1, ps, self.kv_heads, self.head_dim)
            pk = bk.reshape(pages)[:, n0:].cpu().numpy()
            pv = bv.reshape(pages)[:, n0:].cpu().numpy()
        payload = pack_pages(pk, pv, self.wire_dtype)
        payload.update(next_token=nxt, next_logp=nxt_logp,
                       p=p, start=start)
        self._stats["requests"] += 1
        self._stats["tokens"] += p - start
        self._stats["wire_bytes"] += payload["wire_bytes"]
        self._stats["fp32_bytes"] += payload["fp32_bytes"]
        use_plane = self._use_plane if self._use_plane is not None \
            else _plane_up()
        if use_plane:
            import ray_tpu_torch

            names = _WIRE_ARRAYS[payload["fmt"]]
            payload["refs"] = ray_tpu_torch.put_many(
                [payload.pop(n) for n in names])
            payload["ref_names"] = list(names)
        # Host wall time of the call; it ends by reading the pages back
        # (and putting them, with the object plane).
        self._stats["seconds"] += time.perf_counter() - t0
        return payload

    def prefill_many(self, requests: List[dict]) -> List[Dict[str, Any]]:
        """Each request is the keyword arguments of :meth:`prefill`."""
        return [self.prefill(**r) for r in requests]

    def stats(self) -> Dict[str, Any]:
        out = dict(self._stats)
        out["buckets"] = len(self._buckets)
        return out

    def drain(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# Client side (lives inside the decode engine's loop)
# ---------------------------------------------------------------------------
class _PrefillJob:
    """One in-flight prefill.  ``poll()`` returns None while pending,
    else ``(k, v, next_token, meta)`` with [L, n_pages, ps, Hkv, D] fp32
    page arrays; raises the worker's error."""

    def __init__(self, future):
        self._future = future
        self._delivered = False

    def poll(self):
        if self._delivered or not self._future.done():
            return None
        payload = self._future.result()
        self._delivered = True
        return _resolve_payload(payload)


def _resolve_payload(payload: Dict[str, Any]):
    payload = dict(payload)
    refs = payload.pop("refs", None)
    if refs is not None:
        import ray_tpu_torch

        vals = ray_tpu_torch.get_many(list(refs))
        payload.update(zip(payload.pop("ref_names"), vals))
    k, v = unpack_pages(payload)
    meta = {"wire_bytes": payload["wire_bytes"],
            "fp32_bytes": payload["fp32_bytes"],
            "exact": payload["fmt"] == "native",
            "next_logp": payload.get("next_logp", float("nan"))}
    return k, v, payload["next_token"], meta


class PrefillClient:
    """Engine-facing adapter over an in-process ``PrefillWorker`` (kind
    ``"local"``: the worker runs on one background thread, so prefill
    overlaps the engine's decode loop wherever the device or the host
    has room) or a ``PrefillWorker`` actor handle (kind ``"actor"``: the
    job is the call's ``ObjectRef``).  A Serve deployment handle (kind
    ``"deployment"``) needs the Serve control plane and raises."""

    def __init__(self, target):
        self._target = target
        self._pool = None
        if hasattr(target, "method"):
            self._kind = "deployment"
        elif hasattr(getattr(target, "prefill", None), "remote"):
            self._kind = "actor"
        elif callable(getattr(target, "prefill", None)):
            self._kind = "local"
        else:
            raise TypeError(
                f"not a prefill target: {type(target).__name__} (need a "
                "PrefillWorker or a PrefillWorker actor handle)")
        if self._kind == "deployment":
            raise NotImplementedError(
                f"prefill through a deployment handle {_SERVE}")

    def submit(self, tokens, start: int,
               sampling: SamplingParams) -> _PrefillJob:
        args = (list(tokens), int(start), float(sampling.temperature),
                float(sampling.top_p), int(sampling.seed))
        if self._kind == "actor":
            return _PrefillJob(self._target.prefill.remote(*args).future())
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="rtt-prefill")
        return _PrefillJob(self._pool.submit(self._target.prefill, *args))


def as_prefill_client(target) -> PrefillClient:
    return target if isinstance(target, PrefillClient) \
        else PrefillClient(target)
