"""Continuous-batching LLM decode engine with a paged KV cache
(counterpart of ``ray_tpu/serve/llm_engine.py``).

1. **Fixed-slot decode step.**  Every decode step runs all
   ``max_slots`` lanes (token ids, lengths, page table, active mask,
   sampling params); admitting or retiring a request flips host-side
   state only.  Inactive lanes compute garbage that is written to the
   scratch page.

2. **Token-boundary admission.**  The engine loop runs one decode step
   for all in-flight requests, then admits pending requests into free
   slots between steps (one prefill each), so a new request joins the
   running batch at the next token boundary.

3. **Paged KV cache.**  K/V live in fixed-size pages of device tensors
   ``[L, num_pages, page_size, Hkv, D]`` handed out by ``PagePool``.  A
   sequence owns ``ceil(len/page)`` pages found through a per-slot page
   table; each step gathers the pages into the attention view and writes
   the new tokens' K/V back.  When the pool runs dry the engine preempts
   the youngest request (recompute preemption: its pages free, and it is
   prefilled again later from prompt + generated-so-far; sampling is
   position-seeded, so the resumed output is identical).

4. **Seeded sampling** (``serve/sampling.py``): ``temperature=0`` (the
   default) is greedy argmax, the token-identity contract with
   ``NaiveLM``.  Each step returns its logits and the engine samples them
   on the host's generator stream, capturing each emitted token's
   behavior logprob (raw log-softmax).

5. **Speculative decoding.**  With a ``draft_model``, each iteration
   runs ``spec_tokens - 1`` draft steps that propose tokens, one catch-up
   draft step, then one target verify step over the ``[max_slots,
   spec_tokens]`` window that samples the target's token at every
   position (accept the longest matching prefix, plus the target's own
   token).  Sampling is position-seeded, so the accepted stream is the
   plain stream; the draft only sets the tokens a step yields.  The draft
   has its own page arrays under the target's page table, and with
   ``draft_window`` attends to the last pages only.

6. **Prefix cache** (``serve/prefix_cache.py``).  After prefill every
   full page's K/V is snapshotted to a host LRU under the hash of the
   token prefix that produced it; admission adopts the longest cached
   run of pages and prefills only the tail, which attends to the adopted
   pages.

7. **Disaggregated prefill** (``serve/prefill.py``).  With ``prefill=``
   (an in-process ``PrefillWorker``), an admission whose uncached tail
   is at least ``prefill_min_tokens`` long is handed to the worker's
   thread; the engine adopts the returned pages at a later token
   boundary, and decode never waits for a long prompt.

8. **Token-boundary hot weight swap** (``swap_weights``).  A new
   ``state_dict`` is copied into the model between decode steps (one
   host-to-device copy per version); in-flight slots are recycled
   through recompute preemption, so their KV is rebuilt under the new
   weights; every emitted token is stamped with the weight version it was
   sampled under, and the prefix-cache namespace folds the version in,
   so pre-swap pages become unaddressable.  ``rollout`` and
   ``generate_rollouts`` return tokens with their logprobs and stamps.

9. **Metrics and spans.**  Every ~2 s the loop exports the engine's
   ``serve_*`` metrics (``util/metrics.py``: tokens, requests, in-flight
   requests, batch occupancy, KV pages, tokens/s, prefix hits, spec
   acceptance, the submit-to-admission wait), and each iteration is
   recorded as a ``serve_engine_step`` span on the trace of an active
   request that was submitted under one.

The loop is a worker thread owned by the engine (the JAX package runs it
as a ``flow.Stage`` of its runtime).  ``LLMServer`` is the Serve
deployment callable (one engine per replica); ``generate_many`` sends a
prompt batch to a deployment over the object plane.  Not ported yet, and
raising where a caller reaches it: the cluster prefix directory (what is
left of ROADMAP Queue 1 item 1a).

The engine serves either model family of ``build_model``: GPT-2, and the
Llama family, whose pages hold K/V at ``num_kv_heads``.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import queue
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.gpt2 import _lecun_normal_
from ray_tpu_torch.exceptions import EngineClosedError, KVPoolExhaustedError
from ray_tpu_torch.serve import prefix_cache as pc
from ray_tpu_torch.serve.sampling import (
    GREEDY,
    SamplingParams,
    sample_tokens,
    sample_tokens_with_logprobs,
)

_DIRECTORY = ("is not ported yet: it is left of ROADMAP Queue 1 item 1a, "
              "with multi-host and client mode")


def _is_object_ref(value) -> bool:
    from ray_tpu_torch.object_ref import ObjectRef

    return isinstance(value, ObjectRef)


class PagePool:
    """Free-list allocator of fixed-size KV-cache pages.  Pages are
    created once (the device tensors are allocated up front) and recycled
    through a free list.  Page 0 is the scratch page: the masked-out lanes
    of the decode and prefill writes (inactive slots, prompt padding) go
    there, so they can never corrupt a live sequence."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("PagePool needs >= 2 pages (page 0 is scratch)")
        self.capacity = num_pages - 1  # page 0 reserved
        self._free: collections.deque = collections.deque(range(1, num_pages))
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.peak_in_use = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop n pages, all-or-nothing (a partial grant would deadlock the
        grower against its own reservation)."""
        with self._lock:
            if len(self._free) < n:
                self.misses += 1
                return None
            self.hits += 1
            out = [self._free.popleft() for _ in range(n)]
            self.peak_in_use = max(self.peak_in_use, self.in_use)
            return out

    def free(self, pages: Sequence[int]):
        with self._lock:
            self._free.extend(pages)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"capacity": self.capacity, "free": len(self._free),
                    "in_use": self.in_use, "peak_in_use": self.peak_in_use,
                    "hits": self.hits, "misses": self.misses}


@dataclasses.dataclass
class _Request:
    id: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int]
    sampling: SamplingParams = GREEDY
    out: List[int] = dataclasses.field(default_factory=list)
    chunks: "queue.Queue" = dataclasses.field(default_factory=queue.Queue)
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    error: Optional[BaseException] = None
    streamed: int = 0  # tokens already pushed to the chunk stream
    admit_seq: int = -1  # preemption picks the youngest (highest seq)
    # True once the caller has the terminal state (result() returned or
    # raised, or the None chunk was delivered); only consumed requests
    # are evicted from the registry.
    consumed: bool = False
    spec_proposed: int = 0
    spec_accepted: int = 0
    # Parallel to ``out``: each emitted token's behavior logprob and the
    # weight version it was sampled under.
    out_logps: List[float] = dataclasses.field(default_factory=list)
    out_versions: List[int] = dataclasses.field(default_factory=list)
    submitted: float = dataclasses.field(default_factory=time.monotonic)
    # The distributed trace the request was submitted under (the caller's
    # context, when tracing is on): the engine's steps are recorded on it.
    trace_ctx: Optional[tuple] = None

    def context(self) -> List[int]:
        """Prompt plus generated-so-far: what a (re)admission prefills."""
        return self.prompt + self.out

    def finish(self, error: Optional[BaseException] = None):
        self.error = error
        if self.streamed < len(self.out):
            self.chunks.put(self.out[self.streamed:])
            self.streamed = len(self.out)
        self.chunks.put(None)
        self.done.set()


# ---------------------------------------------------------------------------
# Step helpers shared by the engine and the prefill worker
# ---------------------------------------------------------------------------
def _scatter_kv(k_pages, v_pages, page_idx, off, newk, newv):
    """Write [L, N, Hkv, D] K/V rows at (page_idx[N], off[N]) of every
    layer's pages, in place."""
    layers = torch.arange(k_pages.shape[0], device=k_pages.device)[:, None]
    k_pages.index_put_((layers, page_idx[None], off[None]),
                       newk.to(k_pages.dtype))
    v_pages.index_put_((layers, page_idx[None], off[None]),
                       newv.to(v_pages.dtype))


def _wpe_rows(positions: torch.Tensor, cfg) -> torch.Tensor:
    """Positions as rows of the position tables (GPT-2's ``wpe``, Llama's
    rope tables): clamped to the table, as JAX clamps an out-of-range
    gather.  Only lanes whose outputs are discarded reach
    past it (prompt padding, a speculative window at the end of the
    context)."""
    return positions.clamp_max(cfg.max_position_embeddings - 1)


def _full_forward(model, tokens: Sequence[int], bucket: int, device):
    """Full-context forward (empty cache) of ``tokens`` padded to
    ``bucket``: (logits [bucket, V], K and V [L, bucket, Hkv, D])."""
    c = model.config
    toks = np.zeros((bucket,), np.int64)
    toks[:len(tokens)] = tokens
    ids = torch.from_numpy(toks).to(device)[None]
    hkv = getattr(c, "num_kv_heads", c.num_heads)
    empty = [(torch.zeros((1, 0, hkv, c.head_dim), dtype=c.dtype,
                          device=device),) * 2
             for _ in range(c.num_layers)]
    logits, new_kvs = model(
        ids, torch.arange(bucket, device=device)[None], empty,
        torch.zeros((1,), dtype=torch.long, device=device))
    newk = torch.stack([nk[0][0] for nk in new_kvs])  # [L, bucket, Hkv, D]
    newv = torch.stack([nk[1][0] for nk in new_kvs])
    return logits[0], newk, newv


def _sample(logits, positions, temps, top_ps, seeds):
    """Sample rows of ``logits`` [N, V] with host arrays of [N] params;
    returns (tokens int64, logprobs) as numpy (one read-back)."""
    positions, temps, top_ps, seeds = (
        torch.from_numpy(np.ascontiguousarray(a)).to(logits.device)
        for a in (positions, temps, top_ps, seeds))
    tok, logp = sample_tokens_with_logprobs(logits, positions, temps, top_ps,
                                            seeds)
    return tok.cpu().numpy(), logp.cpu().numpy()


def _sample_one(logits_row, position: int, s: SamplingParams):
    """The token at ``position`` from one logits row [V] under the
    request's sampling, and its logprob."""
    tok, logp = _sample(logits_row[None], np.array([position]),
                        np.array([s.temperature], np.float32),
                        np.array([s.top_p], np.float32), np.array([s.seed]))
    return int(tok[0]), float(logp[0])


class LLMEngine:
    """Replica-resident continuous-batching decode engine.

    ``submit()`` is thread-safe and returns immediately; the engine's
    worker thread owns the device state and serializes prefill and
    decode.  ``result()`` blocks for the full output, ``stream()`` yields
    token chunks as they are produced.  ``model`` (and ``draft_model``)
    must already be on ``device`` (CUDA unless ``device="cpu"``); the
    module carries its weights, so there is no ``params`` or
    ``draft_params`` argument."""

    # Registry size bound: evict consumed finished requests past LIMIT,
    # down to FLOOR (an undrained streaming request is never dropped).
    REGISTRY_LIMIT = 4096
    REGISTRY_FLOOR = 2048

    def __init__(self, model, *, max_slots: int = 8, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_ctx: Optional[int] = None, chunk_tokens: int = 8,
                 start: bool = True, draft_model=None,
                 spec_tokens: Optional[int] = None,
                 draft_window: Optional[int] = None, prefix_cache=None,
                 cache_namespace: str = "", prefix_directory=None,
                 prefill=None, prefill_min_tokens: int = 32, device=None):
        self.device = resolve_device(device)
        for name, m in (("model", model), ("draft model", draft_model)):
            if m is None:
                continue
            param_device = next(m.parameters()).device
            if param_device != self.device:
                raise ValueError(f"the {name} is on {param_device} but the "
                                 f"engine runs on {self.device}")
        self._model = model
        c = model.config
        self.num_layers = c.num_layers
        self.head_dim = c.head_dim
        self.kv_heads = getattr(c, "num_kv_heads", c.num_heads)
        self.dtype = c.dtype
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.max_ctx = int(max_ctx or c.max_position_embeddings)
        self.pages_per_slot = math.ceil(self.max_ctx / self.page_size)
        self.max_ctx = self.pages_per_slot * self.page_size
        if self.max_ctx > c.max_position_embeddings:
            raise ValueError(
                f"max_ctx {self.max_ctx} (page-rounded) exceeds the model's "
                f"max_position_embeddings {c.max_position_embeddings}")
        # Default pool: full provisioning (+1 scratch), so every slot can
        # reach max_ctx and preemption never fires.
        if num_pages is None:
            num_pages = self.max_slots * self.pages_per_slot + 1
        self.pool = PagePool(num_pages)
        self.chunk_tokens = chunk_tokens

        # The JAX engine donates these buffers to its compiled steps;
        # here the steps write them in place (index_put_).
        self._k_pages, self._v_pages = self._page_arrays(c, num_pages)

        # ---- speculative decoding (draft + verify) ----
        self.spec_tokens = int(spec_tokens if spec_tokens is not None
                               else 4 if draft_model is not None else 0)
        self._draft_model = draft_model
        self._spec = draft_model is not None and self.spec_tokens >= 2
        if draft_model is not None and not self._spec:
            raise ValueError(
                f"speculative decoding needs spec_tokens >= 2, got "
                f"{self.spec_tokens}")
        if self._spec:
            dc = draft_model.config
            if dc.vocab_size != c.vocab_size or \
                    dc.max_position_embeddings < self.max_ctx:
                raise ValueError(
                    "draft model must share the target's vocab and cover "
                    "its max_ctx "
                    f"(draft vocab {dc.vocab_size} vs {c.vocab_size}, "
                    f"positions {dc.max_position_embeddings} vs "
                    f"{self.max_ctx})")
            # The draft's pages sit under the target's page table.
            self._dk_pages, self._dv_pages = self._page_arrays(dc, num_pages)
        # Sliding-window draft attention: the draft gathers only the last
        # ceil(draft_window / page_size) pages (at least 2).
        self._draft_window_pages = None
        if draft_window is not None:
            if not self._spec:
                raise ValueError("draft_window needs a draft model")
            self._draft_window_pages = max(
                2, math.ceil(int(draft_window) / self.page_size))

        # ---- prefix cache (the local tier) ----
        if prefix_directory is not None:
            raise NotImplementedError(
                f"prefix_directory (the cluster prefix cache) {_DIRECTORY}")
        if prefix_cache is True:
            prefix_cache = pc.PrefixCacheLocal(256 * 1024 * 1024)
        self._prefix = prefix_cache or None
        if not cache_namespace:
            cache_namespace = (f"{type(model).__name__}|{c!r}|"
                               f"ps{self.page_size}")
        # Callers pass the unversioned base; every swap_weights re-derives
        # the effective namespace, making pre-swap pages unaddressable.
        self._base_namespace = cache_namespace
        self._weight_version = 0
        self._namespace = pc.versioned_namespace(cache_namespace, 0)

        # ---- disaggregated prefill ----
        self._prefill_min = int(prefill_min_tokens)
        self._prefill_client = None
        if prefill is not None:
            from ray_tpu_torch.serve.prefill import as_prefill_client

            self._prefill_client = as_prefill_client(prefill)
        # (req, job, start) awaiting the worker: nothing is reserved while
        # a prefill is in flight; finished payloads park in _ready until a
        # slot frees.
        self._awaiting: List[tuple] = []
        self._ready: collections.deque = collections.deque()
        self._prefill_max_inflight = 2 * self.max_slots

        # Host-side slot state (the loop thread is the only writer).
        self._table = np.zeros((self.max_slots, self.pages_per_slot),
                               np.int64)
        self._lengths = np.zeros((self.max_slots,), np.int64)
        self._active = np.zeros((self.max_slots,), bool)
        self._last_tok = np.zeros((self.max_slots,), np.int64)
        self._temps = np.zeros((self.max_slots,), np.float32)
        self._top_ps = np.ones((self.max_slots,), np.float32)
        self._seeds = np.zeros((self.max_slots,), np.int64)
        self._slot_pages: List[List[int]] = [[] for _ in range(self.max_slots)]
        self._slot_req: Dict[int, _Request] = {}

        self._decode = self._make_decode_step(model)
        if self._spec:
            self._draft_decode = self._make_decode_step(
                draft_model, window_pages=self._draft_window_pages)
            self._verify = self._make_verify_step(model)
        self._prefill_buckets = set()

        self._pending: collections.deque = collections.deque()
        self._requests: Dict[int, _Request] = {}
        self._next_id = 0
        self._admit_counter = 0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self._stats = collections.Counter()
        self._occupancy_sum = 0.0
        self._decode_s = 0.0
        self._prefill_s = 0.0
        # Host wall time of the parts of a speculative step, each ended by
        # a device sync the step needs anyway (its sampling reads back).
        self._spec_split = collections.Counter()
        # Hot weight swap: queued (state_dict, version, event), applied by
        # the loop thread at the next token boundary.
        self._pending_swaps: collections.deque = collections.deque()
        self._swap_latency_sum = 0.0
        # Wall time of device work (prefill, decode, swap) and the
        # completion stamps of recent decode steps.
        self._work_s = 0.0
        self._step_stamps: collections.deque = collections.deque(
            maxlen=1024)
        self._t0 = time.monotonic()
        self._metrics = None
        self._metrics_flush = 0.0
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="llm_engine")
            self._thread.start()

    def _page_arrays(self, cfg, num_pages: int):
        shape = (cfg.num_layers, num_pages, self.page_size,
                 getattr(cfg, "num_kv_heads", cfg.num_heads), cfg.head_dim)
        return (torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                torch.zeros(shape, dtype=cfg.dtype, device=self.device))

    # ------------------------------------------------------------------
    # public API (any thread)
    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None,
               seed: Optional[int] = None) -> int:
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens > self.max_ctx:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_ctx {self.max_ctx}")
        if sampling is None:
            sampling = SamplingParams(
                temperature=0.0 if temperature is None else float(temperature),
                top_p=1.0 if top_p is None else float(top_p),
                seed=0 if seed is None else int(seed))
        sampling.validate()
        from ray_tpu_torch import observability as obs

        trace_ctx = obs.get_context() if obs.enabled() else None
        with self._cond:
            if self._closed:
                raise EngineClosedError("engine is closed")
            rid = self._next_id
            self._next_id += 1
            req = _Request(rid, prompt, max_new_tokens, eos_id,
                           sampling=sampling, trace_ctx=trace_ctx)
            self._requests[rid] = req
            self._pending.append(req)
            self._cond.notify_all()
        return rid

    def result(self, rid: int, timeout: Optional[float] = None) -> List[int]:
        req = self._requests[rid]
        if not req.done.wait(timeout):
            raise TimeoutError(f"request {rid} not done within {timeout}s")
        req.consumed = True
        if req.error is not None:
            raise req.error
        return list(req.out)

    def swap_weights(self, params, version: int,
                     timeout: Optional[float] = 60.0) -> int:
        """Install new weights (a ``state_dict`` of the serving model, or
        an ``ObjectRef`` to one: the one-put weight broadcast, resolved by
        the loop) at the next token boundary: one host-to-device copy per
        version, no in-flight request dropped.  Active slots are recycled
        through recompute preemption, so their KV is rebuilt under the new
        weights; their emitted tokens, logprobs and stamps stay, and every
        later token is sampled under, and stamped with, ``version``.  The
        prefix-cache namespace re-derives with the version, so pre-swap
        pages are never adopted after the swap.

        ``version`` must exceed the current one.  With ``timeout`` the
        call blocks until the loop applies the swap (``TimeoutError``
        otherwise); ``timeout=None`` returns at once.  A tree whose names,
        shapes or dtypes differ from the model's stops the engine
        (``EngineClosedError`` here, ``ValueError`` on its requests).
        Returns the installed version."""
        if not isinstance(params, Mapping) and not _is_object_ref(params):
            raise TypeError(
                f"swap_weights takes a state_dict or an ObjectRef to one, "
                f"not a {type(params).__name__}")
        version = int(version)
        applied = threading.Event()
        with self._cond:
            if self._closed:
                raise EngineClosedError("engine is closed")
            pending_max = max(
                [v for _, v, _ in self._pending_swaps],
                default=self._weight_version)
            if version <= pending_max:
                raise ValueError(
                    f"swap version {version} must exceed the current "
                    f"version {pending_max}")
            self._pending_swaps.append((params, version, applied))
            self._cond.notify_all()
        if timeout is not None:
            if not applied.wait(timeout):
                raise TimeoutError(
                    f"weight swap to version {version} not applied within "
                    f"{timeout}s")
            if self._weight_version < version:
                # close()/_fail_all wakes waiters without applying.
                raise EngineClosedError(
                    f"engine closed before swap to version {version} "
                    f"applied")
        return version

    @property
    def weight_version(self) -> int:
        return self._weight_version

    def rollout(self, rid: int, timeout: Optional[float] = None
                ) -> Dict[str, Any]:
        """Blocking full result with the per-token behavior logprobs and
        weight-version stamps: the RLHF rollout record."""
        req = self._requests[rid]
        if not req.done.wait(timeout):
            raise TimeoutError(f"request {rid} not done within {timeout}s")
        req.consumed = True
        if req.error is not None:
            raise req.error
        return {
            "prompt": list(req.prompt),
            "tokens": list(req.out),
            "logprobs": list(req.out_logps),
            "versions": list(req.out_versions),
        }

    def generate_rollouts(self, prompts: Sequence[Sequence[int]],
                          max_new_tokens: int = 16,
                          eos_id: Optional[int] = None,
                          sampling: Optional[List[SamplingParams]] = None,
                          timeout: float = 300.0) -> List[Dict[str, Any]]:
        """Submit a prompt batch and collect version-stamped rollouts (all
        prompts in flight together, subject to ``max_slots``)."""
        if sampling is None:
            sampling = [None] * len(prompts)
        rids = [self.submit(p, max_new_tokens, eos_id, sampling=s)
                for p, s in zip(prompts, sampling)]
        return [self.rollout(r, timeout=timeout) for r in rids]

    def recent_step_stamps(self) -> List[float]:
        """``time.monotonic()`` completion stamps of recent decode
        steps."""
        with self._lock:
            return list(self._step_stamps)

    def stream(self, rid: int, timeout: float = 120.0):
        """Yield token chunks (lists) as they are produced; returns when
        the request retires.  Raises the request's error, if any."""
        req = self._requests[rid]
        while True:
            chunk = req.chunks.get(timeout=timeout)
            if chunk is None:
                break
            yield chunk
        req.consumed = True
        if req.error is not None:
            raise req.error

    def request_stats(self, rid: int) -> Dict[str, Any]:
        """Per-request accounting (speculative acceptance)."""
        req = self._requests[rid]
        return {
            "tokens": len(req.out),
            "spec_proposed": req.spec_proposed,
            "spec_accepted": req.spec_accepted,
            "spec_acceptance_rate": (req.spec_accepted / req.spec_proposed
                                     if req.spec_proposed else 0.0),
        }

    def stats(self) -> Dict[str, Any]:
        """Counters of the engine, under the JAX package's names.
        ``decode_seconds`` is host wall time around the decode steps (each
        ends by reading its sampled tokens back, a device sync);
        ``prefill_seconds`` around admissions (prefix lookup and adoption,
        prefill, the snapshot of new pages and the draft's prefill).
        ``spec_split_seconds`` splits the speculative steps into draft
        forwards, draft sampling, verify forward and verify sampling."""
        with self._lock:
            n_active = int(self._active.sum())
            s = dict(self._stats)
            n_pending = len(self._pending)
            n_awaiting = len(self._awaiting) + len(self._ready)
        pool = self.pool.stats()
        steps = s.get("steps", 0)
        out = {
            "active": n_active,
            "pending": n_pending,
            "admitted": s.get("admitted", 0),
            "admitted_mid_batch": s.get("admitted_mid_batch", 0),
            "completed": s.get("completed", 0),
            "preemptions": s.get("preemptions", 0),
            "steps": steps,
            "tokens_generated": s.get("tokens", 0),
            "avg_batch_occupancy": (self._occupancy_sum / steps
                                    if steps else 0.0),
            "pages_in_use": pool["in_use"],
            "pages_free": pool["free"],
            "page_pool": pool,
            "prefills": s.get("prefills", 0),
            "prefill_buckets": len(self._prefill_buckets),
            "decode_seconds": self._decode_s,
            "prefill_seconds": self._prefill_s,
            # speculative decoding
            "spec_steps": s.get("spec_steps", 0),
            "spec_proposed": s.get("spec_proposed", 0),
            "spec_accepted": s.get("spec_accepted", 0),
            "spec_acceptance_rate": (
                s.get("spec_accepted", 0) / s.get("spec_proposed", 1)
                if s.get("spec_proposed", 0) else 0.0),
            "spec_split_seconds": dict(self._spec_split),
            # prefix cache (no directory here: remote hits stay 0)
            "prefix_hit_pages": s.get("prefix_hit_pages", 0),
            "prefix_remote_hit_pages": s.get("prefix_remote_hit_pages", 0),
            "prefix_published_pages": s.get("prefix_published_pages", 0),
            "prefill_tokens": s.get("prefill_tokens", 0),
            "prefill_tokens_saved": s.get("prefill_tokens_saved", 0),
            # disaggregated prefill
            "prefill_offloaded": s.get("prefill_offloaded", 0),
            "prefill_inflight": n_awaiting,
            "prefill_prefix_fallback": s.get("prefill_prefix_fallback", 0),
            "wire_bytes": s.get("wire_bytes", 0),
            "wire_fp32_bytes": s.get("wire_fp32_bytes", 0),
            # hot weight swap
            "weight_version": self._weight_version,
            "swaps": s.get("swaps", 0),
            "swap_reprefills": s.get("swap_reprefills", 0),
            "swap_latency_s_avg": (self._swap_latency_sum / s["swaps"]
                                   if s.get("swaps", 0) else 0.0),
            "work_seconds": self._work_s,
        }
        if self._prefix is not None:
            out["prefix_cache"] = self._prefix.stats()
        return out

    def close(self, timeout: float = 10.0):
        with self._cond:
            if self._closed:
                return
            self._closed = True
            swaps = list(self._pending_swaps)
            self._pending_swaps.clear()
            self._cond.notify_all()
        for _, _, applied in swaps:
            applied.set()  # wake blocked swappers; the version stays put
        if self._thread is not None:
            self._thread.join(timeout)
        err = EngineClosedError("engine closed with requests in flight")
        for req in list(self._requests.values()):
            if not req.done.is_set():
                req.finish(error=err)

    # ------------------------------------------------------------------
    # the steps (plain functions over tensors, run eagerly)
    # ------------------------------------------------------------------
    def _dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _gather_for(self, cfg):
        """Pages + [slots, pp] table -> per-slot contiguous
        [L, slots, max_ctx, Hkv, D] attention view (rows past each slot's
        length are garbage, masked by cached_attention)."""
        L = cfg.num_layers
        hkv = getattr(cfg, "num_kv_heads", cfg.num_heads)
        d, mc = cfg.head_dim, self.max_ctx

        def gather(pages, table):
            return pages[:, table].reshape(L, table.shape[0], mc, hkv, d)

        return gather

    def _write_mask(self, active, positions):
        """Lanes whose K/V lands in a slot's pages: active and inside the
        context.  A speculative window may reach past max_ctx at the end
        of a request; those rows go to the scratch page, where the JAX
        engine's clamped page column would wrap them onto the slot's last
        page."""
        return active & (positions < self.max_ctx)

    def _make_decode_step(self, model, window_pages: Optional[int] = None):
        """One token for every slot, for the target or the draft (each
        over its own page arrays): ``step(k_pages, v_pages, table,
        lengths, tokens, active)`` with host arrays writes each lane's K/V
        at its write head and returns the logits [slots, V].

        ``window_pages`` (the draft) attends to the last n pages only:
        positions are baked into the cached K/V at write time, so the
        windowed view with window-relative lengths is exact windowed
        attention."""
        cfg = model.config
        L, ps, pp = cfg.num_layers, self.page_size, self.pages_per_slot
        hkv = getattr(cfg, "num_kv_heads", cfg.num_heads)
        if window_pages is None or window_pages >= pp:
            gather = self._gather_for(cfg)

            def gather_view(pages, table, lengths):
                return gather(pages, table), lengths
        else:
            wp = int(window_pages)

            def gather_view(pages, table, lengths):
                # Pages [(len-1)//ps - wp + 1 .. (len-1)//ps], clamped:
                # the newest wp pages; valid rows are lengths - start*ps.
                last_page = (lengths - 1).clamp_min(0) // ps
                start = (last_page - (wp - 1)).clamp_min(0)
                cols = start[:, None] + torch.arange(wp, device=self.device)
                idx = table.gather(1, cols.clamp_max(pp - 1))
                view = pages[:, idx].reshape(L, table.shape[0], wp * ps, hkv,
                                             cfg.head_dim)
                return view, lengths - start * ps

        def step(k_pages, v_pages, table, lengths, tokens, active):
            table, lengths, tokens, active = (
                self._dev(a) for a in (table, lengths, tokens, active))
            k_cache, view_len = gather_view(k_pages, table, lengths)
            v_cache, _ = gather_view(v_pages, table, lengths)
            kv = [(k_cache[i], v_cache[i]) for i in range(L)]
            logits, new_kvs = model(tokens[:, None],
                                    _wpe_rows(lengths, cfg)[:, None], kv,
                                    view_len)
            newk = torch.stack([nk[0][:, 0] for nk in new_kvs])
            newv = torch.stack([nk[1][:, 0] for nk in new_kvs])
            slots = torch.arange(table.shape[0], device=self.device)
            page_idx = torch.where(
                self._write_mask(active, lengths),
                table[slots, (lengths // ps).clamp_max(pp - 1)], 0)
            _scatter_kv(k_pages, v_pages, page_idx, lengths % ps, newk, newv)
            return logits[:, -1]

        return step

    def _make_verify_step(self, model):
        """Target verification of a [slots, k] speculative window: one
        forward over the window, K/V written for every position, and the
        logits [slots, k, V] of every position returned for sampling."""
        cfg = model.config
        L, ps, pp = cfg.num_layers, self.page_size, self.pages_per_slot
        k_win = self.spec_tokens
        gather = self._gather_for(cfg)

        def verify(k_pages, v_pages, table, lengths, window, active):
            table, lengths, window, active = (
                self._dev(a) for a in (table, lengths, window, active))
            k_cache = gather(k_pages, table)
            v_cache = gather(v_pages, table)
            kv = [(k_cache[i], v_cache[i]) for i in range(L)]
            positions = lengths[:, None] + torch.arange(k_win,
                                                        device=self.device)
            logits, new_kvs = model(window, _wpe_rows(positions, cfg), kv,
                                    lengths)
            n = table.shape[0]
            newk = torch.stack([nk[0] for nk in new_kvs])  # [L,n,k,Hkv,D]
            newv = torch.stack([nk[1] for nk in new_kvs])
            page_idx = torch.where(
                self._write_mask(active[:, None], positions),
                table.gather(1, (positions // ps).clamp_max(pp - 1)), 0)
            _scatter_kv(k_pages, v_pages, page_idx.reshape(-1),
                        (positions % ps).reshape(-1),
                        newk.flatten(1, 2), newv.flatten(1, 2))
            return logits

        return verify

    def _full_prefill(self, model, k_pages, v_pages, row, ctx):
        """Full-context prefill (empty cache) of ``ctx`` at its
        power-of-two bucket into the pages of table ``row``; returns the
        logits row at p - 1.  The target's prefill and the draft's (the
        JAX engine's ``_prefill_fn`` and ``_draft_prefill_fn``)."""
        p, ps = len(ctx), self.page_size
        bucket = self._bucket_for(p)
        self._prefill_buckets.add(bucket)
        logits, newk, newv = _full_forward(model, ctx, bucket, self.device)
        t = torch.arange(bucket, device=self.device)
        page_idx = torch.where(t < p, self._dev(row)[t // ps], 0)
        _scatter_kv(k_pages, v_pages, page_idx, t % ps, newk, newv)
        return logits[p - 1]

    def _tail_prefill(self, row, ctx, start: int):
        """Cache-aware tail prefill: the first ``start`` tokens' K/V is
        already in the pages of ``row`` (adopted), so only the tail runs
        through the model, attending to the gathered prefix plus itself.
        Returns the logits row at p - 1."""
        cfg, ps, pp = self._model.config, self.page_size, self.pages_per_slot
        p = len(ctx)
        tail_len = p - start
        bucket = self._bucket_for(tail_len)
        self._prefill_buckets.add(bucket)
        toks = np.zeros((bucket,), np.int64)
        toks[:tail_len] = ctx[start:]
        row = self._dev(row)
        gather = self._gather_for(cfg)
        k_cache = gather(self._k_pages, row[None])  # [L, 1, max_ctx, Hkv, D]
        v_cache = gather(self._v_pages, row[None])
        kv = [(k_cache[i], v_cache[i]) for i in range(self.num_layers)]
        t = torch.arange(bucket, device=self.device)
        abs_pos = start + t
        logits, new_kvs = self._model(
            self._dev(toks)[None], _wpe_rows(abs_pos, cfg)[None], kv,
            torch.tensor([start], device=self.device))
        newk = torch.stack([nk[0][0] for nk in new_kvs])
        newv = torch.stack([nk[1][0] for nk in new_kvs])
        page_idx = torch.where(
            t < tail_len, row[(abs_pos // ps).clamp_max(pp - 1)], 0)
        _scatter_kv(self._k_pages, self._v_pages, page_idx, abs_pos % ps,
                    newk, newv)
        return logits[0, tail_len - 1]

    def _bucket_for(self, p: int) -> int:
        b = 8
        while b < p:
            b <<= 1
        return min(b, self.max_ctx)

    # ------------------------------------------------------------------
    # engine loop (the worker thread owns the device state)
    # ------------------------------------------------------------------
    def _loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            while self._wait_for_work():
                if not self._iteration():
                    return

    def _wait_for_work(self) -> bool:
        """Block while there is nothing to do; with only remote prefills
        in flight, poll them every millisecond.  False once closed."""
        with self._cond:
            while not self._closed and not (
                    self._pending or self._ready or self._pending_swaps
                    or self._active.any()):
                if self._awaiting:
                    self._cond.wait(0.001)
                    break
                self._cond.wait(0.2)
            return not self._closed

    def _iteration(self) -> bool:
        t_work0 = time.perf_counter()
        try:
            self._apply_swaps()  # token boundary: between decode steps
            self._poll_prefill()
            self._admit()
            self._grow()
            if self._active.any():
                if self._spec:
                    self._decode_once_spec()
                else:
                    self._decode_once()
                with self._lock:
                    self._step_stamps.append(time.monotonic())
        except BaseException as e:  # noqa: BLE001 — fail per request
            self._fail_all(e)
            return False
        t_work1 = time.perf_counter()
        self._work_s += t_work1 - t_work0
        self._record_step_span(t_work0, t_work1)
        self._flush_metrics()
        return True

    def _record_step_span(self, t0: float, t1: float) -> None:
        """Record the iteration on an active request's trace, so that a
        request's decode steps join the client's timeline.  Nothing is
        recorded when no in-flight request carries a context."""
        ctx = next((tuple(req.trace_ctx) for req in self._slot_req.values()
                    if req.trace_ctx is not None), None)
        if ctx is None:
            return
        from ray_tpu_torch._private import profiling

        profiling.record_span("serve_engine_step", t0, t1,
                              active=int(self._active.sum()),
                              _trace_ctx=ctx)

    # ------------------------------------------------------------------
    # hot weight swap (loop thread only)
    # ------------------------------------------------------------------
    def _apply_swaps(self):
        """Install every queued weight version, newest last.  Runs
        between decode steps: the definition of a token boundary."""
        while True:
            with self._lock:
                if not self._pending_swaps:
                    return
                params, version, applied = self._pending_swaps.popleft()
            t0 = time.monotonic()
            try:
                if _is_object_ref(params):
                    import ray_tpu_torch

                    params = ray_tpu_torch.get(params)
                self._check_swap_tree(params)
            except BaseException:
                # The loop is about to die (_fail_all); wake the blocked
                # swapper now, so it raises EngineClosedError at once.
                applied.set()
                raise
            # One host-to-device copy per version, into the model's own
            # tensors (a draft built by layerskip_draft holds copies and
            # keeps its weights).
            self._model.load_state_dict(params)
            self._weight_version = int(version)
            self._namespace = pc.versioned_namespace(
                self._base_namespace, self._weight_version)
            # In-flight requests: recycled through recompute preemption so
            # their KV is rebuilt under the new weights at re-admission.
            for slot in range(self.max_slots):
                if self._active[slot]:
                    self._preempt(slot)
                    self._stats["swap_reprefills"] += 1
            self._stats["swaps"] += 1
            self._swap_latency_sum += time.monotonic() - t0
            applied.set()

    def _check_swap_tree(self, params: Mapping[str, Any]):
        """A mismatched state_dict would garble the model: fail loudly."""
        cur = self._model.state_dict()
        if set(params) != set(cur):
            raise ValueError(
                "swap_weights state_dict does not match the serving "
                f"model's (missing {sorted(set(cur) - set(params))}, "
                f"unexpected {sorted(set(params) - set(cur))})")
        for name, old in cur.items():
            new = params[name]
            if tuple(new.shape) != tuple(old.shape) or \
                    new.dtype != old.dtype:
                raise ValueError(
                    f"swap_weights leaf {name} mismatch: "
                    f"{tuple(new.shape)}/{new.dtype} vs serving "
                    f"{tuple(old.shape)}/{old.dtype}: a swap must not "
                    f"change shapes or dtypes")

    def _fail_all(self, e: BaseException):
        with self._lock:
            self._closed = True  # a dead loop must reject new submits
            self._awaiting = []
            self._ready.clear()
            swaps = list(self._pending_swaps)
            self._pending_swaps.clear()
        for _, _, applied in swaps:
            applied.set()
        for req in list(self._requests.values()):
            if not req.done.is_set():
                req.finish(error=e)
        for s in range(self.max_slots):
            if self._slot_pages[s]:
                self.pool.free(self._slot_pages[s])
                self._slot_pages[s] = []
        self._active[:] = False

    # ------------------------------------------------------------------
    # admission: prefix-cache lookup, local prefill or offload
    # ------------------------------------------------------------------
    def _admit(self):
        """Token-boundary admission: activate finished offloaded prefills
        first, then fill free slots from the pending queue, one prefill
        each.  Requires prompt pages + 1 free so the first decode token
        cannot force a preemption at once.  Offload decisions come before
        any slot or page is reserved."""
        self._activate_ready()
        while True:
            with self._lock:
                if not self._pending:
                    return
                req = self._pending[0]
                ctx = req.context()
                p = len(ctx)
                need = math.ceil(p / self.page_size)
                if need + 1 > self.pool.capacity:
                    # Can never fit, even with the whole pool to itself.
                    self._pending.popleft()
                    req.finish(error=KVPoolExhaustedError(
                        f"request {req.id} needs {need + 1} pages but the "
                        f"pool holds {self.pool.capacity}"))
                    continue
                inflight = len(self._awaiting) + len(self._ready)
            if (self._prefill_client is not None
                    and inflight < self._prefill_max_inflight):
                # The uncached tail from the local cache's view.
                start = self._local_prefix_run(ctx)
                if p - start >= self._prefill_min:
                    job = self._prefill_client.submit(ctx, start,
                                                      req.sampling)
                    with self._lock:
                        self._pending.popleft()
                        self._awaiting.append((req, job, start))
                    self._stats["prefill_offloaded"] += 1
                    continue
            slot, mid_batch = self._reserve(need)
            if slot is None:
                return
            with self._lock:
                self._pending.popleft()
            t0 = time.perf_counter()
            # Longest cached prefix: adopt its pages, prefill the tail.
            cached = self._lookup_prefix(ctx)
            start = len(cached) * self.page_size
            if cached:
                self._adopt_pages(slot, 0, cached)
                self._stats["prefill_tokens_saved"] += start
            nxt, lp = self._local_prefill(slot, req, ctx, start)
            self._finish_admission(slot, req, p, nxt, lp, mid_batch, t0)

    def _reserve(self, need: int):
        """A free slot with ``need`` pages (and one more free in the
        pool), or (None, False)."""
        with self._lock:
            free = [s for s in range(self.max_slots) if not self._active[s]]
            if not free:
                return None, False
            pages = self.pool.alloc(need + 1)
            if pages is None:
                return None, False  # pool too tight; retry next boundary
            self.pool.free(pages[need:])  # only reserve the +1 headroom
            slot = free[0]
            mid_batch = bool(self._active.any())
        self._slot_pages[slot] = pages[:need]
        self._table[slot] = 0
        self._table[slot, :need] = pages[:need]
        return slot, mid_batch

    def _local_prefix_run(self, ctx: List[int]) -> int:
        """Length (tokens) of the leading full-page run present in the
        local cache (contains() only, no fetch)."""
        if self._prefix is None:
            return 0
        keys = pc.prefix_page_keys(
            self._namespace, ctx, self.page_size,
            max_pages=(len(ctx) - 1) // self.page_size)
        n = 0
        for key in keys:
            if not self._prefix.contains(key):
                break
            n += 1
        return n * self.page_size

    def _activate_ready(self):
        """Admit finished offloaded prefills into free slots: reserve the
        slot and pages now, re-adopt the cached prefix, adopt the tail
        pages from the wire, activate.  If the prefix was evicted during
        the round trip, fall back to a local prefill (the tail payload
        alone cannot cover the missing positions)."""
        while self._ready:
            req, result, start = self._ready[0]
            ctx = req.context()
            p = len(ctx)
            slot, mid_batch = self._reserve(math.ceil(p / self.page_size))
            if slot is None:
                return
            with self._lock:
                self._ready.popleft()
            t0 = time.perf_counter()
            k_np, v_np, next_tok, meta = result
            first_page = start // self.page_size
            if start:
                cached = self._lookup_prefix(ctx, max_pages=first_page)
                if len(cached) < first_page:
                    self._stats["prefill_prefix_fallback"] += 1
                    hit = len(cached) * self.page_size
                    if cached:
                        self._adopt_pages(slot, 0, cached)
                        self._stats["prefill_tokens_saved"] += hit
                    nxt, lp = self._local_prefill(slot, req, ctx, hit)
                    self._finish_admission(slot, req, p, nxt, lp, mid_batch,
                                           t0)
                    continue
                self._adopt_pages(slot, 0, cached)
                self._stats["prefill_tokens_saved"] += start
            self._adopt_pages(
                slot, first_page,
                [(k_np[:, j], v_np[:, j]) for j in range(k_np.shape[1])])
            self._stats["wire_bytes"] += int(meta.get("wire_bytes", 0))
            self._stats["wire_fp32_bytes"] += int(meta.get("fp32_bytes", 0))
            if meta.get("exact", True):
                self._publish_prefix(ctx, slot)
            self._finish_admission(slot, req, p, int(next_tok),
                                   float(meta.get("next_logp", float("nan"))),
                                   mid_batch, t0)

    def _local_prefill(self, slot: int, req: _Request, ctx: List[int],
                       start: int):
        """Run the full or the tail prefill into the slot's pages, then
        snapshot its new full pages; returns (next token, logprob)."""
        p = len(ctx)
        row = self._table[slot]
        if start == 0:
            logits = self._full_prefill(self._model, self._k_pages,
                                        self._v_pages, row, ctx)
        else:
            logits = self._tail_prefill(row, ctx, start)
        tok_lp = _sample_one(logits, p, req.sampling)
        self._stats["prefills"] += 1
        self._stats["prefill_tokens"] += p - start
        self._publish_prefix(ctx, slot)
        return tok_lp

    def _finish_admission(self, slot: int, req: _Request, p: int,
                          next_tok: int, next_logp: float, mid_batch: bool,
                          t0: float):
        """Shared end of every admission path: the slot's K/V covers
        positions [0, p) and ``next_tok`` is the sampled token at p."""
        if self._spec:
            self._warm_draft(slot, req.context())
        s = req.sampling
        self._stats["admitted"] += 1
        if mid_batch:
            self._stats["admitted_mid_batch"] += 1
        self._observe_queue_wait(time.monotonic() - req.submitted)
        self._lengths[slot] = p
        self._last_tok[slot] = next_tok
        self._temps[slot] = s.temperature
        self._top_ps[slot] = s.top_p
        self._seeds[slot] = s.seed
        req.admit_seq = self._admit_counter
        self._admit_counter += 1
        with self._lock:
            self._active[slot] = True
        self._slot_req[slot] = req
        self._prefill_s += time.perf_counter() - t0
        self._append_token(slot, req, next_tok, next_logp)

    def _warm_draft(self, slot: int, ctx: List[int]):
        """Spec mode: full draft prefill of the context into the draft's
        pages (the same table row as the target)."""
        self._full_prefill(self._draft_model, self._dk_pages, self._dv_pages,
                           self._table[slot], ctx)

    # ------------------------------------------------------------------
    # prefix cache: lookup / adopt / publish (the local tier)
    # ------------------------------------------------------------------
    def _lookup_prefix(self, ctx: List[int],
                       max_pages: Optional[int] = None) -> List[tuple]:
        """(k, v) host pages of the longest cached run of leading full
        pages, capped at (len-1)//page_size so at least one position is
        computed afresh (the next token needs a logits row)."""
        if self._prefix is None:
            return []
        cap = (len(ctx) - 1) // self.page_size
        if max_pages is not None:
            cap = min(cap, max_pages)
        out: List[tuple] = []
        for key in pc.prefix_page_keys(self._namespace, ctx, self.page_size,
                                       max_pages=cap):
            entry = self._prefix.get(key)
            if entry is None:
                break
            out.append(entry)
        self._stats["prefix_hit_pages"] += len(out)
        return out

    def _adopt_pages(self, slot: int, first_page: int, pages: List[tuple]):
        """Copy host (k, v) pages, each [L, ps, Hkv, D], into the slot's
        device pages from page index ``first_page`` on (one copy each for
        K and V); the cast to the cache dtype is exact for pages that came
        from a cache of that dtype."""
        n = len(pages)
        if n == 0:
            return
        ids = self._dev(self._table[slot, first_page:first_page + n])
        for dst, j in ((self._k_pages, 0), (self._v_pages, 1)):
            new = torch.stack([torch.as_tensor(pg[j]) for pg in pages], 1)
            dst[:, ids] = new.to(device=self.device, dtype=dst.dtype)

    def _publish_prefix(self, ctx: List[int], slot: int):
        """Snapshot every full page of ``ctx`` not yet cached into the
        local LRU (one read-back from the device).  Full pages are
        immutable: later decode writes touch later pages."""
        if self._prefix is None:
            return
        n_full = len(ctx) // self.page_size
        keys = pc.prefix_page_keys(self._namespace, ctx, self.page_size,
                                   max_pages=n_full)
        todo = [(i, key) for i, key in enumerate(keys)
                if not self._prefix.contains(key)]
        if not todo:
            return
        ids = self._dev(self._table[slot, [i for i, _ in todo]])
        k_all = self._k_pages[:, ids].cpu()  # [L, m, ps, Hkv, D]
        v_all = self._v_pages[:, ids].cpu()
        for j, (_, key) in enumerate(todo):
            self._prefix.put(key, k_all[:, j].clone(), v_all[:, j].clone())
        self._stats["prefix_published_pages"] += len(todo)

    # ------------------------------------------------------------------
    # disaggregated prefill: poll the jobs
    # ------------------------------------------------------------------
    def _poll_prefill(self):
        """Move finished offloaded prefills to the ready queue; decode of
        the active slots never waits on them."""
        with self._lock:
            awaiting = list(self._awaiting)
        for entry in awaiting:
            req, job, start = entry
            try:
                result = job.poll()
            except Exception as e:  # noqa: BLE001 — typed per-request fail
                with self._lock:
                    if entry in self._awaiting:
                        self._awaiting.remove(entry)
                req.finish(error=e)
                continue
            if result is None:
                continue
            with self._lock:
                self._awaiting.remove(entry)
                self._ready.append((req, result, start))

    # ------------------------------------------------------------------
    # decode steps
    # ------------------------------------------------------------------
    def _grow(self):
        """Allocate pages for every active slot whose write horizon (one
        token, or ``spec_tokens`` positions in spec mode) crosses a page
        boundary; preempt the youngest other request when the pool is dry
        (recompute preemption)."""
        horizon = self.spec_tokens if self._spec else 1
        for slot in range(self.max_slots):
            if not self._active[slot]:
                continue
            pos = int(self._lengths[slot])
            page_needed = min(pos + horizon - 1,
                              self.max_ctx - 1) // self.page_size
            while page_needed >= len(self._slot_pages[slot]):
                got = self.pool.alloc(1)
                if got is not None:
                    self._table[slot, len(self._slot_pages[slot])] = got[0]
                    self._slot_pages[slot].append(got[0])
                    continue
                victim = self._pick_victim(exclude=slot)
                if victim is None:
                    req = self._slot_req[slot]
                    self._retire(slot, req, error=KVPoolExhaustedError(
                        f"request {req.id} needs page {page_needed + 1} "
                        f"but the pool ({self.pool.capacity} pages) is "
                        f"exhausted and no other request can be "
                        f"preempted"))
                    break
                self._preempt(victim)

    def _pick_victim(self, exclude: int) -> Optional[int]:
        best, best_seq = None, -1
        for s in range(self.max_slots):
            if s == exclude or not self._active[s]:
                continue
            seq = self._slot_req[s].admit_seq
            if seq > best_seq:
                best, best_seq = s, seq
        return best

    def _release(self, slot: int):
        """Free the slot's pages (the target's and the draft's, which
        share them) and clear its lane."""
        self.pool.free(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._table[slot] = 0
        self._lengths[slot] = 0
        self._temps[slot] = 0.0  # an idle lane samples greedily (no draws)
        self._slot_req.pop(slot, None)

    def _preempt(self, slot: int):
        req = self._slot_req[slot]
        self._release(slot)
        self._stats["preemptions"] += 1
        with self._lock:
            self._active[slot] = False
            self._pending.appendleft(req)  # readmitted first, from context()

    def _decode_once(self):
        """One token for every slot: the decode step (page gather, model,
        K/V write), then sampling at absolute position lengths + 1."""
        t0 = time.perf_counter()
        n_active = int(self._active.sum())
        logits = self._decode(self._k_pages, self._v_pages, self._table,
                              self._lengths, self._last_tok, self._active)
        nxt, lps = _sample(logits, self._lengths + 1, self._temps,
                           self._top_ps, self._seeds)
        self._decode_s += time.perf_counter() - t0
        self._stats["steps"] += 1
        self._stats["tokens"] += n_active
        self._occupancy_sum += n_active / self.max_slots
        for slot in range(self.max_slots):
            if not self._active[slot]:
                continue
            self._lengths[slot] += 1  # the last token's K/V just landed
            req = self._slot_req[slot]
            tok = int(nxt[slot])
            self._last_tok[slot] = tok
            self._append_token(slot, req, tok, float(lps[slot]))

    def _timed(self, part: str, t0: float) -> float:
        """Close a part of the speculative step at a device sync."""
        self._sync()
        t1 = time.perf_counter()
        self._spec_split[part] += t1 - t0
        return t1

    def _decode_once_spec(self):
        """Draft k-1 proposals per slot, verify the [slots, k] window in
        one target step, accept the longest matching prefix plus the
        target's own token.  Sampling keys depend only on (seed, absolute
        position), so the emitted stream is the non-speculative stream."""
        t_start = time.perf_counter()
        k, n = self.spec_tokens, self.max_slots
        n_active = int(self._active.sum())
        proposals = np.zeros((n, k - 1), np.int64)
        d_last = self._last_tok.copy()
        t = t_start
        for j in range(k - 1):
            logits = self._draft_decode(
                self._dk_pages, self._dv_pages, self._table,
                self._lengths + j, d_last, self._active)
            t = self._timed("draft", t)
            d_last, _ = _sample(logits, self._lengths + j + 1, self._temps,
                                self._top_ps, self._seeds)
            proposals[:, j] = d_last
            t = self._timed("draft_sample", t)
        # Catch-up step: write the last proposal's draft K/V (position
        # len+k-1).  On full acceptance that position is part of the valid
        # cache next iteration, and without this write the draft would
        # read a stale row and desync.  Its logits are not sampled (the
        # JAX engine samples and discards them).
        self._draft_decode(self._dk_pages, self._dv_pages, self._table,
                           self._lengths + (k - 1), d_last, self._active)
        t = self._timed("draft", t)
        window = np.concatenate([self._last_tok[:, None], proposals], axis=1)
        logits = self._verify(self._k_pages, self._v_pages, self._table,
                              self._lengths, window, self._active)
        t = self._timed("verify", t)
        positions = self._lengths[:, None] + np.arange(1, k + 1)
        sampled, v_logps = _sample(
            logits.reshape(n * k, -1), positions.reshape(-1),
            np.repeat(self._temps, k), np.repeat(self._top_ps, k),
            np.repeat(self._seeds, k))
        sampled = sampled.reshape(n, k)  # tokens at len+1..len+k
        v_logps = v_logps.reshape(n, k)
        self._timed("verify_sample", t)
        self._decode_s += time.perf_counter() - t_start
        self._stats["steps"] += 1
        self._stats["spec_steps"] += 1
        self._occupancy_sum += n_active / self.max_slots
        for slot in range(self.max_slots):
            if not self._active[slot]:
                continue
            req = self._slot_req[slot]
            m = 0
            while m < k - 1 and proposals[slot, m] == sampled[slot, m]:
                m += 1
            emit = m + 1  # matched proposals + the target's own token
            self._stats["spec_proposed"] += k - 1
            self._stats["spec_accepted"] += m
            req.spec_proposed += k - 1
            req.spec_accepted += m
            self._stats["tokens"] += emit
            self._lengths[slot] += emit
            self._last_tok[slot] = int(sampled[slot, emit - 1])
            for j in range(emit):
                self._append_token(slot, req, int(sampled[slot, j]),
                                   float(v_logps[slot, j]))
                if not self._active[slot]:
                    break  # retired mid-window (EOS / max_new_tokens)

    def _append_token(self, slot: int, req: _Request, tok: int,
                      logp: float):
        req.out.append(tok)
        req.out_logps.append(logp)
        req.out_versions.append(self._weight_version)
        finished = (len(req.out) >= req.max_new_tokens
                    or (req.eos_id is not None and tok == req.eos_id))
        if finished:
            self._retire(slot, req)
        elif len(req.out) - req.streamed >= self.chunk_tokens:
            req.chunks.put(req.out[req.streamed:])
            req.streamed = len(req.out)

    def _retire(self, slot: int, req: _Request,
                error: Optional[BaseException] = None):
        self._release(slot)
        with self._lock:
            self._active[slot] = False
            self._evict_consumed_locked()
        self._stats["completed"] += 1
        req.finish(error=error)

    def _evict_consumed_locked(self):
        """Bound the registry without losing undrained streams: only
        finished requests whose consumer has the terminal state are
        dropped."""
        if len(self._requests) <= self.REGISTRY_LIMIT:
            return
        for rid in list(self._requests):
            if len(self._requests) <= self.REGISTRY_FLOOR:
                break
            r = self._requests[rid]
            if r.done.is_set() and r.consumed:
                del self._requests[rid]

    # ------------------------------------------------------------------
    # metrics (best effort: the engine also runs without a runtime, where
    # the metrics store is unreachable)
    # ------------------------------------------------------------------
    def _ensure_metrics(self):
        if self._metrics is None:
            from ray_tpu_torch.util import metrics as um

            self._metrics = {
                "tokens": um.Meter("serve_tokens",
                                   "Tokens generated by the decode engine"),
                "requests": um.Meter("serve_requests",
                                     "Requests completed by the engine"),
                "inflight": um.Gauge("serve_inflight_requests",
                                     "Active + queued engine requests"),
                "occupancy": um.Gauge("serve_batch_occupancy",
                                      "Active slots / max_slots"),
                "pages_in_use": um.Gauge("serve_kv_pages_in_use",
                                         "KV cache pages allocated"),
                "pages_free": um.Gauge("serve_kv_pages_free",
                                       "KV cache pages free"),
                "tokens_per_s": um.Gauge("serve_tokens_per_s",
                                         "Engine decode throughput"),
                "prefix_hits": um.Meter(
                    "serve_prefix_hit_pages",
                    "KV pages adopted from the prefix cache"),
                "spec_accept": um.Gauge(
                    "serve_spec_acceptance",
                    "Speculative-decode acceptance rate (accepted / "
                    "proposed draft tokens)"),
                "queue_wait": um.Histogram(
                    "serve_queue_wait_s", "Submit-to-admission wait",
                    boundaries=(0.001, 0.01, 0.1, 1.0, 10.0)),
            }

    def _observe_queue_wait(self, wait_s: float):
        try:
            self._ensure_metrics()
            self._metrics["queue_wait"].observe(wait_s)
        except Exception:
            pass

    def _flush_metrics(self):
        now = time.monotonic()
        if now - self._metrics_flush < 2.0:
            return
        self._metrics_flush = now
        try:
            self._ensure_metrics()
            m, st = self._metrics, self._stats
            m["tokens"].mark(st["tokens"] - m["tokens"].total())
            m["requests"].mark(st["completed"] - m["requests"].total())
            m["prefix_hits"].mark(
                st["prefix_hit_pages"] - m["prefix_hits"].total())
            if st.get("spec_proposed", 0):
                m["spec_accept"].set(
                    st["spec_accepted"] / st["spec_proposed"])
            with self._lock:
                inflight = int(self._active.sum()) + len(self._pending)
                occ = float(self._active.sum()) / self.max_slots
            m["inflight"].set(inflight)
            m["occupancy"].set(occ)
            pool = self.pool.stats()
            m["pages_in_use"].set(pool["in_use"])
            m["pages_free"].set(pool["free"])
            m["tokens_per_s"].set(st["tokens"] / max(1e-9,
                                                     now - self._t0))
            for meter in (m["tokens"], m["requests"], m["prefix_hits"]):
                meter.flush()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# The naive per-request baseline and build_model
# ---------------------------------------------------------------------------
class NaiveLM:
    """Per-request serving baseline: batch 1, no KV cache; every token
    re-runs the full-context forward at a fixed padded width (padding is
    exact under the causal mask).  It is the reference the engine must be
    token-identical to, and, with ``sampling``, the seeded-sampling
    reference too.  At ``width >= 1024`` on CUDA every step runs the
    flash-attention kernel once per layer."""

    def __init__(self, model, width: int, device=None):
        self.device = resolve_device(device)
        param_device = next(model.parameters()).device
        if param_device != self.device:
            raise ValueError(f"the model is on {param_device} but NaiveLM "
                             f"runs on {self.device}")
        self.model = model
        self.width = width

    def generate(self, prompt: Sequence[int], max_new_tokens: int,
                 eos_id: Optional[int] = None,
                 sampling: Optional[SamplingParams] = None) -> List[int]:
        s = sampling or GREEDY
        dev = self.device
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        buf = torch.zeros((1, self.width), dtype=torch.long, device=dev)
        buf[0, :len(prompt)] = torch.tensor(prompt, device=dev)
        n = len(prompt)
        temp = torch.tensor([s.temperature], device=dev)
        top_p = torch.tensor([s.top_p], device=dev)
        seed = torch.tensor([s.seed], device=dev)
        out: List[int] = []
        with torch.inference_mode():
            for _ in range(max_new_tokens):
                logits = self.model(buf)
                tok = int(sample_tokens(logits[0, n - 1][None],
                                        torch.tensor([n], device=dev),
                                        temp, top_p, seed)[0])
                out.append(tok)
                if n < self.width:
                    buf[0, n] = tok
                n += 1
                if eos_id is not None and tok == eos_id:
                    break
        return out


def build_model(model_kind: str = "gpt2", config_kw: Optional[dict] = None,
                seed: int = 0, device=None):
    """A seeded model for a serving replica, on ``device`` (CUDA unless
    ``device="cpu"``).  ``config_kw`` may hold ``tiny=False`` for the
    config's own defaults (default: its tiny preset), plus any field of
    ``GPT2Config`` or ``LlamaConfig``.

    The init draws flax's distributions from a CPU ``torch.Generator``,
    so every device gets the same weights; they are not JAX's values.
    GPT-2: normal(0.02) for ``wte``, normal(0.01) for ``wpe``,
    lecun-normal Dense kernels, zero biases, and with ``moe`` set
    normal(0.02) for each block's router and expert stacks.  Llama
    (``nn.Embed`` and ``nn.Dense`` defaults): normal(1/sqrt(hidden)) for ``embed``,
    lecun-normal for every Dense kernel, ones for the RMSNorm scales; the
    module is made on the meta device and each parameter is drawn on the
    CPU and copied to ``device`` in turn, so no CPU copy of the whole
    model is made."""
    device = resolve_device(device)
    config_kw = dict(config_kw or {})
    tiny = config_kw.pop("tiny", True)
    gen = torch.Generator().manual_seed(seed)
    if model_kind == "llama":
        from ray_tpu_torch.models import Llama, LlamaConfig

        cfg = LlamaConfig.tiny(**config_kw) if tiny \
            else LlamaConfig(**config_kw)
        with torch.device("meta"):
            model = Llama(cfg)
        model = model.to_empty(device=device)
        with torch.no_grad():
            for name, p in model.named_parameters():
                w = torch.empty(p.shape)
                if name == "embed":
                    w.normal_(0.0, cfg.hidden_size ** -0.5, generator=gen)
                elif name.endswith("norm.weight"):
                    w.fill_(1.0)
                else:
                    _lecun_normal_(w, gen)
                p.copy_(w)
        return model.eval()
    if model_kind != "gpt2":
        raise ValueError(f"unknown model_kind {model_kind!r}")
    from ray_tpu_torch.models import GPT2, GPT2Config

    cfg = GPT2Config.tiny(**config_kw) if tiny else GPT2Config(**config_kw)
    model = GPT2(cfg)
    with torch.no_grad():
        model.wte.normal_(0.0, 0.02, generator=gen)
        model.wpe.normal_(0.0, 0.01, generator=gen)
        for module in model.modules():
            if isinstance(module, torch.nn.Linear):
                _lecun_normal_(module.weight, gen)
                module.bias.zero_()
        if cfg.moe is not None:  # after the rest: dense draws unchanged
            for block in model.h:
                for w in (block.moe_router, block.moe_w_in,
                          block.moe_w_out):
                    w.normal_(0.0, 0.02, generator=gen)
    return model.to(device).eval()


def cache_namespace_for(model_kind: str, config_kw: Optional[dict],
                        seed: int, page_size: int,
                        weight_version: Optional[int] = None) -> str:
    """Stable prefix-cache namespace: everything that changes a page's
    bytes (model family, config, init seed, page geometry, and the weight
    version) is in the address.  ``weight_version=None`` gives the
    unversioned base, the form to hand ``LLMEngine(cache_namespace=...)``,
    which folds its live version in on every ``swap_weights``."""
    kw = sorted((config_kw or {}).items())
    base = f"{model_kind}|{kw!r}|seed{seed}|ps{page_size}"
    if weight_version is None:
        return base
    return pc.versioned_namespace(base, weight_version)


class LLMServer:
    """Serve deployment callable hosting one LLMEngine per replica.

    Use with ``@serve.deployment``/``serve.run`` (a replica that needs the
    card asks for it with ``ray_actor_options={"num_gpus": ...}``), or
    in-process.  Entry points:

    - ``__call__({"tokens": [...], "max_new_tokens": n, "temperature": t,
      "top_p": p, "seed": s, "eos_id": e})`` answers a JSON request with
      ``{"tokens": [...]}`` (the HTTP path);
    - ``generate_batch(refs, ...)``: the object-plane path (prompt refs in
      through ``get_many``, output refs back through ``put_many``); pair
      it with :func:`generate_many` on the client;
    - ``submit_stream``/``next_chunk``: pull-based token streaming;
    - ``swap_weights``, ``generate_rollouts``, ``request_stats``: the
      RLHF generation surface;
    - ``autoscale_metric``: in-flight work per decode slot, for the
      controller's ``metric_method`` mode.

    ``draft_config_kw`` (+ ``spec_tokens``) turns on speculative decoding
    with a draft built from the same seed; ``prefix_cache=True`` the local
    prefix cache; ``prefill=`` (a ``PrefillWorker``, its actor handle, or
    a ``PrefillWorker`` deployment's handle) disaggregated prefill."""

    def __init__(self, model_kind: str = "gpt2",
                 config_kw: Optional[dict] = None, seed: int = 0,
                 draft_config_kw: Optional[dict] = None,
                 spec_tokens: Optional[int] = None, prefix_cache=None,
                 prefix_directory=None, prefill=None, device=None,
                 **engine_kw):
        model = build_model(model_kind, config_kw, seed, device)
        draft_model = None
        if draft_config_kw is not None:
            draft_model = build_model(model_kind, draft_config_kw, seed,
                                      device)
        self.engine = LLMEngine(
            model, draft_model=draft_model, spec_tokens=spec_tokens,
            prefix_cache=prefix_cache, prefix_directory=prefix_directory,
            prefill=prefill,
            cache_namespace=cache_namespace_for(
                model_kind, config_kw, seed, engine_kw.get("page_size", 16)),
            device=device, **engine_kw)

    @staticmethod
    def _sampling_of(request: dict) -> SamplingParams:
        return SamplingParams(
            temperature=float(request.get("temperature", 0.0)),
            top_p=float(request.get("top_p", 1.0)),
            seed=int(request.get("seed", 0)))

    def __call__(self, request: dict) -> dict:
        rid = self.engine.submit(request["tokens"],
                                 int(request.get("max_new_tokens", 16)),
                                 request.get("eos_id"),
                                 sampling=self._sampling_of(request))
        return {"tokens": self.engine.result(rid, timeout=120.0)}

    def generate_batch(self, prompts, max_new_tokens: int = 16,
                       eos_id: Optional[int] = None, as_refs: bool = True,
                       sampling: Optional[list] = None):
        """Generate for a prompt batch (token lists or refs to them) with
        every prompt in flight together; returns refs to int32 arrays of
        the outputs (``as_refs``), else the token lists."""
        import ray_tpu_torch

        prompts = _resolve_prompts(prompts)
        if sampling is None:
            sampling = [None] * len(prompts)
        rids = [self.engine.submit(p, max_new_tokens, eos_id, sampling=s)
                for p, s in zip(prompts, sampling)]
        outs = [self.engine.result(r, timeout=120.0) for r in rids]
        if not as_refs:
            return outs
        return ray_tpu_torch.put_many([np.asarray(o, np.int32)
                                       for o in outs])

    def submit_stream(self, prompt, max_new_tokens: int = 16,
                      eos_id: Optional[int] = None,
                      sampling: Optional[SamplingParams] = None) -> int:
        if _is_object_ref(prompt):
            import ray_tpu_torch

            prompt = ray_tpu_torch.get(prompt)
        return self.engine.submit(prompt, max_new_tokens, eos_id,
                                  sampling=sampling)

    def next_chunk(self, rid: int, timeout: float = 60.0):
        """Next streamed token chunk, or None when the request retired."""
        req = self.engine._requests[rid]
        try:
            chunk = req.chunks.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(f"no chunk for request {rid} in {timeout}s")
        if chunk is None:
            req.consumed = True
        return chunk

    def swap_weights(self, params, version: int,
                     timeout: Optional[float] = 60.0) -> int:
        """Hot-swap this replica's weights (a ``state_dict`` or an
        ``ObjectRef`` to one)."""
        return self.engine.swap_weights(params, version, timeout=timeout)

    def generate_rollouts(self, prompts, max_new_tokens: int = 16,
                          eos_id: Optional[int] = None,
                          sampling: Optional[list] = None):
        """Version-stamped rollouts (tokens + behavior logprobs); takes
        prompt refs like ``generate_batch``."""
        return self.engine.generate_rollouts(
            _resolve_prompts(prompts), max_new_tokens, eos_id,
            sampling=sampling)

    def stats(self) -> dict:
        return self.engine.stats()

    def request_stats(self, rid: int) -> dict:
        return self.engine.request_stats(rid)

    def autoscale_metric(self) -> float:
        """Engine-load signal for the controller's ``metric_method``
        autoscaling mode: in-flight work per decode slot (1.0 = every
        slot of the replica's batch is busy)."""
        st = self.engine.stats()
        return (st["active"] + st["pending"]
                + st["prefill_inflight"]) / self.engine.max_slots

    def drain(self):
        """Teardown: close the engine (fails in-flight requests with a
        typed error) and any replica-local batchers."""
        self.engine.close()
        from ray_tpu_torch.serve import batching

        batching.close_instance_batchers(self)
        return True


def _resolve_prompts(prompts) -> list:
    """Prompts as token lists: prompts given as refs are fetched with one
    ``get_many``."""
    prompts = list(prompts)
    if prompts and _is_object_ref(prompts[0]):
        import ray_tpu_torch

        prompts = ray_tpu_torch.get_many(prompts)
    return prompts


def generate_many(handle, prompts, max_new_tokens: int = 16,
                  eos_id: Optional[int] = None,
                  sampling: Optional[List[SamplingParams]] = None,
                  timeout: float = 120.0) -> List[List[int]]:
    """The client half of the object-plane request path: prompts are
    grouped by their prefix affinity key (so shared-prefix requests land
    on the replica that holds their cached pages), each group is put with
    one ``put_many`` and sent in one ``generate_batch`` call carrying the
    refs, and the outputs come back through one ``get_many`` a group.
    The whole batch rides one trace, rooted at a
    ``serve.generate_many`` span."""
    import ray_tpu_torch
    from ray_tpu_torch.util import tracing

    with tracing.span("serve.generate_many", requests=len(prompts)):
        groups: Dict[str, List[int]] = {}
        for i, p in enumerate(prompts):
            groups.setdefault(pc.affinity_key(p), []).append(i)
        out: List[Optional[List[int]]] = [None] * len(prompts)
        calls = []
        for key, idxs in groups.items():
            refs = ray_tpu_torch.put_many(
                [np.asarray(prompts[i], np.int32) for i in idxs])
            samp = [sampling[i] for i in idxs] if sampling else None
            calls.append((idxs, handle.method("generate_batch").remote(
                refs, max_new_tokens, eos_id, True, samp, _affinity=key)))
        for idxs, call in calls:
            out_refs = ray_tpu_torch.get(call, timeout=timeout)
            vals = ray_tpu_torch.get_many(out_refs, timeout=timeout)
            for i, v in zip(idxs, vals):
                out[i] = [int(t) for t in v]
        return out
