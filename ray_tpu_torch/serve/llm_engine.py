"""Continuous-batching LLM decode engine with a paged KV cache
(counterpart of ``ray_tpu/serve/llm_engine.py``).

1. **Fixed-slot decode step.**  Every decode step runs all
   ``max_slots`` lanes (token ids, lengths, page table, active mask,
   sampling params); admitting or retiring a request flips host-side
   state only.  Inactive lanes compute garbage that is written to the
   scratch page.

2. **Token-boundary admission.**  The engine loop runs one decode step
   for all in-flight requests, then admits pending requests into free
   slots between steps (one full prefill each), so a new request joins
   the running batch at the next token boundary.

3. **Paged KV cache.**  K/V live in fixed-size pages of device tensors
   ``[L, num_pages, page_size, Hkv, D]`` handed out by ``PagePool``.  A
   sequence owns ``ceil(len/page)`` pages found through a per-slot page
   table; each step gathers the pages into the attention view and writes
   the new token's K/V back.  When the pool runs dry the engine preempts
   the youngest request (recompute preemption: its pages free, and it is
   prefilled again later from prompt + generated-so-far; sampling is
   position-seeded, so the resumed output is identical).

4. **Seeded sampling** (``serve/sampling.py``): ``temperature=0`` (the
   default) is greedy argmax, the token-identity contract with
   ``NaiveLM``.

The loop is a worker thread owned by the engine.  Not ported yet (see
ROADMAP.md): speculative decoding, the prefix cache and tail prefill,
disaggregated prefill, hot weight swap and rollouts, the object-plane
batch paths, metrics export and tracing spans.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.exceptions import EngineClosedError, KVPoolExhaustedError
from ray_tpu_torch.serve.sampling import GREEDY, SamplingParams, sample_tokens


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


class LLMEngine:
    """Replica-resident continuous-batching decode engine.

    ``submit()`` is thread-safe and returns immediately; the engine's
    worker thread owns the device state and serializes prefill and
    decode.  ``result()`` blocks for the full output, ``stream()`` yields
    token chunks as they are produced.  ``model`` must already be on
    ``device`` (CUDA unless ``device="cpu"``)."""

    # Registry size bound: evict consumed finished requests past LIMIT,
    # down to FLOOR (an undrained streaming request is never dropped).
    REGISTRY_LIMIT = 4096
    REGISTRY_FLOOR = 2048

    def __init__(self, model, *, max_slots: int = 8, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_ctx: Optional[int] = None, chunk_tokens: int = 8,
                 start: bool = True, device=None):
        self.device = resolve_device(device)
        param_device = next(model.parameters()).device
        if param_device != self.device:
            raise ValueError(f"the model is on {param_device} but the engine "
                             f"runs on {self.device}")
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
        shape = (self.num_layers, num_pages, self.page_size,
                 self.kv_heads, self.head_dim)
        self._k_pages = torch.zeros(shape, dtype=self.dtype,
                                    device=self.device)
        self._v_pages = torch.zeros(shape, dtype=self.dtype,
                                    device=self.device)

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
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="llm_engine")
            self._thread.start()

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
        with self._cond:
            if self._closed:
                raise EngineClosedError("engine is closed")
            rid = self._next_id
            self._next_id += 1
            req = _Request(rid, prompt, max_new_tokens, eos_id,
                           sampling=sampling)
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

    def stats(self) -> Dict[str, object]:
        """Counters of the engine.  ``decode_seconds`` and
        ``prefill_seconds`` are host wall time around the steps, each of
        which ends by reading its sampled tokens back (a device sync)."""
        with self._lock:
            n_active = int(self._active.sum())
            s = dict(self._stats)
            n_pending = len(self._pending)
        pool = self.pool.stats()
        steps = s.get("steps", 0)
        return {
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
            "prefill_tokens": s.get("prefill_tokens", 0),
            "decode_seconds": self._decode_s,
            "prefill_seconds": self._prefill_s,
        }

    def close(self, timeout: float = 10.0):
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        err = EngineClosedError("engine closed with requests in flight")
        for req in list(self._requests.values()):
            if not req.done.is_set():
                req.finish(error=err)

    # ------------------------------------------------------------------
    # engine loop (the worker thread owns the device state)
    # ------------------------------------------------------------------
    def _loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            while True:
                with self._cond:
                    while (not self._closed and not self._pending
                           and not self._active.any()):
                        self._cond.wait(0.2)
                    if self._closed:
                        return
                try:
                    self._admit()
                    self._grow()
                    if self._active.any():
                        self._decode_once()
                except BaseException as e:  # noqa: BLE001 — fail per request
                    self._fail_all(e)
                    return

    def _fail_all(self, e: BaseException):
        with self._lock:
            self._closed = True  # a dead loop must reject new submits
        for req in list(self._requests.values()):
            if not req.done.is_set():
                req.finish(error=e)
        for s in range(self.max_slots):
            if self._slot_pages[s]:
                self.pool.free(self._slot_pages[s])
                self._slot_pages[s] = []
        self._active[:] = False

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _admit(self):
        """Token-boundary admission: fill free slots from the pending
        queue, one full prefill each.  Requires prompt pages + 1 free so
        the first decode token cannot force a preemption at once.  The
        JAX engine also looks up the prefix cache and may offload the
        prefill to prefill replicas here; those branches are still to be
        ported."""
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
                free = [s for s in range(self.max_slots)
                        if not self._active[s]]
                if not free:
                    return
                pages = self.pool.alloc(need + 1)
                if pages is None:
                    return  # pool too tight right now; retry next boundary
                self.pool.free(pages[need:])  # only reserve the +1 headroom
                pages = pages[:need]
                self._pending.popleft()
                slot = free[0]
                mid_batch = bool(self._active.any())
            self._slot_pages[slot] = pages
            row = np.zeros((self.pages_per_slot,), np.int64)
            row[:need] = pages
            self._table[slot] = row
            nxt = self._prefill(slot, req, ctx)
            self._finish_admission(slot, req, p, nxt, mid_batch)

    def _bucket_for(self, p: int) -> int:
        b = 8
        while b < p:
            b <<= 1
        return min(b, self.max_ctx)

    def _prefill(self, slot: int, req: _Request, ctx: List[int]) -> int:
        """Full-context prefill (empty cache) of ``ctx``, padded to its
        power-of-two bucket, into the slot's pages; returns the sampled
        token at absolute position p = len(ctx)."""
        t0 = time.perf_counter()
        dev, ps = self.device, self.page_size
        p = len(ctx)
        bucket = self._bucket_for(p)
        toks = np.zeros((bucket,), np.int64)
        toks[:p] = ctx
        ids = torch.from_numpy(toks).to(dev)[None]
        t = torch.arange(bucket, device=dev)
        empty = [(torch.zeros((1, 0, self.kv_heads, self.head_dim),
                              dtype=self.dtype, device=dev),) * 2
                 for _ in range(self.num_layers)]
        logits, new_kvs = self._model(
            ids, t[None], empty, torch.zeros((1,), dtype=torch.long,
                                             device=dev))
        s = req.sampling
        nxt = sample_tokens(
            logits[0, p - 1][None], torch.tensor([p], device=dev),
            torch.tensor([s.temperature], device=dev),
            torch.tensor([s.top_p], device=dev),
            torch.tensor([s.seed], device=dev))
        row = torch.from_numpy(self._table[slot]).to(dev)
        page_idx = torch.where(t < p, row[t // ps], 0)
        newk = torch.stack([nk[0][0] for nk in new_kvs])  # [L,bkt,Hkv,D]
        newv = torch.stack([nk[1][0] for nk in new_kvs])
        self._write_kv(page_idx[None], (t % ps)[None], newk, newv)
        nxt = int(nxt[0])  # reads back: the prefill is done on the device
        self._stats["prefills"] += 1
        self._stats["prefill_tokens"] += p
        self._prefill_s += time.perf_counter() - t0
        return nxt

    def _write_kv(self, page_idx, off, newk, newv):
        """Write [L, N, Hkv, D] K/V rows at (page_idx[N], off[N]) of every
        layer's pages, in place."""
        layers = torch.arange(self.num_layers, device=self.device)[:, None]
        self._k_pages.index_put_((layers, page_idx, off),
                                 newk.to(self.dtype))
        self._v_pages.index_put_((layers, page_idx, off),
                                 newv.to(self.dtype))

    def _finish_admission(self, slot: int, req: _Request, p: int,
                          next_tok: int, mid_batch: bool):
        """The slot's KV covers positions [0, p) and ``next_tok`` is the
        sampled token at p."""
        s = req.sampling
        self._stats["admitted"] += 1
        if mid_batch:
            self._stats["admitted_mid_batch"] += 1
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
        self._append_token(slot, req, next_tok)

    # ------------------------------------------------------------------
    # decode steps
    # ------------------------------------------------------------------
    def _grow(self):
        """Allocate a page for every active slot whose next write crosses
        a page boundary; preempt the youngest other request when the pool
        is dry (recompute preemption)."""
        for slot in range(self.max_slots):
            if not self._active[slot]:
                continue
            pos = int(self._lengths[slot])
            page_needed = min(pos, self.max_ctx - 1) // self.page_size
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

    def _preempt(self, slot: int):
        req = self._slot_req.pop(slot)
        self.pool.free(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._table[slot] = 0
        self._lengths[slot] = 0
        self._stats["preemptions"] += 1
        with self._lock:
            self._active[slot] = False
            self._pending.appendleft(req)  # readmitted first, from context()

    def _decode_once(self):
        """One token for every slot: gather each slot's pages into a
        [L, slots, max_ctx, Hkv, D] view (rows past a slot's length are
        masked by cached_attention), run the model on the last tokens,
        sample, and write the new K/V at each slot's write head."""
        t0 = time.perf_counter()
        dev = self.device
        n_active = int(self._active.sum())
        n, L, ps = self.max_slots, self.num_layers, self.page_size
        table = torch.from_numpy(self._table).to(dev)
        lengths = torch.from_numpy(self._lengths).to(dev)
        active = torch.from_numpy(self._active).to(dev)
        k_cache = self._k_pages[:, table].reshape(
            L, n, self.max_ctx, self.kv_heads, self.head_dim)
        v_cache = self._v_pages[:, table].reshape(
            L, n, self.max_ctx, self.kv_heads, self.head_dim)
        kv = [(k_cache[i], v_cache[i]) for i in range(L)]
        tokens = torch.from_numpy(self._last_tok).to(dev)
        logits, new_kvs = self._model(tokens[:, None], lengths[:, None], kv,
                                      lengths)
        # The generated token sits at absolute position lengths + 1.
        nxt = sample_tokens(logits[:, -1], lengths + 1,
                            torch.from_numpy(self._temps).to(dev),
                            torch.from_numpy(self._top_ps).to(dev),
                            torch.from_numpy(self._seeds).to(dev))
        newk = torch.stack([nk[0][:, 0] for nk in new_kvs])  # [L,n,Hkv,D]
        newv = torch.stack([nk[1][:, 0] for nk in new_kvs])
        page_col = (lengths // ps).clamp_max(self.pages_per_slot - 1)
        page_idx = torch.where(
            active, table[torch.arange(n, device=dev), page_col], 0)
        self._write_kv(page_idx[None], (lengths % ps)[None], newk, newv)
        nxt = nxt.cpu().numpy()
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
            self._append_token(slot, req, tok)

    def _append_token(self, slot: int, req: _Request, tok: int):
        req.out.append(tok)
        finished = (len(req.out) >= req.max_new_tokens
                    or (req.eos_id is not None and tok == req.eos_id))
        if finished:
            self._retire(slot, req)
        elif len(req.out) - req.streamed >= self.chunk_tokens:
            req.chunks.put(req.out[req.streamed:])
            req.streamed = len(req.out)

    def _retire(self, slot: int, req: _Request,
                error: Optional[BaseException] = None):
        self.pool.free(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._table[slot] = 0
        self._lengths[slot] = 0
        self._slot_req.pop(slot, None)
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


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator):
    """flax's lecun_normal: truncated normal (2 std) of variance
    1/fan_in, for a torch Linear weight [out, in]."""
    std = (1.0 / w.shape[1]) ** 0.5 / 0.87962566103423978
    torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                generator=gen)


def build_model(model_kind: str = "gpt2", config_kw: Optional[dict] = None,
                seed: int = 0, device=None):
    """A seeded model for a serving replica, on ``device`` (CUDA unless
    ``device="cpu"``).  The init uses flax's distributions (normal(0.02)
    for ``wte``, normal(0.01) for ``wpe``, lecun-normal Dense kernels,
    zero biases) from a CPU ``torch.Generator``, so every device gets the
    same weights; they are not JAX's values.  ``config_kw`` may hold
    ``tiny=False`` for the full GPT-2 small shape (default: the tiny
    preset), plus any ``GPT2Config`` field."""
    device = resolve_device(device)
    config_kw = dict(config_kw or {})
    if model_kind != "gpt2":
        raise ValueError(f"unknown model_kind {model_kind!r} (the port has "
                         f"gpt2 so far)")
    from ray_tpu_torch.models import GPT2, GPT2Config

    cfg = GPT2Config.tiny(**config_kw) if config_kw.pop("tiny", True) \
        else GPT2Config(**config_kw)
    model = GPT2(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        model.wte.normal_(0.0, 0.02, generator=gen)
        model.wpe.normal_(0.0, 0.01, generator=gen)
        for module in model.modules():
            if isinstance(module, torch.nn.Linear):
                _lecun_normal_(module.weight, gen)
                module.bias.zero_()
    return model.to(device).eval()


class LLMServer:
    """Serve callable hosting one LLMEngine per replica.

    - ``__call__({"tokens": [...], "max_new_tokens": n, "temperature": t,
      "top_p": p, "seed": s, "eos_id": e})`` answers a JSON request with
      ``{"tokens": [...]}``;
    - ``submit_stream``/``next_chunk``: pull-based token streaming.

    Running it as a Serve deployment over the actor runtime, the
    object-plane batch path, speculative decoding, the prefix cache and
    disaggregated prefill are still to be ported."""

    def __init__(self, model_kind: str = "gpt2",
                 config_kw: Optional[dict] = None, seed: int = 0,
                 device=None, **engine_kw):
        model = build_model(model_kind, config_kw, seed, device)
        self.engine = LLMEngine(model, device=device, **engine_kw)

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

    def submit_stream(self, prompt, max_new_tokens: int = 16,
                      eos_id: Optional[int] = None,
                      sampling: Optional[SamplingParams] = None) -> int:
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

    def stats(self) -> dict:
        return self.engine.stats()

    def drain(self):
        """Teardown: close the engine (fails in-flight requests with a
        typed error)."""
        self.engine.close()
        return True
