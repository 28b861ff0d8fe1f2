"""Content-addressed KV prefix cache for the serving engine, the
in-process half (counterpart of ``ray_tpu/serve/prefix_cache.py``).

The KV cache of a token prefix depends only on that prefix (attention is
causal, positions are absolute, and replicas built from one seed hold the
same weights), so a full KV page is an immutable value addressed by the
hash of the token prefix that produced it.

Copied from the JAX package, which the port may not import (the module
there imports no JAX, but it is part of ``ray_tpu``): the key functions
``versioned_namespace``, ``page_key``, ``prefix_page_keys``,
``affinity_key`` and ``rendezvous_pick``, unchanged, so that both packages
give the same key string for the same tokens; and ``PrefixCacheLocal``,
the per-replica host LRU, whose pages here are CPU tensors in the engine's
dtype (numpy has no bf16), so its byte budget counts what the JAX
package's counts.

Not ported: ``PrefixDirectory`` and ``create_directory``, the cluster
half, which need the task/actor runtime (ROADMAP Queue 1 item 1a);
``create_directory`` raises, naming it.
"""
from __future__ import annotations

import collections
import hashlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

# Tokens hashed for the router affinity key.  Any fixed count works (all
# parties just need to agree); one default page is a natural prefix unit.
AFFINITY_PREFIX_TOKENS = 16


def versioned_namespace(base: str, weight_version: int) -> str:
    """Fold the serving weight version into a cache namespace: after a
    hot weight swap every page computed under the old weights becomes
    unaddressable (invalidation by addressing, no sweep)."""
    return f"{base}|wv{int(weight_version)}"


def page_key(namespace: str, tokens) -> str:
    """Content address of the KV page covering ``tokens``: blake2b-160
    over the namespace and the whole token prefix up to the page's end
    (causal attention makes earlier tokens part of the page's value)."""
    h = hashlib.blake2b(digest_size=20)
    h.update(namespace.encode("utf-8"))
    h.update(b"\x00")
    h.update(np.ascontiguousarray(tokens, dtype=np.int32).tobytes())
    return h.hexdigest()


def prefix_page_keys(namespace: str, tokens, page_size: int,
                     max_pages: Optional[int] = None) -> List[str]:
    """Keys for every full page of ``tokens``: key i covers tokens
    ``[0, (i+1)*page_size)``.  ``max_pages`` truncates (admission caps at
    ``(len - 1) // page_size`` so the sampled next token always has at
    least one freshly computed position behind it)."""
    toks = np.ascontiguousarray(tokens, dtype=np.int32)
    n = len(toks) // page_size
    if max_pages is not None:
        n = min(n, max_pages)
    return [page_key(namespace, toks[:(i + 1) * page_size])
            for i in range(n)]


def affinity_key(tokens, n_tokens: int = AFFINITY_PREFIX_TOKENS) -> str:
    """Stable routing key for cache affinity: digest of the first
    ``n_tokens`` tokens (shorter prompts hash what they have)."""
    toks = np.ascontiguousarray(tokens, dtype=np.int32)[:n_tokens]
    return hashlib.blake2b(toks.tobytes(), digest_size=8).hexdigest()


def rendezvous_pick(key: str, candidates: List[str]) -> Optional[int]:
    """Index of the highest-scoring candidate under rendezvous (HRW)
    hashing: every router maps a key to the same replica with no shared
    state."""
    if not candidates:
        return None
    best, best_score = 0, b""
    for i, cand in enumerate(candidates):
        score = hashlib.blake2b((key + "|" + cand).encode("utf-8"),
                                digest_size=8).digest()
        if score > best_score:
            best, best_score = i, score
    return best


class PrefixCacheLocal:
    """Byte-bounded LRU of KV pages in host memory, thread-safe.

    Values are ``(k, v)`` CPU tensors of shape [L, page_size, Hkv, D] in
    the engine's cache dtype: the exact bits the engine snapshotted, which
    its adopt step copies back onto the device."""

    def __init__(self, max_bytes: int = 256 * 1024 * 1024):
        self.max_bytes = int(max_bytes)
        self._entries: "collections.OrderedDict[str, Tuple]" = \
            collections.OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: str):
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry[0], entry[1]

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def put(self, key: str, k, v) -> None:
        nbytes = int(k.nbytes + v.nbytes)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[2]
            self._entries[key] = (k, v, nbytes)
            self._bytes += nbytes
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                _, (_, _, freed) = self._entries.popitem(last=False)
                self._bytes -= freed
                self.evictions += 1

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}


def create_directory(max_entries: int = 4096):
    """The cluster-wide page directory is an actor: it waits for the
    task/actor runtime (ROADMAP Queue 1 item 1a)."""
    raise NotImplementedError(
        "PrefixDirectory / create_directory need the task/actor runtime, "
        "not ported yet (ROADMAP Queue 1 item 1a); use the local "
        "PrefixCacheLocal (LLMEngine(prefix_cache=True))")
