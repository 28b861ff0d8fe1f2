"""Distributed replay plane: sharded prioritized replay whose storage IS
the object plane (counterpart of
``ray_tpu/rllib/execution/replay_plane.py``, copied onto the port's
runtime, ``parallel/flow.py`` and metrics).

What differs from the JAX package: ``sample_stacked`` returns ``[U, B,
...]`` torch tensors on the learner's device, staged in one pinned host
buffer and moved in one copy, and ``run_actor_replay_iter`` draws its
updates' noise from a ``torch.Generator`` seeded with the env-step count
(where the JAX package splits ``PRNGKey(env_steps)``) and sends the
learner's CPU state dict to the workers.  The sharded plane holds each
fragment's refs in the driver until its shard has evicted it (the JAX
plane releases them at the shard's insert ack, before the shard's
borrow pin, which rides another channel, may have reached the owner).  The numpy draws
(``np.random.default_rng(seed)``) are the JAX package's, so the plane's
sampled ids, IS weights and n-step columns are its bit for bit.

The learner-local ``HostReplay`` ring (an earlier dqn.py) made every
rollout transition travel worker -> learner as raw bytes, and sampling
ran serial with SGD on the learner thread.  Here replay becomes a
throughput datapath assembled from planes this repo already has
(pooled shm segments, fragment refs, the flow substrate, the WorkerSet
strike machinery) — the Ray design's canonical object-store workload
(arXiv:1712.05889 §4.2) in the Podracer actor/learner decoupling
(arXiv:2104.06272):

- **Zero-copy insert** — rollout workers ``put_many`` their fixed-shape
  fragment columns (one pooled-segment write; one ``seal_batch`` control
  message) and ship only the REFS.  A :class:`ReplayShard` actor indexes
  and pins refs — payload bytes never enter the shard or the learner's
  insert path.  Eviction is a ref release: the ring slot drops its
  ObjectRef and the store reclaims the segment into the pool.
- **Vectorized priorities** — each shard keeps sum/min segment trees
  over per-transition priorities (leaf = ``slot * frag_len + offset``)
  using the batched ``set_many`` / ``find_prefixsum_idx_many`` ops from
  rllib/utils/replay_buffers.py: one numpy descent per sampled batch,
  one propagation wave per priority-update batch.
- **Two-level sampling, one gather** — a batch draw picks shards by a
  multinomial over their priority masses, then each shard runs an
  in-shard prefix-sum search; the learner resolves every sampled
  fragment column with ONE batched ``get_many`` and assembles
  compile-once ``[B, ...]`` batches (fixed B, stable dtypes — the jit
  signature never changes).
- **Async priority updates** — learner TD errors flow back as coalesced
  batches on a bounded ``flow.Stage`` sink: pending updates merge into
  one RPC per shard per send, the bounded queue backpressures a learner
  that outruns the plane, and updates addressed to evicted slots are
  dropped by a per-slot sequence check (staleness-tolerant by design).
- **Weight-version stamps** — every fragment carries the weights version
  it was acted under (the rollout plane's stamp); sampled batches expose
  per-row versions and a ``max_weight_staleness`` gate masks over-stale
  rows' importance weights to zero without changing the batch shape.
- **Gather/SGD overlap** — :meth:`ReplayPlane.prefetch` returns a
  ``flow.Stage`` that keeps K gathered batches in flight, so the
  gather + host assembly of batch i+1 runs while the learner's SGD step
  consumes batch i (wall stamps in ``sample_stamps``).
- **Shard death** — shards live behind the existing WorkerSet strike
  machinery: a failed RPC strikes the shard, a struck-out shard is
  replaced (empty) and the missing draw mass is re-spread over the
  survivors, so sampling degrades gracefully and the learner never
  loses a step.

``ReplayPlane(num_shards=0)`` is the LOCAL single-shard mode: the same
:class:`ShardCore` runs in-process and payload tokens are the fragment
column dicts themselves — this replaces ``HostReplay`` so DQN/SAC/TD3
actor modes share one replay implementation (and the RLHF loop can
reuse the plane for preference data).
"""
from __future__ import annotations

import collections
import queue as _queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.parallel.flow import CancellationToken, Stage, Window
from ray_tpu_torch.rllib.utils.replay_buffers import (
    MinSegmentTree,
    SumSegmentTree,
)

__all__ = [
    "LEARNER_COLS",
    "ReplayBatch",
    "ReplayPlane",
    "ReplayShard",
    "ShardCore",
    "compute_nstep",
    "run_actor_replay_iter",
]

# The canonical learner minibatch schema (what the TD/actor-critic losses
# consume).  n_step > 1 adds a "discounts" column (gamma^m * (1 - done)).
LEARNER_COLS = ("obs", "actions", "rewards", "next_obs", "dones")

_CLOSE = object()  # priority-update queue end-of-stream sentinel


# ---------------------------------------------------------------------------
# n-step returns at insert, from fragment contiguity
# ---------------------------------------------------------------------------

def compute_nstep(batch: Dict[str, np.ndarray], num_envs: int,
                  gamma: float, n_step: int) -> Dict[str, np.ndarray]:
    """Fold n-step returns into a raw transition fragment.

    ``batch`` holds flat row-major columns where row ``t * num_envs + e``
    is env ``e``'s transition at fragment step ``t`` (the
    OffPolicyRolloutWorker layout), so step t's successor sits exactly
    ``num_envs`` rows ahead — fragment contiguity is the whole index
    structure, no episode ids needed.  The horizon truncates at the
    first ``done`` AND at the fragment end (the last rows bootstrap from
    however many steps the fragment still holds).  Returns a new column
    dict: ``rewards`` become the discounted n-step sums, ``next_obs`` /
    ``dones`` move to the horizon end, and a ``discounts`` column
    carries ``gamma^m * (1 - done_m)`` (m = steps actually folded) — the
    exact bootstrap factor for ``target = R + discount * Q(next_obs)``.
    """
    n = len(batch["rewards"])
    N = int(num_envs) if num_envs else 1
    if n % N != 0:
        raise ValueError(f"fragment of {n} rows is not divisible by "
                         f"num_envs={N}")
    T = n // N
    r = np.asarray(batch["rewards"], np.float64).reshape(T, N)
    d = np.asarray(batch["dones"], np.float64).reshape(T, N)
    next_obs = np.asarray(batch["next_obs"])
    next_obs = next_obs.reshape((T, N) + next_obs.shape[1:])

    R = r.copy()
    nxt = next_obs.copy()
    dfin = d.copy()
    m_steps = np.ones((T, N))
    open_ = 1.0 - d          # horizon still open after folding step t
    gamma_pow = 1.0
    for k in range(1, int(n_step)):
        gamma_pow *= gamma
        ext = open_[:T - k] if T - k > 0 else open_[:0]
        if ext.size == 0:
            break
        R[:T - k] += ext * gamma_pow * r[k:]
        sel = ext > 0
        nxt[:T - k][sel] = next_obs[k:][sel]
        dfin[:T - k][sel] = d[k:][sel]
        m_steps[:T - k] += ext
        new_open = np.zeros_like(open_)
        new_open[:T - k] = ext * (1.0 - d[k:])
        open_ = new_open

    out = dict(batch)
    out["rewards"] = R.reshape(n).astype(np.float32)
    out["next_obs"] = nxt.reshape((n,) + next_obs.shape[2:])
    out["dones"] = dfin.reshape(n).astype(np.float32)
    out["discounts"] = ((gamma ** m_steps) * (1.0 - dfin)).reshape(n) \
        .astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# ShardCore: ring of fragment slots + vectorized priority trees
# ---------------------------------------------------------------------------

class ShardCore:
    """One replay shard: a ring of fixed-shape fragment slots plus
    vectorized sum/min segment trees over per-transition priorities.

    The core never touches payload bytes: each slot holds an opaque
    payload token — the fragment's column dict in local mode, a
    ``{col: ObjectRef}`` dict in the distributed plane — and the
    priority leaf for transition ``(slot, offset)`` is
    ``slot * frag_len + offset``.  Sampling and priority updates run the
    batched tree ops; a per-slot sequence number makes late priority
    updates addressed to an evicted slot drop silently."""

    def __init__(self, capacity: int, alpha: float = 0.0, seed: int = 0,
                 eps: float = 1e-6):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.alpha = float(alpha)
        self.eps = float(eps)
        self.rng = np.random.default_rng(seed)
        self.frag_len: Optional[int] = None
        self.num_slots = 0
        self.slots: List[Optional[Dict[str, Any]]] = []
        self.slot_seq: Optional[np.ndarray] = None
        self._sum: Optional[SumSegmentTree] = None
        self._min: Optional[MinSegmentTree] = None
        self.cursor = 0
        self.size = 0
        self.max_priority = 1.0
        self.inserts = 0
        self.evictions = 0
        self.stale_updates = 0

    def _init_layout(self, frag_len: int) -> None:
        self.frag_len = L = int(frag_len)
        self.num_slots = S = max(1, self.capacity // L)
        leaves = 1
        while leaves < S * L:
            leaves *= 2
        self._sum = SumSegmentTree(leaves)
        self._min = MinSegmentTree(leaves)
        self.slots = [None] * S
        self.slot_seq = np.zeros(S, np.int64)

    @property
    def mass(self) -> float:
        return self._sum.reduce() if self._sum is not None else 0.0

    @property
    def p_min(self) -> float:
        return self._min.reduce() if self._min is not None else float("inf")

    def insert_fragment(self, payload: Any, n: int, version: int = 0,
                        priorities: Optional[np.ndarray] = None) -> Any:
        """Index one fragment at the ring cursor.  Returns the evicted
        slot's payload token (None when the ring isn't full yet) so the
        caller can release it — in the distributed shard that drop IS
        the object-store eviction."""
        n = int(n)
        if self.frag_len is None:
            self._init_layout(n)
        if n != self.frag_len:
            raise ValueError(
                f"fragment of {n} rows in a shard laid out for "
                f"fixed-shape fragments of {self.frag_len} — the plane "
                "requires one fragment shape per buffer")
        slot = self.cursor
        evicted = self.slots[slot]
        self.slots[slot] = {"payload": payload, "version": int(version),
                            "n": n}
        self.slot_seq[slot] += 1
        if priorities is None:
            p = np.full(n, self.max_priority, np.float64)
        else:
            p = np.maximum(np.asarray(priorities, np.float64), self.eps)
            if p.shape != (n,):
                raise ValueError(f"priorities shape {p.shape} != ({n},)")
            self.max_priority = max(self.max_priority, float(p.max()))
        pa = p ** self.alpha
        base = slot * self.frag_len
        leaf_idx = np.arange(base, base + n, dtype=np.int64)
        self._sum.set_many(leaf_idx, pa)
        self._min.set_many(leaf_idx, pa)
        if evicted is None:
            self.size += n
        else:
            self.evictions += 1
        self.cursor = (slot + 1) % self.num_slots
        self.inserts += 1
        return None if evicted is None else evicted["payload"]

    def sample_rows(self, k: int,
                    uniforms: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Draw ``k`` rows proportional to priority mass (one vectorized
        prefix-sum descent).  Returns per-row slot/offset/leaf/seq/p/
        version arrays plus the payload token of every touched slot —
        the shape both the local plane and the shard actor reply with."""
        total = self.mass
        if k <= 0 or total <= 0.0 or self.size == 0:
            z = np.zeros(0, np.int64)
            return {"slot": z, "offset": z, "leaf": z, "seq": z,
                    "p": np.zeros(0, np.float64), "version": z,
                    "total": total, "p_min": self.p_min, "size": self.size,
                    "payloads": {}}
        u = self.rng.random(k) if uniforms is None else \
            np.asarray(uniforms, np.float64)
        leaves = self._sum.find_prefixsum_idx_many(u * total)
        pa = self._sum.value_many(leaves)
        bad = (pa <= 0.0) | (leaves >= self.num_slots * self.frag_len)
        if bad.any():
            # Float boundary landed in a zero-width (unoccupied) leaf:
            # re-route those lanes uniformly over the occupied prefix.
            leaves[bad] = self.rng.integers(0, self.size, int(bad.sum()))
            pa = self._sum.value_many(leaves)
        slot = leaves // self.frag_len
        offset = leaves % self.frag_len
        versions = np.array([self.slots[int(s)]["version"] for s in slot],
                            np.int64)
        uniq = np.unique(slot)
        payloads = {int(s): self.slots[int(s)]["payload"] for s in uniq}
        return {"slot": slot, "offset": offset, "leaf": leaves,
                "seq": self.slot_seq[slot].copy(), "p": pa,
                "version": versions, "total": total, "p_min": self.p_min,
                "size": self.size, "payloads": payloads}

    def update_priorities(self, leaves: np.ndarray, seqs: np.ndarray,
                          priorities: np.ndarray) -> int:
        """Batched priority write; rows whose slot was re-used since the
        sample (sequence mismatch) are dropped — late updates are
        expected under async flow, not an error.  Returns applied count."""
        if self._sum is None:
            return 0
        leaves = np.asarray(leaves, np.int64)
        seqs = np.asarray(seqs, np.int64)
        p = np.asarray(priorities, np.float64)
        ok = self.slot_seq[leaves // self.frag_len] == seqs
        self.stale_updates += int((~ok).sum())
        if not ok.any():
            return 0
        p = np.maximum(p[ok], self.eps)
        pa = p ** self.alpha
        self._sum.set_many(leaves[ok], pa)
        self._min.set_many(leaves[ok], pa)
        self.max_priority = max(self.max_priority, float(p.max()))
        return int(ok.sum())

    def stats(self) -> Dict[str, Any]:
        return {
            "size": self.size,
            "capacity": self.capacity,
            "fill": self.size / self.capacity if self.capacity else 0.0,
            "mass": self.mass,
            "inserts": self.inserts,
            "evictions": self.evictions,
            "stale_updates": self.stale_updates,
            "max_priority": self.max_priority,
        }


# ---------------------------------------------------------------------------
# ReplayShard: the thin actor over ShardCore
# ---------------------------------------------------------------------------

@ray_tpu_torch.remote
class ReplayShard:
    """Thin actor wrapper: indexes fragment REFS (pinning them via the
    borrower protocol) and answers priority-ordered draws.  Payload bytes
    never enter this process — insert is ref bookkeeping, eviction drops
    the evicted slot's refs so the store reclaims the segments."""

    def __init__(self, capacity: int, alpha: float = 0.0, seed: int = 0,
                 shard_index: int = 0):
        self.core = ShardCore(capacity, alpha=alpha, seed=seed)
        self.shard_index = int(shard_index)

    def ping(self):
        return "ok"

    def pid(self):
        import os

        return os.getpid()

    def close(self):
        """Nothing to close (``WorkerSet.stop`` asks every actor first)."""
        return True

    def insert(self, refs: Dict[str, Any], n: int, version: int = 0,
               priorities=None) -> Dict[str, Any]:
        # The evicted {col: ref} dict goes out of scope right here — the
        # deserialized ObjectRefs' finalizers release this process's
        # borrows, which IS the eviction.
        evicted = self.core.insert_fragment(refs, n, version, priorities)
        if evicted is not None:
            del evicted
            # Push the deferred ref releases out now instead of at the
            # gc thread's next wakeup: eviction should return segments
            # to the store pool before the NEXT insert's bytes arrive
            # (bounded store residency; run_replay_smoke pins this).
            from ray_tpu_torch._private.worker import global_worker

            try:
                global_worker._drain_ref_gc_queue()
            except Exception:
                pass
        return {"mass": self.core.mass, "size": self.core.size,
                "p_min": self.core.p_min}

    def sample(self, k: int) -> Dict[str, Any]:
        return self.core.sample_rows(int(k))

    def update_priorities(self, leaves, seqs, priorities) -> int:
        return self.core.update_priorities(leaves, seqs, priorities)

    def stats(self) -> Dict[str, Any]:
        out = self.core.stats()
        out["shard"] = self.shard_index
        return out


class _ShardSetConfig:
    """Minimal config shim so shards ride WorkerSet's strike/replacement
    machinery (the only field WorkerSet reads with a factory)."""

    def __init__(self, n: int):
        self.num_rollout_workers = n


# ---------------------------------------------------------------------------
# ReplayBatch
# ---------------------------------------------------------------------------

class ReplayBatch:
    """One assembled ``[B, ...]`` learner batch.

    ``data`` maps column name -> np.ndarray; ``weights`` are the
    importance-sampling weights (all-ones in uniform mode; zeroed for
    rows failing the staleness gate); ``ids`` is ``[B, 3]`` int64
    ``(shard, leaf, seq)`` — the opaque handle update_priorities takes;
    ``versions`` are the per-row weight-version stamps."""

    __slots__ = ("data", "weights", "ids", "versions")

    def __init__(self, data, weights, ids, versions):
        self.data = data
        self.weights = weights
        self.ids = ids
        self.versions = versions

    def __getitem__(self, key: str) -> np.ndarray:
        return self.data[key]

    def __contains__(self, key: str) -> bool:
        return key in self.data

    def __len__(self) -> int:
        return len(self.weights)


def _plane_metrics():
    """Lazy replay_* metric handles (internal_kv needs a live driver)."""
    from ray_tpu_torch.util.metrics import Gauge, Histogram, Meter

    return {
        "inserts": Meter("replay_inserts_total",
                         "fragments indexed by the replay plane"),
        "insert_rows": Meter("replay_insert_rows_total",
                             "transitions indexed by the replay plane"),
        "samples": Meter("replay_samples_total",
                         "batches sampled from the replay plane"),
        "sample_rows": Meter("replay_sample_rows_total",
                             "transitions sampled from the replay plane"),
        "stale_rows": Meter("replay_stale_rows_total",
                            "sampled rows masked by the staleness gate"),
        "fill": Gauge("replay_shard_fill",
                      "per-shard fill fraction", tag_keys=("shard",)),
        "mass": Gauge("replay_shard_priority_mass",
                      "per-shard total priority mass",
                      tag_keys=("shard",)),
        "upd_lag": Histogram(
            "replay_priority_update_lag_s",
            "enqueue-to-apply lag of async priority updates",
            boundaries=(0.001, 0.01, 0.1, 1.0, 10.0)),
    }


class _DeviceStaging:
    """One host buffer that numpy columns are written into side by side
    (each at an 8-byte-aligned offset) and that reaches the device in ONE
    copy, each column then a view of the copy.  For CUDA the buffer is
    pinned and the copy asynchronous; an event of the copy guards the
    buffer's reuse by the next call."""

    def __init__(self):
        self._buf = None
        self._copied = None  # the last CUDA copy's event

    def to_device(self, arrays: Dict[str, np.ndarray], device=None):
        import torch

        device = torch.device(device or "cpu")
        cuda = device.type == "cuda"
        layout, total = [], 0
        for name, a in arrays.items():
            a = np.ascontiguousarray(a)
            layout.append((name, total, a))
            total += -(-a.nbytes // 8) * 8
        if self._buf is None or self._buf.numel() < total or \
                self._buf.is_pinned() != cuda:
            self._buf = torch.empty(total, dtype=torch.uint8,
                                    pin_memory=cuda)
            self._copied = None
        if self._copied is not None:
            self._copied.synchronize()
        host = self._buf.numpy()
        for _name, off, a in layout:
            host[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        if cuda:
            moved = self._buf[:total].to(device, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record()
        else:
            moved = self._buf[:total].clone()
        return {name: moved[off:off + a.nbytes].view(
                    torch.from_numpy(a[:0]).dtype).view(a.shape)
                for name, off, a in layout}


# ---------------------------------------------------------------------------
# ReplayPlane
# ---------------------------------------------------------------------------

class ReplayPlane:
    """User-facing replay handle — local single-shard or sharded on the
    object plane.  See the module docstring for the architecture."""

    def __init__(self, capacity: int, num_shards: int = 0,
                 alpha: float = 0.0, beta: float = 0.4, seed: int = 0,
                 n_step: int = 1, gamma: float = 0.99,
                 max_weight_staleness: Optional[int] = None,
                 insert_window: int = 4, update_depth: int = 4,
                 eps: float = 1e-6):
        self.capacity = int(capacity)
        self.num_shards = int(num_shards)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.n_step = int(n_step)
        self.gamma = float(gamma)
        self.max_weight_staleness = max_weight_staleness
        self._learner_version: Optional[int] = None
        self._np_rng = np.random.default_rng(seed)
        self._lock = threading.RLock()
        self._metrics = None
        self._metrics_dead = False
        self.gather_calls = 0          # batched get_many gathers issued
        self.sample_stamps: List[Tuple[float, float]] = []  # (t0, t1)
        self.stale_rows = 0
        self._closed = False
        self._staging: Optional[_DeviceStaging] = None

        self._core: Optional[ShardCore] = None
        self._shard_set = None
        self._insert_windows: List[Window] = []
        self._route_i = 0
        self._masses: Optional[np.ndarray] = None
        self._sizes: Optional[np.ndarray] = None
        self._p_mins: Optional[np.ndarray] = None
        self._upd_q: Optional[_queue.Queue] = None
        self._upd_stage: Optional[Stage] = None
        self._upd_token: Optional[CancellationToken] = None

        if self.num_shards <= 0:
            self._core = ShardCore(capacity, alpha=alpha, seed=seed,
                                   eps=eps)
        else:
            from ray_tpu_torch.rllib.evaluation.worker_set import WorkerSet

            self._per_shard = per_shard = max(1, self.capacity
                                              // self.num_shards)

            def factory(i):
                return ReplayShard.options(max_restarts=1).remote(
                    per_shard, alpha, seed + 7919 * i, i)

            self._shard_set = WorkerSet(_ShardSetConfig(self.num_shards),
                                        None, worker_factory=factory)
            self._insert_windows = [Window(max(1, insert_window))
                                    for _ in range(self.num_shards)]
            self._held = [collections.deque()
                          for _ in range(self.num_shards)]
            self._masses = np.zeros(self.num_shards)
            self._sizes = np.zeros(self.num_shards, np.int64)
            self._p_mins = np.full(self.num_shards, np.inf)
            self._upd_q = _queue.Queue(maxsize=max(1, update_depth))

    # ---- mode / config plumbing -----------------------------------------
    @classmethod
    def from_config(cls, cfg, seed: Optional[int] = None) -> "ReplayPlane":
        """Build from an AlgorithmConfig's replay knobs (getattr-guarded
        so older config objects keep working)."""
        prioritized = bool(getattr(cfg, "replay_prioritized", False))
        return cls(
            capacity=getattr(cfg, "buffer_size", 50_000),
            num_shards=int(getattr(cfg, "replay_num_shards", 0)),
            alpha=(float(getattr(cfg, "replay_alpha", 0.6))
                   if prioritized else 0.0),
            beta=float(getattr(cfg, "replay_beta", 0.4)),
            seed=int(seed if seed is not None else getattr(cfg, "seed", 0)),
            n_step=int(getattr(cfg, "n_step", 1)),
            gamma=float(getattr(cfg, "gamma", 0.99)),
            max_weight_staleness=getattr(cfg, "replay_max_weight_staleness",
                                         None),
        )

    @property
    def distributed(self) -> bool:
        return self._shard_set is not None

    @property
    def size(self) -> int:
        if self._core is not None:
            return self._core.size
        with self._lock:
            self._sync_inserts()
            return int(self._sizes.sum())

    @property
    def mass(self) -> float:
        if self._core is not None:
            return self._core.mass
        with self._lock:
            self._sync_inserts()
            return float(self._masses.sum())

    def note_weights_version(self, version: int) -> None:
        """Record the learner's current weights version — the reference
        point for the max_weight_staleness gate on sampled rows."""
        self._learner_version = int(version)

    # ---- metrics ---------------------------------------------------------
    def _m(self):
        if self._metrics_dead:
            return None
        if self._metrics is None:
            try:
                self._metrics = _plane_metrics()
            except Exception:
                self._metrics_dead = True
        return self._metrics

    def _mark(self, key: str, value: float = 1.0) -> None:
        m = self._m()
        if m is None:
            return
        try:
            m[key].mark(value)
        except Exception:
            self._metrics_dead = True

    def _export_shard_gauges(self, i: int, size: int, mass: float) -> None:
        m = self._m()
        if m is None:
            return
        try:
            per = (self.capacity // self.num_shards
                   if self.distributed else self.capacity) or 1
            tags = {"shard": str(i)}
            m["fill"].set(min(1.0, size / per), tags)
            m["mass"].set(float(mass), tags)
        except Exception:
            self._metrics_dead = True

    def flush_metrics(self) -> None:
        """Force pending Meter marks into the KV (tests / shutdown)."""
        m = self._m()
        if m is None:
            return
        for h in m.values():
            if hasattr(h, "flush"):
                try:
                    h.flush()
                except Exception:
                    pass
        if self._core is not None:
            self._export_shard_gauges(0, self._core.size, self._core.mass)

    # ---- insert ----------------------------------------------------------
    def insert(self, batch: Dict[str, np.ndarray],
               priorities: Optional[np.ndarray] = None, version: int = 0,
               num_envs: Optional[int] = None) -> None:
        """Index one rollout fragment.  Local mode keeps the column dict
        as the payload (no copy); distributed mode publishes the columns
        with ONE ``put_many`` burst and ships the refs to a shard.
        ``num_envs`` gives the row layout for n-step folding."""
        if self.n_step > 1:
            batch = compute_nstep(batch, num_envs or 1, self.gamma,
                                  self.n_step)
        n = len(batch["rewards"])
        if self._core is not None:
            with self._lock:
                self._core.insert_fragment(dict(batch), n, version,
                                           priorities)
                self._export_shard_gauges(0, self._core.size,
                                          self._core.mass)
        else:
            cols = sorted(batch)
            refs = ray_tpu_torch.put_many([np.ascontiguousarray(batch[c])
                                     for c in cols])
            self.insert_refs(dict(zip(cols, refs)), n, version, priorities)
        self._mark("inserts")
        self._mark("insert_rows", n)

    def insert_refs(self, refs: Dict[str, Any], n: int, version: int = 0,
                    priorities: Optional[np.ndarray] = None) -> None:
        """Distributed insert: route a published fragment's refs to a
        shard (round-robin over live shards), bounded in flight per
        shard by a flow.Window of un-harvested acks."""
        if not self.distributed:
            raise RuntimeError("insert_refs needs a sharded plane")
        with self._lock:
            i = self._route_i % self.num_shards
            self._route_i += 1
            shard = self._shard_set.workers[i]
            fut = shard.insert.remote(refs, int(n), int(version), priorities)
            # Hold the refs until the shard has evicted the fragment (its
            # ring of S slots drops fragment k - S at insert k): the
            # shard's borrow pin rides another channel than its insert
            # ack, so releasing at the ack (the JAX package's rule) can
            # free a fragment the shard still indexes, and a later sample
            # then gathers a lost object.
            held = self._held[i]
            held.append(refs)
            while len(held) > max(1, self._per_shard // int(n)) + 1:
                held.popleft()
            win = self._insert_windows[i]
            win.append(fut)
            while win.over_depth:
                self._harvest_insert_ack(i, win.popleft(), block=True)
            self._mark("inserts")
            self._mark("insert_rows", n)

    def _harvest_insert_ack(self, i: int, fut, block: bool) -> None:
        try:
            ack = ray_tpu_torch.get(fut, timeout=60.0 if block else 0.0)
        except ray_tpu_torch.exceptions.RayTpuError:
            self._on_shard_failure(i)
            return
        self._masses[i] = ack["mass"]
        self._sizes[i] = ack["size"]
        self._p_mins[i] = ack["p_min"]
        self._export_shard_gauges(i, ack["size"], ack["mass"])

    def _drain_insert_acks(self) -> None:
        """Poll-harvest landed insert acks (refreshes the shard mass
        snapshot sampling draws from) without blocking."""
        for i, win in enumerate(self._insert_windows):
            while win:
                fut = win.peek()
                try:
                    ready, _ = ray_tpu_torch.wait([fut], num_returns=1,
                                            timeout=0.0)
                except ray_tpu_torch.exceptions.RayTpuError:
                    win.popleft()
                    self._on_shard_failure(i)
                    continue
                if not ready:
                    break
                win.popleft()
                self._harvest_insert_ack(i, fut, block=True)

    def _sync_inserts(self) -> None:
        """Block-harvest every pending insert ack: the authoritative
        size/mass barrier."""
        for i, win in enumerate(self._insert_windows):
            while win:
                self._harvest_insert_ack(i, win.popleft(), block=True)

    def _on_shard_failure(self, i: int) -> None:
        """One strike via the WorkerSet machinery; a struck-out shard is
        replaced by a fresh (empty) one and its mass leaves the draw."""
        replaced = self._shard_set.report_failure_index(i)
        if replaced:
            self._masses[i] = 0.0
            self._sizes[i] = 0
            self._p_mins[i] = np.inf
            self._insert_windows[i].clear()
            self._held[i].clear()
            self._export_shard_gauges(i, 0, 0.0)

    # ---- sampling --------------------------------------------------------
    def sample(self, batch_size: int, beta: Optional[float] = None,
               rng: Optional[np.random.Generator] = None) -> ReplayBatch:
        """One ``[B, ...]`` batch: two-level priority draw resolved with
        ONE batched get_many gather (distributed) or direct views
        (local)."""
        t0 = time.monotonic()
        beta = self.beta if beta is None else float(beta)
        if self._core is not None:
            with self._lock:
                k = int(batch_size)
                u = rng.random(k) if rng is not None else None
                rows = self._core.sample_rows(k, uniforms=u)
                parts = [(0, rows)]
                resolved = {(0, s): p for s, p in rows["payloads"].items()}
                totals = {0: rows["total"]}
                sizes = {0: rows["size"]}
                p_mins = {0: rows["p_min"]}
                batch = self._assemble(parts, resolved, totals, sizes,
                                       p_mins, beta, int(batch_size), rng)
        else:
            batch = self._sample_distributed(int(batch_size), beta, rng)
        t1 = time.monotonic()
        self.sample_stamps.append((t0, t1))
        if len(self.sample_stamps) > 256:
            del self.sample_stamps[:128]
        self._mark("samples")
        self._mark("sample_rows", len(batch))
        return batch

    def _sample_distributed(self, B: int, beta: float,
                            rng: Optional[np.random.Generator]
                            ) -> ReplayBatch:
        gen = rng if rng is not None else self._np_rng
        with self._lock:
            self._drain_insert_acks()
            parts: List[Tuple[int, Dict[str, Any]]] = []
            got = 0
            # Retry rounds: a dead shard's draw mass re-spreads over the
            # survivors so the learner still gets a full batch.
            for _round in range(max(2, self.num_shards + 1)):
                need = B - got
                if need <= 0:
                    break
                masses = np.maximum(self._masses, 0.0)
                total = masses.sum()
                if total <= 0.0:
                    self._refresh_stats()
                    masses = np.maximum(self._masses, 0.0)
                    total = masses.sum()
                    if total <= 0.0:
                        break
                counts = gen.multinomial(need, masses / total)
                futures = [(i, self._shard_set.workers[i].sample.remote(
                    int(c))) for i, c in enumerate(counts) if c > 0]
                for i, fut in futures:
                    try:
                        reply = ray_tpu_torch.get(fut, timeout=60.0)
                    except ray_tpu_torch.exceptions.RayTpuError:
                        self._on_shard_failure(i)
                        continue
                    self._masses[i] = reply["total"]
                    self._sizes[i] = reply["size"]
                    self._p_mins[i] = reply["p_min"]
                    k = len(reply["slot"])
                    if k:
                        parts.append((i, reply))
                        got += k
            if got == 0:
                raise RuntimeError(
                    "replay plane could not sample: no live shard holds "
                    "data (all shards empty or dead)")
            # ONE batched gather for every sampled fragment column.
            resolved: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}
            flat_refs: List[Any] = []
            flat_keys: List[Tuple[int, int, str]] = []
            seen = set()
            for i, reply in parts:
                for s, refdict in reply["payloads"].items():
                    if (i, s) in seen:
                        continue
                    seen.add((i, s))
                    for col, ref in refdict.items():
                        flat_refs.append(ref)
                        flat_keys.append((i, int(s), col))
            values = ray_tpu_torch.get_many(flat_refs, timeout=60.0)
            self.gather_calls += 1
            for (i, s, col), v in zip(flat_keys, values):
                resolved.setdefault((i, s), {})[col] = v
            totals = {i: float(self._masses[i]) for i in
                      range(self.num_shards)}
            sizes = {i: int(self._sizes[i]) for i in range(self.num_shards)}
            p_mins = {i: float(self._p_mins[i]) for i in
                      range(self.num_shards)}
            return self._assemble(parts, resolved, totals, sizes, p_mins,
                                  beta, B, rng)

    def _refresh_stats(self) -> None:
        futures = [(i, w.stats.remote())
                   for i, w in enumerate(self._shard_set.workers)]
        for i, fut in futures:
            try:
                st = ray_tpu_torch.get(fut, timeout=30.0)
            except ray_tpu_torch.exceptions.RayTpuError:
                self._on_shard_failure(i)
                continue
            self._masses[i] = st["mass"]
            self._sizes[i] = st["size"]

    def _assemble(self, parts, resolved, totals, sizes, p_mins, beta, B,
                  rng) -> ReplayBatch:
        """Fuse shard replies + resolved payload columns into one
        compile-once [B, ...] batch (fixed B: short draws — possible only
        after shard loss — pad by resampling assembled rows)."""
        got = sum(len(reply["slot"]) for _i, reply in parts)
        first_payload = next(iter(resolved.values()))
        col_names = [c for c in first_payload if c != "actions_logp"]
        data = {}
        for col in col_names:
            proto = first_payload[col]
            data[col] = np.empty((got,) + proto.shape[1:], proto.dtype)
        ids = np.empty((got, 3), np.int64)
        versions = np.empty(got, np.int64)
        p_all = np.empty(got, np.float64)
        cursor = 0
        for i, reply in parts:
            k = len(reply["slot"])
            sl = slice(cursor, cursor + k)
            slots, offs = reply["slot"], reply["offset"]
            for s in np.unique(slots):
                m = slots == s
                arrs = resolved[(i, int(s))]
                for col in col_names:
                    data[col][sl][m] = arrs[col][offs[m]]
            ids[sl, 0] = i
            ids[sl, 1] = reply["leaf"]
            ids[sl, 2] = reply["seq"]
            versions[sl] = reply["version"]
            p_all[sl] = reply["p"]
            cursor += k
        # IS weights from GLOBAL mass/size/min (uniform mode: all ones).
        total = sum(t for t in totals.values() if np.isfinite(t))
        n_total = sum(sizes.values())
        finite_mins = [v for v in p_mins.values() if np.isfinite(v)]
        if self.alpha == 0.0 or total <= 0.0 or not finite_mins:
            weights = np.ones(got, np.float32)
        else:
            p_min = min(finite_mins)
            max_w = (max(p_min, 1e-12) / total * max(n_total, 1)) ** (-beta)
            weights = ((p_all / total * max(n_total, 1)) ** (-beta)
                       / max_w).astype(np.float32)
        if got < B:
            pad_rng = rng if rng is not None else self._np_rng
            pad = pad_rng.integers(0, got, B - got)
            for col in col_names:
                data[col] = np.concatenate([data[col], data[col][pad]])
            ids = np.concatenate([ids, ids[pad]])
            versions = np.concatenate([versions, versions[pad]])
            weights = np.concatenate([weights, weights[pad]])
        if self.max_weight_staleness is not None and \
                self._learner_version is not None:
            lag = self._learner_version - versions
            stale = lag > self.max_weight_staleness
            n_stale = int(stale.sum())
            if n_stale:
                weights = np.where(stale, 0.0, weights).astype(np.float32)
                self.stale_rows += n_stale
                self._mark("stale_rows", n_stale)
        return ReplayBatch(data, weights, ids, versions)

    def sample_stacked(self, rng, num_batches: int, batch_size: int,
                       device=None, return_ids: bool = False):
        """[U, B, ...] stacked learner minibatches as torch tensors on
        ``device`` (the CPU when None) — the shape the learner's U updates
        take in turn.  ``rng`` (np Generator) drives the draws so
        determinism still flows from the algorithm seed.  The columns go
        to the device in ONE copy (``_DeviceStaging``).  With
        ``return_ids`` the columns also hold the IS ``weights`` [U, B],
        and the result is ``(columns, ids)``, ids the [U, B, 3] numpy
        handles ``update_priorities`` takes."""
        batches = [self.sample(batch_size, rng=rng)
                   for _ in range(num_batches)]
        cols = {c: np.stack([b[c] for b in batches])
                for c in LEARNER_COLS if c in batches[0].data}
        if return_ids:
            cols["weights"] = np.stack([b.weights for b in batches])
        if self._staging is None:
            self._staging = _DeviceStaging()
        stacked = self._staging.to_device(cols, device)
        if return_ids:
            return stacked, np.stack([b.ids for b in batches])
        return stacked

    def prefetch(self, batch_size: int, beta: Optional[float] = None,
                 depth: int = 2) -> Stage:
        """flow.Stage keeping up to ``depth`` gathered batches in flight:
        the gather + host assembly of batch i+1 overlaps the learner's
        SGD on batch i.  Iterate it for batches; ``close()`` to drain."""
        import itertools

        return Stage(itertools.count(),
                     lambda _i: self.sample(batch_size, beta),
                     depth=max(1, depth), workers=1,
                     name="replay_gather")

    # ---- priority updates ------------------------------------------------
    def update_priorities(self, ids: np.ndarray,
                          priorities: np.ndarray) -> None:
        """Feed TD-error priorities back.  Local: direct vectorized
        write.  Distributed: enqueue on the bounded flow.Stage sink —
        pending batches coalesce into one RPC per shard per send, and a
        full queue backpressures the learner."""
        ids = np.asarray(ids, np.int64)
        priorities = np.asarray(priorities, np.float64)
        if ids.size == 0:
            return
        if self._core is not None:
            with self._lock:
                self._core.update_priorities(ids[:, 1], ids[:, 2],
                                             priorities)
            return
        self._ensure_update_stage()
        self._upd_q.put((ids, priorities, time.monotonic()))

    def _ensure_update_stage(self) -> None:
        if self._upd_stage is not None:
            return
        with self._lock:
            if self._upd_stage is not None:
                return
            self._upd_token = CancellationToken()
            q, token = self._upd_q, self._upd_token

            def source():
                while not token.cancelled:
                    try:
                        item = q.get(timeout=0.2)
                    except _queue.Empty:
                        continue
                    if item is _CLOSE:
                        return
                    yield item

            self._upd_stage = Stage(source(), self._send_priority_updates,
                                    depth=1, workers=1, sink=True,
                                    name="replay_prio",
                                    token=self._upd_token)

    def _send_priority_updates(self, first) -> None:
        """Sink fn: coalesce everything queued behind ``first`` into one
        update RPC per shard; harvest acks with strike handling."""
        items = [first]
        while True:
            try:
                nxt = self._upd_q.get_nowait()
            except _queue.Empty:
                break
            if nxt is _CLOSE:
                break
            items.append(nxt)
        ids = np.concatenate([it[0] for it in items])
        prios = np.concatenate([it[1] for it in items])
        oldest = min(it[2] for it in items)
        futures = []
        for i in np.unique(ids[:, 0]):
            m = ids[:, 0] == i
            shard = self._shard_set.workers[int(i)]
            futures.append((int(i), shard.update_priorities.remote(
                ids[m, 1], ids[m, 2], prios[m])))
        for i, fut in futures:
            try:
                ray_tpu_torch.get(fut, timeout=30.0)
            except ray_tpu_torch.exceptions.RayTpuError:
                self._on_shard_failure(i)
        m = self._m()
        if m is not None:
            try:
                m["upd_lag"].observe(time.monotonic() - oldest)
            except Exception:
                self._metrics_dead = True

    # ---- lifecycle / observability --------------------------------------
    def stats(self) -> Dict[str, Any]:
        if self._core is not None:
            out = self._core.stats()
            out.update(num_shards=0, gather_calls=self.gather_calls,
                       stale_rows=self.stale_rows)
            return out
        return {
            "num_shards": self.num_shards,
            "size": self.size,
            "mass": self.mass,
            "per_shard_size": [int(s) for s in self._sizes],
            "per_shard_mass": [float(m) for m in self._masses],
            "gather_calls": self.gather_calls,
            "stale_rows": self.stale_rows,
            "num_healthy_shards": self._shard_set.num_healthy_workers,
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._upd_stage is not None:
            try:
                self._upd_q.put_nowait(_CLOSE)
            except _queue.Full:
                pass
            self._upd_stage.close()
            self._upd_stage = None
        self.flush_metrics()
        if self._shard_set is not None:
            for win, held in zip(self._insert_windows, self._held):
                win.clear()
                held.clear()
            self._shard_set.stop()
            self._shard_set = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# The shared actor-topology iteration for the replay family (DQN/SAC/TD3)
# ---------------------------------------------------------------------------

def run_actor_replay_iter(algo, explore_arg, batch_size, do_updates):
    """ONE shared actor-topology iteration for the replay family
    (DQN/SAC/TD3): harvest transitions from the rollout actors into the
    algorithm's :class:`ReplayPlane`, run the algorithm's updates once
    warm, and assemble the common metrics (reward EMA, worker health).

    Local plane (``replay_num_shards=0``): workers ship raw batches and
    the plane indexes them in-process (the historical HostReplay path,
    one implementation instead of three).  Sharded plane: workers
    ``sample_publish`` fragment refs — bytes go rollout worker -> object
    store -> learner gather, never through the insert path.

    ``do_updates(stacked, generator)`` runs the U updates on the learner's
    device; ``generator`` (on that device, seeded with the env-step
    count) draws their noise.  On a prioritized plane the stacked columns
    carry the IS ``weights``, and the ``priorities`` [U, B] that
    ``do_updates`` may return go back to the plane.  The iteration marks ``algo.on_phase``'s
    "start", "sample" (the transitions inserted), "gather" (the stacked
    batches on the device), "update" (after the updates' metrics' read)
    and "publish" (the learner's CPU state dict at the workers); the last
    three with nothing between them before ``learning_starts``."""
    import torch

    cfg = algo.config
    plane: ReplayPlane = algo._rb
    mark = algo.on_phase or (lambda name: None)
    mark("start")
    metrics: Dict[str, Any] = {}
    steps_this_iter = 0
    if plane.distributed:
        results = algo.workers.publish_sync(explore_arg, cfg.gamma,
                                            plane.n_step)
        returns: List[float] = []
        for refs, meta, completed in results:
            plane.insert_refs(refs, meta["n"],
                              version=meta.get("version", 0))
            steps_this_iter += int(meta["n"])
            returns.extend(completed)
        algo._env_steps += steps_this_iter
    else:
        batches, returns = algo.workers.sample_sync(explore_arg)
        for b in batches:
            plane.insert(b, version=algo.workers.weights_version,
                         num_envs=cfg.num_envs_per_worker)
            n = len(b["rewards"])
            algo._env_steps += n
            steps_this_iter += n
    mark("sample")
    metrics["replay_size"] = plane.size
    if returns:
        mean_r = float(np.mean(returns))
        prev = getattr(algo, "_ep_reward_ema", None)
        algo._ep_reward_ema = (mean_r if prev is None
                               else 0.7 * prev + 0.3 * mean_r)
        metrics["episodes_this_iter"] = len(returns)
    if getattr(algo, "_ep_reward_ema", None) is not None:
        metrics["episode_reward_mean"] = algo._ep_reward_ema
    warm = plane.size >= cfg.learning_starts
    if warm:
        # Algorithms may pin an actor-mode update count (e.g. DQN's
        # replay-ratio-derived default) — num_updates_per_iter's default
        # is tuned for the anakin path's huge batches.
        U = getattr(algo, "_actor_updates", None) or cfg.num_updates_per_iter
        prioritized = plane.alpha > 0.0
        stacked = plane.sample_stacked(algo._host_rng, U, batch_size,
                                       algo.device, return_ids=prioritized)
        if prioritized:
            stacked, ids = stacked
        mark("gather")
        generator = torch.Generator(device=algo.device).manual_seed(
            algo._env_steps)
        metrics.update(do_updates(stacked, generator))
        # A learner that weighs its loss by the IS weights returns each
        # row's new priority (DQN: |TD error|); the JAX package's actor
        # path sends none back.
        priorities = metrics.pop("priorities", None)
        if prioritized and priorities is not None:
            plane.update_priorities(ids.reshape(-1, 3),
                                    priorities.reshape(-1))
        mark("update")
        version = algo.workers.sync_weights(algo._sync_params())
        plane.note_weights_version(version)
        mark("publish")
    else:
        for name in ("gather", "update", "publish"):
            mark(name)
    metrics["num_env_steps_sampled_this_iter"] = steps_this_iter
    metrics["num_healthy_workers"] = algo.workers.num_healthy_workers
    return metrics
