"""Typed config-flag registry with env-var overrides.

Reference: the RAY_CONFIG x-macro registry (src/ray/common/ray_config_def.h
:17-22, 189 flags, overridable per-process via RAY_<name> env vars and the
_system_config dict passed to ray.init).  Same contract here: every
tunable the runtime consults is DECLARED in one table with a type and
default, overridable via ``RAY_TPU_TORCH_<NAME>`` env vars or
``ray_tpu_torch.init(_system_config={...})`` — ad-hoc os.environ.get calls are
the anti-pattern this replaces.

Copied from ``ray_tpu/_private/config.py`` (the JAX package).
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional

_ENV_PREFIX = "RAY_TPU_TORCH_"


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


class _Flag:
    __slots__ = ("name", "type", "default", "doc")

    def __init__(self, name: str, type_: type, default, doc: str):
        self.name = name
        self.type = type_
        self.default = default
        self.doc = doc

    def parse(self, raw: str):
        if self.type is bool:
            return _parse_bool(raw)
        return self.type(raw)


class RayTpuConfig:
    """Singleton flag table (reference: RayConfig, ray_config.h).

    Resolution order per flag: _system_config override > RAY_TPU_TORCH_<NAME>
    env var > declared default.  Values are cached after first read;
    ``reset()`` clears the cache (tests)."""

    def __init__(self):
        self._flags: Dict[str, _Flag] = {}
        self._overrides: Dict[str, Any] = {}
        self._cache: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def declare(self, name: str, type_: type, default, doc: str = ""):
        self._flags[name] = _Flag(name, type_, default, doc)
        return self

    def get(self, name: str):
        with self._lock:
            if name in self._cache:
                return self._cache[name]
            flag = self._flags.get(name)
            if flag is None:
                raise KeyError(f"undeclared config flag {name!r}")
            if name in self._overrides:
                ov = self._overrides[name]
                if isinstance(ov, str):
                    # Strings go through the flag parser — bool('0') would
                    # silently flip a disable into an enable.
                    value = flag.parse(ov)
                elif isinstance(ov, flag.type):
                    value = ov
                else:
                    value = flag.type(ov)
            else:
                raw = os.environ.get(_ENV_PREFIX + name.upper())
                value = flag.parse(raw) if raw is not None else flag.default
            self._cache[name] = value
            return value

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.get(name)

    def apply_system_config(self, overrides: Optional[Dict[str, Any]]):
        if not overrides:
            return
        with self._lock:
            for k, v in overrides.items():
                if k not in self._flags:
                    raise KeyError(f"unknown _system_config flag {k!r}")
                self._overrides[k] = v
            self._cache.clear()

    def reset(self):
        with self._lock:
            self._overrides.clear()
            self._cache.clear()

    def dump(self) -> Dict[str, Any]:
        """Current value of every declared flag (state API / debugging)."""
        return {name: self.get(name) for name in sorted(self._flags)}

    def doc(self, name: str) -> str:
        return self._flags[name].doc


CONFIG = RayTpuConfig()

# ---- the registry (one declaration per tunable; grep for CONFIG.<name>
# to find the consumer) ----
CONFIG \
    .declare("native_store", bool, False,
             "Use the C++ shared-memory arena for driver puts.  Off by "
             "default: the arena path predates the segment-pool + "
             "batched-notify object plane (put_many coalescing, pooled "
             "pre-faulted segments — the measured 7-8 GB/s path) and "
             "bypasses both; opt in only until it learns those "
             "semantics.  (It was also silently disabled for several "
             "rounds by a stale libshm_store.so built against a newer "
             "glibc — the loader now rebuilds from source instead.)") \
    .declare("worker_idle_ttl_s", float, 300.0,
             "Idle pooled workers are reaped after this long.") \
    .declare("max_workers_per_node", int, 64,
             "Worker-process cap per node.") \
    .declare("health_check_period_s", float, 0.5,
             "Worker liveness poll interval in the head monitor.") \
    .declare("spawn_failure_limit", int, 3,
             "Consecutive worker spawn failures before queued work fails.") \
    .declare("object_store_memory", int, 2 * 1024**3,
             "Default per-node store capacity in bytes.") \
    .declare("inline_object_threshold", int, 100 * 1024,
             "Objects <= this many bytes inline in replies/directory.") \
    .declare("transfer_chunk_bytes", int, 4 * 1024 * 1024,
             "Cross-host object transfer chunk size.") \
    .declare("transfer_pipeline_depth", int, 2,
             "Chunks kept in flight per transfer stream (read-next-"
             "while-sending); 0/1 disables pipelining.") \
    .declare("transfer_stripe_ranges", int, 8,
             "Target number of chunk ranges a striped pull splits an "
             "object into (work-stealing granularity across sources).") \
    .declare("transfer_stripe_min_bytes", int, 8 * 1024 * 1024,
             "Objects at least this large use the striped multi-source "
             "pull path; smaller ones keep the single-stream pull.") \
    .declare("transfer_stripe_sources", int, 4,
             "Max concurrent source streams per striped pull.") \
    .declare("transfer_coop_broadcast", bool, True,
             "Receivers advertise partially-pulled objects as chunk-"
             "range sources (dissemination tree for one-to-N broadcast) "
             "and coalesce concurrent same-object pulls.") \
    .declare("segment_pool", bool, True,
             "Recycle shm segments across puts through size-class free "
             "lists instead of create/unlink per object.") \
    .declare("segment_pool_bytes", int, 0,
             "Free-list byte cap of the segment pool (0 = the store's "
             "capacity).") \
    .declare("segment_pool_prewarm", str, "",
             "Comma list of SIZE:COUNT segments to pre-create and "
             "pre-fault in the background at store startup, e.g. "
             "'64MiB:4,8MiB:8'.") \
    .declare("copy_threads", int, 0,
             "Worker threads for large-buffer memcpy in pack_into "
             "(0 = auto: min(4, cpu//2); 1 = single-threaded).") \
    .declare("parallel_copy_min_bytes", int, 8 * 1024 * 1024,
             "Buffers at least this large are copied by the parallel "
             "memcpy pool.") \
    .declare("spill_enabled", bool, True,
             "Spill referenced objects to disk under memory pressure.") \
    .declare("collective_timeout_s", float, 300.0,
             "Actor-collective rendezvous timeout.") \
    .declare("serve_control_interval_s", float, 1.0,
             "Serve controller reconcile period.") \
    .declare("serve_max_slots", int, 8,
             "LLM engine decode-batch slots per replica (the compiled "
             "decode step's fixed batch dimension).") \
    .declare("serve_page_size", int, 16,
             "Tokens per KV-cache page in the LLM engine's paged pool.") \
    .declare("serve_spec_tokens", int, 0,
             "Speculative-decode window (tokens verified per target "
             "step; >= 2 with a draft model, 0 = plain decode).") \
    .declare("serve_prefill_min_tokens", int, 32,
             "Uncached-tail length at which an admission is offloaded "
             "to a disaggregated prefill replica.") \
    .declare("serve_prefix_cache_bytes", int, 256 * 1024 * 1024,
             "Per-replica host LRU budget for prefix-cache KV pages.") \
    .declare("tcp_host", str, "127.0.0.1",
             "Head TCP bind host (0.0.0.0 to accept remote nodes).") \
    .declare("chaos_delay_us", int, 0,
             "Chaos: max random delay injected at instrumented points.") \
    .declare("scheduler_spread_threshold", float, 0.5,
             "Hybrid policy: node load ratio above which tasks spread.") \
    .declare("task_event_buffer_size", int, 10000,
             "Max task events retained for the state API.") \
    .declare("gcs_snapshot_period_s", float, 0.0,
             "Persist GCS tables every N seconds (0 = disabled).") \
    .declare("tracing_enabled", bool, False,
             "Instrument task submit/execute with OpenTelemetry spans "
             "(API-only; wire a TracerProvider to export).") \
    .declare("tracing_buffer_size", int, 4096,
             "Capacity of the per-process span ring buffer "
             "(drop-oldest; drops counted in "
             "tracing_spans_dropped_total).") \
    .declare("trace_store_max_bytes", int, 32 * 1024 * 1024,
             "Head-side TraceStore global byte budget; whole traces "
             "are evicted LRU past this.") \
    .declare("trace_max_bytes", int, 2 * 1024 * 1024,
             "Per-trace byte budget in the head TraceStore; excess "
             "spans within one trace are dropped and counted.") \
    .declare("flight_record_dir", str, "",
             "Crash flight-recorder bundle directory (also "
             "RAY_TPU_TORCH_FLIGHT_RECORD_DIR); empty disables postmortem "
             "bundles.") \
    .declare("flight_record_max", int, 16,
             "Max flight-record bundles kept; oldest pruned.") \
    .declare("memory_usage_threshold", float, 0.95,
             "Host/cgroup memory fraction above which the monitor kills "
             "a worker (reference: memory_usage_threshold).") \
    .declare("memory_monitor_refresh_ms", int, 250,
             "Memory-pressure check period (0 disables the monitor; "
             "reference: memory_monitor_refresh_ms).") \
    .declare("worker_killing_policy", str, "retriable_lifo",
             "OOM victim selection: retriable_lifo | group_by_owner "
             "(reference default: ray_config_def.h:103).") \
    .declare("memory_monitor_test_file", str, "",
             "Test hook: read usage fraction from this file instead of "
             "/proc (mirrors the reference's fake-memory test mode).") \
    .declare("node_stats_period_s", float, 2.0,
             "Per-node cpu/mem/store usage snapshot period "
             "(0 disables; reference: the dashboard reporter agent).") \
    .declare("direct_transport", bool, True,
             "Push tasks/actor calls directly to workers over cached "
             "leases, bypassing the head on the hot path (reference: "
             "direct_task_transport.h lease caching).") \
    .declare("lease_idle_s", float, 0.5,
             "Return an idle worker lease to the head after this long.") \
    .declare("reconnect_window_s", float, 30.0,
             "How long agents/workers/drivers retry reconnecting to a "
             "restarted head before giving up (reference: the GCS "
             "reconnect window, ray_config_def.h:58-62).") \
    .declare("rpc_timeout", float, 0.0,
             "Default overall deadline (seconds) for control-plane "
             "requests without an explicit timeout; 0 keeps blocking "
             "semantics unbounded (lost replies still recover via "
             "per-attempt resends).  Env: RAY_TPU_TORCH_RPC_TIMEOUT.") \
    .declare("rpc_attempt_timeout", float, 15.0,
             "Per-attempt reply wait before a pending request frame is "
             "resent (idempotency keys + the head reply cache make the "
             "resend exactly-once).") \
    .declare("rpc_retry_base_s", float, 0.05,
             "Base backoff between RPC retry attempts (exponential, "
             "jittered, capped at rpc_retry_cap_s).") \
    .declare("rpc_retry_cap_s", float, 2.0,
             "Backoff cap between RPC retry attempts.") \
    .declare("rpc_acked_ops", bool, False,
             "Route one-way notifies/submits through acked, idempotency-"
             "keyed requests so dropped frames are retried (auto-enabled "
             "while RAY_TPU_TORCH_TESTING_NET_SCHEDULE is set).") \
    .declare("rpc_reply_cache_size", int, 1024,
             "Head-side idempotency reply-cache entries (exactly-once "
             "dedup window for retried/duplicated frames).") \
    .declare("rpc_reply_cache_ttl_s", float, 300.0,
             "Reply-cache entries are evictable this long after their "
             "reply was recorded.") \
    .declare("rpc_hang_dump_s", float, 120.0,
             "The RPC watchdog dumps the blocked thread's stack for any "
             "in-flight call older than this (0 disables dumps).") \
    .declare("rpc_watchdog_interval_s", float, 1.0,
             "Scan period of the per-transport RPC keeper thread "
             "(async resends + hung-call detection).") \
    .declare("transfer_timeout_s", float, 120.0,
             "Per-chunk progress deadline on cross-host object pulls "
             "(0 = wait forever, the pre-deadline behavior).") \
    .declare("transfer_retries", int, 2,
             "Extra pull attempts after a transfer connection failure.") \
    .declare("object_durability", str, "off",
             "Durability policy for non-reconstructable (put) objects: "
             "'off' (hot path untouched), 'replicate:K' (async replicas "
             "on K holder nodes), 'spill' (async backup copy on disk).  "
             "Gives node-loss survivability to objects lineage cannot "
             "rebuild.") \
    .declare("object_durability_min_bytes", int, 0,
             "Only puts at least this large enter the durability plane "
             "(inline puts below inline_object_threshold are head-"
             "resident and already survive node loss).") \
    .declare("node_lease_timeout_s", float, 15.0,
             "A remote node agent whose heartbeat is silent this long is "
             "declared dead (exactly once): its object locations are "
             "discarded, leased/queued work is requeued, and its workers "
             "are struck.  0 disables lease expiry (conn EOF remains the "
             "only death signal).") \
    .declare("node_heartbeat_period_s", float, 1.0,
             "Node-agent liveness heartbeat period (any agent message "
             "also refreshes the lease).") \
    .declare("zero_sharding", str, "off",
             "ZeRO-style data-parallel update sharding for the Train JAX "
             "loops: 'off' | 'opt' (optimizer state sharded 1/N, grads "
             "all-reduced) | 'opt+grads' (grads reduce-scattered too).  "
             "Consumed as the default by the bench GPT-2 loop and "
             "train.jax.compile_zero_step callers; RLlib uses "
             "AlgorithmConfig.resources(zero_sharding=...).") \
    .declare("quantized_collectives", str, "off",
             "Gradient-reduction wire format for the sharded train "
             "steps: 'off' (fp32 psum) | 'int8' (block-scaled int8, "
             "~4x fewer bytes, loss-parity gated).") \
    .declare("locality_scheduling", bool, True,
             "Arg-locality-aware placement: tasks with ObjectRef args "
             "wait for their args to exist, then prefer nodes on the "
             "host already holding the most arg bytes (reference: "
             "locality_aware_lease_policy.h).  'off' restores pure "
             "utilization packing (bench baseline / regression triage).") \
    .declare("locality_min_bytes", int, 1024 * 1024,
             "Resident arg bytes a host must hold before locality "
             "outranks the hybrid utilization score (tiny args are not "
             "worth unbalancing the cluster for).") \
    .declare("locality_prefetch", bool, True,
             "When a task is placed on a node whose host is missing "
             "some of its args, start pulling them into that node's "
             "store while the task is still queued (dispatch overlaps "
             "the wire instead of serializing behind it).")
