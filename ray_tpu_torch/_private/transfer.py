"""Node-to-node object transfer over TCP (the DCN object plane).

TPU-native equivalent of the reference's ObjectManager chunked push/pull
(src/ray/object_manager/object_manager.h:117, push_manager.h:29,
pull_manager.h:52).  Design differences, deliberately:

- **Pull-only, requester-driven** (the reference pulls for task args and
  pushes for ray.get): the process that needs the bytes connects to the
  store that has them and streams chunks into its own node store.  One
  mechanism, no push/pull coordination protocol.
- The wire is a `multiprocessing.connection` TCP channel (same framing +
  HMAC challenge as the control plane) instead of gRPC: the hot path is
  a handful of large objects (SampleBatches, checkpoints, dataset blocks),
  where per-message overhead is irrelevant and `send_bytes` is a single
  syscall per chunk.
- Chunk size 4 MiB (reference default 1 MiB, ray_config_def.h) — fewer
  framing round-trips on DCN-class links.

The server runs a thread inside whichever process owns a node store (the
head process for in-process raylets, the node agent for remote nodes) and
reads under a pin so eviction can never recycle a slot mid-stream.

Copied from ``ray_tpu/_private/transfer.py`` (the JAX package).
"""
from __future__ import annotations

import queue
import random
import socket
import threading
import time
import traceback
from collections import OrderedDict
from multiprocessing.connection import Client, Listener
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private.direct import LISTEN_BACKLOG, accept_next
from ray_tpu_torch._private.ids import ObjectID

CHUNK = 4 * 1024 * 1024


class RangeUnavailableError(KeyError):
    """The peer exists and holds the object partially, but not the
    requested chunk range (it evicted the record, or the directory's
    bitmap was stale).  Distinct from KeyError("not in this store") so
    the striped scheduler can drop the SOURCE without burning a pull
    retry ladder on it."""


# ---------------------------------------------------------------------------
# transfer_* metrics: process-local counters (always available, asserted by
# smokes/benches via transfer_stats()) mirrored into util.metrics so
# prometheus_text() exports them.  KV flushes are best-effort — transfer
# happens in worker/agent processes whose kv plane may be mid-teardown.
# ---------------------------------------------------------------------------
_stats_lock = threading.Lock()
_STATS: Dict[str, float] = {
    "striped_pulls": 0,         # pulls that went through pull_striped
    "striped_bytes": 0,         # bytes landed by striped ranges
    "ranges_completed": 0,      # chunk ranges fetched (any source)
    "ranges_from_partial": 0,   # ranges served by a partial (non-owner) peer
    "range_reassignments": 0,   # ranges requeued off a dead/slow source
    "range_retries": 0,         # per-range wire retries (chaos/drops)
    "active_streams": 0,        # currently-open range/pull streams
    "served_ranges": 0,         # server side: range requests served
    "served_partial_ranges": 0,  # ... of those, out of a partial record
    "served_partial_bytes": 0,
    "coalesced_pulls": 0,       # same-oid pulls that waited on the leader
}
_meters: Dict[str, object] = {}


def _stat_add(name: str, delta: float = 1.0) -> None:
    with _stats_lock:
        _STATS[name] = _STATS.get(name, 0.0) + delta
    if name == "active_streams":
        _gauge_streams()
        return
    try:
        m = _meters.get(name)
        if m is None:
            from ray_tpu_torch.util.metrics import Meter

            m = _meters[name] = Meter(f"transfer_{name}_total")
        m.mark(delta)
    except Exception:
        pass


def _gauge_streams() -> None:
    try:
        g = _meters.get("_streams_gauge")
        if g is None:
            from ray_tpu_torch.util.metrics import Gauge

            g = _meters["_streams_gauge"] = Gauge(
                "transfer_active_streams",
                "Open transfer-plane streams in this process.")
        g.set(_STATS["active_streams"])
    except Exception:
        pass


def _peer_meter(peer: str):
    key = f"_peer:{peer}"
    m = _meters.get(key)
    if m is None:
        from ray_tpu_torch.util.metrics import Meter

        m = Meter("transfer_peer_bytes_total",
                  "Bytes pulled over the transfer plane, per source peer.",
                  tag_keys=("peer",)).set_default_tags({"peer": peer})
        _meters[key] = m
    return m


def transfer_stats() -> Dict[str, float]:
    """Snapshot of this process's transfer-plane counters (the smoke /
    bench proof surface; mirrors the transfer_* prometheus metrics)."""
    with _stats_lock:
        return dict(_STATS)

_routable_ip_cache: Optional[str] = None
_routable_ip_lock = threading.Lock()


def routable_ip() -> str:
    """Best-effort externally-routable IP of this host.

    Cached after the first call: the probe opens a UDP socket and does two
    syscalls, and callers hit this once per transfer connection — a host's
    routable address does not change within a process's lifetime."""
    global _routable_ip_cache
    ip = _routable_ip_cache
    if ip is not None:
        return ip
    with _routable_ip_lock:
        if _routable_ip_cache is None:
            _routable_ip_cache = _probe_routable_ip()
        return _routable_ip_cache


def _probe_routable_ip() -> str:
    try:
        u = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        u.connect(("8.8.8.8", 80))
        ip = u.getsockname()[0]
        u.close()
        return ip
    except OSError:
        try:
            return socket.gethostbyname(socket.gethostname())
        except OSError:
            return "127.0.0.1"


def _chunk_size() -> int:
    try:
        from ray_tpu_torch._private.config import CONFIG

        return int(CONFIG.transfer_chunk_bytes) or CHUNK
    except Exception:
        return CHUNK


def _pipeline_depth() -> int:
    try:
        from ray_tpu_torch._private.config import CONFIG

        return max(0, int(CONFIG.transfer_pipeline_depth))
    except Exception:
        return 2


def wire_store_reporting(store, send) -> None:
    """Wire a remote-process store's evict/spill callbacks to the head.

    The head's directory must learn about evictions and spills in agent and
    driver processes, or it hands out resolutions for bytes that no longer
    exist (local stores report through in-process callbacks instead —
    head.py add_node)."""

    def on_evict(oid: ObjectID):
        try:
            send({"type": "object_evicted", "oid": oid.binary()})
        except Exception:
            pass

    def on_spill(oid: ObjectID):
        rec = store.spilled_lookup(oid)
        if rec is None:
            return
        try:
            send({"type": "object_spilled", "oid": oid.binary(),
                  "path": rec["path"], "meta": rec["meta"],
                  "size": rec["size"]})
        except Exception:
            pass

    store.evict_callback = on_evict
    store.spill_callback = on_spill


class _PartialRecord:
    """An in-progress (or just-completed) pull this process can re-serve.

    ``buf`` is a writable view over the destination segment the owner is
    still landing ranges into; ``have`` is the set of chunk indices whose
    bytes are final.  The registry serves a range iff every chunk in it
    landed — readers never observe torn bytes because a chunk is marked
    only after its recv_bytes_into completed."""

    __slots__ = ("buf", "size", "chunk", "have", "nchunks", "meta",
                 "complete")

    def __init__(self, buf, size: int, chunk: int):
        self.buf = buf
        self.size = size
        self.chunk = max(1, chunk)
        self.have: Set[int] = set()
        self.nchunks = (size + self.chunk - 1) // self.chunk
        self.meta: Optional[bytes] = None
        self.complete = False

    def covers(self, off: int, length: int) -> bool:
        if self.complete:
            return True
        lo = off // self.chunk
        hi = (off + length + self.chunk - 1) // self.chunk
        return all(i in self.have for i in range(lo, hi))


class ObjectTransferServer:
    """Serves chunked object reads from one node store and/or this
    process's partial-pull registry (cooperative broadcast).

    Protocol (per connection, may serve many requests):
      recv {"oid": bytes[, "off": int, "len": int]}
      send {"ok": True, "meta": bytes|None, "size": total_size} then the
           requested byte range (whole object when off/len absent) as raw
           chunks via send_bytes
      or   {"ok": False, "error": str[, "code": "norange"]}

    ``code: norange`` means "I hold this object partially but not that
    range" — the puller drops this source without failing the pull.

    ``store=None`` runs a store-less peer server: it serves ONLY the
    partial registry.  Worker processes use that mode to re-serve ranges
    of objects they are themselves still pulling, which is what turns a
    one-to-N broadcast into a dissemination mesh instead of N unicast
    streams through the owner.
    """

    # Completed partial records kept around for late pullers; in-progress
    # records are never evicted (their owner drops them on failure).
    PARTIAL_CAP = 32

    def __init__(self, store, authkey: bytes, host: str = "0.0.0.0"):
        self.store = store
        self._listener = Listener((host, 0), family="AF_INET",
                                  backlog=LISTEN_BACKLOG, authkey=authkey)
        self.port = self._listener.address[1]
        self.address: Tuple[str, int] = (routable_ip(), self.port)
        self._shutdown = False
        # Transfer-plane traffic actually served by this store (locality
        # smokes assert "quiet plane" on these, not just on directory
        # accounting).  Plain ints under the GIL — per-object bumps.
        self.served_objects = 0
        self.served_bytes = 0
        self.served_ranges = 0
        self.served_partial_ranges = 0
        self.served_partial_bytes = 0
        self._partials: "OrderedDict[ObjectID, _PartialRecord]" = \
            OrderedDict()
        self._plock = threading.Lock()
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="rtpu-xfer-accept", daemon=True)
        self._thread.start()

    # ---- partial registry (cooperative broadcast) ----
    def register_partial(self, oid: ObjectID, buf, size: int,
                         chunk: int) -> None:
        with self._plock:
            self._partials[oid] = _PartialRecord(buf, size, chunk)
            self._partials.move_to_end(oid)
            while len(self._partials) > self.PARTIAL_CAP:
                victim = next((k for k, r in self._partials.items()
                               if r.complete), None)
                if victim is None:
                    break  # all in-progress: owners drop them themselves
                self._partials.pop(victim)

    def mark_range(self, oid: ObjectID, off: int, length: int) -> List[int]:
        """Record [off, off+length) as landed; returns the newly-complete
        chunk indices (what the owner should advertise)."""
        with self._plock:
            rec = self._partials.get(oid)
            if rec is None:
                return []
            # Only chunks FULLY inside [off, off+length) become servable
            # (ceil the left edge, floor the right — the final partial
            # chunk counts once the range reaches the object's end).
            lo = (off + rec.chunk - 1) // rec.chunk
            hi = (rec.nchunks if off + length >= rec.size
                  else (off + length) // rec.chunk)
            fresh = [i for i in range(lo, min(hi, rec.nchunks))
                     if i not in rec.have]
            rec.have.update(fresh)
            return fresh

    def complete_partial(self, oid: ObjectID, meta: bytes) -> None:
        with self._plock:
            rec = self._partials.get(oid)
            if rec is not None:
                rec.meta = meta
                rec.complete = True
                rec.have = set(range(rec.nchunks))

    def drop_partial(self, oid: ObjectID) -> bool:
        with self._plock:
            return self._partials.pop(oid, None) is not None

    def _accept_loop(self):
        while True:
            conn = accept_next(self._listener, lambda: self._shutdown)
            if conn is None:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="rtpu-xfer", daemon=True).start()

    def _serve_conn(self, conn):
        try:
            while True:
                req = conn.recv()
                self._serve_one(conn, ObjectID(req["oid"]),
                                req.get("off"), req.get("len"),
                                req.get("tc"))
        except (EOFError, OSError, BrokenPipeError):
            pass
        except Exception:
            traceback.print_exc()
        finally:
            try:
                conn.close()
            except Exception:
                pass

    def _serve_partial(self, conn, oid: ObjectID, off, length) -> bool:
        """Serve a range out of the partial registry.  Returns True when
        the request was answered (hit, or a norange refusal for a record
        we own but whose range hasn't landed)."""
        with self._plock:
            rec = self._partials.get(oid)
            if rec is None:
                return False
            if off is None:
                off, length = 0, rec.size
                if not rec.complete:
                    # A whole-object request needs meta; only a sealed
                    # record can answer it.
                    conn.send({"ok": False, "code": "norange",
                               "error": f"object {oid} incomplete here"})
                    return True
            length = max(0, min(length, rec.size - off))
            if not rec.covers(off, length):
                conn.send({"ok": False, "code": "norange",
                           "error": f"range {off}+{length} of {oid} "
                                    "not landed here yet"})
                return True
            meta = rec.meta
            view = memoryview(rec.buf)[off:off + length]
        try:
            self.served_ranges += 1
            self.served_partial_ranges += 1
            self.served_partial_bytes += length
            self.served_bytes += length
            _stat_add("served_ranges")
            _stat_add("served_partial_ranges")
            _stat_add("served_partial_bytes", length)
            conn.send({"ok": True,
                       "meta": bytes(meta) if meta is not None else None,
                       "size": rec.size})
            if length == 0:
                conn.send_bytes(b"")
                return True
            chunk = _chunk_size()
            for poff in range(0, length, chunk):
                conn.send_bytes(view[poff:poff + chunk])
            return True
        finally:
            view.release()

    def _serve_one(self, conn, oid: ObjectID, off=None, length=None,
                   tc=None):
        t0 = time.time()
        served0 = self.served_bytes
        try:
            # Cooperative path first: a range this process is still
            # landing (or just sealed) is served straight out of the
            # destination buffer, store or no store.
            if self._serve_partial(conn, oid, off, length):
                return
            if self.store is None:
                conn.send({"ok": False,
                           "error": f"object {oid} not at this peer"})
                return
            # Pin while streaming: eviction must not recycle the buffer
            # under us (plasma's client in-use-count contract).
            self.store.pin(oid)
            try:
                got = self._read(oid, off, length)
                if got is None:
                    conn.send({"ok": False,
                               "error": f"object {oid} not in this store"})
                    return
                meta, size, span, chunks = got
                self.served_objects += 1
                self.served_bytes += span
                if off is not None:
                    self.served_ranges += 1
                    _stat_add("served_ranges")
                conn.send({"ok": True, "meta": bytes(meta), "size": size})
                chunk = _chunk_size()
                depth = _pipeline_depth()
                if span == 0:
                    conn.send_bytes(b"")
                    return
                if depth >= 2 and span > chunk:
                    # Pipelined: a producer thread reads/slices chunk
                    # N+1..N+d while this thread's send_bytes(chunk N)
                    # blocks on the socket, so disk reads (spilled
                    # objects) and socket writes overlap instead of
                    # strictly alternating.
                    self._send_pipelined(conn, chunks, depth)
                else:
                    for piece in chunks:
                        conn.send_bytes(piece)
            finally:
                self.store.unpin(oid)
        finally:
            if tc is not None:
                # Serve-side span inside the puller's trace — the
                # cross-process flow edge for transfer-plane bytes.
                try:
                    from ray_tpu_torch import observability as obs

                    obs.record("transfer.pull", t0, time.time(),
                               ctx=tuple(tc), oid=oid.hex(),
                               bytes=self.served_bytes - served0,
                               range=off is not None)
                except Exception:
                    pass

    @staticmethod
    def _send_pipelined(conn, chunks, depth: int):
        q: "queue.Queue" = queue.Queue(maxsize=max(1, depth - 1))
        stop = threading.Event()
        _END = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for piece in chunks:
                    if not put(piece):
                        return  # consumer bailed (socket error): closing
                        # the generator runs its finally (file close)
                put(_END)
            except BaseException as e:  # noqa: BLE001 — forwarded to sender
                put(e)

        t = threading.Thread(target=produce, name="rtpu-xfer-read",
                             daemon=True)
        t.start()
        try:
            while True:
                piece = q.get()
                if piece is _END:
                    return
                if isinstance(piece, BaseException):
                    raise piece
                conn.send_bytes(piece)
        finally:
            stop.set()
            t.join(timeout=5.0)

    @staticmethod
    def _clamp(size: int, off, length) -> Tuple[int, int]:
        if off is None:
            return 0, size
        off = max(0, min(int(off), size))
        return off, max(0, min(int(length), size - off))

    def _read(self, oid: ObjectID, off=None, length=None):
        """Resolve an object (or a byte range of it) to
        (meta, total_size, span_bytes, chunk_iterable); None if the store
        has no trace of it."""
        chunk = _chunk_size()
        got = self.store.get(oid)
        if got is not None:
            meta, data = got
            o, ln = self._clamp(len(data), off, length)
            return (meta, len(data), ln,
                    _view_chunks(memoryview(data)[o:o + ln], chunk))
        # Arena-resident object (owner-process put): copy out under the
        # store lock — an arena slot can be recycled by a concurrent
        # delete, and unlike shm segments the mapping gives no lifetime
        # guarantee to readers in this process.
        lock = getattr(self.store, "_lock", None)
        if lock is None:
            return None
        with lock:
            hit = self.store.arena_lookup(oid)
            if hit is not None:
                from ray_tpu_torch._native import ArenaReader

                view = ArenaReader.view(hit["store"], hit["offset"],
                                        hit["size"], hit["capacity"])
                data = memoryview(bytes(view))
                o, ln = self._clamp(len(data), off, length)
                return (hit["meta"], len(data), ln,
                        _view_chunks(data[o:o + ln], chunk))
        # Spilled-to-disk fallback: stream straight off the spill file
        # (reference: spilled_object_reader.h) — chunked reads feed the
        # pipelined sender, so the whole object is never buffered here.
        lookup = getattr(self.store, "spilled_lookup", None)
        rec = lookup(oid) if lookup is not None else None
        if rec is not None:
            try:
                f = open(rec["path"], "rb")
            except OSError:
                return None
            o, ln = self._clamp(rec["size"], off, length)
            if o:
                try:
                    f.seek(o)
                except OSError:
                    f.close()
                    return None
            return rec["meta"], rec["size"], ln, _file_chunks(f, chunk, ln)
        return None

    def shutdown(self):
        self._shutdown = True
        try:
            self._listener.close()
        except Exception:
            pass


def _view_chunks(data: memoryview, chunk: int):
    for off in range(0, len(data), chunk):
        yield data[off:off + chunk]


def _file_chunks(f, chunk: int, limit: Optional[int] = None):
    try:
        left = limit
        while True:
            want = chunk if left is None else min(chunk, left)
            if want <= 0:
                return
            piece = f.read(want)
            if not piece:
                return
            if left is not None:
                left -= len(piece)
            yield piece
    finally:
        f.close()


def _client_with_deadline(addr: Tuple[str, int], authkey: bytes,
                          timeout: float):
    """Client() with a bounded connect+handshake.

    A SIGSTOPped/hung peer ACCEPTS the TCP connection (kernel backlog)
    and then never answers the HMAC challenge — a plain Client() blocks
    forever inside answer_challenge, before any per-chunk deadline can
    apply.  The handshake runs on a helper thread; past the deadline the
    attempt is abandoned (the thread closes the socket if it ever
    completes) and the caller's retry/failover takes over."""
    if not timeout or timeout <= 0:
        return Client(tuple(addr), family="AF_INET", authkey=authkey)
    box: dict = {}
    lock = threading.Lock()
    done = threading.Event()

    def run():
        try:
            c = Client(tuple(addr), family="AF_INET", authkey=authkey)
        except BaseException as e:  # noqa: BLE001 — forwarded to caller
            with lock:
                box["err"] = e
            done.set()
            return
        with lock:
            if box.get("abandoned"):
                abandoned = True
            else:
                box["conn"] = c
                abandoned = False
        done.set()
        if abandoned:
            try:
                c.close()
            except Exception:
                pass

    threading.Thread(target=run, name="rtpu-xfer-conn", daemon=True).start()
    if not done.wait(timeout):
        with lock:
            conn = box.get("conn")
            if conn is None:
                box["abandoned"] = True
        if box.get("abandoned"):
            raise OSError(
                f"transfer connect to {addr} stalled past {timeout}s")
        return conn
    if "err" in box:
        raise box["err"]
    return box["conn"]


class TransferClient:
    """Pulls objects from remote transfer servers; caches connections."""

    def __init__(self, authkey: bytes):
        self.authkey = authkey
        self._conns = {}
        self._conn_locks = {}  # addr -> per-connection stream lock
        self._lock = threading.Lock()  # guards the two maps only
        # Per-peer bandwidth/load accounting: EWMA bytes/s per source and
        # a live in-flight stream count, feeding striped range assignment
        # and get_many's least-loaded holder choice.
        self._peer_bw: Dict[tuple, float] = {}
        self._peer_active: Dict[tuple, int] = {}
        self._peer_lock = threading.Lock()

    # ---- per-peer accounting ----
    def _stream_begin(self, addr: tuple) -> None:
        with self._peer_lock:
            self._peer_active[addr] = self._peer_active.get(addr, 0) + 1
        _stat_add("active_streams", 1)

    def _stream_end(self, addr: tuple, nbytes: int, dt: float) -> None:
        with self._peer_lock:
            n = self._peer_active.get(addr, 1) - 1
            if n <= 0:
                self._peer_active.pop(addr, None)
            else:
                self._peer_active[addr] = n
            if nbytes > 0 and dt > 0:
                bw = nbytes / dt
                old = self._peer_bw.get(addr)
                self._peer_bw[addr] = \
                    bw if old is None else 0.7 * old + 0.3 * bw
        _stat_add("active_streams", -1)
        if nbytes > 0:
            try:
                _peer_meter(f"{addr[0]}:{addr[1]}").mark(nbytes)
            except Exception:
                pass

    def peer_bandwidth(self, addr) -> float:
        with self._peer_lock:
            return self._peer_bw.get(tuple(addr), 0.0)

    def rank_sources(self, addrs) -> list:
        """Order candidate holders least-loaded-first: fewest in-flight
        streams from this process, then highest observed bandwidth.
        Unmeasured peers sort ahead of known-slow ones (optimism spreads
        first touches across holders)."""
        with self._peer_lock:
            def key(a):
                t = tuple(a)
                return (self._peer_active.get(t, 0),
                        -self._peer_bw.get(t, float("inf")))

            return sorted(addrs, key=key)

    def _conn_for(self, addr: Tuple[str, int]):
        addr = tuple(addr)
        with self._lock:
            conn = self._conns.get(addr)
            lock = self._conn_locks.setdefault(addr, threading.Lock())
        if conn is not None:
            return conn, lock
        from ray_tpu_torch._private.config import CONFIG

        conn = _client_with_deadline(addr, self.authkey,
                                     float(CONFIG.transfer_timeout_s))
        with self._lock:
            old = self._conns.setdefault(addr, conn)
        if old is not conn:
            conn.close()
            return old, lock
        return conn, lock

    @staticmethod
    def _await_bytes(conn, timeout_s: float, oid: ObjectID, what: str):
        """Per-chunk progress deadline: a stream that stops moving raises
        instead of blocking recv() forever (a severed peer whose FIN was
        lost looks exactly like a slow one — bound it)."""
        if timeout_s and timeout_s > 0 and not conn.poll(timeout_s):
            raise OSError(
                f"transfer of {oid} stalled: no {what} for {timeout_s}s")

    def _invalidate(self, addr):
        with self._lock:
            conn = self._conns.pop(tuple(addr), None)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass

    def pull(self, addr: Tuple[str, int], oid: ObjectID,
             sink=None) -> Tuple[bytes, bytes]:
        """Fetch (meta, data) for oid from the store at addr.

        If `sink` (a writable buffer of the right size, e.g. a local shm
        view) is provided, chunks are written into it and `data` returns
        that buffer's bytes are NOT copied again — the caller owns sink.
        Connection errors/stalls invalidate the cached conn and retry
        with backoff (`transfer_retries`); each chunk must arrive within
        `transfer_timeout_s` or the attempt counts as failed."""
        addr_t = tuple(addr)
        t0 = time.monotonic()
        nbytes = 0
        self._stream_begin(addr_t)
        try:
            meta, data = self._pull_impl(addr, oid, sink)
            nbytes = len(data) if data is not None else (
                len(memoryview(sink)) if sink is not None else 0)
            return meta, data
        finally:
            self._stream_end(addr_t, nbytes, time.monotonic() - t0)

    def _pull_impl(self, addr: Tuple[str, int], oid: ObjectID,
                   sink=None) -> Tuple[bytes, bytes]:
        from ray_tpu_torch._private.chaos import net_fault
        from ray_tpu_torch._private.config import CONFIG
        from ray_tpu_torch._private.retry import RetryPolicy

        retries = max(0, int(CONFIG.transfer_retries))
        timeout_s = float(CONFIG.transfer_timeout_s)
        policy = RetryPolicy(base=0.05, cap=1.0)
        tc = None
        try:
            from ray_tpu_torch import observability as obs
            from ray_tpu_torch.util.tracing import tracing_enabled

            if tracing_enabled():
                tc = obs.get_context()
        except Exception:
            pass
        for attempt in range(retries + 1):
            act = net_fault("pull")
            if act is not None:
                kind, delay_ms = act
                if kind == "delay":
                    time.sleep(delay_ms / 1000.0)
                elif kind in ("drop", "sever"):
                    # The data channel is strict request/response: a lost
                    # frame is indistinguishable from a severed conn, so
                    # both surface as a connection failure (and retry).
                    self._invalidate(addr)
                    if attempt >= retries:
                        raise OSError("chaos: transfer connection severed")
                    time.sleep(policy.delay(attempt + 1))
                    continue
            conn, conn_lock = self._conn_for(addr)
            try:
                # One in-flight request per CONNECTION (request/response
                # protocol); pulls against different servers overlap.
                with conn_lock:
                    req = {"oid": oid.binary()}
                    if tc is not None:
                        req["tc"] = tc
                    conn.send(req)
                    self._await_bytes(conn, timeout_s, oid, "header")
                    hdr = conn.recv()
                    if not hdr["ok"]:
                        raise KeyError(hdr["error"])
                    size = hdr["size"]
                    if sink is not None:
                        view = memoryview(sink)
                        off = 0
                        if size == 0:
                            self._await_bytes(conn, timeout_s, oid, "chunk")
                            conn.recv_bytes()
                        while off < size:
                            self._await_bytes(conn, timeout_s, oid, "chunk")
                            n = conn.recv_bytes_into(view[off:])
                            off += n
                        return hdr["meta"], None
                    parts = []
                    got = 0
                    while got < size:
                        self._await_bytes(conn, timeout_s, oid, "chunk")
                        b = conn.recv_bytes()
                        parts.append(b)
                        got += len(b)
                    if size == 0:
                        self._await_bytes(conn, timeout_s, oid, "chunk")
                        conn.recv_bytes()
                    return hdr["meta"], b"".join(parts)
            except (EOFError, OSError, BrokenPipeError):
                self._invalidate(addr)
                if attempt >= retries:
                    raise
                time.sleep(policy.delay(attempt + 1))
        raise RuntimeError("unreachable")

    def pull_range(self, addr: Tuple[str, int], oid: ObjectID, off: int,
                   length: int, sink, tc=None,
                   retries: Optional[int] = None) -> Tuple[bytes, int]:
        """Fetch bytes [off, off+length) of oid from addr into ``sink``
        (a writable view of exactly that span).  Returns (meta, nbytes).

        Retries are PER RANGE: a dropped/severed frame re-requests only
        this range over a fresh connection — the other ranges of a
        striped pull are untouched.  Raises RangeUnavailableError when
        the peer holds the object but not this range (partial holder the
        directory over-promised): the caller reassigns the range without
        counting the peer dead for other work."""
        from ray_tpu_torch._private.chaos import net_fault
        from ray_tpu_torch._private.config import CONFIG
        from ray_tpu_torch._private.retry import RetryPolicy

        if retries is None:
            retries = max(0, int(CONFIG.transfer_retries))
        timeout_s = float(CONFIG.transfer_timeout_s)
        policy = RetryPolicy(base=0.05, cap=1.0)
        addr = tuple(addr)
        t0 = time.monotonic()
        done = 0
        self._stream_begin(addr)
        try:
            for attempt in range(retries + 1):
                act = net_fault("pull")
                if act is not None:
                    kind, delay_ms = act
                    if kind == "delay":
                        time.sleep(delay_ms / 1000.0)
                    elif kind in ("drop", "sever"):
                        self._invalidate(addr)
                        if attempt >= retries:
                            raise OSError(
                                "chaos: transfer connection severed")
                        _stat_add("range_retries")
                        time.sleep(policy.delay(attempt + 1))
                        continue
                conn, conn_lock = self._conn_for(addr)
                try:
                    with conn_lock:
                        req = {"oid": oid.binary(), "off": int(off),
                               "len": int(length)}
                        if tc is not None:
                            req["tc"] = tc
                        conn.send(req)
                        self._await_bytes(conn, timeout_s, oid, "header")
                        hdr = conn.recv()
                        if not hdr["ok"]:
                            if hdr.get("code") == "norange":
                                raise RangeUnavailableError(hdr["error"])
                            raise KeyError(hdr["error"])
                        want = max(0, min(int(length),
                                          int(hdr["size"]) - int(off)))
                        view = memoryview(sink)
                        got = 0
                        if want == 0:
                            self._await_bytes(conn, timeout_s, oid,
                                              "chunk")
                            conn.recv_bytes()
                        while got < want:
                            self._await_bytes(conn, timeout_s, oid,
                                              "chunk")
                            got += conn.recv_bytes_into(view[got:])
                        done = got
                        return hdr["meta"], got
                except (EOFError, OSError, BrokenPipeError):
                    self._invalidate(addr)
                    if attempt >= retries:
                        raise
                    _stat_add("range_retries")
                    time.sleep(policy.delay(attempt + 1))
            raise RuntimeError("unreachable")
        finally:
            self._stream_end(addr, done, time.monotonic() - t0)

    def close(self):
        with self._lock:
            for c in self._conns.values():
                try:
                    c.close()
                except Exception:
                    pass
            self._conns.clear()


class _Source:
    __slots__ = ("addr", "chunks", "dead", "spawned")

    def __init__(self, addr: tuple, chunks: Optional[Set[int]]):
        self.addr = tuple(addr)
        self.chunks = chunks  # None == full holder
        self.dead = False
        self.spawned = False


def pull_striped(client: TransferClient, oid: ObjectID, size: int,
                 sources, sink, *, meta_hint: Optional[bytes] = None,
                 chunk: Optional[int] = None, tc=None, refresh=None,
                 progress=None) -> Tuple[Optional[bytes], dict]:
    """Multi-source pull: split [0, size) into chunk-aligned ranges and
    fetch them concurrently from every live source, writing each range
    into its slice of ``sink`` (one preallocated destination buffer).

    ``sources`` is an iterable of (addr, chunk_index_set_or_None) — None
    marks a full holder, a set marks a partial (cooperative) holder that
    can only be assigned ranges its bitmap covers.  Work-stealing: each
    source's stream claims the next range it is eligible for, so fast
    peers naturally carry more ranges and per-peer bandwidth accounting
    (rank_sources) decides which sources stream at all when there are
    more holders than ``transfer_stripe_sources``.

    Failure model (the PR 7 failover, made per-range): a dead/stalled
    source's claimed range is requeued and reassigned to a surviving
    source; ``refresh()`` (optional, called when sources run dry or there
    is spare stream capacity) re-asks the directory for holders so
    newly-advertised partial holders join MID-pull.  Raises the last
    source error only when no source can finish the job.

    ``progress(off, length)`` fires after each landed range — the hook
    cooperative pullers use to advertise their own bitmap.

    Returns (meta, stats); meta falls back to ``meta_hint`` when every
    source that answered was itself meta-less (an in-progress partial).
    """
    from ray_tpu_torch._private.config import CONFIG

    chunkb = int(chunk or _chunk_size()) or CHUNK
    nchunks = max(1, (size + chunkb - 1) // chunkb)
    max_src = max(1, int(CONFIG.transfer_stripe_sources))
    target = max(2, int(CONFIG.transfer_stripe_ranges))
    nranges = min(nchunks, max(target, 2 * max_src))
    per, extra = divmod(nchunks, nranges)
    bounds: List[Tuple[int, int]] = []
    lo = 0
    for i in range(nranges):
        hi = lo + per + (1 if i < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    # Rotate the claim order per puller: concurrent pullers of the same
    # object then land DIFFERENT ranges first, so their partial bitmaps
    # are useful to each other (the dissemination-mesh property; a fixed
    # 0..N order would make every peer's bitmap a prefix of your own).
    start = random.randrange(nranges)
    pending: List[int] = [(start + i) % nranges for i in range(nranges)]
    claimed: Set[int] = set()
    done: Set[int] = set()
    cond = threading.Condition()
    srcs: Dict[tuple, _Source] = {}
    meta_box: List[Optional[bytes]] = [None]
    err_box: List[Optional[BaseException]] = [None]
    abort = [False]
    stats = {"nranges": nranges, "partial_ranges": 0, "reassigned": 0,
             "bytes_from": {}, "refreshes": 0}
    sinkview = memoryview(sink)
    timeout_s = float(CONFIG.transfer_timeout_s) or 120.0

    def _merge(items) -> int:
        """Fold (addr, chunks) pairs into the source table (under cond).
        Returns how many NEW usable sources appeared."""
        fresh = 0
        for addr, chunks in items:
            key = tuple(addr)
            cur = srcs.get(key)
            if cur is None:
                srcs[key] = _Source(key, set(chunks)
                                    if chunks is not None else None)
                fresh += 1
            elif cur.chunks is not None:
                if chunks is None:
                    cur.chunks = None  # promoted to full holder
                else:
                    cur.chunks.update(chunks)
        return fresh

    def _eligible(src: _Source, ridx: int) -> bool:
        if src.chunks is None:
            return True
        rlo, rhi = bounds[ridx]
        return all(i in src.chunks for i in range(rlo, rhi))

    def _runner(src: _Source):
        try:
            while True:
                with cond:
                    if abort[0] or src.dead or len(done) == nranges:
                        return
                    ridx = next((r for r in pending
                                 if _eligible(src, r)), None)
                    if ridx is None:
                        if not pending and not claimed:
                            return
                        cond.wait(0.05)  # a failure may requeue a range
                        continue
                    pending.remove(ridx)
                    claimed.add(ridx)
                rlo, rhi = bounds[ridx]
                off = rlo * chunkb
                ln = min(size, rhi * chunkb) - off
                seg = sinkview[off:off + ln]
                ok = False
                try:
                    m, n = client.pull_range(src.addr, oid, off, ln, seg,
                                             tc=tc)
                    ok = True
                except BaseException as e:  # noqa: BLE001 — requeue+record
                    with cond:
                        claimed.discard(ridx)
                        pending.append(ridx)
                        src.dead = True
                        err_box[0] = e
                        stats["reassigned"] += 1
                        cond.notify_all()
                    _stat_add("range_reassignments")
                    return
                finally:
                    seg.release()
                with cond:
                    claimed.discard(ridx)
                    done.add(ridx)
                    if m is not None and meta_box[0] is None:
                        meta_box[0] = m
                    key = f"{src.addr[0]}:{src.addr[1]}"
                    stats["bytes_from"][key] = \
                        stats["bytes_from"].get(key, 0) + n
                    if src.chunks is not None:
                        stats["partial_ranges"] += 1
                        _stat_add("ranges_from_partial")
                    cond.notify_all()
                _stat_add("ranges_completed")
                _stat_add("striped_bytes", ln)
                if progress is not None:
                    try:
                        progress(off, ln)
                    except Exception:
                        pass
        finally:
            with cond:
                src.spawned = False
                cond.notify_all()

    def _spawn_locked() -> None:
        live = sum(1 for s in srcs.values() if s.spawned)
        if live >= max_src:
            return
        idle = [s for s in srcs.values() if not s.dead and not s.spawned]
        for addr in client.rank_sources([s.addr for s in idle]):
            if live >= max_src:
                return
            s = srcs[tuple(addr)]
            s.spawned = True
            live += 1
            threading.Thread(target=_runner, args=(s,),
                             name="rtpu-stripe", daemon=True).start()

    _stat_add("striped_pulls")
    with cond:
        _merge(sources)
        _spawn_locked()
    last_progress = time.monotonic()
    last_refresh = 0.0
    refresh_strikes = 0
    refresh_interval = 0.05
    ndone = 0
    try:
        while True:
            with cond:
                cond.wait(0.05)
                if len(done) > ndone:
                    ndone = len(done)
                    last_progress = time.monotonic()
                if len(done) == nranges:
                    return (meta_box[0] if meta_box[0] is not None
                            else meta_hint), stats
                _spawn_locked()  # replace streams lost to dead sources
                alive = [s for s in srcs.values() if not s.dead]
                spawned = any(s.spawned for s in srcs.values())
            now = time.monotonic()
            want_refresh = refresh is not None and (
                not alive or len(alive) < max_src)
            if want_refresh and now - last_refresh >= refresh_interval:
                last_refresh = now
                stats["refreshes"] += 1
                try:
                    extra_sources = refresh() or []
                except Exception:
                    extra_sources = []
                with cond:
                    if _merge(extra_sources):
                        refresh_strikes = 0
                        refresh_interval = 0.05
                    else:
                        # Nothing new: poll the directory less and less
                        # (it answers every puller of a hot broadcast).
                        refresh_interval = min(1.0, refresh_interval * 2)
                        if not alive:
                            refresh_strikes += 1
                    if alive:
                        refresh_strikes = 0
                    _spawn_locked()
            if not alive and not spawned:
                if refresh is None or refresh_strikes >= 3:
                    raise err_box[0] or OSError(
                        f"striped pull of {oid}: no live sources")
            if now - last_progress > timeout_s:
                raise err_box[0] or OSError(
                    f"striped pull of {oid} stalled: no range completed "
                    f"for {timeout_s}s")
    finally:
        with cond:
            abort[0] = True
            cond.notify_all()
            # Runner threads hold live views into sinkview while a range
            # is in flight; the caller may unlink/close the backing shm
            # the moment we return, so drain them first (bounded by the
            # per-chunk progress deadline inside pull_range).
            deadline = time.monotonic() + timeout_s + 5.0
            while any(s.spawned for s in srcs.values()) \
                    and time.monotonic() < deadline:
                cond.wait(0.2)
        sinkview.release()
