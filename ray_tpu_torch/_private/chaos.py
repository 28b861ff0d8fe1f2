"""Chaos / fault-injection hooks for schedule-perturbation testing.

Reference: asio delay injection (src/ray/common/asio/asio_chaos.h:22, flag
RAY_testing_asio_delay_us in ray_config_def.h:735-738) and the node-killer
actor (python/ray/_private/test_utils.py:1337).

Enable delays with RAY_TPU_TESTING_DELAY_MS="<op_substr>:<min>:<max>", e.g.
"submit:0:20" delays every task submission by 0-20ms.  `kill_random_worker`
is the in-process node-killer equivalent.

Gang-level fault injection (mesh fault-tolerance testing): set
RAY_TPU_TESTING_KILL_SCHEDULE to a ``;``-separated list of
``<op>:<rank>:<nth>[:<generation>]`` entries — when the matching op fires
for the ``nth`` time (1-based, counted per process) at ``rank`` in gang
``generation`` the process SIGKILLs itself, simulating a hard rank crash
mid-collective.  ``rank`` and ``generation`` accept ``*`` (any); generation
defaults to ``0`` so a restarted gang (which re-exports
RTPU_MESH_GENERATION) survives by default, making restart-then-succeed
loops deterministic.  Kill sites: ``mesh_run`` (MeshWorker.run entry),
``train_report`` (TrainWorker result reporting), and the node-agent
sites ``node_agent_spawn`` (counted per spawn_worker command),
``node_agent_msg`` (per handled head message) and ``node_agent_tick``
(per 0.5s reap tick) — a node-agent match SIGKILLs the agent AND all of
its worker children, simulating whole-node loss.  Driver-side,
``kill_mesh_rank`` murders a specific (or seeded-random) rank of a live
MeshGroup/WorkerGroup by killing its hosting worker process, and
``kill_node`` SIGKILLs a node-agent subprocess with its whole process
group.

Message-level transport faults (drop/duplicate/delay/sever individual
control- and data-plane messages, deterministic and seeded): set
RAY_TPU_TESTING_NET_SCHEDULE — see :class:`NetSchedule` and
docs/FAULT_TOLERANCE.md "RPC deadlines, retries, and transport chaos".

Copied from ``ray_tpu/_private/chaos.py`` (the JAX package).
"""
from __future__ import annotations

import os
import random
import time
from typing import List, Optional, Tuple

KILL_SCHEDULE_ENV = "RAY_TPU_TESTING_KILL_SCHEDULE"
GENERATION_ENV = "RTPU_MESH_GENERATION"
NET_SCHEDULE_ENV = "RAY_TPU_TESTING_NET_SCHEDULE"


# ---------------------------------------------------------------------------
# Message-level transport faults
# ---------------------------------------------------------------------------
class NetSchedule:
    """A seeded, deterministic message-fault schedule.

    RAY_TPU_TESTING_NET_SCHEDULE is a ``;``-separated list of
    ``<op>:<kind>:<prob>:<seed>[:<times>[:<delay_ms>]]`` entries:

    - ``op``    — substring matched against the fault-point label.
      Labels are directional: ``request:<op>`` / ``notify:<type>`` on the
      send side, ``reply:<op>`` / ``push:<type>`` on the receive side,
      and ``pull`` on the transfer.py data channel.
    - ``kind``  — ``drop`` (message vanishes), ``dup`` (delivered twice),
      ``delay`` (sleeps ``delay_ms``, default 25), ``sever`` (the
      connection is closed mid-flight, like a mid-stream RST).
    - ``prob``  — per-message trigger probability, drawn from a dedicated
      ``random.Random(seed)`` so a schedule replays identically.
    - ``times`` — optional cap on total triggers (e.g. ``1`` = exactly
      the first matching draw fires, then the link heals).

    Example: ``reply:resolve:drop:0.3:42;request:submit:dup:1.0:7:1``
    drops ~30% of resolve replies forever and duplicates exactly one
    submit frame.
    """

    def __init__(self, entries):
        import threading

        # entries: list of dicts {needle, kind, prob, rng, left, delay_ms}
        self.entries = entries
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, spec: str) -> "NetSchedule":
        entries = []
        for part in (spec or "").split(";"):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            if len(bits) < 4:
                continue
            # The op label may itself contain ':' ("request:submit"), so
            # anchor the parse on the first known fault kind.
            try:
                kinds = ("drop", "dup", "delay", "sever")
                ki = next(i for i in range(1, len(bits))
                          if bits[i] in kinds)
                op = ":".join(bits[:ki])
                kind = bits[ki]
                prob = float(bits[ki + 1])
                seed = int(bits[ki + 2])
                times = (int(bits[ki + 3])
                         if len(bits) > ki + 3 and bits[ki + 3] else None)
                delay_ms = (float(bits[ki + 4])
                            if len(bits) > ki + 4 else 25.0)
            except (StopIteration, ValueError, IndexError):
                continue
            entries.append({"needle": op, "kind": kind, "prob": prob,
                            "rng": random.Random(seed),
                            "left": times, "delay_ms": delay_ms})
        return cls(entries)

    def fault(self, label: str) -> Optional[Tuple[str, float]]:
        """Consult the schedule for a message at ``label``; returns
        ``(kind, delay_ms)`` when a fault fires, else None.  First
        matching entry wins; draws are per-entry deterministic."""
        for e in self.entries:
            if e["needle"] not in label:
                continue
            if e["left"] is not None and e["left"] <= 0:
                continue
            if e["rng"].random() >= e["prob"]:
                continue
            if e["left"] is not None:
                with self._lock:
                    if e["left"] <= 0:
                        continue
                    e["left"] -= 1
            from ray_tpu_torch._private import retry as _retry

            _retry.note("net_faults")
            return e["kind"], e["delay_ms"]
        return None


def net_request_label(op: str, payload: Optional[dict]) -> str:
    """Fault-point label for a request frame.  Acked notifies (op
    ``notify_msg``) append the inner message type so schedules can target
    the real op ("seal", "task_done") instead of the envelope."""
    if op == "notify_msg" and isinstance(payload, dict):
        inner = payload.get("msg")
        if isinstance(inner, dict) and inner.get("type"):
            return f"notify_msg:{inner['type']}"
    return op


_net_schedule: Optional[NetSchedule] = None
_net_schedule_spec: Optional[str] = None


def net_schedule() -> Optional[NetSchedule]:
    """Process-wide schedule parsed from RAY_TPU_TESTING_NET_SCHEDULE
    (re-parsed when the env var changes, like the kill schedule)."""
    global _net_schedule, _net_schedule_spec
    spec = os.environ.get(NET_SCHEDULE_ENV)
    if not spec:
        if _net_schedule is not None:
            _net_schedule = None
            _net_schedule_spec = None
        return None
    if _net_schedule is None or spec != _net_schedule_spec:
        _net_schedule = NetSchedule.from_spec(spec)
        _net_schedule_spec = spec
    return _net_schedule


def net_fault(label: str) -> Optional[Tuple[str, float]]:
    sched = net_schedule()
    return sched.fault(label) if sched is not None else None


class FaultableConn:
    """Fault-injecting wrapper around a multiprocessing Connection.

    Installed under ConnTransport (and the node agent's head link) when a
    net schedule is active.  Send-side labels come from the outgoing
    frame (``request:<op>`` / ``notify:<type>``); receive-side labels
    from the incoming frame (``reply:<op>`` / ``push:<type>``, the op
    echoed in reply frames by the head).  ``sever`` closes the underlying
    connection — exactly what a dropped TCP link looks like to both
    reader loops, driving the reconnect/resend path.
    """

    def __init__(self, conn, schedule_fn=net_fault):
        self._conn = conn
        self._fault = schedule_fn
        self._recv_dups = []

    # -- label derivation --
    @staticmethod
    def _send_label(msg) -> str:
        if isinstance(msg, dict):
            t = msg.get("type")
            if t == "request":
                return f"request:{net_request_label(msg.get('op', ''), msg.get('payload'))}"
            if t == "notify":
                return f"notify:{msg.get('op', '')}"
            return f"notify:{t}"
        return "notify:raw"

    @staticmethod
    def _recv_label(msg) -> str:
        if isinstance(msg, dict):
            t = msg.get("type")
            if t == "reply":
                return f"reply:{msg.get('op', '')}"
            return f"push:{t}"
        return "push:raw"

    # -- faulted endpoints --
    def send(self, msg):
        act = self._fault(self._send_label(msg))
        if act is None:
            return self._conn.send(msg)
        kind, delay_ms = act
        if kind == "drop":
            return None
        if kind == "dup":
            self._conn.send(msg)
            return self._conn.send(msg)
        if kind == "delay":
            time.sleep(delay_ms / 1000.0)
            return self._conn.send(msg)
        if kind == "sever":
            try:
                self._conn.close()
            finally:
                raise OSError("chaos: connection severed (send)")
        return self._conn.send(msg)

    def recv(self):
        while True:
            if self._recv_dups:
                return self._recv_dups.pop()
            msg = self._conn.recv()
            act = self._fault(self._recv_label(msg))
            if act is None:
                return msg
            kind, delay_ms = act
            if kind == "drop":
                continue
            if kind == "dup":
                self._recv_dups.append(msg)
                return msg
            if kind == "delay":
                time.sleep(delay_ms / 1000.0)
                return msg
            if kind == "sever":
                try:
                    self._conn.close()
                finally:
                    raise EOFError("chaos: connection severed (recv)")
            return msg

    # -- transparent delegation --
    def __getattr__(self, name):
        return getattr(self._conn, name)


def wrap_net_faults(conn):
    """Wrap ``conn`` in a FaultableConn when a net schedule is active
    (identity no-op otherwise, and never double-wraps)."""
    if isinstance(conn, FaultableConn):
        return conn
    return FaultableConn(conn) if net_schedule() is not None else conn


def _parse() -> Optional[Tuple[str, float, float]]:
    spec = os.environ.get("RAY_TPU_TESTING_DELAY_MS")
    if not spec:
        return None
    try:
        op, lo, hi = spec.split(":")
        return op, float(lo), float(hi)
    except ValueError:
        return None


def maybe_delay(op: str):
    """Called on head-side operations; sleeps if the op matches the spec."""
    parsed = _parse()
    if parsed is None:
        return
    needle, lo, hi = parsed
    if needle in op:
        time.sleep(random.uniform(lo, hi) / 1000.0)


class ChaosSchedule:
    """A deterministic rank-kill schedule, parsed once per process.

    Entries are (op, rank, nth, generation); rank/generation may be None
    (wildcard).  ``should_die(op, rank)`` is called at each kill site with
    the process's per-op invocation count and the gang generation from
    RTPU_MESH_GENERATION."""

    def __init__(self, entries: List[Tuple[str, Optional[int], int,
                                           Optional[int]]]):
        self.entries = list(entries)
        self._counts: dict = {}

    @classmethod
    def from_spec(cls, spec: str) -> "ChaosSchedule":
        entries = []
        for part in (spec or "").split(";"):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            if len(bits) not in (3, 4):
                continue
            op = bits[0]
            rank = None if bits[1] == "*" else int(bits[1])
            nth = int(bits[2])
            gen: Optional[int] = 0
            if len(bits) == 4:
                gen = None if bits[3] == "*" else int(bits[3])
            entries.append((op, rank, nth, gen))
        return cls(entries)

    @classmethod
    def from_env(cls) -> Optional["ChaosSchedule"]:
        spec = os.environ.get(KILL_SCHEDULE_ENV)
        return cls.from_spec(spec) if spec else None

    def should_die(self, op: str, rank: Optional[int]) -> bool:
        if not self.entries:
            return False
        count = self._counts.get(op, 0) + 1
        self._counts[op] = count
        try:
            generation = int(os.environ.get(GENERATION_ENV, "0"))
        except ValueError:
            generation = 0
        for e_op, e_rank, e_nth, e_gen in self.entries:
            if e_op != op:
                continue
            if e_rank is not None and e_rank != rank:
                continue
            if e_gen is not None and e_gen != generation:
                continue
            if count == e_nth:
                return True
        return False


_schedule: Optional[ChaosSchedule] = None
_schedule_spec: Optional[str] = None


def check_die(op: str, rank: Optional[int] = None) -> bool:
    """Consult the env kill schedule for this kill site; True means the
    process is scheduled to die NOW (the caller decides how — plain
    SIGKILL for workers, children-then-self for node agents)."""
    global _schedule, _schedule_spec
    spec = os.environ.get(KILL_SCHEDULE_ENV)
    if not spec:
        return False
    if _schedule is None or spec != _schedule_spec:
        _schedule = ChaosSchedule.from_spec(spec)
        _schedule_spec = spec
    return _schedule.should_die(op, rank)


def maybe_die(op: str, rank: Optional[int] = None) -> None:
    """Worker-side kill site: consult the env schedule and SIGKILL the
    current process on a match (a hard crash — no atexit, no cleanup —
    exactly what a preempted TPU host looks like to the gang)."""
    if check_die(op, rank):
        import signal

        os.kill(os.getpid(), signal.SIGKILL)


def _kill_actor_process(actor, head=None) -> bool:
    """Kill the worker PROCESS hosting `actor` (crash injection, not the
    graceful ray_tpu_torch.kill path).  Returns True if a process was killed."""
    import ray_tpu_torch

    head = head or ray_tpu_torch._global_head()
    if head is None:
        return False
    with head._lock:
        info = head.gcs.get_actor_info(actor._actor_id)
        wid = info.worker_id if info is not None else None
        handle = None
        if wid is not None:
            _, handle = head._find_worker(wid)
    if handle is None or handle.proc is None:
        return False
    try:
        handle.proc.kill()
        return True
    except Exception:
        return False


def kill_mesh_rank(group, rank: Optional[int] = None,
                   rng: Optional[random.Random] = None,
                   head=None) -> Optional[int]:
    """Kill one rank of a MeshGroup / Train WorkerGroup by murdering its
    hosting worker process.  `rank=None` picks one with the seeded `rng`
    (deterministic chaos).  Returns the killed rank, or None if nothing
    could be killed."""
    workers = getattr(group, "workers", group)
    if not workers:
        return None
    if rank is None:
        rng = rng or random.Random()
        rank = rng.randrange(len(workers))
    return rank if _kill_actor_process(workers[rank], head=head) else None


def kill_node(proc) -> bool:
    """SIGKILL an entire node: the agent subprocess AND every worker it
    spawned, atomically via its process group (start the agent with
    start_new_session=True — util.testing.start_node_agent does).  Falls
    back to killing just the agent when it shares our group.  This is the
    driver-side node-killer for chaos tests (reference:
    python/ray/_private/test_utils.py:1337 node killer)."""
    import signal

    pid = getattr(proc, "pid", proc)
    try:
        pgid = os.getpgid(pid)
    except OSError:
        return False
    try:
        if pgid != os.getpgid(0):
            os.killpg(pgid, signal.SIGKILL)
        else:
            os.kill(pid, signal.SIGKILL)
        return True
    except OSError:
        return False


def kill_random_worker(head=None, rng: Optional[random.Random] = None) -> bool:
    """Kill one random busy worker process (crash injection). Returns True
    if something was killed."""
    import ray_tpu_torch

    head = head or ray_tpu_torch._global_head()
    rng = rng or random.Random()
    with head._lock:
        candidates = [
            w for r in head.raylets.values() for w in r.workers.values()
            if w.proc is not None and w.conn is not None
        ]
    if not candidates:
        return False
    victim = rng.choice(candidates)
    try:
        victim.proc.kill()
        return True
    except Exception:
        return False
