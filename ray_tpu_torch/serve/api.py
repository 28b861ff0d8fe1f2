"""Serve API: @deployment, run, handles, HTTP proxy (copy of
``ray_tpu/serve/api.py``).

A replica is an actor of the port's runtime; one that needs the card
asks for it in ``ray_actor_options={"num_gpus": ...}`` (a fraction below
1 shares the card with other such workers).  The proxy bookkeeping
(``_node_proxies``, ``_demoted_proxies``, ``_proxy_strikes``) is kept
under ``_proxy_lock``, as in the reference."""
from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional

import ray_tpu_torch

# Seconds a replica's reconfigure or a proxy's start may take before its
# get gives up: a replica that hangs fails the call instead of stalling
# the caller forever.  Requests stay unbounded, as in the reference.
_GET_S = 600.0

_deployments: Dict[str, "Deployment"] = {}
_proxy = None


@ray_tpu_torch.remote
class _Replica:
    """Hosts one copy of the user callable (reference: RayServeReplica,
    serve/_private/replica.py:260).  The callable owns whatever devices
    its worker sees: with ``num_gpus`` in ``ray_actor_options``, the
    card."""

    def __init__(self, cls_or_fn, init_args, init_kwargs):
        if isinstance(cls_or_fn, type):
            self._callable = cls_or_fn(*init_args, **init_kwargs)
        else:
            self._callable = cls_or_fn
        self._queued = 0

    def handle_request(self, method: str, args, kwargs):
        target = (self._callable if method == "__call__"
                  else getattr(self._callable, method))
        if not callable(target):
            raise TypeError(f"{method} is not callable on this deployment")
        return target(*args, **kwargs)

    def queue_len(self) -> int:
        return self._queued

    def drain(self) -> bool:
        """Teardown hook: close the callable's batchers (waking blocked
        submitters with a typed error) and, if the callable exposes its
        own drain (e.g. llm_engine.LLMServer), run it — so killing the
        replica never strands callers mid-queue."""
        from ray_tpu_torch.serve import batching

        fn = getattr(self._callable, "drain", None)
        if callable(fn):
            try:
                fn()
            except Exception:
                pass
        batching.close_instance_batchers(self._callable)
        return True

    def reconfigure(self, user_config):
        fn = getattr(self._callable, "reconfigure", None)
        if fn is not None:
            fn(user_config)
        return True


def _replica_key(r) -> str:
    """Stable identity of a replica actor across handle copies (the
    rendezvous-hash input for cache-affinity routing)."""
    aid = getattr(r, "_actor_id", None)
    if aid is None:
        return f"id:{id(r)}"
    try:
        return aid.hex()
    except AttributeError:
        return str(aid)


class DeploymentHandle:
    """Router over a *mutable* replica set: least-loaded assignment with an
    in-flight cap, live queue metrics for the controller, and dynamic
    add/remove so autoscaling reconfigures in place (reference:
    Router/ReplicaSet, serve/_private/router.py:62,221).

    **Cache-affinity routing**: ``remote(..., _affinity=key)`` rendezvous-
    hashes the key over the live replica ids (serve/prefix_cache.py), so
    every router — driver handle and every node proxy — sends requests
    sharing a prompt prefix to the replica already holding its cached KV
    pages, with no shared routing state and automatic remapping when
    autoscaling changes the set.  A saturated preferred replica falls
    back to the normal least-loaded path (affinity is a hint, never a
    hotspot amplifier)."""

    def __init__(self, name: str, replicas: List[Any],
                 max_in_flight_per_replica: int = 8):
        self.name = name
        self._replicas: List[Any] = list(replicas)
        self._in_flight: Dict[Any, int] = {r: 0 for r in self._replicas}
        self._rr = 0
        self._cap = max_in_flight_per_replica
        self._lock = threading.Lock()
        self._affinity_hits = 0
        self._affinity_misses = 0

    def __reduce__(self):
        # A handle serializes as a SNAPSHOT of its replica set (actor
        # handles pickle; the lock and in-flight counters are
        # per-process router state, rebuilt empty).  This is what lets
        # a deployment handle ride bind args into another deployment's
        # replicas — e.g. the decode engine's ``prefill=`` handle.  The
        # copy does not see later autoscale events (the node proxies'
        # route broadcast is the pattern for that).
        with self._lock:
            return (DeploymentHandle,
                    (self.name, list(self._replicas), self._cap))

    def remote(self, *args, _method: str = "__call__",
               _affinity: Optional[str] = None, **kwargs):
        with self._lock:
            if not self._replicas:
                raise RuntimeError(f"deployment {self.name} has no replicas")
            n = len(self._replicas)
            pick = None
            if _affinity is not None:
                from ray_tpu_torch.serve.prefix_cache import rendezvous_pick

                i = rendezvous_pick(
                    _affinity, [_replica_key(r) for r in self._replicas])
                cand = self._replicas[i]
                if self._in_flight[cand] < self._cap:
                    pick = cand
                    self._affinity_hits += 1
                else:
                    self._affinity_misses += 1
            # Round-robin start, pick the first under-cap replica; when all
            # are saturated take the least loaded (requests queue in the
            # actor's mailbox — that queue depth is the autoscaling signal).
            if pick is None:
                for k in range(n):
                    r = self._replicas[(self._rr + k) % n]
                    if self._in_flight[r] < self._cap:
                        pick = r
                        break
            if pick is None:
                pick = min(self._replicas, key=lambda r: self._in_flight[r])
            self._rr = (self._rr + 1) % max(1, n)
            self._in_flight[pick] += 1
        ref = pick.handle_request.remote(_method, args, kwargs)

        def done(_f):
            with self._lock:
                if pick in self._in_flight:
                    self._in_flight[pick] -= 1

        try:
            ref.future().add_done_callback(done)
        except Exception:
            with self._lock:
                if pick in self._in_flight:
                    self._in_flight[pick] -= 1
        return ref

    def method(self, name: str):
        h = self

        class _M:
            def remote(self, *a, **kw):
                return h.remote(*a, _method=name, **kw)

        return _M()

    # ---- controller surface ----
    def queue_stats(self) -> Dict[str, float]:
        """Total and per-replica in-flight load (the metric the reference's
        replicas push to the controller, serve/_private/autoscaling_metrics)."""
        with self._lock:
            total = sum(self._in_flight.values())
            n = max(1, len(self._replicas))
            return {"total_in_flight": float(total),
                    "avg_per_replica": total / n,
                    "num_replicas": len(self._replicas),
                    "affinity_hits": float(self._affinity_hits),
                    "affinity_misses": float(self._affinity_misses)}

    def add_replica(self, replica):
        with self._lock:
            self._replicas.append(replica)
            self._in_flight[replica] = 0

    def set_replicas(self, replicas):
        """Swap the replica set IN PLACE, matching by actor id: retained
        replicas keep their handle objects (so outstanding requests'
        done-callbacks still decrement the live counters — a rebuilt
        handle would zero the autoscaling signal on every broadcast)."""
        with self._lock:
            by_id = {r._actor_id: r for r in self._replicas}
            new_list = []
            for r in replicas:
                existing = by_id.pop(getattr(r, "_actor_id", None), None)
                if existing is not None:
                    new_list.append(existing)
                else:
                    new_list.append(r)
                    self._in_flight[r] = 0
            self._replicas = new_list
            for gone in by_id.values():
                self._in_flight.pop(gone, None)

    def pop_replica(self):
        """Remove (and return) the least-loaded replica, or None at size 1.

        Routing stops immediately, but the in-flight counter entry is KEPT
        so outstanding requests keep decrementing it — the controller
        drains on in_flight_of() before killing, then forget_replica()."""
        with self._lock:
            if len(self._replicas) <= 1:
                return None
            r = min(self._replicas, key=lambda x: self._in_flight[x])
            self._replicas.remove(r)
            return r

    def in_flight_of(self, replica) -> int:
        with self._lock:
            return self._in_flight.get(replica, 0)

    def forget_replica(self, replica):
        with self._lock:
            self._in_flight.pop(replica, None)

    @property
    def num_replicas(self):
        with self._lock:
            return len(self._replicas)


class Deployment:
    def __init__(self, cls_or_fn, name: str, num_replicas: int = 1,
                 ray_actor_options: Optional[dict] = None,
                 user_config: Any = None,
                 autoscaling_config: Optional[dict] = None):
        self._func = cls_or_fn
        self.name = name
        self.num_replicas = num_replicas
        self.ray_actor_options = ray_actor_options or {}
        self.user_config = user_config
        self.autoscaling_config = autoscaling_config
        self._init_args: tuple = ()
        self._init_kwargs: dict = {}
        self.handle: Optional[DeploymentHandle] = None
        self._replicas: List[Any] = []

    def bind(self, *args, **kwargs) -> "Deployment":
        self._init_args = args
        self._init_kwargs = kwargs
        return self

    def options(self, **kw) -> "Deployment":
        import copy

        d = copy.copy(self)
        # The shallow copy must not alias the replica list — a teardown of
        # one deployment would otherwise kill its siblings' replicas.
        d._replicas = []
        d.handle = None
        for k, v in kw.items():
            setattr(d, k, v)
        return d

    # ---- lifecycle ----
    def _make_replica(self):
        opts = dict(self.ray_actor_options)
        opts.setdefault("max_concurrency", 8)
        r = _Replica.options(**opts).remote(self._func, self._init_args,
                                            self._init_kwargs)
        if self.user_config is not None:
            ray_tpu_torch.get(r.reconfigure.remote(self.user_config),
                              timeout=_GET_S)
        self._replicas.append(r)
        return r

    def _deploy(self) -> DeploymentHandle:
        self._replicas = []
        start = self.num_replicas
        if self.autoscaling_config:
            start = max(int(self.autoscaling_config.get("min_replicas", 1)),
                        min(start, int(self.autoscaling_config.get(
                            "max_replicas", start))))
        replicas = [self._make_replica() for _ in range(start)]
        self.handle = DeploymentHandle(self.name, replicas)
        if self.autoscaling_config:
            from ray_tpu_torch.serve.controller import get_controller

            get_controller().watch(self)
        return self.handle

    def _teardown(self):
        from ray_tpu_torch.serve.controller import get_controller

        get_controller().unwatch(self)
        # Drain before kill: close each replica's batchers so submitters
        # blocked on a batcher future get a typed BatcherClosedError
        # instead of hanging on a killed actor forever.
        acks = []
        for r in self._replicas:
            try:
                acks.append(r.drain.remote())
            except Exception:
                pass
        for a in acks:
            try:
                ray_tpu_torch.get(a, timeout=5)
            except Exception:
                pass
        for r in self._replicas:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        self._replicas = []


def deployment(_func=None, *, name: Optional[str] = None,
               num_replicas: int = 1, ray_actor_options: Optional[dict] = None,
               user_config: Any = None,
               autoscaling_config: Optional[dict] = None):
    """@serve.deployment (reference: serve/api.py:251)."""

    def wrap(cls_or_fn):
        return Deployment(cls_or_fn, name or cls_or_fn.__name__,
                          num_replicas, ray_actor_options, user_config,
                          autoscaling_config)

    if _func is not None:
        return wrap(_func)
    return wrap


def run(dep: Deployment, name: Optional[str] = None) -> DeploymentHandle:
    """serve.run (reference: serve/api.py:455)."""
    key = name or dep.name
    old = _deployments.pop(key, None)
    if old is not None:
        # Unroute everywhere FIRST (proxies briefly 404 the name), then
        # free the old replicas' resources before deploying the new ones
        # — deploy-before-teardown would deadlock a redeploy whose old
        # replicas hold resources the new ones need, and broadcast-after-
        # kill would route proxies at corpses.
        broadcast_routes()
        old._teardown()
    try:
        handle = dep._deploy()
    except BaseException:
        if old is not None:
            # Roll back: a failed redeploy must not leave a previously
            # healthy name with zero replicas.
            try:
                old._deploy()
                _deployments[key] = old
                broadcast_routes()
            except Exception:
                pass
        raise
    _deployments[key] = dep
    broadcast_routes()
    return handle


def get_deployment_handle(name: str) -> DeploymentHandle:
    return _deployments[name].handle


def delete(name: str):
    dep = _deployments.pop(name, None)
    # Unroute everywhere first, then kill.
    broadcast_routes()
    if dep is not None:
        dep._teardown()


def shutdown():
    global _proxy
    for name in list(_deployments):
        delete(name)
    # Driver-process batchers (plain-function @serve.batch, local-mode
    # replicas): close them here — their daemon threads and any blocked
    # submitters don't die with a remote actor.
    from ray_tpu_torch.serve import batching

    batching.shutdown_batchers()
    if _proxy is not None:
        _proxy.shutdown()
        _proxy = None
    with _proxy_lock:
        doomed = _node_proxies + _demoted_proxies
        _node_proxies.clear()
        _demoted_proxies.clear()
        _proxy_strikes.clear()
    for p in doomed:
        try:
            ray_tpu_torch.kill(p)
        except Exception:
            pass
    from ray_tpu_torch.serve.controller import reset_controller

    reset_controller()


def _make_http_handler(resolve):
    """HTTP handler class over a route resolver: ``resolve(name)`` →
    (DeploymentHandle, is_ingress) or None.  The driver proxy resolves
    against the live ``_deployments`` registry; per-node proxy ACTORS
    resolve against their broadcast route table — one handler, two
    routers (reference: HTTPProxy's shared request path,
    serve/_private/http_proxy.py:230)."""
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def _route(self):
            from urllib.parse import urlsplit

            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) if length else b""
            split = urlsplit(self.path)
            # Name comes from the PATH only — '/echo?x=1' must route
            # to 'echo', not 404 on a name containing the query.
            name = split.path.strip("/").split("/")[0]
            resolved = resolve(name)
            if resolved is None:
                self.send_response(404)
                self.end_headers()
                self.wfile.write(b'{"error": "no such deployment"}')
                return
            handle, is_ingress = resolved
            if is_ingress:
                # ASGI path: ship the full request dict; the replica
                # drives the app and returns {status, headers, body}.
                sub = split.path[len(name) + 1:] or "/"
                req = {"method": self.command, "path": sub,
                       "query_string": split.query,
                       "headers": list(self.headers.items()),
                       "body": body}
                try:
                    resp = ray_tpu_torch.get(handle.remote(req))
                except Exception as e:  # noqa: BLE001
                    out = json.dumps({"error": str(e)}).encode()
                    self.send_response(500)
                    self.send_header("Content-Length", str(len(out)))
                    self.end_headers()
                    self.wfile.write(out)
                    return
                payload = resp.get("body") or b""
                self.send_response(resp.get("status", 200))
                hdrs = resp.get("headers") or []
                hdrs = hdrs.items() if isinstance(hdrs, dict) else hdrs
                for k, v in hdrs:
                    if k.lower() != "content-length":
                        self.send_header(k, v)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                return
            if self.command != "POST":
                # Plain JSON deployments keep the POST-only contract:
                # stray GETs (crawlers, health checks) must not invoke
                # user code with a None payload.
                self.send_response(405)
                self.end_headers()
                self.wfile.write(b'{"error": "POST only"}')
                return
            try:
                payload = json.loads(body) if body else None
                affinity = None
                if isinstance(payload, dict) and payload.get("tokens"):
                    # LLM-shaped request: route by prompt-prefix affinity
                    # so shared prefixes land on the replica that cached
                    # their KV pages.
                    from ray_tpu_torch.serve.prefix_cache import affinity_key

                    affinity = affinity_key(payload["tokens"])
                result = ray_tpu_torch.get(handle.remote(payload,
                                                   _affinity=affinity))
                out = json.dumps({"result": result}).encode()
                self.send_response(200)
            except Exception as e:  # noqa: BLE001
                out = json.dumps({"error": str(e)}).encode()
                self.send_response(500)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        do_POST = do_GET = do_PUT = do_DELETE = do_PATCH = _route

        def log_message(self, *a):
            pass

    return Handler


def _driver_resolve(name: str):
    dep = _deployments.get(name)
    if dep is None or dep.handle is None:
        return None
    return dep.handle, bool(getattr(dep, "is_ingress", False))


class _HttpProxy:
    """Threaded stdlib HTTP server forwarding POST /<deployment> bodies
    (JSON) to handles (reference: HTTPProxy ASGI actor)."""

    def __init__(self, port: int, resolve=None, bind: str = "127.0.0.1"):
        import http.server

        handler = _make_http_handler(resolve or _driver_resolve)
        self.server = http.server.ThreadingHTTPServer((bind, port), handler)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def shutdown(self):
        self.server.shutdown()


@ray_tpu_torch.remote
class HTTPProxyActor:
    """Per-node HTTP ingress (reference: one HTTPProxy actor per node,
    serve/_private/http_proxy.py:230).  Routes against a broadcast table
    of replica actor handles — the driver pushes updates on every deploy/
    delete/autoscale event, so all node proxies serve one coherent route
    table while keeping their in-flight accounting local (the reference's
    routers are also proxy-local)."""

    def __init__(self, port: int = 0, bind: str = "0.0.0.0"):
        self._routes: Dict[str, DeploymentHandle] = {}
        self._ingress: Dict[str, bool] = {}
        self._lock = threading.Lock()

        def resolve(name):
            with self._lock:
                h = self._routes.get(name)
                if h is None:
                    return None
                return h, self._ingress.get(name, False)

        self._proxy = _HttpProxy(port, resolve=resolve, bind=bind)

    def ready(self) -> int:
        return self._proxy.port

    def update_routes(self, routes: Dict[str, dict]) -> bool:
        """routes: {name: {"replicas": [actor handles], "is_ingress": b}}.
        Existing handles update in place (set_replicas) so in-flight
        counters — the autoscaling signal — survive a broadcast."""
        with self._lock:
            new_routes: Dict[str, DeploymentHandle] = {}
            for name, r in routes.items():
                h = self._routes.get(name)
                if h is None:
                    h = DeploymentHandle(name, r["replicas"])
                else:
                    h.set_replicas(r["replicas"])
                new_routes[name] = h
            self._routes = new_routes
            self._ingress = {name: bool(r.get("is_ingress"))
                             for name, r in routes.items()}
        return True

    def queue_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-deployment in-flight load at THIS proxy — the autoscaling
        signal the controller aggregates across proxies (reference: the
        replicas' autoscaling metric push, autoscaling_metrics.py)."""
        with self._lock:
            return {name: h.queue_stats()
                    for name, h in self._routes.items()}


_node_proxies: List[Any] = []
_demoted_proxies: List[Any] = []
_proxy_strikes: Dict[str, int] = {}
# One lock for the three structures above: the controller loop, a
# concurrent broadcast_routes() (deploy from another thread) and shutdown()
# all mutate them; unsynchronized list surgery loses strikes or double-
# demotes.  Strikes are keyed by the proxy's stable actor id — handle
# objects for the same actor may differ (deserialized copies), and id() of
# a dead handle can be recycled by the allocator.
_proxy_lock = threading.Lock()
_PROXY_MAX_STRIKES = 3


def _proxy_key(p) -> str:
    aid = getattr(p, "_actor_id", None)
    if aid is not None:
        try:
            return aid.hex()
        except AttributeError:
            return str(aid)
    return f"id:{id(p)}"


def _proxy_ok(p):
    with _proxy_lock:
        _proxy_strikes.pop(_proxy_key(p), None)


def _proxy_failed(p):
    """Strike a proxy; after 3 consecutive failures DEMOTE it — its RPC
    timeout must not stall every controller poll, but a merely-slow
    proxy on a live node keeps its listening socket and still receives
    best-effort route broadcasts (a successful broadcast ack promotes it
    back); killing it would turn three slow polls into a permanent
    ingress outage for that node."""
    key = _proxy_key(p)
    with _proxy_lock:
        n = _proxy_strikes.get(key, 0) + 1
        _proxy_strikes[key] = n
        if n >= _PROXY_MAX_STRIKES:
            try:
                _node_proxies.remove(p)
            except ValueError:
                pass
            if p not in _demoted_proxies:
                _demoted_proxies.append(p)
            _proxy_strikes.pop(key, None)


def start_http_proxy(port: int = 0) -> int:
    """Start the driver-local HTTP ingress; returns the bound port."""
    global _proxy
    if _proxy is None:
        _proxy = _HttpProxy(port)
    return _proxy.port


def start_http_proxies(port: int = 0) -> Dict[str, int]:
    """Per-node ingress (reference: ProxyLocation.EveryNode): one
    HTTPProxyActor pinned to EACH cluster node, all serving the same
    route table.  Returns {node_id_hex: bound_port}."""
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    global _node_proxies
    nodes = [n["node_id"] for n in ray_tpu_torch.nodes() if n.get("alive", True)]
    out = {}
    for node_hex in nodes:
        actor = HTTPProxyActor.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(node_hex),
            max_concurrency=16).remote(port)
        out[node_hex] = ray_tpu_torch.get(actor.ready.remote(),
                                          timeout=_GET_S)
        with _proxy_lock:
            _node_proxies.append(actor)
    broadcast_routes()
    return out


def _current_routes() -> Dict[str, dict]:
    return {name: {"replicas": list(dep._replicas),
                   "is_ingress": bool(getattr(dep, "is_ingress", False))}
            for name, dep in _deployments.items()
            if dep.handle is not None}


def collect_proxy_stats() -> Dict[str, float]:
    """ONE stats RPC per proxy per controller tick (shared across every
    watched deployment): {deployment: summed in-flight across proxies}.
    A proxy failing the poll takes exactly one strike per tick."""
    totals: Dict[str, float] = {}
    with _proxy_lock:
        healthy = list(_node_proxies)
    for p in healthy:
        try:
            pstats = ray_tpu_torch.get(p.queue_stats.remote(), timeout=5)
            _proxy_ok(p)
        except Exception:
            _proxy_failed(p)
            continue
        for name, s in pstats.items():
            totals[name] = totals.get(name, 0.0) \
                + s.get("total_in_flight", 0.0)
    return totals


def aggregate_queue_stats(name: str, handle: DeploymentHandle,
                          proxy_totals: Optional[Dict[str, float]] = None
                          ) -> Dict[str, float]:
    """Cluster-wide queue metric for one deployment: the driver handle's
    local in-flight plus every node proxy's — requests entering through
    per-node ingress must drive autoscaling exactly like driver-side
    calls.  Pass ``proxy_totals`` (collect_proxy_stats) to share one
    poll across deployments."""
    if proxy_totals is None:
        proxy_totals = collect_proxy_stats()
    stats = handle.queue_stats()
    total = stats["total_in_flight"] + proxy_totals.get(name, 0.0)
    n = max(1, handle.num_replicas)
    return {"total_in_flight": float(total),
            "avg_per_replica": total / n,
            "num_replicas": handle.num_replicas}


def broadcast_routes() -> None:
    """Push the deployment→replicas table to every node proxy (called on
    deploy/delete and by the controller after autoscale events).  Waits
    for the acks: serve.run() returning must mean every ingress routes
    the new deployment."""
    with _proxy_lock:
        healthy_snap = list(_node_proxies)
        demoted_snap = list(_demoted_proxies)
    if not healthy_snap:
        return
    routes = _current_routes()
    acks = []
    for p in healthy_snap:
        try:
            acks.append((p, False, p.update_routes.remote(routes)))
        except Exception:
            _proxy_failed(p)
    for p in demoted_snap:
        try:
            acks.append((p, True, p.update_routes.remote(routes)))
        except Exception:
            pass
    for p, demoted, a in acks:
        try:
            ray_tpu_torch.get(a, timeout=10)
            if demoted:
                # The proxy answered again: back into the healthy pool.
                with _proxy_lock:
                    try:
                        _demoted_proxies.remove(p)
                    except ValueError:
                        pass
                    if p not in _node_proxies:
                        _node_proxies.append(p)
            _proxy_ok(p)
        except Exception:
            if not demoted:
                _proxy_failed(p)
