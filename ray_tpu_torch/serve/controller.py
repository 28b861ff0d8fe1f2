"""Serve controller: the reconciliation loop that makes autoscaling real
(copy of ``ray_tpu/serve/controller.py``).

Reference: ServeController + DeploymentState reconciliation
(serve/controller.py:60, serve/_private/deployment_state.py:962) driven by
replica queue metrics (serve/_private/autoscaling_metrics.py) through
calculate_desired_num_replicas (autoscaling_policy.py:10-49).

Design difference: our router lives driver-side (DeploymentHandle), so the
queue metric — in-flight requests per replica — is read directly from the
handle instead of being pushed via actor gauges; the control loop is a
daemon thread in the serve process rather than a dedicated controller
actor.  The policy math and the scale-up/down mechanics match the
reference's semantics: desired = policy(current, avg_queued), replicas are
added/removed in place, downscale picks the least-loaded replica.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.autoscaling import calculate_desired_num_replicas


class ServeController:
    def __init__(self, interval_s: float = 1.0):
        self.interval_s = interval_s
        self._watched: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Rolling queue-metric window per deployment (smooths one-poll
        # spikes the way the reference's look_back_period does).
        self._window: Dict[str, list] = {}

    def watch(self, deployment):
        with self._lock:
            self._watched[deployment.name] = deployment
            self._window.setdefault(deployment.name, [])
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="rtpu-serve-controller",
                    daemon=True)
                self._thread.start()

    def unwatch(self, deployment):
        with self._lock:
            self._watched.pop(deployment.name, None)
            self._window.pop(deployment.name, None)

    def _run(self):
        while not self._stop.wait(self.interval_s):
            with self._lock:
                deployments = list(self._watched.values())
            # One proxy-stats poll per tick, shared by every deployment.
            try:
                from ray_tpu_torch.serve.api import collect_proxy_stats

                proxy_totals = collect_proxy_stats()
            except Exception:
                proxy_totals = {}
            for dep in deployments:
                try:
                    self._reconcile(dep, proxy_totals)
                except Exception:
                    import traceback

                    traceback.print_exc()

    def _reconcile(self, dep, proxy_totals=None):
        handle = dep.handle
        cfg = dep.autoscaling_config or {}
        if handle is None:
            return
        from ray_tpu_torch.serve.api import aggregate_queue_stats

        stats = aggregate_queue_stats(dep.name, handle, proxy_totals)
        signal = stats["avg_per_replica"]
        if cfg.get("metric_method"):
            # Replica-reported load (e.g. LLMServer.autoscale_metric —
            # in-flight work per decode slot): richer than router queue
            # depth for engines that batch internally, where 8 queued
            # requests on one replica may be a full batch (scale!) or
            # an eighth of one (don't).  Best-effort: an unreachable
            # replica falls back to the queue signal for this tick.
            vals = self._poll_replica_metric(dep, cfg["metric_method"])
            if vals:
                signal = sum(vals) / len(vals)
        win = self._window.setdefault(dep.name, [])
        win.append(signal)
        look_back = max(1, int(cfg.get("look_back_polls", 3)))
        del win[:-look_back]
        avg = sum(win) / len(win)
        current = stats["num_replicas"]
        desired = calculate_desired_num_replicas(
            current_num_replicas=current,
            avg_queued_per_replica=avg,
            target_queued_per_replica=float(
                cfg.get("target_num_ongoing_requests_per_replica", 1.0)),
            min_replicas=int(cfg.get("min_replicas", 1)),
            max_replicas=int(cfg.get("max_replicas", current)),
            smoothing_factor=float(cfg.get("smoothing_factor", 1.0)))
        from ray_tpu_torch.serve import api as serve_api

        scaled = desired != handle.num_replicas
        while desired > handle.num_replicas:
            handle.add_replica(dep._make_replica())
        doomed = []
        while desired < handle.num_replicas:
            r = handle.pop_replica()
            if r is None:
                break
            try:
                dep._replicas.remove(r)
            except ValueError:
                pass
            doomed.append(r)
        if scaled:
            # Broadcast BEFORE any kill: node proxies must stop routing
            # to a doomed replica before it dies, or their in-window
            # requests land on a corpse.
            serve_api.broadcast_routes()
        for r in doomed:
            # Graceful drain (reference: DeploymentState stops a replica
            # only after it finishes outstanding requests): routing
            # stopped at pop_replica + broadcast; wait for in-flight to
            # hit zero (driver side; proxy-side stragglers are covered by
            # the same drain window).
            deadline = time.time() + float(
                cfg.get("downscale_drain_timeout_s", 5.0))
            while handle.in_flight_of(r) > 0 and time.time() < deadline:
                time.sleep(0.05)
            handle.forget_replica(r)
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass

    def _poll_replica_metric(self, dep, method: str):
        """One round of replica-load samples, polled concurrently with a
        bounded wait — a slow replica costs one tick's sample, never a
        stalled control loop."""
        refs = []
        for r in list(dep._replicas):
            try:
                refs.append(r.handle_request.remote(method, (), {}))
            except Exception:
                continue
        vals = []
        for ref in refs:
            try:
                vals.append(float(ray_tpu_torch.get(ref, timeout=5)))
            except Exception:
                continue
        return vals

    def shutdown(self):
        self._stop.set()
        with self._lock:
            self._watched.clear()
            self._window.clear()


_controller: Optional[ServeController] = None


def get_controller() -> ServeController:
    global _controller
    if _controller is None:
        from ray_tpu_torch._private.config import CONFIG

        _controller = ServeController(
            interval_s=CONFIG.serve_control_interval_s)
    return _controller


def reset_controller():
    global _controller
    if _controller is not None:
        _controller.shutdown()
        _controller = None
