"""ASGI ingress: serve any ASGI application (Starlette/FastAPI-shaped)
behind deployments and the HTTP proxy (copy of ``ray_tpu/serve/asgi.py``).

Reference: serve.ingress + the ASGI receive/send plumbing in
serve/_private/http_util.py (ASGIHTTPSender) and proxy — re-implemented
on the stdlib: the replica drives the app's ``(scope, receive, send)``
protocol with asyncio and returns a plain response dict, so the proxy and
DeploymentHandle callers stay transport-agnostic.
"""
from __future__ import annotations

import asyncio
from typing import Any, Callable, Dict, Optional
from urllib.parse import urlsplit


class ASGIAdapter:
    """Drives one ASGI app.  ``handle(request_dict) -> response_dict``
    where request = {method, path, query_string, headers, body} and
    response = {status, headers, body}; headers travel as a LIST of
    (name, value) pairs end-to-end so duplicates (Set-Cookie) survive."""

    def __init__(self, app: Callable):
        import threading

        self.app = app
        # One persistent loop per adapter: a per-request asyncio.run would
        # pay loop setup/teardown on the serving hot path and break apps
        # holding loop-bound state (sessions, locks) across requests.
        self._loop = asyncio.new_event_loop()
        self._loop_lock = threading.Lock()

    def handle(self, request: Dict[str, Any]) -> Dict[str, Any]:
        with self._loop_lock:  # replicas may serve from several threads
            return self._loop.run_until_complete(self._run(request))

    async def _run(self, request: Dict[str, Any]) -> Dict[str, Any]:
        split = urlsplit(request.get("path", "/"))
        scope = {
            "type": "http",
            "asgi": {"version": "3.0", "spec_version": "2.3"},
            "http_version": "1.1",
            "method": request.get("method", "GET").upper(),
            "path": split.path or "/",
            "raw_path": (split.path or "/").encode(),
            "query_string": (request.get("query_string")
                             or split.query or "").encode()
            if isinstance(request.get("query_string", ""), str)
            else request.get("query_string", b""),
            "headers": [(k.lower().encode(), v.encode())
                        for k, v in _header_pairs(request.get("headers"))],
            "server": ("ray_tpu_torch-serve", 0),
            "client": ("127.0.0.1", 0),
            "scheme": "http",
            "root_path": "",
        }
        body = request.get("body") or b""
        if isinstance(body, str):
            body = body.encode()
        received = {"sent": False}

        async def receive():
            if received["sent"]:
                return {"type": "http.disconnect"}
            received["sent"] = True
            return {"type": "http.request", "body": body,
                    "more_body": False}

        response = {"status": 500, "headers": [], "body": b""}
        chunks = []

        async def send(message):
            if message["type"] == "http.response.start":
                response["status"] = message["status"]
                response["headers"] = [
                    (k.decode(), v.decode())
                    for k, v in message.get("headers") or []]
            elif message["type"] == "http.response.body":
                chunks.append(message.get("body") or b"")

        await self.app(scope, receive, send)
        response["body"] = b"".join(chunks)
        return response


def _header_pairs(headers) -> list:
    """Accept either a dict or a list of (name, value) pairs."""
    if headers is None:
        return []
    if isinstance(headers, dict):
        return list(headers.items())
    return list(headers)


class _IngressCallable:
    """The replica-side callable serve.ingress deploys: builds the adapter
    once per replica, exposes the dict protocol."""

    def __init__(self, app_builder):
        if _looks_like_app(app_builder):
            app = app_builder
        elif callable(app_builder):
            app = app_builder()  # zero-arg factory (builds per replica)
        else:
            raise TypeError("ingress() wants an ASGI app or a factory")
        self._adapter = ASGIAdapter(app)

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        return self._adapter.handle(request)


def _looks_like_app(obj) -> bool:
    """ASGI apps are callables taking (scope, receive, send)."""
    import inspect

    try:
        sig = inspect.signature(obj)
        return len(sig.parameters) >= 3
    except (TypeError, ValueError):
        return False


def ingress(app, *, name: Optional[str] = None, num_replicas: int = 1,
            autoscaling_config: Optional[dict] = None):
    """Wrap an ASGI app (or zero-arg factory returning one) as a
    Deployment; the proxy routes every method under /<name>/... to it."""
    from ray_tpu_torch.serve.api import Deployment

    dep = Deployment(_IngressCallable,
                     name or getattr(app, "__name__", "ingress"),
                     num_replicas, None, None, autoscaling_config)
    dep.bind(app)
    dep.is_ingress = True
    return dep
