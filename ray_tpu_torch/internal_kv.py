"""Internal KV store on the GCS (reference: ray.experimental.internal_kv).

Copied from ``ray_tpu/internal_kv.py`` (the JAX package).
"""
from __future__ import annotations

from typing import List, Optional


def _req(payload: dict):
    from ray_tpu_torch import _worker

    return _worker().transport.request("kv", payload)


def kv_put(key: bytes, value: bytes, overwrite: bool = True,
           namespace: str = "default") -> bool:
    return _req({"verb": "put", "key": key, "value": value,
                 "overwrite": overwrite, "namespace": namespace})


def kv_get(key: bytes, namespace: str = "default") -> Optional[bytes]:
    return _req({"verb": "get", "key": key, "namespace": namespace})


def kv_del(key: bytes, namespace: str = "default"):
    return _req({"verb": "del", "key": key, "namespace": namespace})


def kv_keys(prefix: bytes = b"", namespace: str = "default") -> List[bytes]:
    return _req({"verb": "keys", "prefix": prefix, "namespace": namespace})
