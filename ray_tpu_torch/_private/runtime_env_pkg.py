"""py_modules runtime env: content-hash packaging + a worker-side URI cache.

Reference: python/ray/_private/runtime_env/packaging.py (local dirs are
zipped, content-hashed into ``gcs://_ray_pkg_<hash>.zip`` URIs and pushed
to the GCS KV) and uri_cache.py (workers download/unpack once per URI).
TPU-native redesign: the zip bytes ride the head's existing KV plane
(namespace ``_pkgs``) over the control connection — no side channel, and
a restarted head repopulates from its snapshot like any other KV state.

Driver side: ``normalize_py_modules`` rewrites local paths / imported
modules in ``runtime_env["py_modules"]`` to ``pkg://<sha256>`` URIs,
uploading each package at most once per content hash.  Worker side:
``ensure_local`` materializes a URI into a per-node cache directory
(atomic rename, shared by all workers on the node) and
``_PyModulesOverlay`` prepends the cached roots to sys.path for the
task's duration — refcounted like the working_dir overlay, adopted for
the worker's lifetime on actor creation.

Copied from ``ray_tpu/_private/runtime_env_pkg.py`` (the JAX package).
"""
from __future__ import annotations

import hashlib
import io
import os
import threading
import zipfile
from typing import List, Optional, Tuple

PKG_SCHEME = "pkg://"
KV_NAMESPACE = "_pkgs"
# Mirrors the reference's GCS_STORAGE_MAX_SIZE warning threshold
# (packaging.py): bigger uploads work but stall the control plane.
WARN_SIZE = 100 * 1024 * 1024

_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}


def _iter_files(root: str):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in _EXCLUDE_DIRS)
        for f in sorted(filenames):
            if f.endswith((".pyc", ".pyo")):
                continue
            yield os.path.join(dirpath, f)


def package_path(path: str) -> Tuple[str, bytes]:
    """Zip a local directory (as a top-level package dir) or a single
    module file; returns (pkg://<hash>, zip_bytes).  The hash covers
    relative paths + file contents, so identical sources dedupe and any
    edit produces a fresh URI (reference: packaging.py hash semantics)."""
    path = os.path.abspath(path)
    h = hashlib.sha256()
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        if os.path.isdir(path):
            base = os.path.basename(path.rstrip(os.sep))
            for fp in _iter_files(path):
                rel = os.path.join(base, os.path.relpath(fp, path))
                h.update(rel.encode())
                with open(fp, "rb") as fh:
                    data = fh.read()
                h.update(data)
                zf.writestr(rel, data)
        elif os.path.isfile(path):
            rel = os.path.basename(path)
            h.update(rel.encode())
            with open(path, "rb") as fh:
                data = fh.read()
            h.update(data)
            zf.writestr(rel, data)
        else:
            raise FileNotFoundError(f"py_modules entry {path!r} not found")
    return PKG_SCHEME + h.hexdigest(), buf.getvalue()


def _module_root(mod) -> str:
    """An imported module/package object → its source path (reference:
    py_modules accepts module objects, runtime_env/py_modules.py)."""
    f = getattr(mod, "__file__", None)
    if f is None:
        raise ValueError(f"module {mod!r} has no __file__ — only source "
                         "modules/packages can ship as py_modules")
    if os.path.basename(f).startswith("__init__."):
        return os.path.dirname(f)
    return f


# Driver-side upload memo: abspath -> (stat signature, uri).  The stat
# signature (file count + latest mtime + total size) cheaply invalidates
# when sources change; the content hash remains the authority.  A memo
# hit skips the zip+hash only — presence in THIS cluster's KV is still
# verified per call (a fresh init() or an unpersisted head restart wipes
# the KV while the process-global memo survives).
_upload_memo = {}
_memo_lock = threading.Lock()


def _kv_has(transport, uri: str) -> bool:
    try:
        keys = transport.request("kv", {"verb": "keys",
                                        "prefix": uri.encode(),
                                        "namespace": KV_NAMESPACE})
    except Exception:
        return False
    return bool(keys)


def _stat_sig(path: str):
    if os.path.isfile(path):
        st = os.stat(path)
        return (1, st.st_mtime_ns, st.st_size)
    n, mt, sz = 0, 0, 0
    for fp in _iter_files(path):
        try:
            st = os.stat(fp)
        except OSError:
            continue
        n += 1
        mt = max(mt, st.st_mtime_ns)
        sz += st.st_size
    return (n, mt, sz)


def normalize_py_modules(renv: Optional[dict], transport) -> Optional[dict]:
    """Rewrite local py_modules entries to pkg:// URIs, uploading to the
    head KV when the content hash is not already stored.  Entries that
    are already URIs pass through.  Returns a new runtime_env dict (the
    input is never mutated) or the input unchanged when there is nothing
    to do."""
    if not renv or not renv.get("py_modules"):
        return renv
    out: List[str] = []
    changed = False
    for entry in renv["py_modules"]:
        if isinstance(entry, str) and entry.startswith(PKG_SCHEME):
            out.append(entry)
            continue
        if not isinstance(entry, str):
            entry = _module_root(entry)
        path = os.path.abspath(entry)
        sig = _stat_sig(path)
        with _memo_lock:
            memo = _upload_memo.get(path)
        if memo is not None and memo[0] == sig \
                and _kv_has(transport, memo[1]):
            out.append(memo[1])
            changed = True
            continue
        uri, blob = package_path(path)
        if len(blob) > WARN_SIZE:
            import logging

            logging.getLogger(__name__).warning(
                "py_modules package %s is %dMB — large packages stall the "
                "control plane; ship data via the object store instead",
                path, len(blob) // (1024 * 1024))
        key = uri.encode()
        # overwrite=False: content-addressed, so a concurrent/previous
        # upload of the same hash is byte-identical.
        transport.request("kv", {"verb": "put", "key": key, "value": blob,
                                 "namespace": KV_NAMESPACE,
                                 "overwrite": False})
        with _memo_lock:
            _upload_memo[path] = (sig, uri)
        out.append(uri)
        changed = True
    if not changed:
        return renv
    new_env = dict(renv)
    new_env["py_modules"] = out
    return new_env


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------
def _cache_root() -> str:
    return os.environ.get("RTPU_PKG_CACHE",
                          os.path.join("/tmp", "rtpu_pkg_cache"))


def ensure_local(uri: str, transport) -> str:
    """Materialize a pkg:// URI into the node-local cache; returns the
    directory to put on sys.path.  Extract-to-temp + atomic rename makes
    concurrent workers on one node safe (uri_cache.py's one-download-per-
    URI property, without its bookkeeping process)."""
    if not uri.startswith(PKG_SCHEME):
        # Local-path entry (same-host convenience / tests): use in place.
        path = os.path.abspath(uri)
        if not os.path.exists(path):
            raise FileNotFoundError(f"py_modules entry {path!r} does not "
                                    "exist on this node")
        return os.path.dirname(path) if os.path.isfile(path) else \
            os.path.dirname(path.rstrip(os.sep))
    digest = uri[len(PKG_SCHEME):]
    target = os.path.join(_cache_root(), digest)
    if os.path.isdir(target):
        return target
    blob = transport.request("kv", {"verb": "get", "key": uri.encode(),
                                    "namespace": KV_NAMESPACE})
    if blob is None:
        raise FileNotFoundError(
            f"py_modules package {uri} not found in the cluster KV (was "
            "the uploading driver's head wiped without persistence?)")
    # Per-call scratch dir: two threads of one worker share a pid, so a
    # pid-suffixed path could be extracted into by one thread while the
    # other renames (or rmtree's) it — mkdtemp gives each materialization
    # its own publish candidate, and the atomic rename stays the only
    # cross-writer coordination point.
    import tempfile

    os.makedirs(_cache_root(), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_cache_root(), prefix=digest + ".tmp.")
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        zf.extractall(tmp)
    try:
        os.rename(tmp, target)
    except OSError:
        # Lost the race to another worker: theirs is byte-identical.
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return target


class PyModulesOverlay:
    """Refcounted sys.path prepend of package roots (the py_modules
    analogue of the working_dir overlay): concurrent tasks may share one
    active set; a different set while active is refused; restore evicts
    modules imported from the roots so pooled workers don't leak code
    between jobs."""

    def __init__(self):
        self._lock = threading.Lock()
        self._active: Optional[tuple] = None
        self._count = 0

    def apply(self, roots: List[str]):
        import sys

        key = tuple(roots)
        with self._lock:
            if self._count and self._active != key:
                raise RuntimeError(
                    "concurrent tasks with different py_modules on one "
                    f"worker ({self._active} vs {key}); use separate "
                    "actors or max_concurrency=1")
            if self._count == 0:
                for r in reversed(roots):
                    sys.path.insert(0, r)
                self._active = key
            self._count += 1

    def restore(self):
        import sys

        with self._lock:
            if self._count == 0:
                return
            self._count -= 1
            if self._count == 0:
                for r in self._active:
                    try:
                        sys.path.remove(r)
                    except ValueError:
                        pass
                    prefix = r + os.sep
                    for name, mod in list(sys.modules.items()):
                        mod_file = getattr(mod, "__file__", None) or ""
                        if mod_file.startswith(prefix):
                            sys.modules.pop(name, None)
                self._active = None

    def adopt(self):
        with self._lock:
            self._count = max(self._count - 1, 0)
            if self._count == 0:
                self._active = None
