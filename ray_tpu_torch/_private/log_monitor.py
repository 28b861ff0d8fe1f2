"""Worker log capture + driver echo.

Reference: worker processes write stdout/stderr to per-worker log files,
the LogMonitor tails them (python/ray/_private/log_monitor.py:104) and
publishes new lines through GCS pubsub, and the driver echoes them with a
worker prefix.  Same shape here: spawn_worker redirects output to
``<session_dir>/logs/worker-<id>.{out,err}``, a monitor thread in the head
tails every file and publishes ("LOG", record) on the GCS, and
``ray_tpu_torch.init(log_to_driver=True)`` (the default) subscribes a printer.

Copied from ``ray_tpu/_private/log_monitor.py`` (the JAX package).
"""
from __future__ import annotations

import os
import sys
import threading
from typing import Dict, Optional, TextIO

POLL_S = 0.3


class LogMonitor:
    def __init__(self, logs_dir: str, gcs):
        self.logs_dir = logs_dir
        self.gcs = gcs
        self._offsets: Dict[str, int] = {}
        self._partial: Dict[str, bytes] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="rtpu-log-monitor", daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(POLL_S):
            try:
                self.poll_once()
            except Exception:
                pass

    def poll_once(self):
        if not os.path.isdir(self.logs_dir):
            return
        for name in os.listdir(self.logs_dir):
            path = os.path.join(self.logs_dir, name)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            off = self._offsets.get(path, 0)
            if size <= off:
                continue
            try:
                with open(path, "rb") as f:
                    f.seek(off)
                    chunk = f.read(size - off)
            except OSError:
                continue
            self._offsets[path] = size
            data = self._partial.pop(path, b"") + chunk
            *lines, tail = data.split(b"\n")
            if tail:
                self._partial[path] = tail
            if not lines:
                continue
            # worker-<hex>.out / worker-<hex>.err
            stem, _, stream = name.rpartition(".")
            source = stem.replace("worker-", "")
            for line in lines:
                self.gcs.publish("LOG", {
                    "source": source, "stream": stream,
                    "line": line.decode("utf-8", "replace")})

    def stop(self):
        self._stop.set()


def attach_driver_echo(gcs, out: Optional[TextIO] = None):
    """Print published worker log lines with a source prefix (the
    reference's driver log echo)."""
    out = out or sys.stderr

    def printer(record):
        prefix = f"({record['source'][:12]} {record['stream']})"
        try:
            print(f"{prefix} {record['line']}", file=out)
        except Exception:
            pass

    gcs.subscribe("LOG", printer)
    return printer
