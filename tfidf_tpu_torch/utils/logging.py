"""Structured logging.

The reference logs narratively on every path via SLF4J/Logback
(``logback.xml:27-29``; e.g. ``Leader.java:41-90``, ``Worker.java:59-89``).
Here we emit single-line structured records (human prefix + key=value tail)
so the same stream doubles as a machine-parseable event log.

Records emitted while a trace span is active (``utils/tracing.py``)
carry a ``trace=<trace id>`` field, so slow-query log lines and every
warn/error on a traced request path are joinable with ``GET
/api/trace/<id>`` output. The trace id is read off a contextvar at
RECORD CREATION time (``_KVAdapter.process`` runs on the emitting
thread), not at formatting time — handlers may format on another
thread where the contextvar would be empty.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time

_CONFIGURED = False
_LOCK = threading.Lock()


def _trace_id() -> str | None:
    # late import: logging is imported by nearly everything, including
    # modules tracing itself depends on at import time
    from tfidf_tpu_torch.utils.tracing import current_trace_id
    return current_trace_id()


class _KVFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        kv = getattr(record, "kv", None)
        if kv:
            tail = " ".join(f"{k}={v}" for k, v in sorted(kv.items()))
            return f"{base} | {tail}"
        return base


class _KVAdapter(logging.LoggerAdapter):
    """Lets call sites pass arbitrary keyword fields: log.info("msg", docs=3)."""

    _RESERVED = {"exc_info", "stack_info", "stacklevel", "extra"}

    def process(self, msg, kwargs):
        kv = {k: v for k, v in kwargs.items() if k not in self._RESERVED}
        tid = _trace_id()
        if tid is not None and "trace" not in kv:
            kv["trace"] = tid
        passthrough = {k: v for k, v in kwargs.items() if k in self._RESERVED}
        passthrough.setdefault("extra", {})["kv"] = kv
        return msg, passthrough


def _configure() -> None:
    global _CONFIGURED
    with _LOCK:
        if _CONFIGURED:
            return
        root = logging.getLogger("tfidf_tpu_torch")
        level = os.environ.get("TFIDF_LOG_LEVEL", "INFO").upper()
        root.setLevel(level)
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_KVFormatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s", "%H:%M:%S"))
        root.addHandler(handler)
        root.propagate = False
        _CONFIGURED = True


def get_logger(name: str) -> _KVAdapter:
    _configure()
    return _KVAdapter(logging.getLogger(f"tfidf_tpu_torch.{name}"), {})


class Stopwatch:
    """Tiny timing helper for log lines: with Stopwatch() as sw: ...; sw.ms"""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        self.ms = round(self.seconds * 1e3, 2)
        return False
