"""ctypes bindings + build-on-demand for the native ingest hot path.

A copy of ``tfidf_tpu/native`` with its own copy of the C++ source
(``tfidf_native.cpp``, the same ctypes surface). The shared library is
compiled with the system ``g++`` on first use into ``build/native/`` beside
the package, named by a hash of the source and flags, so an edited source
is rebuilt and the source directory stays clean. Nothing is built when
this module is imported.

If no compiler is available the engine runs on the pure-Python analyzer
with identical results — :func:`available` is the capability probe, and
the engine counts each path (``ingest_native_fast_path`` /
``ingest_python_fallback``), so a missing compiler shows in the metrics.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from tfidf_tpu_torch.utils.logging import get_logger

log = get_logger("native")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "tfidf_native.cpp")
_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                          "native")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def lib_path() -> str:
    """Where the library for the current source and flags lives."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(_BUILD_DIR,
                        f"libtfidf_native-{digest.hexdigest()[:12]}.so")


def _build(out: str) -> bool:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native build failed; using pure-Python analyzer",
                    err=repr(e))
        return False
    os.replace(tmp, out)
    log.info("native library built", path=out)
    return True


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            log.warning("native library load failed", err=repr(e))
            return None
        lib.tfidf_engine_new.restype = ctypes.c_void_p
        lib.tfidf_engine_new.argtypes = [
            ctypes.c_int, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
        lib.tfidf_engine_free.argtypes = [ctypes.c_void_p]
        lib.tfidf_vocab_size.restype = ctypes.c_int64
        lib.tfidf_vocab_size.argtypes = [ctypes.c_void_p]
        lib.tfidf_vocab_lookup.restype = ctypes.c_int32
        lib.tfidf_vocab_lookup.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
        lib.tfidf_vocab_term.restype = ctypes.c_int64
        lib.tfidf_vocab_term.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p,
            ctypes.c_int64]
        lib.tfidf_vocab_dump_size.restype = ctypes.c_int64
        lib.tfidf_vocab_dump_size.argtypes = [ctypes.c_void_p]
        lib.tfidf_vocab_dump.restype = ctypes.c_int64
        lib.tfidf_vocab_dump.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
        lib.tfidf_analyze_doc.restype = ctypes.c_int64
        lib.tfidf_analyze_doc.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


NONASCII = -2
OVERFLOW = -1


class NativeEngine:
    """One native analyzer+vocabulary instance.

    All native calls hold ``self._mu``: ctypes releases the GIL, and the
    C++ side mutates shared unordered_maps (vocab + scratch), so
    concurrent upload handlers and searches would otherwise race.
    """

    def __init__(self, lowercase: bool = True,
                 stopwords: tuple[str, ...] = (),
                 max_token_length: int = 255) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._mu = threading.Lock()
        stops = "\n".join(stopwords).encode("utf-8")
        self._h = ctypes.c_void_p(lib.tfidf_engine_new(
            int(lowercase), max_token_length, stops, len(stops)))
        # reusable output buffers, grown on demand (guarded by _mu)
        self._cap = 4096
        self._ids = np.empty(self._cap, np.int32)
        self._tfs = np.empty(self._cap, np.float32)
        self._len = ctypes.c_double(0.0)

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.tfidf_engine_free(h)
            self._h = None

    def vocab_size(self) -> int:
        with self._mu:
            return int(self._lib.tfidf_vocab_size(self._h))

    def lookup(self, term: str, add: bool) -> int | None:
        b = term.encode("utf-8")
        with self._mu:
            tid = self._lib.tfidf_vocab_lookup(self._h, b, len(b),
                                               int(add))
        return None if tid < 0 else int(tid)

    def term(self, tid: int) -> str:
        cap = 1024
        while True:
            buf = ctypes.create_string_buffer(cap)
            with self._mu:
                n = self._lib.tfidf_vocab_term(self._h, tid, buf, cap)
            if n == OVERFLOW:
                cap *= 4
                continue
            if n < 0:
                raise IndexError(f"term id {tid}")
            return buf.raw[:n].decode("utf-8")

    def dump_terms(self) -> list[str]:
        with self._mu:
            n = self._lib.tfidf_vocab_dump_size(self._h)
            if n == 0:
                return []
            buf = ctypes.create_string_buffer(int(n))
            wrote = self._lib.tfidf_vocab_dump(self._h, buf, n)
        assert wrote == n, (wrote, n)
        return buf.raw.decode("utf-8").split("\n")[:-1]

    def analyze(self, text: str, *, add: bool
                ) -> tuple[np.ndarray, np.ndarray, float] | None:
        """ASCII fast path: text -> (sorted ids, tfs, doc length).
        Returns None when the text needs the Python (Unicode) analyzer."""
        try:
            raw = text.encode("ascii")
        except UnicodeEncodeError:
            return None
        with self._mu:
            while True:
                n = self._lib.tfidf_analyze_doc(
                    self._h, raw, len(raw), int(add),
                    self._ids.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_int32)),
                    self._tfs.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_float)),
                    self._cap, ctypes.byref(self._len))
                if n == OVERFLOW:
                    self._cap *= 4
                    self._ids = np.empty(self._cap, np.int32)
                    self._tfs = np.empty(self._cap, np.float32)
                    continue
                if n == NONASCII:   # unreachable after the encode check
                    return None
                n = int(n)
                return (self._ids[:n].copy(), self._tfs[:n].copy(),
                        float(self._len.value))
