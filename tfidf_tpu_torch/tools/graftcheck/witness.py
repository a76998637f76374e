"""Runtime lockdep witness — the dynamic half of the lock-graph check.

The static lock graph (:mod:`.lockgraph`) is an over-approximation
built by resolution rules that can miss paths; a runtime trace alone
sees only the schedules that happened to run. Each side validates the
other:

- the witness instruments every ``threading.Lock``/``RLock``/
  ``Condition`` the *package* constructs while installed, records the
  actually-observed acquisition orders per thread, and
- :meth:`LockdepWitness.check` fails on a real **inversion** (both
  ``A→B`` and ``B→A`` observed — a schedule away from deadlock) and on
  any observed edge the static graph cannot explain (``A→B`` observed
  but ``B`` unreachable from ``A`` statically — the analyzer's
  resolution has a hole that must be fixed, not ignored).

Locks are named by their creation site: the static pass records every
``threading.Lock()`` call's (file, line) together with the lock's
graph name, and the instrumented constructor looks the caller's frame
up in that map — no cooperation from the instrumented code needed.

Scope: ``install()`` swaps a proxy ``threading`` module into every
already-imported ``tfidf_tpu_torch`` module's namespace, so only locks the
package creates *after* install are instrumented (import-time
singletons like the metrics lock stay raw — they are leaf locks the
static graph already covers). TEST-ONLY by design: nothing under
``tfidf_tpu_torch/`` outside ``tools/`` imports this module, production
paths always run raw ``threading`` primitives.
"""

from __future__ import annotations

import os
import sys
import threading as _real_threading

from tfidf_tpu_torch.tools.graftcheck.core import SourceTree
from tfidf_tpu_torch.tools.graftcheck.lockgraph import LockGraph, build

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def _site_name(site_map: dict[tuple[str, int], str], depth: int = 2) -> str:
    f = sys._getframe(depth)
    path = f.f_code.co_filename.replace(os.sep, "/")
    idx = path.rfind("tfidf_tpu_torch/")
    rel = path[idx:] if idx >= 0 else path
    return site_map.get((rel, f.f_lineno), f"{rel}:{f.f_lineno}")


class _InstrLock:
    """Delegating wrapper over a real lock primitive that reports
    acquisition/release to the witness. ``_depth`` tracks reentrancy
    (mutated only by the owning thread) so an RLock's re-acquire adds
    no ordering edges."""

    _factory = staticmethod(_real_threading.Lock)

    def __init__(self, witness: "LockdepWitness", name: str) -> None:
        self._w = witness
        self.name = name
        self._inner = self._factory()
        self._depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            if self._depth == 0:
                self._w._on_acquire(self)
            self._depth += 1
        return got

    def release(self) -> None:
        self._depth -= 1
        if self._depth == 0:
            self._w._on_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<witness lock {self.name}>"


class _InstrRLock(_InstrLock):
    _factory = staticmethod(_real_threading.RLock)

    # Condition(instrumented_rlock) support: the default Condition glue
    # only handles plain locks; an RLock must expose the save/restore
    # protocol — and OUR versions must keep the held-stack honest when
    # wait() fully releases and later re-acquires.

    def _release_save(self):
        depth, self._depth = self._depth, 0
        self._w._on_release(self)
        return self._inner._release_save(), depth

    def _acquire_restore(self, state) -> None:
        inner_state, depth = state
        self._inner._acquire_restore(inner_state)
        self._w._on_acquire(self)
        self._depth = depth

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


class _ThreadingProxy:
    """A stand-in for the ``threading`` module inside package
    namespaces: Lock/RLock/Condition are instrumented, everything else
    delegates to the real module."""

    def __init__(self, witness: "LockdepWitness") -> None:
        self._w = witness

    def __getattr__(self, name: str):
        return getattr(_real_threading, name)

    def Lock(self):
        return _InstrLock(self._w, _site_name(self._w.site_map))

    def RLock(self):
        return _InstrRLock(self._w, _site_name(self._w.site_map))

    def Condition(self, lock=None):
        if lock is None:
            lock = _InstrRLock(self._w, _site_name(self._w.site_map))
        return _real_threading.Condition(lock)


class LockdepWitness:
    """Record real lock-acquisition orders and check them against the
    statically computed graph. Use as a context manager::

        with LockdepWitness() as w:
            ... drive the cluster ...
        w.check(min_multilock_edges=1)
    """

    def __init__(self, root: str = _REPO_ROOT,
                 graph: LockGraph | None = None) -> None:
        self.graph = graph or build(SourceTree(root))
        self.site_map = dict(self.graph.tree.lock_sites)
        self._tls = _real_threading.local()
        self._mu = _real_threading.Lock()   # guards edges/inversions
        # (outer_name, inner_name) -> observation count
        self.edges: dict[tuple[str, str], int] = {}
        self.inversions: list[tuple[str, str]] = []
        self._saved: dict[str, object] = {}
        self._installed = False

    # ---- bookkeeping (called from instrumented locks) ----

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _on_acquire(self, lock: _InstrLock) -> None:
        st = self._stack()
        new_edges = []
        for held in st:
            if held.name != lock.name:
                new_edges.append((held.name, lock.name))
        st.append(lock)
        if not new_edges:
            return
        with self._mu:
            for e in new_edges:
                first = e not in self.edges
                self.edges[e] = self.edges.get(e, 0) + 1
                rev = (e[1], e[0])
                if first and rev in self.edges:
                    self.inversions.append(e)

    def _on_release(self, lock: _InstrLock) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] is lock:
                del st[i]
                return

    # ---- install / uninstall ----

    def install(self) -> "LockdepWitness":
        """Swap the proxy ``threading`` into every imported tfidf_tpu_torch
        module namespace. Locks constructed from here on are
        instrumented; pre-existing locks stay raw."""
        assert not self._installed
        proxy = _ThreadingProxy(self)
        for name, mod in list(sys.modules.items()):
            if mod is None or not (name == "tfidf_tpu_torch"
                                   or name.startswith("tfidf_tpu_torch.")) \
                    or name.startswith("tfidf_tpu_torch.tools."):
                continue
            if mod.__dict__.get("threading") is _real_threading:
                self._saved[name] = mod.__dict__["threading"]
                mod.__dict__["threading"] = proxy
        self._installed = True
        return self

    def uninstall(self) -> None:
        for name, orig in self._saved.items():
            mod = sys.modules.get(name)
            if mod is not None:
                mod.__dict__["threading"] = orig
        self._saved.clear()
        self._installed = False

    def __enter__(self) -> "LockdepWitness":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # ---- verdict ----

    def multi_lock_edges(self) -> set[tuple[str, str]]:
        return set(self.edges)

    def unexplained_edges(self) -> list[tuple[str, str]]:
        """Observed orderings the static graph cannot explain (no
        static path outer→inner)."""
        return sorted(e for e in self.edges
                      if not self.graph.reachable(*e))

    def report(self) -> dict:
        return {
            "observed_edges": {f"{a} -> {b}": n
                               for (a, b), n in sorted(self.edges.items())},
            "inversions": [f"{a} -> {b} (reverse also observed)"
                           for a, b in self.inversions],
            "unexplained": [f"{a} -> {b}"
                            for a, b in self.unexplained_edges()],
        }

    def check(self, min_multilock_edges: int = 0) -> dict:
        """Raise AssertionError on any inversion or statically
        unexplained edge; optionally require that at least
        ``min_multilock_edges`` real multi-lock orderings were seen
        (guards against the witness silently observing nothing)."""
        rep = self.report()
        problems = []
        if self.inversions:
            problems.append(f"lock-order inversions: {rep['inversions']}")
        if rep["unexplained"]:
            problems.append(
                "orderings missing from the static lock graph "
                f"(fix the analyzer or the code): {rep['unexplained']}")
        if len(self.edges) < min_multilock_edges:
            problems.append(
                f"witness observed {len(self.edges)} multi-lock "
                f"ordering(s), expected >= {min_multilock_edges} — "
                f"instrumentation is not seeing the real workload")
        if problems:
            raise AssertionError("lockdep witness failed:\n  "
                                 + "\n  ".join(problems)
                                 + f"\n  report: {rep}")
        return rep
